"""The port's toolchain probes (socp_tpu_torch.ops.probes, plain versions on
the CPU) against the reference's Mosaic probe kernels, run here through
`pl.pallas_call(..., interpret=True)` on the same numpy inputs.

The kernel bodies are imported from `scripts/pallas_probe.py` and
`scripts/pallas_probe2.py` (importing them only prints a backend line;
their module-level environment default is undone after the import).  Each
probe is also held to the script's own check.

  P1  _chol_kernel   f32 Cholesky (128, 128)   port: ops.chol.chol_single (f32)
  P2  _eft_kernel    two-sum / two-prod        port: probes.eft
  P3  _read_kernel   sum of rows, in order     port: probes.row_sum
  P4  _write_kernel  rows reversed             port: probes.row_reverse
  P5  _fwd_kernel    forward substitution      port: probes.fwd_subst
"""

import contextlib
import importlib.util
import io
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from socp_tpu_torch.ops import chol, probes
from tests._host_memory import release_host_memory  # noqa: F401

SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"


def _script(name):
    saved = dict(os.environ)
    try:
        spec = importlib.util.spec_from_file_location(f"_{name}", SCRIPTS / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        with contextlib.redirect_stdout(io.StringIO()):
            spec.loader.exec_module(mod)
    finally:
        os.environ.clear()
        os.environ.update(saved)
    return mod


@pytest.fixture(scope="module")
def p1():
    return _script("pallas_probe")


@pytest.fixture(scope="module")
def p2():
    return _script("pallas_probe2")


def _run(kernel, out_shape, *args):
    shapes = tuple(jax.ShapeDtypeStruct(s, jnp.float32) for s in out_shape)
    out = pl.pallas_call(kernel, out_shape=shapes if len(shapes) > 1 else shapes[0],
                         interpret=True)(*(jnp.asarray(a) for a in args))
    return tuple(np.asarray(o) for o in out) if len(shapes) > 1 else np.asarray(out)


def test_p1_chol(p1):
    """run_chol's input (A A' + n I, n = 128) and check (reconstruction
    below 1e-5 of max |H|); against the probe: rtol 2e-5 and atol 2e-6
    max |L| (test_pallas.py:20-35's tolerances, scaled to L)."""
    n = 128
    rng = np.random.default_rng(0)
    A = rng.normal(size=(n, n)).astype(np.float32)
    H = A @ A.T + n * np.eye(n, dtype=np.float32)
    ref = _run(p1._chol_kernel, [(n, n)], H)
    L = chol.chol_single(torch.as_tensor(H)).numpy()
    np.testing.assert_allclose(L, ref, rtol=2e-5, atol=2e-6 * np.abs(ref).max())
    L64 = L.astype(np.float64)
    assert np.abs(L64 @ L64.T - H).max() / np.abs(H).max() < 1e-5


def test_p2_eft(p1):
    """run_eft's inputs and check: s + e == a + b and p + q == a b exactly
    in f64, with nonzero error words; bit-equal to the probe."""
    rng = np.random.default_rng(1)
    a = rng.normal(size=(8, 128)).astype(np.float32)
    b = (rng.normal(size=(8, 128)) * 1e-3).astype(np.float32)
    ref = _run(p1._eft_kernel, [(8, 128)] * 4, a, b)
    out = [o.numpy() for o in probes.eft(torch.as_tensor(a), torch.as_tensor(b))]
    for name, r, o in zip("sepq", ref, out):
        np.testing.assert_array_equal(o, r, err_msg=name)
    s, e, p, q = (o.astype(np.float64) for o in out)
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    assert np.array_equal(s + e, a64 + b64)
    assert np.array_equal(p + q, a64 * b64)
    assert np.count_nonzero(e) > 0 and np.count_nonzero(q) > 0


def test_p3_read(p2):
    n = 64
    M = np.arange(n * n, dtype=np.float32).reshape(n, n)
    ref = _run(p2._read_kernel, [(1, n)], M)
    out = probes.row_sum(torch.as_tensor(M)).numpy()
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, M.sum(0, keepdims=True))


def test_p4_write(p2):
    n = 64
    M = np.arange(n * n, dtype=np.float32).reshape(n, n)
    ref = _run(p2._write_kernel, [(n, n)], M)
    out = probes.row_reverse(torch.as_tensor(M)).numpy()
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, M[::-1])


def test_p5_fwd(p2):
    """run_fwd's inputs (n = 128, k = 1) and check (relative error against
    np.linalg.solve below 1e-4); against the probe: rtol 1e-5, atol 1e-6
    max |x|."""
    n, k = 128, 1
    rng = np.random.default_rng(0)
    A = rng.normal(size=(n, n))
    L = np.linalg.cholesky(A @ A.T + n * np.eye(n)).astype(np.float32)
    b = rng.normal(size=(n, k)).astype(np.float32)
    LT = L.T.copy()
    ref = _run(p2._fwd_kernel, [(n, k)], LT, b)
    x = probes.fwd_subst(torch.as_tensor(LT), torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(x, ref, rtol=1e-5, atol=1e-6 * np.abs(ref).max())
    exact = np.linalg.solve(L, b)
    assert np.abs(x - exact).max() / np.abs(exact).max() < 1e-4


def test_probe_wrappers_refuse_other_dtypes_and_launch_nothing_on_the_cpu():
    before = dict(probes.launches)
    with pytest.raises(TypeError):
        probes.row_sum(torch.zeros(2, 2, dtype=torch.float64))
    with pytest.raises(ValueError):
        probes.fwd_subst(torch.eye(3), torch.ones(2, 1))
    probes.row_reverse(torch.eye(3))
    assert probes.launches == before
