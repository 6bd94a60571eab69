"""Repairs of the port's API against the reference (CPU):

  * `native_dd=True` overrides `factor_dtype`, as the reference's
    config.py says ("factor_dtype is ignored when set"): the f64 factor;
  * `dtype` takes every spelling of f64 the reference's callers pass
    (numpy's, a string, JAX's) and of f32, still refusing any other;
  * `KKTStrategy` is exported with the reference's members and values.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import socp_tpu
import socp_tpu_torch
from socp_tpu_torch import SolverConfig, api
from socp_tpu_torch.models.portfolio import portfolio
from socp_tpu_torch.models.robust_ls import robust_ls_batch
from socp_tpu_torch.ops import chol
from tests._host_memory import release_host_memory  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """On these shapes the port's CPU path is eager-op overhead, and
    torch's intra-op threads only contend with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_native_dd_overrides_factor_dtype(monkeypatch):
    """portfolio(0, n=64, k=8): native_dd with factor_dtype="float32" is the
    native_dd solve (before the repair it took the f32 factor and ended
    optimal-inaccurate at gap 4.07e-8); every factor and back-solve is
    f64 and no kernel launches (the CPU's plain path)."""
    prob = portfolio(0, n=64, k=8)[0]
    both = SolverConfig(native_dd=True, factor_dtype="float32")
    assert api._resolve_config(both).factor_dtype is None
    dtypes = []
    for name in ("cholesky", "tri_pair_solve"):
        real = getattr(chol, name)
        monkeypatch.setattr(chol, name,
                            lambda *a, real=real: dtypes.append(a[0].dtype) or real(*a))
    counters = [c + s for c in chol.COUNTERS.values() for s in ("", "_f32")]
    before = [getattr(chol, c) for c in counters]
    got = socp_tpu_torch.solve(prob, config=both, device="cpu")
    assert set(dtypes) == {torch.float64}
    assert [getattr(chol, c) for c in counters] == before
    want = socp_tpu_torch.solve(prob, config=SolverConfig(native_dd=True),
                                device="cpu")
    assert got.status == want.status == socp_tpu_torch.Status.OPTIMAL
    assert got.inaccurate == want.inaccurate is False
    assert abs(got.pcost - want.pcost) <= 1e-8 * max(1.0, abs(want.pcost))
    assert got.iterations == want.iterations
    # without native_dd the f32 factor stays what it was
    assert api._resolve_config(SolverConfig(factor_dtype="float32")).factor_dtype == "float32"


F64_SPELLINGS = [None, torch.float64, np.float64, np.dtype("float64"),
                 "float64", jnp.float64, jnp.dtype("float64")]


def test_every_f64_spelling_is_accepted_and_gives_the_same_bits():
    c, G, h, dims = robust_ls_batch(0, 2, n=8)
    outs = [socp_tpu_torch.solve_batch_raw(c, G, h, dims, dtype=d, device="cpu")
            for d in F64_SPELLINGS]
    for d in F64_SPELLINGS:
        assert api.resolve_dtype(d) is torch.float64
    for out in outs[1:]:
        for a, b in zip(out, outs[0]):
            assert np.array_equal(a, b)
    prob = portfolio(0, n=6, k=2)[0]
    one = [socp_tpu_torch.solve(prob, dtype=d, device="cpu") for d in (None, np.float64)]
    assert np.array_equal(one[0].x, one[1].x)


@pytest.mark.parametrize("dtype", [torch.float16, np.float16, "float16",
                                   jnp.bfloat16, np.dtype("int64"), "double-ish"])
def test_other_dtypes_still_raise(dtype):
    """f64 and f32 are the carry dtypes (f32: tests/test_torch_f32carry.py);
    every other dtype raises."""
    c, G, h, dims = robust_ls_batch(0, 2, n=4, k=6)
    with pytest.raises(ValueError, match="float64 or float32"):
        socp_tpu_torch.prepare_batch(c, G, h, dims, dtype=dtype, device="cpu")
    with pytest.raises(ValueError, match="float64 or float32"):
        socp_tpu_torch.solve(portfolio(0, n=6, k=2)[0], dtype=dtype, device="cpu")


def test_kkt_strategy_is_the_references():
    ours = [(m.name, m.value) for m in socp_tpu_torch.KKTStrategy]
    assert ours == [(m.name, m.value) for m in socp_tpu.KKTStrategy]
    assert "KKTStrategy" in socp_tpu_torch.__all__
    assert socp_tpu_torch.config.KKTStrategy.DENSE.value == "dense"
    fields = [f.name for f in dataclasses.fields(SolverConfig)]
    assert fields == [f.name for f in dataclasses.fields(socp_tpu.SolverConfig)]
