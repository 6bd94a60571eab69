"""The plain PyTorch versions of the port's batched kernels vs the
reference's instance-tiled Pallas kernels (interpret mode on the CPU).

  chol_batched      vs socp_tpu.ops.pallas_chol.cholesky_dd_batched(H, tile=4)
  tri_pair_batched  vs socp_tpu.ops.pallas_chol.tri_pair_solve_batched(L, LT, b, tile=4)

Inputs: B = 8 SPD matrices with kappa = 1e8 from a numpy seed, converted to
dd for the reference with `ddm.from_f64` and back with `astype_f64`.
Tolerances are the reference's own for these kernels
(tests/test_pallas.py:90-129): Cholesky rtol 1e-9 / atol 1e-11, pair solve
rtol 1e-10 / atol 1e-12.  The CUDA kernels themselves are held to these
plain versions on the card by chip_smoke.py (bit for bit).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from socp_tpu.ops import dd as ddm
from socp_tpu.ops.pallas_chol import cholesky_dd_batched, tri_pair_solve_batched
from socp_tpu_torch.ops import chol
from tests._host_memory import release_host_memory  # noqa: F401

B = 8


def _spd(rng, n, kappa=1e8, neg=False):
    Q, _ = np.linalg.qr(rng.normal(size=(B, n, n)))
    ev = np.logspace(-np.log10(kappa), 0, n)
    if neg:
        ev[0] = -1e-3
    H = (Q * ev) @ np.swapaxes(Q, 1, 2)
    return 0.5 * (H + np.swapaxes(H, 1, 2))


@pytest.mark.parametrize("n", [24, 37])
def test_chol_plain_matches_pallas(n):
    H = _spd(np.random.default_rng(n), n)
    ref = jax.jit(lambda h: cholesky_dd_batched(h, tile=4))(
        ddm.from_f64(jnp.asarray(H)))
    L = chol.chol_batched(torch.as_tensor(H))
    np.testing.assert_allclose(L.numpy(), np.asarray(ref.astype_f64()),
                               rtol=1e-9, atol=1e-11)
    # and it is a Cholesky factor of H
    np.testing.assert_allclose(L.numpy(), np.linalg.cholesky(H),
                               rtol=1e-9, atol=1e-11)


@pytest.mark.parametrize("n,k", [(24, 1), (24, 3), (37, 1), (37, 3)])
def test_tri_pair_plain_matches_pallas(n, k):
    rng = np.random.default_rng(100 + n + k)
    L = chol.chol_batched_plain(torch.as_tensor(_spd(rng, n)))
    b = rng.standard_normal((B, n, k))
    Ld = ddm.from_f64(jnp.asarray(L.numpy()))
    LT = ddm.DD(jnp.swapaxes(Ld.hi, 1, 2), jnp.swapaxes(Ld.lo, 1, 2))
    ref = jax.jit(lambda *a: tri_pair_solve_batched(*a, tile=4))(
        Ld, LT, ddm.from_f64(jnp.asarray(b)))
    x = chol.tri_pair_batched(L, torch.as_tensor(b))
    np.testing.assert_allclose(x.numpy(), np.asarray(ref.astype_f64()),
                               rtol=1e-10, atol=1e-12)


def test_non_pd_gives_nan_not_exception():
    """A frozen lane's H can be numerically singular: the factor must be
    non-finite (as jnp.linalg.cholesky gives), never an exception."""
    H = torch.as_tensor(_spd(np.random.default_rng(3), 24, neg=True))
    L = chol.chol_batched(H)
    assert bool((~torch.isfinite(L)).flatten(1).any(1).all())
    x = chol.tri_pair_batched(L, torch.ones(B, 24, 1, dtype=torch.float64))
    assert not bool(torch.isfinite(x).all())


def test_cpu_tensors_take_the_plain_path_and_launch_nothing():
    before = (chol.chol_launches, chol.tri_pair_launches)
    rng = np.random.default_rng(4)
    H = torch.as_tensor(_spd(rng, 12))
    rhs = torch.as_tensor(rng.standard_normal((B, 12, 2)))
    L = chol.chol_batched(H)
    assert torch.equal(L, chol.chol_batched_plain(H))
    assert torch.equal(chol.tri_pair_batched(L, rhs),
                       chol.tri_pair_batched_plain(L, rhs))
    assert (chol.chol_launches, chol.tri_pair_launches) == before


def test_empty_and_tiny_shapes():
    """p = 0 gives (B, 0, 0) factors; p = 1 a 1x1 Schur factor."""
    assert chol.chol_batched(torch.zeros(B, 0, 0, dtype=torch.float64)).shape == (B, 0, 0)
    H = torch.full((B, 1, 1), 4.0, dtype=torch.float64)
    L = chol.chol_batched(H)
    assert torch.equal(L, torch.full_like(H, 2.0))
    x = chol.tri_pair_batched(L, torch.ones(B, 1, 3, dtype=torch.float64))
    assert torch.equal(x, torch.full((B, 1, 3), 0.25, dtype=torch.float64))


@pytest.mark.parametrize("bad", ["dtype", "layout", "shape"])
def test_wrappers_reject_what_the_kernels_do_not_take(bad):
    H = torch.eye(4, dtype=torch.float64).expand(2, 4, 4).contiguous()
    rhs = torch.ones(2, 4, 1, dtype=torch.float64)
    if bad == "dtype":
        # float64 and float32 have kernels; other dtypes have none
        with pytest.raises(TypeError):
            chol.chol_batched(H.half())
    elif bad == "layout":
        with pytest.raises(ValueError):
            chol.tri_pair_batched(H, torch.ones(2, 3, 4, dtype=torch.float64).transpose(1, 2))
    else:
        with pytest.raises(ValueError):
            chol.tri_pair_batched(H, rhs[:, :3])


# ---- the batched kernels' schedules, step for step (csrc/chol_batched.cu
# and csrc/tri_pair_batched.cu): each must round every entry as the plain
# loops do, so that the card can hold the kernels to them bit for bit


def _microtile_order(H: torch.Tensor) -> torch.Tensor:
    """chol_batched's steps: column 0 from the pivots read off H; at step j,
    column j + 1 first -- its pivot is the one published at step j - 1
    minus its own update with column j, its entries are updated with
    column j and divided by the pivot's square root -- then the rest of the
    trailing lower triangle takes column j, and entry (j + 2, j + 2) is
    published as the next pivot.  The kernel's 4 x 4 register tiles and its
    two schedules (by n) change only which thread does which entry."""
    n = H.shape[-1]
    M = torch.tril(H)                      # the kernel reads only this
    L = torch.zeros_like(H)
    pv = torch.diagonal(H, dim1=1, dim2=2).clone()
    col = M[:, :, 0] / torch.sqrt(pv[:, 0])[:, None]
    L[:, :, 0] = col
    for j in range(n - 1):
        c = col[:, j + 1]
        d = torch.sqrt(pv[:, j + 1] - c * c)
        nxt = torch.zeros_like(col)
        nxt[:, j + 1:] = (M[:, j + 1:, j + 1] - col[:, j + 1:] * c[:, None]) / d[:, None]
        L[:, j + 1:, j + 1] = nxt[:, j + 1:]
        M[:, j + 2:, j + 2:] = torch.tril(
            M[:, j + 2:, j + 2:] - col[:, j + 2:, None] * col[:, None, j + 2:])
        if j + 2 < n:
            pv[:, j + 2] = M[:, j + 2, j + 2]
        col = nxt
    return L


def _batched_pair_order(L: torch.Tensor, rhs: torch.Tensor, nb: int = 32) -> torch.Tensor:
    """tri_pair_batched's jobs in the kernel's order: forward, for each
    32-row panel its diagonal block's chain (each row's quotient is its
    result), then each block below it takes the panel's quotients in step
    order; backward the same from the bottom panel up."""
    n = L.shape[-1]
    X = rhs.clone()
    diag = torch.diagonal(L, dim1=1, dim2=2)[..., None]       # (B, n, 1)
    panels = range(0, n, nb)
    for a in panels:
        e = min(n, a + nb)
        qs = []
        for j in range(a, e):
            q = X[:, j] / diag[:, j]
            X[:, j + 1:e] -= L[:, j + 1:e, j, None] * q[:, None]
            qs.append(q)
        X[:, a:e] = torch.stack(qs, 1)
        for r in range(e, n, nb):
            rows = slice(r, min(n, r + nb))
            for t, q in enumerate(qs):
                X[:, rows] -= L[:, rows, a + t, None] * q[:, None]
    for a in reversed(panels):
        e = min(n, a + nb)
        qs = {}
        for j in range(e - 1, a - 1, -1):
            qs[j] = X[:, j] / diag[:, j]
            X[:, a:j] -= L[:, j, a:j, None] * qs[j][:, None]
        for j in range(a, e):
            X[:, j] = qs[j]
        for r in range(a - nb, -1, -nb):
            rows = slice(r, r + nb)
            for j in range(e - 1, a - 1, -1):
                X[:, rows] -= L[:, j, rows, None] * qs[j][:, None]
    return X


# n across the micro-tile (4) and panel (32) edges, the Cholesky's second
# schedule (above n = 108) and config 3's n = 102, up to the largest order
# the wrappers take in f64
BATCHED_SCHEDULE_CASES = (
    [("chol", d, n, 0) for d in ("f64", "f32")
     for n in (1, 2, 3, 4, 5, 31, 32, 33, 65, 102, 108, 109, 169)]
    + [("pair", d, n, k) for d in ("f64", "f32")
       for n in (1, 2, 31, 32, 33, 65, 102, 169) for k in (1, 3)])


@pytest.mark.parametrize("schedule,dtype,n,k", BATCHED_SCHEDULE_CASES)
def test_batched_kernel_schedule_is_the_plain_order(schedule, dtype, n, k):
    """B = 3 instances through each batched kernel's schedule: bit-equal to
    the plain loops (torch.equal) in f64 and f32."""
    rng = np.random.default_rng(1000 + n + k)
    H = torch.as_tensor(_spd(rng, n, kappa=1e8 if dtype == "f64" else 1e4)[:3],
                        dtype=torch.float64 if dtype == "f64" else torch.float32)
    if schedule == "pair":
        L = chol.chol_batched_plain(H)
        rhs = torch.as_tensor(rng.standard_normal((3, n, k)), dtype=H.dtype)
        got, want = _batched_pair_order(L, rhs), chol.tri_pair_batched_plain(L, rhs)
    else:
        got, want = _microtile_order(H), chol.chol_batched_plain(H)
    assert bool(torch.isfinite(want).all())
    assert torch.equal(got, want)
