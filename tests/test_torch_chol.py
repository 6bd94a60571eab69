"""The plain PyTorch versions of the port's batched kernels vs the
reference's instance-tiled Pallas kernels (interpret mode on the CPU).

  chol_batched      vs socp_tpu.ops.pallas_chol.cholesky_dd_batched(H, tile=4)
  tri_pair_batched  vs socp_tpu.ops.pallas_chol.tri_pair_solve_batched(L, LT, b, tile=4)

Inputs: B = 8 SPD matrices with kappa = 1e8 from a numpy seed, converted to
dd for the reference with `ddm.from_f64` and back with `astype_f64`.
Tolerances are the reference's own for these kernels
(tests/test_pallas.py:90-129): Cholesky rtol 1e-9 / atol 1e-11, pair solve
rtol 1e-10 / atol 1e-12.  The CUDA kernels themselves are held to these
plain versions on the card by chip_smoke.py (bit for bit); here each of
their schedules is emulated step for step (the tile dataflow with its
tickets and flags) and held to the plain loops bit for bit.  The slice,
solve_batch of three portfolios at n = 180, is held to the reference's
solve_batch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import socp_tpu
import socp_tpu_torch
from socp_tpu.models.portfolio import portfolio
from socp_tpu.ops import dd as ddm
from socp_tpu.ops.pallas_chol import cholesky_dd_batched, tri_pair_solve_batched
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


B = 8


def _spd(rng, n, kappa=1e8, neg=False):
    Q, _ = np.linalg.qr(rng.normal(size=(B, n, n)))
    ev = np.logspace(-np.log10(kappa), 0, n)
    if neg:
        ev[0] = -1e-3
    H = (Q * ev) @ np.swapaxes(Q, 1, 2)
    return 0.5 * (H + np.swapaxes(H, 1, 2))


@pytest.mark.parametrize("n", [24, 37, 176])
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


@pytest.mark.parametrize("n,k", [(24, 1), (24, 3), (37, 1), (37, 3), (176, 1)])
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
    published as the next pivot.  The kernel's 4 x 4 register tiles (n = 33
    ... 108) change only which thread does which entry."""
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


def _small_lanes(n: int) -> int:
    """The lanes an instance takes in chol_batched's small-order schedule:
    the power of two at or above n (csrc/chol_batched.cu small_lanes)."""
    return 1 << max(0, n - 1).bit_length()


def _warp_row_order(H: torch.Tensor) -> torch.Tensor:
    """chol_batched's small-order schedule (n <= 32): a warp holds
    G = 32 / W instances (W = `_small_lanes(n)` lanes each; the batch's
    last warp is filled with identity instances), lane i holding row i of
    its instance's lower triangle.  Step j: the pivot is row j's entry j;
    every lane divides its entry j by the pivot's square root (lanes above
    row j divide 1), publishes the quotient as column j (an instance past
    the batch publishes zeros), and subtracts quotient x column entry from
    each of its entries k > j.  The identity instances' pivots must stay 1
    (they divide nothing by zero; their factors are never written)."""
    B, n, _ = H.shape
    G = 32 // _small_lanes(n)
    pad = -B % G
    eye = torch.eye(n, dtype=H.dtype).expand(pad, n, n)
    acc = torch.cat([torch.tril(H), eye]).reshape(-1, G, n, n)  # (warp, g, i, k)
    live_inst = torch.arange(B + pad).reshape(-1, G) < B
    row = torch.arange(n)
    for j in range(n):
        d = torch.sqrt(acc[:, :, j, j])                         # lane j's pivot
        assert bool((d[~live_inst] == 1).all())
        own = live_inst[:, :, None] & (row >= j)
        num = torch.where(own, acc[:, :, :, j], torch.ones_like(acc[:, :, :, j]))
        q = num / d[:, :, None]
        acc[:, :, :, j] = q
        cv = torch.where(live_inst[:, :, None], q, torch.zeros_like(q))
        acc[:, :, :, j + 1:] = acc[:, :, :, j + 1:] - q[..., None] * cv[:, :, None, j + 1:]
    return torch.tril(acc).reshape(-1, n, n)[:B]


def _warp_pair_order(L: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """tri_pair_batched's small-order schedule (n <= 32): a warp solves all
    k columns of G instances, U = 32 // n column units at once (lanes
    u n + i), G = max(1, U // k), the warp's G k units in passes of U.  In a
    pass, each unit's chain: forward, step j divides row j's x by L_jj, and
    every row i > j subtracts L[i][j] times it; backward, step j (n - 1
    down) the same for rows i < j with L[j][i].  The units of a pass step
    together; each unit's own operations keep the plain order."""
    B, n, k = rhs.shape
    per_pass = 32 // n
    G = 1 if k >= per_pass else per_pass // k
    X = torch.empty_like(rhs)
    diag = torch.diagonal(L, dim1=1, dim2=2)
    for first in range(0, B, G):
        units = [(first + u // k, u % k) for u in range(min(G, B - first) * k)]
        for base in range(0, len(units), per_pass):
            inst, col = map(torch.tensor, zip(*units[base:base + per_pass]))
            Lp, piv = L[inst], diag[inst]
            x = rhs[inst, :, col].clone()                       # (units, n)
            for j in range(n):
                q = x[:, j] / piv[:, j]
                x[:, j + 1:] = x[:, j + 1:] - Lp[:, j + 1:, j] * q[:, None]
                x[:, j] = q
            for j in range(n - 1, -1, -1):
                q = x[:, j] / piv[:, j]
                x[:, :j] = x[:, :j] - Lp[:, j, :j] * q[:, None]
                x[:, j] = q
            X[inst, :, col] = x
    return X


def _tiles_dataflow_order(H: torch.Tensor, grid: int, seed: int = 0,
                          nb: int = 32) -> torch.Tensor:
    """chol_batched's tile dataflow above the register tiles
    (csrc/chol_tiles.cuh), its protocol as well as its arithmetic: `grid`
    blocks are coroutines that take tickets from one counter, dealt
    ticket-major over groups of min(B, grid // 2) instances; ticket 0 of an
    instance is its walker, the rest its jobs; every wait on a tile's flag
    yields, and the blocks run in a random order (`seed`).  Each tile
    applies the updates, factors and solves of the kernel in its order:
    panel by panel, one column t at a time.  Raises if every block waits
    (a deadlock) and returns the factors otherwise."""
    Bn, n, _ = H.shape
    nt = -(-n // nb)
    N = nt * nb
    per = nt * (nt + 1) // 2 - 2 if nt >= 3 else 1
    group = Bn if Bn < grid // 2 else max(1, grid // 2)
    Hp = torch.zeros((Bn, N, N), dtype=H.dtype)
    Hp[:, :n, :n] = torch.tril(H)             # the kernel reads only this
    L = torch.zeros_like(Hp)
    flags = torch.zeros((Bn, nt, nt), dtype=torch.bool)
    roots = torch.zeros((Bn, N), dtype=H.dtype)
    counter = [0]

    def tile(X, b, i, c):
        return X[b, i * nb:(i + 1) * nb, c * nb:(c + 1) * nb]

    def wait(b, i, j):
        while not flags[b, i, j]:
            yield

    def update(A, Si, Sc):
        for t in range(nb):
            A -= Si[:, t, None] * Sc[None, :, t]

    def factor(A, cols):                      # the walker's column loop
        r = torch.ones(nb, dtype=A.dtype)
        for t in range(cols):
            r[t] = torch.sqrt(A[t, t])
            A[t:, t] = A[t:, t] / r[t]
            A[t + 1:, t + 1:] -= A[t + 1:, t, None] * A[None, t + 1:, t]
        return r

    def solve(A, D, r):                       # a tile's rows against D
        for t in range(nb):
            A[:, t] = A[:, t] / r[t]
            A[:, t + 1:] -= A[:, t, None] * D[None, t + 1:, t]

    def panels(b, A, I, C, p1):
        for P in range(p1):
            yield from wait(b, I, P)
            yield from wait(b, C, P)
            update(A, tile(L, b, I, P), tile(L, b, C, P))

    def walk(b):
        have_a, ahead, Sq = False, None, None
        for K in range(nt):
            if K < 2:
                D = tile(Hp, b, K, K).clone()
            elif not have_a:
                yield from wait(b, K - 2, K)
                D = tile(L, b, K, K).clone()
            else:
                D = ahead
            if K > 0:
                update(D, Sq, Sq)
            r = factor(D, min(nb, n - K * nb))
            tile(L, b, K, K)[:] = torch.tril(D)
            if K + 1 == nt:
                return
            roots[b, K * nb:(K + 1) * nb] = r
            flags[b, K, K] = True
            if K > 0:
                yield from wait(b, K, K + 1)
            have_a = K > 0 and bool(flags[b, K - 1, K + 1])
            Sp = tile(Hp if K == 0 else L, b, K + 1, K).clone()
            if have_a:
                ahead = tile(L, b, K + 1, K + 1).clone()
            solve(Sp, D, r)
            tile(L, b, K + 1, K)[:] = Sp
            flags[b, K + 1, K] = True
            Sq = Sp

    def job(b, k):
        for C in range(nt):
            full = max(0, nt - C - 2)
            if k < full:
                I, kind = C + 2 + k, 0
                break
            k -= full
            if C + 2 < nt:
                if k < 2:
                    I, kind = C + 2, 1 + k
                    break
                k -= 2
        if kind == 1:                         # tile (C + 2, C + 1)
            A = tile(Hp, b, I, C + 1).clone()
            yield from panels(b, A, I, C + 1, C + 1)
            tile(L, b, I, C + 1)[:] = A
            flags[b, C + 1, I] = True
        elif kind == 2:                       # tile (C + 2, C + 2)
            A = tile(Hp, b, I, I).clone()
            yield from panels(b, A, I, I, C + 1)
            tile(L, b, I, I)[:] = torch.tril(A)
            flags[b, C, I] = True
        else:                                 # tile (I, C), I >= C + 2
            A = tile(Hp, b, I, C).clone()
            yield from panels(b, A, I, C, C)
            yield from wait(b, C, C)
            solve(A, tile(L, b, C, C), roots[b, C * nb:(C + 1) * nb])
            tile(L, b, I, C)[:] = A
            flags[b, I, C] = True

    def block():
        while counter[0] < Bn * per:
            ticket = counter[0]
            counter[0] += 1
            g, r = divmod(ticket, group * per)
            size = min(group, Bn - g * group)
            k, inst = divmod(r, size)
            if k == 0:
                yield from walk(g * group + inst)
            else:
                yield from job(g * group + inst, k - 1)

    rng = np.random.default_rng(seed)
    blocks = [block() for _ in range(grid)]
    stalled = 0          # rounds in which no ticket was taken and no flag set
    while blocks:
        state = (counter[0], int(flags.sum()))
        blocks = [blocks[i] for i in rng.permutation(len(blocks))
                  if next(blocks[i], StopIteration) is not StopIteration]
        stalled = stalled + 1 if (counter[0], int(flags.sum())) == state else 0
        # a block passes at most 2 nt waits without setting a flag
        assert stalled <= 2 * nt + 2, "every block waits: the dataflow deadlocked"
    return L[:, :n, :n]


def _block_pair_order(L: torch.Tensor, rhs: torch.Tensor, nb: int = 32) -> torch.Tensor:
    """tri_pair_batched above its warp-per-instance panels
    (csrc/tri_pair_panels.cuh: a block for each instance and up to 4 rhs
    columns, which share nothing): per 32-row panel, the chain warp first
    applies the last panel's quotients to the panel's rows (the lookahead),
    then runs the panel's steps; the row threads apply the last panel's
    quotients to the rows beyond this panel, one panel late.  Forward top
    down, every x divided by its pivot, backward bottom up, every x divided
    again."""
    n = L.shape[-1]
    X = rhs.clone()
    diag = torch.diagonal(L, dim1=1, dim2=2)[..., None]       # (B, n, 1)

    def coef(j, rows, forward):                 # L[i][j] or L[j][i], rows i
        return L[:, rows, j, None] if forward else L[:, j, rows, None]

    for forward in (True, False):
        starts = range(0, n, nb)
        last = []                               # the last panel's (j, q)
        for a in (starts if forward else reversed(starts)):
            e = min(n, a + nb)
            rows = slice(a, e)
            beyond = slice(e, n) if forward else slice(0, a)
            for j, q in last:                   # the chain's lookahead
                X[:, rows] -= coef(j, rows, forward) * q[:, None]
            for j, q in last:                   # the row threads
                X[:, beyond] -= coef(j, beyond, forward) * q[:, None]
            last = []
            for j in (range(a, e) if forward else range(e - 1, a - 1, -1)):
                q = X[:, j] / diag[:, j]
                below = slice(j + 1, e) if forward else slice(a, j)
                X[:, below] -= coef(j, below, forward) * q[:, None]
                last.append((j, q))
        X = X / diag
    return X


# n across the micro-tile (4) and panel (32) edges and config 3's n = 102,
# up to n = 169 (the microtile and panel schedules, which the card runs
# above n = 32, the microtile one up to n = 108); then the small-order schedules (n <= 32) across
# their lane buckets (half a warp an instance up to n = 16), config 4's
# n = 10 (k = 8) and config 5's n = 21 and 1; then the schedules above the
# register tiles and the warp panels (the card runs them from n = 109 and
# 257; their order depends on the tile count, 3 and 4 here, not on n)
BATCHED_SCHEDULE_CASES = (
    [("chol", d, n, 0) for d in ("f64", "f32")
     for n in (1, 2, 3, 4, 5, 31, 32, 33, 65, 102, 108, 109, 169)]
    + [("pair", d, n, k) for d in ("f64", "f32")
       for n in (1, 2, 31, 32, 33, 65, 102, 169) for k in (1, 3)]
    + [("warp_chol", d, n, 0) for d in ("f64", "f32")
       for n in (1, 2, 8, 10, 16, 17, 21, 31, 32)]
    + [("warp_pair", d, n, k) for d in ("f64", "f32")
       for n in (1, 2, 8, 10, 16, 17, 21, 31, 32) for k in (1, 3, 8)]
    + [("dataflow", d, n, 0) for d in ("f64", "f32") for n in (65, 97)]
    + [("block_pair", d, n, k) for d in ("f64", "f32") for n in (65, 97)
       for k in (1, 5)])


@pytest.mark.parametrize("schedule,dtype,n,k", BATCHED_SCHEDULE_CASES)
def test_batched_kernel_schedule_is_the_plain_order(schedule, dtype, n, k):
    """B = 3 instances through each batched kernel's schedule: bit-equal to
    the plain loops (torch.equal) in f64 and f32."""
    rng = np.random.default_rng(1000 + n + k)
    H = torch.as_tensor(_spd(rng, n, kappa=1e8 if dtype == "f64" else 1e4)[:3],
                        dtype=torch.float64 if dtype == "f64" else torch.float32)
    if schedule.endswith("pair"):
        L = chol.chol_batched_plain(H)
        rhs = torch.as_tensor(rng.standard_normal((3, n, k)), dtype=H.dtype)
        order = {"pair": _batched_pair_order, "warp_pair": _warp_pair_order,
                 "block_pair": _block_pair_order}[schedule]
        got, want = order(L, rhs), chol.tri_pair_batched_plain(L, rhs)
    elif schedule == "dataflow":
        # grid 2: a group of one instance, walked after another's; grid 8:
        # all three walkers at once
        want = chol.chol_batched_plain(H)
        for grid in (2, 8):
            assert torch.equal(_tiles_dataflow_order(H, grid, seed=grid), want)
        got = _tiles_dataflow_order(H, 4, seed=n)
    else:
        order = _warp_row_order if schedule == "warp_chol" else _microtile_order
        got, want = order(H), chol.chol_batched_plain(H)
    assert bool(torch.isfinite(want).all())
    assert torch.equal(got, want)


def test_solve_batch_of_portfolios_above_the_register_tiles():
    """The slice at a CPU size: solve_batch of B = 3 portfolio(s, n=180,
    k=8), s = 0, 1, 2 (H of order 180, above the register tiles: the card
    factors it with the tile dataflow and solves with the warp panels), on
    the CPU against socp_tpu.solve_batch: the same status and
    iterations lane for lane (ROADMAP.md queue 3 lets iteration counts
    differ; on this batch they agree), every lane OPTIMAL, pcost within
    1e-8 relative."""
    probs = [portfolio(s, n=180, k=8)[0] for s in range(3)]
    data = {f: np.stack([getattr(p, f) for p in probs])
            for f in ("c", "G", "h", "A", "b")}
    c, G, h = data.pop("c"), data.pop("G"), data.pop("h")
    ref = socp_tpu.solve_batch(c, G, h, probs[0].dims, **data)
    out = socp_tpu_torch.solve_batch(c, G, h, probs[0].dims, **data,
                                     device="cpu")
    iters = [(r.iterations, o.iterations) for r, o in zip(ref, out)]
    for r, o in zip(ref, out):
        assert o.status == int(r.status) == socp_tpu_torch.Status.OPTIMAL, iters
        assert o.iterations == r.iterations, iters
        assert abs(o.pcost - r.pcost) <= 1e-8 * max(1.0, abs(r.pcost)), iters


@pytest.mark.parametrize("dtype,n,Bn", [
    ("f64", 177, 2), ("f64", 177, 3), ("f64", 257, 2), ("f64", 257, 3),
    ("f32", 253, 2), ("f32", 253, 3), ("f32", 257, 2), ("f32", 257, 3)])
def test_routers_send_every_order_to_the_batched_wrappers_once(
        dtype, n, Bn, monkeypatch):
    """Above the orders the batched kernels once refused (f64 169, f32
    240; the pair solves' 256), the routers make one batched call each for
    the whole batch, never a call per instance, and give the bits of the
    plain loops and of B single calls."""
    calls = []
    for name in ("chol_single", "chol_batched", "tri_pair_single",
                 "tri_pair_batched"):
        fn = getattr(chol, name)

        def spy(*args, _fn=fn, _name=name):
            calls.append(_name)
            return _fn(*args)

        monkeypatch.setattr(chol, name, spy)
    rng = np.random.default_rng(n + Bn)
    H = torch.as_tensor(_spd(rng, n, kappa=1e8 if dtype == "f64" else 1e4)[:Bn],
                        dtype=torch.float64 if dtype == "f64" else torch.float32)
    rhs = torch.as_tensor(rng.standard_normal((Bn, n, 1)), dtype=H.dtype)
    L = chol.cholesky(H)
    X = chol.tri_pair_solve(L, rhs)
    assert calls == ["chol_batched", "tri_pair_batched"]
    assert torch.equal(L, chol.chol_batched_plain(H))
    assert torch.equal(X, chol.tri_pair_batched_plain(L, rhs))
    assert torch.equal(L, torch.stack([chol.chol_single_plain(h) for h in H]))
    assert torch.equal(X, torch.stack([chol.tri_pair_single_plain(l, r)
                                       for l, r in zip(L, rhs)]))
    assert bool(torch.isfinite(X).all())


@pytest.mark.parametrize("ints", [-1, 0, 7])
def test_tile_dataflow_scratch_is_sized_by_its_query(ints):
    """The scratch buffer the wrappers hand the tile dataflow: int32 of the
    size the source's query gives, none for none, and a refusal where the
    query says its counters cannot address the shape (a negative size)."""
    H = torch.zeros(2, 3, 3, dtype=torch.float64)
    if ints < 0:
        with pytest.raises(ValueError, match="more scratch"):
            chol._scratch(H, ints)
        return
    s = chol._scratch(H, ints)
    if ints == 0:
        assert s is None
    else:
        assert s.dtype == torch.int32 and s.shape == (ints,)
        assert s.device == H.device
