"""The port's single-instance path (device="cpu": the kernels' plain
versions) against the reference, on the CPU.

  chol_single      vs socp_tpu.ops.pallas_chol.cholesky_dd (interpret mode)
  tri_pair_single  vs socp_tpu.ops.pallas_chol.tri_pair_solve
  solve            vs socp_tpu.solve

Kernel inputs: SPD matrices with kappa = 1e8 from a numpy seed, converted
to dd for the reference with `ddm.from_f64` and back with `astype_f64`.
Tolerances are the reference's own for these kernels (tests/test_pallas.py:
38-53 and 71-87): Cholesky rtol 1e-9 / atol 1e-11, pair solve rtol 1e-10 /
atol 1e-12.  Solves are held to equal status, pcost to 1e-8 relative and x
to atol 1e-7, except on config 1: its optimal x is not unique (the returned
x lies 2.25 from the constructed x*, with equal pcost), and there the two
packages' x agree to 4e-7, so x is held to atol 1e-6.  Iteration counts are
compared and reported in the assertion message (equal in every case here).
The reference runs four distinct `solve` compiles in this file.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import socp_tpu
import socp_tpu_torch
from socp_tpu import SolverConfig as RConfig
from socp_tpu.models import portfolio as rportfolio
from socp_tpu.models import random_socp as rrandom
from socp_tpu.ops import dd as ddm
from socp_tpu.ops.pallas_chol import cholesky_dd, tri_pair_solve
from socp_tpu_torch import SolverConfig
from socp_tpu_torch.carry import problem_from_reference
from socp_tpu_torch.models import portfolio, random_socp
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


def _spd(rng, n, kappa=1e8):
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    ev = np.logspace(-np.log10(kappa), 0, n)
    H = (Q * ev) @ Q.T
    return (H + H.T) / 2


# ---- kernels' plain versions -------------------------------------------


@pytest.mark.parametrize("n", [24, 37])
def test_chol_single_plain_matches_pallas(n):
    H = _spd(np.random.default_rng(n), n)
    ref = jax.jit(cholesky_dd)(ddm.from_f64(jnp.asarray(H)))
    L = chol.chol_single(torch.as_tensor(H))
    np.testing.assert_allclose(L.numpy(), np.asarray(ref.astype_f64()),
                               rtol=1e-9, atol=1e-11)


@pytest.mark.parametrize("n,k", [(24, 1), (37, 3)])
def test_tri_pair_single_plain_matches_pallas(n, k):
    rng = np.random.default_rng(100 + n + k)
    L = chol.chol_single_plain(torch.as_tensor(_spd(rng, n)))
    b = rng.standard_normal((n, k))
    Ld = ddm.from_f64(jnp.asarray(L.numpy()))
    LT = ddm.DD(Ld.hi.T, Ld.lo.T)
    ref = jax.jit(tri_pair_solve)(Ld, LT, ddm.from_f64(jnp.asarray(b)))
    x = chol.tri_pair_single(L, torch.as_tensor(b))
    np.testing.assert_allclose(x.numpy(), np.asarray(ref.astype_f64()),
                               rtol=1e-10, atol=1e-12)


def test_single_plain_versions_match_numpy_at_n200():
    """n = 200: seven tiles of the kernel's dataflow."""
    rng = np.random.default_rng(200)
    H = _spd(rng, 200)
    L = chol.chol_single(torch.as_tensor(H))
    np.testing.assert_allclose(L.numpy(), np.linalg.cholesky(H),
                               rtol=1e-9, atol=1e-11)
    b = rng.standard_normal((200, 3))
    x = chol.tri_pair_single(L, torch.as_tensor(b))
    Ln = L.numpy()
    ref = np.linalg.solve(Ln.T, np.linalg.solve(Ln, b))
    np.testing.assert_allclose(x.numpy(), ref, rtol=1e-10, atol=1e-12)


# ---- the kernels' schedules, step for step (csrc/chol_single.cu and
# csrc/tri_pair_single.cu): each must round every entry as the plain loops do


def _tile_order(H: torch.Tensor, nb: int = 32) -> torch.Tensor:
    """chol_single's tile dataflow, column of tiles by column of tiles (the
    kernel's blocks may finish tiles in another order, but every entry sees
    the same steps): tile (I, C) applies panels P < C one column t at a
    time, then the diagonal tile runs the column loop and keeps its square
    roots, and a tile below it solves its rows right-looking against them."""
    n = H.shape[0]
    nt = -(-n // nb)
    L = torch.zeros_like(H)
    piv = torch.zeros(n, dtype=H.dtype)
    for C in range(nt):
        for I in range(C, nt):
            rs, cs = slice(I * nb, min(n, I * nb + nb)), slice(C * nb, min(n, C * nb + nb))
            A = H[rs, cs].clone()
            for P in range(C):
                ps = slice(P * nb, P * nb + nb)
                Li, Lc = L[rs, ps], L[cs, ps]
                for t in range(nb):
                    A -= Li[:, t, None] * Lc[None, :, t]
            if I == C:
                for t in range(A.shape[0]):
                    piv[C * nb + t] = torch.sqrt(A[t, t])
                    A[t:, t] = A[t:, t] / piv[C * nb + t]
                    A[t + 1:, t + 1:] -= A[t + 1:, t, None] * A[None, t + 1:, t]
                L[rs, cs] = torch.tril(A)
            else:
                D = L[cs, cs]
                for t in range(nb):
                    A[:, t] = A[:, t] / piv[C * nb + t]
                    A[:, t + 1:] -= A[:, t, None] * D[None, t + 1:, t]
                L[rs, cs] = A
    return L


def _pair_order(L: torch.Tensor, rhs: torch.Tensor, nb: int = 32) -> torch.Tensor:
    """tri_pair_single's panels: per panel, the chain's 32 steps on the
    panel's own rows, then the rows beyond it take the panel's quotients
    in step order; forward from the top, backward from the bottom."""
    n = L.shape[0]
    X = rhs.clone()
    diag = torch.diagonal(L)[:, None]
    for j0 in range(0, n, nb):
        j1 = min(n, j0 + nb)
        qs = []
        for j in range(j0, j1):
            q = X[j] / diag[j]
            X[j + 1:j1] -= L[j + 1:j1, j, None] * q
            qs.append(q)
        for t, q in enumerate(qs):
            X[j1:] -= L[j1:, j0 + t, None] * q
    X = X / diag
    for b in range(n, 0, -nb):
        a = max(0, b - nb)
        qs = []
        for j in range(b - 1, a - 1, -1):
            q = X[j] / diag[j]
            X[a:j] -= L[j, a:j, None] * q
            qs.append(q)
        for t, q in enumerate(qs):
            X[:a] -= L[b - 1 - t, :a, None] * q
    return X / diag


SCHEDULE_CASES = (
    [("tiles", d, n, 0) for d in ("f64", "f32")
     for n in (1, 2, 31, 32, 33, 65, 203)]
    + [("pair", d, n, k) for d in ("f64", "f32") for n in (31, 32, 33, 65, 203)
       for k in (1, 5)])


@pytest.mark.parametrize("schedule,dtype,n,k", SCHEDULE_CASES)
def test_kernel_schedule_is_the_plain_order(schedule, dtype, n, k):
    """Both kernels' schedules and the plain loops round every entry alike,
    so the card checks both kernels bit for bit.  n straddles the panel and
    tile edges (32)."""
    rng = np.random.default_rng(n + k)
    if dtype == "f64":
        H = torch.as_tensor(_spd(rng, n))
    else:
        H = torch.as_tensor(_spd(rng, n, kappa=1e4), dtype=torch.float32)
    if schedule == "pair":
        L = chol.chol_single_plain(H)
        rhs = torch.as_tensor(rng.standard_normal((n, k)), dtype=H.dtype)
        got, want = _pair_order(L, rhs), chol.tri_pair_single_plain(L, rhs)
    else:
        got, want = _tile_order(H), chol.chol_single_plain(H)
    assert bool(torch.isfinite(want).all())
    assert torch.equal(got, want)


def test_cpu_tensors_take_the_plain_path_and_launch_nothing():
    before = (chol.chol_single_launches, chol.tri_pair_single_launches)
    rng = np.random.default_rng(4)
    H = torch.as_tensor(_spd(rng, 12))
    rhs = torch.as_tensor(rng.standard_normal((12, 2)))
    L = chol.chol_single(H)
    assert torch.equal(L, chol.chol_single_plain(H))
    assert torch.equal(chol.tri_pair_single(L, rhs),
                       chol.tri_pair_single_plain(L, rhs))
    assert (chol.chol_single_launches, chol.tri_pair_single_launches) == before


@pytest.mark.parametrize("B", [1, 3])
def test_router_sends_one_instance_to_the_single_kernels(B, monkeypatch):
    calls = []
    for name in ("chol_single", "chol_batched", "tri_pair_single",
                 "tri_pair_batched"):
        fn = getattr(chol, name)

        def spy(*args, _fn=fn, _name=name):
            calls.append(_name)
            return _fn(*args)

        monkeypatch.setattr(chol, name, spy)
    rng = np.random.default_rng(B)
    H = torch.as_tensor(np.stack([_spd(rng, 9) for _ in range(B)]))
    rhs = torch.as_tensor(rng.standard_normal((B, 9, 2)))
    L = chol.cholesky(H)
    X = chol.tri_pair_solve(L, rhs)
    kind = "single" if B == 1 else "batched"
    assert calls == [f"chol_{kind}", f"tri_pair_{kind}"]
    assert L.shape == H.shape and X.shape == rhs.shape
    assert torch.equal(L, chol.chol_batched_plain(H))
    assert torch.equal(X, chol.tri_pair_batched_plain(L, rhs))


def test_single_tiny_shapes_and_non_pd():
    assert chol.chol_single(torch.zeros(0, 0, dtype=torch.float64)).shape == (0, 0)
    L = chol.chol_single(torch.full((1, 1), 4.0, dtype=torch.float64))
    assert torch.equal(L, torch.full((1, 1), 2.0, dtype=torch.float64))
    x = chol.tri_pair_single(L, torch.ones(1, 3, dtype=torch.float64))
    assert torch.equal(x, torch.full((1, 3), 0.25, dtype=torch.float64))
    H = _spd(np.random.default_rng(3), 24)
    H[0, 0] = -1.0
    assert not bool(torch.isfinite(chol.chol_single(torch.as_tensor(H))).all())


@pytest.mark.parametrize("bad", ["dtype", "batch", "shape"])
def test_single_wrappers_reject_what_the_kernels_do_not_take(bad):
    H = torch.eye(4, dtype=torch.float64)
    if bad == "dtype":
        # float64 and float32 have kernels; other dtypes have none
        with pytest.raises(TypeError):
            chol.chol_single(H.half())
    elif bad == "batch":
        with pytest.raises(ValueError, match=r"\(n, \*\) matrix"):
            chol.chol_single(H[None])
    else:
        with pytest.raises(ValueError):
            chol.tri_pair_single(H, torch.ones(3, 1, dtype=torch.float64))


# ---- the single solve ---------------------------------------------------


def _config1():
    prob, known = rrandom.random_socp(0, n=50, l=10, qs=(10, 14, 20))
    return prob, {}, 1e-6, known


CASES = {
    "config1_n50": _config1,
    "portfolio_n64": lambda: (rportfolio.portfolio(0, n=64, k=8)[0], {},
                              1e-7, None),
    "primal_infeasible_soc": lambda: (rrandom.primal_infeasible_soc(0), {},
                                      1e-7, None),
    "portfolio_gondzio1": lambda: (rportfolio.portfolio(7, n=60, k=8)[0],
                                   {"gondzio_correctors": 1}, 1e-7, None),
}


def _compare(ref, out, x_atol, label):
    iters = f"{label}: iterations ref {ref.iterations} port {out.iterations}"
    assert out.status == int(ref.status), iters
    rel = abs(out.pcost - ref.pcost) / max(1.0, abs(ref.pcost))
    assert rel <= 1e-8, f"pcost rel {rel}; {iters}"
    np.testing.assert_allclose(out.x, ref.x, rtol=0, atol=x_atol, err_msg=iters)
    assert out.s.shape == ref.s.shape and out.z.shape == ref.z.shape


@pytest.mark.parametrize("case", sorted(CASES))
def test_solve_matches_reference(case):
    prob, cfg, x_atol, known = CASES[case]()
    ref = socp_tpu.solve(prob, config=RConfig(**cfg))
    out = socp_tpu_torch.solve(problem_from_reference(prob),
                               config=SolverConfig(**cfg), device="cpu")
    assert isinstance(out, socp_tpu_torch.Solution)
    _compare(ref, out, x_atol, case)
    if known is not None:
        assert abs(out.pcost - known.pcost) <= 1e-6 * max(1.0, abs(known.pcost))


def test_warm_restart_matches_reference():
    """Config 1 with a perturbed h, started from the reference's solution of
    the unperturbed problem (unpadded, as `solve(warm=...)` takes it): the
    port's warm solve against the reference's cold solve of the same
    problem (the compile of config 1 again).  Fewer iterations than cold.

    This holds the warm solve's result, not its iterates: the reference's
    warm solve would be one more compile, and warm_push recenters s and z,
    so a fault in padding the warm s and z that still converges to the
    same optimum passes here."""
    prob, _, x_atol, _ = _config1()
    r0 = socp_tpu.solve(prob)
    moved = copy.deepcopy(prob)
    moved.h = prob.h + 1e-3 * np.random.default_rng(5).normal(size=prob.h.shape)
    ref = socp_tpu.solve(moved)
    port = problem_from_reference(moved)
    out = socp_tpu_torch.solve(port, warm=(r0.x, r0.y, r0.s, r0.z),
                               device="cpu")
    assert out.status == int(ref.status) == 0
    rel = abs(out.pcost - ref.pcost) / max(1.0, abs(ref.pcost))
    assert rel <= 1e-8, rel
    cold = socp_tpu_torch.solve(port, device="cpu")
    assert out.iterations < cold.iterations == ref.iterations


@pytest.mark.parametrize("model", ["random_socp", "random_socp_quadratic",
                                   "portfolio", "infeasible"])
def test_model_copies_are_bit_equal(model):
    def same(a, b):
        assert type(a).__name__ == type(b).__name__
        for f in ("c", "G", "h", "A", "b", "P"):
            fa, fb = getattr(a, f), getattr(b, f)
            assert (fa is None) == (fb is None), f
            if fa is not None:
                np.testing.assert_array_equal(fa, fb, err_msg=f)
        assert (a.dims.l, a.dims.qs) == (b.dims.l, b.dims.qs)

    if model.startswith("random_socp"):
        kw = dict(n=50, l=10, qs=(10, 14, 20), quadratic=model.endswith("c"))
        (p, kp), (r, kr) = random_socp.random_socp(3, **kw), rrandom.random_socp(3, **kw)
        same(p, r)
        for f in ("x", "y", "s", "z", "pcost"):
            np.testing.assert_array_equal(getattr(kp, f), getattr(kr, f))
    elif model == "portfolio":
        (p, ip), (r, ir) = portfolio.portfolio(0), rportfolio.portfolio(0)
        same(p, r)
        for f in ip:
            np.testing.assert_array_equal(ip[f], ir[f])
        w = np.full(500, 1 / 500)
        assert portfolio.portfolio_risk(ip, w) == rportfolio.portfolio_risk(ir, w)
    else:
        for name in ("primal_infeasible_lp", "dual_infeasible_lp",
                     "primal_infeasible_soc", "dual_infeasible_soc"):
            p, r = getattr(random_socp, name)(2), getattr(rrandom, name)(2)
            same(p, r)
    same(problem_from_reference(r), p)
