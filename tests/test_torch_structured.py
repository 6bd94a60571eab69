"""The port's structured KKT assembly (kkt/structured.py, the route of
SolverConfig(native_dd=True)) against the reference's dd-native algebra
(socp_tpu.cones.dd_ops, socp_tpu.kkt.dd_dense, ipm/dd_driver) and against
the port's own scaled-matrix assembly (kkt/dense.py), f64 on the CPU.

Tolerances: the W^-2 helpers 1e-12 relative to the reference's dd (each
entry, or 1e-12 of the largest entry where it cancels); directions 1e-10
against kkt/dense at a shared scaling, and test_dd_kkt.py's own rtol 1e-8,
atol 1e-9 x scale against the reference's solve_dd; whole solves by status
and pcost (1e-9 against the reference's native_dd driver, 2e-8 against
its f64 one, as tests/test_dd_driver.py holds the reference's two
drivers; 1e-8 on a batch).  Iteration counts are printed, not held
equal (ROADMAP.md queue 3: not a fault).  The reference runs jitted, one
compile per case: its dd graphs are most of this file's time."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import socp_tpu
import socp_tpu_torch
from socp_tpu import SolverConfig as RConfig
from socp_tpu.cones import dd_ops
from socp_tpu.cones.layout import make_layout as rmake_layout
from socp_tpu.kkt import dd_dense
from socp_tpu.models import random_socp as random_socp_ref
from socp_tpu.models.portfolio import portfolio as rportfolio
from socp_tpu.models.robust_ls import robust_ls as rrobust_ls
from socp_tpu.models.robust_ls import robust_ls_batch
from socp_tpu.ops import dd as ddm
from socp_tpu.ops.ozaki import preslice
from socp_tpu.problem import ConeDims as RConeDims
from socp_tpu_torch import SolverConfig
from socp_tpu_torch.carry import problem_from_reference
from socp_tpu_torch.cones import ops as tops
from socp_tpu_torch.cones.layout import make_layout
from socp_tpu_torch.kkt import dense as tdense
from socp_tpu_torch.kkt import structured
from socp_tpu_torch.kkt.dense import _dot, _mtv, _mv
from socp_tpu_torch.models.random_socp import random_socp
from socp_tpu_torch.problem import ConeDims
from tests.test_dd_cones import _interior
from tests._host_memory import release_host_memory  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """On these shapes the port's CPU path is eager-op overhead, and
    torch's intra-op threads only contend with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


N = 8


def _close(got, want, rtol, atol_rel):
    """Each entry within rtol, or within atol_rel of the largest entry."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_rel * scale)


def _layouts(l, qs):
    return make_layout(ConeDims(l, qs)), rmake_layout(RConeDims(l, qs))


# ---- the W^-2 helpers (cones/ops.py) ------------------------------------

# tests/test_dd_cones.py's layouts, and one with a dim-1 SOC block
HELPER_CASES = [(5, (2, 3, 7)), (0, (4, 9, 17)), (3, (1, 2, 25)), (3, (1, 4, 9))]


@pytest.mark.parametrize("l,qs", HELPER_CASES)
def test_w2_helpers_match_reference(l, qs):
    """apply_W2, apply_Winv2, winv2_rho and winv2_columns against
    socp_tpu.cones.dd_ops on test_dd_cones.py's interior iterates; the
    port derives wbar = 2 v0 v - e from its scaling's v, the reference
    keeps wbar.  Also W^2 u against W (W u) in the port itself."""
    tl, rl = _layouts(l, qs)
    rdims = RConeDims(l, qs)
    rng = np.random.default_rng(0)
    s = rl.pad_vec(_interior(rng, rdims))
    z = rl.pad_vec(_interior(rng, rdims))
    u = rl.pad_vec(rng.normal(size=rdims.dim))

    @jax.jit
    def ref(s, z, u):
        sc = dd_ops.nt_scale(rl, ddm.from_f64(s), ddm.from_f64(z))
        ud = ddm.from_f64(u)
        V, w2 = dd_ops.winv2_columns(rl, sc)
        return [a.astype_f64() for a in (
            dd_ops.apply_W2(rl, sc, ud), dd_ops.apply_Winv2(rl, sc, ud),
            dd_ops.winv2_rho(rl, sc), V, w2)]

    want = ref(*(jnp.asarray(a) for a in (s, z, u)))
    t = lambda a: torch.as_tensor(a)[None]
    sc = tops.nt_scale(tl, t(s), t(z))
    V, w2 = tops.winv2_columns(tl, sc)
    got = [tops.apply_W2(tl, sc, t(u)), tops.apply_Winv2(tl, sc, t(u)),
           tops.winv2_rho(tl, sc), V, w2]
    assert V.shape == (1, tl.m_pad, len(qs)) and w2.shape == (1, len(qs))
    for g, w in zip(got, want):
        _close(g[0], w, 1e-12, 1e-12)

    WWu = tops.apply_W(tl, sc, tops.apply_W(tl, sc, t(u)))
    _close(got[0], WWu, 1e-13, 1e-13)
    WiWiu = tops.apply_Winv(tl, sc, tops.apply_Winv(tl, sc, t(u)))
    _close(got[1], WiWiu, 1e-13, 1e-13)


def test_const_gram_gate():
    """precompute_const_gram declines no SOC block and more than
    CONST_GRAM_MAX_BLOCKS (4) of them, as tests/test_dd_kkt.py holds the
    reference's."""
    assert structured.CONST_GRAM_MAX_BLOCKS == dd_dense.CONST_GRAM_MAX_BLOCKS == 4
    assert structured.STRUCT_MAX_BLOCKS == dd_dense.STRUCT_MAX_BLOCKS == 32
    rng = np.random.default_rng(23)
    for dims in (ConeDims(l=6, qs=()), ConeDims(l=0, qs=(3,) * 5)):
        layout = make_layout(dims)
        G = torch.as_tensor(layout.pad_rows(rng.normal(size=(2, dims.dim, 4))))
        assert structured.precompute_const_gram(layout, G) is None


@pytest.mark.parametrize("l,qs,want", [
    (0, (201, 101), "const_gram"),             # config 3: NB = 2
    (10, (10, 14, 20), "const_gram"),          # config 1: NB = 3, l > 0
    (500, (521,), "const_gram"),               # config 2: NB = 1
    (4, (3,) * 4, "const_gram"),
    (4, (3,) * 5, "structured"),
    (0, (2,) * 32, "structured"),
    (2, (3,) * 33, "dense"),
    (6, (), "structured"),                      # NB = 0: rho only
])
def test_route_by_block_count(l, qs, want):
    layout = make_layout(ConeDims(l, qs))
    G = torch.zeros((1, layout.m_pad, 2), dtype=torch.float64)
    cg = structured.precompute_const_gram(layout, G)
    assert structured.route(layout, cg) == want
    if want == "const_gram":
        nb = len(qs)
        assert cg.K.shape == (1, nb, 2, 2) and cg.g0.shape == (1, 2, nb)
        assert (cg.Go is None) == (l == 0)


# ---- factor and solve (kkt/structured.py) -------------------------------

# (l, qs, p, seed): tests/test_dd_kkt.py's ConstGram shapes (:102-106,
# seed 19) and its structured shapes (:24-28, seed 11)
KKT_CASES = [
    (0, (9, 17), 0, 19, "const_gram"),
    (5, (2, 3, 7), 0, 19, "const_gram"),
    (3, (1, 2, 25), 2, 19, "const_gram"),
    (5, (2, 3, 7), 0, 11, "structured"),
    (0, (4, 9, 17), 3, 11, "structured"),
    (3, (1, 2, 25), 2, 11, "structured"),
]


def _kkt_data(l, qs, p, seed):
    rdims = RConeDims(l, qs)
    rl = rmake_layout(rdims)
    rng = np.random.default_rng(seed)
    d = dict(s=rl.pad_vec(_interior(rng, rdims)),
             z=rl.pad_vec(_interior(rng, rdims)),
             G=rl.pad_rows(rng.normal(size=(rdims.dim, N))),
             A=rng.normal(size=(p, N)))
    d.update(bx=rng.normal(size=N), by=rng.normal(size=p),
             bz=rng.normal(size=rl.m_pad))
    return d


@pytest.mark.parametrize("l,qs,p,seed,how", KKT_CASES)
def test_structured_directions(l, qs, p, seed, how):
    """The port's ConstGram / structured directions three ways: against its
    scaled-matrix assembly (kkt/dense) at a shared scaling, against the
    reference's factor_dd + solve_dd by the same route, and the G dx it
    returns (and carries through refinement) against a fresh matvec."""
    tl, rl = _layouts(l, qs)
    d = _kkt_data(l, qs, p, seed)
    keys = ("s", "z", "G", "A", "bx", "by", "bz")

    @jax.jit
    def ref(s, z, G, A, bx, by, bz):
        s, z, G, A, bx, by, bz = (ddm.from_f64(a) for a in (s, z, G, A, bx, by, bz))
        sc = dd_ops.nt_scale(rl, s, z)
        cg = dd_dense.precompute_const_gram(rl, G) if how == "const_gram" else None
        kkt = dd_dense.factor_dd(rl, sc, None, A, G, 1e-12, GT_s=preslice(G.T),
                                 G_s=preslice(G), cg=cg)
        assert isinstance(kkt, dd_dense.DDKKTn)
        return [o.astype_f64() for o in dd_dense.solve_dd(rl, kkt, A, bx, by, bz)]

    want = ref(*(jnp.asarray(d[k]) for k in keys))
    t = {k: torch.as_tensor(d[k])[None] for k in keys}
    sc = tops.nt_scale(tl, t["s"], t["z"])
    cg = (structured.precompute_const_gram(tl, t["G"]) if how == "const_gram"
          else None)
    assert structured.route(tl, cg) == how
    kkt = structured.factor(tl, sc, None, t["A"], t["G"], 1e-12, cg=cg)
    assert isinstance(kkt, structured.StructKKT)
    dx, dy, dz, Gdx = structured.solve(tl, kkt, t["A"], t["bx"], t["by"],
                                       t["bz"], want_Gdx=True)
    kd = tdense.factor(tl, sc, None, t["A"], t["G"], 1e-12)
    dense_out = tdense.solve(tl, kd, t["A"], t["bx"], t["by"], t["bz"])

    for g, dn, w in zip((dx, dy, dz), dense_out, want):
        if not w.size:
            continue
        _close(g[0], dn[0], 1e-10, 1e-10)
        _close(g[0], w, 1e-8, 1e-9)
    assert torch.equal(Gdx, _mv(t["G"], dx))

    # two refinement rounds: the carried G dx against a fresh one a round
    steps = 2
    got = structured.solve_refined(tl, kkt, None, t["A"], t["G"], t["bx"],
                                   t["by"], t["bz"], refine_steps=steps)
    fresh = _refined_fresh_Gdx(tl, kkt, t["A"], t["G"], t["bx"], t["by"],
                               t["bz"], steps)
    for g, f in zip(got, fresh):
        _close(g, f, 1e-14, 1e-14)


def _refined_fresh_Gdx(layout, kkt, A, G, bx, by, bz, steps):
    """structured.solve_refined with G dx recomputed every round."""
    dx, dy, dz = structured.solve(layout, kkt, A, bx, by, bz)
    rhs_norm = torch.sqrt(_dot(bx, bx) + _dot(by, by) + _dot(bz, bz)) + 1.0
    for _ in range(steps):
        rx = bx - (_mtv(A, dy) + _mtv(G, dz))
        ry = by - _mv(A, dx)
        rz = bz - (_mv(G, dx) - tops.apply_W2(layout, kkt.scaling, dz))
        quality = torch.sqrt(_dot(rx, rx) + _dot(ry, ry) + _dot(rz, rz)) / rhs_norm
        ex, ey, ez = structured.solve(layout, kkt, A, rx, ry, rz)
        dx, dy, dz = dx + ex, dy + ey, dz + ez
    return dx, dy, dz, quality


# ---- whole solves with native_dd=True -----------------------------------

NATIVE = SolverConfig(native_dd=True)


@pytest.fixture
def no_ghat(monkeypatch):
    """Fails the test if W^-1 G is formed (the scaled-matrix assembly)."""
    def refuse(*args, **kwargs):
        raise AssertionError("scale_rows_Winv called on the native_dd route")

    monkeypatch.setattr(tops, "scale_rows_Winv", refuse)


def test_native_solve_matches_reference_native(no_ghat):
    """tests/test_dd_driver.py's robust_ls(0, n=12): the port's native_dd
    route (ConstGram, NB = 2) against the reference's native_dd driver,
    held as that file holds the reference's dd driver to its f64 one."""
    prob = rrobust_ls(0, n=12)[0]
    ref = socp_tpu.solve(prob, config=RConfig(native_dd=True))
    out = socp_tpu_torch.solve(problem_from_reference(prob), config=NATIVE,
                               device="cpu")
    print(f"iterations ref {ref.iterations} port {out.iterations}")
    assert int(out.status) == int(ref.status) == 0
    assert not out.inaccurate
    assert out.gap <= 1e-8 or out.relgap <= 1e-8
    assert abs(out.pcost - ref.pcost) <= 1e-9 * max(1.0, abs(ref.pcost))


def test_native_solve_with_equalities_matches_reference(no_ghat):
    """tests/test_dd_driver.py's portfolio(3, n=16, k=4) (p = 1, l = 16,
    NB = 1) with native_dd against the reference's f64 driver, at that
    file's 2e-8 (it holds the reference's native_dd driver to the same f64
    solve at 2e-8; compiling the former costs 75 s and 8.6 GB here)."""
    prob = rportfolio(3, n=16, k=4)[0]
    ref = socp_tpu.solve(prob)
    out = socp_tpu_torch.solve(problem_from_reference(prob), config=NATIVE,
                               device="cpu")
    print(f"iterations ref {ref.iterations} port {out.iterations}")
    assert int(out.status) == int(ref.status) == 0
    assert not out.inaccurate
    assert abs(out.pcost - ref.pcost) <= 2e-8 * max(1.0, abs(ref.pcost))
    np.testing.assert_allclose(out.x, ref.x, atol=1e-7)


def _mixed_status():
    """tests/test_batched.py:41-61: a primal-infeasible lane beside an
    optimal one (an orthant only: NB = 0, the rho-only assembly); the
    infeasible lane freezes early and its scaling runs on."""
    bad = random_socp_ref.primal_infeasible_lp(0)
    feas = copy.deepcopy(bad)
    feas.h = feas.h.copy()
    feas.h[1] = 2.0
    return (dict(c=np.stack([bad.c, feas.c]), G=np.stack([bad.G, feas.G]),
                 h=np.stack([bad.h, feas.h]), dims=bad.dims), {"max_iter": 80})


@pytest.mark.parametrize("case", ["robust_ls", "mixed_status"])
def test_native_batch_matches_reference(case, no_ghat):
    """robust_ls_batch(0, 8, n=16, k=24) (NB = 2, the ConstGram assembly)
    and a batch of mixed statuses with native_dd against the reference's
    (default) batched solve: statuses equal, pcost within 1e-8."""
    if case == "robust_ls":
        c, G, h, dims = robust_ls_batch(0, 8, n=16, k=24)
        data, cfg = dict(c=c, G=G, h=h, dims=dims), {}
    else:
        data, cfg = _mixed_status()
    ref = socp_tpu.solve_batch_raw(**data, config=RConfig(**cfg))
    out = socp_tpu_torch.solve_batch_raw(
        **data, config=SolverConfig(native_dd=True, **cfg), device="cpu")
    print(f"{case}: iterations ref {np.asarray(ref[5]).tolist()} "
          f"native {out[5].tolist()}")
    np.testing.assert_array_equal(out[4], np.asarray(ref[4]))
    if case == "mixed_status":
        assert out[4].tolist() == [int(socp_tpu_torch.Status.PRIMAL_INFEASIBLE),
                                   int(socp_tpu_torch.Status.OPTIMAL)]
    rp = np.asarray(ref[6])[:, 0]
    assert np.all(np.abs(out[6][:, 0] - rp) <= 1e-8 * np.maximum(1.0, np.abs(rp)))


def test_native_batch_matches_default_route(monkeypatch):
    """The same batch with native_dd against the port's default route
    (which does form W^-1 G): statuses equal, pcost within 1e-8."""
    c, G, h, dims = robust_ls_batch(0, 8, n=16, k=24)
    calls = []
    real = tops.scale_rows_Winv
    monkeypatch.setattr(tops, "scale_rows_Winv",
                        lambda *a: calls.append(1) or real(*a))
    default = socp_tpu_torch.solve_batch_raw(c, G, h, dims, device="cpu")
    assert calls
    monkeypatch.setattr(tops, "scale_rows_Winv", real)
    native = socp_tpu_torch.solve_batch_raw(c, G, h, dims, config=NATIVE,
                                            device="cpu")
    print(f"iterations default {default[5].tolist()} native {native[5].tolist()}")
    np.testing.assert_array_equal(native[4], default[4])
    rp = default[6][:, 0]
    assert np.all(np.abs(native[6][:, 0] - rp) <= 1e-8 * np.maximum(1.0, np.abs(rp)))


def test_structured_route_whole_solve(monkeypatch, no_ghat):
    """A layout of 6 SOC blocks (5 <= NB <= 32: the rho/V assembly) with
    equalities, native_dd against the default route."""
    prob = random_socp(0, n=20, l=4, qs=(3, 4, 3, 5, 3, 4), p=2)[0]
    layout = make_layout(prob.dims)
    G = torch.as_tensor(layout.pad_rows(prob.G))[None]
    assert structured.route(layout, structured.precompute_const_gram(
        layout, G)) == "structured"
    out = socp_tpu_torch.solve(prob, config=NATIVE, device="cpu")
    monkeypatch.undo()                       # the default route forms W^-1 G
    ref = socp_tpu_torch.solve(prob, device="cpu")
    print(f"iterations default {ref.iterations} native {out.iterations}")
    assert int(out.status) == int(ref.status) == 0
    assert abs(out.pcost - ref.pcost) <= 1e-8 * max(1.0, abs(ref.pcost))
