"""The port's block-Schur solve (socp_tpu_torch/parallel/schur.py) against
the reference's `socp_tpu.parallel.schur.solve_block` on a 1-device mesh,
on the CPU (the kernels' plain versions).

Three reference compiles in all (XLA-CPU, about 5 s each): config 4's
block shape at K = 32, the block QP with history (its primal-infeasible
variant has the same shapes and config, so it reuses the compile), and
one Gondzio corrector.  Sums over the blocks reduce in another order in
torch than in XLA, so the port is held to tolerances, not bits."""

import numpy as np
import pytest
import torch

from socp_tpu import SolverConfig as RefConfig
from socp_tpu.parallel.mesh import block_mesh
from socp_tpu.parallel.schur import random_block_problem as ref_problem
from socp_tpu.parallel.schur import solve_block as ref_solve_block
from socp_tpu.problem import ConeDims as RefConeDims
from socp_tpu_torch import SolverConfig, Status
from socp_tpu_torch.ops import chol
from socp_tpu_torch.parallel.schur import (BlockSocpProblem,
                                           random_block_problem, solve_block)
from socp_tpu_torch.problem import ConeDims
from tests._host_memory import release_host_memory  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """On these shapes the port's CPU path is eager-op overhead, and
    torch's intra-op threads only contend with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


C4_DIMS = dict(nb=10, p=8)          # config 4's block: l = 4, qs = (6,)


def _c4(seed, K):
    return ref_problem(seed, K=K, block_dims=RefConeDims(l=4, qs=(6,)),
                       **C4_DIMS)


def _qp(seed=2):
    """tests/test_schur.py's block QP: P = 0.5 I on every block."""
    prob, _ = ref_problem(seed, K=8, nb=6, p=3)
    K, nb = prob.c.shape
    prob.P = np.broadcast_to(0.5 * np.eye(nb), (K, nb, nb)).copy()
    return prob


def _infeasible_qp():
    """The QP with two contradictory orthant rows in block 0 (x_0 <= -1
    and x_0 >= 1); its other 12 rows keep rank(G_0) = nb."""
    prob = _qp()
    prob.G[0, :2] = 0.0
    prob.G[0, 0, 0], prob.G[0, 1, 0] = 1.0, -1.0
    prob.h[0, :2] = -1.0
    return prob


def _rel(a, b):
    return abs(a - b) / max(1.0, abs(b))


@pytest.fixture(scope="module")
def ref_c4():
    prob, pstar = _c4(0, 32)
    return prob, pstar, ref_solve_block(prob, mesh=block_mesh(1))


@pytest.fixture(scope="module")
def ref_qp():
    cfg = RefConfig(collect_history=True)
    return {name: (prob, ref_solve_block(prob, mesh=block_mesh(1), config=cfg))
            for name, prob in (("qp", _qp()), ("infeasible", _infeasible_qp()))}


@pytest.fixture(scope="module")
def ref_gondzio():
    prob, _ = ref_problem(4, K=4, nb=6, p=3)
    return prob, ref_solve_block(prob, mesh=block_mesh(1),
                                 config=RefConfig(gondzio_correctors=1))


@pytest.mark.parametrize("seed", [0, 1])
def test_generator_equals_reference(seed):
    ref, ref_pstar = _c4(seed, 16)
    port, pstar = random_block_problem(seed, K=16,
                                       block_dims=ConeDims(l=4, qs=(6,)),
                                       **C4_DIMS)
    assert pstar == ref_pstar
    for f in ("c", "G", "h", "A", "b"):
        np.testing.assert_array_equal(getattr(port, f), getattr(ref, f))
    assert port.P is None and port.block_dims == ConeDims(4, (6,))


def test_config4_block_shape_matches_reference(ref_c4):
    prob, pstar, ref = ref_c4
    out = solve_block(prob, device="cpu")
    assert out[4] == ref[4] == Status.OPTIMAL
    assert out[5] == ref[5]
    for j in (0, 1):                                # pcost, dcost
        assert _rel(out[6][j], ref[6][j]) <= 1e-9, (j, out[6][j], ref[6][j])
    assert _rel(out[6][0], pstar) <= 1e-6
    assert out[6][6] == ref[6][6] == 0.0
    for i, name in enumerate("xysz"):
        assert out[i].shape == ref[i].shape, name
        np.testing.assert_allclose(out[i], ref[i], rtol=0, atol=1e-6,
                                   err_msg=name)


def test_port_problem_gives_the_reference_problems_solve(ref_c4):
    """solve_block reads a reference BlockSocpProblem by its fields: the
    port's copy of the same instance gives the same bits."""
    prob = ref_c4[0]
    port = BlockSocpProblem(c=prob.c, G=prob.G, h=prob.h,
                            block_dims=ConeDims(4, (6,)), A=prob.A, b=prob.b)
    a = solve_block(prob, device="cpu")
    b = solve_block(port, device="cpu", dtype=np.float64)
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u, v)


def test_block_qp_history_matches_reference(ref_qp):
    prob, ref = ref_qp["qp"]
    out = solve_block(prob, config=SolverConfig(collect_history=True),
                      device="cpu")
    assert out[4] == ref[4] == Status.OPTIMAL
    assert out[5] == ref[5] and out[7].shape == ref[7].shape == (ref[5], 6)
    hist, rhist = out[7][:, :3], ref[7][:, :3]      # pcost, dcost, gap
    rel = np.abs(hist - rhist) / np.abs(rhist)
    assert rel.max() <= 1e-7, rel
    assert _rel(out[6][0], ref[6][0]) <= 1e-9


def test_primal_infeasible_block_matches_reference(ref_qp):
    prob, ref = ref_qp["infeasible"]
    out = solve_block(prob, config=SolverConfig(collect_history=True),
                      device="cpu")
    assert ref[4] == Status.PRIMAL_INFEASIBLE
    assert out[4] == ref[4] and out[5] == ref[5]


def test_gondzio_corrector_matches_reference(ref_gondzio):
    prob, ref = ref_gondzio
    out = solve_block(prob, config=SolverConfig(gondzio_correctors=1),
                      device="cpu")
    assert out[4] == ref[4] == Status.OPTIMAL
    assert out[5] == ref[5]
    assert _rel(out[6][0], ref[6][0]) <= 1e-9
    np.testing.assert_allclose(out[0], ref[0], rtol=0, atol=1e-6)


@pytest.mark.parametrize("field,value", [("factor_dtype", "dd32"),
                                         ("factor_dtype", "float32"),
                                         ("native_dd", True),
                                         ("ring_schur", True)])
def test_ignored_fields_give_the_default_bits(field, value):
    """The reference's block path factors in f64 off its dd32 branch,
    never reads native_dd, and on one device ring_schur is the identity."""
    prob, _ = _c4(1, 16)
    base = solve_block(prob, device="cpu")
    out = solve_block(prob, config=SolverConfig(**{field: value}),
                      device="cpu")
    for u, v in zip(out, base):
        np.testing.assert_array_equal(u, v)


def test_float32_carry_raises():
    """f32 carries run (the reference's f32-carries mode, held to the
    reference by tests/test_torch_f32carry.py); a carry below f32 raises."""
    prob, _ = _c4(1, 4)
    for dtype in (np.float16, "bfloat16"):
        with pytest.raises(ValueError, match="float64 or float32"):
            solve_block(prob, dtype=dtype, device="cpu")
    out = solve_block(prob, dtype=np.float32, device="cpu")
    assert out[4] == Status.OPTIMAL
    assert np.array_equal(out[0], out[0].astype(np.float32))


@pytest.mark.parametrize("gondzio", [0, 1])
def test_factor_and_solves_reach_the_routers(monkeypatch, gondzio):
    """Every factor: one chol.cholesky of (K, nb, nb), one of (1, p, p),
    one tri_pair_solve with k = p; every unrefined solve two block solves
    (k = 1) and one Schur solve.  The init and each body: 1 + 8 block
    solves and 4 Schur solves; a corrector adds 2 + 1."""
    K, nb, p = 16, 10, 8
    prob, _ = _c4(1, K)
    chols, pairs = [], []

    def cholesky(H, f=chol.cholesky):
        chols.append(tuple(H.shape))
        return f(H)

    def tri_pair_solve(L, rhs, f=chol.tri_pair_solve):
        pairs.append((tuple(L.shape), tuple(rhs.shape)))
        return f(L, rhs)

    monkeypatch.setattr(chol, "cholesky", cholesky)
    monkeypatch.setattr(chol, "tri_pair_solve", tri_pair_solve)
    out = solve_block(prob, config=SolverConfig(gondzio_correctors=gondzio),
                      device="cpu")
    assert out[4] == Status.OPTIMAL
    factors = out[5] + 2                 # the init, then k + 1 loop bodies
    bodies = factors - 1                 # the correctors run in the bodies
    assert chols == [(K, nb, nb), (1, p, p)] * factors
    blocks = (K, nb, nb)
    assert pairs.count((blocks, (K, nb, p))) == factors
    assert pairs.count((blocks, (K, nb, 1))) == 8 * factors + 2 * gondzio * bodies
    assert pairs.count(((1, p, p), (1, p, 1))) == 4 * factors + gondzio * bodies
    assert len(pairs) == 13 * factors + 3 * gondzio * bodies


def test_history_off_returns_seven_fields():
    prob, _ = _c4(2, 8)
    out = solve_block(prob, device="cpu")
    assert len(out) == 7
    x, y, s, z, status, k, stats = out
    assert x.shape == (8, 10) and y.shape == (8,)
    assert s.shape == z.shape == (8, 10)
    assert stats.shape == (7,) and isinstance(status, Status)
    hist = solve_block(prob, config=SolverConfig(collect_history=True),
                       device="cpu")[7]
    assert hist.shape == (k, 6) and hist[-1, 2] < hist[0, 2]
