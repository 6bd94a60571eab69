"""The port's sharded paths (socp_tpu_torch/parallel/batch.py, schur.py,
admm.py, hugecone.py and dryrun.py with `mesh=`) on gloo ranks on the CPU,
against the reference's sharded functions on its faked mesh at the same
device count (tests/conftest.py fakes 8 XLA devices; a mesh here takes the
first 2 or 4) and at the shapes of the reference's own tests.

Each run spawns its ranks through tests/_dist_ranks.py (a timeout on
every collective, a deadline on the run, every rank killed at the first
failure).  In every run each rank's outputs are held bit for bit to rank
0's: a sharded solve replicates every scalar it branches on.

Tolerances: the reference's (tests/test_sharding.py:15, pcost 1e-7;
tests/test_schur.py:72 and :99, pcost 1e-7 and y 1e-5, ring against psum
x 1e-8; tests/test_admm.py:33, :48 and :125, w_bar 1e-6 and 1e-8), where
the port against the reference runs tighter (both in f64, in another
order; CHANGES.md has the gaps measured): pcost 1e-9 relative, x, y and
w_bar 1e-9 absolute, except the block problems' x (1e-7), whose optimal
face is ill-conditioned (x moves 1.6e-8 between one and two ranks of the
port itself).  The huge cone is held to the port's one-rank solve (the
same status and iterations, pcost 1e-9 relative, x 1e-9) and to the
numpy oracle (pcost 1e-7 relative, x 1e-6, as tests/test_torch_hugecone.py
holds the one-rank solve; x 1e-5 with a Gondzio corrector, whose one-rank
solve ends 7.7e-6 from the oracle's x at the same pcost to 3.5e-11), not
to the reference's sharded run, which fails on the CPU (CHANGES.md).

Run lengths: the ADMM comparisons run 12 and 10 rounds where the
reference's tests run 40 and 30 to tol 1e-5 (each of the reference's
rounds and the port's costs about as much as its compile here); the
problems are the reference's.
"""

import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import jax
from socp_tpu.models.robust_ls import robust_ls_batch as ref_robust_ls_batch
from socp_tpu.models.stochastic import scenario_portfolio as ref_scenario_portfolio
from socp_tpu.parallel.admm import admm_consensus as ref_admm
from socp_tpu.parallel.batch import solve_batch_sharded as ref_solve_batch_sharded
from socp_tpu.parallel.schur import random_block_problem as ref_random_block_problem
from socp_tpu.parallel.schur import solve_block as ref_solve_block
from socp_tpu.problem import ConeDims as RConeDims
from socp_tpu.utils import oracle
from socp_tpu.utils.checkpoint import SolverCheckpoint as RefCheckpoint
from socp_tpu_torch import SolverConfig, Status, solve_batch_raw
from socp_tpu_torch.models.robust_ls import robust_ls_batch
from socp_tpu_torch.models.stochastic import scenario_portfolio
from socp_tpu_torch.parallel import hugecone as hc
from socp_tpu_torch.parallel.admm import admm_consensus
from socp_tpu_torch.parallel.schur import random_block_problem
from tests import _dist_ranks
from tests._host_memory import release_host_memory  # noqa: F401
from tests.test_torch_hugecone import _huge_soc_problem, _multi_soc_problem

TOL = 1e-9


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The parent's one-rank runs are eager-op overhead on these shapes."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _ref_mesh(shape, names):
    n = int(np.prod(shape))
    return Mesh(np.asarray(jax.devices()[:n]).reshape(shape), names)


def _replicated(ranks, get):
    """Every rank's outputs (a tuple of arrays and scalars) equal rank 0's,
    bit for bit."""
    first = get(ranks[0])
    for other in ranks[1:]:
        for a, b in zip(first, get(other)):
            assert np.array_equal(a, b) if isinstance(a, np.ndarray) else a == b
    return first


def _rel(a, b):
    return abs(a - b) / max(1.0, abs(b))


# ---- the sharded batch (tests/test_sharding.py:15) ----------------------

def test_batch_sharded_matches_reference():
    c, G, h, dims = robust_ls_batch(0, batch=8, n=12, k=16)
    configs = [{}, {"factor_dtype": "float32"}]
    ranks = _dist_ranks.run(2, "batch", c=c, G=G, h=h, dims=dims,
                            configs=configs, B_bad=7)
    rc, rG, rh, rdims = ref_robust_ls_batch(0, batch=8, n=12, k=16)
    ref = ref_solve_batch_sharded(rc, rG, rh, rdims,
                                  mesh=_ref_mesh((2,), ("batch",)))
    for i, cfg in enumerate(configs):
        out = _replicated(ranks, lambda r: r["outs"][i])
        x, y, s, z, status, k, stats, hist = out
        # per-instance independent: the same bits as one rank's batch
        one = solve_batch_raw(c, G, h, dims, config=SolverConfig(**cfg),
                              device="cpu")
        for a, b in zip(out, one):
            assert np.array_equal(a, b)
        # the loop condition: one reduction a check, bodies + 1 checks
        counts = ranks[0]["counts"][i]
        assert counts["pany"] == int(k.max()) + 2
        assert counts["all_gather"] == 8 and counts["psum"] == 0
        if not cfg:
            assert np.all(status == 0) and np.array_equal(status, ref[4])
            assert np.array_equal(k, ref[5])
            assert np.all(np.abs(stats[:, 0] - ref[6][:, 0])
                          <= TOL * np.maximum(1.0, np.abs(ref[6][:, 0])))
            np.testing.assert_allclose(x, ref[0], rtol=0, atol=TOL)
        else:                        # the f32 factor: optimal, inaccurate
            assert np.all(status == 0) and np.all(stats[:, 6] == 1.0)
            assert np.all(np.abs(stats[:, 0] - ref[6][:, 0])
                          <= 5e-5 * np.maximum(1.0, np.abs(ref[6][:, 0])))
    assert "not divisible" in ranks[0]["indivisible"]


# ---- block-Schur (tests/test_schur.py:72, :99, :113) ---------------------

SCHUR = (  # (seed, K, p, ring_schur)
    (1, 16, 4, False),
    (5, 16, 4, True),
    (6, 8, 6, True),        # p = 6 in 4 chunks: 2, 2, 1, 1
)


def test_block_schur_sharded_matches_reference():
    probs = [random_block_problem(seed, K=K, nb=6, p=p)[0]
             for seed, K, p, _ in SCHUR]
    configs = [{"ring_schur": ring} for *_, ring in SCHUR]
    ranks = _dist_ranks.run(2, "schur", problems=probs, configs=configs,
                            K_bad=7)
    mesh = _ref_mesh((2,), ("blocks",))
    for i, (seed, K, p, ring) in enumerate(SCHUR):
        out = _replicated(ranks, lambda r: r["outs"][i])
        x, y, s, z, status, k, stats = out
        rprob, pstar = ref_random_block_problem(seed, K=K, nb=6, p=p)
        ref = ref_solve_block(rprob, mesh=mesh,
                              config=SolverConfig(ring_schur=ring))
        assert status == Status.OPTIMAL and ref[4].name == "OPTIMAL"
        assert k == ref[5]
        assert _rel(stats[0], ref[6][0]) <= TOL
        assert _rel(stats[0], pstar) <= 1e-6
        np.testing.assert_allclose(y, ref[1], rtol=0, atol=TOL)
        np.testing.assert_allclose(x, ref[0], rtol=0, atol=1e-7)
        counts = ranks[0]["counts"][i]
        assert (counts["ring_allreduce"] > 0) == ring
        assert counts["psum"] > 0 and counts["pmin"] > 0
    assert "not divisible" in ranks[0]["indivisible"]


# ---- consensus ADMM (tests/test_admm.py:33, :48, :125) -------------------

ADMM = {  # name: (seed, S, world, pod, extra keywords)
    "sharded": (1, 8, 2, False, dict(outer_iters=12, tol=1e-5)),
    "pod_mesh_2d": (2, 16, 4, True, dict(outer_iters=10, tol=1e-5)),
    "chunked_sharded": (7, 16, 2, False,
                        dict(outer_iters=5, tol=0.0, scenario_chunk=8)),
}


@pytest.mark.parametrize("name", sorted(ADMM))
def test_admm_sharded_matches_reference(name):
    seed, S, world, pod, extra = ADMM[name]
    c, G, h, dims, A, b, info = scenario_portfolio(seed, n=10, k=3,
                                                   n_scenarios=S)
    kw = dict(n_consensus=info["n"], A=A, b=b, rho=1.0, **extra)
    ranks = _dist_ranks.run(world, "admm", data=(c, G, h, dims), kw=kw,
                            pod=pod)
    res = _replicated(ranks, lambda r: (
        r["res"].w_bar, r["res"].x, r["res"].objective, r["res"].primal_res,
        r["res"].dual_res, r["res"].outer_iterations, r["res"].rho,
        r["res"].inner_status_ok))
    w_bar, x, objective, pres, dres, rounds, rho, ok = res
    rdata = ref_scenario_portfolio(seed, n=10, k=3, n_scenarios=S)
    mesh = (_ref_mesh((2, 2), ("scenario", "blocks")) if pod
            else _ref_mesh((world,), ("batch",)))
    ref = ref_admm(*rdata[:4], n_consensus=rdata[6]["n"], A=rdata[4],
                   b=rdata[5], rho=1.0, mesh=mesh, **extra)
    assert ok and ref.inner_status_ok
    assert (rounds, rho) == (ref.outer_iterations, ref.rho)
    np.testing.assert_allclose(w_bar, ref.w_bar, rtol=0, atol=TOL)
    np.testing.assert_allclose(x, ref.x, rtol=0, atol=TOL)
    assert abs(objective - ref.objective) <= TOL
    # one device read a round, after the round's two all-reduces (the
    # consensus mean; the residual with the all-OPTIMAL flag)
    assert ranks[0]["reads"] == rounds
    assert ranks[0]["counts"]["psum"] == 2 * rounds
    assert ranks[0]["counts"]["all_gather"] == 1          # the final x


def test_admm_checkpoint_on_two_ranks_resumes_on_one(tmp_path):
    """tests/test_admm.py:109's chunked checkpoint: written by rank 0 of
    two from the gathered state at round 3, read by the reference's loader
    and resumed on one rank, it lands where one rank's uninterrupted run
    does."""
    c, G, h, dims, A, b, info = scenario_portfolio(6, n=10, k=3,
                                                   n_scenarios=8)
    kw = dict(n_consensus=info["n"], A=A, b=b, rho=1.0, tol=0.0,
              scenario_chunk=4)
    path = str(tmp_path / "admm_ck.npz")
    _dist_ranks.run(2, "admm", data=(c, G, h, dims),
                    kw=dict(kw, outer_iters=3, checkpoint_every=3,
                            checkpoint_path=path))
    ck = RefCheckpoint.load(path)
    assert ck.iteration == 3 and ck.y.shape == (8, info["n"])
    assert ck.meta["warm_x"].shape[0] == 8
    full = admm_consensus(c, G, h, dims, outer_iters=6, device="cpu", **kw)
    resumed = admm_consensus(c, G, h, dims, outer_iters=6, resume_from=path,
                             device="cpu", **kw)
    assert resumed.outer_iterations == 3
    np.testing.assert_allclose(resumed.w_bar, full.w_bar, rtol=0, atol=TOL)
    np.testing.assert_allclose(resumed.x, full.x, rtol=0, atol=TOL)


# ---- the huge cone (tests/test_hugecone.py:64, :142; a Gondzio case) -----

HUGE = {  # name: (problem, gondzio correctors)
    "huge_soc_1": (lambda: _huge_soc_problem(1, n=10, l=8, q=57), 0),
    "multi_soc_4": (lambda: _multi_soc_problem(4, n=10, l=8, qs=(25, 17),
                                               p=3), 0),
    "multi_soc_4_gondzio": (lambda: _multi_soc_problem(4, n=10, l=8,
                                                       qs=(25, 17), p=3), 1),
}


def test_hugecone_sharded_matches_one_rank_and_oracle():
    names = sorted(HUGE)
    probs = [HUGE[name][0]() for name in names]
    cases = [((p.c, p.G, p.h, p.dims.l, p.dims.qs),
              dict(A=p.A, b=p.b, config={"gondzio_correctors": HUGE[name][1]}))
             for name, p in zip(names, probs)]
    ranks = _dist_ranks.run(2, "hugecone", problems=cases)
    for i, (name, prob) in enumerate(zip(names, probs)):
        x, y, s, z, status, k, stats = _replicated(ranks,
                                                   lambda r: r["outs"][i])
        one = hc.solve_huge(*cases[i][0], A=prob.A, b=prob.b, device="cpu",
                            config=SolverConfig(
                                gondzio_correctors=HUGE[name][1]))
        assert (status, k) == (one[4], one[5]) and status == Status.OPTIMAL
        assert _rel(stats[0], one[6][0]) <= TOL, name
        np.testing.assert_allclose(x, one[0], rtol=0, atol=TOL)
        np.testing.assert_allclose(s, one[2], rtol=0, atol=TOL)
        assert s.shape == z.shape == prob.h.shape
        ref = oracle.solve(prob.c, prob.G, prob.h,
                           RConeDims(prob.dims.l, tuple(prob.dims.qs)),
                           A=prob.A, b=prob.b)
        assert ref["status_name"] == "optimal"
        assert _rel(stats[0], ref["pcost"]) <= 1e-7
        np.testing.assert_allclose(x, ref["x"], rtol=0,
                                   atol=1e-5 if HUGE[name][1] else 1e-6)
        assert ranks[0]["reads"][i] == k + 1            # one read a body


# ---- __graft_entry__.dryrun_multichip (:52-110) --------------------------

@pytest.mark.parametrize("world", [2, 4])
def test_dryrun_multichip(world):
    counts = _dist_ranks.run(world, "dryrun")
    assert counts[0] == counts[-1]
    # every kind of reduction the sharded paths make was made
    for kind in ("psum", "pmin", "pany", "all_gather", "allsum"):
        assert counts[0][kind] > 0, kind
