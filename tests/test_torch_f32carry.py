"""The reference's f32-carries mode (`dtype=float32`, with and without
`SolverConfig(refine_in_f64=True)`) in the port against the reference on
the CPU (the kernels' plain versions), one case per entry point:

  solve            tests/test_dense_solver.py:118-128's instance, the
                   default config and the refine_in_f64 config there
  prepare_batch,   robust_ls_batch at B = 4, and a warm restart from the
  solve_batch(_raw) f32 outputs
  native_dd        f32 inputs rounded, then solved in f64
  solve_block      random_block_problem at K = 16
  admm_consensus   the reference run with JAX's x64 off
  the huge cone    one SOC of q = 2^12 + 1 rows, f32 inputs rounded, then
                   solved in f64 (as the reference's dd carries; held to
                   the f64 solve of the rounded inputs)

Held: equal status; pcost within 5e-5 relative (`reltol_inacc`); the
inaccurate flag equal, except where rounding near the f32 floor decides
between the strict exit and the relaxed one, as in
test_torch_f32factor.py::test_flag_is_decided_by_rounding: there the side
whose flag is 0 must have met the strict tolerances.  Iteration counts are
printed with their instance, not held.  The carries are held to f32 (the
state's dtype at exit, before the numpy cast): a tensor of f64 meeting
one of f32 in torch promotes the result to f64.

Cost: five reference compiles (the two solves, the batch, the block solve
and the ADMM round), about 31 s of test calls on one process.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import socp_tpu
import socp_tpu_torch
from socp_tpu import SolverConfig as RConfig
from socp_tpu.models.random_socp import random_socp
from socp_tpu.models.robust_ls import robust_ls_batch
from socp_tpu.models.stochastic import scenario_portfolio
from socp_tpu.parallel import admm as radmm
from socp_tpu.parallel.mesh import block_mesh
from socp_tpu.parallel.schur import random_block_problem
from socp_tpu.parallel.schur import solve_block as ref_solve_block
from socp_tpu_torch import SolverConfig, api
from socp_tpu_torch.carry import problem_from_reference
from socp_tpu_torch.ipm import driver
from socp_tpu_torch.kkt import dense
from socp_tpu_torch.parallel import admm, hugecone, schur
from socp_tpu_torch.problem import SocpProblem
from tests._host_memory import release_host_memory  # noqa: F401

PCOST_REL = 5e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """These shapes are eager-op overhead on the CPU; torch's intra-op
    threads only contend with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

# tests/test_dense_solver.py:118-128: f32 carries, refinement in f64
REFINE = dict(refine_steps=2, refine_in_f64=True, delta_reg=1e-6,
              abstol=1e-6, reltol=1e-6, feastol=1e-6)
CONFIGS = {"default": {}, "refine_in_f64": REFINE}


@pytest.fixture
def carries(monkeypatch):
    """The dtypes of the state the port's loops hand back (x, y, s, z,
    stats), by loop, and the dtypes the refinement residual's operands
    took."""
    seen = {"driver": [], "block": [], "residual": []}

    def spy(name, module, attr):
        inner = getattr(module, attr)

        def wrapped(*args, **kw):
            out = inner(*args, **kw)
            if name == "residual":
                seen[name].append(out[2].dtype)
            else:
                seen[name].append({t.dtype for t in (*out[:4], out[6])})
            return out
        monkeypatch.setattr(module, attr, wrapped)

    spy("driver", driver, "solve_core")
    spy("block", schur, "_core")
    spy("residual", dense, "residual_operands")
    return seen


def _rel(a, b):
    return abs(a - b) / max(1.0, abs(b))


def _hold(label, ref, port, strict, iters):
    """ref, port: (status, inaccurate, pcost, gap, relgap, pres, dres)."""
    msg = f"{label}: iterations {iters}; ref {ref}; port {port}"
    print(msg)
    assert int(port[0]) == int(ref[0]), msg
    assert _rel(port[2], ref[2]) <= PCOST_REL, msg
    if bool(port[1]) != bool(ref[1]):      # decided by rounding (module doc)
        gap, relgap, pres, dres = (port if not port[1] else ref)[3:]
        assert pres <= strict and dres <= strict, msg
        assert gap <= strict or relgap <= strict, msg


def _sol(s):
    return (int(s.status), s.inaccurate, s.pcost, s.gap, s.relgap, s.pres,
            s.dres)


def _rounded(prob):
    """The problem's data rounded to f32, held as f64."""
    def r(a):
        return None if a is None else np.asarray(a, np.float32).astype(np.float64)
    return SocpProblem(c=r(prob.c), G=r(prob.G), h=r(prob.h), dims=prob.dims,
                       A=r(prob.A), b=r(prob.b), P=r(prob.P))


@pytest.fixture(scope="module")
def instance():
    prob, _ = random_socp(2, n=30, l=8, qs=(4, 6, 10), p=5)
    return prob


_REFERENCE = {}


def _reference_solve(instance, config):
    """The reference's f32 solve of `instance`, once a config and process
    (each is a compile; the tests that use one may run in other workers)."""
    if config not in _REFERENCE:
        _REFERENCE[config] = socp_tpu.solve(
            instance, config=RConfig(**CONFIGS[config]), dtype=np.float32)
    return _REFERENCE[config]


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_solve_matches_reference(config, instance, carries):
    ref = _reference_solve(instance, config)
    cfg = SolverConfig(**CONFIGS[config])
    out = socp_tpu_torch.solve(problem_from_reference(instance), config=cfg,
                               dtype=np.float32, device="cpu")
    assert carries["driver"] == [{torch.float32}]
    # the residual's operands: f64 under refine_in_f64, the carry dtype else
    assert carries["residual"] == [torch.float64 if cfg.refine_in_f64
                                   else torch.float32]
    assert out.x.dtype == np.float64
    assert np.array_equal(out.x, out.x.astype(np.float32))   # f32 values
    _hold(f"random_socp(2) {config}", _sol(ref), _sol(out),
          cfg.feastol, f"ref {ref.iterations} port {out.iterations}")


def test_solve_batch_matches_reference_and_warm_starts(carries):
    """solve_batch (through solve_batch_raw and prepare_batch) at B = 4,
    then prepare_batch's function warm-started from its own f32 outputs."""
    c, G, h, dims = robust_ls_batch(3, 4, n=12, k=16)
    ref = socp_tpu.solve_batch(c, G, h, dims, dtype=np.float32)
    out = socp_tpu_torch.solve_batch(c, G, h, dims, dtype=np.float32,
                                     device="cpu")
    assert carries["driver"] == [{torch.float32}]
    for i, (r, p) in enumerate(zip(ref, out)):
        _hold(f"robust_ls_batch(3, 4)[{i}]", _sol(r), _sol(p), 1e-8,
              f"ref {r.iterations} port {p.iterations}")
    fn, args, _ = socp_tpu_torch.prepare_batch(
        c, G, h, dims, dtype="float32", has_warm=True, device="cpu")
    assert {a.dtype for a in args} == {torch.float32}
    first = socp_tpu_torch.prepare_batch(c, G, h, dims, dtype=torch.float32,
                                         device="cpu")
    first = first[0](*first[1])
    assert [p.iterations for p in out] == first[5].tolist()
    warm = fn(*args, first[:4])
    assert all(t.dtype == torch.float32 for t in (*warm[:4], warm[6]))
    assert bool((warm[4] == 0).all())
    print(f"warm restart: iterations {warm[5].tolist()}, cold "
          f"{first[5].tolist()}")


def test_native_dd_rounds_f32_inputs_then_runs_f64(instance, carries):
    prob = problem_from_reference(instance)
    cfg = SolverConfig(native_dd=True)
    out = socp_tpu_torch.solve(prob, config=cfg, dtype=np.float32, device="cpu")
    again = socp_tpu_torch.solve(_rounded(prob), config=cfg, device="cpu")
    assert carries["driver"] == [{torch.float64}] * 2
    assert np.array_equal(out.x, again.x) and out.pcost == again.pcost
    ref = _reference_solve(instance, "default")
    _hold("random_socp(2) native_dd", _sol(ref), _sol(out), 1e-8,
          f"ref {ref.iterations} port {out.iterations}")


def test_solve_block_matches_reference(carries):
    prob, _ = random_block_problem(0, K=16, nb=8, p=4)
    ref = ref_solve_block(prob, mesh=block_mesh(1), dtype=np.float32)
    out = schur.solve_block(prob, dtype=np.float32, device="cpu")
    assert carries["block"] == [{torch.float32}]

    def t(o):
        return (int(o[4]), o[6][6] > 0.5, *(o[6][i] for i in (0, 2, 3, 4, 5)))
    _hold("random_block_problem(0, K=16)", t(ref), t(out), 1e-8,
          f"ref {ref[5]} port {out[5]}")


def test_admm_matches_reference_with_x64_off(carries):
    """The reference's ADMM takes f32 carries where JAX's x64 is off
    (socp_tpu/parallel/admm.py:228).  Its round function is lru-cached by
    the dtype's name, so the run under the context traces anew: one more
    miss, and w_bar's values are f32 numbers.  One round (a second is a
    second compile, the warm-started round; the port's f32 warm starts
    are held in the batch test above)."""
    c, G, h, dims, A, b, info = scenario_portfolio(0, n=12, k=3,
                                                   n_scenarios=6)
    kw = dict(A=A, b=b, outer_iters=1)
    misses = radmm._round_fn.cache_info().misses
    with jax.enable_x64(False):
        ref = radmm.admm_consensus(c, G, h, dims, info["n"], **kw)
    assert radmm._round_fn.cache_info().misses == misses + 1
    assert np.array_equal(ref.w_bar, ref.w_bar.astype(np.float32))
    out = admm.admm_consensus(c, G, h, dims, info["n"], dtype=jnp.float32,
                              device="cpu", **kw)
    assert carries["driver"] == [{torch.float32}] * out.outer_iterations
    assert out.w_bar.dtype == np.float64
    assert np.array_equal(out.w_bar, out.w_bar.astype(np.float32))
    print(f"admm: ref {ref.outer_iterations} rounds, objective "
          f"{ref.objective}; port {out.outer_iterations}, {out.objective}")
    assert out.inner_status_ok == ref.inner_status_ok
    assert (out.outer_iterations, out.rho) == (ref.outer_iterations, ref.rho)
    assert _rel(out.objective, ref.objective) <= PCOST_REL
    np.testing.assert_allclose(out.w_bar, ref.w_bar, rtol=0, atol=1e-4)


def test_hugecone_rounds_f32_inputs_then_runs_f64():
    """One SOC of q = 2^12 + 1 rows with coupling equalities
    (tests/test_hugecone.py:103-123's generator).  The reference's f32
    huge cone is its dd32 graph built from the rounded inputs, whose
    compile takes about 76 s on the CPU (tests/test_torch_hugecone.py), so
    the port is held to what that graph computes, the f64 solve of the
    rounded inputs: bit for bit to the port's f64 huge cone on them (which
    tests/test_torch_hugecone.py holds to the reference), and to the
    port's dense `solve` of them in status, iterations and pcost (1e-9)."""
    from test_torch_hugecone import _multi_soc_problem

    prob = _multi_soc_problem(3, qs=((1 << 12) + 1,))
    rp = _rounded(prob)

    def huge(p, **kw):
        return hugecone.solve_huge(p.c, p.G, p.h, p.dims.l, p.dims.qs,
                                   A=p.A, b=p.b, device="cpu", **kw)
    out = huge(prob, dtype=np.float32)
    again = huge(rp)
    assert np.array_equal(out[0], again[0]) and np.array_equal(out[6], again[6])
    dense_sol = socp_tpu_torch.solve(rp, device="cpu")
    print(f"huge cone q = 4097: {out[4].name} in {out[5]}, dense "
          f"{dense_sol.iterations}")
    assert (out[4], out[5]) == (dense_sol.status, dense_sol.iterations)
    assert _rel(out[6][0], dense_sol.pcost) <= 1e-9


# Config 4 at full size (K = 10,240, scripts/bench_all.py:144-170) in f32
# carries: the reference's block path (socp_tpu.parallel.schur.solve_block
# on one device, default config) stalls and exits NUMERICAL_ERROR after 8
# iterations with relgap 3.7e-4, above the relaxed 5e-5; at K = 1024 it
# ends OPTIMAL.  chip_smoke.py's f32carry phase expects these.
REF4_F32 = {"K": 10240, "status": "NUMERICAL_ERROR", "iterations": 8,
            "pcost": 264.932129, "K_optimal": 1024}


@pytest.mark.slow
def test_config4_f32_ends_as_the_reference():
    """REF4_F32 recomputed: the reference's f32 block solve at K = 10,240
    and at 1024, and the port's beside it (status equal, pcost within
    5e-5).  Slow: config 4's reference graph at K = 10,240 runs about 7 s
    on the CPU."""
    from socp_tpu.problem import ConeDims as RConeDims

    for K in (REF4_F32["K"], REF4_F32["K_optimal"]):
        prob, _ = random_block_problem(0, K=K, nb=10, p=8,
                                       block_dims=RConeDims(l=4, qs=(6,)))
        ref = ref_solve_block(prob, mesh=block_mesh(1), dtype=np.float32)
        out = schur.solve_block(prob, dtype=np.float32, device="cpu")
        print(f"config 4 f32, K = {K}: ref {ref[4].name} in {ref[5]}, pcost "
              f"{ref[6][0]}; port {out[4].name} in {out[5]}, {out[6][0]}")
        assert out[4] == ref[4]
        assert _rel(out[6][0], ref[6][0]) <= PCOST_REL
        if K == REF4_F32["K"]:
            assert (ref[4].name, ref[5]) == (REF4_F32["status"],
                                             REF4_F32["iterations"])
            assert _rel(ref[6][0], REF4_F32["pcost"]) <= 1e-6
        else:
            assert ref[4].name == "OPTIMAL"


F32_SPELLINGS = [torch.float32, np.float32, np.dtype("float32"), "float32",
                 jnp.float32]
F64_SPELLINGS = [None, torch.float64, torch.double, np.float64,
                 np.dtype("float64"), "float64", jnp.float64]
REFUSED = [torch.float16, torch.bfloat16, np.float16, "bfloat16", jnp.bfloat16,
           np.int32, torch.int64, "int8"]


@pytest.mark.parametrize(
    "spelling,want", [(s, torch.float32) for s in F32_SPELLINGS]
    + [(s, torch.float64) for s in F64_SPELLINGS], ids=str)
def test_resolve_dtype_accepts_f32_and_f64(spelling, want):
    assert api.resolve_dtype(spelling) is want


@pytest.mark.parametrize("spelling", REFUSED, ids=str)
def test_resolve_dtype_refuses_other_types(spelling):
    with pytest.raises(ValueError, match="float64 or float32"):
        api.resolve_dtype(spelling)
