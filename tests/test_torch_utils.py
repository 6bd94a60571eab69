"""The port's utilities (socp_tpu_torch/utils/: the NumPy oracle, the
benchmark-record schema, the phase timers and traces) and the
single-device `entry()` (socp_tpu_torch/parallel/dryrun.py), against the
reference's `socp_tpu.utils` and `__graft_entry__.entry()`, on the CPU.

The oracles are held bit for bit (status, iterations, x, y, s, z and the
iteration log) on the fixtures of tests/test_oracle.py: the port's copy
keeps the reference's arithmetic line for line.  The one rule it changes,
a double root of an SOC step whose discriminant rounds below 0, is shown
on its instance (ROADMAP.md, queue 3 item 6) with its exact value.  The
oracle's jprod, jdiv and max_step are held to the port's cone kernels
(socp_tpu_torch/cones/ops.py) at 1e-12 relative.  Records and the
timers' report text must be equal to the reference's.

`entry()`'s lockstep solve is held to the reference's jitted entry: the
same status and iterations, x, s and z within 1e-9 relative (elementwise,
against max(1, |reference|)).  That is tighter than
tests/test_torch_solve.py's hold on the same driver (status, pcost 1e-8
relative), so 1e-9 is the tolerance used; the two differed by about 1e-11
on this instance.  It is the file's one reference compile (about 5 s);
everything else is NumPy.  About 10 s on one process.
"""

import glob
import importlib
import io
import json
import os

import numpy as np
import pytest
import torch

from socp_tpu.models.portfolio import portfolio
from socp_tpu.models.random_socp import (dual_infeasible_lp,
                                         primal_infeasible_lp, random_socp)
from socp_tpu.problem import ConeDims as RConeDims
from socp_tpu.utils import metrics as ref_metrics
from socp_tpu.utils import oracle as ref_oracle
from socp_tpu_torch import Status, solve
from socp_tpu_torch.cones import ops as tops
from socp_tpu_torch.cones.layout import make_layout
from socp_tpu_torch.problem import ConeDims
from socp_tpu_torch.utils import metrics, oracle, profiling
from tests._host_memory import release_host_memory  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's CPU path at these shapes is eager-op overhead; torch's
    intra-op threads only contend with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ---- the oracle ----------------------------------------------------------
def _problem(prob, **kw):
    """(the solve's arguments but dims, (l, qs))."""
    return (dict(c=prob.c, G=prob.G, h=prob.h, A=prob.A, b=prob.b, P=prob.P,
                 **kw), (prob.dims.l, tuple(prob.dims.qs)))


# tests/test_oracle.py's fixtures: an orthant-and-SOC problem with
# equalities, a portfolio, a QP (P != 0), one without equalities, the two
# infeasible LPs and a run cut by max_iter
CASES = {
    "random_socp": lambda: _problem(random_socp(0, n=30, l=8, qs=(4, 6, 10),
                                                p=5)[0]),
    "portfolio": lambda: _problem(portfolio(0, n=40, k=5)[0]),
    "quadratic": lambda: _problem(random_socp(3, n=25, l=5, qs=(5, 8), p=4,
                                              quadratic=True)[0]),
    "no_equalities": lambda: _problem(random_socp(4, n=20, l=10, qs=(8, 6),
                                                  p=0)[0]),
    "primal_infeasible": lambda: _problem(primal_infeasible_lp(0)),
    "dual_infeasible": lambda: _problem(dual_infeasible_lp(0)),
    "max_iter": lambda: _problem(random_socp(0, n=30, l=8, qs=(4, 6, 10),
                                             p=5)[0], max_iter=3),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_oracle_is_the_reference_bit_for_bit(case):
    data, (l, qs) = CASES[case]()
    ref = ref_oracle.solve(dims=RConeDims(l, qs), **data)
    out = oracle.solve(dims=ConeDims(l, qs), **data)
    assert out["status"] == ref["status"]
    assert out["status_name"] == ref["status_name"]
    assert out["status_name"] == Status(out["status"]).name.lower()
    assert out["iterations"] == ref["iterations"]
    for key in ("x", "y", "s", "z"):
        np.testing.assert_array_equal(out[key], ref[key], err_msg=key)
    for key in ("gap", "pcost", "pres", "dres"):
        assert out[key] == ref[key], key
    assert out["log"] == ref["log"]


def _interior(rng, l, qs):
    parts = [rng.uniform(0.5, 2.0, size=l)]
    for q in qs:
        u1 = rng.normal(size=q - 1)
        parts.append(np.concatenate(
            [[np.linalg.norm(u1) + rng.uniform(0.5, 2.0)], u1]))
    return np.concatenate(parts)


def test_oracle_takes_the_double_root_the_reference_drops():
    """A dim-1 SOC moving toward its boundary, the other blocks moving
    into the cone (tests/test_torch_hugecone.py's instance, ROADMAP.md
    queue 3 item 6): the exact step is -u0/du0, a double root of det(u +
    a du) = 0 whose rounded discriminant lands below 0.  The reference's
    oracle returns inf, the port's the root."""
    l, qs = 3, (1, 2, 6)
    rng = np.random.default_rng(1)
    u = _interior(rng, l, qs)
    du = _interior(rng, l, qs)
    du[l] = -du[l]
    assert ref_oracle.max_step(RConeDims(l, qs), u, du) == np.inf
    alpha = oracle.max_step(ConeDims(l, qs), u, du)
    assert abs(alpha - 1.6292983085823112) <= 1e-12 * 1.6292983085823112
    assert abs(alpha - (-u[l] / du[l])) <= 1e-12 * alpha


@pytest.mark.parametrize("seed", [0, 1])
def test_oracle_cone_ops_match_the_ports_kernels(seed):
    """jprod, jdiv and max_step of the oracle against cones/ops on the
    padded layout, 1e-12 relative; the step both ways (a bounded one, and
    an unbounded one along a cone member)."""
    l, qs = 5, (9, 7, 1)
    dims = ConeDims(l, qs)
    layout = make_layout(dims)
    rng = np.random.default_rng(seed)
    u, v = _interior(rng, l, qs), _interior(rng, l, qs)
    d = rng.normal(size=dims.dim)

    def port(f, *vecs):
        t = [torch.as_tensor(layout.pad_vec(a))[None] for a in vecs]
        out = f(layout, *t)[0].numpy()
        return layout.unpad_vec(out) if out.ndim else float(out)

    def close(a, b):
        np.testing.assert_allclose(a, b, rtol=1e-12,
                                   atol=1e-12 * np.abs(b).max())

    close(port(tops.jprod, u, d), oracle.jprod(dims, u, d))
    close(port(tops.jdiv, u, d), oracle.jdiv(dims, u, d))
    close(port(tops.max_step, u, d), oracle.max_step(dims, u, d))
    assert port(tops.max_step, u, v) == oracle.max_step(dims, u, v) == np.inf


# ---- metrics -------------------------------------------------------------
RECORDS = [
    (("config3", "solves_per_s", 24758.123456789, "solves/s"),
     dict(vs_baseline=1.23456, iters_per_s=12345.678912, mesh_devices=4.0,
          batch=4096, status="optimal")),
    (("config4", "block_solve_s", 0.1470000001, "s"),
     dict(kkt_factor_ms=0.25351, kkt_solve_ms=None, lockstep_iter_ms=18.44444,
          achieved_vs_attainable_pct=12.34567)),
    (("config2", "solve_ms", 1, "ms"), {}),
]


def test_records_equal_the_references():
    for args, kw in RECORDS:
        ours = metrics.metric_record(*args, **dict(kw))
        ref = ref_metrics.metric_record(*args, **dict(kw))
        assert json.dumps(ours) == json.dumps(ref)
        assert list(ours) == list(ref)
        a, b = io.StringIO(), io.StringIO()
        metrics.emit(ours, a)
        ref_metrics.emit(ref, b)
        assert a.getvalue() == b.getvalue()
    assert metrics.SCHEMA == ref_metrics.SCHEMA
    assert metrics._KEYS == ref_metrics._KEYS
    rec = metrics.metric_record(*RECORDS[0][0], **RECORDS[0][1])
    assert rec["mesh_devices"] == 4 and rec["mfu_bf16_pct"] is None
    assert rec["iters_per_s"] == 12345.6789 and rec["vs_baseline"] == 1.23


# ---- profiling -----------------------------------------------------------
def test_phase_timers_report_equals_the_references():
    """The report text for the same totals; the reference's module
    imports jax, which conftest has loaded already."""
    ref_profiling = importlib.import_module("socp_tpu.utils.profiling")
    ours, ref = profiling.PhaseTimers(), ref_profiling.PhaseTimers()
    for t in (ours, ref):
        t.totals.update({"solve": 1.25, "factor": 0.0123456, "x" * 40: 3.5})
        t.counts.update({"solve": 2, "factor": 17, "x" * 40: 1})
    assert ours.report() == ref.report()
    timers = profiling.PhaseTimers()
    for _ in range(3):
        with timers.phase("a"):
            pass
    assert timers.counts["a"] == 3 and timers.totals["a"] >= 0.0


def test_trace_writes_the_ops_of_a_solve(tmp_path):
    from socp_tpu_torch.models.portfolio import portfolio as port_portfolio

    log_dir = str(tmp_path / "trace")
    with profiling.trace(log_dir) as where:
        sol = solve(port_portfolio(0, n=6, k=2)[0], device="cpu")
    assert where == log_dir and sol.status == Status.OPTIMAL
    files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    # the IPM's products, the plain Cholesky's sqrt and the loop's host read
    assert {"aten::bmm", "aten::sqrt", "aten::item"} <= names, sorted(names)


# ---- entry() -------------------------------------------------------------
def test_entry_matches_the_references():
    import jax

    import __graft_entry__
    from socp_tpu_torch.parallel.dryrun import entry

    fn, args = __graft_entry__.entry()
    ref = [np.asarray(a) for a in jax.jit(fn)(*args)]
    pfn, pargs = entry(device="cpu")
    assert all(a.device.type == "cpu" for a in pargs)
    out = [t.numpy() for t in pfn(*pargs)]
    np.testing.assert_array_equal(out[4], ref[4])
    np.testing.assert_array_equal(out[5], ref[5])
    for i, key in ((0, "x"), (2, "s"), (3, "z")):
        assert out[i].shape == ref[i].shape, key
        rel = np.abs(out[i] - ref[i]) / np.maximum(1.0, np.abs(ref[i]))
        assert rel.max() <= 1e-9, (key, rel.max())
