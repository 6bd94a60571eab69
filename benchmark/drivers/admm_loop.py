"""Closed loop, one client, over `socp_tpu_torch.parallel.admm.admm_consensus`.

Set-up makes the problem from the seed (the configuration's `problem`)
and makes the mix's warm-up call of `warmup_rounds` rounds.  The window
calls `admm_consensus` back to back, each call `rounds` rounds from a fresh
start with the mix's `scenario_chunk`, placing the scenario data on the
device itself, until `seconds` have passed; the last call started
finishes.  Every call's result is judged after the window has closed.
"""

from __future__ import annotations

import time

from benchmark.harness.runner import Call, counters, delta


class State:
    def __init__(self, config, traffic, pb, solver, device, dtype):
        self.config, self.traffic, self.problem = config, traffic, pb
        self.solver, self.device, self.dtype = solver, device, dtype


def _call(state, rounds):
    from socp_tpu_torch import ConeDims
    from socp_tpu_torch.parallel.admm import admm_consensus

    pb, cfg = state.problem, state.config
    return admm_consensus(
        pb["c"], pb["G"], pb["h"], ConeDims(l=pb["l"], qs=pb["qs"]),
        pb["n_consensus"], A=pb["A"], b=pb["b"], rho=cfg.ADMM["rho"],
        outer_iters=rounds, tol=cfg.ADMM["tol"], config=state.solver,
        scenario_chunk=state.traffic["scenario_chunk"], device=state.device,
        dtype=state.dtype)


def setup(config, traffic, seed, device, sizes, dtype):
    from socp_tpu_torch import SolverConfig

    solver = SolverConfig(**{**config.SOLVER, **traffic.get("solver", {})})
    state = State(config, traffic, config.problem(seed, sizes), solver,
                  device, dtype)
    _call(state, traffic["warmup_rounds"])
    return state


def _send(state):
    c0 = counters()
    t0 = time.perf_counter()
    res = _call(state, state.traffic["rounds"])
    t1 = time.perf_counter()
    return Call(t0, t1, {"result": res, "counters": delta(c0, counters()),
                         "rounds": res.outer_iterations})


def window(state, seconds):
    calls = []
    start = time.perf_counter()
    while True:
        calls.append(_send(state))
        if calls[-1].t1 - start >= seconds:
            return calls, calls[-1].t1 - start


def stretch(state):
    """One call, for the profiler."""
    call = _send(state)
    return [call], {"calls": 1, "rounds": call.work["rounds"]}


def finish(state, calls):
    return [{"problem": state.problem, "result": c.work["result"]} for c in calls]


def counts(records):
    bad = sum(1 for r in records if not r["result"].inner_status_ok)
    return len(records), bad
