"""Closed loop, one client, over `socp_tpu_torch.prepare_batch`'s solve.

Set-up makes a pool of `pool` distinct batches from the seed (the
configuration's `pool(...)`), places each on the device once through
`prepare_batch` with the configuration's solver settings and the mix's
`solver` overrides, and solves one batch to warm up.  The window sends
the pool's batches back to back, in turn, each to the end of the host
read of its status, until `seconds` have passed; the last batch sent
finishes.  Every batch's outputs stay on the device until the window has
closed and are then judged.
"""

from __future__ import annotations

import time

from benchmark.harness.runner import Call, counters, delta


class State:
    def __init__(self, config, traffic, items, prepared, device):
        self.config, self.traffic = config, traffic
        self.items, self.prepared, self.device = items, prepared, device
        self.sent = 0


def setup(config, traffic, seed, device, sizes, dtype):
    from socp_tpu_torch import SolverConfig, prepare_batch

    solver = SolverConfig(**{**config.SOLVER, **traffic.get("solver", {})})
    items = config.pool(seed, traffic["pool"], device, sizes)
    prepared = []
    for it in items:
        fn, args, _ = prepare_batch(it.pop("c"), it.pop("G"), it.pop("h"),
                                    it["dims"], config=solver, dtype=dtype,
                                    device=device)
        prepared.append((fn, args))
    state = State(config, traffic, items, prepared, device)
    fn, args = prepared[0]
    fn(*args)[4].cpu()                                  # warm-up
    return state


def _send(state):
    k = state.sent % len(state.prepared)
    fn, args = state.prepared[k]
    c0 = counters()
    t0 = time.perf_counter()
    out = fn(*args)
    out[4].cpu()                                        # the status read
    t1 = time.perf_counter()
    state.sent += 1
    return Call(t0, t1, {"item": k, "out": out,
                         "counters": delta(c0, counters()),
                         "instances": int(out[4].shape[0])})


def window(state, seconds):
    calls = []
    start = time.perf_counter()
    while True:
        calls.append(_send(state))
        if calls[-1].t1 - start >= seconds:
            return calls, calls[-1].t1 - start


def stretch(state):
    """One pass over the pool, for the profiler."""
    calls = [_send(state) for _ in range(len(state.prepared))]
    return calls, {"calls": len(calls),
                   "instances": sum(c.work["instances"] for c in calls)}


def finish(state, calls):
    """The judged records: each call's outputs with its pool item; the
    program's placed data are released."""
    from socp_tpu_torch import Status

    state.prepared = None
    records = []
    for c in calls:
        x, y, s, z, status, k, stats, _ = c.work.pop("out")
        certified = (status == int(Status.OPTIMAL)) & (stats[:, 6] == 0)
        c.work["certified"] = int(certified.sum())
        records.append({"item": state.items[c.work["item"]], "x": x, "y": y,
                        "s": s, "z": z, "status": status, "k": k,
                        "stats": stats, "certified": c.work["certified"],
                        "instances": c.work["instances"]})
    return records


def counts(records):
    attempted = sum(r["instances"] for r in records)
    return attempted, attempted - sum(r["certified"] for r in records)
