"""Inner lockstep iterations a round in the window (launch counters: two
factors an iteration, two at each unchunked call's cold start)."""

from benchmark.harness.measures import admm_iterations, per


def read(run):
    its = [admm_iterations(c.work["counters"]) for c in run.calls]
    if any(i is None for i in its):
        return None
    return per(sum(its), sum(c.work["rounds"] for c in run.calls))
