"""Mean lockstep iterations a batch in the window (launch counters)."""

from benchmark.harness.measures import window_iterations


def read(run):
    return window_iterations(run) / len(run.calls)
