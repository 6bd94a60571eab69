"""The window's ms over the lockstep iterations its batches ran (launch
counters)."""

from benchmark.harness.measures import per, window_iterations


def read(run):
    return per(run.window_s * 1e3, window_iterations(run))
