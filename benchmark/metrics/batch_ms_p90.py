"""The 90th percentile of every batch's latency in the window, send to
the host's read of its status, in ms."""

from benchmark.harness.measures import percentile


def read(run):
    return percentile([(c.t1 - c.t0) * 1e3 for c in run.calls], 90)
