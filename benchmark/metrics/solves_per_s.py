"""Instances certified (status OPTIMAL, not accepted at the relaxed
tolerances) in the window, over the window's seconds."""


def read(run):
    return sum(c.work["certified"] for c in run.calls) / run.window_s
