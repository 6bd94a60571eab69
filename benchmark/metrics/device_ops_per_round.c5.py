"""Device operations (kernels, copies, sets) an ADMM round in the traced
stretch."""

from benchmark.harness.measures import per, stretch_rounds


def read(run):
    if run.stretch is None:
        return None
    return per(run.stretch.ops, stretch_rounds(run))
