"""Device operations (kernels, copies, sets) a lockstep iteration in the
traced stretch: the eager dispatch a device-resident loop would remove."""

from benchmark.harness.measures import per, stretch_iterations


def read(run):
    if run.stretch is None:
        return None
    return per(run.stretch.ops, stretch_iterations(run))
