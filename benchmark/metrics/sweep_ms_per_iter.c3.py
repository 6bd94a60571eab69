"""Device ms of the cone sweeps' kernels (elementwise, reductions, cat,
copy kernels; not the copy engines' transfers) a lockstep iteration in
the traced stretch."""

from benchmark.harness.measures import per, stretch_iterations
from benchmark.harness.trace import SWEEPS


def read(run):
    if run.stretch is None:
        return None
    return per(run.stretch.seconds(*SWEEPS) * 1e3, stretch_iterations(run))
