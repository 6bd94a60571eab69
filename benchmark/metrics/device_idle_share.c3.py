"""1 - device busy ms a lockstep iteration (traced stretch) over wall ms a
lockstep iteration (the unprofiled window of the same run), in %."""

from benchmark.harness.measures import idle_share, stretch_iterations, window_iterations


def read(run):
    return idle_share(run, stretch_iterations(run), window_iterations(run))
