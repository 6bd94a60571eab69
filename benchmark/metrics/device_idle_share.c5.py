"""1 - device busy s an ADMM round (traced stretch) over wall s a round
(the unprofiled window of the same run), in %."""

from benchmark.harness.measures import idle_share, stretch_rounds


def read(run):
    return idle_share(run, stretch_rounds(run),
                      sum(c.work["rounds"] for c in run.calls))
