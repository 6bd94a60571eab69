"""chol_batched's share of its roofline in the traced stretch, in %."""

from benchmark.harness.measures import roofline


def read(run):
    return roofline(run, "chol_batched")
