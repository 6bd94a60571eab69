"""Device ms of cuBLAS kernels (gemm, gemv, cutlass) a lockstep iteration
in the traced stretch."""

from benchmark.harness.measures import per, stretch_iterations


def read(run):
    if run.stretch is None:
        return None
    return per(run.stretch.seconds("cublas") * 1e3, stretch_iterations(run))
