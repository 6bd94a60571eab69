"""Set-up seconds: process start to the first timed call (imports, data
made from the seed and placed, the warm-up call; a checkout's first run
also builds the kernels)."""


def read(run):
    return run.setup_s
