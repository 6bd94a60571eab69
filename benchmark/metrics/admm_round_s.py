"""The window's seconds over the ADMM rounds its calls completed (each
call's data placement counted)."""


def read(run):
    return run.window_s / sum(c.work["rounds"] for c in run.calls)
