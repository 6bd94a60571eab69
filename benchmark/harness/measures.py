"""Arithmetic that the metric readers (metrics/*.py) share: percentiles,
the lockstep and ADMM iteration counts read from the port's launch
counters, and the traced stretch's quantities per unit of work."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The q-th percentile of values, linear between the closest ranks
    (numpy's default): rank q/100 (n - 1) of the sorted values."""
    v = sorted(values)
    if not v:
        raise ValueError("percentile of no values")
    pos = q / 100.0 * (len(v) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def factors(counts: dict) -> int:
    """Batched Cholesky launches, f64 and f32 instances together."""
    return counts["chol_batched"] + counts["chol_batched_f32"]


def batch_iterations(counts: dict, batches: int) -> int:
    """Lockstep iterations of `batches` cold batched solves with no
    equality rows (p = 0): one factor an iteration, one more at the
    W = I start of each solve."""
    return factors(counts) - batches


def admm_iterations(counts: dict) -> int:
    """Inner lockstep iterations of one unchunked ADMM call whose scenario
    solves have one equality row (p = 1): two factors an iteration (H and
    the 1 x 1 Schur complement), two more at the call's cold W = I start
    (later rounds start warm)."""
    f = factors(counts) - 2
    return f // 2 if f >= 0 and f % 2 == 0 else None


def window_iterations(run) -> int:
    return sum(batch_iterations(c.work["counters"], 1) for c in run.calls)


def stretch_iterations(run):
    st = run.stretch
    return None if st is None else batch_iterations(st.counters, st.work["calls"])


def stretch_rounds(run):
    st = run.stretch
    return None if st is None else st.work["rounds"]


def per(value, units):
    """value / units, or None where either is missing or units is 0."""
    if value is None or not units:
        return None
    return value / units


def roofline(run, kernel: str):
    """The kernel's share of its roofline over the traced stretch, in %:
    the least time of the launches the counters count, at the cell's
    shapes (configs/<config>.py `least_times`), over the kernel's device
    time in the trace."""
    st = run.stretch
    if st is None or not st.launches(kernel):
        return None
    shapes = {k: run.shape(k) for k in run.config.SHAPES}
    least = run.config.least_times(st.counters, shapes, run.traffic).get(kernel)
    if least is None:
        return None
    return 100.0 * least[0] / st.seconds(kernel)


def idle_share(run, busy_units, window_units):
    """1 - busy seconds per unit of work in the traced stretch over wall
    seconds per unit in the unprofiled window, in %."""
    st = run.stretch
    if st is None:
        return None
    busy = per(st.busy_s, busy_units)
    wall = per(run.window_s, window_units)
    if busy is None or wall is None:
        return None
    return 100.0 * (1.0 - busy / wall)
