"""Profiling helpers: the port of `socp_tpu/utils/profiling.py`.

`PhaseTimers` accumulates named wall-clock phases on the host; once CUDA
is initialised it synchronizes the current device before each clock
read, so a phase holds the device time of the kernels it enqueued.
`trace` profiles a block with `torch.profiler` (the CPU, and CUDA where it
is available) and writes a Chrome / Perfetto trace into a directory.

    timers = PhaseTimers()
    with timers.phase("solve"):
        sol = solve(prob)
    print(timers.report())

    with trace("/path/to/dir") as log_dir:
        sol = solve(prob)          # log_dir now holds one *.pt.trace.json
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from collections import defaultdict

import torch


def _clock() -> float:
    """The host clock, after the current CUDA device has gone idle (where
    CUDA is initialised)."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return time.perf_counter()


class PhaseTimers:
    """Accumulating named wall-clock timers (blocks until device idle)."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = _clock()
        try:
            yield
        finally:
            self.totals[name] += _clock() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            lines.append(
                f"{name:30s} {self.totals[name]*1e3:10.2f} ms "
                f"({self.counts[name]} calls)"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Profile the block with torch.profiler and, on exit, write its
    Chrome / Perfetto trace (`<pid>_<ns>.pt.trace.json`) into `log_dir`
    (made if missing; by default `socp_tpu_torch_trace` in the temporary
    directory, /tmp/socp_tpu_torch_trace where TMPDIR is unset).  Yields
    `log_dir`.  Open the file in https://ui.perfetto.dev or
    chrome://tracing."""
    from torch.profiler import ProfilerActivity, profile

    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "socp_tpu_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"{os.getpid()}_{time.time_ns()}.pt.trace.json"))
