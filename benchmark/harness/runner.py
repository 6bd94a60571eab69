"""One run of one cell: set-up, the measured window, an optional traced
stretch, then (outside every timing) the check against the plain
reference, and the result line.

`run_cell` is the whole run without the command line and without the look
for a card, so that the tests can drive it on the CPU at small sizes;
`main` is the command (benchmark/run.py), which refuses to run without
CUDA devices.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import sys
import time

import torch

from benchmark.harness import trace as tracing
from benchmark.harness.spec import ROOT, Spec

# top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "socp_tpu")


@dataclasses.dataclass
class Call:
    """One call of the timed path: host clock before and after, and what
    the driver recorded of it (launch-counter deltas, instances, rounds,
    the outputs to judge)."""

    t0: float
    t1: float
    work: dict


@dataclasses.dataclass
class Run:
    """What a metric reader sees of a finished run."""

    cell: dict
    config: object
    traffic: dict
    seconds: float
    setup_s: float
    window_s: float
    calls: list
    stretch: tracing.Stretch | None = None
    sizes: dict = dataclasses.field(default_factory=dict)

    def shape(self, key):
        """A size of the configuration as run (the tests' small sizes
        override the file's)."""
        return self.sizes.get(key, self.config.SHAPES[key])


def counters() -> dict:
    """The port's kernel-launch counters (socp_tpu_torch.ops.chol), by
    kernel name, the f32 instances under `<name>_f32`."""
    from socp_tpu_torch.ops import chol

    out = {}
    for kernel, attr in chol.COUNTERS.items():
        out[kernel] = getattr(chol, attr)
        out[kernel + "_f32"] = getattr(chol, attr + "_f32")
    return out


def delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole: `socp_tpu_torch` is not `socp_tpu`."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def _number(v):
    """A JSON-safe number: non-finite values as strings."""
    v = float(v)
    return v if math.isfinite(v) else repr(v)


def compare(readings: dict, limits: dict) -> tuple[bool, dict]:
    """Each number with a limit against it: correct iff every one is
    present, finite and at most its limit."""
    checks, ok = {}, True
    for name, spec in limits["numbers"].items():
        value = readings.get(name)
        good = value is not None and math.isfinite(value) and value <= spec["limit"]
        ok &= good
        checks[name] = {"value": None if value is None else _number(value),
                        "limit": spec["limit"]}
    return ok, checks


def _describe(calls, window_s):
    """A line on standard error of what the window ran: calls, seconds,
    each call's ms (least, median, most) and the launches it counted."""
    ms = sorted((c.t1 - c.t0) * 1e3 for c in calls)
    launched = {}
    for c in calls:
        for k, v in c.work["counters"].items():
            launched[k] = launched.get(k, 0) + v
    print(f"benchmark: window {len(calls)} calls in {window_s!r} s; call ms "
          f"{ms[0]!r} / {ms[len(ms) // 2]!r} / {ms[-1]!r}; launches "
          f"{ {k: v for k, v in launched.items() if v} }", file=sys.stderr)


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", sizes: dict | None = None, dtype=None,
             spec: Spec | None = None, t_start: float | None = None):
    """Run one cell once; return the result line as a dict (checks last)
    and every reading of the check, compared or not.  `sizes` overrides
    the configuration's sizes (tests only); `dtype` is the carry dtype
    handed to the program (None: the configuration's f64; float32 is the
    control's path)."""
    t_start = time.perf_counter() if t_start is None else t_start
    spec = spec or Spec()
    cell = spec.cell(cell_name)
    config = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    limits = spec.limits(cell_name)
    metrics = spec.metrics(cell_name, trace)
    readers = {m["name"]: spec.reader(m["name"]) for m in metrics}
    driver = spec.driver(traffic["driver"])
    sizes = dict(sizes or {})

    state = driver.setup(config, traffic, seed, device, sizes, dtype)
    if device != "cpu":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    calls, window_s = driver.window(state, seconds)
    _describe(calls, window_s)
    stretch = last = None
    if trace:
        traced_calls = []

        def one_stretch():
            new, work = driver.stretch(state)
            traced_calls.extend(new)
            return work

        shapes = {k: sizes.get(k, v) for k, v in config.SHAPES.items()}
        stretch, last, _ = tracing.traced(
            one_stretch, counters,
            lambda d: config.least_times(d, shapes, traffic))
        calls_judged = calls + traced_calls
    else:
        calls_judged = calls
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    records = driver.finish(state, calls_judged)
    del state
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    readings = config.judge(records, device, sizes, traffic)
    correct, checks = compare(readings, limits)

    run = Run(cell=cell, config=config, traffic=traffic, seconds=seconds,
              setup_s=setup_s, window_s=window_s, calls=calls,
              stretch=stretch, sizes=sizes)
    values = {}
    for m in metrics:
        v = readers[m["name"]].read(run)
        if v is None:
            print(f"benchmark: {m['name']}: not measured", file=sys.stderr)
            continue
        values[m["name"]] = {"value": _number(v), "unit": m["unit"]}
    found = forbidden_modules()
    if found:
        raise SystemExit(f"benchmark: the run loaded {', '.join(found)}; no "
                         "module of jax, jaxlib, flax or socp_tpu may load")
    attempted, failed = driver.counts(records)
    dev = {"platform": "gpu" if device != "cpu" else "cpu",
           "kind": torch.cuda.get_device_name(0) if device != "cpu" else "cpu",
           "count": int(cell.get("chips", 1)),
           "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": values, "device": dev}
    if trace:
        seen = stretch or last
        if stretch is None and seen is not None:
            print("benchmark: busy_s and the breakdown are from a stretch "
                  "that failed its checks", file=sys.stderr)
        if seen is not None and seen.busy_s > 0:
            dev["busy_s"] = seen.busy_s
            dev["window_s"] = seen.wall_s
            result["breakdown"] = seen.breakdown()
    result["checks"] = checks
    return result, readings


def parse(argv):
    p = argparse.ArgumentParser(
        prog="benchmark/run.py",
        description="Run one cell of the benchmark once on the CUDA "
                    "devices of this machine and print its result line.")
    p.add_argument("--workload", required=True, help="a workload of BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cache_dirs():
    """Kernel and build caches in fixed directories inside the checkout
    (the port's own nvcc builds are in socp_tpu_torch/_build/)."""
    base = ROOT / ".bench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels")):
        os.environ[var] = str(base / sub)


def main(argv=None, t_start=None) -> int:
    args = parse(argv)
    spec = Spec()
    cell = spec.cell(args.workload)
    chips = int(cell.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " (no CPU fallback)", file=sys.stderr)
        return 2
    cache_dirs()
    # the host thread that drives the card and its helpers on two cores
    os.sched_setaffinity(0, sorted(os.sched_getaffinity(0))[:2])
    torch.set_num_threads(1)
    result, readings = run_cell(args.workload, args.seed, args.seconds,
                                bool(args.trace), spec=spec, t_start=t_start)
    for name, v in readings.items():
        print(f"reading {name} {v!r}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
