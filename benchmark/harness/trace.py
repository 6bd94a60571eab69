"""A traced stretch: torch.profiler over a few calls of the timed path,
reduced to device time by kernel category, the device's busy time, its
operation count, and the longest idle gaps labelled by what the host was
doing.

The tracer sometimes drops a trace or part of one, so a stretch is kept
only if it passes three checks (`problems`): the profiler saw device
time; the sum of the device operations' times is no more than the CUDA
events' time around the same stretch; and no kernel with a known least
time (harness/roofline.py) ran faster than it.  A stretch that fails is
traced again, up to `tries` times; after that the metrics that read it are
not reported.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time
from pathlib import Path

import torch

_CATEGORIES = json.loads((Path(__file__).with_name("categories.json")).read_text())


def category(name: str) -> str:
    """The category of a device operation's name (categories.json)."""
    low = name.lower()
    for key, cat in _CATEGORIES["categories"]:
        if key in low:
            return f"{cat}_f32" if "_kernel<float" in low else cat
    return "other"


SWEEPS = tuple(_CATEGORIES["sweeps"])


@dataclasses.dataclass
class Stretch:
    """One traced stretch, reduced."""

    wall_s: float                  # host clock around the stretch
    event_s: float                 # CUDA events around the stretch
    busy_s: float                  # union of the device operations' times
    ops: int                       # device operations (kernels, copies, sets)
    by_category: dict              # category -> [seconds, count]
    by_name: dict                  # name -> [seconds, count]
    durations: dict                # category -> list of each launch's seconds
    gaps: list                     # [label, seconds], longest first
    counters: dict                 # launch-counter deltas over the stretch
    work: dict                     # what the stretch ran (iterations, rounds)

    def seconds(self, *cats) -> float:
        return sum(self.by_category.get(c, [0.0, 0])[0] for c in cats)

    def launches(self, cat) -> int:
        return self.by_category.get(cat, [0.0, 0])[1]

    def breakdown(self) -> dict:
        """The ten device operations that took most time (names cut to 160
        characters) and the ten longest idle gaps."""
        top = sorted(self.by_name.items(), key=lambda kv: -kv[1][0])[:10]
        return {"device_ops": [[name[:160], v[0]] for name, v in top],
                "idle_gaps": [list(g) for g in self.gaps[:10]]}


def _events(prof):
    """(device?, name, start_ns, duration_ns) for every event of a trace."""
    from torch.autograd import DeviceType

    try:
        raw = prof.profiler.kineto_results.events()
        return [(e.device_type() == DeviceType.CUDA, e.name(), e.start_ns(),
                 e.duration_ns()) for e in raw]
    except AttributeError:
        return [(e.device_type == DeviceType.CUDA, e.name,
                 int(e.time_range.start * 1000), int(e.time_range.elapsed_us() * 1000))
                for e in prof.events()]


# the profiler's own host events, which say nothing of the program
_OWN = ("Activity Buffer Request", "[memory]", "ProfilerStep")


def _label(cpu, t_ns):
    """What the host was doing at t_ns: the innermost host event around it,
    or the last one that ended before it."""
    inner, last = None, None
    for name, start, dur in cpu:
        if name.startswith(_OWN):
            continue
        if start <= t_ns <= start + dur:
            if inner is None or dur < inner[1]:
                inner = (name, dur)
        elif start + dur < t_ns and (last is None or start + dur > last[1]):
            last = (name, start + dur)
    if inner is not None:
        return inner[0]
    return f"host between ops, after {last[0]}" if last else "host"


def reduce(events, wall_s, event_s, counters, work) -> Stretch:
    dev = sorted((s, d, n) for is_dev, n, s, d in events if is_dev and d >= 0)
    cpu = [(n, s, d) for is_dev, n, s, d in events if not is_dev]
    by_cat, by_name, durations = {}, {}, {}
    busy, cur_s, cur_e = 0, None, None
    gaps = []
    for s, d, n in dev:
        c = by_cat.setdefault(category(n), [0.0, 0])
        c[0] += d / 1e9
        c[1] += 1
        durations.setdefault(category(n), []).append(d / 1e9)
        v = by_name.setdefault(n, [0.0, 0])
        v[0] += d / 1e9
        v[1] += 1
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((s - cur_e, cur_e, s))
            cur_s, cur_e = s, s + d
        else:
            cur_e = max(cur_e, s + d)
    if cur_e is not None:
        busy += cur_e - cur_s
    gaps.sort(reverse=True)
    labelled = [[_label(cpu, (a + b) // 2), g / 1e9] for g, a, b in gaps[:10]]
    return Stretch(wall_s=wall_s, event_s=event_s, busy_s=busy / 1e9,
                   ops=len(dev), by_category=by_cat, by_name=by_name,
                   durations=durations, gaps=labelled, counters=counters,
                   work=work)


def problems(st: Stretch, least) -> list[str]:
    """Why a stretch cannot be read; `least` maps a category to (least
    seconds of all its launches, least seconds of its cheapest launch)."""
    out = []
    if st.busy_s <= 0:
        out.append("the profiler saw no device time")
    total = sum(v[0] for v in st.by_category.values())
    if total > st.event_s * 1.001 + 5e-5:
        out.append(f"device operations sum to {total!r} s, over the "
                   f"{st.event_s!r} s of the CUDA events around them")
    for cat, (all_s, one_s) in least.items():
        if st.launches(cat) and st.seconds(cat) < all_s:
            out.append(f"{cat}: {st.seconds(cat)!r} s of device time, under "
                       f"its least time {all_s!r} s")
        fast = [d for d in st.durations.get(cat, []) if d < one_s]
        if fast:
            out.append(f"{cat}: {len(fast)} launches under {one_s!r} s, the "
                       "least time of its cheapest launch")
    return out


def capture(stretch):
    """One run of `stretch()` under the profiler, between CUDA events:
    (events, host seconds, event seconds, the work it reports)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        a.record()
        work = stretch()
        b.record()
        b.synchronize()
        wall = time.perf_counter() - t0
    return _events(prof), wall, a.elapsed_time(b) / 1e3, work


def traced(stretch, counters, least_of, tries: int = 3, capture=capture):
    """Trace `stretch()` (which returns a dict of the work it did) until a
    trace passes `problems`, up to `tries` times.  `counters()` reads the
    launch counters; `least_of(deltas)` gives the least times for
    `problems`.  Returns (Stretch or None, the last Stretch seen,
    attempts)."""
    last = None
    for attempt in range(tries):
        before = counters()
        events, wall, event_s, work = capture(stretch)
        after = counters()
        deltas = {k: after[k] - before[k] for k in after}
        st = reduce(events, wall, event_s, deltas, work)
        last = st
        found = problems(st, least_of(deltas))
        if not found:
            return st, st, attempt + 1
        print(f"benchmark: traced stretch {attempt + 1} of {tries} not read: "
              + "; ".join(found), file=sys.stderr, flush=True)
    return None, last, tries
