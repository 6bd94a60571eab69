"""Replay pytest-xdist's `--dist load` schedule of the tier-1 suite on
measured test times, to see what sets its wall time.

xdist (3.x, `LoadScheduling`) hands each of the W workers a first chunk of
c = (N // W) // 4 consecutive tests of the N collected, then tops a worker
up from the front of the queue when it runs low.  The reference's long
tests (tests/test_dd_kkt.py, test_gondzio.py, test_hugecone.py,
test_pallas.py, all among the first ~160 of the collection) fall into the
first chunks, so where c cuts them apart, and not the port's tests
(collected after them), decides the longest worker.  N moves c: every test
a PR adds anywhere counts.

    # times: a junit file from one whole run of the tier-1 command
    python -m pytest tests/ -m 'not slow' -n 6 --dist load \
        --junitxml=run.xml ...
    python tier1_schedule.py run.xml                  # this collection
    python tier1_schedule.py run.xml --extra -40 40   # N - 40 ... N + 40

For each N it prints c, the longest worker's end (s), and how many of the
tests that passed in run.xml end before the limit when every test takes
`--scale` times its measured time (a slower or busier machine).  Added
tests take 0.01 s each and are put after the reference's tests; removed
ones are taken from the same place.
"""

from __future__ import annotations

import argparse
import heapq
import subprocess
import sys
import xml.etree.ElementTree as ET


def collected(collect_file: str | None) -> list[str]:
    """Test ids in collection order, from a file of `--collect-only -q`
    lines or from running the collection here."""
    if collect_file:
        lines = open(collect_file).read().splitlines()
    else:
        lines = subprocess.run(
            [sys.executable, "-m", "pytest", "tests/", "-q", "-m", "not slow",
             "--collect-only", "-p", "no:cacheprovider", "-p", "no:xdist",
             "-o", "addopts=", "-p", "no:randomly"],
            capture_output=True, text=True, check=False).stdout.splitlines()
    return [line.strip() for line in lines if "::" in line]


def measured(junit: str) -> dict[str, tuple[float, bool]]:
    """id -> (seconds, passed) from a junit file."""
    out = {}
    for tc in ET.parse(junit).iter("testcase"):
        test_id = tc.get("classname").replace(".", "/") + ".py::" + tc.get("name")
        bad = any(tc.find(tag) is not None
                  for tag in ("skipped", "failure", "error"))
        out[test_id] = (float(tc.get("time")), not bad)
    return out


def replay(durs: list[float], workers: int = 6, start: float = 8.0,
           scale: float = 1.0) -> tuple[list[float], int]:
    """End time of every test under xdist's load schedule, and c."""
    n = len(durs)
    pending = list(range(n))
    chunk = max((n // workers) // 4, 2)
    queue = {w: pending[chunk * w:chunk * (w + 1)] for w in range(workers)}
    del pending[:chunk * workers]
    clock = dict.fromkeys(queue, start)
    ends = [0.0] * n
    events: list[tuple[float, int, int]] = []

    def begin(w):
        if queue[w]:
            i = queue[w][0]
            heapq.heappush(events, (clock[w] + durs[i] * scale, w, i))

    for w in queue:
        begin(w)
    while events:
        t, w, i = heapq.heappop(events)
        clock[w] = ends[i] = t
        queue[w].pop(0)
        if pending:
            low = max(2, len(pending) // workers // 4)
            high = max(2, len(pending) // workers // 2)
            q = queue[w]
            # xdist waits while a worker runs long tests and holds two more
            if len(q) < low and not (durs[i] >= 0.1 and len(q) >= 2):
                take = high - len(q)
                q += pending[:take]
                del pending[:take]
        begin(w)
    return ends, chunk


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("junit")
    ap.add_argument("--collected", help="file of `--collect-only -q` lines")
    ap.add_argument("--extra", type=int, nargs=2, default=(0, 0),
                    metavar=("FROM", "TO"), help="tests added (or removed)")
    ap.add_argument("--scale", type=float, nargs="+", default=[1.0, 1.5])
    ap.add_argument("--limit", type=float, default=1470.0)
    ap.add_argument("--workers", type=int, default=6)
    args = ap.parse_args()

    ids = collected(args.collected)
    times = measured(args.junit)
    missing = [i for i in ids if i not in times]
    if missing:
        sys.exit(f"{len(missing)} collected tests not in {args.junit}, "
                 f"e.g. {missing[0]}")
    durs = [times[i][0] for i in ids]
    ok = [times[i][1] for i in ids]
    # the first port test: added or removed tests go there
    at = next(k for k, i in enumerate(ids) if i.startswith("tests/test_torch_"))
    print("N  c  longest_worker_s  " + "  ".join(
        f"passed_by_{args.limit:g}s_x{s:g}" for s in args.scale))
    for extra in range(args.extra[0], args.extra[1] + 1):
        if extra >= 0:
            d = durs[:at] + [0.01] * extra + durs[at:]
            o = ok[:at] + [True] * extra + ok[at:]
        else:
            d, o = durs[:at] + durs[at - extra:], ok[:at] + ok[at - extra:]
        ends, chunk = replay(d, args.workers)
        counts = []
        for s in args.scale:
            ends_s, _ = replay(d, args.workers, scale=s)
            counts.append(sum(1 for e, p in zip(ends_s, o)
                              if p and e <= args.limit))
        print(len(d), chunk, f"{max(ends):.1f}",
              "  ".join(str(c) for c in counts))


if __name__ == "__main__":
    main()
