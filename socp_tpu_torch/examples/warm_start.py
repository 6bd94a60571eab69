"""Warm starting: re-solving a drifting problem from yesterday's optimum,
the port of examples/warm_start.py.

A daily portfolio rebalancing changes the problem a little each period,
and the previous solution is an excellent start.  `solve(prob, warm=(x,
y, s, z))` skips the least-squares initialization and recenters the
start a little into the cone interior (config.warm_push): a warm point ON
the boundary would destroy the NT scaling.

    python -m socp_tpu_torch.examples.warm_start [--cpu]
"""

from __future__ import annotations

import numpy as np

from socp_tpu_torch.api import solve
from socp_tpu_torch.examples import device_name, parse
from socp_tpu_torch.models.portfolio import portfolio


def run(n: int = 120, k: int = 12, days: int = 5, device=None) -> dict:
    """Day 0 cold, then `days` days whose expected returns drift by 2%
    (`default_rng(1)`), each solved cold and warm from the day before's
    warm solution; raises if a warm pcost leaves 1e-7 of the cold one.
    Returns day 0's problem and Solution and, a row a day, c and the
    cold and warm Solutions."""
    prob, _ = portfolio(0, n=n, k=k)
    day0 = prob.c.copy()
    base = solve(prob, device=device)
    rng = np.random.default_rng(1)
    rows = []
    prev = base
    for day in range(1, days + 1):
        # drift the expected returns a little
        prob.c = prob.c * (1.0 + 0.02 * rng.standard_normal(prob.c.shape))
        cold = solve(prob, device=device)
        warm = solve(prob, warm=(prev.x, prev.y, prev.s, prev.z),
                     device=device)
        if abs(warm.pcost - cold.pcost) > 1e-7 * max(1.0, abs(cold.pcost)):
            raise RuntimeError(f"day {day}: warm pcost {warm.pcost!r} is not "
                               f"cold's {cold.pcost!r} to 1e-7")
        rows.append({"day": day, "c": prob.c.copy(), "cold": cold,
                     "warm": warm})
        prev = warm
    prob.c = day0
    return {"problem": prob, "base": base, "days": rows,
            "total_cold": sum(r["cold"].iterations for r in rows),
            "total_warm": sum(r["warm"].iterations for r in rows),
            "device": device_name(device)}


def main(argv=None) -> None:
    device, _ = parse(argv)
    r = run(device=device)
    base = r["base"]
    print(f"day 0 (cold): {base.iterations} iterations, "
          f"pcost {base.pcost:.6f}")
    for row in r["days"]:
        print(f"day {row['day']}: cold {row['cold'].iterations} iters, "
              f"warm {row['warm'].iterations} iters (same optimum)")
    cold, warm = r["total_cold"], r["total_warm"]
    print(f"\ntotals over {len(r['days'])} re-solves: cold {cold}, warm "
          f"{warm} ({100 * (1 - warm / cold):.0f}% fewer iterations) "
          f"on {r['device']}")


if __name__ == "__main__":
    main()
