"""Batched robust least squares: B independent SOCPs in lockstep
(BASELINE config 3), the port of examples/batched_robust_ls.py.

    python -m socp_tpu_torch.examples.batched_robust_ls [B] [--cpu]
"""

from __future__ import annotations

import time

import numpy as np

from socp_tpu_torch.api import resolve_device, solve_batch_raw
from socp_tpu_torch.config import SolverConfig
from socp_tpu_torch.examples import device_name, parse
from socp_tpu_torch.models.robust_ls import robust_ls_batch


def run(B: int = 64, n: int = 50, device=None) -> dict:
    """`robust_ls_batch(0, B, n)` solved twice through `solve_batch_raw`
    with `factor_dtype="dd32"`, on the card on the `native_dd` route as
    the reference takes it on its accelerator; returns the data, the
    second call's raw 8-tuple and what the script prints: the first
    call's s (the kernels' build included where they are not built yet),
    the second's, solves/s, the OPTIMAL count and the largest gap."""
    c, G, h, dims = robust_ls_batch(0, batch=B, n=n)
    cfg = SolverConfig(factor_dtype="dd32",
                       native_dd=resolve_device(device).type == "cuda")
    t0 = time.perf_counter()
    solve_batch_raw(c, G, h, dims, config=cfg, device=device)
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = solve_batch_raw(c, G, h, dims, config=cfg, device=device)
    steady_s = time.perf_counter() - t0
    status, stats = out[4], out[6]
    return {"data": (c, G, h, dims), "out": out, "config": cfg, "B": B,
            "first_s": first_s, "steady_s": steady_s,
            "solves_per_s": B / steady_s,
            "optimal": int((status == 0).sum()),
            "max_gap": float(stats[:, 2].max()),
            "iterations": int(np.max(out[5])),
            "device": device_name(device)}


def main(argv=None) -> None:
    device, args = parse(argv)
    r = run(B=int(args[0]) if args else 64, device=device)
    print(f"first call (incl. the kernels' build): {r['first_s']:.1f}s "
          f"on {r['device']}")
    print(f"steady: {r['steady_s']:.2f}s -> {r['solves_per_s']:.1f} solves/s "
          f"| optimal {r['optimal']}/{r['B']} | max gap {r['max_gap']:.2e} "
          f"| on {r['device']}")


if __name__ == "__main__":
    main()
