"""Markowitz portfolio with a factor risk model (BASELINE config 2): the
port of examples/portfolio.py.

    python -m socp_tpu_torch.examples.portfolio [--cpu]
"""

from __future__ import annotations

import time

from socp_tpu_torch.api import solve
from socp_tpu_torch.examples import device_name, parse
from socp_tpu_torch.models.portfolio import portfolio, portfolio_risk


def run(seed: int = 7, n: int = 200, k: int = 16, sigma_max: float = 0.15,
        verbose: bool = True, device=None) -> dict:
    """Solve `portfolio(seed, n, k, sigma_max)` with the iteration table
    (`verbose`); returns the problem, the Solution and what the script
    prints: status, iterations, gap, expected return, risk and its
    limit, the budget's error, the least weight and the solve's wall s."""
    prob, info = portfolio(seed=seed, n=n, k=k, sigma_max=sigma_max)
    t0 = time.perf_counter()
    sol = solve(prob, verbose=verbose, device=device)
    wall_s = time.perf_counter() - t0
    w = sol.x[:n]
    return {"problem": prob, "solution": sol, "status": sol.status,
            "iterations": sol.iterations, "gap": sol.gap,
            "pcost": sol.pcost, "inaccurate": sol.inaccurate,
            "expected_return": float(info["mu"] @ w),
            "risk": portfolio_risk(info, w), "sigma_max": sigma_max,
            "budget_err": abs(float(w.sum()) - 1.0),
            "w_min": float(w.min()), "wall_s": wall_s,
            "device": device_name(device)}


def main(argv=None) -> None:
    device, _ = parse(argv)
    r = run(device=device)
    print(f"\nstatus={r['status'].name} iters={r['iterations']} "
          f"gap={r['gap']:.2e}")
    print(f"expected return: {r['expected_return']:.4f}")
    print(f"risk: {r['risk']:.4f} (limit {r['sigma_max']})")
    print(f"solve: {r['wall_s']:.3f}s on {r['device']}")


if __name__ == "__main__":
    main()
