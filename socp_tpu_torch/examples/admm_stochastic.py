"""Two-stage stochastic portfolio via consensus ADMM over scenario
subproblems (BASELINE config 5), cross-checked against the extensive
form: the port of examples/admm_stochastic.py.

    python -m socp_tpu_torch.examples.admm_stochastic [--cpu]

At the script's rho = 1 the run stops at its 100-round limit before the
1e-6 tolerance, as the reference's does (ROADMAP.md, queue 3 item 12).
"""

from __future__ import annotations

import time

from socp_tpu_torch.api import solve
from socp_tpu_torch.examples import device_name, parse
from socp_tpu_torch.models.stochastic import extensive_form, scenario_portfolio
from socp_tpu_torch.parallel.admm import admm_consensus


def run(S: int = 32, n: int = 12, rho: float = 1.0, rounds: int = 100,
        tol: float = 1e-6, verbose: bool = True, device=None) -> dict:
    """`scenario_portfolio(0, n, S)` through `admm_consensus` (at most
    `rounds` rounds to `tol`), then its extensive form through `solve`;
    returns the data, the ADMMResult, the extensive form's problem and
    Solution, and each part's wall s."""
    c, G, h, dims, A, b, info = scenario_portfolio(0, n=n, n_scenarios=S)
    t0 = time.perf_counter()
    res = admm_consensus(c, G, h, dims, info["n"], A=A, b=b, rho=rho,
                         outer_iters=rounds, tol=tol, verbose=verbose,
                         device=device)
    admm_s = time.perf_counter() - t0
    ext_prob = extensive_form(c, G, h, dims, A, b, info)
    t0 = time.perf_counter()
    ext = solve(ext_prob, device=device)
    ext_s = time.perf_counter() - t0
    return {"data": (c, G, h, dims, A, b, info), "admm": res,
            "outer_iterations": res.outer_iterations,
            "objective": res.objective, "extensive_problem": ext_prob,
            "extensive": ext, "admm_s": admm_s, "extensive_s": ext_s,
            "device": device_name(device)}


def main(argv=None) -> None:
    device, _ = parse(argv)
    r = run(device=device)
    ext = r["extensive"]
    print(f"\nADMM: {r['outer_iterations']} outer iters, "
          f"objective {r['objective']:.6f} ({r['admm_s']:.2f}s on "
          f"{r['device']})")
    print(f"extensive form: {ext.status.name}, objective {ext.pcost:.6f} "
          f"({r['extensive_s']:.2f}s on {r['device']})")


if __name__ == "__main__":
    main()
