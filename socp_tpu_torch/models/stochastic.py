"""Two-stage stochastic portfolio (BASELINE config 5).

A copy of `socp_tpu/models/stochastic.py`: the same seeds and arguments
give the same arrays in both packages.

First stage: portfolio weights w (consensus variable).  Second stage, per
return scenario i: shortfall recourse v_i >= max(0, r_floor - mu_i'w) with
linear penalty kappa.  Scenario subproblem over x = (w, v):

    minimize   -mu_i'w + kappa * v
    subject to 1'w = 1, w >= 0, v >= 0,
               mu_i'w + v >= r_floor
               ||(F'w, D w)|| <= sigma_max           (shared risk model)

The extensive form (one big SOCP with shared w and all v_i) is the exact
cross-check for the ADMM decomposition (parallel/admm.py).
"""

from __future__ import annotations

import numpy as np

from socp_tpu_torch.problem import ConeDims, SocpProblem


def scenario_portfolio(
    seed: int,
    n: int = 20,
    k: int = 4,
    n_scenarios: int = 8,
    sigma_max: float = 0.25,
    kappa: float = 2.0,
    r_floor: float = 0.05,
):
    """Batched scenario subproblems (for ADMM) + shared metadata.

    Returns (c (S, nv), G (S, m, nv), h (S, m), dims, A (1, nv), b, info).
    Variables per scenario: x = (w (n), v (1)); consensus coords = w.
    """
    rng = np.random.default_rng(seed)
    mu_bar = 0.05 + 0.15 * rng.random(n)
    F = rng.normal(size=(n, k)) * (0.2 / np.sqrt(k))
    Dhalf = 0.05 + 0.15 * rng.random(n)
    mus = mu_bar[None, :] + 0.1 * rng.normal(size=(n_scenarios, n)) / np.sqrt(n)

    nv = n + 1
    # cone rows: orthant [w >= 0 (n), v >= 0 (1), mu_i'w + v >= r_floor (1)]
    #            + SOC (k + n + 1) risk
    m = n + 2 + (k + n + 1)
    dims = ConeDims(l=n + 2, qs=(k + n + 1,))

    G = np.zeros((n_scenarios, m, nv))
    h = np.zeros((n_scenarios, m))
    c = np.zeros((n_scenarios, nv))
    # every scenario's rows at once (the reference fills them scenario by
    # scenario; the entries are the same)
    G[:, :n, :n] = -np.eye(n)                     # w >= 0
    G[:, n, n] = -1.0                             # v >= 0
    G[:, n + 1, :n] = -mus                        # mu'w + v >= r_floor
    G[:, n + 1, n] = -1.0
    h[:, n + 1] = -r_floor
    off = n + 2
    h[:, off] = sigma_max
    G[:, off + 1:off + 1 + k, :n] = -F.T
    G[:, off + 1 + k:, :n] = -np.diag(Dhalf)
    c[:, :n] = -mus
    c[:, n] = kappa
    A = np.zeros((1, nv))
    A[0, :n] = 1.0
    b = np.array([1.0])
    info = {"mus": mus, "F": F, "Dhalf": Dhalf, "sigma_max": sigma_max,
            "kappa": kappa, "r_floor": r_floor, "n": n}
    return c, G, h, dims, A, b, info


def extensive_form(c, G, h, dims, A, b, info) -> SocpProblem:
    """Exact extensive-form SOCP: variables (w (n), v_1..v_S); the orthant
    rows of every scenario first, then their SOC rows, in scenario order."""
    S, m, nv = G.shape
    n = info["n"]
    N = n + S
    l = dims.l
    cols = np.zeros((S, m, N))
    cols[:, :, :n] = G[:, :, :n]
    cols[np.arange(S), :, n + np.arange(S)] = G[:, :, n]    # v_i column
    GE = np.concatenate([cols[:, :l].reshape(S * l, N),
                         cols[:, l:].reshape(S * (m - l), N)])
    hE = np.concatenate([h[:, :l].ravel(), h[:, l:].ravel()])
    cE = np.zeros(N)
    # the reference sums the scenarios' w costs one at a time, in order
    for i in range(S):
        cE[:n] += c[i, :n] / S
    cE[n:] = c[:, n] / S
    AE = np.zeros((1, N))
    AE[0, :n] = 1.0
    dimsE = ConeDims(l=S * l, qs=tuple(dims.qs) * S)
    return SocpProblem(c=cE, G=GE, h=hE, dims=dimsE, A=AE, b=b)
