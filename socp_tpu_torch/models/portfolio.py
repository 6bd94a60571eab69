"""Markowitz portfolio SOCP with a factor risk model (BASELINE config-2).

A copy of `socp_tpu/models/portfolio.py`: the same seeds give the same
instances in both packages.

    maximize    mu'w
    subject to  ||(F'w, sqrt(D) w)||_2 <= sigma_max      (risk limit)
                1'w = 1,  w >= 0

with covariance Sigma = F F' + diag(D) (factor model, F in R^{n x k}).

Variables w in R^n.  Cone: orthant l = n (w >= 0) followed by one SOC of
dimension k + n + 1 (risk).  One equality row (budget).
"""

from __future__ import annotations

import numpy as np

from socp_tpu_torch.problem import ConeDims, SocpProblem


def portfolio(
    seed: int, n: int = 500, k: int = 20, sigma_max: float = 0.15
) -> tuple[SocpProblem, dict]:
    rng = np.random.default_rng(seed)
    mu = 0.05 + 0.15 * rng.random(n)                 # expected returns
    F = rng.normal(size=(n, k)) * (0.2 / np.sqrt(k))  # factor loadings
    Dhalf = 0.05 + 0.15 * rng.random(n)               # idiosyncratic vol

    m = n + (k + n + 1)
    G = np.zeros((m, n))
    h = np.zeros(m)
    # orthant rows: -w + s = 0  (w >= 0)
    G[:n, :] = -np.eye(n)
    # SOC rows: s = (sigma_max, F'w, diag(Dhalf) w)
    off = n
    h[off] = sigma_max
    G[off + 1 : off + 1 + k, :] = -F.T
    G[off + 1 + k :, :] = -np.diag(Dhalf)
    A = np.ones((1, n))
    b = np.array([1.0])
    dims = ConeDims(l=n, qs=(k + n + 1,))
    prob = SocpProblem(c=-mu, G=G, h=h, dims=dims, A=A, b=b)
    return prob, {"mu": mu, "F": F, "Dhalf": Dhalf, "sigma_max": sigma_max}


def portfolio_risk(info: dict, w: np.ndarray) -> float:
    """sqrt(w' Sigma w) under the factor model."""
    return float(
        np.sqrt(np.sum((info["F"].T @ w) ** 2) + np.sum((info["Dhalf"] * w) ** 2))
    )
