"""Random SOCP generators (BASELINE config-1 family) and infeasible models.

A copy of `socp_tpu/models/random_socp.py`: the same seeds give the same
instances in both packages.

`random_socp` builds (x*, y*, s*, z*) satisfying the KKT conditions exactly
(per-cone complementary pairs), then derives (b, h, c) so the constructed
point is optimal:  b = Ax*, h = Gx* + s*, c = -(A'y* + G'z* + Px*).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from socp_tpu_torch.problem import ConeDims, SocpProblem


@dataclasses.dataclass
class KnownSolution:
    x: np.ndarray
    y: np.ndarray
    s: np.ndarray
    z: np.ndarray
    pcost: float


def _complementary_pair(rng, dims: ConeDims):
    """Draw (s*, z*) in K x K with s* o z* = 0 blockwise."""
    m = dims.dim
    s = np.zeros(m)
    z = np.zeros(m)
    for i in range(dims.l):
        if rng.random() < 0.5:
            s[i] = rng.uniform(0.5, 2.0)
        else:
            z[i] = rng.uniform(0.5, 2.0)
    for sl in dims.soc_slices():
        q = sl.stop - sl.start
        mode = int(rng.integers(0, 3)) if q >= 2 else int(rng.integers(0, 2))
        if mode == 0:  # constraint inactive: s interior, z = 0
            u = rng.normal(size=q - 1)
            if q >= 2:
                u *= rng.uniform(0.1, 0.8) / max(np.linalg.norm(u), 1e-12)
            s[sl.start] = rng.uniform(0.5, 2.0)
            s[sl.start + 1 : sl.stop] = s[sl.start] * u
        elif mode == 1:  # constraint "fully active": z interior, s = 0
            u = rng.normal(size=q - 1)
            if q >= 2:
                u *= rng.uniform(0.1, 0.8) / max(np.linalg.norm(u), 1e-12)
            z[sl.start] = rng.uniform(0.5, 2.0)
            z[sl.start + 1 : sl.stop] = z[sl.start] * u
        else:  # boundary pair: s = a(1,u), z = b(1,-u), ||u|| = 1
            u = rng.normal(size=q - 1)
            u /= max(np.linalg.norm(u), 1e-12)
            a, bb = rng.uniform(0.5, 2.0, size=2)
            s[sl.start] = a
            s[sl.start + 1 : sl.stop] = a * u
            z[sl.start] = bb
            z[sl.start + 1 : sl.stop] = -bb * u
    return s, z


def random_socp(
    seed: int,
    n: int = 50,
    l: int = 10,
    qs: tuple[int, ...] = (10, 15, 20),
    p: int = 5,
    quadratic: bool = False,
) -> tuple[SocpProblem, KnownSolution]:
    """KKT-constructed random SOCP with known optimum (BASELINE config-1 shape
    with the defaults: n=50, 3 SOCs of dim 10-20 + orthant)."""
    rng = np.random.default_rng(seed)
    dims = ConeDims(l, tuple(qs))
    xstar = rng.normal(size=n)
    ystar = rng.normal(size=p)
    sstar, zstar = _complementary_pair(rng, dims)
    A = rng.normal(size=(p, n)) / np.sqrt(n)
    G = rng.normal(size=(dims.dim, n)) / np.sqrt(n)
    P = None
    Px = np.zeros(n)
    if quadratic:
        M = rng.normal(size=(n, n)) / np.sqrt(n)
        P = M @ M.T + 0.1 * np.eye(n)
        Px = P @ xstar
    b = A @ xstar
    h = G @ xstar + sstar
    c = -(A.T @ ystar + G.T @ zstar + Px)
    pcost = float(0.5 * xstar @ Px + c @ xstar)
    prob = SocpProblem(c=c, G=G, h=h, dims=dims, A=A, b=b, P=P)
    return prob, KnownSolution(xstar, ystar, sstar, zstar, pcost)


def primal_infeasible_lp(seed: int = 0, n: int = 3) -> SocpProblem:
    """x_0 >= 1 and x_0 <= 0 simultaneously (all vars boxed so the dual has
    no Farkas ray): cleanly primal infeasible."""
    rng = np.random.default_rng(seed)
    G = np.zeros((2 + 2 * n, n))
    G[0, 0] = -1.0
    G[1, 0] = 1.0
    G[2 : 2 + n, :] = -np.eye(n)   # x >= -1
    G[2 + n :, :] = np.eye(n)      # x <= 1
    h = np.concatenate([[-1.0, 0.0], np.ones(2 * n)])
    return SocpProblem(c=rng.normal(size=n), G=G, h=h, dims=ConeDims(l=2 + 2 * n))


def dual_infeasible_lp(seed: int = 0, n: int = 3) -> SocpProblem:
    """min -x_0 with only x >= 0: unbounded below (dual infeasible)."""
    c = np.zeros(n)
    c[0] = -1.0
    return SocpProblem(c=c, G=-np.eye(n), h=np.zeros(n), dims=ConeDims(l=n))


def primal_infeasible_soc(seed: int = 0, q: int = 4) -> SocpProblem:
    """Infeasibility through CONE geometry: variables (t, u), constraints
    ||u|| <= t (SOC, forces t >= 0) and t <= -1 (orthant).  The Farkas dual
    ray needs a point on the SOC boundary."""
    rng = np.random.default_rng(seed)
    n = q  # (t, u) with u in R^{q-1}
    # orthant row: s0 = -1 - t >= 0  <=>  t <= -1
    # SOC rows:    s_soc = (t, u) in Q  <=>  ||u|| <= t
    G = np.zeros((1 + q, n))
    G[0, 0] = 1.0
    G[1:, :] = -np.eye(q)
    h = np.concatenate([[-1.0], np.zeros(q)])
    return SocpProblem(
        c=rng.normal(size=n), G=G, h=h, dims=ConeDims(l=1, qs=(q,))
    )


def dual_infeasible_soc(seed: int = 0, q: int = 4) -> SocpProblem:
    """min -t s.t. ||u|| <= t: the recession ray (t, u) = (1, 0) rides the
    SOC's axis and drops the objective without bound."""
    n = q
    c = np.zeros(n)
    c[0] = -1.0
    G = -np.eye(q)
    h = np.zeros(q)
    return SocpProblem(c=c, G=G, h=h, dims=ConeDims(l=0, qs=(q,)))
