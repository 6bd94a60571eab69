"""The plain reference for robust least squares,

    minimize  ||D x - d|| + rho ||x||,

and the certificate that judges a conic solver's answer to it.

The optimum: where the optimal x and D x - d are both nonzero, the
optimality condition D'(Dx - d)/||Dx - d|| + rho x/||x|| = 0 says that x
is the ridge solution x(lam) = (D'D + lam I)^-1 D'd at the lam > 0 with
phi(lam) = lam ||x(lam)|| - rho ||D x(lam) - d|| = 0.  phi < 0 near 0 and
phi > 0 for large lam whenever ||D'd|| > rho ||d|| (else x = 0 is
optimal), and any root is a stationary point of a convex function, so a
bisection on log(lam) finds the optimum; its value is first-order
insensitive to the error left in lam.  From it the conic solution
follows in closed form: t1 = ||r||, t2 = ||x||, s = (t1, r; t2, x) and
z = (1, -r/||r||; rho, -rho x/||x||), r = Dx - d.

The conic form is the one of the benchmark's generator: variables
(x, t1, t2), SOC rows (t1, Dx - d) then (t2, x), c = (0, 1, rho).
Everything here is plain PyTorch and imports nothing of the program.
"""

from __future__ import annotations

import math

import torch


def padded_index(l: int, qs, multiple: int):
    """For each row of the user's flat cone order, its position in a solver
    layout that pads every SOC to a multiple of `multiple` (at least 2) and
    groups the blocks by padded size, smallest first, after the orthant.
    Returns (index (m,) list, m_pad)."""
    def padq(q):
        q = max(q, 2)
        return -(-q // multiple) * multiple if multiple > 1 else q

    starts, off = [], l
    for q in qs:
        starts.append(off)
        off += q
    index = list(range(l)) + [0] * (off - l)
    pos = l
    for size in sorted(set(padq(q) for q in qs)):
        for i, q in enumerate(qs):
            if padq(q) == size:
                for j in range(q):
                    index[starts[i] + j] = pos + j
                pos += size
    return index, pos


def optimum(D, d, rho: float, steps: int = 200):
    """x* (B, n) and f* (B,) for (B, k, n) D and (B, k) d, in their dtype."""
    B, k, n = D.shape
    DtD = D.transpose(1, 2) @ D
    Dtd = (D.transpose(1, 2) @ d[:, :, None])[:, :, 0]
    eye = torch.eye(n, dtype=D.dtype, device=D.device)

    def ridge(lam):
        L = torch.linalg.cholesky(DtD + lam[:, None, None] * eye)
        return torch.cholesky_solve(Dtd[:, :, None], L)[:, :, 0]

    def phi(lam):
        x = ridge(lam)
        r = (D @ x[:, :, None])[:, :, 0] - d
        return (lam * torch.linalg.vector_norm(x, dim=1)
                - rho * torch.linalg.vector_norm(r, dim=1))

    # a bracket in log(lam): the scale of D'D's diagonal, widened until
    # the signs differ
    scale = torch.diagonal(DtD, dim1=1, dim2=2).mean(1)
    lo = torch.log(scale * 1e-12)
    hi = torch.log(scale * 1e6)
    x0 = (torch.linalg.vector_norm(Dtd, dim=1)
          <= rho * torch.linalg.vector_norm(d, dim=1))       # x = 0 optimal
    if bool((phi(torch.exp(lo)) >= 0).any() & ~x0.all()) or bool(
            ((phi(torch.exp(hi)) <= 0) & ~x0).any()):
        raise ValueError("robust LS reference: no bracket for the ridge "
                         "parameter")
    for _ in range(steps):
        mid = 0.5 * (lo + hi)
        neg = phi(torch.exp(mid)) < 0
        lo = torch.where(neg, mid, lo)
        hi = torch.where(neg, hi, mid)
        if bool(((hi - lo) < 4 * torch.finfo(D.dtype).eps * hi.abs().clamp_min(1)).all()):
            break
    x = ridge(torch.exp(0.5 * (lo + hi)))
    x = torch.where(x0[:, None], torch.zeros_like(x), x)
    return x, objective(D, d, rho, x)


def objective(D, d, rho: float, x):
    """||D x - d|| + rho ||x||, per instance."""
    r = (D @ x[:, :, None])[:, :, 0] - d
    return torch.linalg.vector_norm(r, dim=1) + rho * torch.linalg.vector_norm(x, dim=1)


def conic_solution(D, d, rho: float, x):
    """(v, s, z) of the conic form in the user's row order, from x."""
    r = (D @ x[:, :, None])[:, :, 0] - d
    nr = torch.linalg.vector_norm(r, dim=1)
    nx = torch.linalg.vector_norm(x, dim=1)
    v = torch.cat([x, nr[:, None], nx[:, None]], 1)
    s = torch.cat([nr[:, None], r, nx[:, None], x], 1)
    one = torch.ones_like(nr)[:, None]
    z = torch.cat([one, -r / nr[:, None], rho * one, -rho * x / nx[:, None]], 1)
    return v, s, z


def certificate(D, d, rho: float, v, s, z):
    """The conic answer (v, s, z) in the user's row order, judged against
    the data in f64: per instance (pres, dres, gap, relgap), as the
    solver's stopping rule defines them (y is empty: p = 0).

      pres   = ||G v + s - h|| / max(1, ||h||), or the relative distance
               of s from the cone if that is larger
      dres   = ||G'z + c|| / max(1, ||c||), or z's distance from the cone
      gap    = s'z, less the rounding of that sum, m eps sum_i |s_i z_i|
      relgap = gap / -pcost if pcost < 0, gap / dcost if dcost > 0, else inf

    with pcost = c'v and dcost = pcost + z'(G v + s - h) - gap.  The solver
    stops at the first iterate whose own s'z is under its tolerance, so
    the largest gaps of a batch lie within a few 1e-15 of it; s'z cancels
    a head against a tail of about its size, and two correct sums of the
    same terms in other orders differ by up to the rounding allowance,
    which keeps the recomputation from failing an answer that the
    solver's own sum accepted."""
    D, d, v, s, z = (t.to(torch.float64) for t in (D, d, v, s, z))
    B, k, n = D.shape
    x, t1, t2 = v[:, :n], v[:, n], v[:, n + 1]
    r = (D @ x[:, :, None])[:, :, 0] - d
    # G v + s - h, row by row: (-t1, -Dx; -t2, -x) + s - (0, -d; 0, 0)
    rz = torch.cat([(s[:, 0] - t1)[:, None], s[:, 1:k + 1] - r,
                    (s[:, k + 1] - t2)[:, None], s[:, k + 2:] - x], 1)
    # G'z + c: x gets -D' z1 - z2, t1 gets 1 - z1_0, t2 gets rho - z2_0
    z1, z2 = z[:, 1:k + 1], z[:, k + 2:]
    rx = torch.cat([-(D.transpose(1, 2) @ z1[:, :, None])[:, :, 0] - z2,
                    (1.0 - z[:, 0])[:, None], (rho - z[:, k + 1])[:, None]], 1)
    norm_h = torch.linalg.vector_norm(d, dim=1).clamp_min(1.0)
    norm_c = math.sqrt(1.0 + rho * rho)

    def outside(u):         # how far u lies outside the two SOCs
        a = torch.linalg.vector_norm(u[:, 1:k + 1], dim=1) - u[:, 0]
        b = torch.linalg.vector_norm(u[:, k + 2:], dim=1) - u[:, k + 1]
        return torch.clamp_min(torch.maximum(a, b), 0.0)

    pres = torch.maximum(torch.linalg.vector_norm(rz, dim=1), outside(s)) / norm_h
    dres = torch.maximum(torch.linalg.vector_norm(rx, dim=1), outside(z)) / max(1.0, norm_c)
    m = s.shape[1]
    sz = s * z
    gap = sz.sum(1) - m * torch.finfo(torch.float64).eps * sz.abs().sum(1)
    pcost = t1 + rho * t2
    dcost = pcost + (z * rz).sum(1) - gap
    inf = torch.full_like(gap, math.inf)
    relgap = torch.where(pcost < 0, gap / -pcost,
                         torch.where(dcost > 0, gap / dcost, inf))
    return pres, dres, gap, relgap
