"""Plain consensus ADMM over scenario SOCPs: the benchmark's reference for
the stochastic-portfolio configuration.

Scaled-form consensus ADMM with over-relaxation and residual balancing
(Boyd, Parikh, Chu, Peleato and Eckstein, "Distributed Optimization and
Statistical Learning via the Alternating Direction Method of Multipliers",
2011, sections 3.4.1, 3.4.3 and 7.1), from a fresh start (w_bar = 0,
u = 0):

    x_i   = argmin f_i(x) + (rho/2) ||E x - w_bar + u_i||^2
    xh_i  = alpha E x_i + (1 - alpha) w_bar
    w_bar = mean_i (xh_i + u_i)
    u_i   = u_i + xh_i - w_bar
    pres  = sqrt(mean_i ||E x_i - w_bar||^2),  dres = rho ||w_bar - w_bar_old||

and, unless both residuals are within `tol`, rho doubles (u halves) when
pres > 10 dres, or halves (u doubles) when dres > 10 pres.  Each round's
scenario problems are solved together by the plain interior-point method
of `conic.py`, each to 1e-11, in f64.
"""

from __future__ import annotations

import torch

from benchmark.reference import conic


def admm(c, G, h, l, qs, n_consensus, A, b, rho=1.0, rounds=10, tol=1e-5,
         alpha=1.6, dtype=torch.float64, device="cpu"):
    """c (S, n), G (S, m, n), h (S, m) numpy; A (p, n), b (p,) shared.
    Returns a dict of numpy arrays and floats: w_bar, x (S, n) of the
    last round, objective, pres, dres, rho, rounds, `unsolved`, the
    scenario solves (over every round) that did not reach 1e-11, and the
    last round's subproblems: their linear terms `c_last` (S, n) and
    penalty `rho_last` (the quadratic term is (rho_last / 2) ||E x||^2)."""
    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    cT, GT, hT = t(c), t(G), t(h)
    S, n = cT.shape
    nc = n_consensus
    cone = conic.Cone(l, qs)
    AT = t(A).expand(S, *A.shape)
    bT = t(b).expand(S, *b.shape)
    E = torch.zeros(n, dtype=dtype, device=device)
    E[:nc] = 1.0
    w_bar = torch.zeros(nc, dtype=dtype, device=device)
    u = torch.zeros(S, nc, dtype=dtype, device=device)
    pres = dres = float("inf")
    unsolved = 0
    x = None
    done_rounds = 0
    for _ in range(rounds):
        done_rounds += 1
        shift = torch.zeros(S, n, dtype=dtype, device=device)
        shift[:, :nc] = rho * (u - w_bar)
        P = (rho * torch.diag(E)).expand(S, n, n)
        c_last, rho_last = cT + shift, rho
        x, _, _, _, conv, _ = conic.solve(c_last, GT, hT, cone, AT, bT, P)
        unsolved += int((~conv).sum())
        xc = x[:, :nc]
        xh = alpha * xc + (1.0 - alpha) * w_bar
        w_new = (xh + u).mean(0)
        u = u + xh - w_new
        pres = float(torch.sqrt(((xc - w_new) ** 2).sum(1).mean()))
        dres = float(rho * torch.linalg.vector_norm(w_new - w_bar))
        w_bar = w_new
        converged = pres <= tol and dres <= tol
        if converged:
            break
        if pres > 10.0 * dres:
            rho *= 2.0
            u = u * 0.5
        elif dres > 10.0 * pres:
            rho *= 0.5
            u = u * 2.0
    x_cons = x.clone()
    x_cons[:, :nc] = w_bar
    objective = float((cT * x_cons).sum(1).mean())
    return {"w_bar": w_bar.cpu().double().numpy(), "x": x.cpu().double().numpy(),
            "objective": objective, "pres": pres, "dres": dres, "rho": rho,
            "rounds": done_rounds, "unsolved": unsolved,
            "c_last": c_last.cpu().double().numpy(), "rho_last": rho_last}


def subproblem_value(c_last, rho_last, x, n_consensus):
    """Each scenario's last-round subproblem objective at x (S, n):
    c_last_i'x_i + (rho_last / 2) ||E x_i||^2."""
    import numpy as np

    x = np.asarray(x, np.float64)
    xc = x[:, :n_consensus]
    return np.einsum("sn,sn->s", c_last, x) + 0.5 * rho_last * np.einsum(
        "sn,sn->s", xc, xc)


def infeasibility(G, h, l, qs, A, b, x):
    """Each scenario's constraint violation at x (S, n), from the data
    alone: how far h - G x lies outside R+^l x Q^qs (the orthant's most
    negative entry, and each SOC's tail norm over its head) and the
    largest |A x - b|; (S,), in f64."""
    import numpy as np

    x = np.asarray(x, np.float64)
    r = h - np.einsum("smn,sn->sm", G, x)
    out = np.maximum(0.0, -r[:, :l].min(axis=1)) if l else np.zeros(len(x))
    off = l
    for q in qs:
        head, tail = r[:, off], r[:, off + 1:off + q]
        out = np.maximum(out, np.linalg.norm(tail, axis=1) - head)
        off += q
    if len(b):
        A = np.asarray(A, np.float64)
        Ax = np.einsum("pn,sn->sp", A, x) if A.ndim == 2 else np.einsum(
            "spn,sn->sp", A, x)
        out = np.maximum(out, np.abs(Ax - b).max(axis=1))
    return out


def residual_relations(x, w_bar, pres, dres, rho, n_consensus, alpha=1.6,
                       tol=1e-5):
    """Two relations that the answer of every run of the iteration above
    satisfies exactly, whatever its inner solves, read off the answer
    alone: (pres, dres) recomputed in f64 from the last round's x and
    w_bar.

      pres = sqrt(mean_i ||E x_i - w_bar||^2), by its definition;
      dres = rho alpha / |1 - alpha| ||mean_i E x_i - w_bar||,

    the second because mean_i u_i = 0 after every round (the dual update
    subtracts the new mean; a change of rho scales u), so the last
    consensus step is w_bar = alpha mean_i E x_i + (1 - alpha) w_old and
    w_bar - w_old = alpha (mean_i E x_i - w_bar) / (1 - alpha).  rho is the
    penalty of the last round, before that round's adaptation, which the
    reported residuals decide.  Returns the two relative gaps between the
    reported residuals and the recomputed ones."""
    import numpy as np

    xc = np.asarray(x, np.float64)[:, :n_consensus]
    w = np.asarray(w_bar, np.float64)
    converged = pres <= tol and dres <= tol
    rho_last = rho
    if not converged and pres > 10.0 * dres:
        rho_last = rho / 2.0
    elif not converged and dres > 10.0 * pres:
        rho_last = rho * 2.0
    p = float(np.sqrt(np.mean(np.sum((xc - w) ** 2, axis=1))))
    d = rho_last * alpha / abs(1.0 - alpha) * float(
        np.linalg.norm(xc.mean(axis=0) - w))
    return abs(pres - p) / p, abs(dres - d) / d
