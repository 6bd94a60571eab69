"""A plain batched conic interior-point method in PyTorch, the benchmark's
reference solver.

It solves B problems of one shape at once:

    minimize    (1/2) x'Px + c'x
    subject to  Ax = b,  Gx + s = h,  s in K = R+^l x Q^{q_1} x ... x Q^{q_N}

by a primal-dual path-following method with Nesterov-Todd scaling and
Mehrotra's predictor-corrector (Vandenberghe, "The CVXOPT linear and
quadratic cone program solvers", 2010, sections 4-6).  Each Newton system
is reduced to H = P + G'W^-2 G and the Schur complement A H^-1 A', both
factored by `torch.linalg.cholesky`.  It is written from those equations,
in the user's cone order with no padding, and imports nothing of the
program under test: it is what the program's answers are compared with.

A lane that meets the tolerances stops moving; the loop ends when every
lane has, or after `max_iter` iterations.  The tolerances are tighter
than the program's (1e-8), so the reference's own error is small beside
the differences the comparison looks for.
"""

from __future__ import annotations

import torch


class Cone:
    """K = R+^l x Q^{qs[0]} x ... in the user's flat order."""

    def __init__(self, l: int, qs):
        self.l = int(l)
        self.qs = tuple(int(q) for q in qs)
        starts, off = [], self.l
        for q in self.qs:
            starts.append(off)
            off += q
        self.starts = tuple(starts)
        self.m = off
        self.degree = self.l + len(self.qs)

    def blocks(self, v):
        """The SOC blocks of (B, m) v, as (head (B,), tail (B, q-1)) pairs."""
        return [(v[:, o], v[:, o + 1:o + q]) for o, q in zip(self.starts, self.qs)]

    def join(self, orth, socs):
        """(B, l) and a list of (head, tail) back to (B, m)."""
        parts = [orth] + [torch.cat([h0[:, None], t], dim=1) for h0, t in socs]
        return torch.cat(parts, dim=1)

    def identity(self, B, dtype, device):
        e = torch.zeros(B, self.m, dtype=dtype, device=device)
        e[:, :self.l] = 1.0
        for o in self.starts:
            e[:, o] = 1.0
        return e

    def prod(self, u, v):
        """Jordan product u o v."""
        orth = u[:, :self.l] * v[:, :self.l]
        socs = [((u0 * v0) + (u1 * v1).sum(1), u0[:, None] * v1 + v0[:, None] * u1)
                for (u0, u1), (v0, v1) in zip(self.blocks(u), self.blocks(v))]
        return self.join(orth, socs)

    def div(self, lam, r):
        """u with lam o u = r."""
        orth = r[:, :self.l] / lam[:, :self.l]
        socs = []
        for (l0, l1), (r0, r1) in zip(self.blocks(lam), self.blocks(r)):
            det = l0 * l0 - (l1 * l1).sum(1)
            u0 = (l0 * r0 - (l1 * r1).sum(1)) / det
            socs.append((u0, (r1 - u0[:, None] * l1) / l0[:, None]))
        return self.join(orth, socs)

    def min_eig(self, u):
        """The least eigenvalue of u in K, per lane."""
        vals = [u[:, :self.l].min(1).values] if self.l else []
        vals += [u0 - torch.linalg.vector_norm(u1, dim=1) for u0, u1 in self.blocks(u)]
        return torch.stack(vals, 1).min(1).values

    def max_step(self, u, d):
        """The largest a >= 0 with u + a d in K (inf if none), u in int K."""
        inf = torch.full_like(u[:, 0], torch.inf)
        steps = []
        if self.l:
            uo, do = u[:, :self.l], d[:, :self.l]
            steps.append(torch.where(do < 0, -uo / do, inf[:, None]).min(1).values)
        for (u0, u1), (d0, d1) in zip(self.blocks(u), self.blocks(d)):
            # det(u + a d) = qa a^2 + 2 qb a + qc, qc > 0
            qa = d0 * d0 - (d1 * d1).sum(1)
            qb = u0 * d0 - (u1 * d1).sum(1)
            qc = u0 * u0 - (u1 * u1).sum(1)
            # a discriminant within rounding of 0 is a double root; one
            # below that means the ray never meets the boundary
            disc = qb * qb - qa * qc
            eps = torch.finfo(u.dtype).eps
            real = disc >= -8 * eps * (qb * qb + (qa * qc).abs())
            root = torch.sqrt(torch.clamp_min(disc, 0.0))
            # the two roots, written without cancellation
            t = -(qb + torch.where(qb >= 0, root, -root))
            r1 = torch.where(qa != 0, t / qa, inf)
            r2 = torch.where(t != 0, qc / t, inf)
            pos = torch.stack([torch.where(r1 > 0, r1, inf),
                               torch.where(r2 > 0, r2, inf)], 1).min(1).values
            pos = torch.where(real, pos, inf)
            # the head must stay positive too (the ray may leave through -K)
            head = torch.where(d0 < 0, -u0 / d0, inf)
            steps.append(torch.minimum(pos, head))
        return torch.stack(steps, 1).min(1).values


class Scaling:
    """Nesterov-Todd scaling W of (s, z): W z = W^-1 s = lam.  W is
    diag(sqrt(s / z)) on the orthant and eta W_bar on a SOC, W_bar the
    symmetric matrix of the unit-J-norm vector w (CVXOPT section 4.1),
    whose inverse is J W_bar J."""

    def __init__(self, cone: Cone, s, z):
        self.cone = cone
        self.d = torch.sqrt(s[:, :cone.l] / z[:, :cone.l])
        self.soc = []
        for (s0, s1), (z0, z1) in zip(cone.blocks(s), cone.blocks(z)):
            sn = torch.sqrt(s0 * s0 - (s1 * s1).sum(1))
            zn = torch.sqrt(z0 * z0 - (z1 * z1).sum(1))
            eta = torch.sqrt(sn / zn)
            bs0, bs1 = s0 / sn, s1 / sn[:, None]
            bz0, bz1 = z0 / zn, z1 / zn[:, None]
            gamma = torch.sqrt((1.0 + bs0 * bz0 + (bs1 * bz1).sum(1)) / 2.0)
            w0 = (bs0 + bz0) / (2.0 * gamma)
            w1 = (bs1 - bz1) / (2.0 * gamma)[:, None]
            self.soc.append((eta, w0, w1))
        self.lam = self.apply(z)

    def _soc(self, v0, v1, eta, w0, w1, inverse):
        # W_bar v = (w0 v0 + w1'v1, v1 + (v0 + w1'v1 / (1 + w0)) w1); the
        # inverse flips the sign of w1
        if inverse:
            w1 = -w1
        wv = (w1 * v1).sum(1)
        out0 = w0 * v0 + wv
        out1 = v1 + (v0 + wv / (1.0 + w0))[:, None] * w1
        f = 1.0 / eta if inverse else eta
        return f * out0, f[:, None] * out1

    def apply(self, v, inverse=False):
        """W v, or W^-1 v."""
        cone = self.cone
        orth = v[:, :cone.l] / self.d if inverse else v[:, :cone.l] * self.d
        socs = [self._soc(v0, v1, *p, inverse)
                for (v0, v1), p in zip(cone.blocks(v), self.soc)]
        return cone.join(orth, socs)

    def apply_rows(self, M, inverse=False):
        """W (or W^-1) applied to each column of (B, m, n) M."""
        B, m, n = M.shape
        cols = M.transpose(1, 2).reshape(B * n, m)
        rep = Scaling.__new__(Scaling)
        rep.cone = self.cone
        rep.d = self.d.repeat_interleave(n, 0)
        rep.soc = [tuple(t.repeat_interleave(n, 0) for t in p) for p in self.soc]
        return rep.apply(cols, inverse).reshape(B, n, m).transpose(1, 2)


def _mv(M, v):
    return torch.bmm(M, v[:, :, None])[:, :, 0]


def _mtv(M, v):
    return torch.bmm(M.transpose(1, 2), v[:, :, None])[:, :, 0]


def _dot(u, v):
    return (u * v).sum(1)


def _norm(v):
    return torch.linalg.vector_norm(v, dim=1) if v.shape[1] else v.new_zeros(v.shape[0])


class _KKT:
    """The reduced Newton system of one scaling: H = P + (W^-1 G)'(W^-1 G)
    and S = A H^-1 A', factored once and used for several right-hand
    sides."""

    def __init__(self, P, G, A, W: Scaling | None):
        Gh = G if W is None else W.apply_rows(G, inverse=True)
        H = Gh.transpose(1, 2) @ Gh
        if P is not None:
            H = H + P
        self.LH, info = torch.linalg.cholesky_ex(H)
        self.failed = info != 0          # lanes whose factor broke down
        self.A, self.G, self.W = A, G, W
        if A.shape[1]:
            HiAt = torch.cholesky_solve(A.transpose(1, 2), self.LH)
            self.LS, info = torch.linalg.cholesky_ex(A @ HiAt)
            self.failed |= info != 0

    def solve(self, bx, by, bz):
        """(dx, dy, dz) with P dx + A'dy + G'dz = bx, A dx = by,
        G dx - W'W dz = bz."""
        # dz = W^-2 (G dx - bz): the x rows become H dx + A'dy = rhs
        Wz = bz if self.W is None else self.W.apply(self.W.apply(bz, True), True)
        rhs = bx + _mtv(self.G, Wz)
        Hr = torch.cholesky_solve(rhs[:, :, None], self.LH)[:, :, 0]
        if self.A.shape[1]:
            dy = torch.cholesky_solve((_mv(self.A, Hr) - by)[:, :, None],
                                      self.LS)[:, :, 0]
            dx = Hr - torch.cholesky_solve(_mtv(self.A, dy)[:, :, None],
                                           self.LH)[:, :, 0]
        else:
            dy = by.new_zeros(by.shape)
            dx = Hr
        r = _mv(self.G, dx) - bz
        dz = r if self.W is None else self.W.apply(self.W.apply(r, True), True)
        return dx, dy, dz


def solve(c, G, h, cone: Cone, A=None, b=None, P=None, tol=1e-11,
          max_iter=60, step_frac=0.99):
    """Solve the batch; all tensors of one dtype and device, c (B, n), G
    (B, m, n), h (B, m), A (B, p, n) and b (B, p) or None, P (B, n, n) or
    None.  Returns (x, y, s, z, converged (B,) bool, iterations)."""
    B, n = c.shape
    if A is None:
        A = c.new_zeros((B, 0, n))
        b = c.new_zeros((B, 0))
    e = cone.identity(B, c.dtype, c.device)
    nu = float(cone.degree)

    # start: the least-squares points of CVXOPT section 5.3, moved into K
    kkt0 = _KKT(P, G, A, None)
    x, _, z0 = kkt0.solve(torch.zeros_like(c), b, h)
    s = -z0
    shift = cone.min_eig(s)
    s = torch.where((shift <= 0)[:, None], s + (1.0 - shift)[:, None] * e, s)
    _, y, z = kkt0.solve(-c, torch.zeros_like(b), torch.zeros_like(h))
    shift = cone.min_eig(z)
    z = torch.where((shift <= 0)[:, None], z + (1.0 - shift)[:, None] * e, z)

    norm_c = torch.clamp_min(_norm(c), 1.0)
    norm_h = torch.clamp_min(_norm(h), 1.0)
    norm_b = torch.clamp_min(_norm(b), 1.0)
    done = torch.zeros(B, dtype=torch.bool, device=c.device)
    it = 0
    for it in range(max_iter):
        Px = _mv(P, x) if P is not None else torch.zeros_like(x)
        rx = Px + _mtv(A, y) + _mtv(G, z) + c
        ry = _mv(A, x) - b
        rz = _mv(G, x) + s - h
        gap = _dot(s, z)
        pcost = _dot(c, x) + 0.5 * _dot(x, Px)
        pres = torch.maximum(_norm(ry) / norm_b, _norm(rz) / norm_h)
        dres = _norm(rx) / norm_c
        conv = ((pres <= tol) & (dres <= tol)
                & (gap <= tol * torch.clamp_min(pcost.abs(), 1.0)))
        done = done | conv
        if bool(done.all()):
            break
        W = Scaling(cone, s, z)
        lam = W.lam
        kkt = _KKT(P, G, A, W)
        mu = gap / nu

        def newton(rc):
            # lam o (W dz + W^-1 ds) = rc:  ds = W (lam \ rc) - W'W dz
            t = cone.div(lam, rc)
            dx, dy, dz = kkt.solve(-rx, -ry, -rz - W.apply(t))
            dzs = W.apply(dz)
            return dx, dy, dz, t - dzs, dzs

        lam2 = cone.prod(lam, lam)
        _, _, _, dsa, dza = newton(-lam2)
        aa = torch.clamp_max(torch.minimum(cone.max_step(lam, dsa),
                                           cone.max_step(lam, dza)), 1.0)
        sigma = (_dot(lam + aa[:, None] * dsa, lam + aa[:, None] * dza)
                 / _dot(lam, lam)).clamp(0.0, 1.0) ** 3
        rc = -lam2 - cone.prod(dsa, dza) + (sigma * mu)[:, None] * e
        dx, dy, dz, dss, dzs = newton(rc)
        a = torch.clamp_max(step_frac * torch.minimum(cone.max_step(lam, dss),
                                                      cone.max_step(lam, dzs)), 1.0)
        ok = (~done & ~kkt.failed & torch.isfinite(a)
              & torch.isfinite(_dot(dx, dx)))
        a = torch.where(ok, a, torch.zeros_like(a))
        a = torch.nan_to_num(a)[:, None]
        ds = W.apply(dss)
        x = x + a * torch.nan_to_num(dx)
        y = y + a * torch.nan_to_num(dy)
        z = z + a * torch.nan_to_num(dz)
        s = s + a * torch.nan_to_num(ds)
    return x, y, s, z, done, it
