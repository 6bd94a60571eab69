"""One SOCP whose cone vector has millions of rows, on one device or with
the rows sharded over the ranks of a mesh: the port of
`socp_tpu/parallel/hugecone.py` (SURVEY.md section 5, the long-context
row).

    minimize c'x   s.t.  A x = b,  G x + s = h,   s in R+^l x Q^q1 x ... x Q^qN

with l + sum(q_i) = m huge and n, p and N modest.  As in the reference,
the m rows of G and every m-vector are split over the mesh's ranks while
x, y, the SOC heads and the condensed n x n system are replicated:

  * every m-vector is an `HV(orth, head, tail)`: the orthant part (l,),
    the head u0 of each SOC (N,) and the SOC tails (N, t_max), each tail
    zero-padded to the longest; every Jordan-algebra quantity (det, arrow
    product, NT point, max-step quadratic) is head-vector arithmetic plus
    a tail dot (`tdots` reduces several at once);
  * the condensed KKT is the tall-skinny Gram H = Ghat'Ghat of the scaled
    rows Ghat = W^-1 G (`torch.matmul`, cuBLAS on the card), factored in
    f64 by `kkt.dense._eq_chol` on a batch of one, so the routers of
    ops/chol.py send it to `chol_single` and each back-solve to
    `tri_pair_single`; p coupling equalities ride a (p, p) Schur
    complement S = A H^-1 A' with its own factor;
  * the reference's device reductions (`dd_allsum`, `pmin`, `lax.psum`)
    are parallel/collectives.py's `allsum` (gather, then the fixed-order
    sum: the same bits on every rank), `pmin` and `psum` over the mesh's
    group (`group` below), and the identity without a mesh.

Sharding (`mesh=`, N ranks): the orthant rows and each SOC's tail rows
are padded to a multiple of N, as the reference pads them
(hugecone.py:813-823): orthant pads are rows G = 0, h = 1 (strictly
feasible, so they only add N-1 or fewer coordinates of degree one), tail
pads are zero; rank r holds the r-th contiguous N-th of the orthant rows
and of every tail.  The replicated terms of the refinement norms are
divided by N before the sum over the ranks, so they count once.  Without
a mesh nothing is padded.

Precision: the reference runs every carry, Gram and factor in double-word
f32 (dd32) because the TPU has no fast f64; the card has native FP64, so
the port runs all of it in f64.  `factor_dtype` and `native_dd` have no
effect here, as in the reference, which never reads them.  f32 inputs
(`dtype=float32`) are rounded to f32 and then solved in f64: the
reference's dd carries are built from the rounded inputs.

One deliberate difference (ROADMAP.md, queue 3): the reference's
`max_step` drops the double root of a dim-1 SOC block when the rounded
discriminant lands just below 0 and returns inf, a step that leaves the
cone.  Here, as in cones/ops.max_step, a discriminant within 8 eps
(b^2 + 4|ac|) of 0 counts as 0.

Launches, at the default refine_steps = 1 without correctors: the W = I
initialization and every loop body each make 1 `chol_single` (H) and 4
`tri_pair_single` (two refined solves of one pair solve each) for p = 0,
or 2 and 13 for p > 0 (S's factor, H^-1 A' at k = p, and 3 pair solves a
back-solve); each Gondzio corrector adds one unrefined back-solve, 1 or 3.

The loop reads the device once a body, in `_fetch` (its `done` flag and
`k`, and the verbose row), which a test counts; on a mesh the flag is
already a replicated value, so the read needs no collective of its own.
Config is resolved by `api._resolve_config`: `gondzio_correctors=None` is
0, where the reference took 1 on a TPU.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from socp_tpu_torch.api import _put, _resolve_config, resolve_device, resolve_dtype
from socp_tpu_torch.config import DEFAULT_CONFIG, SolverConfig
from socp_tpu_torch.kkt.dense import EqChol, _eq_chol
from socp_tpu_torch.parallel import collectives as coll
from socp_tpu_torch.parallel.mesh import mesh_group, shard_index
from socp_tpu_torch.solution import Status


class HV(NamedTuple):
    """A member of R^l x Q^q1 x ... x Q^qN: orthant part, head vector and
    the (zero-padded) tail block."""

    orth: torch.Tensor   # (l,)
    head: torch.Tensor   # (N,)
    tail: torch.Tensor   # (N, t_max)


def _hmap(f, *vs: HV) -> HV:
    return HV(*(f(*parts) for parts in zip(*vs)))


def _col(x: torch.Tensor) -> torch.Tensor:
    return x[:, None]


# The functions below take `group`, the process group the rows are split
# over (None: one device, every reduction the identity).
def tdots(*pairs: tuple[HV, HV], group=None) -> list[torch.Tensor]:
    """Per-SOC tail dots u1'v1, each (N,), for several (u, v) pairs with
    one reduction: the partials are stacked, reduced, unstacked."""
    red = coll.allsum(torch.stack([torch.sum(u.tail * v.tail, dim=1)
                                   for u, v in pairs]), group)
    return list(red.unbind(0))


# ---- Jordan algebra on (head, tail) SOC blocks ------------------------
def soc_det(u: HV, utu: torch.Tensor) -> torch.Tensor:
    """det = u0^2 - ||u1||^2 given the reduced tail dot utu (N,)."""
    return u.head * u.head - utu


def jprod(u: HV, v: HV, utv: torch.Tensor) -> HV:
    return HV(u.orth * v.orth, u.head * v.head + utv,
              _col(u.head) * v.tail + _col(v.head) * u.tail)


def jdiv(lam: HV, d: HV, ltl: torch.Tensor, ltd: torch.Tensor) -> HV:
    """lam \\ d: the u with lam o u = d."""
    u0 = (lam.head * d.head - ltd) / soc_det(lam, ltl)
    return HV(d.orth / lam.orth, u0,
              (d.tail - _col(u0) * lam.tail) / _col(lam.head))


def lambda_min(u: HV, utu: torch.Tensor, group=None) -> torch.Tensor:
    """The least eigenvalue over all blocks (0-d)."""
    out = torch.amin(u.head - torch.sqrt(torch.clamp_min(utu, 0.0)))
    if u.orth.numel():
        out = torch.minimum(out, coll.pmin(torch.amin(u.orth), group))
    return out


def max_step(u: HV, du: HV, utu: torch.Tensor, dtd: torch.Tensor,
             utd: torch.Tensor, group=None) -> torch.Tensor:
    """sup{alpha >= 0 : u + alpha du in K} (0-d, inf if unbounded); tail
    dots pre-reduced.  SOC blocks: the smallest positive root of
    det(u + alpha du) = a alpha^2 + b alpha + c by the stable form
    2c / (-b + sqrt(D)), with a D within 8 eps (b^2 + 4|ac|) of 0 taken
    as 0 (module doc)."""
    eps = torch.finfo(u.head.dtype).eps
    a = soc_det(du, dtd)
    b = 2.0 * (u.head * du.head - utd)
    c = soc_det(u, utu)
    disc = b * b - 4.0 * a * c
    real = disc >= -8.0 * eps * (b * b + 4.0 * torch.abs(a * c))
    denom = -b + torch.sqrt(torch.clamp_min(disc, 0.0))
    valid = ((a < 0) | ((b < 0) & real)) & (denom > 0)
    safe = torch.where(denom > 0, denom, 1.0)
    out = torch.amin(torch.where(valid, 2.0 * c / safe, math.inf))
    if u.orth.numel():
        cand = torch.where(du.orth < 0, -(u.orth / du.orth), math.inf)
        out = torch.minimum(out, coll.pmin(torch.amin(cand), group))
    return out


# ---- NT scaling, head/tail form (SURVEY Appendix A) -------------------
class HScal(NamedTuple):
    w_orth: torch.Tensor     # (l,)
    eta: torch.Tensor        # (N,)
    v: HV                    # the NT point's square root (orth unused)
    lam: HV                  # W z


def nt_scale(s: HV, z: HV, group=None) -> HScal:
    w_orth = torch.sqrt(s.orth / z.orth)
    sts, ztz, stz = tdots((s, s), (z, z), (s, z), group=group)
    dets = soc_det(s, sts)
    detz = soc_det(z, ztz)
    rs = torch.sqrt(dets)
    rz = torch.sqrt(detz)
    # gamma^2 = (1 + zbar'sbar) / 2, zbar'sbar = (s0 z0 + s1'z1) / (rs rz)
    szb = (s.head * z.head + stz) / (rs * rz)
    tg = 2.0 * torch.sqrt((szb + 1.0) * 0.5)
    # wbar = (sbar + J zbar) / (2 gamma)
    wb_head = (s.head / rs + z.head / rz) / tg
    wb_tail = (s.tail / _col(rs) - z.tail / _col(rz)) / _col(tg)
    w0p = wb_head + 1.0
    vden = torch.sqrt(2.0 * w0p)
    v = HV(w_orth, w0p / vden, wb_tail / _col(vden))
    eta = torch.sqrt(torch.sqrt(dets / detz))
    # lam = W z = eta (2 v (v'z) - J z)
    (vtz,) = tdots((v, z), group=group)
    vz = v.head * z.head + vtz
    lam = HV(torch.sqrt(s.orth * z.orth),
             eta * (2.0 * v.head * vz - z.head),
             _col(eta) * (2.0 * v.tail * _col(vz) + z.tail))
    return HScal(w_orth=w_orth, eta=eta, v=v, lam=lam)


def apply_W(sc: HScal, u: HV, group=None) -> HV:
    (vtu,) = tdots((sc.v, u), group=group)
    vu = sc.v.head * u.head + vtu
    return HV(sc.w_orth * u.orth,
              sc.eta * (2.0 * sc.v.head * vu - u.head),
              _col(sc.eta) * (2.0 * sc.v.tail * _col(vu) + u.tail))


def apply_Winv(sc: HScal, u: HV, group=None) -> HV:
    # W^-1 = eta^-1 P(Jv): (Jv)'u = v0 u0 - v1'u1
    (vtu,) = tdots((sc.v, u), group=group)
    jvu = sc.v.head * u.head - vtu
    return HV(u.orth / sc.w_orth,
              (2.0 * sc.v.head * jvu - u.head) / sc.eta,
              (u.tail - 2.0 * sc.v.tail * _col(jvu)) / _col(sc.eta))


def _fetch(flags: torch.Tensor) -> list[float]:
    """The loop's one device-to-host transfer a body: [done, k] and, with
    verbose, the body's row."""
    return flags.cpu().tolist()


class _Factored(NamedTuple):
    L_H: EqChol
    L_S: Optional[EqChol]
    Gh_o: torch.Tensor       # (l, n)
    Gh_H: torch.Tensor       # (N, n)
    Gh_tf: torch.Tensor      # (N t_max, n): the scaled tail rows
    scaling: HScal


class _State(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    s: HV
    z: HV
    k: torch.Tensor          # () int32
    status: torch.Tensor     # () int32
    done: torch.Tensor       # () bool
    best_merit: torch.Tensor
    bx: torch.Tensor
    by: torch.Tensor
    bs: HV
    bz_: HV
    hist: torch.Tensor       # (max_iter, 6) with collect_history, else (0, 6)


def _core(cfg: SolverConfig, group, c, G_o, G_H, G_t, h_o, h_H, h_t, A, b):
    """The IPM on this rank's rows.  G_o: (l, n) orthant rows; G_H: (N, n)
    SOC head rows (replicated); G_t: (N, t_max, n) SOC tail rows; h
    likewise.  `group`: the process group the rows are split over (None:
    one device).  Returns (x, y, s.orth, s.head, s.tail, z.orth, z.head,
    z.tail, status, k, stats, hist) as tensors, the orthant and tail parts
    this rank's."""
    ndev = 1 if group is None else shard_index(group)[1]

    def allsum(v):
        return coll.allsum(v, group)

    def psum(v):
        return coll.psum(v, group)

    dots, lmin, mstep, nt, W, Winv = (
        functools.partial(f, group=group)
        for f in (tdots, lambda_min, max_step, nt_scale, apply_W, apply_Winv))

    n = c.shape[0]
    l = G_o.shape[0]
    n_soc, t_max = h_t.shape
    p = b.shape[0]
    dtype, device = c.dtype, c.device
    G_tf = G_t.reshape(n_soc * t_max, n)          # a view: the tail rows
    h = HV(h_o, h_H, h_t)

    def _sq(v):
        return torch.sum(v * v)

    def vdot(u: HV, v: HV) -> torch.Tensor:
        """Full inner product: one reduction + the replicated head dot."""
        loc = torch.sum(u.tail * v.tail)
        if l:
            loc = loc + torch.dot(u.orth, v.orth)
        return allsum(loc) + torch.dot(u.head, v.head)

    def vnorm(u: HV) -> torch.Tensor:
        return torch.sqrt(torch.clamp_min(vdot(u, u), 0.0))

    def vadd(u: HV, v: HV) -> HV:
        return _hmap(torch.add, u, v)

    def vsub(u: HV, v: HV) -> HV:
        return _hmap(torch.sub, u, v)

    def vneg(u: HV) -> HV:
        return _hmap(torch.neg, u)

    def axpy(u: HV, a, d: HV) -> HV:
        return _hmap(lambda x, y: x + a * y, u, d)

    def hwhere(mask, u: HV, v: HV) -> HV:
        return _hmap(lambda x, y: torch.where(mask, x, y), u, v)

    def ones(k):
        return torch.ones(k, dtype=dtype, device=device)

    e = HV(ones(l), ones(n_soc), h_t.new_zeros((n_soc, t_max)))
    zero_hv = HV(h_o.new_zeros(l), h_H.new_zeros(n_soc),
                 h_t.new_zeros((n_soc, t_max)))
    nu = float(ndev * l + n_soc)          # the orthant pads count

    # ---- G products ----------------------------------------------------
    def G_mv(x) -> HV:
        return HV(G_o @ x, G_H @ x, (G_tf @ x).view(n_soc, t_max))

    def GT_mv(u: HV):
        loc = G_tf.T @ u.tail.reshape(-1) + G_o.T @ u.orth
        return allsum(loc) + G_H.T @ u.head

    # ---- KKT: tall-skinny Gram, f64 Cholesky ----------------------------
    def scale_rows_Winv(sc: HScal):
        """Ghat = W^-1 G rowwise.  SOC rows need t = (Jv)'G per cone:
        v0 g0 - V1'G1, an (N, n) reduced tall matvec."""
        vtG = allsum(torch.bmm(sc.v.tail[:, None, :], G_t)[:, 0])
        t_vec = _col(sc.v.head) * G_H - vtG                     # (N, n)
        Gh_o = G_o / _col(sc.w_orth)
        Gh_H = (2.0 * _col(sc.v.head) * t_vec - G_H) / _col(sc.eta)
        Gh_t = torch.addcmul(G_t, sc.v.tail[:, :, None], t_vec[:, None, :],
                             value=-2.0)
        Gh_t.div_(sc.eta[:, None, None])                        # fresh tensor
        return Gh_o, Gh_H, Gh_t

    def factor(sc: HScal) -> _Factored:
        Gh_o, Gh_H, Gh_t = scale_rows_Winv(sc)
        Gh_tf = Gh_t.view(n_soc * t_max, n)
        H = torch.addmm(Gh_tf.T @ Gh_tf, Gh_o.T, Gh_o)          # local rows
        H = torch.addmm(allsum(H), Gh_H.T, Gh_H)               # replicated rows
        L_H = _eq_chol(H[None], cfg.delta_reg)
        L_S = None
        if p:
            HinvAT = L_H.solve(A.T[None])[0]                    # (n, p)
            L_S = _eq_chol((A @ HinvAT)[None], cfg.delta_reg)
        return _Factored(L_H=L_H, L_S=L_S, Gh_o=Gh_o, Gh_H=Gh_H, Gh_tf=Gh_tf,
                         scaling=sc)

    def Ghat_mv(f: _Factored, x) -> HV:
        return HV(f.Gh_o @ x, f.Gh_H @ x, (f.Gh_tf @ x).view(n_soc, t_max))

    def GhatT_mv(f: _Factored, u: HV):
        loc = f.Gh_tf.T @ u.tail.reshape(-1) + f.Gh_o.T @ u.orth
        return allsum(loc) + f.Gh_H.T @ u.head

    def kkt_solve_once(f: _Factored, bx, by, bz: HV):
        """Condensed solve + (p, p) Schur for the equalities."""
        bhz = Winv(f.scaling, bz)
        btx = bx + GhatT_mv(f, bhz)
        if p:
            t1 = f.L_H.solve(btx[None])[0]
            dy = f.L_S.solve((A @ t1 - by)[None])[0]
            dx = f.L_H.solve((btx - A.T @ dy)[None])[0]
        else:
            dy = by
            dx = f.L_H.solve(btx[None])[0]
        dz = Winv(f.scaling, vsub(Ghat_mv(f, dx), bhz))
        return dx, dy, dz

    def kkt_solve(f: _Factored, bx, by, bz: HV):
        """Solve + refinement on the 3x3 residual; returns the relative
        residual before the last correction as the stall signal (0
        without refinement)."""
        dx, dy, dz = kkt_solve_once(f, bx, by, bz)
        quality = c.new_zeros(())
        if cfg.refine_steps <= 0:
            return dx, dy, dz, quality

        def hnrm2(u: HV):
            """The rows' part of the squared norm: orthant + tails."""
            return _sq(u.orth) + _sq(u.tail)

        # replicated terms are divided by the rank count before the sum
        # over the ranks, so they count once in the global norm
        rhs_norm = torch.sqrt(
            psum(_sq(bx) / ndev + hnrm2(bz)) + _sq(bz.head) + _sq(by)) + 1.0
        for _ in range(cfg.refine_steps):
            rx = bx - GT_mv(dz)
            if p:
                rx = rx - A.T @ dy
                ry = by - A @ dx
            else:
                ry = by
            WWdz = W(f.scaling, W(f.scaling, dz))
            rz = vsub(bz, vsub(G_mv(dx), WWdz))
            quality = torch.sqrt(
                psum(_sq(rx) / ndev + hnrm2(rz)) + _sq(rz.head) + _sq(ry)
            ) / rhs_norm
            ex, ey, ez = kkt_solve_once(f, rx, ry, rz)
            dx, dy, dz = dx + ex, dy + ey, vadd(dz, ez)
        return dx, dy, dz, quality

    norm_b = torch.clamp_min(torch.linalg.vector_norm(b), 1.0)
    norm_h = torch.clamp_min(vnorm(h), 1.0)
    norm_c = torch.clamp_min(torch.linalg.vector_norm(c), 1.0)

    def residuals(x, y, s: HV, z: HV):
        rx = GT_mv(z) + c
        if p:
            rx = rx + A.T @ y
            ry = A @ x - b
        else:
            ry = b
        rz = vsub(vadd(G_mv(x), s), h)
        return rx, ry, rz

    # ---- init (W = I solves + interior shift) --------------------------
    f0 = factor(HScal(w_orth=ones(l), eta=ones(n_soc), v=e, lam=e))   # W = I
    x0, _, z0m, _ = kkt_solve(f0, c.new_zeros(n), b, h)
    shat = vneg(z0m)
    (shat_tt,) = dots((shat, shat))
    ap = -lmin(shat, shat_tt)
    s0 = hwhere(ap < 0, shat, axpy(shat, 1.0 + ap, e))
    _, y0, zhat, _ = kkt_solve(f0, -c, b.new_zeros(p), zero_hv)
    (zhat_tt,) = dots((zhat, zhat))
    ad = -lmin(zhat, zhat_tt)
    z0 = hwhere(ad < 0, zhat, axpy(zhat, 1.0 + ad, e))

    def metrics(x, y, s, z, rx, ry, rz):
        gap = vdot(s, z)
        pcost = torch.dot(c, x)
        dcost = pcost + vdot(z, rz) - gap
        if p:
            dcost = dcost + torch.dot(y, ry)
        relgap = torch.where(pcost < 0, gap / -pcost,
                             torch.where(dcost > 0, gap / dcost, math.inf))
        pres = vnorm(rz) / norm_h
        if p:
            pres = torch.maximum(torch.linalg.vector_norm(ry) / norm_b, pres)
        dres = torch.linalg.vector_norm(rx) / norm_c
        return gap, pcost, dcost, relgap, pres, dres

    def certificates(x, y, s, z, rx, ry, rz, feastol):
        """Approximate Farkas rays read off the residuals: A'y + G'z =
        rx - c, Ax = ry + b, Gx + s = rz + h."""
        hz_by = vdot(h, z)
        if p:
            hz_by = hz_by + torch.dot(y, b)
        pinf = (hz_by < 0) & (
            torch.linalg.vector_norm(rx - c) <= feastol * -hz_by)
        cx = torch.dot(c, x)
        dres_c = vnorm(vadd(rz, h))
        if p:
            dres_c = torch.maximum(torch.linalg.vector_norm(ry + b), dres_c)
        dinf = (cx < 0) & (dres_c <= feastol * -cx)
        return pinf, dinf

    def body(st: _State):
        """One iteration.  The loop runs it only on a state that is not
        done (the reference's while-loop condition), so the reference's
        `st.done` terms are dropped.  Returns the new state and the flags
        the loop reads ([done, k], and the verbose row)."""
        x, y, s, z = st.x, st.y, st.s, st.z
        rx, ry, rz = residuals(x, y, s, z)
        gap, pcost, dcost, relgap, pres, dres = metrics(x, y, s, z, rx, ry, rz)
        mu = gap / nu
        converged = ((pres <= cfg.feastol) & (dres <= cfg.feastol)
                     & ((gap <= cfg.abstol) | (relgap <= cfg.reltol)))

        merit = torch.maximum(torch.maximum(pres, dres),
                              torch.minimum(relgap, gap))
        better = merit < st.best_merit
        best_merit = torch.where(better, merit, st.best_merit)
        bx = torch.where(better, x, st.bx)
        by = torch.where(better, y, st.by)
        bs = hwhere(better, s, st.bs)
        bz_ = hwhere(better, z, st.bz_)

        pinf, dinf = certificates(x, y, s, z, rx, ry, rz, cfg.feastol)

        sc = nt(s, z)
        f = factor(sc)
        lam = sc.lam
        (ltl,) = dots((lam, lam))

        def newton(d_s: HV, ltd):
            dtil = jdiv(lam, d_s, ltl, ltd)
            rhs_z = vadd(vneg(rz), W(sc, dtil))
            dx, dy, dz, quality = kkt_solve(f, -rx, -ry, rhs_z)
            dz_sc = W(sc, dz)
            ds_sc = vneg(vadd(dtil, dz_sc))
            return dx, dy, dz, ds_sc, dz_sc, quality

        def step(ds_sc: HV, dz_sc: HV):
            """min(mstep(lam, ds_sc), mstep(lam, dz_sc))."""
            ds_ds, dz_dz, l_ds, l_dz = dots(
                (ds_sc, ds_sc), (dz_sc, dz_sc), (lam, ds_sc), (lam, dz_sc))
            return torch.minimum(mstep(lam, ds_sc, ltl, ds_ds, l_ds),
                                 mstep(lam, dz_sc, ltl, dz_dz, l_dz))

        lam2 = jprod(lam, lam, ltl)
        (ltl2,) = dots((lam, lam2))
        _, _, _, ds_sc_a, dz_sc_a, _ = newton(lam2, ltl2)
        alpha_a = torch.clamp_max(step(ds_sc_a, dz_sc_a), 1.0)
        gap_a = vdot(axpy(lam, alpha_a, ds_sc_a), axpy(lam, alpha_a, dz_sc_a))
        sigma = torch.clamp(gap_a / gap, 0.0, 1.0) ** 3

        (dsa_dza,) = dots((ds_sc_a, dz_sc_a))
        sm = sigma * mu
        cross = jprod(ds_sc_a, dz_sc_a, dsa_dza)
        d_s = HV(lam2.orth + cross.orth - sm, lam2.head + cross.head - sm,
                 lam2.tail + cross.tail)
        (ltd2,) = dots((lam, d_s))
        dx, dy, dz, ds_sc, dz_sc, quality = newton(d_s, ltd2)
        alpha = torch.clamp_max(cfg.step_frac * step(ds_sc, dz_sc), 1.0)

        # ---- Gondzio centrality correctors: each one unrefined back-solve
        # on the factor of this iteration
        for _ in range(cfg.gondzio_correctors or 0):
            mu_t = sigma * mu
            lo_b, hi_b = 0.1 * mu_t, 10.0 * mu_t
            a_hat = torch.clamp_max(alpha / cfg.step_frac + 0.1, 1.0)
            v_s = axpy(lam, a_hat, ds_sc)
            v_z = axpy(lam, a_hat, dz_sc)
            (vs_vz,) = dots((v_s, v_z))
            vprod = jprod(v_s, v_z, vs_vz)
            (vp_tt,) = dots((vprod, vprod))
            # the spectral clip delta (zero on in-band blocks)
            n1 = torch.sqrt(torch.clamp_min(vp_tt, 0.0))        # (N,)
            lp = vprod.head + n1
            lm = vprod.head - n1
            dp = torch.clamp(lp, lo_b, hi_b) - lp
            dm = torch.clamp(lm, lo_b, hi_b) - lm
            fcl = 0.5 * (dp - dm) / torch.where(n1 > 0, n1, 1.0)
            vo = vprod.orth
            tn = HV(vo - torch.clamp(vo, lo_b, hi_b), -0.5 * (dp + dm),
                    -(vprod.tail * _col(fcl)))
            (l_tn,) = dots((lam, tn))
            dtil_c = jdiv(lam, tn, ltl, l_tn)
            dxc, dyc, dzc = kkt_solve_once(
                f, torch.zeros_like(c), torch.zeros_like(b),
                W(sc, dtil_c))
            dz_sc_c = W(sc, dzc)
            ds_sc_c = vneg(vadd(dtil_c, dz_sc_c))
            c_ds = vadd(ds_sc, ds_sc_c)
            c_dz = vadd(dz_sc, dz_sc_c)
            alpha_c = torch.clamp_max(cfg.step_frac * step(c_ds, c_dz), 1.0)
            accept = alpha_c >= alpha + 0.01
            dx = torch.where(accept, dx + dxc, dx)
            dy = torch.where(accept, dy + dyc, dy)
            dz = hwhere(accept, vadd(dz, dzc), dz)
            ds_sc = hwhere(accept, c_ds, ds_sc)
            dz_sc = hwhere(accept, c_dz, dz_sc)
            alpha = torch.where(accept, alpha_c, alpha)

        ds = W(sc, ds_sc)

        step_finite = (
            torch.isfinite(alpha) & (alpha > 0)
            & torch.isfinite(_sq(dx))
            & torch.isfinite(vdot(ds, ds))
            & torch.isfinite(vdot(dz, dz)))
        stalled = quality > cfg.solve_quality_tol
        numerr = ~step_finite | ~torch.isfinite(gap) | stalled

        # priority: converged > primal cert > dual cert > numerical error
        status = torch.full_like(st.status, int(Status.RUNNING))
        for flag, code in ((numerr, Status.NUMERICAL_ERROR),
                           (dinf, Status.DUAL_INFEASIBLE),
                           (pinf, Status.PRIMAL_INFEASIBLE),
                           (converged, Status.OPTIMAL)):
            status = torch.where(flag, int(code), status)
        done = status != int(Status.RUNNING)

        def upd(old, d):
            return torch.where(done, old, old + alpha * d)

        hist = st.hist
        if cfg.collect_history:
            row = torch.stack([pcost, dcost, gap, pres, dres,
                               torch.where(done, 0.0, alpha)])
            hist = hist.index_copy(0, st.k.long().view(1), row[None])

        k = torch.where(done, st.k, st.k + 1)
        flags = [done.to(dtype), k.to(dtype)]
        if cfg.verbose:
            flags += [st.k.to(dtype), pcost, gap, pres, dres, alpha, quality]
        new = _State(
            x=upd(x, dx), y=upd(y, dy),
            s=_hmap(upd, s, ds), z=_hmap(upd, z, dz),
            k=k, status=status, done=done,
            best_merit=best_merit, bx=bx, by=by, bs=bs, bz_=bz_, hist=hist)
        return new, torch.stack(flags)

    n_hist = cfg.max_iter if cfg.collect_history else 0
    st = _State(x=x0, y=y0, s=s0, z=z0,
                k=torch.zeros((), dtype=torch.int32, device=device),
                status=torch.full((), int(Status.RUNNING), dtype=torch.int32,
                                  device=device),
                done=torch.zeros((), dtype=torch.bool, device=device),
                best_merit=c.new_full((), math.inf),
                bx=x0, by=y0, bs=s0, bz_=z0,
                hist=c.new_zeros((n_hist, 6)))

    # the reference's while-loop: a body runs while not done and k <
    # max_iter (k counts the bodies that stepped, so at most max_iter)
    for _ in range(cfg.max_iter):
        st, flags = body(st)
        read = _fetch(flags)
        if cfg.verbose:
            k, pc, g, pr, dr, a, q = read[2:]
            print(f"{int(k):3d} pcost={pc:+.6e} gap={g:.3e} pres={pr:.3e} "
                  f"dres={dr:.3e} step={a:.3f} kktres={q:.1e}", flush=True)
        if read[0]:
            break

    status = torch.where(st.done, st.status, int(Status.MAX_ITERATIONS))

    # ---- relaxed exit pass: best-iterate restore, "optimal, inaccurate"
    # acceptance, relaxed certificates ------------------------------------
    restore = ((status == int(Status.NUMERICAL_ERROR))
               | (status == int(Status.MAX_ITERATIONS)))
    rxf, ryf, rzf = residuals(st.x, st.y, st.s, st.z)
    pinf_f, dinf_f = certificates(st.x, st.y, st.s, st.z, rxf, ryf, rzf,
                                  cfg.feastol_inacc)
    pinf_exit = restore & pinf_f
    dinf_exit = restore & dinf_f

    x = torch.where(restore, st.bx, st.x)
    y = torch.where(restore, st.by, st.y)
    s = hwhere(restore, st.bs, st.s)
    z = hwhere(restore, st.bz_, st.z)

    rx, ry, rz = residuals(x, y, s, z)
    gap, pcost, dcost, relgap, pres, dres = metrics(x, y, s, z, rx, ry, rz)
    inacc_ok = ((pres <= cfg.feastol_inacc) & (dres <= cfg.feastol_inacc)
                & ((gap <= cfg.abstol_inacc) | (relgap <= cfg.reltol_inacc)))
    cert = ~inacc_ok & (pinf_exit | dinf_exit)
    x = torch.where(cert, st.x, x)
    y = torch.where(cert, st.y, y)
    s = hwhere(cert, st.s, s)
    z = hwhere(cert, st.z, z)
    status = torch.where(
        restore & inacc_ok, int(Status.OPTIMAL),
        torch.where(
            pinf_exit & ~inacc_ok, int(Status.PRIMAL_INFEASIBLE),
            torch.where(dinf_exit & ~inacc_ok & ~pinf_exit,
                        int(Status.DUAL_INFEASIBLE), status))).to(torch.int32)
    inaccurate = restore & inacc_ok
    stats = torch.stack([pcost, dcost, gap, relgap, pres, dres,
                         inaccurate.to(dtype)])
    return (x, y, *s, *z, status, st.k, stats, st.hist)


def _split(a: np.ndarray, l: int, qs: tuple[int, ...], t_max: int,
           l_pad: int | None = None, orth_pad: float = 0.0):
    """Flat rows (m, ...) in cone order -> the orthant rows (l_pad, ...;
    rows past l filled with `orth_pad`), the SOC heads (N, ...) and the
    SOC tails (N, t_max, ...), zero-padded."""
    rest = a.shape[1:]
    head = np.zeros((len(qs),) + rest)
    tail = np.zeros((len(qs), t_max) + rest)
    off = l
    for i, q in enumerate(qs):
        head[i] = a[off]
        tail[i, : q - 1] = a[off + 1 : off + q]
        off += q
    orth = np.asarray(a[:l], np.float64)
    if l_pad is not None and l_pad > l:
        orth = np.concatenate([orth, np.full((l_pad - l,) + rest, orth_pad)])
    return orth, head, tail


def _gather(o, hd, tl, l: int, qs: tuple[int, ...]) -> np.ndarray:
    """The inverse of `_split` for a vector: full length, cone order."""
    pieces = [np.asarray(o, np.float64)[:l]]
    for i, q in enumerate(qs):
        pieces.append(np.asarray(hd, np.float64)[i : i + 1])
        pieces.append(np.asarray(tl, np.float64)[i, : q - 1])
    return np.concatenate(pieces)


def prepare_huge(
    c: np.ndarray,            # (n,)
    G: np.ndarray,            # (m, n): orthant rows, then SOC blocks in order
    h: np.ndarray,            # (m,)
    l: int,
    qs: tuple[int, ...],
    A: Optional[np.ndarray] = None,   # (p, n) coupling equalities
    b: Optional[np.ndarray] = None,
    config: SolverConfig = DEFAULT_CONFIG,
    device=None,
    dtype=None,
    mesh=None,
):
    """Device-resident preparation for the huge-cone solve: splits the
    problem into the head/tail layout, places it on the device ONCE, and
    returns `(fn, args, assemble)` where `fn(*args)` runs the IPM and
    `assemble(out)` builds the host result tuple, so repeat solves reuse
    the upload of G.  `mesh`: split the rows over the ranks of a 1-D mesh
    (module doc); every rank passes the whole problem, places only its
    rows, and gets the whole result from `assemble`.  `device=None` means
    "cuda" (it raises where CUDA is absent); `device="cpu"` runs the
    kernels' plain versions.  `dtype` takes None or any spelling of f64,
    or of f32: f32 inputs are rounded to f32 and then solved in f64, as
    the reference's `to_dd` builds its carries from the rounded inputs
    (socp_tpu/parallel/hugecone.py:93-94)."""
    dev = resolve_device(device)
    inputs = resolve_dtype(dtype)
    config = _resolve_config(config)
    qs = tuple(int(q) for q in qs)
    m, n = np.shape(G)
    if len(qs) < 1:
        raise ValueError("need at least one SOC block")
    if l + sum(qs) != m:
        raise ValueError(f"l + sum(qs) = {l + sum(qs)} != m = {m}")
    if not all(q >= 1 for q in qs):
        raise ValueError(f"every SOC needs q >= 1, got {qs}")
    A_h = np.zeros((0, n)) if A is None else np.asarray(A, np.float64)
    b_h = np.zeros((0,)) if b is None else np.asarray(b, np.float64)

    group = None if mesh is None else mesh_group(mesh)
    r, ndev = (0, 1) if group is None else shard_index(group)

    def padded(k):
        return max(-(-k // ndev) * ndev, ndev)

    l_pad = padded(l) if l else 0
    t_max = padded(max(q - 1 for q in qs))
    G = np.asarray(G, np.float64)
    G_o, G_H, G_t = _split(G, l, qs, t_max, l_pad)
    # padding orthant rows with h = 1 > 0 keeps them strictly feasible
    h_o, h_H, h_t = _split(np.asarray(h, np.float64), l, qs, t_max, l_pad, 1.0)
    lo, to = l_pad // ndev, t_max // ndev          # this rank's rows
    args = tuple(_put(a, dev, inputs, torch.float64) for a in
                 (c, G_o[r * lo:(r + 1) * lo], G_H,
                  G_t[:, r * to:(r + 1) * to], h_o[r * lo:(r + 1) * lo], h_H,
                  h_t[:, r * to:(r + 1) * to], A_h, b_h))

    def fn(*dev_args):
        return _core(config, group, *dev_args)

    def whole(t, dim):
        """Every rank's part of an orthant (dim 0) or tail (dim 1) block."""
        return torch.cat(list(coll.all_gather(t, group).unbind(0)), dim=dim)

    def assemble(raw):
        if group is not None:
            raw = list(raw)
            for i, dim in ((2, 0), (4, 1), (5, 0), (7, 1)):
                raw[i] = whole(raw[i], dim)
        (x, y, s_o, s_H, s_t, z_o, z_H, z_t, status, k, stats, hist) = (
            t.cpu().numpy() for t in raw)
        out = (x, y, _gather(s_o, s_H, s_t, l, qs),
               _gather(z_o, z_H, z_t, l, qs),
               Status(int(status)), int(k), stats)
        if config.collect_history:
            out = out + (hist[: int(k)],)
        return out

    return fn, args, assemble


def solve_huge(
    c: np.ndarray,
    G: np.ndarray,
    h: np.ndarray,
    l: int,
    qs: tuple[int, ...],
    A: Optional[np.ndarray] = None,
    b: Optional[np.ndarray] = None,
    config: SolverConfig = DEFAULT_CONFIG,
    device=None,
    dtype=None,
    mesh=None,
):
    """Solve min c'x s.t. Ax = b, Gx + s = h, s in R+^l x Q^q1 x ... on
    one device or with the rows split over the ranks of `mesh` (sum(qs)
    may be millions).

    Returns (x, y, s, z, status, iterations, stats) with stats in the
    port's layout [pcost, dcost, gap, relgap, pres, dres,
    inaccurate_flag]; s, z full-length in cone order.  With
    config.collect_history the per-iteration table (k x 6: pcost, dcost,
    gap, pres, dres, step) is appended."""
    fn, args, assemble = prepare_huge(c, G, h, l, qs, A=A, b=b, config=config,
                                      device=device, dtype=dtype, mesh=mesh)
    return assemble(fn(*args))


def solve_huge_soc(
    c: np.ndarray,            # (n,)
    G: np.ndarray,            # (l + q, n): orthant rows then ONE SOC block
    h: np.ndarray,            # (l + q,)
    l: int,
    config: SolverConfig = DEFAULT_CONFIG,
    device=None,
    dtype=None,
    mesh=None,
):
    """Single-SOC wrapper.  Returns (x, s, z, status, iterations,
    stats=[pcost, gap, pres, dres]), the reference's historical 4-stat
    layout; `solve_huge` has the full one."""
    q = np.shape(G)[0] - l
    out = solve_huge(c, G, h, l, (q,), config=config, device=device,
                     dtype=dtype, mesh=mesh)
    x, y, s, z, status, k, stats = out[:7]
    return (x, s, z, status, k,
            np.asarray([stats[0], stats[2], stats[4], stats[5]]))
