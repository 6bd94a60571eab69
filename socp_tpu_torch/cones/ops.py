"""Cone kernels (Jordan algebra) on the padded flat layout, over a leading
batch dim — the port of `socp_tpu/cones/ops.py`.

Every function takes the static `ConeLayout` plus padded flat vectors of
shape `(B, layout.m_pad)`; an SOC bucket is the view
`u[:, off:off+size].view(B, n_blocks, q_pad)`.  Per-instance reductions
(`lambda_min`, `max_step`) return `(B,)`.  Zero tail-padding is exact and
preserved by every op (see layout.py).

Every function is dtype-generic: it computes in its inputs' dtype (f64, or
f32 for the reference's f32-carries mode), with Python scalars that never
promote; the solvers pass their carry dtype to `identity` and
`identity_scaling`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from socp_tpu_torch.cones.layout import ConeLayout


def _orth(layout: ConeLayout, u: torch.Tensor) -> torch.Tensor:
    return u[:, : layout.l]


def _views(layout: ConeLayout, u: torch.Tensor):
    """Bucket views [(B, n_blocks, q_pad), ...] of a padded flat batch."""
    B = u.shape[0]
    return [
        u[:, b.offset : b.offset + b.size].view(B, b.n_blocks, b.q_pad)
        for b in layout.buckets
    ]


def _flat(pieces) -> torch.Tensor:
    return torch.cat([p.flatten(1) for p in pieces], dim=1)


def _J(ub: torch.Tensor) -> torch.Tensor:
    """Reflection J = diag(1, -1, ..., -1) on the last axis."""
    return torch.cat([ub[..., :1], -ub[..., 1:]], dim=-1)


def _jdet(ub: torch.Tensor) -> torch.Tensor:
    """Jordan determinant u0^2 - ||u1||^2 per block."""
    return 2.0 * ub[..., 0] ** 2 - torch.sum(ub * ub, dim=-1)


def identity(layout: ConeLayout, batch: int, dtype=torch.float64,
             device=None) -> torch.Tensor:
    """The cone identity e in `dtype`: the solvers pass their carry
    dtype."""
    pieces = [torch.ones((batch, layout.l), dtype=dtype, device=device)]
    for b in layout.buckets:
        e = torch.zeros((batch, b.n_blocks, b.q_pad), dtype=dtype,
                        device=device)
        e[..., 0] = 1.0
        pieces.append(e)
    return _flat(pieces)


def jprod(layout: ConeLayout, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Jordan product u o v."""
    pieces = [_orth(layout, u) * _orth(layout, v)]
    for ub, vb in zip(_views(layout, u), _views(layout, v)):
        dot = torch.sum(ub * vb, dim=-1, keepdim=True)      # u'v per block
        rest = (ub[..., :1] * vb + vb[..., :1] * ub)[..., 1:]
        pieces.append(torch.cat([dot, rest], dim=-1))
    return _flat(pieces)


def jdiv(layout: ConeLayout, lam: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Solve lam o u = d for u (lam interior)."""
    pieces = [_orth(layout, d) / _orth(layout, lam)]
    for lb, db in zip(_views(layout, lam), _views(layout, d)):
        det = _jdet(lb)
        l0 = lb[..., 0]
        l1d1 = torch.sum(lb * db, dim=-1) - l0 * db[..., 0]
        u0 = (l0 * db[..., 0] - l1d1) / det
        u1 = (db[..., 1:] - u0[..., None] * lb[..., 1:]) / l0[..., None]
        pieces.append(torch.cat([u0[..., None], u1], dim=-1))
    return _flat(pieces)


def _soc_n1(ub: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(
        torch.clamp_min(torch.sum(ub * ub, dim=-1) - ub[..., 0] ** 2, 0.0)
    )


def lambda_min(layout: ConeLayout, u: torch.Tensor) -> torch.Tensor:
    """Smallest Jordan eigenvalue per instance: (B,)."""
    vals = []
    if layout.l:
        vals.append(torch.amin(_orth(layout, u), dim=1))
    for ub in _views(layout, u):
        vals.append(torch.amin(ub[..., 0] - _soc_n1(ub), dim=1))
    if not vals:
        return torch.full((u.shape[0],), torch.inf, dtype=u.dtype,
                          device=u.device)
    return torch.amin(torch.stack(vals, dim=1), dim=1)


def eig_clip_delta(layout: ConeLayout, v: torch.Tensor, lo, hi) -> torch.Tensor:
    """clip(v, [lo, hi]) - v in the Jordan spectral sense, per block.

    `lo`/`hi` are per-instance (B,) tensors.  Exactly zero on blocks
    already inside the band (see the reference's docstring)."""
    lo, hi = lo[:, None], hi[:, None]
    vo = _orth(layout, v)
    pieces = [torch.clamp(vo, lo, hi) - vo]
    for vb in _views(layout, v):
        n1 = _soc_n1(vb)
        lp = vb[..., 0] + n1
        lm = vb[..., 0] - n1
        dp = torch.clamp(lp, lo, hi) - lp
        dm = torch.clamp(lm, lo, hi) - lm
        fac = 0.5 * (dp - dm) / torch.where(n1 > 0, n1, torch.ones_like(n1))
        out = vb * fac[..., None]
        out[..., 0] = 0.5 * (dp + dm)
        pieces.append(out)
    return _flat(pieces)


def max_step(layout: ConeLayout, u: torch.Tensor, du: torch.Tensor) -> torch.Tensor:
    """sup{alpha >= 0 : u + alpha du in K} per instance (inf if unbounded).

    SOC blocks: smallest positive root of det(u + a du) = 0 by the stable
    formula a* = 2c / (-b + sqrt(D)); orthant: min(-u/du over du < 0).
    Branch-free, as in the reference.

    One deliberate difference: a double root (D = 0 exactly, as for every
    dim-1 SOC block and for du on a boundary ray) may round to a D just
    below 0.  The reference then drops the root and returns inf, a step
    that leaves the cone; here a D within the rounding error of
    b*b - 4ac counts as 0 (ROADMAP.md, queue 3).  The margin is 8 eps of
    u's own dtype, so in f32 it scales with f32's rounding as the
    reference's f32 arithmetic does: the rule is the same relative test in
    both dtypes."""
    eps = torch.finfo(u.dtype).eps
    alphas = []
    if layout.l:
        uo, duo = _orth(layout, u), _orth(layout, du)
        cand = torch.where(duo < 0, -uo / duo, torch.inf)
        alphas.append(torch.amin(cand, dim=1))
    for ub, db in zip(_views(layout, u), _views(layout, du)):
        a = _jdet(db)
        b = 2.0 * (2.0 * ub[..., 0] * db[..., 0] - torch.sum(ub * db, dim=-1))
        c = _jdet(ub)
        disc = b * b - 4.0 * a * c
        real = disc >= -8.0 * eps * (b * b + 4.0 * torch.abs(a * c))
        sq = torch.sqrt(torch.clamp_min(disc, 0.0))
        denom = -b + sq
        valid = ((a < 0) | ((b < 0) & real)) & (denom > 0)
        safe = torch.where(denom > 0, denom, torch.ones_like(denom))
        cand = torch.where(valid, 2.0 * c / safe, torch.inf)
        alphas.append(torch.amin(cand, dim=1))
    if not alphas:
        return u.new_full((u.shape[0],), torch.inf)
    return torch.amin(torch.stack(alphas, dim=1), dim=1)


class Scaling(NamedTuple):
    """Nesterov-Todd scaling of a batch.  Orthant: W = diag(w).  Each SOC
    bucket: W = eta * (2vv' - J) with det(v) = 1."""

    w_orth: torch.Tensor                 # (B, l)
    etas: tuple[torch.Tensor, ...]       # per bucket (B, n_blocks)
    vs: tuple[torch.Tensor, ...]         # per bucket (B, n_blocks, q_pad)
    lam: torch.Tensor                    # (B, m_pad)  lambda = W z = W^-1 s


def nt_scale(layout: ConeLayout, s: torch.Tensor, z: torch.Tensor) -> Scaling:
    so, zo = _orth(layout, s), _orth(layout, z)
    w_orth = torch.sqrt(so / zo)
    lam_pieces = [torch.sqrt(so * zo)]
    etas, vs = [], []
    for sb, zb in zip(_views(layout, s), _views(layout, z)):
        dets = _jdet(sb)
        detz = _jdet(zb)
        sbar = sb / torch.sqrt(dets)[..., None]
        zbar = zb / torch.sqrt(detz)[..., None]
        gamma = torch.sqrt((1.0 + torch.sum(sbar * zbar, dim=-1)) / 2.0)
        wbar = (sbar + _J(zbar)) / (2.0 * gamma[..., None])
        v = wbar.clone()
        v[..., 0] += 1.0
        v = v / torch.sqrt(2.0 * (1.0 + wbar[..., 0]))[..., None]
        eta = (dets / detz) ** 0.25
        etas.append(eta)
        vs.append(v)
        lam_b = eta[..., None] * (
            2.0 * v * torch.sum(v * zb, dim=-1)[..., None] - _J(zb)
        )
        lam_pieces.append(lam_b)
    return Scaling(w_orth=w_orth, etas=tuple(etas), vs=tuple(vs),
                   lam=_flat(lam_pieces))


def identity_scaling(layout: ConeLayout, batch: int, dtype=torch.float64,
                     device=None) -> Scaling:
    """W = I (initialization) in `dtype` (the solvers pass their carry
    dtype); lam is unused there."""
    etas, vs = [], []
    for b in layout.buckets:
        etas.append(torch.ones((batch, b.n_blocks), dtype=dtype, device=device))
        v = torch.zeros((batch, b.n_blocks, b.q_pad), dtype=dtype,
                        device=device)
        v[..., 0] = 1.0
        vs.append(v)
    return Scaling(
        w_orth=torch.ones((batch, layout.l), dtype=dtype, device=device),
        etas=tuple(etas),
        vs=tuple(vs),
        lam=identity(layout, batch, dtype, device),
    )


def apply_W(layout: ConeLayout, sc: Scaling, u: torch.Tensor) -> torch.Tensor:
    pieces = [_orth(layout, u) * sc.w_orth]
    for ub, eta, v in zip(_views(layout, u), sc.etas, sc.vs):
        pieces.append(eta[..., None] * (
            2.0 * v * torch.sum(v * ub, dim=-1)[..., None] - _J(ub)
        ))
    return _flat(pieces)


def apply_Winv(layout: ConeLayout, sc: Scaling, u: torch.Tensor) -> torch.Tensor:
    pieces = [_orth(layout, u) / sc.w_orth]
    for ub, eta, v in zip(_views(layout, u), sc.etas, sc.vs):
        jv = _J(v)
        pieces.append(
            (2.0 * jv * torch.sum(jv * ub, dim=-1)[..., None] - _J(ub))
            / eta[..., None]
        )
    return _flat(pieces)


def _wbar(v: torch.Tensor) -> torch.Tensor:
    """wbar = v o v = 2 v0 v - e (unit Jordan det): W = eta P(v) and
    W^2 = eta^2 P(wbar).  The reference keeps wbar beside v in its dd
    scaling (cones/dd_ops.py); here it is derived from v where needed."""
    wb = 2.0 * v[..., :1] * v
    wb[..., 0] -= 1.0
    return wb


def _apply2(layout: ConeLayout, sc: Scaling, u: torch.Tensor,
            inverse: bool) -> torch.Tensor:
    """W^2 u (or W^-2 u) in one pass: W^2 = eta^2 P(wbar) and W^-2 =
    eta^-2 P(J wbar), both P(g) u = 2 g (g'u) - J u."""
    w2 = sc.w_orth * sc.w_orth
    uo = _orth(layout, u)
    pieces = [uo / w2 if inverse else uo * w2]
    for ub, eta, v in zip(_views(layout, u), sc.etas, sc.vs):
        wb = _wbar(v)
        g = _J(wb) if inverse else wb
        core = 2.0 * g * torch.sum(g * ub, dim=-1, keepdim=True) - _J(ub)
        eta2 = (eta * eta)[..., None]
        pieces.append(core / eta2 if inverse else core * eta2)
    return _flat(pieces)


def apply_W2(layout: ConeLayout, sc: Scaling, u: torch.Tensor) -> torch.Tensor:
    """W'W u = W^2 u (W symmetric) in one pass."""
    return _apply2(layout, sc, u, inverse=False)


def apply_Winv2(layout: ConeLayout, sc: Scaling, u: torch.Tensor) -> torch.Tensor:
    """W^-2 u in one pass."""
    return _apply2(layout, sc, u, inverse=True)


def n_soc_blocks(layout: ConeLayout) -> int:
    """NB, the total SOC block count."""
    return sum(b.n_blocks for b in layout.buckets)


def winv2_rho(layout: ConeLayout, sc: Scaling) -> torch.Tensor:
    """The diagonal part of W^-2 as (B, m_pad) row weights: w^-2 on the
    orthant rows; per SOC block -eta^-2 on the head row and +eta^-2 on the
    tail rows (the -eta^-2 J term), so that

        G' W^-2 G = G' diag(rho) G + (G'V) diag(w2) (G'V)'

    with (V, w2) = winv2_columns."""
    pieces = [1.0 / (sc.w_orth * sc.w_orth)]
    for b, eta in zip(layout.buckets, sc.etas):
        e2 = 1.0 / (eta * eta)                              # (B, nb)
        sign = torch.ones(b.q_pad, dtype=e2.dtype, device=e2.device)
        sign[0] = -1.0
        pieces.append(e2[..., None] * sign)
    return _flat(pieces)


def winv2_columns(layout: ConeLayout, sc: Scaling):
    """Rank-correction generators of the structured KKT assembly: V
    (B, m_pad, NB), whose column b holds J wbar_b on block b's padded rows
    and zeros elsewhere, and w2 (B, NB) = 2 eta_b^-2 (None when NB = 0)."""
    nb_total = n_soc_blocks(layout)
    B = sc.w_orth.shape[0]
    dtype, device = sc.w_orth.dtype, sc.w_orth.device
    V = torch.zeros((B, layout.m_pad, nb_total), dtype=dtype, device=device)
    w2s = []
    col0 = 0
    for b, eta, v in zip(layout.buckets, sc.etas, sc.vs):
        nb = b.n_blocks
        eye = torch.eye(nb, dtype=dtype, device=device)
        blk = _J(_wbar(v))[..., None] * eye[:, None, :]    # (B, nb, q_pad, nb)
        V[:, b.offset:b.offset + b.size, col0:col0 + nb] = blk.reshape(
            B, b.size, nb)
        w2s.append(2.0 / (eta * eta))
        col0 += nb
    w2 = torch.cat(w2s, dim=1) if w2s else None
    return V, w2


def scale_rows_Winv(layout: ConeLayout, sc: Scaling, G: torch.Tensor) -> torch.Tensor:
    """W^-1 G for a (B, m_pad, n) batch: diag scaling on orthant rows, a
    batched rank-1 (arrow) update per SOC bucket, never materializing W."""
    B, _, n = G.shape
    pieces = [G[:, : layout.l] / sc.w_orth[..., None]]
    for b, eta, v in zip(layout.buckets, sc.etas, sc.vs):
        Gb = G[:, b.offset : b.offset + b.size].view(B, b.n_blocks, b.q_pad, n)
        jv = _J(v)
        t = torch.einsum("bkq,bkqn->bkn", jv, Gb)           # (Jv)' G_b
        JGb = torch.cat([Gb[:, :, :1, :], -Gb[:, :, 1:, :]], dim=2)
        out = (2.0 * jv[..., None] * t[:, :, None, :] - JGb) / eta[..., None, None]
        pieces.append(out.reshape(B, b.size, n))
    return torch.cat(pieces, dim=1)
