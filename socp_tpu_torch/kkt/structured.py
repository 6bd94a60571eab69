"""Structured assembly of the condensed KKT system over a batch, in f64 —
the port of the dd-native half of `socp_tpu/kkt/dd_dense.py`
(`ConstGram`, `precompute_const_gram`, `factor_dd`, `solve_dd`,
`solve_refined_dd`), the reference's route under `native_dd=True`.

The system and its two factors are those of kkt/dense.py; what differs is
how H = Paug + G' W^-2 G is assembled and how the back-solves apply W:

  * ConstGram (1 <= NB <= CONST_GRAM_MAX_BLOCKS, NB the SOC block count;
    the per-solve constants from `precompute_const_gram`): per SOC block
    W_b^-2 = eta_b^-2 (2 u_b u_b' - J) with u_b = J wbar_b, so

        H = sum_b eta_b^-2 (K_b - 2 g0_b g0_b') + C diag(-w2, w2) C'
            [+ G_o' diag(w^-2) G_o] + Paug,     C = [g0 | G'V],

    with K_b = G_b'G_b and g0_b = G' e_head(b) constant over the solve:
    a weighted sum of NB constant n x n matrices, one rank-2NB product and
    the orthant rows' Gram.
  * structured (NB <= STRUCT_MAX_BLOCKS):
        H = G' diag(rho) G + (G'V) diag(w2) (G'V)' + Paug
    with rho, V, w2 from cones/ops.winv2_rho / winv2_columns.
  * otherwise the scaled-matrix assembly of kkt/dense.py (Ghat = W^-1 G).

The first two never form W^-1 G: a back-solve applies W^-2 by a fused cone
op on the CONSTANT G (btx = bx + G'(W^-2 bz), dz = W^-2 (G dx - bz)), and
returns the G dx it computed so that the refinement residual reuses it.
The factors and back-solves go through kkt/dense.py's `EqChol`, so through
the same kernel routers and the same four f64 kernels.  The assembly
itself is batched torch products (cuBLAS f64 on the card), as the
reference leaves it to XLA.  f64 only: `native_dd` selects the f64 factor
whatever `factor_dtype` says (api.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from socp_tpu_torch.cones import ops as cops
from socp_tpu_torch.cones.layout import ConeLayout
from socp_tpu_torch.kkt import dense
from socp_tpu_torch.kkt.dense import EqChol, _dot, _mtv, _mv

# Largest SOC block count of the ConstGram assembly (a memory gate: the
# stacked K holds NB n^2 words an instance).
CONST_GRAM_MAX_BLOCKS = 4
# Largest SOC block count of the structured (rank-correction) assembly;
# beyond it the m x NB generators outgrow the pass over W^-1 G they replace.
STRUCT_MAX_BLOCKS = 32


class ConstGram(NamedTuple):
    """The per-solve constants of the ConstGram assembly."""

    K: torch.Tensor               # (B, NB, n, n) per-block Grams G_b' G_b
    g0: torch.Tensor              # (B, n, NB) head rows G' e_head(b)
    Go: torch.Tensor | None       # (B, l, n) orthant rows; None for l = 0


class StructKKT(NamedTuple):
    """Factored condensed system of the ConstGram and structured
    assemblies: the back-solves ride the constant G."""

    L_H: EqChol
    L_S: EqChol
    G: torch.Tensor               # (B, m_pad, n), the problem's own
    scaling: cops.Scaling


def precompute_const_gram(layout: ConeLayout,
                          G: torch.Tensor) -> ConstGram | None:
    """The ConstGram constants (one batched GEMM a bucket), or None when the
    layout does not qualify (no SOC block, or more than
    CONST_GRAM_MAX_BLOCKS).  Block b takes its q_pad padded rows, zero rows
    included, as the reference slices them."""
    nb_total = cops.n_soc_blocks(layout)
    if nb_total == 0 or nb_total > CONST_GRAM_MAX_BLOCKS:
        return None
    B, _, n = G.shape
    Ks, g0s = [], []
    for b in layout.buckets:
        Gb = G[:, b.offset:b.offset + b.size].reshape(B, b.n_blocks, b.q_pad, n)
        Ks.append(Gb.transpose(2, 3) @ Gb)                 # (B, nb, n, n)
        g0s.append(Gb[:, :, 0, :])                         # (B, nb, n)
    K = torch.cat(Ks, dim=1)
    g0 = torch.cat(g0s, dim=1).transpose(1, 2).contiguous()
    Go = G[:, :layout.l] if layout.l else None
    return ConstGram(K=K, g0=g0, Go=Go)


def route(layout: ConeLayout, cg: ConstGram | None) -> str:
    """The assembly `factor` takes: "const_gram", "structured" or "dense"."""
    if cg is not None:
        return "const_gram"
    if cops.n_soc_blocks(layout) <= STRUCT_MAX_BLOCKS:
        return "structured"
    return "dense"


def factor(
    layout: ConeLayout,
    scaling: cops.Scaling,
    Paug: torch.Tensor | None,
    A: torch.Tensor,
    G: torch.Tensor,
    delta: float = 0.0,
    cg: ConstGram | None = None,
) -> StructKKT | dense.DenseKKT:
    """Assemble H = Paug + G' W^-2 G by the best assembly the layout allows
    (module doc; `route`) and factor it, with the Schur complement of A for
    p > 0.  The same launches as kkt/dense.factor."""
    how = route(layout, cg)
    if how == "dense":
        return dense.factor(layout, scaling, Paug, A, G, delta)
    if how == "const_gram":
        V, w2 = cops.winv2_columns(layout, scaling)        # w2 = 2 eta^-2
        e2 = 0.5 * w2                                      # eta^-2
        H = torch.einsum("bk,bkij->bij", e2, cg.K)
        U = G.transpose(1, 2) @ V                          # (B, n, NB)
        C = torch.cat([cg.g0, U], dim=2)                   # (B, n, 2 NB)
        wC = torch.cat([-w2, w2], dim=1)
        H = H + (C * wC[:, None, :]) @ C.transpose(1, 2)
        if layout.l:
            w2o = 1.0 / (scaling.w_orth * scaling.w_orth)
            H = H + cg.Go.transpose(1, 2) @ (cg.Go * w2o[..., None])
    else:
        rho = cops.winv2_rho(layout, scaling)
        H = G.transpose(1, 2) @ (G * rho[..., None])
        if cops.n_soc_blocks(layout):
            V, w2 = cops.winv2_columns(layout, scaling)
            U = G.transpose(1, 2) @ V
            H = H + (U * w2[:, None, :]) @ U.transpose(1, 2)
    if Paug is not None:
        H = H + Paug
    L_H, L_S = dense.factor_condensed(H, A, delta)
    return StructKKT(L_H=L_H, L_S=L_S, G=G, scaling=scaling)


def solve(
    layout: ConeLayout,
    kkt: StructKKT | dense.DenseKKT,
    A: torch.Tensor,
    bx: torch.Tensor,
    by: torch.Tensor,
    bz: torch.Tensor,
    aug_rho: float = 0.0,
    want_Gdx: bool = False,
):
    """One condensed back-solve.  `want_Gdx=True` also returns the G dx that
    the dz mapping computed (None from the scaled-matrix assembly, which
    forms only Ghat dx)."""
    if isinstance(kkt, dense.DenseKKT):
        dx, dy, dz = dense.solve(layout, kkt, A, bx, by, bz, aug_rho=aug_rho)
        Gdx = None
    else:
        t = cops.apply_Winv2(layout, kkt.scaling, bz)
        btx = bx + _mtv(kkt.G, t)
        dx, dy = dense.solve_condensed(kkt.L_H, kkt.L_S, A, btx, by, aug_rho)
        Gdx = _mv(kkt.G, dx)
        dz = cops.apply_Winv2(layout, kkt.scaling, Gdx - bz)
    if want_Gdx:
        return dx, dy, dz, Gdx
    return dx, dy, dz


def solve_refined(
    layout: ConeLayout,
    kkt: StructKKT | dense.DenseKKT,
    P: torch.Tensor | None,
    A: torch.Tensor,
    G: torch.Tensor,
    bx: torch.Tensor,
    by: torch.Tensor,
    bz: torch.Tensor,
    refine_steps: int = 0,
    aug_rho: float = 0.0,
):
    """Solve + iterative refinement on the full 3x3 residual, as
    kkt/dense.solve_refined, with W'W applied in one pass and the
    residual's G dx taken from the solve (one G-sized matvec fewer a
    round).  Returns (dx, dy, dz, quality)."""
    dx, dy, dz, Gdx = solve(layout, kkt, A, bx, by, bz, aug_rho=aug_rho,
                            want_Gdx=True)
    quality = bx.new_zeros(bx.shape[0])
    if refine_steps <= 0:
        return dx, dy, dz, quality
    rhs_norm = torch.sqrt(_dot(bx, bx) + _dot(by, by) + _dot(bz, bz)) + 1.0
    for _ in range(refine_steps):
        rx = bx - (_mtv(A, dy) + _mtv(G, dz))
        if P is not None:
            rx = rx - _mv(P, dx)
        ry = by - _mv(A, dx)
        WWdz = cops.apply_W2(layout, kkt.scaling, dz)
        if Gdx is None:
            Gdx = _mv(G, dx)
        rz = bz - (Gdx - WWdz)
        quality = torch.sqrt(_dot(rx, rx) + _dot(ry, ry) + _dot(rz, rz)) / rhs_norm
        ex, ey, ez, Gex = solve(layout, kkt, A, rx, ry, rz, aug_rho=aug_rho,
                                want_Gdx=True)
        dx = dx + ex
        dy = dy + ey
        dz = dz + ez
        Gdx = Gdx + Gex if Gex is not None else None
    return dx, dy, dz, quality
