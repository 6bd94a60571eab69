"""Dense condensed KKT subsystem over a batch — the port of
`socp_tpu/kkt/dense.py`.

The quasidefinite 3x3 system of every instance

    [P   A'  G' ] [dx]   [bx]
    [A   0   0  ] [dy] = [by]
    [G   0  -W'W] [dz]   [bz]

is reduced to two SPD factorizations:

    Ghat = W^-1 G                      (blockwise diag + rank-1, O(mn))
    H    = Paug + Ghat'Ghat + delta I  -> Cholesky L_H      (n x n)
    S    = A H^-1 A'    + delta I      -> Cholesky L_S      (p x p)

with `Paug = P + rho A'A` (see the reference's module doc).  The factors go
through the Cholesky router and every back-solve through the
triangular-pair router (`socp_tpu_torch.ops.chol.cholesky` /
`tri_pair_solve`): a batch of one instance (the single solve) runs the
single-instance kernels, a larger batch the batched ones.  H's product
Ghat'Ghat is a plain batched matmul, as the reference leaves it to XLA.

Precision.  All arithmetic runs in the carry dtype (the iterates', f64 or
f32) by default.  `factor(..., factor_dtype=torch.float32)` under f64
carries is the reference's mixed-precision mode
(`SolverConfig(factor_dtype="float32")`, the dsgesv scheme): Ghat = W^-1 G
is formed in f64 and cast to f32, H = Ghat'Ghat + Paug, the equilibrated
Cholesky factors (whose delta floor becomes 32 eps_f32, about 3.8e-6) and
every back-solve run in f32, through the f32 kernels; `solve` casts its
right-hand sides to f32, and `solve_refined` casts each solve's result back
to the carry dtype (f64) before it adds it, and keeps the refinement
residual, with the f64 `scaling`, in f64.  Under f32 carries (the
reference's f32-carries mode) everything is f32, and an f64 factor
(`factor_dtype="float64"` or `"dd32"`) casts Ghat and the right-hand sides
up.  `solve_refined(..., refine_in_f64=True)` takes the residual's products
and sums in f64 over f64 copies of P, A and G (`residual_operands`) and
casts the correction to the carry dtype, as the reference does
(socp_tpu/kkt/dense.py:207-230); the W'W dz product stays in the carry
dtype there too.  The f32 products (Ghat'Ghat, Ghat' bhz, Ghat dx, and
every product of an f32 carry) are cuBLAS SGEMM / SGEMV on the card: they
are in full f32 only while `torch.backends.cuda.matmul.allow_tf32` is False
(PyTorch's default), which this module does not change.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from socp_tpu_torch.cones import ops as cops
from socp_tpu_torch.cones.layout import ConeLayout
from socp_tpu_torch.ops import chol


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched matvec (B, r, c) @ (B, c) -> (B, r)."""
    return (M @ v[..., None])[..., 0]


def _mtv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched transposed matvec (B, r, c)' @ (B, r) -> (B, c)."""
    return (v[:, None, :] @ M)[:, 0, :]


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b, dim=-1)


class EqChol(NamedTuple):
    """Jacobi-equilibrated Cholesky factor of a batch of SPD matrices M:
    L L' = D M D + delta I with D = diag(1/sqrt(diag M))."""

    L: torch.Tensor   # (B, n, n)
    d: torch.Tensor   # (B, n)

    def solve(self, rhs: torch.Tensor) -> torch.Tensor:
        """M^-1 rhs for rhs (B, n) or (B, n, k), via the tri-pair kernel."""
        vec = rhs.ndim == 2
        r = rhs[..., None] if vec else rhs
        y = chol.tri_pair_solve(self.L, (self.d[..., None] * r).contiguous())
        y = self.d[..., None] * y
        return y[..., 0] if vec else y


def _eq_chol(M: torch.Tensor, delta: float) -> EqChol:
    finfo = torch.finfo(M.dtype)
    diag = torch.diagonal(M, dim1=1, dim2=2)
    d = 1.0 / torch.sqrt(torch.clamp_min(diag, finfo.tiny ** 0.5))
    Mn = d[:, :, None] * M * d[:, None, :]
    # floor the regularization at a multiple of the factor dtype's epsilon
    delta_eff = max(delta, 32.0 * finfo.eps)
    torch.diagonal(Mn, dim1=1, dim2=2).add_(delta_eff)   # Mn is a fresh tensor
    return EqChol(L=chol.cholesky(Mn), d=d)


class DenseKKT(NamedTuple):
    """Factored condensed system.  L_H, L_S, Ghat and scaling_lo are in the
    factor dtype (the back-solves); scaling keeps the carry dtype for the
    refinement residual's W'W products.  In f64 mode scaling_lo holds
    scaling's tensors."""

    L_H: EqChol               # equilibrated Cholesky of H (B, n, n)
    L_S: EqChol               # equilibrated Cholesky of the Schur complement
    Ghat: torch.Tensor        # (B, m_pad, n) = W^-1 G
    scaling: cops.Scaling
    scaling_lo: cops.Scaling


def _cast_scaling(sc: cops.Scaling, dtype: torch.dtype) -> cops.Scaling:
    return cops.Scaling(
        w_orth=sc.w_orth.to(dtype),
        etas=tuple(e.to(dtype) for e in sc.etas),
        vs=tuple(v.to(dtype) for v in sc.vs),
        lam=sc.lam.to(dtype),
    )


def factor(
    layout: ConeLayout,
    scaling: cops.Scaling,
    Paug: torch.Tensor | None,
    A: torch.Tensor,
    G: torch.Tensor,
    delta: float = 0.0,
    factor_dtype: torch.dtype | None = None,
) -> DenseKKT:
    """Assemble and factor; `Paug` already holds the rho A'A augmentation.
    `factor_dtype` (None: G's dtype) is the dtype of the factors and the
    back-solves (module doc).

    Launches: one Cholesky of H; with p > 0 also one tri-pair solve with
    k = p (H^-1 A') and one Cholesky of the p x p Schur complement."""
    fdt = factor_dtype or G.dtype
    # .to() of a tensor already in fdt is the tensor itself: no copy in f64
    Ghat = cops.scale_rows_Winv(layout, scaling, G).to(fdt)
    A = A.to(fdt)
    H = Ghat.transpose(1, 2) @ Ghat
    if Paug is not None:
        H = H + Paug.to(fdt)
    L_H, L_S = factor_condensed(H, A, delta)
    return DenseKKT(L_H=L_H, L_S=L_S, Ghat=Ghat, scaling=scaling,
                    scaling_lo=_cast_scaling(scaling, fdt))


def factor_condensed(H: torch.Tensor, A: torch.Tensor, delta: float):
    """(L_H, L_S): the equilibrated factors of an assembled H and, with
    p > 0, of the Schur complement S = A H^-1 A' (empty for p = 0).  A is
    in H's dtype."""
    B, p, _ = A.shape
    L_H = _eq_chol(H, delta)
    if p:
        HinvAT = L_H.solve(A.transpose(1, 2))
        S = A @ HinvAT
        L_S = _eq_chol(S, delta)
    else:
        L_S = EqChol(L=H.new_zeros((B, 0, 0)), d=H.new_zeros((B, 0)))
    return L_H, L_S


def solve(
    layout: ConeLayout,
    kkt: DenseKKT,
    A: torch.Tensor,
    bx: torch.Tensor,
    by: torch.Tensor,
    bz: torch.Tensor,
    aug_rho: float = 0.0,
):
    """One condensed back-solve in the factor dtype (the right-hand sides
    and A are cast to it, as the reference does): 1 tri-pair launch for
    p = 0, 3 for p > 0.  The augmented system's multiplier relates to the
    true dy by dy = y_hat + rho*by (exact)."""
    fdt = kkt.Ghat.dtype
    bx, by, bz, A = (t.to(fdt) for t in (bx, by, bz, A))
    bhz = cops.apply_Winv(layout, kkt.scaling_lo, bz)
    btx = bx + _mtv(kkt.Ghat, bhz)
    dx, dy = solve_condensed(kkt.L_H, kkt.L_S, A, btx, by, aug_rho)
    dz = cops.apply_Winv(layout, kkt.scaling_lo, _mv(kkt.Ghat, dx) - bhz)
    return dx, dy, dz


def solve_condensed(L_H: EqChol, L_S: EqChol, A: torch.Tensor,
                    btx: torch.Tensor, by: torch.Tensor, aug_rho: float = 0.0):
    """(dx, dy) of the condensed system H dx + A' y = btx, A dx = by through
    the factors of `factor_condensed`: 1 tri-pair launch for p = 0, 3 for
    p > 0."""
    if A.shape[1]:
        t1 = L_H.solve(btx)
        yhat = L_S.solve(_mv(A, t1) - by)
        dx = L_H.solve(btx - _mtv(A, yhat))
        dy = yhat + aug_rho * by if aug_rho else yhat
    else:
        dy = by  # empty
        dx = L_H.solve(btx)
    return dx, dy


def residual_operands(P: torch.Tensor | None, A: torch.Tensor,
                      G: torch.Tensor, refine_in_f64: bool = False):
    """(P, A, G) in the refinement residual's dtype: f64 under
    `refine_in_f64`, else G's (the carry dtype).  Tensors already in it are
    returned as they are, so f64 carries copy nothing."""
    hi = torch.float64 if refine_in_f64 else G.dtype
    return tuple(None if t is None else t.to(hi) for t in (P, A, G))


def solve_refined(
    layout: ConeLayout,
    kkt: DenseKKT,
    P: torch.Tensor | None,
    A: torch.Tensor,
    G: torch.Tensor,
    bx: torch.Tensor,
    by: torch.Tensor,
    bz: torch.Tensor,
    refine_steps: int = 0,
    aug_rho: float = 0.0,
    refine_in_f64: bool = False,
    hi_ops: tuple | None = None,
):
    """KKT solve + iterative refinement on the full 3x3 residual.  `P` is
    the ORIGINAL quadratic term (None for a pure SOCP).  Returns
    (dx, dy, dz, quality) with quality the (B,) relative residual before
    the last correction (0 without refinement).  The solves' results are
    cast to the carry dtype (bx's) before they are added.  The residual is
    computed in the carry dtype, or in f64 under `refine_in_f64` (module
    doc); `hi_ops` is `residual_operands(P, A, G, refine_in_f64)`, made
    here when not given."""
    carry = bx.dtype

    def solve_carry(rx, ry, rz):
        out = solve(layout, kkt, A, rx, ry, rz, aug_rho=aug_rho)
        return tuple(o.to(carry) for o in out)

    dx, dy, dz = solve_carry(bx, by, bz)
    quality = bx.new_zeros(bx.shape[0])
    if refine_steps <= 0:
        return dx, dy, dz, quality
    sc = kkt.scaling
    Ph, Ah, Gh = hi_ops or residual_operands(P, A, G, refine_in_f64)
    hi = Gh.dtype
    bxh, byh, bzh = bx.to(hi), by.to(hi), bz.to(hi)
    rhs_norm = torch.sqrt(_dot(bx, bx) + _dot(by, by) + _dot(bz, bz)) + 1.0
    for _ in range(refine_steps):
        dxh, dyh, dzh = dx.to(hi), dy.to(hi), dz.to(hi)
        rx = bxh - (_mtv(Ah, dyh) + _mtv(Gh, dzh))
        if P is not None:
            rx = rx - _mv(Ph, dxh)
        ry = byh - _mv(Ah, dxh)
        WWdz = cops.apply_W(layout, sc, cops.apply_W(layout, sc, dz)).to(hi)
        rz = bzh - (_mv(Gh, dxh) - WWdz)
        quality = (torch.sqrt(_dot(rx, rx) + _dot(ry, ry) + _dot(rz, rz))
                   .to(carry) / rhs_norm)
        ex, ey, ez = solve_carry(rx, ry, rz)
        dx = dx + ex
        dy = dy + ey
        dz = dz + ez
    return dx, dy, dz, quality
