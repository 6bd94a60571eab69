"""Plain-NumPy SOCP interior-point oracle: the port's copy of
`socp_tpu/utils/oracle.py`, the executable specification of the solver.

It solves

    minimize    (1/2) x'Px + c'x
    subject to  Ax = b
                Gx + s = h,   s in K,
    K = R+^l x Q^{q_1} x ... x Q^{q_N}   (nonnegative orthant x second-order cones)

by a primal-dual path-following interior-point method with
Nesterov-Todd scaling and Mehrotra predictor-corrector steps, to a 1e-8
duality gap / feasibility tolerance, with a dense LU of the full 3x3 KKT
system every iteration.  It stays deliberately simple, loopy NumPy and
SciPy, independent of the torch code it is a spec for: a user of the port
without the JAX package compares `socp_tpu_torch.solve` against
`socp_tpu_torch.utils.oracle.solve` on the same data.  Its status codes
are the ints of `socp_tpu_torch.solution.Status`.

Well-posedness assumptions (same as CVXOPT's coneprog): rank(A) = p and
rank([P; A; G]) = n; otherwise the quasidefinite KKT system is singular.

The arithmetic is the reference's line for line, so on the same inputs
both oracles give the same bits, with one deliberate difference, in
`_smallest_pos_root`: an SOC block's step length is the smallest
positive root of det(u + a du) = a t^2 + b t + c, whose discriminant is
0 for a double root (every dim-1 SOC block, and du on a boundary ray).
Rounding may leave it just below 0; the reference then drops the root
and returns inf, a step that leaves the cone.  Here a discriminant within
8 eps (b^2 + 4|ac|) of 0 counts as 0, the rule the port's solver applies
(`socp_tpu_torch/cones/ops.max_step`; ROADMAP.md, queue 3 items 1 and
6).  Where that rule does not fire, the two oracles agree bit for bit.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from socp_tpu_torch.problem import ConeDims
from socp_tpu_torch.solution import Status

# Status codes: the solver's (socp_tpu_torch.solution.Status).
OPTIMAL = int(Status.OPTIMAL)
PRIMAL_INFEASIBLE = int(Status.PRIMAL_INFEASIBLE)
DUAL_INFEASIBLE = int(Status.DUAL_INFEASIBLE)
MAX_ITER = int(Status.MAX_ITERATIONS)
NUMERICAL_ERROR = int(Status.NUMERICAL_ERROR)

_EPS = float(np.finfo(np.float64).eps)

STATUS_NAMES = {
    OPTIMAL: "optimal",
    PRIMAL_INFEASIBLE: "primal_infeasible",
    DUAL_INFEASIBLE: "dual_infeasible",
    MAX_ITER: "max_iterations",
    NUMERICAL_ERROR: "numerical_error",
}


# ---------------------------------------------------------------------------
# Jordan-algebra cone kernels (flat-vector, per-block loops; executable spec)
# ---------------------------------------------------------------------------


def cone_identity(dims: ConeDims) -> np.ndarray:
    e = np.zeros(dims.dim)
    e[: dims.l] = 1.0
    for sl in dims.soc_slices():
        e[sl.start] = 1.0
    return e


def jprod(dims: ConeDims, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Jordan product u o v: elementwise on the orthant, arrow product on SOCs."""
    out = np.empty_like(u)
    out[: dims.l] = u[: dims.l] * v[: dims.l]
    for sl in dims.soc_slices():
        u0, u1 = u[sl.start], u[sl.start + 1 : sl.stop]
        v0, v1 = v[sl.start], v[sl.start + 1 : sl.stop]
        out[sl.start] = u0 * v0 + u1 @ v1
        out[sl.start + 1 : sl.stop] = u0 * v1 + v0 * u1
    return out


def jdiv(dims: ConeDims, lam: np.ndarray, d: np.ndarray) -> np.ndarray:
    """Solve lam o u = d for u (lam interior)."""
    out = np.empty_like(d)
    out[: dims.l] = d[: dims.l] / lam[: dims.l]
    for sl in dims.soc_slices():
        l0, l1 = lam[sl.start], lam[sl.start + 1 : sl.stop]
        d0, d1 = d[sl.start], d[sl.start + 1 : sl.stop]
        det = l0 * l0 - l1 @ l1
        u0 = (l0 * d0 - l1 @ d1) / det
        out[sl.start] = u0
        out[sl.start + 1 : sl.stop] = (d1 - u0 * l1) / l0
    return out


def lambda_min(dims: ConeDims, u: np.ndarray) -> float:
    """Smallest Jordan eigenvalue over all blocks (min(u) / u0 - ||u1||)."""
    vals = []
    if dims.l:
        vals.append(np.min(u[: dims.l]))
    for sl in dims.soc_slices():
        vals.append(u[sl.start] - np.linalg.norm(u[sl.start + 1 : sl.stop]))
    return min(vals) if vals else np.inf


def max_step(dims: ConeDims, u: np.ndarray, du: np.ndarray) -> float:
    """sup{alpha >= 0 : u + alpha*du in K} for interior u (+inf if unbounded).

    Orthant: min over du_i < 0 of -u_i/du_i.  SOC: smallest positive root of
    det(u + alpha*du) = 0, a scalar quadratic (SURVEY.md Appendix A).
    """
    alpha = np.inf
    if dims.l:
        neg = du[: dims.l] < 0
        if np.any(neg):
            alpha = min(alpha, np.min(-u[: dims.l][neg] / du[: dims.l][neg]))
    for sl in dims.soc_slices():
        u0, u1 = u[sl.start], u[sl.start + 1 : sl.stop]
        d0, d1 = du[sl.start], du[sl.start + 1 : sl.stop]
        a = d0 * d0 - d1 @ d1          # det(du)
        b = 2.0 * (u0 * d0 - u1 @ d1)  # 2 u'J du
        c = u0 * u0 - u1 @ u1          # det(u) > 0 for interior u
        root = _smallest_pos_root(a, b, c)
        alpha = min(alpha, root)
    return alpha


def _smallest_pos_root(a: float, b: float, c: float) -> float:
    """Smallest positive root of a*t^2 + b*t + c = 0 given c > 0; inf if none.

    A discriminant within 8 eps (b^2 + 4|ac|) of 0, its rounding error,
    is a double root (module doc); the reference returns inf there."""
    if a == 0.0:
        return -c / b if b < 0 else np.inf
    disc = b * b - 4.0 * a * c
    if a < 0.0:
        # f(0) = c > 0, f(inf) -> -inf: exactly one positive root.
        # disc >= b^2 here since -4ac > 0.
        return (-b - np.sqrt(disc)) / (2.0 * a) if b > 0 else \
               (2.0 * c) / (-b + np.sqrt(disc))
    if disc < -8.0 * _EPS * (b * b + 4.0 * abs(a * c)):
        return np.inf
    # a > 0: two real roots of same sign (product c/a > 0); positive iff b < 0.
    if b >= 0.0:
        return np.inf
    sq = np.sqrt(max(disc, 0.0))
    return (2.0 * c) / (-b + sq)  # stable form of smallest root


class NTScaling:
    """Nesterov-Todd scaling for the product cone.

    Orthant block: W = diag(w), w = sqrt(s/z).
    SOC block (SURVEY.md Appendix A, verified):
        sbar = s/sqrt(det s), zbar = z/sqrt(det z)
        gamma = sqrt((1 + zbar's bar)/2), wbar = (sbar + J zbar)/(2 gamma)
        eta = (det s / det z)^(1/4), v = (wbar + e)/sqrt(2 (1 + wbar_0))
        W u    = eta   * (2 v (v'u)      - J u)          (W = eta * P(v), symmetric)
        W^-1 u = eta^-1* (2 (Jv)((Jv)'u) - J u)          (P(v)^-1 = P(Jv), det v = 1)
    and lambda = W z = W^-1 s (the NT identity).
    """

    def __init__(self, dims: ConeDims, s: np.ndarray, z: np.ndarray):
        self.dims = dims
        self.w_orth = np.sqrt(s[: dims.l] / z[: dims.l])
        self.soc_eta: list[float] = []
        self.soc_v: list[np.ndarray] = []
        for sl in dims.soc_slices():
            sb, zb = s[sl], z[sl]
            dets = sb[0] ** 2 - sb[1:] @ sb[1:]
            detz = zb[0] ** 2 - zb[1:] @ zb[1:]
            sbar = sb / np.sqrt(dets)
            zbar = zb / np.sqrt(detz)
            gamma = np.sqrt((1.0 + sbar @ zbar) / 2.0)
            wbar = np.empty_like(sb)
            wbar[0] = (sbar[0] + zbar[0]) / (2.0 * gamma)
            wbar[1:] = (sbar[1:] - zbar[1:]) / (2.0 * gamma)
            v = wbar.copy()
            v[0] += 1.0
            v /= np.sqrt(2.0 * (1.0 + wbar[0]))
            self.soc_eta.append((dets / detz) ** 0.25)
            self.soc_v.append(v)
        self.lam = self.apply_W(z)

    def _apply(self, u: np.ndarray, inverse: bool) -> np.ndarray:
        dims = self.dims
        out = np.empty_like(u)
        out[: dims.l] = u[: dims.l] / self.w_orth if inverse else u[: dims.l] * self.w_orth
        for k, sl in enumerate(dims.soc_slices()):
            eta, v = self.soc_eta[k], self.soc_v[k]
            ub = u[sl]
            Ju = ub.copy()
            Ju[1:] *= -1.0
            if inverse:
                jv = v.copy()
                jv[1:] *= -1.0
                out[sl] = (2.0 * (jv @ ub) * jv - Ju) / eta
            else:
                out[sl] = eta * (2.0 * (v @ ub) * v - Ju)
        return out

    def apply_W(self, u: np.ndarray) -> np.ndarray:
        return self._apply(u, inverse=False)

    def apply_Winv(self, u: np.ndarray) -> np.ndarray:
        return self._apply(u, inverse=True)


class _IdentityScaling:
    """W = I (used for initialization)."""

    def __init__(self, dims: ConeDims):
        self.dims = dims

    def apply_W(self, u):
        return u

    def apply_Winv(self, u):
        return u


# ---------------------------------------------------------------------------
# KKT subsystem: full 3x3 assemble + LU factor (oracle keeps it simple)
# ---------------------------------------------------------------------------


class KKT:
    """[P A' G'; A 0 0; G 0 -W'W] factored once per IPM iteration.

    The solver uses the condensed normal-equations / Schur form instead;
    the oracle uses the full quasidefinite system with dense LU for maximum
    transparency.  Static regularization +/-delta on the diagonal.
    """

    def __init__(self, P, A, G, scaling, dims: ConeDims, delta: float = 0.0):
        import scipy.linalg

        n = G.shape[1]
        p = A.shape[0]
        m = G.shape[0]
        self.n, self.p, self.m = n, p, m
        self.scaling = scaling
        WW = np.empty((m, m))
        for j in range(m):
            ej = np.zeros(m)
            ej[j] = 1.0
            WW[:, j] = scaling.apply_W(scaling.apply_W(ej))
        K = np.zeros((n + p + m, n + p + m))
        K[:n, :n] = P + delta * np.eye(n)
        K[:n, n : n + p] = A.T
        K[:n, n + p :] = G.T
        K[n : n + p, :n] = A
        K[n : n + p, n : n + p] = -delta * np.eye(p)
        K[n + p :, :n] = G
        K[n + p :, n + p :] = -WW - delta * np.eye(m)
        self._lu = scipy.linalg.lu_factor(K)
        self._solve = lambda rhs: scipy.linalg.lu_solve(self._lu, rhs)

    def solve(self, bx, by, bz):
        n, p = self.n, self.p
        sol = self._solve(np.concatenate([bx, by, bz]))
        return sol[:n], sol[n : n + p], sol[n + p :]


# ---------------------------------------------------------------------------
# The IPM driver
# ---------------------------------------------------------------------------


def solve(
    c: np.ndarray,
    G: np.ndarray,
    h: np.ndarray,
    dims: ConeDims,
    A: Optional[np.ndarray] = None,
    b: Optional[np.ndarray] = None,
    P: Optional[np.ndarray] = None,
    max_iter: int = 100,
    abstol: float = 1e-8,
    reltol: float = 1e-8,
    feastol: float = 1e-8,
    step_frac: float = 0.99,
    verbose: bool = False,
) -> dict:
    """Mehrotra predictor-corrector IPM; returns a dict of x, y, s, z,
    status (an int of Status) and status_name, iterations, gap, pcost,
    pres, dres and the per-iteration log."""
    n = int(c.shape[0])
    m = int(G.shape[0])
    assert m == dims.dim, f"G rows {m} != cone dim {dims.dim}"
    if A is None:
        A = np.zeros((0, n))
        b = np.zeros(0)
    p = A.shape[0]
    if P is None:
        P = np.zeros((n, n))
    c, G, h, A, b, P = (np.asarray(x, float) for x in (c, G, h, A, b, P))

    nu = float(dims.degree)
    e = cone_identity(dims)

    # --- Initialization: least-squares KKT solves with W = I, then shift
    #     s and z into the cone interior (SURVEY.md section 3.3).
    kkt0 = KKT(P, A, G, _IdentityScaling(dims), dims)
    x, y, zhat = kkt0.solve(np.zeros(n), b, h)
    shat = -zhat  # third row: Gx - z = h  =>  s = h - Gx = -z
    alpha_p = -lambda_min(dims, shat)
    s = shat if alpha_p < 0 else shat + (1.0 + alpha_p) * e
    _, y, zhat = kkt0.solve(-c, np.zeros(p), np.zeros(m))
    alpha_d = -lambda_min(dims, zhat)
    z = zhat if alpha_d < 0 else zhat + (1.0 + alpha_d) * e

    iters_log = []
    status = MAX_ITER
    niter = 0
    for it in range(max_iter):
        niter = it
        # Residuals and gap.
        rx = P @ x + A.T @ y + G.T @ z + c
        ry = A @ x - b
        rz = G @ x + s - h
        gap = float(s @ z)
        mu = gap / nu

        pcost = 0.5 * x @ (P @ x) + c @ x
        dcost = pcost + (y @ ry if p else 0.0) + z @ rz - gap
        if pcost < 0:
            relgap = gap / -pcost
        elif dcost > 0:
            relgap = gap / dcost
        else:
            relgap = np.inf
        pres = max(
            np.linalg.norm(ry) / max(1.0, np.linalg.norm(b)),
            np.linalg.norm(rz) / max(1.0, np.linalg.norm(h)),
        )
        dres = np.linalg.norm(rx) / max(1.0, np.linalg.norm(c))

        iters_log.append((it, pcost, dcost, gap, pres, dres))
        if verbose:
            print(
                f"{it:3d} pcost={pcost:+.6e} dcost={dcost:+.6e} "
                f"gap={gap:.3e} pres={pres:.3e} dres={dres:.3e}"
            )

        if pres <= feastol and dres <= feastol and (gap <= abstol or relgap <= reltol):
            status = OPTIMAL
            break

        # Infeasibility certificates (no homogeneous embedding; residual tests
        # on the diverging iterates, Farkas-style).
        # Primal infeasible: exists (y, z), z in K*, A'y + G'z = 0, b'y + h'z < 0.
        hz_by = h @ z + (b @ y if p else 0.0)
        if hz_by < 0:
            cert = np.linalg.norm(A.T @ y + G.T @ z) / (-hz_by)
            if cert <= feastol:
                status = PRIMAL_INFEASIBLE
                break
        # Dual infeasible (primal unbounded): exists x, Ax = 0, Gx + s = 0
        # with s in K, c'x < 0.
        cx = c @ x
        if cx < 0:
            cert = max(
                np.linalg.norm(A @ x),
                np.linalg.norm(G @ x + s),
                np.linalg.norm(P @ x),
            ) / (-cx)
            if cert <= feastol:
                status = DUAL_INFEASIBLE
                break
        if not all(np.all(np.isfinite(v)) for v in (x, y, s, z)):
            status = NUMERICAL_ERROR
            break

        # NT scaling and KKT factorization (the solver's hot path).
        try:
            with np.errstate(invalid="raise", divide="raise"):
                scaling = NTScaling(dims, s, z)
                kkt = KKT(P, A, G, scaling, dims)
        except (np.linalg.LinAlgError, ValueError, FloatingPointError):
            status = NUMERICAL_ERROR
            break
        lam = scaling.lam

        def newton(d_s):
            """Solve the Newton system for a given complementarity target d_s.

            Returns (dx, dy, dz, ds_scaled, dz_scaled) with
            ds = W ds_scaled, dz_scaled = W dz.
            """
            dtil = jdiv(dims, lam, d_s)
            dx, dy, dz = kkt.solve(-rx, -ry, -rz + scaling.apply_W(dtil))
            dz_sc = scaling.apply_W(dz)
            ds_sc = -(dtil + dz_sc)
            return dx, dy, dz, ds_sc, dz_sc

        # Affine (predictor) direction: d_s = lam o lam.
        dx_a, dy_a, dz_a, ds_sc_a, dz_sc_a = newton(jprod(dims, lam, lam))
        alpha_a = min(
            max_step(dims, lam, ds_sc_a), max_step(dims, lam, dz_sc_a), np.inf
        )
        alpha_a = min(1.0, alpha_a)
        gap_a = (lam + alpha_a * ds_sc_a) @ (lam + alpha_a * dz_sc_a)
        sigma = max(0.0, min(1.0, gap_a / gap)) ** 3

        # Combined (corrector) direction with second-order correction.
        d_s = (
            jprod(dims, lam, lam)
            + jprod(dims, ds_sc_a, dz_sc_a)
            - sigma * mu * e
        )
        dx, dy, dz, ds_sc, dz_sc = newton(d_s)
        ds = scaling.apply_W(ds_sc)

        alpha = min(max_step(dims, lam, ds_sc), max_step(dims, lam, dz_sc))
        alpha = min(1.0, step_frac * alpha)
        if not np.isfinite(alpha) or alpha <= 0:
            status = NUMERICAL_ERROR
            break

        x = x + alpha * dx
        y = y + alpha * dy
        z = z + alpha * dz
        s = s + alpha * ds
    else:
        niter = max_iter

    return {
        "x": x,
        "y": y,
        "s": s,
        "z": z,
        "status": status,
        "status_name": STATUS_NAMES[status],
        # number of steps applied (= KKT factorizations - 1 when converged;
        # matches the solver's convention)
        "iterations": niter,
        "gap": float(s @ z),
        "pcost": float(0.5 * x @ (P @ x) + c @ x),
        "pres": float(
            max(
                np.linalg.norm(A @ x - b) / max(1.0, np.linalg.norm(b)),
                np.linalg.norm(G @ x + s - h) / max(1.0, np.linalg.norm(h)),
            )
        ),
        "dres": float(
            np.linalg.norm(P @ x + A.T @ y + G.T @ z + c) / max(1.0, np.linalg.norm(c))
        ),
        "log": iters_log,
    }
