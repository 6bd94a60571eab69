"""Batched lockstep IPM driver — the port of `socp_tpu/ipm/driver.py`.

The reference runs one instance's `lax.while_loop` under `jax.vmap`.  A
vmapped while-loop runs the body on every lane and keeps, on each lane
whose condition is false, its WHOLE state from before the body.  The port
writes that out over a leading batch dim:

    active = ~done & (k < max_iter)        # per instance, (B,)
    while active.any():                    # the one host sync per iteration
        new = body(state)
        state = where(active, new, state)  # field by field

so a lane that finished, or that reached `max_iter` without finishing,
keeps its state bit for bit and exits as the reference's lane does.  The
body computes every lane, frozen ones included; a frozen lane's factor may
be NaN, and nothing in the body mixes lanes, so that NaN stays in its lane
and is discarded by the select.  Per-lane conditional arithmetic is
`torch.where`, never a Python branch.

Kernel launches per body (p = 0): one Cholesky and three triangular-pair
solves (affine solve unrefined, combined solve + one refinement solve);
the W = I initialization adds one Cholesky and four pair solves.  They are
the f64 kernels, or the f32 ones under `factor_dtype="float32"` (the f32
factor under f64 refinement, kkt/dense.py); the carries are f64 either way.

KKT route: by default kkt/dense.py, the port of the reference's
`ipm/driver.py` + `kkt/dense.py` (Ghat = W^-1 G every iteration).  Under
`native_dd=True` the structured assembly of kkt/structured.py, the port of
what the reference's `ipm/dd_driver.solve_core_dd` runs (`factor_dd`,
`solve_refined_dd`, `precompute_const_gram` once per solve), in f64; the
rest of the loop is the same code.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from socp_tpu_torch.cones import ops as cops
from socp_tpu_torch.cones.layout import ConeLayout
from socp_tpu_torch.config import SolverConfig
from socp_tpu_torch.kkt import dense, structured
from socp_tpu_torch.kkt.dense import _dot, _mtv, _mv
from socp_tpu_torch.parallel import collectives
from socp_tpu_torch.solution import Status

# SolverConfig.factor_dtype -> the dtype of the KKT factor and back-solves.
# "dd32" (the reference's double-word f32 factor) and "float64" map onto
# the f64 path, as None does (config.py).
FACTOR_DTYPES = {None: torch.float64, "dd32": torch.float64,
                 "float64": torch.float64, "float32": torch.float32}


class IPMState(NamedTuple):
    x: torch.Tensor           # (B, n)
    y: torch.Tensor           # (B, p)
    s: torch.Tensor           # (B, m_pad)
    z: torch.Tensor           # (B, m_pad)
    k: torch.Tensor           # (B,) int32, completed body executions
    status: torch.Tensor      # (B,) int32, RUNNING while iterating
    done: torch.Tensor        # (B,) bool
    # best-merit iterate seen so far (restored on non-optimal exit)
    best_merit: torch.Tensor  # (B,)
    bx: torch.Tensor
    by: torch.Tensor
    bs: torch.Tensor
    bz_: torch.Tensor
    hist: torch.Tensor        # (B, max_iter, 6) with collect_history, else (B, 0, 6)


def _norm(v: torch.Tensor) -> torch.Tensor:
    """Per-instance 2-norm of (B, r); 0 for r = 0."""
    if v.shape[-1] == 0:
        return v.new_zeros(v.shape[0])
    return torch.linalg.vector_norm(v, dim=-1)


def _where(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """torch.where with a per-instance (B,) mask broadcast over a's dims."""
    return torch.where(mask.view(mask.shape + (1,) * (a.ndim - 1)), a, b)


def solve_core(
    layout: ConeLayout,
    cfg: SolverConfig,
    c: torch.Tensor,        # (B, n)
    G: torch.Tensor,        # (B, m_pad, n)
    h: torch.Tensor,        # (B, m_pad)
    A: torch.Tensor,        # (B, p, n)
    b: torch.Tensor,        # (B, p)
    P: torch.Tensor,        # (B, n, n); ignored unless has_P
    has_P: bool = False,
    warm: tuple | None = None,
    group=None,
):
    """Solve B padded SOCPs in lockstep.  All tensors on one device, f64.

    `warm`: optional (x, y, s, z) per-instance padded start — skips the W = I
    init solves and recenters s, z by cfg.warm_push.

    `group`: the process group whose ranks hold the other slices of a
    sharded batch (parallel/batch.py).  The loop then runs while any
    instance of any rank is active: the condition is reduced over the
    ranks (`collectives.pany`) before the loop's one host read, as the
    reference's sharded while-loop reduces its predicate.

    Returns (x, y, s, z, status, iterations, stats, hist) with stats (B, 7)
    = [pcost, dcost, gap, relgap, pres, dres, inaccurate_flag].
    """
    B, n = c.shape
    p = A.shape[1]
    m = layout.m_pad
    dtype, device = c.dtype, c.device
    fdt = FACTOR_DTYPES[cfg.factor_dtype]
    nu = float(layout.degree)
    e = cops.identity(layout, B, dtype, device)
    Pmat = P if has_P else None

    norm_b = torch.clamp_min(_norm(b), 1.0)
    norm_h = torch.clamp_min(_norm(h), 1.0)
    norm_c = torch.clamp_min(_norm(c), 1.0)

    aug_rho = cfg.aug_rho if p else 0.0
    if aug_rho:
        Paug = aug_rho * (A.transpose(1, 2) @ A)
        if has_P:
            Paug = Paug + P
    else:
        Paug = Pmat

    def residuals(x, y, s, z):
        Px = _mv(P, x) if has_P else None
        rx = _mtv(A, y) + _mtv(G, z) + c
        if has_P:
            rx = rx + Px
        ry = _mv(A, x) - b
        rz = _mv(G, x) + s - h
        return rx, ry, rz, Px

    def metrics(x, y, s, z, rx, ry, rz, Px):
        gap = _dot(s, z)
        pcost = _dot(c, x)
        if has_P:
            pcost = pcost + 0.5 * _dot(x, Px)
        dcost = pcost + _dot(y, ry) + _dot(z, rz) - gap
        inf = torch.full_like(gap, torch.inf)
        relgap = torch.where(
            pcost < 0, gap / -pcost, torch.where(dcost > 0, gap / dcost, inf)
        )
        pres = torch.maximum(_norm(ry) / norm_b, _norm(rz) / norm_h)
        dres = _norm(rx) / norm_c
        return gap, pcost, dcost, relgap, pres, dres

    # native_dd: the structured assembly (kkt/structured.py), its constant
    # Grams computed once per solve, before the initialization factor
    cg = structured.precompute_const_gram(layout, G) if cfg.native_dd else None

    def factor(scaling):
        if cfg.native_dd:
            return structured.factor(layout, scaling, Paug, A, G,
                                     cfg.delta_reg, cg=cg)
        return dense.factor(layout, scaling, Paug, A, G, cfg.delta_reg,
                            factor_dtype=fdt)

    def refined(kkt, bx, by, bz, steps=None):
        kkt_mod = structured if cfg.native_dd else dense
        return kkt_mod.solve_refined(
            layout, kkt, Pmat, A, G, bx, by, bz,
            refine_steps=cfg.refine_steps if steps is None else steps,
            aug_rho=aug_rho,
        )

    def hz_by(z, y):
        return _dot(h, z) + (_dot(y, b) if p else 0.0)

    # ---- initialization: warm start or W = I least-squares solves + shift
    if warm is not None:
        xw, yw, sw, zw = (torch.as_tensor(w, dtype=dtype, device=device)
                          for w in warm)
        x0, y0 = xw, yw
        scale = 0.5 * (sw.abs().mean(dim=1) + zw.abs().mean(dim=1)) + 1e-8
        margin = cfg.warm_push * scale
        s0 = sw + torch.clamp_min(margin - cops.lambda_min(layout, sw), 0.0)[:, None] * e
        z0 = zw + torch.clamp_min(margin - cops.lambda_min(layout, zw), 0.0)[:, None] * e
    else:
        sc0 = cops.identity_scaling(layout, B, dtype, device)
        kkt0 = factor(sc0)
        x0, _, z0, _ = refined(kkt0, c.new_zeros((B, n)), b, h)
        shat = -z0
        ap = -cops.lambda_min(layout, shat)
        s0 = _where(ap < 0, shat, shat + (1.0 + ap)[:, None] * e)
        _, y0, zhat, _ = refined(kkt0, -c, c.new_zeros((B, p)),
                                 c.new_zeros((B, m)))
        ad = -cops.lambda_min(layout, zhat)
        z0 = _where(ad < 0, zhat, zhat + (1.0 + ad)[:, None] * e)

    n_hist = cfg.max_iter if cfg.collect_history else 0
    st = IPMState(
        x=x0, y=y0, s=s0, z=z0,
        k=torch.zeros(B, dtype=torch.int32, device=device),
        status=torch.full((B,), int(Status.RUNNING), dtype=torch.int32,
                          device=device),
        done=torch.zeros(B, dtype=torch.bool, device=device),
        best_merit=torch.full((B,), torch.inf, dtype=dtype, device=device),
        bx=x0, by=y0, bs=s0, bz_=z0,
        hist=torch.zeros((B, n_hist, 6), dtype=dtype, device=device),
    )

    def body(st: IPMState) -> IPMState:
        x, y, s, z = st.x, st.y, st.s, st.z
        rx, ry, rz, Px = residuals(x, y, s, z)
        gap, pcost, dcost, relgap, pres, dres = metrics(x, y, s, z, rx, ry, rz, Px)
        mu = gap / nu
        converged = (
            (pres <= cfg.feastol)
            & (dres <= cfg.feastol)
            & ((gap <= cfg.abstol) | (relgap <= cfg.reltol))
        )

        # best-iterate tracking (merit: worst normalized optimality measure)
        merit = torch.maximum(torch.maximum(pres, dres),
                              torch.minimum(relgap, gap))
        better = (merit < st.best_merit) & ~st.done
        best_merit = torch.where(better, merit, st.best_merit)
        bx = _where(better, x, st.bx)
        by = _where(better, y, st.by)
        bs = _where(better, s, st.bs)
        bz_ = _where(better, z, st.bz_)

        # Farkas-style infeasibility certificates read off the residuals
        hzby = hz_by(z, y)
        pinf_vec = rx - c - Px if has_P else rx - c
        pinf = (hzby < 0) & (_norm(pinf_vec) <= cfg.feastol * -hzby)
        cx = _dot(c, x)
        dinf_res = torch.maximum(_norm(ry + b), _norm(rz + h))
        if has_P:
            dinf_res = torch.maximum(dinf_res, _norm(Px))
        dinf = (cx < 0) & (dinf_res <= cfg.feastol * -cx)

        # ---- NT scaling + KKT factor (the hot block)
        scaling = cops.nt_scale(layout, s, z)
        kkt = factor(scaling)
        lam = scaling.lam

        def newton(d_s, steps=None):
            dtil = cops.jdiv(layout, lam, d_s)
            dx, dy, dz, quality = refined(
                kkt, -rx, -ry, -rz + cops.apply_W(layout, scaling, dtil),
                steps=steps,
            )
            dz_sc = cops.apply_W(layout, scaling, dz)
            ds_sc = -(dtil + dz_sc)
            return dx, dy, dz, ds_sc, dz_sc, quality

        # affine (predictor)
        lam2 = cops.jprod(layout, lam, lam)
        _, _, _, ds_sc_a, dz_sc_a, _ = newton(lam2, steps=cfg.refine_affine)
        alpha_a = torch.minimum(cops.max_step(layout, lam, ds_sc_a),
                                cops.max_step(layout, lam, dz_sc_a))
        alpha_a = torch.clamp_max(alpha_a, 1.0)[:, None]
        gap_a = _dot(lam + alpha_a * ds_sc_a, lam + alpha_a * dz_sc_a)
        sigma = torch.clamp(gap_a / gap, 0.0, 1.0) ** 3

        # combined (corrector) with second-order term
        d_s = (lam2 + cops.jprod(layout, ds_sc_a, dz_sc_a)
               - (sigma * mu)[:, None] * e)
        dx, dy, dz, ds_sc, dz_sc, quality = newton(d_s)
        alpha = torch.minimum(cops.max_step(layout, lam, ds_sc),
                              cops.max_step(layout, lam, dz_sc))
        alpha = torch.clamp_max(cfg.step_frac * alpha, 1.0)

        # ---- Gondzio centrality correctors (0 at the resolved default)
        for _ in range(cfg.gondzio_correctors or 0):
            mu_t = sigma * mu
            a_hat = torch.clamp_max(alpha / cfg.step_frac + 0.1, 1.0)[:, None]
            vprod = cops.jprod(layout, lam + a_hat * ds_sc, lam + a_hat * dz_sc)
            t = cops.eig_clip_delta(layout, vprod, 0.1 * mu_t, 10.0 * mu_t)
            dtil_c = cops.jdiv(layout, lam, -t)
            rhs_zc = cops.apply_W(layout, scaling, dtil_c)
            dxc, dyc, dzc, _ = refined(kkt, c.new_zeros((B, n)),
                                       c.new_zeros((B, p)), rhs_zc, steps=0)
            dz_sc_c = cops.apply_W(layout, scaling, dzc)
            ds_sc_c = -(dtil_c + dz_sc_c)
            c_ds_sc = ds_sc + ds_sc_c
            c_dz_sc = dz_sc + dz_sc_c
            alpha_c = torch.minimum(cops.max_step(layout, lam, c_ds_sc),
                                    cops.max_step(layout, lam, c_dz_sc))
            alpha_c = torch.clamp_max(cfg.step_frac * alpha_c, 1.0)
            accept = alpha_c >= alpha + 0.01
            dx = _where(accept, dx + dxc, dx)
            dy = _where(accept, dy + dyc, dy)
            dz = _where(accept, dz + dzc, dz)
            ds_sc = _where(accept, c_ds_sc, ds_sc)
            dz_sc = _where(accept, c_dz_sc, dz_sc)
            alpha = torch.where(accept, alpha_c, alpha)

        ds = cops.apply_W(layout, scaling, ds_sc)

        step_finite = (
            torch.isfinite(alpha)
            & (alpha > 0)
            & torch.isfinite(_dot(dx, dx))
            & torch.isfinite(_dot(ds, ds))
            & torch.isfinite(_dot(dz, dz))
        )
        stalled = quality > cfg.solve_quality_tol
        numerr = ~step_finite | ~torch.isfinite(gap) | stalled

        # priority: converged > primal cert > dual cert > numerical error
        new_status = torch.full_like(st.status, int(Status.RUNNING))
        for flag, code in ((numerr, Status.NUMERICAL_ERROR),
                           (dinf, Status.DUAL_INFEASIBLE),
                           (pinf, Status.PRIMAL_INFEASIBLE),
                           (converged, Status.OPTIMAL)):
            new_status = torch.where(flag, int(code), new_status)
        done_now = new_status != int(Status.RUNNING)
        freeze = st.done | done_now

        if cfg.verbose:
            _print_rows(st.k, pcost, dcost, gap, pres, dres, alpha, quality,
                        ~st.done & (st.k < cfg.max_iter))

        def upd(old, delta):
            return _where(freeze, old, old + alpha[:, None] * delta)

        hist = st.hist
        if cfg.collect_history:
            row = torch.stack([pcost, dcost, gap, pres, dres,
                               torch.where(freeze, torch.zeros_like(alpha),
                                           alpha)], dim=1)
            idx = st.k.clamp_max(n_hist - 1).long()
            written = hist.clone()
            written[torch.arange(B, device=device), idx] = row
            hist = _where(st.done, hist, written)

        return IPMState(
            x=upd(x, dx),
            y=upd(y, dy),
            z=upd(z, dz),
            s=upd(s, ds),
            k=torch.where(freeze, st.k, st.k + 1),
            status=torch.where(st.done, st.status, new_status),
            done=freeze,
            best_merit=best_merit,
            bx=bx, by=by, bs=bs, bz_=bz_,
            hist=hist,
        )

    # the vmapped while-loop, written out (module doc)
    while True:
        active = ~st.done & (st.k < cfg.max_iter)
        if not bool(collectives.pany(active.any(), group)):
            break
        new = body(st)
        st = IPMState(*(_where(active, a, o) for a, o in zip(new, st)))

    status = torch.where(st.done, st.status, int(Status.MAX_ITERATIONS))

    # ---- best-iterate restoration + inaccurate acceptance
    restore = ((status == int(Status.NUMERICAL_ERROR))
               | (status == int(Status.MAX_ITERATIONS)))

    # relaxed exit certificates on the FINAL iterate (see the reference)
    rxf, ryf, rzf, Pxf = residuals(st.x, st.y, st.s, st.z)
    hz_by_f = hz_by(st.z, st.y)
    pvec_f = rxf - c - Pxf if has_P else rxf - c
    pinf_exit = restore & (hz_by_f < 0) & (
        _norm(pvec_f) <= cfg.feastol_inacc * -hz_by_f
    )
    cx_f = _dot(c, st.x)
    dres_f = torch.maximum(_norm(ryf + b), _norm(rzf + h))
    if has_P:
        dres_f = torch.maximum(dres_f, _norm(Pxf))
    dinf_exit = restore & (cx_f < 0) & (dres_f <= cfg.feastol_inacc * -cx_f)

    x = _where(restore, st.bx, st.x)
    y = _where(restore, st.by, st.y)
    s = _where(restore, st.bs, st.s)
    z = _where(restore, st.bz_, st.z)

    rx, ry, rz, Px = residuals(x, y, s, z)
    gap, pcost, dcost, relgap, pres, dres = metrics(x, y, s, z, rx, ry, rz, Px)
    inacc_ok = (
        (pres <= cfg.feastol_inacc)
        & (dres <= cfg.feastol_inacc)
        & ((gap <= cfg.abstol_inacc) | (relgap <= cfg.reltol_inacc))
    )
    # priority: relaxed-optimal > primal cert > dual cert > raw exit status
    cert = ~inacc_ok & (pinf_exit | dinf_exit)
    x = _where(cert, st.x, x)
    y = _where(cert, st.y, y)
    s = _where(cert, st.s, s)
    z = _where(cert, st.z, z)
    status = torch.where(
        restore & inacc_ok, int(Status.OPTIMAL),
        torch.where(
            pinf_exit & ~inacc_ok, int(Status.PRIMAL_INFEASIBLE),
            torch.where(dinf_exit & ~inacc_ok & ~pinf_exit,
                        int(Status.DUAL_INFEASIBLE), status),
        ),
    ).to(torch.int32)
    inaccurate = restore & inacc_ok

    stats = torch.stack([pcost, dcost, gap, relgap, pres, dres,
                         inaccurate.to(dtype)], dim=1)
    return x, y, s, z, status, st.k, stats, st.hist


def _print_rows(k, pcost, dcost, gap, pres, dres, alpha, quality, active):
    """The reference's per-iteration line, one per active instance (host)."""
    cols = torch.stack([k.to(pcost.dtype), pcost, dcost, gap, pres, dres,
                        alpha, quality], dim=1)[active].cpu().tolist()
    for kk, pc, dc, g, pr, dr, a, q in cols:
        print(f"{int(kk):3d} pcost={pc:+.6e} dcost={dc:+.6e} gap={g:.3e} "
              f"pres={pr:.3e} dres={dr:.3e} step={a:.3f} kktres={q:.1e}")
