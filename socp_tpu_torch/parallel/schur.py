"""Block-partitioned KKT with the Schur reduction of the coupling rows, on
one device or with the blocks sharded over the ranks of a mesh: the port
of `socp_tpu/parallel/schur.py`.

Problem class: K structurally identical blocks coupled only through p
shared equality constraints,

    minimize    sum_i [ (1/2) x_i' P_i x_i + c_i' x_i ]
    subject to  sum_i A_i x_i = b                      (coupling)
                G_i x_i + s_i = h_i,  s_i in K_b        (per-block cones)

(BASELINE config 4: K = 10,240 blocks of nb = 10 vars, block cone
R+^4 x Q^6, p = 8: 102,400 vars.)  The condensed KKT is block-diagonal
H_i = P_i + Ghat_i'Ghat_i plus the p x p Schur complement of the coupling
rows, S = sum_i A_i H_i^-1 A_i'.

The blocks are the leading axis of every tensor, so the cone functions of
cones/ops.py (batched over a leading axis) sweep all blocks at once and
the kernel routers (ops/chol.py) see one batch of K blocks:

  * H's factor: `kkt.dense._eq_chol` on (K, nb, nb) -> `chol_batched`;
  * H^-1 A': `EqChol.solve` on (K, nb, p) -> `tri_pair_batched`, k = p;
  * S: one einsum over the blocks (a GEMM, which the reference leaves to
    XLA), then `_eq_chol(S[None])` -> `chol_single`;
  * each unrefined back-solve: two `tri_pair_batched` (k = 1) on the
    blocks and one `tri_pair_single` (p x 1) for dy.

Launches, at the default refine_steps = 1: the W = I initialization and
every loop body each make 1 chol_batched, 1 chol_single, 9
tri_pair_batched (H^-1 A', then 2 for each of the four unrefined solves of
two refined ones) and 4 tri_pair_single; a Gondzio corrector adds 2 + 1.

Unlike the batched driver (ipm/driver.py), where each instance has its own
step, every scalar here is global over the blocks, as the reference's
psum / pmin make it: the step, mu, the norms, the stop flags, the
refinement quality, the Gondzio band.  With `mesh=` the K blocks are split
over the ranks (K / N each, contiguous) and those reductions are the
collectives of parallel/collectives.py over the mesh's group: `psum` for
every sum over blocks, `pmin` for the steps and the interior shifts, and
for S, the one large collective a factor, `psum` or, with
`SolverConfig.ring_schur`, `ring_allreduce` (4 chunks of its last axis).
Every such value is then the same bits on every rank, and so is every
branch taken from it.  Without a mesh they are the identity (one device),
and `ring_schur` changes nothing.  The loop syncs with the host once an
iteration, on its condition (a replicated value: no collective of its
own), as the batched driver's does.

Config, as the reference's block path resolves it off the TPU:
`gondzio_correctors=None` is 0.  `factor_dtype` is ignored: the
reference's "dd32" block factor emulates f64 in double-word f32, which
the card has natively, and its block path factors in f64 for any other
value (there is no f32 block factor).  `native_dd` is ignored too, as the
reference's block path never reads it.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from socp_tpu_torch.api import _put, resolve_device, resolve_dtype
from socp_tpu_torch.cones import ops as cops
from socp_tpu_torch.cones.layout import ConeLayout, make_layout
from socp_tpu_torch.config import DEFAULT_CONFIG, SolverConfig
from socp_tpu_torch.kkt.dense import EqChol, _eq_chol, _mtv, _mv
from socp_tpu_torch.parallel import collectives as coll
from socp_tpu_torch.parallel.mesh import mesh_group, shard_index
from socp_tpu_torch.problem import ConeDims
from socp_tpu_torch.solution import Status


@dataclasses.dataclass
class BlockSocpProblem:
    """K identical-shape blocks + p coupling equalities (host-side NumPy)."""

    c: np.ndarray            # (K, nb)
    G: np.ndarray            # (K, mb, nb)
    h: np.ndarray            # (K, mb)
    block_dims: ConeDims     # cone of ONE block (dim == mb)
    A: np.ndarray            # (K, p, nb) coupling: sum_i A_i x_i = b
    b: np.ndarray            # (p,)
    P: Optional[np.ndarray] = None   # (K, nb, nb)

    def __post_init__(self):
        K, nb = self.c.shape
        assert self.G.shape == (K, self.block_dims.dim, nb)
        assert self.h.shape == (K, self.block_dims.dim)
        assert self.A.shape[0] == K and self.A.shape[2] == nb
        assert self.b.shape == (self.A.shape[1],)

    @property
    def n_blocks(self) -> int:
        return self.c.shape[0]


class BlockState(NamedTuple):
    x: torch.Tensor           # (K, nb)
    y: torch.Tensor           # (p,)
    s: torch.Tensor           # (K, m_pad)
    z: torch.Tensor           # (K, m_pad)
    k: torch.Tensor           # () int32
    status: torch.Tensor      # () int32
    done: torch.Tensor        # () bool
    # best-merit iterate (restored on a non-optimal exit)
    best_merit: torch.Tensor
    bx: torch.Tensor
    by: torch.Tensor
    bs: torch.Tensor
    bz_: torch.Tensor
    hist: torch.Tensor        # (max_iter, 6) with collect_history, else (0, 6)


class Factored(NamedTuple):
    LH: EqChol                # (K, nb, nb) block factors
    LS: EqChol                # (1, p, p) Schur factor
    Ghat: torch.Tensor        # (K, m_pad, nb) = W^-1 G
    scaling: cops.Scaling


def _sumsq(v: torch.Tensor) -> torch.Tensor:
    return torch.sum(v * v)


def _core(layout: ConeLayout, cfg: SolverConfig, has_P: bool, c, G, h, A, b,
          Pq, group=None, K_total=None):
    """The block IPM on padded tensors of this rank's blocks: c (K, nb),
    G (K, m_pad, nb), h (K, m_pad), A (K, p, nb), b (p,) replicated, Pq
    (K, nb, nb) or None.  `group`: the process group the blocks are
    sharded over (None: one device, every collective the identity);
    `K_total` the block count over all ranks.  Returns (x, y, s, z,
    status, k, stats, hist) as tensors, x, s and z this rank's blocks."""
    dtype, device = c.dtype, c.device
    K, nb = c.shape
    p = b.shape[0]
    m = layout.m_pad

    def psum(v):
        return coll.psum(v, group)

    def schur_reduce(S):
        """The one large collective a factor: the sum of the ranks' (p, p)
        Schur contributions, by the ring or by one all-reduce."""
        if cfg.ring_schur and group is not None:
            return coll.ring_allreduce(S, group,
                                       n_chunks=min(4, max(S.shape[-1], 1)))
        return psum(S)

    def A_T(v):
        """A_i' v per block: (p,) -> (K, nb)."""
        return torch.einsum("kpn,p->kn", A, v)

    def A_sum(v):
        """sum_i A_i v_i: (K, nb) -> (p,)."""
        return torch.einsum("kpn,kn->p", A, v)

    def step(u, du):
        """The global max step: the least over the blocks."""
        return coll.pmin(torch.amin(cops.max_step(layout, u, du)), group)

    def gnorm(v):
        """The 2-norm of a replicated vector."""
        return torch.sqrt(_sumsq(v))

    def bnorm(v):
        """The 2-norm over all blocks of a blocked (K, ...) tensor."""
        return torch.sqrt(psum(_sumsq(v)))

    e = cops.identity(layout, K, dtype, device)
    nu_total = float(layout.degree) * (K if K_total is None else K_total)
    inf = torch.tensor(torch.inf, dtype=dtype, device=device)

    norm_b = torch.clamp_min(gnorm(b), 1.0)
    norm_h = torch.clamp_min(bnorm(h), 1.0)
    norm_c = torch.clamp_min(bnorm(c), 1.0)

    def quad(x):
        if not has_P:
            return 0.0
        return 0.5 * psum(torch.sum(x * _mv(Pq, x)))

    def factor(scaling):
        Ghat = cops.scale_rows_Winv(layout, scaling, G)
        H = Ghat.transpose(1, 2) @ Ghat
        if has_P:
            H = H + Pq
        LH = _eq_chol(H, cfg.delta_reg)
        HinvAT = LH.solve(A.transpose(1, 2))                 # (K, nb, p)
        S = schur_reduce(torch.einsum("kpn,knq->pq", A, HinvAT))
        LS = _eq_chol(S[None], cfg.delta_reg)
        return Factored(LH=LH, LS=LS, Ghat=Ghat, scaling=scaling)

    def kkt_solve_once(f: Factored, bx, by, bz):
        """bx (K, nb), by (p,), bz (K, m_pad)."""
        bhz = cops.apply_Winv(layout, f.scaling, bz)
        btx = bx + _mtv(f.Ghat, bhz)
        t = f.LH.solve(btx)
        dy = f.LS.solve((psum(A_sum(t)) - by)[None])[0]
        dx = f.LH.solve(btx - A_T(dy))
        dz = cops.apply_Winv(layout, f.scaling, _mv(f.Ghat, dx) - bhz)
        return dx, dy, dz

    def kkt_solve(f: Factored, bx, by, bz):
        """Solve + iterative refinement on the block 3x3 residual.  Returns
        the relative residual before the last correction, `quality`, the
        stall signal (0 without refinement)."""
        dx, dy, dz = kkt_solve_once(f, bx, by, bz)
        quality = torch.zeros((), dtype=dtype, device=device)
        if cfg.refine_steps <= 0:
            return dx, dy, dz, quality
        rhs_norm = torch.sqrt(psum(_sumsq(bx) + _sumsq(bz)) + _sumsq(by)) + 1.0
        for _ in range(cfg.refine_steps):
            rx = bx - (A_T(dy) + _mtv(G, dz))
            if has_P:
                rx = rx - _mv(Pq, dx)
            ry = by - psum(A_sum(dx))
            WWdz = cops.apply_W(layout, f.scaling,
                                cops.apply_W(layout, f.scaling, dz))
            rz = bz - (_mv(G, dx) - WWdz)
            quality = torch.sqrt(psum(_sumsq(rx) + _sumsq(rz))
                                 + _sumsq(ry)) / rhs_norm
            ex, ey, ez = kkt_solve_once(f, rx, ry, rz)
            dx, dy, dz = dx + ex, dy + ey, dz + ez
        return dx, dy, dz, quality

    def residuals(x, y, s, z):
        rx = A_T(y) + _mtv(G, z) + c
        if has_P:
            rx = rx + _mv(Pq, x)
        ry = psum(A_sum(x)) - b
        rz = _mv(G, x) + s - h
        return rx, ry, rz

    def metrics(x, y, s, z, rx, ry, rz):
        gap = psum(torch.sum(s * z))
        pcost = psum(torch.sum(c * x)) + quad(x)
        dcost = pcost + y @ ry + psum(torch.sum(z * rz)) - gap
        relgap = torch.where(pcost < 0, gap / -pcost,
                             torch.where(dcost > 0, gap / dcost, inf))
        pres = torch.maximum(gnorm(ry) / norm_b, bnorm(rz) / norm_h)
        dres = bnorm(rx) / norm_c
        return gap, pcost, dcost, relgap, pres, dres

    def aty_gtz(x, rx):
        """A'y + G'z read off the dual residual."""
        v = rx - c
        return v - _mv(Pq, x) if has_P else v

    # ---- init (W = I)
    f0 = factor(cops.identity_scaling(layout, K, dtype, device))
    x0, _, z0, _ = kkt_solve(f0, c.new_zeros((K, nb)), b, h)
    shat = -z0
    ap = -coll.pmin(torch.amin(cops.lambda_min(layout, shat)), group)
    s0 = torch.where(ap < 0, shat, shat + (1.0 + ap) * e)
    _, y0, zhat, _ = kkt_solve(f0, -c, c.new_zeros(p), c.new_zeros((K, m)))
    ad = -coll.pmin(torch.amin(cops.lambda_min(layout, zhat)), group)
    z0 = torch.where(ad < 0, zhat, zhat + (1.0 + ad) * e)

    n_hist = cfg.max_iter if cfg.collect_history else 0
    st = BlockState(
        x=x0, y=y0, s=s0, z=z0,
        k=torch.zeros((), dtype=torch.int32, device=device),
        status=torch.full((), int(Status.RUNNING), dtype=torch.int32,
                          device=device),
        done=torch.zeros((), dtype=torch.bool, device=device),
        best_merit=inf,
        bx=x0, by=y0, bs=s0, bz_=z0,
        hist=torch.zeros((n_hist, 6), dtype=dtype, device=device),
    )

    def body(st: BlockState) -> BlockState:
        x, y, s, z = st.x, st.y, st.s, st.z
        rx, ry, rz = residuals(x, y, s, z)
        gap, pcost, dcost, relgap, pres, dres = metrics(x, y, s, z, rx, ry, rz)
        mu = gap / nu_total
        converged = (
            (pres <= cfg.feastol)
            & (dres <= cfg.feastol)
            & ((gap <= cfg.abstol) | (relgap <= cfg.reltol))
        )

        merit = torch.maximum(torch.maximum(pres, dres),
                              torch.minimum(relgap, gap))
        better = (merit < st.best_merit) & ~st.done
        best_merit = torch.where(better, merit, st.best_merit)
        bx = torch.where(better, x, st.bx)
        by = torch.where(better, y, st.by)
        bs = torch.where(better, s, st.bs)
        bz_ = torch.where(better, z, st.bz_)

        # Farkas certificates read off the residuals
        hz_by = psum(torch.sum(h * z)) + y @ b
        pinf = (hz_by < 0) & (bnorm(aty_gtz(x, rx)) <= cfg.feastol * -hz_by)
        cx = psum(torch.sum(c * x))
        dinf_res = torch.maximum(gnorm(ry + b), bnorm(rz + h))
        dinf = (cx < 0) & (dinf_res <= cfg.feastol * -cx)

        scaling = cops.nt_scale(layout, s, z)
        fac = factor(scaling)
        lam = scaling.lam                                   # (K, m_pad)

        def newton(d_s):
            dtil = cops.jdiv(layout, lam, d_s)
            dx, dy, dz, quality = kkt_solve(
                fac, -rx, -ry, -rz + cops.apply_W(layout, scaling, dtil))
            dz_sc = cops.apply_W(layout, scaling, dz)
            ds_sc = -(dtil + dz_sc)
            return dx, dy, dz, ds_sc, dz_sc, quality

        lam2 = cops.jprod(layout, lam, lam)
        _, _, _, ds_sc_a, dz_sc_a, _ = newton(lam2)
        alpha_a = torch.clamp_max(
            torch.minimum(step(lam, ds_sc_a), step(lam, dz_sc_a)), 1.0)
        gap_a = psum(torch.sum((lam + alpha_a * ds_sc_a)
                               * (lam + alpha_a * dz_sc_a)))
        sigma = torch.clamp(gap_a / gap, 0.0, 1.0) ** 3

        d_s = lam2 + cops.jprod(layout, ds_sc_a, dz_sc_a) - sigma * mu * e
        dx, dy, dz, ds_sc, dz_sc, quality = newton(d_s)
        alpha = torch.clamp_max(
            cfg.step_frac * torch.minimum(step(lam, ds_sc), step(lam, dz_sc)),
            1.0)

        # ---- Gondzio centrality correctors: one unrefined solve each
        # (the factors are reused), accepted only if the global step
        # lengthens
        for _ in range(cfg.gondzio_correctors or 0):
            mu_t = sigma * mu
            a_hat = torch.clamp_max(alpha / cfg.step_frac + 0.1, 1.0)
            vprod = cops.jprod(layout, lam + a_hat * ds_sc, lam + a_hat * dz_sc)
            t = cops.eig_clip_delta(layout, vprod, (0.1 * mu_t).expand(K),
                                    (10.0 * mu_t).expand(K))
            dtil_c = cops.jdiv(layout, lam, -t)
            dxc, dyc, dzc = kkt_solve_once(
                fac, torch.zeros_like(rx), torch.zeros_like(ry),
                cops.apply_W(layout, scaling, dtil_c))
            dz_sc_c = cops.apply_W(layout, scaling, dzc)
            ds_sc_c = -(dtil_c + dz_sc_c)
            c_ds_sc = ds_sc + ds_sc_c
            c_dz_sc = dz_sc + dz_sc_c
            alpha_c = torch.clamp_max(
                cfg.step_frac * torch.minimum(step(lam, c_ds_sc),
                                              step(lam, c_dz_sc)), 1.0)
            accept = alpha_c >= alpha + 0.01
            dx = torch.where(accept, dx + dxc, dx)
            dy = torch.where(accept, dy + dyc, dy)
            dz = torch.where(accept, dz + dzc, dz)
            ds_sc = torch.where(accept, c_ds_sc, ds_sc)
            dz_sc = torch.where(accept, c_dz_sc, dz_sc)
            alpha = torch.where(accept, alpha_c, alpha)

        ds = cops.apply_W(layout, scaling, ds_sc)

        step_finite = (
            torch.isfinite(alpha) & (alpha > 0)
            & torch.isfinite(psum(_sumsq(dx))) & torch.isfinite(psum(_sumsq(ds)))
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
            print(f"{int(st.k):3d} pcost={float(pcost):+.6e} "
                  f"gap={float(gap):.3e} pres={float(pres):.3e} "
                  f"dres={float(dres):.3e} step={float(alpha):.3f}")

        def upd(old, delta):
            return torch.where(freeze, old, old + alpha * delta)

        hist = st.hist
        if cfg.collect_history:
            row = torch.stack([pcost, dcost, gap, pres, dres,
                               torch.where(freeze, 0.0, alpha)])
            written = hist.index_copy(0, st.k.long().view(1), row[None])
            hist = torch.where(st.done, hist, written)

        return BlockState(
            x=upd(x, dx), y=upd(y, dy), s=upd(s, ds), z=upd(z, dz),
            k=torch.where(freeze, st.k, st.k + 1),
            status=torch.where(st.done, st.status, new_status),
            done=freeze,
            best_merit=best_merit, bx=bx, by=by, bs=bs, bz_=bz_,
            hist=hist,
        )

    # the reference's while_loop; its condition is the one host sync
    while bool(~st.done & (st.k < cfg.max_iter)):
        st = body(st)

    status = torch.where(st.done, st.status, int(Status.MAX_ITERATIONS))
    # best-iterate restoration + relaxed (inaccurate) acceptance on a
    # non-optimal, non-certificate exit
    restore = ((status == int(Status.NUMERICAL_ERROR))
               | (status == int(Status.MAX_ITERATIONS)))

    # relaxed exit certificates on the FINAL iterate
    rxf, ryf, rzf = residuals(st.x, st.y, st.s, st.z)
    hz_by_f = psum(torch.sum(h * st.z)) + st.y @ b
    pinf_exit = restore & (hz_by_f < 0) & (
        bnorm(aty_gtz(st.x, rxf)) <= cfg.feastol_inacc * -hz_by_f)
    cx_f = psum(torch.sum(c * st.x))
    dres_cert = torch.maximum(gnorm(ryf + b), bnorm(rzf + h))
    dinf_exit = restore & (cx_f < 0) & (dres_cert <= cfg.feastol_inacc * -cx_f)

    x = torch.where(restore, st.bx, st.x)
    y = torch.where(restore, st.by, st.y)
    s = torch.where(restore, st.bs, st.s)
    z = torch.where(restore, st.bz_, st.z)

    rx, ry, rz = residuals(x, y, s, z)
    gap, pcost, dcost, relgap, pres, dres = metrics(x, y, s, z, rx, ry, rz)
    inacc_ok = (
        (pres <= cfg.feastol_inacc)
        & (dres <= cfg.feastol_inacc)
        & ((gap <= cfg.abstol_inacc) | (relgap <= cfg.reltol_inacc))
    )
    cert = ~inacc_ok & (pinf_exit | dinf_exit)
    x = torch.where(cert, st.x, x)
    y = torch.where(cert, st.y, y)
    s = torch.where(cert, st.s, s)
    z = torch.where(cert, st.z, z)
    status = torch.where(
        restore & inacc_ok, int(Status.OPTIMAL),
        torch.where(
            pinf_exit & ~inacc_ok, int(Status.PRIMAL_INFEASIBLE),
            torch.where(dinf_exit & ~inacc_ok & ~pinf_exit,
                        int(Status.DUAL_INFEASIBLE), status),
        ),
    ).to(torch.int32)
    inaccurate = restore & inacc_ok
    # the driver's stats layout (api.py Solution order)
    stats = torch.stack([pcost, dcost, gap, relgap, pres, dres,
                         inaccurate.to(dtype)])
    return x, y, s, z, status, st.k, stats, st.hist


def solve_block(
    prob: BlockSocpProblem,
    config: SolverConfig = DEFAULT_CONFIG,
    dtype=None,
    device=None,
    mesh=None,
):
    """Solve a block SOCP with the Schur-reduced KKT, on one device or with
    the blocks sharded over the ranks of the 1-D `mesh` (parallel/mesh.py;
    the block count must divide by its size).

    `prob` is this module's BlockSocpProblem or the reference's, read by
    its fields; every rank passes the whole problem.  Returns (x (K, nb),
    y (p,), s, z in the original block cone order, status, iterations,
    stats), the whole problem's on every rank, with stats in the driver's
    layout [pcost, dcost, gap, relgap, pres, dres, inaccurate_flag].  With
    config.collect_history the per-iteration table is appended as an 8th
    element (k x 6: pcost, dcost, gap, pres, dres, step).  `device=None`
    means "cuda" (it raises where CUDA is absent); `device="cpu"` runs the
    kernels' plain versions.  `dtype` takes None or any spelling of f64.
    """
    dev = resolve_device(device)
    resolve_dtype(dtype)
    if config.gondzio_correctors is None:
        config = dataclasses.replace(config, gondzio_correctors=0)
    dims = ConeDims(prob.block_dims.l, tuple(prob.block_dims.qs))
    layout = make_layout(dims, config.bucket_multiple)
    has_P = prob.P is not None
    K = prob.n_blocks
    group = None if mesh is None else mesh_group(mesh)
    sl = slice(None)
    if group is not None:
        r, ndev = shard_index(group)
        if K % ndev != 0:
            raise ValueError(f"blocks {K} not divisible by mesh size {ndev}")
        sl = slice(r * (K // ndev), (r + 1) * (K // ndev))

    out = _core(
        layout, config, has_P,
        _put(prob.c[sl], dev),
        _put(layout.pad_rows(np.asarray(prob.G[sl], np.float64)), dev),
        _put(layout.pad_vec(np.asarray(prob.h[sl], np.float64)), dev),
        _put(prob.A[sl], dev), _put(prob.b, dev),
        _put(prob.P[sl], dev) if has_P else None,
        group=group, K_total=K,
    )
    if group is not None:          # x, s, z: every rank's blocks
        out = tuple(coll.all_gather(t, group).flatten(0, 1) if i in (0, 2, 3)
                    else t for i, t in enumerate(out))
    x, y, s, z, status, k, stats, hist = (t.cpu().numpy() for t in out)
    res = (x, y, layout.unpad_vec(s), layout.unpad_vec(z), Status(int(status)),
           int(k), stats)
    if config.collect_history:
        res = res + (hist[: int(k)],)
    return res


def random_block_problem(seed: int, K: int = 16, nb: int = 8,
                         block_dims: Optional[ConeDims] = None,
                         p: int = 4) -> tuple[BlockSocpProblem, float]:
    """KKT-constructed block problem with known optimal value (the block
    analog of models.random_socp); the same seed and arguments give the
    reference's arrays."""
    from socp_tpu_torch.models.random_socp import _complementary_pair

    rng = np.random.default_rng(seed)
    if block_dims is None:
        block_dims = ConeDims(l=4, qs=(4, 6))
    mb = block_dims.dim
    assert mb >= nb, "need rank(G_i) = nb per block"
    xs = rng.normal(size=(K, nb))
    ys = rng.normal(size=p)
    s = np.empty((K, mb))
    z = np.empty((K, mb))
    for i in range(K):
        s[i], z[i] = _complementary_pair(rng, block_dims)
    A = rng.normal(size=(K, p, nb)) / np.sqrt(K * nb)
    G = rng.normal(size=(K, mb, nb)) / np.sqrt(nb)
    b = np.einsum("kpn,kn->p", A, xs)
    h = np.einsum("kmn,kn->km", G, xs) + s
    c = -(np.einsum("kpn,p->kn", A, ys) + np.einsum("kmn,km->kn", G, z))
    pcost = float(np.sum(c * xs))
    prob = BlockSocpProblem(c=c, G=G, h=h, block_dims=block_dims, A=A, b=b)
    return prob, pcost


def dryrun(mesh, device=None) -> None:
    """One tiny block-Schur solve over `mesh` (dryrun.dryrun_multichip's
    block step): two blocks a rank, 4 iterations, no refinement."""
    ndev = mesh.mesh.numel()
    prob, _ = random_block_problem(0, K=2 * ndev, nb=6, p=3)
    cfg = SolverConfig(max_iter=4, refine_steps=0)
    x = solve_block(prob, config=cfg, device=device, mesh=mesh)[0]
    if x.shape != prob.c.shape or not np.isfinite(x).all():
        raise RuntimeError(f"schur.dryrun: x of shape {x.shape}, finite "
                           f"{np.isfinite(x).all()}")
