"""Consensus ADMM over scenario subproblems, on one device or with the
scenarios sharded over the ranks of a mesh: the port of
`socp_tpu/parallel/admm.py` (BASELINE config 5).

Two-stage stochastic programs decompose into S scenario SOCPs coupled only
through the first-stage (consensus) variables:

    minimize (1/S) sum_i f_i(x_i)   s.t.  E x_i = w_bar  for all i

Scaled-form consensus ADMM with over-relaxation (Boyd et al. 2011, ch. 3):

    x_i^+    = argmin f_i(x_i) + (rho/2) || E x_i - w_bar + u_i ||^2
    xh_i     = alpha E x_i^+ + (1 - alpha) w_bar          (over-relaxation)
    w_bar^+  = mean_i (xh_i + u_i)
    u_i^+    = u_i + xh_i - w_bar^+

A round runs on the device: the inner solves are the batched lockstep IPM
(ipm/driver.solve_core, as `api.prepare_batch`'s function calls it) with
c_eff = c + rho [u - w_bar, 0], a shared P = rho diag(E) and a shared A;
the consensus mean, the dual update and the residuals follow over all S
scenarios.  rho is a 0-d tensor, so adapting it changes no shape.  The
(S, n) scenario solutions stay on the device until the run ends.

Host traffic: the reference runs its loop under a device-to-host transfer
guard and lets three scalars out a round.  PyTorch has no such guard, so
this layer reads the device in one place a round, `_fetch` (pres, dres and
the round's all-OPTIMAL flag in one transfer), which a test can count;
checkpoint snapshots are the only other reads.  The inner driver syncs on
its own loop condition once an iteration (ipm/driver.py).

`scenario_chunk` runs the inner solves as S / chunk sequential calls, each
on its chunk's own device copy of the data; the consensus and the dual
update stay one pass over all S.  Without it the S scenarios are one
batch: the whole run is the chunked path with one chunk, so the two give
the same bits wherever a solve's lanes do not depend on the batch they
share (the CPU's plain path).

Launches: each inner IPM iteration with p = 1 makes 2 chol_batched (H at
n = nv and the 1 x 1 A-Schur complement) and 10 tri_pair_batched; a cold
solve's W = I initialization adds 2 + 13, a warm start skips it.

`mesh`: a 1-D mesh or the 2-D `runtime.pod_mesh`.  The scenario batch is
sharded over all of the mesh's dims, as the reference's `_mesh_specs`
does (admm.py:161-174): rank r of the world holds the contiguous S / N
scenarios at r, their data, u and warm iterates, and runs their inner
solves (in chunks of scenario_chunk / N, so the chunk count is the one
of the unsharded run).  The inner solves exchange nothing: each rank's
lockstep loop ends with its own scenarios.  The consensus mean is one
all-reduce over the whole world (the ranks' means weighted by their share
of S), and the round's residual and all-OPTIMAL flag one more; w_bar,
rho and every branch are then the same bits on every rank.  Each round's
one device read, `_fetch`, comes after those reductions.

Config is resolved as `api._resolve_config` resolves it for the other
entry points (Gondzio None -> 0; `factor_dtype="dd32"` is the f64 path;
`native_dd=True` takes kkt/structured.py).

Precision: `dtype` is the carry dtype, f64 by default.  `dtype=float32`
is the counterpart of the reference's run with JAX's x64 off
(socp_tpu/parallel/admm.py:228): the data are rounded to f32 and the inner
solves, the consensus step and the duals run in f32 (under `native_dd` the
inner solves take the rounded data in f64, as in api.py).  The results are
float64 numpy.

Checkpoint/resume: `checkpoint_every` snapshots (w_bar, u, rho, round and
the warm iterates) in the reference's npz format (utils/checkpoint.py);
`resume_from` restarts a run from such a snapshot, the reference's too.
On a mesh the snapshot is the whole run's, gathered from the ranks and
written by rank 0, and a resume reads the whole file on every rank and
takes the rank's scenarios: a snapshot resumes on any rank count.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from socp_tpu_torch.api import (_numpy, _put, _resolve_config, carry_dtypes,
                                resolve_device)
from socp_tpu_torch.cones.layout import ConeLayout, make_layout
from socp_tpu_torch.config import DEFAULT_CONFIG, SolverConfig
from socp_tpu_torch.ipm import driver
from socp_tpu_torch.parallel import collectives as coll
from socp_tpu_torch.parallel.mesh import mesh_group, shard_index
from socp_tpu_torch.problem import ConeDims
from socp_tpu_torch.solution import Status
from socp_tpu_torch.utils.checkpoint import SolverCheckpoint

_WARM_KEYS = ("warm_x", "warm_y", "warm_s", "warm_z")


@dataclasses.dataclass
class ADMMResult:
    w_bar: np.ndarray          # consensus first-stage solution
    x: np.ndarray              # (S, n) scenario solutions
    objective: float           # (1/S) sum_i f_i(x_i) at consensus point
    primal_res: float          # ||E x_i - w_bar|| (consensus violation)
    dual_res: float            # rho ||w_bar^+ - w_bar||
    outer_iterations: int
    inner_status_ok: bool
    rho: float = 1.0           # final penalty (after adaptation)


def _inner(layout: ConeLayout, config: SolverConfig, c, G, h, A, b, E,
           w_bar, u, rho_d, warm):
    """The inner solves of one chunk (every scenario, unchunked): builds
    the chunk's objective from (w_bar, u, rho) on the device and runs the
    lockstep IPM with P = rho diag(E) and A shared by the chunk.  Returns
    (x, all OPTIMAL, next round's padded warm tuple)."""
    Sc, n = c.shape
    c_eff = c + rho_d * F.pad(u - w_bar[None, :], (0, n - u.shape[1]))
    P = torch.diag(E) * rho_d
    if A.ndim == 2:
        A, b = A.expand((Sc,) + A.shape), b.expand((Sc,) + b.shape)
    out = driver.solve_core(layout, config, c_eff, G, h, A, b,
                            P.expand(Sc, n, n), has_P=True, warm=warm)
    return out[0], torch.all(out[4] == int(Status.OPTIMAL)), out[:4]


def _consensus(xc, u, w_bar, rho_d, alpha: float, ok, group=None,
               share: float = 1.0):
    """Over-relaxed consensus mean and dual update over all S scenarios,
    with the primal and dual residuals (0-d tensors) and whether every
    inner solve of the round ended OPTIMAL.  With `group`, xc, u and `ok`
    are this rank's (its `share` of the S scenarios): the mean and the
    residual's mean are the ranks' means weighted by their shares, summed
    over the group (for one rank, the local mean times 1.0: the same bits
    as without a group)."""
    xh = alpha * xc + (1.0 - alpha) * w_bar[None, :]
    w_new = torch.mean(xh + u, dim=0)
    if group is not None:
        w_new = coll.psum(w_new * share, group)
    u_new = u + xh - w_new[None, :]
    msq = torch.mean(torch.sum((xc - w_new[None, :]) ** 2, dim=1))
    if group is not None:
        msq, failed = coll.psum(torch.stack([msq * share,
                                             (~ok).to(msq.dtype)]), group)
        ok = failed == 0
    pres = torch.sqrt(msq)
    dres = rho_d * torch.linalg.vector_norm(w_new - w_bar)
    return w_new, u_new, pres, dres, ok


def _fetch(pres, dres, ok) -> tuple[float, float, bool]:
    """The round's one device-to-host transfer: pres, dres and whether
    every inner solve of the round ended OPTIMAL."""
    v = torch.stack([pres, dres, ok.to(pres.dtype)]).cpu().tolist()
    return v[0], v[1], v[2] == 1.0


def admm_consensus(
    c: np.ndarray,             # (S, n) per-scenario linear objectives
    G: np.ndarray,             # (S, m, n)
    h: np.ndarray,             # (S, m)
    dims: ConeDims,
    n_consensus: int,          # consensus coords = x[:n_consensus]
    A: Optional[np.ndarray] = None,
    b: Optional[np.ndarray] = None,
    rho: float = 1.0,
    outer_iters: int = 50,
    tol: float = 1e-5,
    config: SolverConfig = DEFAULT_CONFIG,
    verbose: bool = False,
    over_relax: float = 1.6,
    adapt_rho: bool = True,
    warm_start: bool = True,
    checkpoint_every: int = 0,
    checkpoint_path: Optional[str] = None,
    resume_from: Union[SolverCheckpoint, str, None] = None,
    scenario_chunk: Optional[int] = None,
    device=None,
    dtype=None,
    mesh=None,
) -> ADMMResult:
    """Run consensus ADMM; the inner solves are the batched lockstep IPM.

    `A` is (p, n), shared by every scenario, or (S, p, n).

    `warm_start`: rounds after the first start each scenario's inner IPM
    from its previous-round solution (recentered by config.warm_push); the
    iterates stay on the device between rounds.

    `scenario_chunk`: run the inner solves as S / chunk sequential calls
    (the consensus and dual update stay one pass over all S).  It bounds
    the device memory the solves hold at once.  Warm starts, adaptive rho
    and checkpoint/resume work per chunk.

    `mesh`: shard the scenarios over the ranks of a 1-D mesh or of the 2-D
    `runtime.pod_mesh` (module doc); S and scenario_chunk must divide by
    the world size.  Every rank passes the whole problem and gets the
    whole result.

    `device=None` means "cuda" and raises without CUDA (`device="cpu"`
    runs the kernels' plain versions); `dtype`: the carry dtype, any
    spelling of f64 or f32 (`api.resolve_dtype`; module doc)."""
    if checkpoint_every and not checkpoint_path:
        raise ValueError(
            "checkpoint_every > 0 requires checkpoint_path — without it the"
            " requested snapshots would be silently skipped"
        )
    dev = resolve_device(device)
    S, n = c.shape
    nc = n_consensus
    config = _resolve_config(config)
    inputs, carry = carry_dtypes(dtype, config)
    layout = make_layout(dims, config.bucket_multiple)
    batch_A = A is not None and np.ndim(A) == 3
    if A is None:
        A, b = np.zeros((0, n)), np.zeros((0,))

    alpha = float(over_relax)
    chunked = scenario_chunk is not None and 0 < scenario_chunk < S
    if chunked and S % scenario_chunk:
        raise ValueError(
            f"n_scenarios {S} not divisible by scenario_chunk {scenario_chunk}"
        )
    Sc = scenario_chunk if chunked else S
    # this rank's scenarios (all of them without a mesh) and its chunks
    group = None if mesh is None else mesh_group(mesh)
    r, ndev = (0, 1) if group is None else shard_index(group)
    if S % ndev or Sc % ndev:
        raise ValueError(f"n_scenarios {S} and chunk {Sc} must divide by the "
                         f"mesh size {ndev}")
    Sl, Sc = S // ndev, Sc // ndev
    own = slice(r * Sl, (r + 1) * Sl)
    spans = [slice(i, i + Sc) for i in range(0, Sl, Sc)]

    def whole(t):
        """Every rank's rows of a (Sl, ...) tensor, in scenario order."""
        return t if group is None else coll.all_gather(t, group).flatten(0, 1)

    # ---- problem data on the device once, one copy per chunk (never the
    # whole (S, m, n) array beside its slices)
    Gp = layout.pad_rows(np.asarray(G[own], np.float64))
    hp = layout.pad_vec(np.asarray(h[own], np.float64))
    c_own = c[own]
    def put(a):
        return _put(a, dev, inputs, carry)

    chunks = [tuple(put(a[sl]) for a in (c_own, Gp, hp))
              + ((put(A[own][sl]), put(b[own][sl])) if batch_A
                 else (put(A), put(b)))
              for sl in spans]
    E = put((np.arange(n) < nc).astype(np.float64))

    # ---- initial state (fresh or resumed)
    it0 = 0
    warm = None
    if resume_from is not None:
        ck = (SolverCheckpoint.load(resume_from)
              if isinstance(resume_from, str) else resume_from)
        w_bar = put(ck.x)
        u = put(ck.y[own])
        rho = float(ck.meta.get("rho", rho))
        it0 = int(ck.iteration)
        if it0 >= outer_iters:
            raise ValueError(
                f"checkpoint is at round {it0} but outer_iters={outer_iters}"
                " — nothing to resume; raise outer_iters or start fresh"
            )
        if warm_start and "warm_x" in ck.meta:
            warm = [tuple(put(ck.meta[k][own][sl]) for k in _WARM_KEYS)
                    for sl in spans]
    else:
        w_bar = torch.zeros(nc, dtype=carry, device=dev)
        u = torch.zeros((Sl, nc), dtype=carry, device=dev)

    pres = dres = np.inf
    ok = True
    xs = None
    rounds = 0
    for it in range(it0, outer_iters):
        rounds += 1
        rho_d = torch.tensor(rho, dtype=carry, device=dev)
        xs, oks, warm_next = [], [], []
        for i, (sl, data) in enumerate(zip(spans, chunks)):
            x_i, ok_i, wn = _inner(layout, config, *data, E, w_bar, u[sl],
                                   rho_d, None if warm is None else warm[i])
            xs.append(x_i)
            oks.append(ok_i)
            warm_next.append(wn)
        xc = torch.cat([x_[:, :nc] for x_ in xs])
        w_bar, u, pres_d, dres_d, ok_d = _consensus(
            xc, u, w_bar, rho_d, alpha, torch.stack(oks).all(), group,
            Sl / S)
        if warm_start:
            warm = warm_next
        # ok accumulates: one failed inner solve anywhere in the trajectory
        # taints the run (a later clean round must not mask it)
        pres, dres, ok_round = _fetch(pres_d, dres_d, ok_d)
        ok = ok and ok_round
        if verbose:
            print(f"admm {it:3d} pres={pres:.3e} dres={dres:.3e} "
                  f"rho={rho:.2g}")
        converged = pres <= tol and dres <= tol
        if not converged and adapt_rho:
            # residual balancing (Boyd 3.4.1); u is the SCALED dual, so it
            # rescales by rho_old / rho_new
            if pres > 10.0 * dres:
                rho *= 2.0
                u = u * 0.5
            elif dres > 10.0 * pres:
                rho *= 0.5
                u = u * 2.0
        # snapshot AFTER adaptation: the saved (w_bar, u, rho, it + 1) is
        # the start-of-next-round state, so resume is bit-faithful
        if checkpoint_every and (it + 1) % checkpoint_every == 0:
            meta = {"rho": rho, "pres": pres, "dres": dres}
            if warm_start and warm is not None:
                meta.update({k: whole(torch.cat([w[j] for w in warm]))
                             .cpu().numpy() for j, k in enumerate(_WARM_KEYS)})
            u_all = whole(u).cpu().numpy()
            if r == 0:
                SolverCheckpoint(
                    x=w_bar.cpu().numpy(), y=u_all,
                    s=np.zeros(0), z=np.zeros(0), iteration=it + 1, meta=meta,
                ).save(checkpoint_path)
            if group is not None:      # no rank goes on before the file is
                coll.psum(w_bar.new_zeros(()), group).item()
        if converged:
            break

    x_np = np.zeros((S, n)) if xs is None else _numpy(whole(torch.cat(xs)))
    w_np = _numpy(w_bar)
    x_cons = x_np.copy()
    x_cons[:, :nc] = w_np
    objective = float(np.mean(np.sum(c * x_cons, axis=1)))
    return ADMMResult(
        w_bar=w_np, x=x_np, objective=objective, primal_res=pres,
        dual_res=dres, outer_iterations=rounds, inner_status_ok=ok,
        rho=rho,
    )
