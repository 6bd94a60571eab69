"""The single-device entry and one step of every sharded path on tiny
shapes: the ports of `__graft_entry__.entry` and `dryrun_multichip`
(__graft_entry__.py:21-49, :52-110).

`entry()` returns `(fn, args)`: the flagship workload (BASELINE config
3's batched robust least squares, at 8 instances of n = 12) padded and on
the device, and the lockstep IPM over it; `fn(*args)` runs
`ipm/driver.solve_core` and returns its tensors.

    torchrun --nproc-per-node 2 -m socp_tpu_torch.parallel.dryrun        # card
    torchrun --nproc-per-node 2 -m socp_tpu_torch.parallel.dryrun --cpu  # gloo

Every rank runs `dryrun_multichip(N)` with N the world size: the sharded
batch, the block-Schur solve over the blocks, one huge SOC split over the
ranks and, for an even N, consensus ADMM on `runtime.pod_mesh` with two
scenario rows.  A failed check raises.
"""

from __future__ import annotations

import sys

import numpy as np

from socp_tpu_torch.config import SolverConfig


def _finite(what: str, *arrays) -> None:
    if not all(np.isfinite(a).all() for a in arrays):
        raise RuntimeError(f"dryrun_multichip: {what} is not finite")


def entry(device=None):
    """(fn, args): the lockstep batched IPM over the flagship instances,
    `robust_ls_batch(0, batch=8, n=12, k=16)` with
    `SolverConfig(max_iter=10, refine_steps=0)`.  `fn(*args)` returns
    `ipm/driver.solve_core`'s (x, y, s, z, status, iterations, stats,
    hist) as tensors, s and z padded.  `device=None` means "cuda" (it raises where CUDA is
    absent); `device="cpu"` runs the kernels' plain versions."""
    from socp_tpu_torch.api import prepare_batch
    from socp_tpu_torch.models.robust_ls import robust_ls_batch

    c, G, h, dims = robust_ls_batch(0, batch=8, n=12, k=16)
    fn, args, _ = prepare_batch(
        c, G, h, dims, config=SolverConfig(max_iter=10, refine_steps=0),
        device=device)
    return fn, args


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Run each sharded path once over a mesh of `n_devices` ranks (the
    world size); `device` as the entry points take it."""
    from socp_tpu_torch.models.robust_ls import robust_ls_batch
    from socp_tpu_torch.parallel import schur
    from socp_tpu_torch.parallel.batch import solve_batch_sharded
    from socp_tpu_torch.parallel.hugecone import solve_huge_soc
    from socp_tpu_torch.parallel.mesh import batch_mesh, block_mesh

    mesh = batch_mesh(n_devices)
    B = 2 * n_devices
    c, G, h, dims = robust_ls_batch(0, batch=B, n=12, k=16)
    cfg = SolverConfig(max_iter=5, refine_steps=0)
    x = solve_batch_sharded(c, G, h, dims, mesh=mesh, config=cfg,
                            device=device)[0]
    if x.shape != (B, c.shape[1]):
        raise RuntimeError(f"dryrun_multichip: batch x of shape {x.shape}")
    _finite("the batch's x", x)

    schur.dryrun(block_mesh(n_devices), device=device)

    # one huge SOC split over the ranks (head/tail cone kernels, the
    # reduced tall-skinny Gram)
    rng = np.random.default_rng(0)
    nq, nn = 4 * n_devices + 1, 6
    Gh = np.concatenate([np.zeros((1, nn)), -rng.normal(size=(nq - 1, nn))])
    hh = np.concatenate([[3.0], np.zeros(nq - 1)])
    ch = rng.normal(size=nn)
    xh = solve_huge_soc(ch, Gh, hh, l=0, mesh=block_mesh(n_devices),
                        config=SolverConfig(max_iter=5, refine_steps=0),
                        device=device)[0]
    _finite("the huge SOC's x", xh)

    # consensus ADMM on the 2-D scenario x blocks mesh
    if n_devices % 2 == 0:
        from socp_tpu_torch.models.stochastic import scenario_portfolio
        from socp_tpu_torch.parallel.admm import admm_consensus
        from socp_tpu_torch.parallel.runtime import pod_mesh

        c2, G2, h2, dims2, A2, b2, info2 = scenario_portfolio(
            0, n=6, k=2, n_scenarios=2 * n_devices)
        res = admm_consensus(
            c2, G2, h2, dims2, n_consensus=info2["n"], A=A2, b=b2,
            outer_iters=2, mesh=pod_mesh(scenario_size=2),
            config=SolverConfig(max_iter=6, refine_steps=0), device=device)
        _finite("ADMM's w_bar", res.w_bar)


def main(argv=None) -> None:
    import torch.distributed as dist

    from socp_tpu_torch.parallel.runtime import init_distributed

    device = "cpu" if "--cpu" in (argv if argv is not None else sys.argv[1:]) else None
    init_distributed(device=device)
    try:
        dryrun_multichip(dist.get_world_size(), device=device)
        print(f"dryrun_multichip({dist.get_world_size()}) ok on rank "
              f"{dist.get_rank()}", flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
