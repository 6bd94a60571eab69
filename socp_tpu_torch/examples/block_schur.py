"""Block-structured SOCP with the Schur-reduced KKT (BASELINE config 4),
the port of examples/block_schur.py.

    python -m socp_tpu_torch.examples.block_schur [--cpu]
    torchrun --nproc-per-node N -m socp_tpu_torch.examples.block_schur [--cpu]

Alone it solves on one device (`mesh=None`); under torchrun the blocks
are sharded over a mesh of every rank (`parallel.mesh.block_mesh`).
"""

from __future__ import annotations

import time

from socp_tpu_torch.config import SolverConfig
from socp_tpu_torch.examples import device_name, parse, rank, torchrun_mesh
from socp_tpu_torch.parallel.schur import random_block_problem, solve_block


def run(K: int | None = None, nb: int = 8, p: int = 4, verbose: bool = True,
        device=None, mesh=None) -> dict:
    """`random_block_problem(0, K, nb, p)` (K = 8 blocks a rank by
    default) through `solve_block`; returns the known optimum and what
    the script prints: status, iterations, pcost, gap and the wall s."""
    ndev = 1 if mesh is None else mesh.mesh.numel()
    K = 8 * ndev if K is None else K
    prob, pstar = random_block_problem(0, K=K, nb=nb, p=p)
    t0 = time.perf_counter()
    x, y, s, z, status, iters, stats = solve_block(
        prob, config=SolverConfig(verbose=verbose), device=device, mesh=mesh)
    wall_s = time.perf_counter() - t0
    return {"K": K, "devices": ndev, "pstar": pstar, "x": x,
            "status": status, "iterations": iters, "pcost": float(stats[0]),
            "gap": float(stats[2]), "inaccurate": bool(stats[6] > 0.5),
            "wall_s": wall_s, "device": device_name(device)}


def main(argv=None) -> None:
    device, _ = parse(argv)
    with torchrun_mesh(device) as mesh:
        ndev = 1 if mesh is None else mesh.mesh.numel()
        if rank() == 0:
            _, pstar = random_block_problem(0, K=8 * ndev, nb=8, p=4)
            print(f"{8 * ndev} blocks over {ndev} device(s); known optimum "
                  f"{pstar:.6f}")
        r = run(device=device, mesh=mesh)
        if rank() == 0:
            print(f"\nstatus={r['status'].name} iters={r['iterations']} "
                  f"pcost={r['pcost']:.6f} gap={r['gap']:.2e}")
            print(f"solve: {r['wall_s']:.3f}s on {r['device']}")


if __name__ == "__main__":
    main()
