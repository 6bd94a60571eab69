"""One huge second-order cone, the port of examples/huge_cone.py.

A single robust-fitting constraint ||B x - d|| <= a'x + 5 whose residual
vector is far too long for one device's comfort, beside a small box
|x_i| <= 2.  Every Jordan-algebra operation on the cone is elementwise
work plus reductions, and the KKT condenses to a tall-skinny Gram
(parallel/hugecone.py).

    python -m socp_tpu_torch.examples.huge_cone [--cpu]
    torchrun --nproc-per-node N -m socp_tpu_torch.examples.huge_cone [--cpu]

Alone it solves on one device (`mesh=None`); under torchrun the cone's
rows are split over a mesh of every rank.  At the script's q = 8,193 the
instance is primal infeasible (||d|| grows as sqrt(q)), as the
reference's is, so the printed inequality does not hold (ROADMAP.md,
queue 3 item 11).
"""

from __future__ import annotations

import time

import numpy as np

from socp_tpu_torch.examples import device_name, parse, rank, torchrun_mesh
from socp_tpu_torch.parallel.hugecone import solve_huge


def instance(n: int = 16, q: int = 8 * 1024 + 1, l: int = 8, seed: int = 0):
    """The script's problem: min c'x s.t. ||B x - d|| <= a'x + 5 and
    |x_i| <= 2 on the first l/2 coordinates.  Returns (c, G, h, a, B, d)
    with the l orthant rows first, then the SOC of dimension q."""
    rng = np.random.default_rng(seed)
    G = np.zeros((l + q, n))
    h = np.zeros(l + q)
    for i in range(l // 2):
        G[2 * i, i], G[2 * i + 1, i] = 1.0, -1.0
        h[2 * i] = h[2 * i + 1] = 2.0
    a = rng.normal(size=n) * 0.1
    B = rng.normal(size=(q - 1, n)) / np.sqrt(n)
    d = rng.normal(size=q - 1) * 0.1
    G[l] = -a
    h[l] = 5.0
    G[l + 1:] = -B
    h[l + 1:] = -d
    c = rng.normal(size=n)
    return c, G, h, a, B, d


def run(n: int = 16, q: int = 8 * 1024 + 1, l: int = 8, device=None,
        mesh=None) -> dict:
    """The script's instance through `parallel.hugecone.solve_huge`;
    returns the data, the raw 7-tuple (x, y, s, z, status, iterations,
    stats) and what the script prints: status, iterations, pcost, gap,
    pres, dres, ||Bx - d||, a'x + 5 and the wall s."""
    c, G, h, a, B, d = instance(n=n, q=q, l=l)
    t0 = time.perf_counter()
    out = solve_huge(c, G, h, l, (q,), device=device, mesh=mesh)
    wall_s = time.perf_counter() - t0
    x, y, s, z, status, iters, stats = out
    return {"data": (c, G, h, l, (q,), None, None), "result": out,
            "devices": 1 if mesh is None else mesh.mesh.numel(), "q": q,
            "status": status, "iterations": iters,
            "pcost": float(stats[0]), "gap": float(stats[2]),
            "pres": float(stats[4]), "dres": float(stats[5]),
            "resid": float(np.linalg.norm(B @ x - d)),
            "bound": float(a @ x + 5), "wall_s": wall_s,
            "device": device_name(device)}


def main(argv=None) -> None:
    device, _ = parse(argv)
    with torchrun_mesh(device) as mesh:
        r = run(device=device, mesh=mesh)
        if rank() == 0:
            print(f"devices={r['devices']}  q={r['q']:,}  "
                  f"status={r['status'].name}  iters={r['iterations']}")
            print(f"pcost={r['pcost']:.6f}  gap={r['gap']:.2e}  "
                  f"pres={r['pres']:.2e}  dres={r['dres']:.2e}")
            print(f"||Bx-d|| = {r['resid']:.4f}  <=  a'x+5 = "
                  f"{r['bound']:.4f}")
            print(f"solve: {r['wall_s']:.3f}s on {r['device']}")


if __name__ == "__main__":
    main()
