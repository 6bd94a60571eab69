"""Data-parallel batched solving: the instance axis sharded over the ranks of
a mesh, the port of `socp_tpu/parallel/batch.py`.

The lockstep IPM body is purely instance-parallel, so each rank solves
its contiguous slice of the batch through the `api.prepare_batch` path.
The one cross-rank exchange of the loop is its condition: whether any
instance of any rank is still active, one all-reduce of a flag an
iteration (the reference's single ICI bool), read once by the host after
the reduction (ipm/driver.py).  At the end every rank gathers the slices
and returns the whole batch.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from socp_tpu_torch import api
from socp_tpu_torch.config import DEFAULT_CONFIG, SolverConfig
from socp_tpu_torch.parallel import collectives as coll
from socp_tpu_torch.parallel.mesh import mesh_group, shard_index
from socp_tpu_torch.problem import ConeDims


def solve_batch_sharded(
    c: np.ndarray,
    G: np.ndarray,
    h: np.ndarray,
    dims: ConeDims,
    mesh=None,
    A=None,
    b=None,
    P_mat=None,
    config: SolverConfig = DEFAULT_CONFIG,
    dtype=None,
    device=None,
):
    """Like `api.solve_batch_raw`, with the batch axis sharded over the
    ranks of the 1-D `mesh` (parallel/mesh.py).  Every rank passes the full
    host arrays and gets back the full 8-tuple of numpy arrays; the batch
    size must divide by the mesh size.  `mesh=None` is `solve_batch_raw`
    on one device.  `A`, `b` and `P_mat` are shared (2-D / 1-D) or batched
    (3-D / 2-D), as there.  `device=None` means "cuda" (the rank's device,
    made current by `runtime.init_distributed`); `device="cpu"` runs the
    kernels' plain versions on a gloo group."""
    if mesh is None:
        return api.solve_batch_raw(c, G, h, dims, A=A, b=b, P=P_mat,
                                   config=config, dtype=dtype, device=device)
    group = mesh_group(mesh)
    r, ndev = shard_index(group)
    B = np.shape(c)[0]
    if B % ndev != 0:
        raise ValueError(f"batch {B} not divisible by mesh size {ndev}")
    sl = slice(r * (B // ndev), (r + 1) * (B // ndev))

    def local(a, batched_ndim):
        return a if a is None or np.ndim(a) < batched_ndim else a[sl]

    fn, args, layout = api.prepare_batch(
        c[sl], G[sl], h[sl], dims, A=local(A, 3), b=local(b, 2),
        P=local(P_mat, 3), config=config, dtype=dtype, device=device,
        group=group)
    out = [coll.all_gather(t, group) for t in fn(*args)]
    x, y, s, z, status, k, stats, hist = (
        t.flatten(0, 1).cpu().numpy() for t in out)
    return (x, y, layout.unpad_vec(s), layout.unpad_vec(z), status, k, stats,
            hist)
