"""Device meshes over the ranks of `torch.distributed`: the port of
`socp_tpu/parallel/mesh.py`.

A mesh is PyTorch's own `torch.distributed.device_mesh.DeviceMesh` with
named dims ("batch", "blocks"; `runtime.pod_mesh` makes the 2-D
("scenario", "blocks")), made over the world's ranks after
`runtime.init_distributed`.  One rank drives one device, so a mesh of N
devices is a world of N ranks; a mesh size other than the world size
raises `ValueError` (there is no silent subset of the ranks).

The sharded entry points take `mesh=`; `mesh=None` keeps the one-device
path.  A rank's shard of a batch (or of the blocks, or of the rows) is
the contiguous slice at its rank in the mesh's group: `shard_index`
and `shard_leading` say which, in the order `collectives.all_gather`
stacks the ranks' tensors.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def world_size(n_devices: Optional[int] = None) -> int:
    """The world's rank count, which a mesh spans; raises without a
    process group, or where `n_devices` is given and differs."""
    if not dist.is_initialized():
        raise RuntimeError(
            "a mesh needs a process group: call "
            "socp_tpu_torch.parallel.runtime.init_distributed() first "
            "(or run under torchrun)")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(
            f"a mesh of {n_devices} devices in a world of {world} ranks: "
            "a mesh spans every rank, one device a rank")
    return world


def make_mesh(shape: Sequence[int], names: Sequence[str]) -> DeviceMesh:
    """A mesh of the given shape over ranks 0..N-1 in row-major order, of
    device type "cuda" on NCCL and "cpu" on gloo (also the transport of
    two ranks sharing one card)."""
    return DeviceMesh("cuda" if dist.get_backend() == "nccl" else "cpu",
                      torch.arange(int(np.prod(shape))).reshape(tuple(shape)),
                      mesh_dim_names=tuple(names))


def batch_mesh(n_devices: Optional[int] = None, axis: str = "batch") -> DeviceMesh:
    """1-D mesh over every rank for data-parallel (batched) solves;
    `n_devices`, when given, must be the world size."""
    return make_mesh((world_size(n_devices),), (axis,))


def block_mesh(n_devices: Optional[int] = None, axis: str = "blocks") -> DeviceMesh:
    """1-D mesh for the block-partitioned KKT (the Schur reduction) and the
    huge cone's rows."""
    return batch_mesh(n_devices, axis)


def mesh_group(mesh: DeviceMesh, axis: Union[str, Sequence[str], None] = None):
    """The process group a sharded solve reduces over: the group of the
    one named dim, or, for all of a mesh's dims (`axis=None` or every
    name), the world's, since a mesh here spans every rank."""
    names = tuple(mesh.mesh_dim_names or ())
    if isinstance(axis, str):
        axis = (axis,)
    axis = names if axis is None else tuple(axis)
    if mesh.mesh.numel() != dist.get_world_size():
        raise ValueError(f"the mesh {mesh} does not span the world's "
                         f"{dist.get_world_size()} ranks")
    if len(axis) == 1:
        return mesh.get_group(axis[0])
    if sorted(axis) != sorted(names):
        raise ValueError(f"axes {axis} are not one dim or all of {names}")
    return dist.group.WORLD


def shard_index(group) -> tuple[int, int]:
    """(this rank's shard, the shard count) over `group`."""
    return dist.get_rank(group), dist.get_world_size(group)


def shard_leading(mesh: DeviceMesh, axis, *arrays):
    """This rank's contiguous slices of the arrays' leading dim, sharded
    over `axis` (a dim name, or several for all of a mesh's dims); the
    leading dim must divide by the shard count."""
    r, n = shard_index(mesh_group(mesh, axis))
    out = []
    for a in arrays:
        if np.shape(a)[0] % n:
            raise ValueError(f"leading dim {np.shape(a)[0]} not divisible by "
                             f"the {n} shards of {axis!r}")
        k = np.shape(a)[0] // n
        out.append(a[r * k:(r + 1) * k])
    return tuple(out)
