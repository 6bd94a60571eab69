"""Multi-process runtime: the `torch.distributed` bootstrap and the pod mesh,
the port of `socp_tpu/parallel/runtime.py`.

One process drives one device.  On the card the ranks talk over NCCL; on
the CPU (`device="cpu"`, the tests) over gloo.  A run on N devices is N
processes, started by `torchrun --nproc-per-node N` (which sets RANK,
WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR and MASTER_PORT) or
by the caller, who then passes `rank`, `world_size` and `init_method`.

Failure semantics, as the reference's: a rank that dies takes the run
down (its peers fail in their next collective when the group's timeout
expires); a restart re-runs `init_distributed` and resumes from the last
checkpoint (parallel/admm.py).  Errors propagate: there is no fallback from
NCCL to gloo, and a CUDA device that is absent raises.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from socp_tpu_torch.parallel.mesh import make_mesh, world_size as _mesh_world


def init_distributed(
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
    init_method: Optional[str] = None,
    device=None,
    backend: Optional[str] = None,
    timeout: Optional[datetime.timedelta] = None,
) -> None:
    """Join the process group (a no-op for a single process with no
    torchrun environment, and when the group is already up).

    With no arguments it reads torchrun's environment; `rank`,
    `world_size` and `init_method` (for instance "tcp://localhost:29500"
    or "file:///path/store") bring a group up by hand.  `device` is the
    device this rank's tensors live on: None means "cuda" at LOCAL_RANK
    (made current with `torch.cuda.set_device` before the group is made;
    "cuda:i" names the index), "cpu" runs the tests' path.  The backend is
    NCCL for a CUDA device and gloo for the CPU; `backend="gloo"` with a
    CUDA device is the caller's choice of transport (two ranks on one
    card, which NCCL refuses), whose collectives stage through the host
    (parallel/collectives.py)."""
    if dist.is_initialized():
        return
    env = os.environ
    if (rank is None and world_size is None and init_method is None
            and "RANK" not in env and "WORLD_SIZE" not in env):
        return
    rank = int(env.get("RANK", 0)) if rank is None else int(rank)
    world_size = (int(env.get("WORLD_SIZE", 1)) if world_size is None
                  else int(world_size))
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"init_distributed: device {dev} asked for and CUDA is not "
                "available; pass device='cpu' for a gloo group on the CPU")
        index = dev.index if dev.index is not None else int(
            env.get("LOCAL_RANK", 0))
        torch.cuda.set_device(index)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kwargs = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=world_size, **kwargs)


def pod_mesh(
    scenario_axis: str = "scenario",
    block_axis: str = "blocks",
    scenario_size: Optional[int] = None,
) -> DeviceMesh:
    """2-D mesh for the multi-node layouts: axis 0 (`scenario_axis`) spans
    nodes, the consensus traffic of ADMM; axis 1 (`block_axis`) spans each
    node's devices.  By default there is one scenario row per node
    (WORLD_SIZE / LOCAL_WORLD_SIZE, one row where LOCAL_WORLD_SIZE is
    unset): torchrun numbers a node's ranks contiguously, so row i holds
    node i's ranks, as the reference groups devices by process
    (runtime.py:91-102)."""
    world = _mesh_world()
    rows = scenario_size or max(
        world // int(os.environ.get("LOCAL_WORLD_SIZE", world)), 1)
    if world % rows:
        raise ValueError(f"{world} devices not divisible into {rows} "
                         "scenario rows")
    return make_mesh((rows, world // rows), (scenario_axis, block_axis))
