"""The reference's example scripts (`examples/*.py`) on the port, one
module each, run on the card:

    python -m socp_tpu_torch.examples.portfolio            # on the card
    python -m socp_tpu_torch.examples.portfolio --cpu      # the plain path
    python -m socp_tpu_torch.examples.batched_robust_ls 256
    torchrun --nproc-per-node 2 -m socp_tpu_torch.examples.block_schur --cpu

`portfolio`, `batched_robust_ls`, `warm_start`, `block_schur`,
`admm_stochastic` and `huge_cone` each have `run(..., device=None)`,
which holds the script's body at the script's sizes by default and
returns the numbers it prints, and `main(argv=None)`, which prints the
reference's lines.  Importing a module runs nothing.  `device=None`
means "cuda" and raises where CUDA is absent (`--cpu`, `device="cpu"`:
the kernels' plain versions).  A printed time is a host clock around
work that ends in host copies, with the device's name beside it.
`block_schur` and `huge_cone` under torchrun shard over a mesh of every
rank (NCCL on the card; two ranks on one GPU need `--cpu`: NCCL refuses
them); alone they run on one device.
"""

from __future__ import annotations

import contextlib
import os
import sys

import torch


def parse(argv) -> tuple[str | None, list[str]]:
    """(the device `--cpu` asks for, None for the card; the other args)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    device = "cpu" if "--cpu" in argv else None
    return device, [a for a in argv if a != "--cpu"]


def device_name(device) -> str:
    """The name of the device a run on `device` uses: the card's, or "cpu"."""
    from socp_tpu_torch.api import resolve_device

    dev = resolve_device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


@contextlib.contextmanager
def torchrun_mesh(device):
    """Under torchrun (RANK and WORLD_SIZE set): bring the group up on
    `device`, yield a 1-D mesh over every rank (`mesh.block_mesh`) and
    take the group down after; alone, yield None."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        yield None
        return
    import torch.distributed as dist

    from socp_tpu_torch.parallel.mesh import block_mesh
    from socp_tpu_torch.parallel.runtime import init_distributed

    init_distributed(device=device)
    try:
        yield block_mesh()
    finally:
        dist.destroy_process_group()


def rank() -> int:
    """This process's rank (0 outside a process group)."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0
