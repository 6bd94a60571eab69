"""The reductions of the sharded solves over `torch.distributed`: the port
of `socp_tpu/parallel/collectives.py` plus the scalar reductions the
sharded cores need (the reference's `lax.psum` / `lax.pmin` and the
in-order `dd_allsum` of its huge cone).

Every function takes `group`, the process group to reduce over.
`group=None` means no mesh: the function returns its input (a copy where
it would otherwise be a fresh tensor's worth of work), the one-device
path.  With a group, each function calls `torch.distributed`, even for a
group of one, so that a one-rank run on the card goes through NCCL.

  * `psum`: `all_reduce` SUM;  `pmin`: `all_reduce` MIN;
  * `pany`: whether a flag is set on any rank (`all_reduce` MAX of an
    int32), the lockstep loop's condition;
  * `all_gather`: the ranks' tensors stacked in rank order;
  * `allsum`: `all_gather`, then a sum over ranks 0..N-1 in that fixed
    order (the reference's `dd_allsum`, done in f64);
  * `ring_allreduce`: the same gather-then-fixed-order-sum, over chunks of
    the last axis with numpy's `array_split` sizes (an unequal last chunk).

Replication: a sharded solve keeps every loop condition, step length and
stop flag a value that every rank holds bit for bit, or one rank leaves a
loop while another waits in a collective.  `allsum` and `ring_allreduce`
give every rank the same bits by construction (every rank adds the same
slots in the same order).  `psum` relies on the backend: NCCL's and gloo's
all-reduce algorithms reduce each element once and broadcast the result,
and with two ranks a + b = b + a in any order.  The sharded tests assert
that every rank's outputs are bit-identical.

Transport: NCCL takes CUDA tensors on the rank's own device; gloo
implements only `broadcast` and `all_reduce` for CUDA tensors.  Where the
group's backend is gloo and the tensor is on CUDA, each call stages it
through host memory explicitly (a copy to the host, the collective, a
copy back), and counts the staging in `COUNTS["staged"]`.

`COUNTS` counts the calls that reached `torch.distributed`, by kind (one
for each public call, whatever it does inside), in the style of the
kernels' launch counters (ops/chol.py): set them to 0 with
`reset_counts()`, read them with `counts()`.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

COUNTS = {"psum": 0, "pmin": 0, "pany": 0, "all_gather": 0, "allsum": 0,
          "ring_allreduce": 0, "staged": 0}


def reset_counts() -> None:
    for key in COUNTS:
        COUNTS[key] = 0


def counts() -> dict:
    return dict(COUNTS)


def _staged(x: torch.Tensor, group) -> bool:
    """Whether `x` goes through host memory: a CUDA tensor on gloo."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _all_reduce(x: torch.Tensor, op, group) -> torch.Tensor:
    if _staged(x, group):
        COUNTS["staged"] += 1
        y = x.detach().cpu().contiguous()
        dist.all_reduce(y, op=op, group=group)
        return y.to(x.device)
    y = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=op, group=group)
    return y


def _gather(x: torch.Tensor, group) -> torch.Tensor:
    """(ranks, *x.shape): every rank's x, in rank order."""
    src = x.detach()
    if _staged(x, group):
        COUNTS["staged"] += 1
        src = src.cpu()
    src = src.contiguous()
    slots = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(slots, src, group=group)
    return torch.stack(slots).to(x.device)


def _ordered_sum(slots: torch.Tensor) -> torch.Tensor:
    """slots[0] + slots[1] + ... in that order: the same bits on every
    rank, and slots[0] itself for one rank."""
    out = slots[0]
    for i in range(1, slots.shape[0]):
        out = out + slots[i]
    return out


def psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum over the ranks of `group` (the reference's `lax.psum`)."""
    if group is None:
        return x
    COUNTS["psum"] += 1
    return _all_reduce(x, dist.ReduceOp.SUM, group)


def pmin(x: torch.Tensor, group=None) -> torch.Tensor:
    """Least over the ranks of `group` (the reference's `lax.pmin`)."""
    if group is None:
        return x
    COUNTS["pmin"] += 1
    return _all_reduce(x, dist.ReduceOp.MIN, group)


def pany(flag: torch.Tensor, group=None) -> torch.Tensor:
    """Whether the 0-d bool `flag` is set on any rank of `group`."""
    if group is None:
        return flag
    COUNTS["pany"] += 1
    return _all_reduce(flag.to(torch.int32), dist.ReduceOp.MAX, group) > 0


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's `x` stacked in rank order: (ranks, *x.shape); x[None]
    without a group."""
    if group is None:
        return x[None]
    COUNTS["all_gather"] += 1
    return _gather(x, group)


def allsum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum over the ranks in the fixed order 0..N-1 (the reference's
    `dd_allsum`, hugecone.py:104-109, in f64): bitwise replicated."""
    if group is None:
        return x
    COUNTS["allsum"] += 1
    return _ordered_sum(_gather(x, group))


def ring_allreduce(x: torch.Tensor, group=None, n_chunks: int = 1) -> torch.Tensor:
    """Sum of `x` over the ranks by gather, then the fixed-order local sum
    (collectives.py:38-65), chunk by chunk of the last axis: `n_chunks`
    pieces with `array_split` sizes, so p = 6 in 4 chunks is 2, 2, 1, 1."""
    if group is None:
        return x
    COUNTS["ring_allreduce"] += 1
    if n_chunks <= 1 or x.ndim == 0 or x.shape[-1] < n_chunks:
        return _ordered_sum(_gather(x, group))
    pieces = torch.tensor_split(x, n_chunks, dim=-1)
    return torch.cat([_ordered_sum(_gather(p, group)) for p in pieces], dim=-1)
