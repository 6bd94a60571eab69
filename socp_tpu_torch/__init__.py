"""socp_tpu_torch — the PyTorch / CUDA port of `socp_tpu` for an NVIDIA H100.

It imports torch and numpy, never jax and nothing of `socp_tpu`.  It runs
the single-instance solve (`solve`) and the batched lockstep solve
(`prepare_batch`, `solve_batch_raw`, `solve_batch`) in f64 through
hand-written CUDA kernels for the Cholesky factor and the triangular-pair
solve, single-instance and batched (`socp_tpu_torch/csrc/`).
`SolverConfig(native_dd=True)` takes the reference's structured KKT
assembly (kkt/structured.py).  `parallel.schur.solve_block` solves a
block-structured SOCP (per-block factors and the Schur complement of the
coupling rows) on one device.  `parallel.admm.admm_consensus` runs
consensus ADMM over a batch of scenario SOCPs (the inner solves are the
batched lockstep IPM; `models.stochastic` builds the two-stage portfolio
of BASELINE config 5, `utils.checkpoint` its snapshots).
`parallel.hugecone` solves one SOCP with a cone of millions of rows.
Each of them, and `parallel.batch.solve_batch_sharded`, takes `mesh=` to
shard its work over the ranks of `torch.distributed` (`parallel.runtime`,
`parallel.mesh`).  Entry points run on the card unless the caller passes
`device="cpu"`.
"""

from socp_tpu_torch.api import (prepare_batch, solve, solve_batch,
                                solve_batch_raw)
from socp_tpu_torch.config import DEFAULT_CONFIG, KKTStrategy, SolverConfig
from socp_tpu_torch.problem import ConeDims, SocpProblem
from socp_tpu_torch.solution import Solution, Status

__all__ = [
    "solve",
    "prepare_batch",
    "solve_batch",
    "solve_batch_raw",
    "SolverConfig",
    "KKTStrategy",
    "DEFAULT_CONFIG",
    "ConeDims",
    "SocpProblem",
    "Solution",
    "Status",
]
