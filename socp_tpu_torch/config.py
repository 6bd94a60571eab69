"""Solver configuration: the fields and defaults of `socp_tpu/config.py`.

The port keeps every field so that a config written for the reference is a
config for the port.  Its carries are f64 (the card has native FP64), so
the fields that choose among the reference's TPU precision and kernel
routes map onto two paths: f64 iterates with either the f64 Cholesky and
triangular-pair kernels or their f32 instances (single-instance for
`solve`, batched for the batched entry points):

  * `factor_dtype=None` or `"float64"`              -> the f64 path;
  * `native_dd` (dd32 everywhere on the TPU)        -> the f64 path with
    the reference's structured KKT assembly (kkt/structured.py: ConstGram,
    W^-2 helpers, G dx reuse), whatever `factor_dtype` says: the reference
    ignores `factor_dtype` under `native_dd`, and api.py resolves it to
    None;
  * `factor_dtype="dd32"` (dd32 factor)             -> the f64 path;
  * `factor_dtype="float32"` (without `native_dd`)   -> the f32 factor and
    back-solves under f64 refinement (kkt/dense.py), the reference's
    mixed-precision mode; it ends "optimal, inaccurate" near a 1e-6 gap,
    as the reference does;
  * `use_pallas` (VMEM-resident Pallas kernels)     -> the kernels, always;
  * `invert_factor` (explicit triangular inverse)   -> the kernels, always;
  * `refine_in_f64`                                  -> no-op (the carries,
    and so the residuals, are already f64).

Any other `factor_dtype` raises in `api`.  The block-Schur solve
(parallel/schur.py) resolves the fields as the reference's block path
does: it factors in f64 whatever `factor_dtype` says and ignores
`native_dd`; `ring_schur` reduces its Schur complement by
`collectives.ring_allreduce` when its blocks are sharded over a mesh, and
changes nothing on one device.
"""

from __future__ import annotations

import dataclasses
import enum


class KKTStrategy(enum.Enum):
    """How the per-iteration KKT system is factored, as in the reference
    (socp_tpu/config.py).  Informational: `solve` / `solve_batch` use
    DENSE (the condensed normal equations, one dense Cholesky); BLOCK_SCHUR
    names the block-Schur path of `parallel.schur.solve_block` (per-block
    factors and the p x p Schur complement of the coupling rows)."""

    DENSE = "dense"
    BLOCK_SCHUR = "block_schur"


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    max_iter: int = 50
    abstol: float = 1e-8
    reltol: float = 1e-8
    feastol: float = 1e-8
    # Relaxed acceptance (ECOS-style "optimal, inaccurate"): on a stall or
    # max-iter exit the best iterate seen is restored and accepted if it
    # meets these.
    abstol_inacc: float = 5e-5
    reltol_inacc: float = 5e-5
    feastol_inacc: float = 1e-4
    # A combined direction whose relative KKT residual exceeds this is
    # unusable: the instance stops with NUMERICAL_ERROR.
    solve_quality_tol: float = 0.25
    step_frac: float = 0.99
    # Static regularization on the equilibrated (unit-diagonal) condensed
    # system, floored at 32 eps of the factor dtype.
    delta_reg: float = 1e-11
    # Augmented-Lagrangian weight rho on A'A in the condensed (1,1) block
    # (only used when equality constraints are present).
    aug_rho: float = 1.0
    # Iterative-refinement rounds for every KKT solve / for the affine one.
    refine_steps: int = 1
    refine_affine: int = 0
    refine_in_f64: bool = False
    factor_dtype: str | None = None
    native_dd: bool = False
    # SOC bucket granularity (block dims padded to a multiple of this, >= 2).
    bucket_multiple: int = 8
    use_pallas: bool | None = None
    invert_factor: bool | None = None
    ring_schur: bool = False
    # Gondzio centrality correctors per iteration; None = auto, which the
    # port resolves as the reference does off the TPU: 0 (api.py).
    gondzio_correctors: int | None = None
    # Warm-start recentering margin (relative to the iterate's magnitude).
    warm_push: float = 0.05
    # Record [pcost, dcost, gap, pres, dres, step] per iteration.
    collect_history: bool = False
    verbose: bool = False


DEFAULT_CONFIG = SolverConfig()
