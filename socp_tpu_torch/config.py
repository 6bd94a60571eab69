"""Solver configuration: the fields and defaults of `socp_tpu/config.py`.

The port keeps every field so that a config written for the reference is a
config for the port.  The carry dtype (the iterates') is the entry point's
`dtype`: f64 by default (the card has native FP64), or f32, the
reference's f32-carries mode (api.py).  The fields that choose among the
reference's TPU precision and kernel routes map onto the f64 and f32
instances of the Cholesky and triangular-pair kernels (single-instance for
`solve`, batched for the batched entry points).  The factor dtype, by
`factor_dtype` and carry dtype:

  factor_dtype    f64 carries                 f32 carries
  None            f64                         f32 (the carry dtype, as
                                              socp_tpu/kkt/dense.py:117)
  "float32"       f32 factor and back-solves  f32
                  under f64 refinement (the
                  mixed-precision mode; ends
                  "optimal, inaccurate" near
                  a 1e-6 gap, as the
                  reference does)
  "float64"       f64                         f64 (the reference casts
                                              Ghat and the rhs up to f64)
  "dd32"          f64                         f64: the reference's dd32
                                              factor is f64-grade
                                              (kkt/dd_dense.py builds it
                                              from the f32 Ghat and
                                              returns f64)

  * `native_dd` (dd32 everywhere on the TPU)        -> f64 carries with
    the reference's structured KKT assembly (kkt/structured.py: ConstGram,
    W^-2 helpers, G dx reuse), whatever `factor_dtype` says: the reference
    ignores `factor_dtype` under `native_dd`, and api.py resolves it to
    None.  f32 inputs are rounded to f32 first, as the reference builds
    its dd carries from the rounded inputs;
  * `use_pallas` (VMEM-resident Pallas kernels)     -> the kernels, always;
  * `invert_factor` (explicit triangular inverse)   -> the kernels, always;
  * `refine_in_f64`                                  -> the refinement
    residual's products and sums in f64 over f64 copies of P, A and G
    (kkt/dense.py), the correction cast to the carry dtype; a no-op under
    f64 carries, where the residual is already f64.

Any other `factor_dtype` raises in `api`.  The block-Schur solve
(parallel/schur.py) resolves the fields as the reference's block path
does: it factors in the carry dtype, except that "dd32" factors in f64
(the reference's dd32 block factor is f64-grade; under f32 carries the
reference's own block path cannot run it), and ignores `native_dd`;
`ring_schur` reduces its Schur complement by `collectives.ring_allreduce`
when its blocks are sharded over a mesh, and changes nothing on one
device.
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
