"""Solver configuration: the fields and defaults of `socp_tpu/config.py`.

The port keeps every field so that a config written for the reference is a
config for the port.  Its runtime is f64 end to end (the card has native
FP64), so the fields that choose among the reference's TPU precision and
kernel routes all map onto the port's single path — f64 iterates, the
f64 Cholesky kernels and the f64 triangular-pair kernels (single-instance
for `solve`, batched for the batched entry points):

  * `native_dd` (dd32 everywhere on the TPU)        -> the f64 path;
  * `factor_dtype="dd32"` (dd32 factor)             -> the f64 path;
  * `use_pallas` (VMEM-resident Pallas kernels)     -> the f64 kernels, always;
  * `invert_factor` (explicit triangular inverse)   -> the f64 kernels, always;
  * `refine_in_f64`                                  -> no-op (already f64).

`factor_dtype="float32"` (the f32 factor under f64 refinement) is a later
slice of the port and raises in `api`.  `ring_schur` belongs to the
block-Schur path, which this package does not have yet.
"""

from __future__ import annotations

import dataclasses


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
