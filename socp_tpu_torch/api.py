"""Public solver API of the port: host-side padding and layout, the IPM
driver on the device, unpadding — the counterpart of `socp_tpu/api.py`.

    sol = solve(prob)                                   # one SOCP -> Solution
    fn, args, layout = prepare_batch(c, G, h, dims)    # data on the card once
    x, y, s, z, status, k, stats, hist = fn(*args)      # torch tensors
    out = solve_batch_raw(c, G, h, dims)                # numpy 8-tuple
    sols = solve_batch(c, G, h, dims)                   # list[Solution]

`solve` runs the driver on a batch of one, so its KKT factor and
back-solves go through the single-instance kernels (`ops.chol.cholesky` /
`tri_pair_solve` route a batch of one there); the batched entry points run
the batched kernels, one launch a factor or solve at every order
(ops/chol.py).

KKT route: `SolverConfig(native_dd=True)` takes the reference's
accelerator route, the structured assembly of kkt/structured.py
(ConstGram for 1-4 SOC blocks, the rho/V form up to 32, the scaled-matrix
form above), in f64 whatever `factor_dtype` says; the default takes the
scaled-matrix assembly of kkt/dense.py.  `native_dd` passes through
`prepare_batch` and `solve` unchanged.

Precision: `dtype` (`resolve_dtype`) is the carry dtype, the dtype of
the iterates.  None or any spelling of f64 is f64 (`torch.float64`):
iterates, products, factors and solves alike, and TF32 plays no part.
The reference's None means its default, f64 only where JAX's x64 is on;
torch has no such switch, so here None is always f64.  Any spelling of
f32 is the reference's f32-carries mode: the inputs are rounded to f32
and the iterates, the cone sweeps, the products and (`factor_dtype=None`:
the carry dtype) the factors and back-solves run in f32 through the f32
kernels; `SolverConfig(refine_in_f64=True)` takes the refinement
residual in f64 (kkt/dense.py).  Under `native_dd=True` f32 inputs are
rounded to f32 and then solved in f64, as the reference builds its
double-word carries from the rounded inputs.  Outputs are float64 numpy
in every mode, as the reference's are (an f32 run's hold f32 values).
With `SolverConfig(factor_dtype="float32")` and f64 carries the iterates
and the refinement residuals stay f64 while Ghat, H = Ghat'Ghat, the
Cholesky factors and the back-solves are f32 (kkt/dense.py), the
reference's mixed-precision mode; its solves end "optimal, inaccurate"
near a 1e-6 gap, as the reference's do.  f32 products run on cuBLAS, so
with f32 factors or carries `torch.backends.cuda.matmul.allow_tf32 =
True` (or a float32 matmul precision below "highest") WOULD change the
result: the port sets neither and expects PyTorch's defaults (TF32 off).

Device: every entry point takes `device`; `device=None` means `"cuda"`,
and where CUDA is absent that raises instead of carrying on quietly on the
CPU.  `device="cpu"` runs the same driver with the kernels' plain PyTorch
versions (the tests' path).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from socp_tpu_torch.cones.layout import make_layout
from socp_tpu_torch.config import DEFAULT_CONFIG, SolverConfig
from socp_tpu_torch.ipm import driver
from socp_tpu_torch.problem import ConeDims, SocpProblem
from socp_tpu_torch.solution import Solution, Status


def resolve_device(device=None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "socp_tpu_torch runs on CUDA by default and no CUDA device is "
                "available; pass device='cpu' for the plain PyTorch path"
            )
        return torch.device("cuda")
    return torch.device(device)


# spellings of the two carry dtypes, by name: torch's, numpy's and JAX's
# dtypes and the strings all name themselves "float64" / "float32"
_CARRY = {"float64": torch.float64, "float32": torch.float32}
_NUMPY = {torch.float64: np.float64, torch.float32: np.float32}


def resolve_dtype(dtype) -> torch.dtype:
    """The carry dtype: None or any spelling of f64 (torch.float64,
    np.float64, np.dtype("float64"), "float64", JAX's float64) is
    torch.float64, any spelling of f32 torch.float32; anything else (f16,
    bf16, integers) raises."""
    if dtype is None:
        return torch.float64
    if isinstance(dtype, torch.dtype):
        names = {str(dtype).removeprefix("torch.")}
    else:
        names = {str(dtype), str(getattr(dtype, "name", ""))}
        try:
            names.add(np.dtype(dtype).name)
        except TypeError:
            pass
    for name, carry in _CARRY.items():
        if name in names:
            return carry
    raise ValueError(
        f"the port's carries are float64 or float32, got {dtype!r}")


def carry_dtypes(dtype, config: SolverConfig) -> tuple[torch.dtype,
                                                       torch.dtype]:
    """(inputs, carry): the dtype the inputs are rounded to and the dtype
    of the iterates.  They are the same, except that `native_dd` rounds
    f32 inputs to f32 and then carries f64 (module doc)."""
    inputs = resolve_dtype(dtype)
    return inputs, torch.float64 if config.native_dd else inputs


def _resolve_config(config: SolverConfig) -> SolverConfig:
    """Resolve the auto fields as the reference does off the TPU, for a
    single and a batched solve alike (socp_tpu/api.py `_resolve_pallas`):
    no Gondzio corrector, so CPU runs stay iteration-comparable with the
    reference.  `native_dd=True` takes the structured KKT assembly
    (kkt/structured.py) in f64 and, as in the reference, ignores
    `factor_dtype` (resolved to None here, so the driver sees one answer).
    `use_pallas`, `invert_factor` and `factor_dtype="dd32"` select the f64
    kernel path (config.py); `factor_dtype="float32"` selects the f32
    factor and back-solves."""
    if config.native_dd and config.factor_dtype is not None:
        config = dataclasses.replace(config, factor_dtype=None)
    if config.factor_dtype not in driver.FACTOR_DTYPES:
        raise NotImplementedError(
            f"factor_dtype={config.factor_dtype!r}: the port factors in "
            f"one of {sorted(map(str, driver.FACTOR_DTYPES))} (None: the "
            "carry dtype)"
        )
    if config.gondzio_correctors is None:
        config = dataclasses.replace(config, gondzio_correctors=0)
    return config


def _put(a, dev, dtype=torch.float64, carry=None) -> torch.Tensor:
    """`a` on `dev`, rounded to `dtype`, in the `carry` dtype (default:
    `dtype`)."""
    t = torch.as_tensor(np.ascontiguousarray(a, _NUMPY[dtype]), device=dev)
    return t if carry is None else t.to(carry)


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A float output as float64 numpy (an f32 run's values are exact)."""
    a = t.cpu().numpy()
    return a.astype(np.float64) if a.dtype == np.float32 else a


def _solution(config: SolverConfig, x, y, s, z, status, k, stats,
              hist) -> Solution:
    """One instance's numpy outputs (s, z unpadded) as a Solution."""
    return Solution(
        history=hist[: int(k)] if config.collect_history else None,
        x=x, y=y, s=s, z=z,
        status=Status(int(status)),
        iterations=int(k),
        pcost=float(stats[0]),
        dcost=float(stats[1]),
        gap=float(stats[2]),
        relgap=float(stats[3]),
        pres=float(stats[4]),
        dres=float(stats[5]),
        inaccurate=bool(stats[6] > 0.5),
    )


def solve(
    prob: SocpProblem,
    config: SolverConfig = DEFAULT_CONFIG,
    dtype=None,
    verbose: bool | None = None,
    warm: tuple | None = None,
    device=None,
) -> Solution:
    """Solve one SOCP (optionally with quadratic objective P), the port of
    `socp_tpu.solve`.

    `warm`: optional (x, y, s, z) starting point in the ORIGINAL (unpadded)
    cone order, e.g. a previous Solution's fields after a small problem
    change; s and z are recentered by config.warm_push.  `dtype`: the
    carry dtype (module doc)."""
    dev = resolve_device(device)
    if verbose is not None and verbose != config.verbose:
        config = dataclasses.replace(config, verbose=verbose)
    config = _resolve_config(config)
    inputs, carry = carry_dtypes(dtype, config)
    layout = make_layout(prob.dims, config.bucket_multiple)
    has_P = prob.P is not None

    def one(a):
        return _put(a, dev, inputs, carry)[None]

    args = (one(prob.c), one(layout.pad_rows(prob.G)),
            one(layout.pad_vec(prob.h)), one(prob.A), one(prob.b),
            one(prob.P) if has_P else _put(np.zeros((0, 0)), dev, carry))
    if warm is not None:
        xw, yw, sw, zw = (np.array(w, np.float64) for w in warm)
        warm = (one(xw), one(yw), one(layout.pad_vec(sw)),
                one(layout.pad_vec(zw)))
    out = driver.solve_core(layout, config, *args, has_P=has_P, warm=warm)
    x, y, s, z, status, k, stats, hist = (_numpy(t[0]) for t in out)
    return _solution(config, x, y, layout.unpad_vec(s), layout.unpad_vec(z),
                     status, k, stats, hist)


def prepare_batch(
    c, G, h, dims: ConeDims, A=None, b=None, P=None,
    config: SolverConfig = DEFAULT_CONFIG, dtype=None,
    has_warm: bool = False, device=None, group=None,
):
    """Device-resident batched solve: returns `(fn, args, layout)` with all
    problem data padded and placed on the device once; `fn(*args)` runs the
    lockstep IPM and returns torch tensors on that device.

    `has_warm=True`: `fn(*args, warm)` takes a (x, y, s, z) tuple of
    per-instance PADDED warm starts (e.g. the raw outputs of a previous
    `fn(*args)`, or `carry.from_reference_warm`).

    `group`: the process group of a batch sharded over ranks, each rank
    preparing its own slice (parallel/batch.py); the lockstep loop runs
    while any rank has an active instance (ipm/driver.py).

    `dtype`: the carry dtype (module doc); `fn`'s outputs are tensors of
    the carry dtype."""
    dev = resolve_device(device)
    B, n = np.shape(c)
    config = _resolve_config(config)
    inputs, carry = carry_dtypes(dtype, config)
    layout = make_layout(dims, config.bucket_multiple)
    has_P = P is not None
    if A is None:
        A, b = np.zeros((0, n)), np.zeros((0,))
    if P is None:
        P = np.zeros((0, 0))

    def put(a):
        return _put(a, dev, inputs, carry)

    def batched(a, ndim):
        t = put(a)
        return t.expand((B,) + t.shape) if t.ndim == ndim - 1 else t

    args = (
        put(c),
        put(layout.pad_rows(np.asarray(G, np.float64))),
        put(layout.pad_vec(np.asarray(h, np.float64))),
        batched(A, 3),
        batched(b, 2),
        batched(P, 3) if has_P else put(P),
    )

    def fn(c, G, h, A, b, P, warm=None):
        if (warm is not None) != has_warm:
            raise TypeError("fn takes a warm tuple iff prepared with has_warm=True")
        return driver.solve_core(layout, config, c, G, h, A, b, P,
                                 has_P=has_P, warm=warm, group=group)

    return fn, args, layout


def solve_batch_raw(
    c, G, h, dims: ConeDims, A=None, b=None, P=None,
    config: SolverConfig = DEFAULT_CONFIG, dtype=None, device=None,
):
    """Batched solve returning the reference's raw 8-tuple as numpy:
    x, y, s, z (s and z unpadded), status, iterations, stats (B x 7:
    pcost, dcost, gap, relgap, pres, dres, inaccurate), hist."""
    fn, args, layout = prepare_batch(c, G, h, dims, A=A, b=b, P=P,
                                     config=config, dtype=dtype, device=device)
    x, y, s, z, status, k, stats, hist = (_numpy(t) for t in fn(*args))
    return (x, y, layout.unpad_vec(s), layout.unpad_vec(z), status, k, stats,
            hist)


def solve_batch(
    c, G, h, dims: ConeDims, A=None, b=None, P=None,
    config: SolverConfig = DEFAULT_CONFIG, dtype=None, device=None,
) -> list[Solution]:
    """Solve B same-shaped SOCPs in lockstep; one Solution each."""
    x, y, s, z, status, k, stats, hist = solve_batch_raw(
        c, G, h, dims, A=A, b=b, P=P, config=config, dtype=dtype,
        device=device)
    return [_solution(config, x[i], y[i], s[i], z[i], status[i], k[i],
                      stats[i], hist[i])
            for i in range(x.shape[0])]
