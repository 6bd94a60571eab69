"""Cholesky and triangular-pair solve in f64 and f32: the port of the
Pallas kernels of `socp_tpu/ops/pallas_chol.py` that the solver runs.

  chol_batched(H)          lower L with L L' = H for a (B, n, n) batch, any
                           n, zeros above the diagonal (f64: port of
                           `_dd_chol_batch_kernel`; f32: of `_f32_chol_kernel`
                           under jax.vmap)
  tri_pair_batched(L, B)   (L L')^-1 B, forward then backward substitution,
                           for a (B, n, n) factor batch, any n whose rhs
                           column fits the kernel's shared memory (f64: port of
                           `_tri_pair_batch_kernel`; f32: of `_f32_tri_kernel`
                           under jax.vmap; both without the LT operand)
  chol_single(H)           the same for ONE (n, n) matrix, any n (f64: port
                           of `_dd_chol_kernel`; f32: of `_f32_chol_kernel`)
  tri_pair_single(L, B)    the same for one (n, n) factor and an (n, k) rhs
                           (f64: port of `_tri_pair_kernel`; f32: of
                           `_f32_tri_kernel`)
  cholesky(H), tri_pair_solve(L, B)
                           the routers, counterparts of the reference's
                           `cholesky_dd_v` / `tri_pair_solve_v`: a batch of
                           one instance goes to the single kernels, a larger
                           batch to the batched ones, at every order: one
                           launch a call either way, chosen by shape before
                           any launch, never a fallback on failure.

Every wrapper takes float64 or float32 and launches the entry point of its
input's dtype (`csrc/*.cu` export `*_f64` and `*_f32`); a factor and a rhs
of different dtypes raise.  The f32 entries carry the factor and the
back-solves of the solver's mixed-precision mode (`factor_dtype="float32"`,
kkt/dense.py).

Each wrapper takes its plain PyTorch version only for a tensor on the CPU;
for a CUDA tensor it launches the hand-written kernel from
`socp_tpu_torch/csrc/` or raises.  The plain versions repeat the kernels'
arithmetic step for step (the same right-looking column loop and
substitution loops), so a matrix that is not positive definite gives NaN
in both, never an exception.  They are dtype-generic: each step is one
elementwise sqrt, division, multiplication or subtraction, which PyTorch
rounds correctly in f32 as in f64 on the CPU and on the card (eager ops are
never fused into an FMA, and the card's kernels use `__fmul_rn` /
`__fsub_rn` and IEEE sqrt and division), so the kernels agree with them bit
for bit in both types.  The `*_launches` counters count kernel-wrapper
launches (never plain calls), the f64 kernels' under the plain names and
the f32 kernels' under `*_launches_f32`, so a run can show which kernels
it went through.  Each batched kernel picks its schedule by n inside its
source, before it launches (`batched_schedule` names the choice): up to
n = 32 a warp holds one instance or several; above that the Cholesky's
register tiles up to n = 108, then the 32 x 32 tile dataflow that
`chol_single` runs (csrc/chol_tiles.cuh) over the whole batch; the pair
solve's warp-per-instance panels, then above n = 256 `tri_pair_single`'s
block of a chain warp and row threads for each instance
(csrc/tri_pair_panels.cuh).  Every launch is one CUDA kernel; the tile
dataflow's entry points (`chol_single` above n = 32, `chol_batched` above
the register tiles) also zero its tickets and flags in a scratch buffer
the wrapper allocates, one memset beside the kernel.
"""

from __future__ import annotations

import functools

import torch

# kernel launches since the last reset (a caller may set them to 0): the
# f64 kernels' under the plain names, the f32 kernels' under *_f32
chol_launches = 0
tri_pair_launches = 0
chol_single_launches = 0
tri_pair_single_launches = 0
chol_launches_f32 = 0
tri_pair_launches_f32 = 0
chol_single_launches_f32 = 0
tri_pair_single_launches_f32 = 0

# kernel -> its f64 counter (the f32 one adds "_f32")
COUNTERS = {"chol_batched": "chol_launches",
            "tri_pair_batched": "tri_pair_launches",
            "chol_single": "chol_single_launches",
            "tri_pair_single": "tri_pair_single_launches"}

# dtype -> suffix of the C entry point
_SUFFIX = {torch.float64: "f64", torch.float32: "f32"}


def chol_batched_plain(H: torch.Tensor) -> torch.Tensor:
    """Right-looking column loop: the order of every entry's operations in
    csrc/chol_batched.cu."""
    M = H.clone()
    n = M.shape[-1]
    for j in range(n):
        d = torch.sqrt(M[:, j, j])
        col = M[:, j:, j] / d[:, None]
        M[:, j:, j] = col
        c = col[:, 1:]
        M[:, j + 1:, j + 1:] -= c[:, :, None] * c[:, None, :]
    return torch.tril(M)


def tri_pair_batched_plain(L: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Forward then backward substitution: the order of every entry's
    operations in csrc/tri_pair_batched.cu."""
    X = rhs.clone()
    n = L.shape[-1]
    diag = torch.diagonal(L, dim1=1, dim2=2)[..., None]      # (B, n, 1)
    for j in range(n - 1):
        xj = X[:, j, :] / diag[:, j]
        X[:, j + 1:, :] -= L[:, j + 1:, j, None] * xj[:, None, :]
    X = X / diag
    for j in range(n - 1, 0, -1):
        xj = X[:, j, :] / diag[:, j]
        X[:, :j, :] -= L[:, j, :j, None] * xj[:, None, :]
    return X / diag


def chol_single_plain(H: torch.Tensor) -> torch.Tensor:
    """The column loop of `chol_batched_plain` on one (n, n) matrix.  It is
    the plain version of the kernel's tile dataflow, which applies to every
    entry the same rounded operations in the same order
    (csrc/chol_single.cu)."""
    return chol_batched_plain(H[None])[0]


def tri_pair_single_plain(L: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """The substitution loops of `tri_pair_batched_plain` on one factor."""
    return tri_pair_batched_plain(L[None], rhs[None])[0]


def _check(name: str, t: torch.Tensor, ndim: int = 3):
    if t.dtype not in _SUFFIX:
        raise TypeError(f"{name}: expected float64 or float32, got {t.dtype}")
    if t.ndim != ndim:
        what = "a (B, n, *) batch" if ndim == 3 else "an (n, *) matrix"
        raise ValueError(f"{name}: expected {what}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")


def _check_pair(name: str, L: torch.Tensor, rhs: torch.Tensor):
    if L.dtype != rhs.dtype:
        raise TypeError(f"{name}: L is {L.dtype} but rhs is {rhs.dtype}")
    if L.device != rhs.device:
        raise ValueError(f"{name}: L and rhs on different devices")


def _max_n_check(name: str, n: int, t: torch.Tensor):
    """The pair solves' one refusal: an order whose rhs column does not fit
    the kernel's shared memory (csrc/tri_pair_panels.cuh)."""
    max_n = _query(f"{name}_max_n", t.element_size())
    if n > max_n:
        raise ValueError(
            f"{name}: n={n} is above {max_n} for {t.dtype}: the kernel keeps "
            "one rhs column in shared memory")


def _scratch(t: torch.Tensor, ints: int) -> torch.Tensor | None:
    """The tile dataflow's scratch buffer (its tickets, flags and pivot
    roots) of `ints` int32 on t's device, None for none; the entry point
    zeroes what must start at zero on the stream before its kernel."""
    if ints < 0:
        raise ValueError(f"a tile dataflow of shape {tuple(t.shape)} needs "
                         "more scratch than its int32 counters address")
    return torch.empty(ints, dtype=torch.int32, device=t.device) if ints else None


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


@functools.lru_cache(maxsize=None)
def _query(name: str, *args: int) -> int:
    """A layout query of a kernel's source (csrc/*.cu), which alone knows
    its tiles, schedules and shared memory."""
    from socp_tpu_torch.ops import _build

    return _build.kernel(name)(*args)


def batched_schedule(name: str, n: int, k: int = 1) -> str:
    """The schedule batched kernel `name` ("chol_batched" or
    "tri_pair_batched") launches at order n (and k rhs columns), as its
    source's launch() chooses it by n before any launch: "warp x G" for the
    small-order schedule (n <= 32, G instances a warp), else "tiles 128x3"
    (the register tiles) or "tiles dataflow" (chol_batched), "panels" (a
    warp an instance and column) or "block panels" (a block an instance:
    tri_pair_batched).  Builds the source on first use (a CUDA machine
    only)."""
    code = (_query("chol_batched_schedule", n) if name == "chol_batched"
            else _query("tri_pair_batched_schedule", n, k))
    if code > 0:
        return f"warp x {code}"
    if name == "chol_batched":
        return "tiles 128x3" if code == -1 else "tiles dataflow"
    return "panels" if code == -1 else "block panels"


def _launch(name: str, t: torch.Tensor, *args):
    """Call kernel `name`'s C entry point for t's dtype on t's device and
    count the launch; raise if the launch failed."""
    from socp_tpu_torch.ops import _build

    suffix = _SUFFIX[t.dtype]
    with torch.cuda.device(t.device):
        err = _build.kernel(f"{name}_{suffix}")(*args, _stream(t))
    if err:
        raise RuntimeError(f"{name}: launch failed, cudaError {err}")
    globals()[COUNTERS[name] + ("_f32" if suffix == "f32" else "")] += 1


def chol_batched(H: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of a (B, n, n) f64 or f32 batch."""
    _check("chol_batched", H)
    B, n, n2 = H.shape
    if n != n2:
        raise ValueError(f"chol_batched: not square: {tuple(H.shape)}")
    if H.device.type == "cpu":
        return chol_batched_plain(H)
    L = torch.empty_like(H)
    if L.numel() == 0:
        return L
    scratch = _scratch(H, _query("chol_batched_scratch_ints", B, n))
    _launch("chol_batched", H, H.data_ptr(), L.data_ptr(),
            0 if scratch is None else scratch.data_ptr(), B, n)
    return L


def tri_pair_batched(L: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """(L L')^-1 rhs for a (B, n, n) lower factor and (B, n, k) rhs."""
    _check("tri_pair_batched", L)
    _check("tri_pair_batched", rhs)
    B, n, _ = L.shape
    k = rhs.shape[2]
    if L.shape != (B, n, n) or rhs.shape[:2] != (B, n):
        raise ValueError(
            f"tri_pair_batched: shapes {tuple(L.shape)} / {tuple(rhs.shape)}")
    _check_pair("tri_pair_batched", L, rhs)
    if L.device.type == "cpu":
        return tri_pair_batched_plain(L, rhs)
    _max_n_check("tri_pair_batched", n, L)
    X = torch.empty_like(rhs)
    if X.numel() == 0:
        return X
    _launch("tri_pair_batched", L, L.data_ptr(), rhs.data_ptr(), X.data_ptr(),
            B, n, k)
    return X


def chol_single(H: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of one (n, n) f64 or f32 matrix, any n."""
    _check("chol_single", H, ndim=2)
    n = H.shape[0]
    if H.shape != (n, n):
        raise ValueError(f"chol_single: not square: {tuple(H.shape)}")
    if H.device.type == "cpu":
        return chol_single_plain(H)
    L = torch.empty_like(H)
    if n == 0:
        return L
    scratch = _scratch(H, _query("chol_single_scratch_ints", n))
    _launch("chol_single", H, H.data_ptr(), L.data_ptr(),
            0 if scratch is None else scratch.data_ptr(), n)
    return L


def tri_pair_single(L: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """(L L')^-1 rhs for one (n, n) lower factor and an (n, k) rhs."""
    _check("tri_pair_single", L, ndim=2)
    _check("tri_pair_single", rhs, ndim=2)
    n, k = rhs.shape
    if L.shape != (n, n):
        raise ValueError(
            f"tri_pair_single: shapes {tuple(L.shape)} / {tuple(rhs.shape)}")
    _check_pair("tri_pair_single", L, rhs)
    if L.device.type == "cpu":
        return tri_pair_single_plain(L, rhs)
    _max_n_check("tri_pair_single", n, L)
    X = torch.empty_like(rhs)
    if X.numel() == 0:
        return X
    _launch("tri_pair_single", L, L.data_ptr(), rhs.data_ptr(), X.data_ptr(),
            n, k)
    return X


def cholesky(H: torch.Tensor) -> torch.Tensor:
    """Lower factors of a (B, n, n) batch: B == 1 through `chol_single`,
    larger batches through `chol_batched`, at every order."""
    if H.ndim == 3 and H.shape[0] == 1:
        return chol_single(H[0])[None]
    return chol_batched(H)


def tri_pair_solve(L: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """(L L')^-1 rhs for a (B, n, n) factor batch and (B, n, k) rhs: B == 1
    through `tri_pair_single`, larger batches through `tri_pair_batched`,
    at every order."""
    if L.ndim == 3 and L.shape[0] == 1 and rhs.ndim == 3:
        return tri_pair_single(L[0], rhs[0])[None]
    return tri_pair_batched(L, rhs)
