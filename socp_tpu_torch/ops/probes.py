"""The toolchain probes, f32: ports of the Mosaic probe kernels of
`scripts/pallas_probe.py` and `scripts/pallas_probe2.py`.

  eft(a, b)          -> (s, e, p, q): two-sum s + e = a + b and two-prod
                        p + q = a * b, exact (port of `_eft_kernel`, P2)
  row_sum(M)         -> (1, cols): the rows of M added one a step, in row
                        order (port of `_read_kernel`, P3)
  row_reverse(M)     -> M's rows in reverse order (port of `_write_kernel`,
                        P4)
  fwd_subst(LT, b)   -> x with L x = b, reading rows of LT = L' (port of
                        `_fwd_kernel`, P5); n up to FWD_MAX_N (512, the
                        kernel's 32 lanes x 16 registers), any k

P1 (`_chol_kernel`, an f32 Cholesky of a (128, 128) matrix) is the same
function as `ops.chol.chol_single` on an f32 matrix and has no wrapper here.

They lie on no solver path: they show that the card's toolchain keeps
each f32 operation as written (no FMA contraction, no reassociation), reads
and writes rows at a dynamic index, and runs a substitution loop.  As in
`ops.chol`, each wrapper runs its plain PyTorch version only for a tensor on
the CPU; for a CUDA tensor it launches the kernel of `csrc/probes.cu` or
raises, and counts the launch in `launches`.  The plain versions do the
kernels' operations in the kernels' order, one elementwise op at a time, so
the two agree bit for bit.
"""

from __future__ import annotations

import torch

# kernel launches since the last reset, by entry point
launches = {"probe_eft": 0, "probe_read": 0, "probe_write": 0, "probe_fwd": 0}

SPLIT = 4097.0   # Dekker's split for f32: 2^12 + 1
FWD_MAX_N = 512   # fwd_subst's largest n (csrc/probes.cu kFwdMaxN)


def eft_plain(a: torch.Tensor, b: torch.Tensor):
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    p = a * b
    ta = SPLIT * a
    ah = ta - (ta - a)
    al = a - ah
    tb = SPLIT * b
    bh = tb - (tb - b)
    bl = b - bh
    q = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return s, e, p, q


def row_sum_plain(M: torch.Tensor) -> torch.Tensor:
    acc = M.new_zeros((1, M.shape[1]))
    for j in range(M.shape[0]):
        acc = acc + M[j]
    return acc


def row_reverse_plain(M: torch.Tensor) -> torch.Tensor:
    return M.flip(0)


def fwd_subst_plain(LT: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    x = b.clone()
    n = LT.shape[0]
    for j in range(n - 1):
        xj = x[j] / LT[j, j]
        x[j + 1:] -= LT[j, j + 1:, None] * xj[None, :]
    return x / torch.diagonal(LT)[:, None]


def _check(name: str, *ts: torch.Tensor):
    for t in ts:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
        if t.ndim != 2 or not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous 2-d tensor")
        if t.device != ts[0].device:
            raise ValueError(f"{name}: tensors on different devices")


def _launch(name: str, t: torch.Tensor, *args):
    from socp_tpu_torch.ops import _build

    with torch.cuda.device(t.device):
        err = _build.kernel(name)(
            *args, torch.cuda.current_stream(t.device).cuda_stream)
    if err:
        raise RuntimeError(f"{name}: launch failed, cudaError {err}")
    launches[name] += 1


def eft(a: torch.Tensor, b: torch.Tensor):
    _check("eft", a, b)
    if a.shape != b.shape:
        raise ValueError(f"eft: shapes {tuple(a.shape)} / {tuple(b.shape)}")
    if a.device.type == "cpu":
        return eft_plain(a, b)
    out = [torch.empty_like(a) for _ in range(4)]
    _launch("probe_eft", a, a.data_ptr(), b.data_ptr(),
            *(o.data_ptr() for o in out), a.numel())
    return tuple(out)


def row_sum(M: torch.Tensor) -> torch.Tensor:
    _check("row_sum", M)
    if M.device.type == "cpu":
        return row_sum_plain(M)
    out = M.new_empty((1, M.shape[1]))
    _launch("probe_read", M, M.data_ptr(), out.data_ptr(), *M.shape)
    return out


def row_reverse(M: torch.Tensor) -> torch.Tensor:
    _check("row_reverse", M)
    if M.device.type == "cpu":
        return row_reverse_plain(M)
    out = torch.empty_like(M)
    _launch("probe_write", M, M.data_ptr(), out.data_ptr(), *M.shape)
    return out


def fwd_subst(LT: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    _check("fwd_subst", LT, b)
    n, k = b.shape
    if LT.shape != (n, n):
        raise ValueError(
            f"fwd_subst: shapes {tuple(LT.shape)} / {tuple(b.shape)}")
    if not 1 <= n <= FWD_MAX_N:
        raise ValueError(f"fwd_subst: n = {n} is outside the kernel's "
                         f"1 .. {FWD_MAX_N} rows, on every device")
    if LT.device.type == "cpu":
        return fwd_subst_plain(LT, b)
    x = torch.empty_like(b)
    _launch("probe_fwd", LT, LT.data_ptr(), b.data_ptr(), x.data_ptr(), n, k)
    return x
