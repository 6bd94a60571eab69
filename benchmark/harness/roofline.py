"""The least time a kernel's work can take on the card, and the peaks it
is set against (NVIDIA H100 SXM data sheet, dense rates at the full 700 W
power limit).

The work is what the shapes need: each input byte read once and each
output byte written once (a triangular factor by its lower triangle, the
Cholesky's output whole), and the arithmetic of the plain loops.  The
least time is the larger of bytes over the memory bandwidth and
operations over the f64 tensor-core rate, the card's fastest f64 rate, so
no implementation of the same work can read over 100%.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP64_FLOPS_PER_S = 67e12


def chol_flops(n: int) -> int:
    """Operations of the right-looking column loop on an n x n matrix: per
    column one square root, n - j divisions and a rank-1 update."""
    return n + n * (n + 1) // 2 + sum(t * (t + 1) for t in range(n))


def least_s(bytes_: float, flops: float) -> float:
    """The larger of the two bounds, in seconds."""
    return max(bytes_ / HBM_BYTES_PER_S, flops / FP64_FLOPS_PER_S)


def chol_batched_s(B: int, n: int) -> float:
    """One f64 chol_batched launch on a (B, n, n) batch."""
    tri = 8 * B * n * (n + 1) // 2
    full = 8 * B * n * n
    return least_s(tri + full, B * chol_flops(n))


def tri_pair_batched_s(B: int, n: int, k: int) -> float:
    """One f64 tri_pair_batched launch: a (B, n, n) factor, (B, n, k) rhs."""
    tri = 8 * B * n * (n + 1) // 2
    rb = 8 * B * n * k
    return least_s(tri + 2 * rb, B * 2 * n * n * k)
