"""Carry the reference's state into the port.

An SOCP has no weights: what crosses from `socp_tpu` to the port is problem
data (plain numpy, the same for both) and iterates.  Both packages pad the
cone vectors with the same `make_layout`, so a padded iterate of one is a
padded iterate of the other.
"""

from __future__ import annotations

import numpy as np
import torch

from socp_tpu_torch.api import resolve_device
from socp_tpu_torch.cones.layout import ConeLayout
from socp_tpu_torch.problem import ConeDims, SocpProblem


def problem_from_reference(prob) -> SocpProblem:
    """The port's SocpProblem from a reference `socp_tpu.SocpProblem` (its
    fields are numpy arrays, read here by name; nothing of the reference is
    imported): the same data, so both packages solve the same instance."""
    dims = ConeDims(prob.dims.l, tuple(prob.dims.qs))
    return SocpProblem(c=prob.c, G=prob.G, h=prob.h, dims=dims,
                       A=prob.A, b=prob.b, P=prob.P)


def from_reference_warm(x, y, s, z, layout: ConeLayout, device=None):
    """The port's warm tuple from the reference's PADDED per-instance
    iterates — the raw outputs of `socp_tpu.prepare_batch(...)[0](*args)`
    as numpy arrays: x (B, n), y (B, p), s and z (B, m_pad).  Pass the
    result as the last argument of a `prepare_batch(..., has_warm=True)`
    function.  `device=None` means "cuda", as everywhere in the port."""
    dev = resolve_device(device)
    x, y, s, z = (np.asarray(a, np.float64) for a in (x, y, s, z))
    B = x.shape[0]
    if s.shape != (B, layout.m_pad) or z.shape != (B, layout.m_pad):
        raise ValueError(
            f"s/z must be padded (B, {layout.m_pad}); got {s.shape}, {z.shape}")
    if y.shape[0] != B:
        raise ValueError(f"y has batch {y.shape[0]}, x has {B}")
    return tuple(torch.tensor(a, device=dev) for a in (x, y, s, z))
