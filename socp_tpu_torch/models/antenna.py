"""Antenna-array (beamforming) design SOCP (third family in BASELINE's
shared benchmark set: portfolio, robust least-squares, antenna design).

A copy of `socp_tpu/models/antenna.py`: the same arguments give the same
instances in both packages.

Minimize the maximum sidelobe level of an N-element uniform linear array
subject to unit gain at the target angle:

    minimize    t
    subject to  |a(theta_j)' w| <= t   for sidelobe angles theta_j
                Re(a(theta_0)' w) = 1,  Im(a(theta_0)' w) = 0

Complex steering vectors are embedded into reals: w = (wr, wi) in R^{2N};
each modulus constraint is a dim-3 SOC (t, Re, Im).
"""

from __future__ import annotations

import numpy as np

from socp_tpu_torch.problem import ConeDims, SocpProblem


def _steering(n_elem: int, theta: np.ndarray, spacing: float = 0.5) -> np.ndarray:
    """Steering matrix a(theta) for a lambda/2-spaced uniform linear array."""
    k = 2.0 * np.pi * spacing
    idx = np.arange(n_elem)
    return np.exp(1j * k * np.outer(np.sin(theta), idx))  # (n_angles, n_elem)


def antenna_design(
    seed: int = 0,
    n_elem: int = 16,
    n_angles: int = 60,
    target_deg: float = 0.0,
    beamwidth_deg: float = 15.0,
) -> tuple[SocpProblem, dict]:
    rng = np.random.default_rng(seed)
    del rng  # deterministic geometry; seed kept for API uniformity
    angles = np.deg2rad(np.linspace(-90.0, 90.0, n_angles))
    target = np.deg2rad(target_deg)
    sidelobe = angles[np.abs(np.rad2deg(angles) - target_deg) > beamwidth_deg]
    As = _steering(n_elem, sidelobe)          # (ns, N) complex
    a0 = _steering(n_elem, np.array([target]))[0]

    ns = As.shape[0]
    nv = 2 * n_elem + 1                        # (wr, wi, t)
    it = 2 * n_elem

    # |a'w| with complex a, w:  a'w = (ar - i ai)'(wr + i wi)  [conjugate inner]
    # Re = ar'wr + ai'wi ; Im = ar'wi - ai'wr
    def re_row(a):
        r = np.zeros(nv)
        r[:n_elem] = a.real
        r[n_elem : 2 * n_elem] = a.imag
        return r

    def im_row(a):
        r = np.zeros(nv)
        r[:n_elem] = -a.imag
        r[n_elem : 2 * n_elem] = a.real
        return r

    m = 3 * ns
    G = np.zeros((m, nv))
    h = np.zeros(m)
    for j in range(ns):
        off = 3 * j
        G[off, it] = -1.0            # s0 = t
        G[off + 1] = -re_row(As[j])  # s1 = Re(a_j' w)
        G[off + 2] = -im_row(As[j])  # s2 = Im(a_j' w)
    A = np.stack([re_row(a0), im_row(a0)])
    b = np.array([1.0, 0.0])
    dims = ConeDims(l=0, qs=(3,) * ns)
    prob = SocpProblem(c=np.eye(nv)[it], G=G, h=h, dims=dims, A=A, b=b)
    return prob, {"steering_sidelobe": As, "steering_target": a0, "n_elem": n_elem}


def sidelobe_level(info: dict, x: np.ndarray) -> float:
    n_elem = info["n_elem"]
    w = x[:n_elem] + 1j * x[n_elem : 2 * n_elem]
    return float(np.max(np.abs(np.conj(info["steering_sidelobe"]) @ w)))
