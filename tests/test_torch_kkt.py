"""Port condensed KKT (factor + solve_refined, batched) vs the reference's
socp_tpu.kkt.dense under jax.vmap, on the same NT scaling, f64 on the CPU.

Two cases: p = 0 (the robust-LS shape: no equalities, no P) and p = 3 with
a P term (the A-Schur factor, rho A'A augmentation and the y correction).
B = 4 instances from a numpy seed; directions agree to rtol 1e-10."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from socp_tpu.cones import ops as rops
from socp_tpu.cones.layout import make_layout as rmake_layout
from socp_tpu.kkt import dense as rdense
from socp_tpu.problem import ConeDims as RConeDims
from socp_tpu_torch.cones import ops as tops
from socp_tpu_torch.cones.layout import make_layout
from socp_tpu_torch.kkt import dense as tdense
from socp_tpu_torch.problem import ConeDims
from tests._host_memory import release_host_memory  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """On these shapes the port's CPU path is eager-op overhead, and
    torch's intra-op threads only contend with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


B, N = 4, 8
DIMS = (3, (1, 4, 9))
TL = make_layout(ConeDims(*DIMS))
RL = rmake_layout(RConeDims(*DIMS))
DELTA, RHO, STEPS = 1e-11, 1.0, 1


def _interior(rng):
    l, qs = DIMS
    parts = [rng.uniform(0.5, 2.0, size=(B, l))]
    for q in qs:
        u1 = rng.normal(size=(B, q - 1))
        u0 = np.linalg.norm(u1, axis=1, keepdims=True) + rng.uniform(0.5, 2.0, size=(B, 1))
        parts += [u0, u1]
    return TL.pad_vec(np.concatenate(parts, axis=1))


def _case(p, with_P):
    rng = np.random.default_rng(20 + p)
    d = dict(
        s=_interior(rng), z=_interior(rng),
        G=TL.pad_rows(rng.normal(size=(B, TL.m_orig, N))),
        A=rng.normal(size=(B, p, N)),
        bx=rng.normal(size=(B, N)), by=rng.normal(size=(B, p)),
        bz=TL.pad_vec(rng.normal(size=(B, TL.m_orig))),
    )
    if with_P:
        M = rng.normal(size=(B, N, N)) / np.sqrt(N)
        d["P"] = M @ np.swapaxes(M, 1, 2) + 0.1 * np.eye(N)
    return d


def _ref(d, p, with_P):
    aug = RHO if p else 0.0

    def one(s, z, G, A, bx, by, bz, P=None):
        Paug = aug * (A.T @ A) if p else None
        if with_P:
            Paug = P if Paug is None else Paug + P
        kkt = rdense.factor(RL, rops.nt_scale(RL, s, z), Paug, A, G, DELTA)
        return rdense.solve_refined(RL, kkt, P, A, G, bx, by, bz,
                                    refine_steps=STEPS, aug_rho=aug)

    keys = ["s", "z", "G", "A", "bx", "by", "bz"] + (["P"] if with_P else [])
    out = jax.jit(jax.vmap(one))(*(jnp.asarray(d[k]) for k in keys))
    return [np.asarray(o) for o in out]


def _port(d, p, with_P):
    t = {k: torch.as_tensor(v) for k, v in d.items()}
    aug = RHO if p else 0.0
    Paug = aug * (t["A"].transpose(1, 2) @ t["A"]) if p else None
    if with_P:
        Paug = t["P"] if Paug is None else Paug + t["P"]
    kkt = tdense.factor(TL, tops.nt_scale(TL, t["s"], t["z"]), Paug, t["A"],
                        t["G"], DELTA)
    out = tdense.solve_refined(TL, kkt, t.get("P"), t["A"], t["G"], t["bx"],
                               t["by"], t["bz"], refine_steps=STEPS, aug_rho=aug)
    return [o.numpy() for o in out]


@pytest.mark.parametrize("p,with_P", [(0, False), (3, True)])
def test_factor_solve_refined_matches_reference(p, with_P):
    d = _case(p, with_P)
    ref = _ref(d, p, with_P)
    port = _port(d, p, with_P)
    for name, r, q in zip(("dx", "dy", "dz"), ref, port):
        np.testing.assert_allclose(q, r, rtol=1e-10, atol=1e-12, err_msg=name)
    # quality (relative residual before the correction) is rounding-level
    # in both; compare magnitudes, not digits
    assert np.all(port[3] < 1e-10) and np.all(ref[3] < 1e-10)


def test_refined_direction_solves_the_3x3_system():
    """The port's direction satisfies the full KKT system with P, A, G."""
    d = _case(3, True)
    dx, dy, dz, _ = (torch.as_tensor(v) for v in _port(d, 3, True))
    t = {k: torch.as_tensor(v) for k, v in d.items()}
    sc = tops.nt_scale(TL, t["s"], t["z"])
    mv = lambda M, v: (M @ v[..., None])[..., 0]
    rx = mv(t["P"], dx) + mv(t["A"].transpose(1, 2), dy) + mv(t["G"].transpose(1, 2), dz) - t["bx"]
    ry = mv(t["A"], dx) - t["by"]
    rz = mv(t["G"], dx) - tops.apply_W(TL, sc, tops.apply_W(TL, sc, dz)) - t["bz"]
    for r in (rx, ry, rz):
        assert float(r.abs().max()) < 1e-9
