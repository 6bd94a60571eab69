"""Port cone kernels (socp_tpu_torch.cones.ops, batched) vs the reference
(socp_tpu.cones.ops under jax.vmap), f64 on the CPU.

Layout l=3, qs=(1,4,9): an orthant, a dim-1 SOC (padded to 8, so the
u0/u1 split of a padded block is exercised) and two buckets.  B = 5 random
interior points from a numpy seed; rtol 1e-12 (both sides are f64 with the
same formulas; only reduction order differs)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from socp_tpu.cones import ops as rops
from socp_tpu.cones.layout import make_layout as rmake_layout
from socp_tpu.problem import ConeDims as RConeDims
from socp_tpu_torch.cones import ops as tops
from socp_tpu_torch.cones.layout import make_layout
from socp_tpu_torch.problem import ConeDims
from tests._host_memory import release_host_memory  # noqa: F401

B = 5
RTOL, ATOL = 1e-12, 1e-13
DIMS = (3, (1, 4, 9))
TL = make_layout(ConeDims(*DIMS))
RL = rmake_layout(RConeDims(*DIMS))


def _interior(rng):
    """(B, m_pad) strictly interior points, padded with zeros."""
    l, qs = DIMS
    out = []
    for _ in range(B):
        parts = [rng.uniform(0.5, 2.0, size=l)]
        for q in qs:
            u1 = rng.normal(size=q - 1)
            parts.append(np.concatenate(
                [[np.linalg.norm(u1) + rng.uniform(0.5, 2.0)], u1]))
        out.append(TL.pad_vec(np.concatenate(parts)))
    return np.stack(out)


def _direction(rng, dim1_sign=None):
    """(B, m_pad) random directions; `dim1_sign` fixes the sign of the dim-1
    SOC's coordinate (original index l)."""
    d = rng.normal(size=(B, TL.m_orig))
    if dim1_sign is not None:
        d[:, DIMS[0]] = dim1_sign * np.abs(d[:, DIMS[0]])
    return np.stack([TL.pad_vec(v) for v in d])


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    s, z = _interior(rng), _interior(rng)
    return dict(
        # a dim-1 SOC moving toward its boundary is a double root of the
        # max_step quadratic, where the reference's answer depends on the
        # rounding of b*b - 4ac (ROADMAP.md queue 3; see
        # test_max_step_double_root_is_exact): keep it moving inward here
        s=s, z=z, du=_direction(rng, dim1_sign=1.0), d=_direction(rng),
        G=np.stack([TL.pad_rows(rng.normal(size=(TL.m_orig, 6)))
                    for _ in range(B)]),
        lo=rng.uniform(0.2, 0.5, size=B), hi=rng.uniform(1.5, 3.0, size=B),
    )


def _ref(fn, *args):
    return np.asarray(jax.jit(jax.vmap(fn))(*(jnp.asarray(a) for a in args)))


def _port(fn, *args):
    return fn(*(torch.as_tensor(a) for a in args)).numpy()


def _scaling_fields(sc):
    return [sc.w_orth, *sc.etas, *sc.vs, sc.lam]


CASES = {
    "identity": (lambda D: _ref(lambda s: rops.identity(RL, s.dtype), D["s"]),
                 lambda D: tops.identity(TL, B).numpy()),
    "jprod": (lambda D: _ref(lambda u, v: rops.jprod(RL, u, v), D["s"], D["d"]),
              lambda D: _port(lambda u, v: tops.jprod(TL, u, v), D["s"], D["d"])),
    "jdiv": (lambda D: _ref(lambda u, v: rops.jdiv(RL, u, v), D["s"], D["d"]),
             lambda D: _port(lambda u, v: tops.jdiv(TL, u, v), D["s"], D["d"])),
    "lambda_min": (
        lambda D: _ref(lambda u: rops.lambda_min(RL, u), D["d"]),
        lambda D: _port(lambda u: tops.lambda_min(TL, u), D["d"])),
    "eig_clip_delta": (
        lambda D: _ref(lambda v, lo, hi: rops.eig_clip_delta(RL, v, lo, hi),
                       D["s"], D["lo"], D["hi"]),
        lambda D: _port(lambda v, lo, hi: tops.eig_clip_delta(TL, v, lo, hi),
                        D["s"], D["lo"], D["hi"])),
    "max_step": (
        lambda D: _ref(lambda u, du: rops.max_step(RL, u, du), D["s"], D["du"]),
        lambda D: _port(lambda u, du: tops.max_step(TL, u, du), D["s"], D["du"])),
    "apply_W": (
        lambda D: _ref(lambda s, z, u: rops.apply_W(RL, rops.nt_scale(RL, s, z), u),
                       D["s"], D["z"], D["d"]),
        lambda D: _port(lambda s, z, u: tops.apply_W(TL, tops.nt_scale(TL, s, z), u),
                        D["s"], D["z"], D["d"])),
    "apply_Winv": (
        lambda D: _ref(lambda s, z, u: rops.apply_Winv(RL, rops.nt_scale(RL, s, z), u),
                       D["s"], D["z"], D["d"]),
        lambda D: _port(lambda s, z, u: tops.apply_Winv(TL, tops.nt_scale(TL, s, z), u),
                        D["s"], D["z"], D["d"])),
    "scale_rows_Winv": (
        lambda D: _ref(lambda s, z, G: rops.scale_rows_Winv(RL, rops.nt_scale(RL, s, z), G),
                       D["s"], D["z"], D["G"]),
        lambda D: _port(lambda s, z, G: tops.scale_rows_Winv(TL, tops.nt_scale(TL, s, z), G),
                        D["s"], D["z"], D["G"])),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_cone_op_matches_reference(data, name):
    ref_fn, port_fn = CASES[name]
    np.testing.assert_allclose(port_fn(data), ref_fn(data), rtol=RTOL, atol=ATOL)


def test_nt_scale_matches_reference(data):
    ref = jax.jit(jax.vmap(lambda s, z: rops.nt_scale(RL, s, z)))(
        jnp.asarray(data["s"]), jnp.asarray(data["z"]))
    port = tops.nt_scale(TL, torch.as_tensor(data["s"]), torch.as_tensor(data["z"]))
    for r, p in zip(_scaling_fields(ref), _scaling_fields(port)):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=RTOL, atol=ATOL)
    # the scaling maps z to lam and s to lam: W z = W^-1 s = lam
    s, z = torch.as_tensor(data["s"]), torch.as_tensor(data["z"])
    np.testing.assert_allclose(tops.apply_W(TL, port, z).numpy(),
                               port.lam.numpy(), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(tops.apply_Winv(TL, port, s).numpy(),
                               port.lam.numpy(), rtol=1e-10, atol=1e-12)


def test_identity_scaling_matches_reference():
    ref = rops.identity_scaling(RL, jnp.float64)
    port = tops.identity_scaling(TL, B)
    for r, p in zip(_scaling_fields(ref), _scaling_fields(port)):
        np.testing.assert_array_equal(
            p.numpy(), np.broadcast_to(np.asarray(r), p.shape))


def test_max_step_double_root_is_exact(data):
    """A dim-1 SOC block moving toward its boundary: the exact step is
    -u0/du0 (a double root of det(u + a du) = 0).  The port returns it to
    rounding; the reference may return inf or an answer off by sqrt(eps)."""
    rng = np.random.default_rng(12)
    du = _direction(rng, dim1_sign=-1.0)
    u = torch.as_tensor(data["s"])
    alpha = tops.max_step(TL, u, torch.as_tensor(du))
    idx = TL.perm_np[DIMS[0]]
    exact = -data["s"][:, idx] / du[:, idx]
    assert torch.all(alpha <= torch.as_tensor(exact) * (1 + 1e-12))
    # the step reaches the boundary of the cone and never leaves it
    lmin = tops.lambda_min(TL, u + alpha[:, None] * torch.as_tensor(du))
    assert torch.all(lmin >= -1e-12) and torch.all(lmin <= 1e-12)
