"""The port's mixed-precision mode, `SolverConfig(factor_dtype="float32")`
(the f32 factor and back-solves under f64 refinement), against the
reference's on the CPU.

  chol (f32)      plain versions vs socp_tpu.ops.pallas_chol.cholesky_f32
  tri_pair (f32)  plain versions vs socp_tpu.ops.pallas_chol.tri_solve_f32
                  (interpret mode), at test_pallas.py:20-35's tolerances
  kkt.dense       f32 factor + solve_refined vs the reference's on one NT
                  scaling
  solves          solve_batch_raw / solve vs the reference's, four cases

The f32 factor stalls near a 1e-6 gap and its solves end "optimal,
inaccurate" through the relaxed tolerances, in the reference as in the
port.  Held: equal status; pcost within 5e-5 relative (`reltol_inacc`);
the relaxed tolerances (pres, dres <= 1e-4, gap or relgap <= 5e-5) met;
the inaccurate flag equal, except where the instance's dres hovers at the
strict 1e-8 limit and rounding decides between a strict exit and a relaxed
one: there the side whose flag is 0 must have met the strict tolerances.
The reference itself flips that way on `random_socp(0, n=20, l=6,
qs=(4, 6), p=3)`: strict in 6 iterations solved alone, inaccurate in 12 as
lane 0 of the B = 4 batch (`test_flag_is_decided_by_rounding`).  Iteration
counts are compared and reported (printed, and in the assertion
messages), not held.

Cost: about 25 s of CPU, most of it six reference compiles.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import socp_tpu
import socp_tpu_torch
from socp_tpu import SolverConfig as RConfig
from socp_tpu.cones import ops as rops
from socp_tpu.cones.layout import make_layout as rmake_layout
from socp_tpu.kkt import dense as rdense
from socp_tpu.models.portfolio import portfolio
from socp_tpu.models.random_socp import random_socp
from socp_tpu.models.robust_ls import robust_ls_batch
from socp_tpu.ops.pallas_chol import cholesky_f32, tri_solve_f32
from socp_tpu.problem import ConeDims as RConeDims
from socp_tpu_torch import SolverConfig
from socp_tpu_torch.carry import problem_from_reference
from socp_tpu_torch.cones import ops as tops
from socp_tpu_torch.cones.layout import make_layout
from socp_tpu_torch.kkt import dense as tdense
from socp_tpu_torch.ops import chol
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


F32 = dict(factor_dtype="float32")
STRICT, FEAS_INACC, GAP_INACC, PCOST_REL = 1e-8, 1e-4, 5e-5, 5e-5


def _spd(rng, n, kappa=1e4):
    """tests/test_pallas.py's SPD inputs (kappa 1e4: f32 cannot factor 1e8)."""
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    ev = np.logspace(-np.log10(kappa), 0, n)
    H = (Q * ev) @ Q.T
    return ((H + H.T) / 2).astype(np.float32)


# ---- the f32 kernels' plain versions -------------------------------------


@pytest.mark.parametrize("route", ["single_n32", "batched_b4_n16"])
def test_f32_chol_plain_matches_pallas(route):
    """test_pallas.py:20-35: rtol 2e-5, atol 2e-6."""
    rng = np.random.default_rng(0 if route == "single_n32" else 1)
    if route == "single_n32":
        H = _spd(rng, 32)
        ref = jax.jit(cholesky_f32)(jnp.asarray(H))
        L = chol.chol_single(torch.as_tensor(H))
    else:
        H = np.stack([_spd(rng, 16) for _ in range(4)])
        ref = jax.jit(jax.vmap(cholesky_f32))(jnp.asarray(H))
        L = chol.chol_batched(torch.as_tensor(H))
    assert L.dtype == torch.float32
    np.testing.assert_allclose(L.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("n,k", [(24, 1), (37, 3)])
def test_f32_tri_pair_plain_matches_pallas(n, k):
    """Both compute forward then backward substitution in f32 in the same
    axpy order; the reference's interpret mode rounds some steps otherwise
    (at most 3.5e-7 of max |x| here), so: rtol 1e-5, atol 1e-6 max |x|."""
    rng = np.random.default_rng(100 + n + k)
    L = chol.chol_single_plain(torch.as_tensor(_spd(rng, n)))
    b = rng.standard_normal((n, k)).astype(np.float32)
    ref = np.asarray(jax.jit(tri_solve_f32)(jnp.asarray(L.numpy()),
                                            jnp.asarray(L.numpy().T), b))
    x = chol.tri_pair_single(L, torch.as_tensor(b))
    xb = chol.tri_pair_batched(L[None].expand(2, n, n).contiguous(),
                               torch.as_tensor(b)[None].expand(2, n, k).contiguous())
    assert torch.equal(xb[0], x) and torch.equal(xb[1], x)
    np.testing.assert_allclose(x.numpy(), ref, rtol=1e-5,
                               atol=1e-6 * np.abs(ref).max())


def test_wrappers_refuse_mixed_dtypes():
    L = torch.eye(3)
    with pytest.raises(TypeError, match="float32.*float64"):
        chol.tri_pair_single(L, torch.ones(3, 1, dtype=torch.float64))
    with pytest.raises(TypeError, match="float32.*float64"):
        chol.tri_pair_batched(L[None], torch.ones(1, 3, 1, dtype=torch.float64))


# ---- kkt.dense in f32 on one scaling ---------------------------------------

B, N, P_EQ = 4, 8, 3
DIMS = (3, (1, 4, 9))
TL, RL = make_layout(ConeDims(*DIMS)), rmake_layout(RConeDims(*DIMS))


def _interior(rng):
    l, qs = DIMS
    parts = [rng.uniform(0.5, 2.0, size=(B, l))]
    for q in qs:
        u1 = rng.normal(size=(B, q - 1))
        u0 = np.linalg.norm(u1, axis=1, keepdims=True) + rng.uniform(0.5, 2.0, size=(B, 1))
        parts += [u0, u1]
    return TL.pad_vec(np.concatenate(parts, axis=1))


def test_f32_factor_solve_refined_matches_reference():
    """p = 3 with P: the A-Schur factor, rho A'A and the dy correction, all
    in f32 under one f64 refinement step.  Both refine one f32 solve
    against the f64 residual, so the directions agree far below f32's
    epsilon: rtol 1e-7, atol 1e-9 (measured here: 2.8e-9 relative, 5.9e-11
    absolute)."""
    rng = np.random.default_rng(23)
    d = dict(s=_interior(rng), z=_interior(rng),
             G=TL.pad_rows(rng.normal(size=(B, TL.m_orig, N))),
             A=rng.normal(size=(B, P_EQ, N)), bx=rng.normal(size=(B, N)),
             by=rng.normal(size=(B, P_EQ)),
             bz=TL.pad_vec(rng.normal(size=(B, TL.m_orig))))
    M = rng.normal(size=(B, N, N)) / np.sqrt(N)
    d["P"] = M @ np.swapaxes(M, 1, 2) + 0.1 * np.eye(N)
    keys = ["s", "z", "G", "A", "bx", "by", "bz", "P"]

    def one(s, z, G, A, bx, by, bz, P):
        kkt = rdense.factor(RL, rops.nt_scale(RL, s, z), A.T @ A + P, A, G,
                            1e-11, factor_dtype="float32")
        return rdense.solve_refined(RL, kkt, P, A, G, bx, by, bz,
                                    refine_steps=1, aug_rho=1.0)

    ref = jax.jit(jax.vmap(one))(*(jnp.asarray(d[k]) for k in keys))
    t = {k: torch.as_tensor(v) for k, v in d.items()}
    A = t["A"]
    kkt = tdense.factor(TL, tops.nt_scale(TL, t["s"], t["z"]),
                        A.transpose(1, 2) @ A + t["P"], A, t["G"], 1e-11,
                        factor_dtype=torch.float32)
    assert kkt.L_H.L.dtype == kkt.L_S.L.dtype == kkt.Ghat.dtype == torch.float32
    assert kkt.scaling.lam.dtype == torch.float64
    assert kkt.scaling_lo.lam.dtype == torch.float32
    out = tdense.solve_refined(TL, kkt, t["P"], A, t["G"], t["bx"], t["by"],
                               t["bz"], refine_steps=1, aug_rho=1.0)
    for name, r, q in zip(("dx", "dy", "dz", "quality"), ref, out):
        assert q.dtype == torch.float64, name
        if name != "quality":
            np.testing.assert_allclose(q.numpy(), np.asarray(r), rtol=1e-7,
                                       atol=1e-9, err_msg=name)
    # the residual before the correction is f32-grade in both
    assert np.all(out[3].numpy() < 1e-4) and np.all(np.asarray(ref[3]) < 1e-4)


# ---- whole solves ----------------------------------------------------------


def _hold(label, rs, ps, rflag, pflag, rcost, pcost, pstats, iters):
    """One instance: status, pcost and the relaxed tolerances (pstats: the
    port's gap, relgap, pres, dres).  Returns whether the flags agree."""
    msg = f"{label}: {iters}"
    assert ps == rs == int(socp_tpu_torch.Status.OPTIMAL), msg
    gap, relgap, pres, dres = pstats
    assert pres <= FEAS_INACC and dres <= FEAS_INACC, msg
    assert gap <= GAP_INACC or relgap <= GAP_INACC, msg
    assert abs(pcost - rcost) <= PCOST_REL * max(1.0, abs(rcost)), msg
    return bool(rflag) == bool(pflag)


def _strict(gap, relgap, pres, dres):
    return pres <= STRICT and dres <= STRICT and (gap <= STRICT or relgap <= STRICT)


def _batch_cases():
    c, G, h, dims = robust_ls_batch(0, 8, n=16, k=24)
    yield "robust_ls", dict(c=c, G=G, h=h, dims=dims)
    probs = [random_socp(s, n=20, l=6, qs=(4, 6), p=3)[0] for s in range(4)]
    stack = lambda f: np.stack([getattr(pr, f) for pr in probs])
    yield "random_socp_with_A", dict(c=stack("c"), G=stack("G"), h=stack("h"),
                                     dims=probs[0].dims, A=stack("A"),
                                     b=stack("b"))


@pytest.mark.parametrize("case", ["robust_ls", "random_socp_with_A"])
def test_f32factor_batch_matches_reference(case):
    data = dict(_batch_cases())[case]
    ref = socp_tpu.solve_batch_raw(**data, config=RConfig(**F32))
    counts = (chol.chol_launches_f32, chol.tri_pair_launches_f32)
    out = socp_tpu_torch.solve_batch_raw(**data, config=SolverConfig(**F32),
                                         device="cpu")
    assert (chol.chol_launches_f32, chol.tri_pair_launches_f32) == counts
    rstats = np.asarray(ref[6])
    iters = f"iterations ref {np.asarray(ref[5]).tolist()} port {out[5].tolist()}"
    print(f"{case}: {iters}; inaccurate ref {rstats[:, 6].tolist()} "
          f"port {out[6][:, 6].tolist()}")
    for i in range(len(out[4])):
        same = _hold(f"{case}[{i}]", int(ref[4][i]), int(out[4][i]),
                     rstats[i, 6], out[6][i, 6], rstats[i, 0], out[6][i, 0],
                     out[6][i, [2, 3, 4, 5]], iters)
        if not same:   # the rounding-decided exit (module doc)
            st = out[6][i] if out[6][i, 6] < 0.5 else rstats[i]
            assert _strict(*st[[2, 3, 4, 5]]), f"{case}[{i}] flags; {iters}"
    if case == "robust_ls":
        # the gap stalls near 1e-6, far above 1e-8: every lane is inaccurate
        assert np.all(out[6][:, 6] == 1.0) and np.all(rstats[:, 6] == 1.0)


@pytest.mark.parametrize("case", ["config1_n50", "portfolio_n64"])
def test_f32factor_single_matches_reference(case):
    if case == "config1_n50":
        prob = random_socp(0, n=50, l=10, qs=(10, 14, 20))[0]
    else:
        prob = portfolio(0, n=64, k=8)[0]
    ref = socp_tpu.solve(prob, config=RConfig(**F32))
    out = socp_tpu_torch.solve(problem_from_reference(prob),
                               config=SolverConfig(**F32), device="cpu")
    print(f"{case}: iterations ref {ref.iterations} port {out.iterations}")
    same = _hold(case, int(ref.status), int(out.status), ref.inaccurate,
                 out.inaccurate, ref.pcost, out.pcost,
                 (out.gap, out.relgap, out.pres, out.dres),
                 f"iterations ref {ref.iterations} port {out.iterations}")
    assert same and out.inaccurate, (ref, out)


def test_flag_is_decided_by_rounding():
    """random_socp(0, n=20, l=6, qs=(4, 6), p=3) solved alone: the
    reference exits strictly, though as lane 0 of the batch above it exits
    inaccurate; the port's flag may go either way, by the rule above."""
    prob = random_socp(0, n=20, l=6, qs=(4, 6), p=3)[0]
    ref = socp_tpu.solve(prob, config=RConfig(**F32))
    out = socp_tpu_torch.solve(problem_from_reference(prob),
                               config=SolverConfig(**F32), device="cpu")
    print(f"random_socp_0 alone: ref {ref.iterations} iterations, inaccurate "
          f"{ref.inaccurate}; port {out.iterations}, {out.inaccurate}")
    assert int(ref.status) == 0 and not ref.inaccurate
    assert _strict(ref.gap, ref.relgap, ref.pres, ref.dres)
    # the flag rule holds whichever way the port exits: the reference's
    # side (flag 0) met the strict tolerances
    _hold("random_socp_0", int(ref.status), int(out.status), ref.inaccurate,
          out.inaccurate, ref.pcost, out.pcost,
          (out.gap, out.relgap, out.pres, out.dres),
          f"iterations ref {ref.iterations} port {out.iterations}")


@pytest.mark.parametrize("fdt", ["float16", "bfloat16", "f32"])
def test_unknown_factor_dtype_raises(fdt):
    c, G, h, dims = robust_ls_batch(0, 2, n=4, k=6)
    with pytest.raises(NotImplementedError, match=f"factor_dtype='{fdt}'"):
        socp_tpu_torch.solve_batch_raw(c, G, h, dims, device="cpu",
                                       config=SolverConfig(factor_dtype=fdt))
    with pytest.raises(NotImplementedError, match=f"factor_dtype='{fdt}'"):
        socp_tpu_torch.solve(problem_from_reference(portfolio(0, n=6, k=2)[0]),
                             device="cpu", config=SolverConfig(factor_dtype=fdt))
