"""The port's batched lockstep solve (device="cpu": the kernels' plain
versions) vs socp_tpu.solve_batch_raw, instance by instance.

Held: equal statuses, pcost to 1e-8 relative, gap <= 1e-7 on optimal
instances.  Iteration counts are compared and a mismatch is only reported
in the assertion message of a failing check (a differently-rounded solve
may take one more lockstep iteration on a straggler: not a fault)."""

import copy

import numpy as np
import pytest

import socp_tpu
import socp_tpu_torch
from socp_tpu import SolverConfig as RConfig
from socp_tpu.models.random_socp import primal_infeasible_lp, random_socp
from socp_tpu.models.robust_ls import robust_ls_batch
from socp_tpu_torch import SolverConfig
from socp_tpu_torch.carry import from_reference_warm
from tests._host_memory import release_host_memory  # noqa: F401


def _robust_ls():
    c, G, h, dims = robust_ls_batch(0, 8, n=16, k=24)
    return dict(c=c, G=G, h=h, dims=dims), {}


def _random_with_A():
    """tests/test_batched.py:13-29: B = 4 with equality constraints."""
    probs = [random_socp(s, n=20, l=6, qs=(4, 6), p=3)[0] for s in range(4)]
    stack = lambda f: np.stack([getattr(pr, f) for pr in probs])
    return dict(c=stack("c"), G=stack("G"), h=stack("h"), dims=probs[0].dims,
                A=stack("A"), b=stack("b")), {}


def _mixed_status():
    """tests/test_batched.py:41-61: one infeasible lane, one optimal."""
    good = primal_infeasible_lp(0)
    feas = copy.deepcopy(good)
    feas.h = feas.h.copy()
    feas.h[1] = 2.0
    return dict(c=np.stack([good.c, feas.c]), G=np.stack([good.G, feas.G]),
                h=np.stack([good.h, feas.h]), dims=good.dims), {"max_iter": 80}


def _max_iter():
    """max_iter = 2: every lane exits MAX_ITERATIONS through the restore
    path (best iterate, relaxed acceptance, exit certificates)."""
    data, _ = _robust_ls()
    return data, {"max_iter": 2, "collect_history": True}


CASES = {"robust_ls": _robust_ls, "random_socp_with_A": _random_with_A,
         "mixed_status": _mixed_status, "max_iter_2": _max_iter}


def _compare(ref, out, label):
    rs, ps = np.asarray(ref[4]), np.asarray(out[4])
    rk, pk = np.asarray(ref[5]), np.asarray(out[5])
    iters = f"{label}: iterations ref {rk.tolist()} port {pk.tolist()}"
    np.testing.assert_array_equal(ps, rs, err_msg=iters)
    rp, pp = np.asarray(ref[6])[:, 0], np.asarray(out[6])[:, 0]
    rel = np.abs(pp - rp) / np.maximum(1.0, np.abs(rp))
    assert np.all(rel <= 1e-8), f"pcost rel {rel.tolist()}; {iters}"
    opt = ps == int(socp_tpu_torch.Status.OPTIMAL)
    assert np.all(np.asarray(out[6])[opt, 2] <= 1e-7), iters
    return rk, pk


@pytest.mark.parametrize("case", sorted(CASES))
def test_solve_batch_raw_matches_reference(case):
    data, cfg = CASES[case]()
    ref = socp_tpu.solve_batch_raw(**data, config=RConfig(**cfg))
    out = socp_tpu_torch.solve_batch_raw(**data, config=SolverConfig(**cfg),
                                         device="cpu")
    assert len(out) == 8
    assert [np.shape(a) for a in out] == [np.shape(a) for a in ref]
    _compare(ref, out, case)
    if cfg.get("collect_history"):
        np.testing.assert_allclose(out[7], np.asarray(ref[7]), rtol=1e-9,
                                   atol=1e-12)


@pytest.mark.parametrize("p", [0, 2])
def test_dim1_soc_batch_matches_reference_iterations(p):
    """Two dim-1 SOC blocks per instance, where the port's max_step counts a
    discriminant within rounding of 0 as 0 and the reference does not
    (ROADMAP.md queue 3): statuses and iteration counts are equal lane for
    lane, so the difference changes no solve on this batch."""
    probs = [random_socp(s, n=14, l=4, qs=(1, 1, 5), p=p)[0] for s in range(6)]
    stack = lambda f: np.stack([getattr(pr, f) for pr in probs])
    data = dict(c=stack("c"), G=stack("G"), h=stack("h"), dims=probs[0].dims)
    if p:
        data.update(A=stack("A"), b=stack("b"))
    ref = socp_tpu.solve_batch_raw(**data)
    out = socp_tpu_torch.solve_batch_raw(**data, device="cpu")
    rk, pk = _compare(ref, out, f"dim1 p={p}")
    np.testing.assert_array_equal(pk, rk)


def test_warm_start_from_reference_iterates():
    """Both solvers restart from the reference's padded outputs on a
    perturbed problem; the warm tuple crosses via carry.from_reference_warm."""
    data, _ = _robust_ls()
    fn, args, rlayout = socp_tpu.prepare_batch(**data)
    x, y, s, z = (np.asarray(a) for a in fn(*args)[:4])
    h2 = data["h"] + 1e-3 * np.random.default_rng(5).normal(size=data["h"].shape)
    warm_data = dict(data, h=h2)

    fw, aw, _ = socp_tpu.prepare_batch(**warm_data, has_warm=True)
    ref = fw(*aw, (x, y, s, z))
    pfn, pargs, layout = socp_tpu_torch.prepare_batch(
        **warm_data, has_warm=True, device="cpu")
    assert layout.perm == rlayout.perm and layout.m_pad == rlayout.m_pad
    warm = from_reference_warm(x, y, s, z, layout, device="cpu")
    out = [t.numpy() for t in pfn(*pargs, warm)]
    rk, pk = _compare([np.asarray(a) for a in ref], out, "warm")
    # a warm start from a nearby optimum is cheaper than a cold solve
    cold = socp_tpu_torch.solve_batch_raw(**warm_data, device="cpu")
    assert pk.mean() <= np.asarray(cold[5]).mean()
