"""The port's examples (socp_tpu_torch/examples/) on the CPU at reduced
sizes, against the reference's NumPy side: its oracle
(`socp_tpu.utils.oracle.solve`) on the same data, or the known optimum of
its generator.

Held: the same status, pcost within 1e-7 relative of the oracle
(portfolio at n = 40, warm_start at n = 30 for 2 days, every cold and
warm solve; batched_robust_ls at B = 4, n = 16, every lane); block_schur
at K = 4 within 1e-6 of the known optimum (tests/test_schur.py:64's
bound); admm_stochastic at S = 4, n = 6, 5 rounds equal to a direct
`admm_consensus` call (which tests/test_torch_admm.py holds to the
reference), its extensive form within 1e-7 of the oracle; huge_cone at
q = 257 the oracle's status, and its pcost where optimal.  Every example
module imports without printing or solving anything.  Nothing of the
reference compiles; about 5 s on one process.
"""

import contextlib
import importlib
import io

import numpy as np
import pytest
import torch

from socp_tpu.problem import ConeDims as RConeDims
from socp_tpu.utils import oracle as ref_oracle
from socp_tpu_torch import Status
from socp_tpu_torch.examples import (admm_stochastic, batched_robust_ls,
                                     block_schur, huge_cone, portfolio,
                                     warm_start)
from socp_tpu_torch.parallel.admm import admm_consensus
from tests._host_memory import release_host_memory  # noqa: F401

EXAMPLES = ("portfolio", "batched_robust_ls", "warm_start", "block_schur",
            "admm_stochastic", "huge_cone")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's CPU path at these shapes is eager-op overhead; torch's
    intra-op threads only contend with the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _oracle(c, G, h, dims, A=None, b=None):
    return ref_oracle.solve(c, G, h, RConeDims(dims.l, tuple(dims.qs)),
                            A=A, b=b)


def _held(status, pcost, ref, tol=1e-7):
    assert int(status) == ref["status"], (status, ref["status_name"])
    assert abs(pcost - ref["pcost"]) <= tol * max(1.0, abs(ref["pcost"])), (
        pcost, ref["pcost"])


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_imports_without_running(name):
    module = importlib.import_module(f"socp_tpu_torch.examples.{name}")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        importlib.reload(module)
    assert out.getvalue() == ""
    assert callable(module.run) and callable(module.main)


def test_portfolio_matches_the_oracle():
    r = portfolio.run(n=40, verbose=False, device="cpu")
    p = r["problem"]
    _held(r["status"], r["pcost"], _oracle(p.c, p.G, p.h, p.dims, p.A, p.b))
    assert r["status"] == Status.OPTIMAL and not r["inaccurate"]
    assert r["risk"] <= r["sigma_max"] * (1 + 1e-6)
    assert r["budget_err"] <= 1e-6 and r["w_min"] >= -1e-7
    assert r["device"] == "cpu"


def test_warm_start_matches_the_oracle():
    r = warm_start.run(n=30, days=2, device="cpu")
    p = r["problem"]
    _held(r["base"].status, r["base"].pcost,
          _oracle(p.c, p.G, p.h, p.dims, p.A, p.b))
    assert len(r["days"]) == 2
    for row in r["days"]:
        ref = _oracle(row["c"], p.G, p.h, p.dims, p.A, p.b)
        _held(row["cold"].status, row["cold"].pcost, ref)
        _held(row["warm"].status, row["warm"].pcost, ref)
    assert r["total_warm"] < r["total_cold"]


def test_batched_robust_ls_matches_the_oracle():
    r = batched_robust_ls.run(B=4, n=16, device="cpu")
    assert not r["config"].native_dd          # the card's route is native_dd
    c, G, h, dims = r["data"]
    out = r["out"]
    assert r["optimal"] == 4 and r["max_gap"] <= 1e-8
    for i in range(4):
        _held(out[4][i], out[6][i, 0], _oracle(c[i], G[i], h[i], dims))


def test_block_schur_reaches_the_known_optimum():
    r = block_schur.run(K=4, verbose=False, device="cpu")
    assert r["status"] == Status.OPTIMAL and r["devices"] == 1
    assert abs(r["pcost"] - r["pstar"]) <= 1e-6 * max(1.0, abs(r["pstar"]))


def test_admm_stochastic_is_the_direct_call():
    r = admm_stochastic.run(S=4, n=6, rounds=5, verbose=False, device="cpu")
    c, G, h, dims, A, b, info = r["data"]
    direct = admm_consensus(c, G, h, dims, info["n"], A=A, b=b, rho=1.0,
                            outer_iters=5, tol=1e-6, device="cpu")
    res = r["admm"]
    assert res.outer_iterations == direct.outer_iterations == 5
    assert res.inner_status_ok and direct.inner_status_ok
    assert res.objective == direct.objective
    np.testing.assert_array_equal(res.w_bar, direct.w_bar)
    np.testing.assert_array_equal(res.x, direct.x)
    p = r["extensive_problem"]
    _held(r["extensive"].status, r["extensive"].pcost,
          _oracle(p.c, p.G, p.h, p.dims, p.A, p.b))


def test_huge_cone_matches_the_oracle():
    r = huge_cone.run(q=257, device="cpu")
    c, G, h, l, qs, _, _ = r["data"]
    ref = _oracle(c, G, h, RConeDims(l, qs))
    assert int(r["status"]) == ref["status"], (r["status"], ref["status_name"])
    if r["status"] == Status.OPTIMAL:
        _held(r["status"], r["pcost"], ref)
    assert r["devices"] == 1 and r["q"] == 257
