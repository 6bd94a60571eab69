"""The port's copy of the antenna-array design model (the third family of
BASELINE's shared set) and its solves on the CPU against socp_tpu.solve,
on the instance of tests/test_dense_solver.py::test_model_antenna.

Held: the same instance arrays; status OPTIMAL on both sides, pcost within
1e-8 and the sidelobe level at most the optimal value (1 + 1e-5), once
per KKT route.  Its 34 dim-3 SOC blocks are more than the structured
assembly takes (32), so under native_dd it runs the scaled-matrix
assembly, which the test sees."""

import numpy as np
import pytest

import socp_tpu
import socp_tpu_torch
from socp_tpu.models.antenna import antenna_design as rantenna
from socp_tpu_torch import SolverConfig
from socp_tpu_torch.cones import ops as tops
from socp_tpu_torch.cones.layout import make_layout
from socp_tpu_torch.kkt import structured
from socp_tpu_torch.models.antenna import antenna_design, sidelobe_level
from tests._host_memory import release_host_memory  # noqa: F401


def test_antenna_instance_is_the_references():
    prob, info = antenna_design(0, n_elem=8, n_angles=40)
    rprob, rinfo = rantenna(0, n_elem=8, n_angles=40)
    for f in ("c", "G", "h", "A", "b"):
        assert np.array_equal(getattr(prob, f), getattr(rprob, f))
    assert prob.P is rprob.P is None
    assert (prob.dims.l, prob.dims.qs) == (rprob.dims.l, rprob.dims.qs)
    assert np.array_equal(info["steering_sidelobe"], rinfo["steering_sidelobe"])


@pytest.fixture(scope="module")
def reference():
    prob, _ = rantenna(0, n_elem=8, n_angles=40)
    return socp_tpu.solve(prob)


@pytest.mark.parametrize("native_dd", [False, True])
def test_antenna_matches_reference(reference, native_dd, monkeypatch):
    prob, info = antenna_design(0, n_elem=8, n_angles=40)
    layout = make_layout(prob.dims)
    assert len(prob.dims.qs) == 34 > structured.STRUCT_MAX_BLOCKS
    calls = []
    real = tops.scale_rows_Winv
    monkeypatch.setattr(tops, "scale_rows_Winv",
                        lambda *a: calls.append(1) or real(*a))
    sol = socp_tpu_torch.solve(prob, config=SolverConfig(native_dd=native_dd),
                               device="cpu")
    # both routes assemble W^-1 G here: the native one by its fallback
    assert calls
    assert structured.route(layout, None) == "dense"
    print(f"native_dd={native_dd}: iterations ref {reference.iterations} "
          f"port {sol.iterations}")
    assert sol.status_name == reference.status_name == "optimal"
    assert abs(sol.pcost - reference.pcost) <= 1e-8 * max(1.0, abs(reference.pcost))
    assert sidelobe_level(info, sol.x) <= sol.pcost * (1 + 1e-5)
