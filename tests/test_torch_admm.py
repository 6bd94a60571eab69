"""The port's consensus ADMM (socp_tpu_torch/parallel/admm.py), its
stochastic model and its checkpoint, against the reference's
`socp_tpu.parallel.admm.admm_consensus` (default config, no mesh), on the
CPU (the kernels' plain versions).

Three reference shapes, each compiled once (a cold and a warm vmapped IPM)
and shared through module-scoped fixtures: tests/test_admm.py:12's
(`scenario_portfolio(0, n=12, k=3, n_scenarios=6)`), its chunked shape
(seed 5, n = 10, 8 scenarios in chunks of 4) and its adaptive-rho shape
(seed 4, n = 10, 4 scenarios).  Config 5 at bench_all's small scale is
held to the reference's numbers, kept here (its dd32 compile is too slow
for this suite).

Tolerances: the port runs the same f64 arithmetic as the reference in
another order (torch's reductions against XLA's), so its rounds, rho and
inner status are held equal, and w_bar, x and the objective to 1e-9
absolute (the two differed by about 1e-15 on every shape tried).  Within
the port, where only the batch a lane runs in changes, the bits must be
equal; a resumed run is held to the uninterrupted one at rtol 1e-12, as
tests/test_admm.py holds the reference.
"""

import numpy as np
import pytest
import torch

from socp_tpu.models.stochastic import extensive_form as ref_extensive_form
from socp_tpu.models.stochastic import scenario_portfolio as ref_scenario_portfolio
from socp_tpu.parallel.admm import admm_consensus as ref_admm
from socp_tpu.utils.checkpoint import SolverCheckpoint as RefCheckpoint
from socp_tpu_torch import SolverConfig, Status, solve
from socp_tpu_torch.models.stochastic import extensive_form, scenario_portfolio
from socp_tpu_torch.parallel import admm
from socp_tpu_torch.utils.checkpoint import SolverCheckpoint
from tests._host_memory import release_host_memory  # noqa: F401

TOL = 1e-9          # port against reference: w_bar, x, objective (absolute)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """On these shapes the port's CPU path is eager-op overhead, and
    torch's intra-op threads only contend with the other test workers (a
    run took 3x as long with 8 threads as with 1)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _problem(seed, n, k, S):
    c, G, h, dims, A, b, info = scenario_portfolio(seed, n=n, k=k, n_scenarios=S)
    return (c, G, h, dims), dict(n_consensus=info["n"], A=A, b=b), info


def _port(data, kw, **extra):
    return admm.admm_consensus(*data, **kw, device="cpu", **extra)


def _ref(data, kw, **extra):
    return ref_admm(*data, **kw, **extra)


def _close(port, ref, tol=TOL):
    assert port.outer_iterations == ref.outer_iterations
    assert port.rho == ref.rho
    assert port.inner_status_ok == ref.inner_status_ok
    np.testing.assert_allclose(port.w_bar, ref.w_bar, rtol=0, atol=tol)
    np.testing.assert_allclose(port.x, ref.x, rtol=0, atol=tol)
    assert abs(port.objective - ref.objective) <= tol


def _equal(a, b):
    assert a.outer_iterations == b.outer_iterations and a.rho == b.rho
    assert a.inner_status_ok == b.inner_status_ok
    assert np.array_equal(a.w_bar, b.w_bar) and np.array_equal(a.x, b.x)
    assert (a.objective, a.primal_res, a.dual_res) == (
        b.objective, b.primal_res, b.dual_res)


# ---- tests/test_admm.py:12's shape: 100 rounds to tol 1e-6 (43 rounds)

MAIN = dict(rho=1.0, outer_iters=100, tol=1e-6)


@pytest.fixture(scope="module")
def main_case():
    data, kw, info = _problem(0, 12, 3, 6)
    return data, kw, info, _ref(data, kw, **MAIN), _port(data, kw, **MAIN)


@pytest.mark.parametrize("seed", [0, 1])
def test_generator_and_extensive_form_equal_reference(seed):
    ref = ref_scenario_portfolio(seed, n=12, k=3, n_scenarios=6)
    port = scenario_portfolio(seed, n=12, k=3, n_scenarios=6)
    for r, p in zip(ref[:3] + ref[4:6], port[:3] + port[4:6]):
        assert np.array_equal(r, p)
    assert (port[3].l, port[3].qs) == (ref[3].l, tuple(ref[3].qs))
    for key in ("mus", "F", "Dhalf"):
        assert np.array_equal(port[6][key], ref[6][key])
    re, pe = ref_extensive_form(*ref), extensive_form(*port)
    for f in ("c", "G", "h", "A", "b"):
        assert np.array_equal(getattr(pe, f), getattr(re, f)), f
    assert (pe.dims.l, pe.dims.qs) == (re.dims.l, tuple(re.dims.qs))


def test_admm_matches_reference(main_case):
    *_, ref, port = main_case
    assert port.outer_iterations == 43 and port.inner_status_ok
    _close(port, ref)
    assert port.primal_res <= 1e-6 and port.dual_res <= 1e-6


def test_admm_matches_extensive_form(main_case):
    """tests/test_admm.py:12-30's checks, on the port's own solve."""
    data, kw, info, _, port = main_case
    prob = extensive_form(*data, kw["A"], kw["b"], info)
    ext = solve(prob, device="cpu")
    assert ext.status == Status.OPTIMAL
    assert port.primal_res <= 1e-5
    assert abs(port.objective - ext.pcost) <= 5e-4 * max(1.0, abs(ext.pcost))
    assert abs(port.w_bar.sum() - 1.0) <= 1e-6
    assert port.w_bar.min() >= -1e-6


# ---- chunked (tests/test_admm.py:94's shape)

CHUNK = dict(rho=1.0, outer_iters=6, tol=0.0)


@pytest.fixture(scope="module")
def chunk_case():
    data, kw, _ = _problem(5, 10, 3, 8)
    return (data, kw, _ref(data, kw, scenario_chunk=4, **CHUNK),
            _port(data, kw, scenario_chunk=4, **CHUNK))


def test_chunked_equals_unchunked_bit_for_bit(chunk_case):
    data, kw, _, chunked = chunk_case
    _equal(chunked, _port(data, kw, **CHUNK))


def test_chunked_matches_reference_chunked(chunk_case):
    _, _, ref, port = chunk_case
    _close(port, ref)


def test_scenarios_not_divisible_by_chunk_raise():
    data, kw, _ = _problem(5, 10, 3, 8)
    with pytest.raises(ValueError, match="not divisible"):
        _port(data, kw, scenario_chunk=3, **CHUNK)


# ---- checkpoint / resume

@pytest.mark.parametrize("chunk,seed,S,full,cut", [(None, 3, 4, 8, 4),
                                                   (4, 6, 8, 6, 3)])
def test_checkpoint_resume(tmp_path, chunk, seed, S, full, cut):
    """tests/test_admm.py:65 and :111 in the port: interrupt at `cut`
    through the snapshot, resume, and land on the uninterrupted run."""
    data, kw, _ = _problem(seed, 10, 3, S)
    kw = dict(kw, rho=1.0, tol=0.0, scenario_chunk=chunk)
    path = str(tmp_path / "admm_ck.npz")
    whole = _port(data, kw, outer_iters=full)
    _port(data, kw, outer_iters=cut, checkpoint_every=cut, checkpoint_path=path)
    ck = SolverCheckpoint.load(path)
    assert ck.iteration == cut and ck.meta["warm_x"].shape == (S, 11)
    resumed = _port(data, kw, outer_iters=full, resume_from=ck)
    assert resumed.outer_iterations == full - cut
    np.testing.assert_allclose(resumed.w_bar, whole.w_bar, rtol=1e-12,
                               atol=1e-12)


def test_checkpoints_cross_between_the_packages(tmp_path):
    """A reference snapshot (round 4 of the main shape) resumes in the
    port and lands on the port's uninterrupted 8 rounds; a port snapshot
    loads as the reference's SolverCheckpoint, key for key, and resumes
    in the reference onto the reference's uninterrupted run."""
    data, kw, _ = _problem(0, 12, 3, 6)
    kw = dict(kw, rho=1.0, tol=0.0)
    ref_path, port_path = str(tmp_path / "ref.npz"), str(tmp_path / "port.npz")
    _ref(data, kw, outer_iters=4, checkpoint_every=4, checkpoint_path=ref_path)
    resumed = _port(data, kw, outer_iters=8, resume_from=ref_path)
    whole = _port(data, kw, outer_iters=8)
    assert resumed.outer_iterations == 4
    np.testing.assert_allclose(resumed.w_bar, whole.w_bar, rtol=0, atol=TOL)

    _port(data, kw, outer_iters=4, checkpoint_every=4, checkpoint_path=port_path)
    mine, theirs = SolverCheckpoint.load(port_path), RefCheckpoint.load(port_path)
    assert mine.iteration == theirs.iteration == 4
    assert sorted(mine.meta) == sorted(theirs.meta) == sorted(
        RefCheckpoint.load(ref_path).meta)
    for k in ("x", "y"):
        assert np.array_equal(getattr(mine, k), getattr(theirs, k))
    ref_resumed = _ref(data, kw, outer_iters=8, resume_from=port_path)
    ref_whole = _ref(data, kw, outer_iters=8)
    np.testing.assert_allclose(ref_resumed.w_bar, ref_whole.w_bar, rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("what", ["cadence_without_path", "checkpoint_at_end"])
def test_checkpoint_value_errors(tmp_path, what):
    data, kw, _ = _problem(3, 10, 3, 4)
    kw = dict(kw, rho=1.0, tol=0.0)
    if what == "cadence_without_path":
        with pytest.raises(ValueError, match="checkpoint_path"):
            _port(data, kw, outer_iters=2, checkpoint_every=1)
        return
    ck = SolverCheckpoint(x=np.zeros(10), y=np.zeros((4, 10)), s=np.zeros(0),
                          z=np.zeros(0), iteration=3, meta={"rho": 1.0})
    with pytest.raises(ValueError, match="nothing to resume"):
        _port(data, kw, outer_iters=3, resume_from=ck)


# ---- adaptive rho (tests/test_admm.py:134's shape)

def test_adaptive_rho_matches_reference():
    data, kw, _ = _problem(4, 10, 3, 4)
    run = dict(rho=1e-3, outer_iters=60, tol=1e-5, adapt_rho=True)
    ref, port = _ref(data, kw, **run), _port(data, kw, **run)
    assert port.rho != 1e-3 and port.inner_status_ok
    assert port.primal_res <= 1e-5 and port.dual_res <= 1e-5
    _close(port, ref)


# ---- host traffic and the native route

@pytest.mark.parametrize("chunk", [None, 2])
def test_one_host_fetch_a_round(monkeypatch, chunk):
    calls = []
    fetch = admm._fetch

    def counted(*args):
        calls.append(args)
        return fetch(*args)

    monkeypatch.setattr(admm, "_fetch", counted)
    data, kw, _ = _problem(3, 10, 3, 4)
    res = _port(data, kw, rho=1.0, outer_iters=3, tol=0.0, scenario_chunk=chunk)
    assert res.outer_iterations == len(calls) == 3
    assert all(a.ndim == 0 for args in calls for a in args)


def test_native_dd_matches_default_route():
    """The structured assembly (kkt/structured.py, ConstGram with one SOC
    block) against the default assembly, 8 rounds: w_bar and x within
    1e-8."""
    data, kw, _ = _problem(3, 10, 3, 4)
    run = dict(rho=1.0, outer_iters=8, tol=0.0)
    base = _port(data, kw, **run)
    native = _port(data, kw, config=SolverConfig(native_dd=True), **run)
    assert native.inner_status_ok and base.inner_status_ok
    assert native.outer_iterations == base.outer_iterations
    np.testing.assert_allclose(native.w_bar, base.w_bar, rtol=0, atol=1e-8)
    np.testing.assert_allclose(native.x, base.x, rtol=0, atol=1e-8)


# ---- config 5 at bench_all's small scale

# The reference's 10 rounds at S = 256 as scripts/bench_all.py:177-200
# calls it off the TPU (scenario_portfolio(0, n=20, n_scenarios=256),
# rho = 1, SolverConfig(factor_dtype="dd32")), run on the CPU with x64.
# Its dd32 graphs take about 3 minutes to compile, so the numbers are kept
# here (chip_smoke.py's REF5 holds the port's CPU re-run to the same).
REF_SMALL = {"pres": 0.010473211701971484, "dres": 0.02789616956783297,
             "objective": -0.1839553781855421}


def test_config5_small_scale_matches_reference_numbers():
    """The dd32 factor and the port's f64 one are not bit-equal: pres and
    dres within 1e-6 relative, the objective within 1e-7, the same rounds
    and rho, every inner solve OPTIMAL."""
    data, kw, _ = _problem(0, 20, 4, 256)
    res = _port(data, kw, rho=1.0, outer_iters=10, scenario_chunk=256,
                config=SolverConfig(factor_dtype="dd32"))
    assert (res.outer_iterations, res.rho, res.inner_status_ok) == (10, 1.0, True)
    assert abs(res.primal_res - REF_SMALL["pres"]) <= 1e-6 * REF_SMALL["pres"]
    assert abs(res.dual_res - REF_SMALL["dres"]) <= 1e-6 * REF_SMALL["dres"]
    assert abs(res.objective - REF_SMALL["objective"]) <= 1e-7
