"""The reduction of a trace and the checks a traced stretch must pass,
on synthetic traces."""

import pytest

from benchmark.harness import trace

MS = 1_000_000   # ns


def _events():
    # host: a batch span over everything, a sync inside the one long gap
    host = [(False, "batch", 0, 20 * MS), (False, "cudaStreamSynchronize", 9 * MS, 3 * MS),
            (False, "aten::add", 1 * MS, MS // 10)]
    dev = [(True, "void chol_small_kernel<double, 32, 1>(...)", 0, 2 * MS),
           (True, "ampere_dgemm_64x64_nn", 2 * MS, 3 * MS),
           (True, "void at::native::vectorized_elementwise_kernel<4>()", 4 * MS, 2 * MS),
           (True, "Memcpy DtoH (Device -> Pinned)", 13 * MS, MS)]
    return host + dev


def test_reduce_by_hand():
    st = trace.reduce(_events(), wall_s=0.02, event_s=0.016, counters={}, work={})
    assert st.ops == 4
    # busy: [0, 6] ms (the gemm overlaps the elementwise) and [13, 14]
    assert st.busy_s == pytest.approx(0.007)
    assert st.seconds("chol_batched") == pytest.approx(0.002)
    assert st.seconds("cublas") == pytest.approx(0.003)
    # the DtoH copy is a transfer, no part of the sweeps
    assert st.seconds(*trace.SWEEPS) == pytest.approx(0.002)
    assert st.seconds("transfers") == pytest.approx(0.001)
    assert st.gaps[0][0] == "cudaStreamSynchronize"
    assert st.gaps[0][1] == pytest.approx(0.007)
    bd = st.breakdown()
    assert bd["device_ops"][0] == ["ampere_dgemm_64x64_nn", pytest.approx(0.003)]
    assert len(bd["device_ops"]) <= 10 and len(bd["idle_gaps"]) <= 10


def test_categories():
    assert trace.category("void tri_pair_small_kernel<double>(...)") == "tri_pair_batched"
    assert trace.category("void chol_batched_kernel<float, 128, 3, 1>(...)") == "chol_batched_f32"
    assert trace.category("sm90_xmma_gemm_f64f64") == "cublas"
    assert trace.category("something new") == "other"
    for name in ("Memcpy HtoD (Pageable -> Device)", "Memcpy DtoH (Device -> Pinned)",
                 "Memcpy DtoD (Device -> Device)", "Memset (Device)"):
        assert trace.category(name) == "transfers"
    assert "transfers" not in trace.SWEEPS
    assert trace.category("void at::native::vectorized_elementwise_kernel<4, "
                          "at::native::direct_copy_kernel_cuda>") == "elementwise"
    assert trace.category("void at::native::unrolled_copy_kernel") == "copies"


def test_problems_of_a_stretch():
    good = trace.reduce(_events(), 0.02, 0.016, {}, {})
    assert trace.problems(good, {"chol_batched": (0.001, 0.001)}) == []
    # device time over the events' time: a trace from elsewhere
    assert trace.problems(trace.reduce(_events(), 0.02, 0.004, {}, {}), {})
    # a kernel faster than its least time
    assert trace.problems(good, {"chol_batched": (0.003, 0.001)})
    assert trace.problems(good, {"chol_batched": (0.001, 0.0025)})
    # no device time
    host_only = [e for e in _events() if not e[0]]
    assert trace.problems(trace.reduce(host_only, 0.02, 0.01, {}, {}), {})


def test_a_stretch_is_traced_again_then_given_up():
    tries = []

    def capture(bad_first):
        def run(stretch):
            tries.append(1)
            work = stretch()
            events = _events() if len(tries) > bad_first else [
                e for e in _events() if not e[0]]
            return events, 0.02, 0.016, work
        return run

    counters = iter(range(100)).__next__

    def count():
        return {"chol_batched": counters()}

    st, last, n = trace.traced(lambda: {"calls": 1}, count, lambda d: {},
                               capture=capture(2))
    assert st is not None and n == 3 and len(tries) == 3
    tries.clear()
    st, last, n = trace.traced(lambda: {"calls": 1}, count, lambda d: {},
                               capture=capture(5))
    assert st is None and last is not None and n == 3
