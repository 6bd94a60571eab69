"""The metric arithmetic against hand-computed values, on synthetic
timings, counters and traces."""


import pytest

from benchmark.harness import measures, roofline, trace
from benchmark.harness.runner import Call, Run
from benchmark.harness.spec import Spec

SPEC = Spec()


def _counts(chol=0, pair=0):
    return {"chol_batched": chol, "tri_pair_batched": pair,
            "chol_single": 0, "tri_pair_single": 0, "chol_batched_f32": 0,
            "tri_pair_batched_f32": 0, "chol_single_f32": 0,
            "tri_pair_single_f32": 0}


def _batch_run(stretch=None):
    # four batches of 8 instances: 0.2, 0.1, 0.4 and 0.3 s, 10, 11, 10, 9
    # factors (9, 10, 9, 8 lockstep iterations), 7 of 8 certified each
    times = [(0.0, 0.2), (0.2, 0.3), (0.3, 0.7), (0.7, 1.0)]
    chols = [10, 11, 10, 9]
    calls = [Call(a, b, {"counters": _counts(f, 3 * f + 1), "instances": 8,
                         "certified": 7}) for (a, b), f in zip(times, chols)]
    return Run(cell={}, config=SPEC.config("robust_ls_b4096"), traffic={},
               seconds=1.0, setup_s=12.5, window_s=1.0, calls=calls,
               stretch=stretch)


def _read(metric, run):
    return SPEC.reader(metric).read(run)


def test_percentile_by_hand():
    assert measures.percentile([3, 1, 2, 4], 90) == pytest.approx(3.7)
    assert measures.percentile([5], 90) == 5
    assert measures.percentile(range(11), 90) == pytest.approx(9.0)


def test_batch_metrics_by_hand():
    run = _batch_run()
    assert _read("solves_per_s", run) == pytest.approx(28 / 1.0)
    # latencies 200, 100, 400, 300 ms: rank 0.9 * 3 = 2.7 of 100..400
    assert _read("batch_ms_p90", run) == pytest.approx(370.0)
    assert _read("setup_s", run) == 12.5
    assert _read("lockstep_iters.c3", run) == pytest.approx(36 / 4)
    assert _read("lockstep_iter_ms.c3", run) == pytest.approx(1000.0 / 36)


def _stretch(busy_s, ops, cats, counters, work):
    return trace.Stretch(wall_s=busy_s * 2, event_s=busy_s, busy_s=busy_s,
                         ops=ops, by_category=cats, by_name={}, durations={},
                         gaps=[], counters=counters, work=work)


def test_traced_metrics_by_hand():
    # two batches, 22 factors: 20 lockstep iterations; 0.5 s busy
    cats = {"cublas": [0.1, 40], "elementwise": [0.05, 100],
            "reductions": [0.02, 10], "cat": [0.01, 5], "copies": [0.02, 5],
            "transfers": [0.3, 4],
            "chol_batched": [0.022, 22], "tri_pair_batched": [0.01, 64]}
    st = _stretch(0.5, 1000, cats, _counts(22, 64), {"calls": 2})
    run = _batch_run(st)
    assert _read("cublas_ms_per_iter.c3", run) == pytest.approx(100.0 / 20)
    assert _read("sweep_ms_per_iter.c3", run) == pytest.approx(100.0 / 20)
    assert _read("device_ops_per_iter.c3", run) == pytest.approx(50.0)
    # busy 25 ms an iteration against 1000 / 36 ms of wall an iteration
    assert _read("device_idle_share.c3", run) == pytest.approx(
        100 * (1 - 25.0 / (1000.0 / 36)))
    least = 22 * roofline.chol_batched_s(4096, 102)
    assert _read("chol_batched_roofline.c3", run) == pytest.approx(
        100 * least / 0.022)


def test_admm_metrics_by_hand():
    # two calls of 10 rounds, one cold start each: (2 + 2 * 40) and
    # (2 + 2 * 30) factors -> 70 inner iterations in 20 rounds, 5 s
    calls = [Call(0.0, 2.0, {"counters": _counts(82, 13 + 400), "rounds": 10}),
             Call(2.0, 5.0, {"counters": _counts(62, 13 + 300), "rounds": 10})]
    cats = {"elementwise": [0.3, 1000], "chol_batched": [0.05, 82],
            "tri_pair_batched": [0.2, 413], "transfers": [0.12, 3]}
    st = _stretch(1.5, 5000, cats, _counts(82, 413), {"calls": 1, "rounds": 10})
    run = Run(cell={}, config=SPEC.config("scenario_portfolio_s65536"),
              traffic=SPEC.traffic("one_batch"), seconds=5.0, setup_s=1.0,
              window_s=5.0, calls=calls, stretch=st)
    assert _read("admm_round_s", run) == pytest.approx(0.25)
    assert _read("inner_iters_per_round.c5", run) == pytest.approx(70 / 20)
    assert _read("sweep_ms_per_round.c5", run) == pytest.approx(30.0)
    assert _read("transfer_ms_per_round.c5", run) == pytest.approx(12.0)
    assert _read("device_ops_per_round.c5", run) == pytest.approx(500.0)
    assert _read("device_idle_share.c5", run) == pytest.approx(100 * (1 - 0.15 / 0.25))
    # 41 factors at each order; 413 pair solves = 41 (one a factor) + 3 x
    # 124 solves: 124 at order 1, 289 at 21
    S = 65536
    chol = 41 * (roofline.chol_batched_s(S, 21) + roofline.chol_batched_s(S, 1))
    pair = 289 * roofline.tri_pair_batched_s(S, 21, 1) + 124 * roofline.tri_pair_batched_s(S, 1, 1)
    assert _read("chol_batched_roofline.c5", run) == pytest.approx(100 * chol / 0.05)
    assert _read("tri_pair_batched_roofline.c5", run) == pytest.approx(100 * pair / 0.2)


def test_roofline_counts_by_hand():
    # n = 1: one sqrt; n = 2: 2 sqrt, 1 division, 1 update of 1 entry
    # (2 ops), the loop's count n + n(n+1)/2 + sum t(t+1)
    assert roofline.chol_flops(1) == 1 + 1 + 0
    assert roofline.chol_flops(2) == 2 + 3 + 2
    assert roofline.chol_flops(3) == 3 + 6 + (0 + 2 + 6)
    # (B, n) = (2, 3): lower triangle in (6 entries) and the whole out (9)
    b = 8 * 2 * (6 + 9)
    assert roofline.chol_batched_s(2, 3) == pytest.approx(
        max(b / 3.35e12, 2 * roofline.chol_flops(3) / 67e12))
    # pair solve (2, 3, 1): factor's triangle, rhs in and X out
    b = 8 * (2 * 6 + 2 * 2 * 3)
    assert roofline.tri_pair_batched_s(2, 3, 1) == pytest.approx(
        max(b / 3.35e12, 2 * 2 * 9 / 67e12))
    # config 3's shape is bound by bytes
    assert roofline.chol_batched_s(4096, 102) == pytest.approx(
        8 * 4096 * (102 * 103 // 2 + 102 * 102) / 3.35e12)


def test_admm_split_refuses_a_count_that_does_not_fit():
    config = SPEC.config("scenario_portfolio_s65536")
    shapes = dict(config.SHAPES)
    assert config.least_times(_counts(82, 413), shapes, {}).keys() == {
        "chol_batched", "tri_pair_batched"}
    assert "tri_pair_batched" not in config.least_times(_counts(82, 414), shapes, {})
    assert config.least_times(_counts(81, 413), shapes, {}) == {}
