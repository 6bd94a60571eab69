#!/usr/bin/env python3
"""Smoke test of socp_tpu_torch on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py          # from the root of the repository

Phases, each printing one JSON line to stdout:
  1. device   the card's name; nvidia-smi's "name, power.limit" line.
  2. build    nvcc builds every kernel from socp_tpu_torch/csrc/ (seconds).
  3. kernels  each batched CUDA kernel against its plain PyTorch version on
              the card, bit for bit, on f64 SPD batches (kappa = 1e8) made
              from a numpy seed, at the main path's shapes, config 4's
              blocks (B = 10,240, n = 10, also k = 8) and across the
              micro-tile, panel and schedule edges (F64_BATCHED), k = 1 and
              3; a matrix that is not positive definite must give a
              non-finite factor.  Timed at config 3's and config 4's shapes.
              Timed two ways (`timed`): call_ms, CUDA events around one
              call, host work included (median of 15), and kernel_ms, the
              device time of the kernels one call enqueues, from
              torch.profiler (median of 15; where the tracer drops its
              traces, CUDA events behind a spin kernel, kernel_ms_by
              "spin_events"); the library call
              (torch.linalg.cholesky_ex / torch.cholesky_solve, never used
              by the port) the same two ways (library_call_ms,
              library_kernel_ms); the plain version by events.
  4. single_kernels  the single-instance kernels against their plain
              versions bit for bit at n = 1 ... 1000 (both sides of the
              panel and tile edges) and k = 1, 4, 5 (every (n, k) that
              configs 1, 2 and 4 give them), non-PD inputs of one tile and
              of many; timed as phase 3 at the shapes configs 1, 2 and 4
              give them (SINGLE_CHOL_AT, SINGLE_PAIR_AT); the division on their
              chains (csrc/div_rn.cuh) against x / p on 2^25 pairs
              (`div_rn_check`; phase 8 does the same in f32).
  5. main     BASELINE config 3: 4096 robust least-squares SOCPs (n = 100,
              nv = 102, m_pad = 312) in one lockstep batch through
              prepare_batch on "cuda"; every instance OPTIMAL at the 1e-8
              tolerances, pcost equal to the closed-form objective, the
              kernels' launch counts in the IPM loop's ratios, and 8 instances
              re-solved on the CPU (plain path) agreeing with the card.
  6. profile  device time of one more main-path solve by kernel and
              category, from torch.profiler, and the device's idle share:
              1 - busy / wall of the main phase's unprofiled solve.
  5n. main_native  config 3 with SolverConfig(native_dd=True), the
              reference's accelerator route (bench.py:254-266): the
              structured KKT assembly, here ConstGram (NB = 2), which never
              forms W^-1 G; the same checks as phase 5 (the CPU re-solve
              through the same route), the lanes at the lockstep maximum;
              then its profile as phase 6 ("config3_native").
  7. single   BASELINE configs 1 (random_socp, n = 50) and 2 (portfolio,
              n = 500) through socp_tpu_torch.solve on "cuda": OPTIMAL at the
              1e-8 tolerances, the models' own checks, launches only of the
              single-instance kernels in the IPM loop's ratios, the CPU
              (plain path) re-solve agreeing; config 2 again with one Gondzio
              corrector; then profiles of configs 1 and 2 as in phase 6,
              with the port's kernels' device ms and launches in a solve.
  7n. single_native  configs 1 and 2 with native_dd=True (ConstGram: NB = 3
              with orthant rows, p = 5; NB = 1, l = 500, p = 1), as phase 7.
  7b. large_batch  solve_batch of two config-2 instances (seeds 0 and 1) on
              the card: n = 500 is above the batched kernels' largest order,
              so the routers run H's factor and solves through the single
              kernels an instance at a time; both OPTIMAL, pcost within 1e-8
              of each solved alone, the launch ratios of that route.
  7c. block_schur  BASELINE config 4 (scripts/bench_all.py:144-170):
              random_block_problem(0, K=10240, nb=10, p=8, block dims l = 4,
              qs = (6,)), 102,400 vars, through parallel.schur.solve_block on
              "cuda" with factor_dtype="dd32" (the f64 block path): OPTIMAL
              at 1e-8, pcost within 1e-6 of the constructed optimum, a CPU
              re-solve in the same iterations, the launches of the block
              path (chol_batched on the blocks, chol_single on the 8 x 8
              Schur complement, their pair solves); wall s and iterations/s
              of the second solve; then its profile ("config4").
  8. f32_kernels  the f32 instances of the four kernels (the factor of the
              mixed-precision mode, factor_dtype="float32") against their
              plain versions, bit for bit, on f32 SPD batches with kappa =
              1e4 (f32 cannot factor the f64 phases' kappa = 1e8 matrices:
              its rounding, 6e-8 relative, times 1e8 exceeds the smallest
              pivot) made from a numpy seed: batched at n = 1 ... 240
              (F32_BATCHED) with k = 1, 3, single
              at n = 1 ... 1000 with k = 1, 4, 5; non-PD inputs give
              non-finite factors; timed as phase 3 at B = 4096, n = 102 and
              single at config 2's shapes in this mode and P1's n = 128.
  9. f32factor  config 3 with SolverConfig(factor_dtype="float32") through
              prepare_batch on "cuda" (TF32 off is asserted first): every
              instance OPTIMAL at the reference's relaxed tolerances, pcost
              within 5e-5 of the closed form, only the f32 batched kernels
              launched, in the loop's ratios, and 8 instances re-solved on
              the CPU agreeing in status and inaccurate flag; then a profile
              as in phase 6.
 10. f32factor_single  config 2 with factor_dtype="float32" through solve:
              status and inaccurate flag as the CPU re-solve says, the
              portfolio's checks at this mode's tolerances, only the f32
              single kernels launched; then a profile as in phase 7.
 11. probes   the ports of the Mosaic probes (scripts/pallas_probe*.py;
              socp_tpu_torch/ops/probes.py, csrc/probes.cu) at the probes'
              own shapes, each bit-equal to its plain version and held to
              its script's own check, and timed as phase 3; P1, the f32
              Cholesky at n = 128, runs the f32 single kernel.
Then a {"kernels": [...]} line, one row per TPU kernel (11): the f64
batched kernels at config 3's shapes, with their launches in phase 5 (each
f64 row also has "launches_by_path": phases 5, 5n, 7, 7n, 7b and 7c, and
"by_shape": its numbers at config 4's shapes, and for the single ones at
the single path's); the
f64 single-instance ones at n = 500, k = 1 with the path's other shapes
beside, with their launches in phase 7's default run of config 2 and, per
config, of configs 1 and 2; the f32 Cholesky and pair solve at B = 4096,
n = 102 with the single instances beside, with their launches in phases 9
and 10; the probes (P1 its own row), with their launches in phase 11.  A
row's "ms" and "library_ms" are event times of one call (call_ms,
library_call_ms), "kernel_ms" and "library_kernel_ms" device times beside
them.  Last, the {"ok": true, ...} line.
Any failed check exits non-zero before the last line is printed.  It needs
CUDA and the repository: without either it exits non-zero.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
B_MAIN, N_MAIN = 4096, 100          # config 3: robust_ls_batch(0, 4096, n=100)
K4, NB4, P4 = 10240, 10, 8          # config 4: K blocks of nb vars, p coupling rows
HBM_BYTES_PER_S = 3.35e12           # H100 SXM data sheet
FP64_FLOPS_PER_S = 67e12            # H100 SXM data sheet, FP64 tensor core (the
                                    # card's fastest FP64 rate: a lower bound)
FP32_FLOPS_PER_S = 67e12            # H100 SXM data sheet, FP32 (non-tensor)
# both sides of the panel and tile edges (32) and of the one-block limits
# of the kernels before (169 f64, 240 f32), up to the reference's
# _PALLAS_MAX_N and past it
SINGLE_NS = (1, 2, 5, 8, 31, 32, 33, 50, 64, 65, 169, 170, 333, 500, 768,
             1000)
SINGLE_KS = (1, 4, 5)                   # 5: config 1's p, the k of H^-1 A'
# the shapes the single path gives the kernels: configs 1 and 2 in f64 and
# config 4's Schur factor (n = 8, the pair solve at k = 1), config 2 in
# f32 mode and P1 (n = 128) in f32; pair solves as (n, k)
SINGLE_CHOL_AT = {"f64": (1, 5, 8, 50, 500), "f32": (1, 128, 500)}
SINGLE_PAIR_AT = {"f64": ((1, 1), (5, 1), (8, 1), (50, 1), (50, 5), (500, 1)),
                  "f32": ((1, 1), (128, 1), (500, 1))}
# (B, n) of the batched kernels' checks: config 3's shapes, config 4's
# blocks (with k = P4 too), then both sides of the micro-tile (4) and
# panel (32) edges and of the Cholesky's second schedule (above n = 108),
# up to the largest n the wrappers take
F64_BATCHED = ((B_MAIN, N_MAIN + 2), (K4, NB4), (8, 37), (B_MAIN, 3), (64, 1),
               (64, 2), (64, 4), (64, 5), (64, 31), (64, 32), (64, 33),
               (64, 65), (64, 108), (64, 109), (64, 169))
F32_BATCHED = ((B_MAIN, 1), (B_MAIN, 3), (B_MAIN, 37), (B_MAIN, 102),
               (64, 2), (64, 5), (64, 31), (64, 32), (64, 33), (64, 65),
               (64, 108), (64, 109), (256, 169), (256, 240))
KAPPA = {"f64": 1e8, "f32": 1e4}
F32_SINGLE_NS = (1, 2, 5, 31, 32, 33, 50, 64, 65, 128, 240, 241, 333, 500,
                 768, 1000)
RELAXED_FEAS, RELAXED_GAP = 1e-4, 5e-5  # feastol_inacc, abstol/reltol_inacc
COUNTERS = {"chol_batched": "chol_launches",
            "tri_pair_batched": "tri_pair_launches",
            "chol_single": "chol_single_launches",
            "tri_pair_single": "tri_pair_single_launches",
            "chol_batched_f32": "chol_launches_f32",
            "tri_pair_batched_f32": "tri_pair_launches_f32",
            "chol_single_f32": "chol_single_launches_f32",
            "tri_pair_single_f32": "tri_pair_single_launches_f32"}
F64_KERNELS = ("chol_batched", "tri_pair_batched", "chol_single",
               "tri_pair_single")
F32_KERNELS = tuple(f"{k}_f32" for k in F64_KERNELS)


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(ok, what):
    if not ok:
        print(f"chip_smoke: FAILED: {what}", file=sys.stderr, flush=True)
        sys.exit(1)


def spd_batch(rng, B, n, kappa=1e8, neg=False):
    Q, _ = np.linalg.qr(rng.normal(size=(B, n, n)))
    ev = np.logspace(-np.log10(kappa), 0, n)
    if neg:
        ev[0] = -1e-2
    H = (Q * ev[None, None, :]) @ np.swapaxes(Q, 1, 2)
    return 0.5 * (H + np.swapaxes(H, 1, 2))


def cuda_ms(f, reps=15, warm=3):
    """Median milliseconds of f() over reps, each bracketed by CUDA events."""
    for _ in range(warm):
        f()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        f()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def spin_ms(f, reps=15, warm=3, cycles=1 << 21):
    """Median milliseconds of the device's work for one call of f, the
    host's work hidden.  A spin kernel (torch.cuda._sleep, about 1 ms at
    first) goes on the stream before each call, so the host has enqueued
    the whole call before the device reaches it, and CUDA events time the
    call from the spin's end to its last kernel's.  A call the device had
    caught up with (its start event done once the host had enqueued it) is
    taken again behind a spin twice as long; past 64 times the first spin
    the call waits on the host itself, and its time is kept as it is.  The
    time spans the call's first kernel to its last, so a call whose kernels
    wait on its own host work between them (torch.cholesky_solve) counts
    those waits, which the profiler's sum leaves out."""
    for _ in range(warm):
        f()
    torch.cuda.synchronize()
    times = []
    while len(times) < reps:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        f()
        b.record()
        caught_up = a.query()
        b.synchronize()
        if caught_up and cycles < 1 << 27:
            cycles *= 2
            continue
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(f, reps=15, warm=3, tries=3):
    """(ms, how): the median over the last reps calls of the device time of
    the kernels (and memsets) one call of f enqueues, summed, from
    torch.profiler (how = "profiler").  A marker kernel (torch.cuda._sleep's
    spin kernel) goes on the stream before each call and after the last,
    so a call's device events are those between two markers in stream
    order.  Unlike cuda_ms it leaves out the host work of the call
    (ctypes, allocation).  The tracer can drop events, at a trace's start
    or a whole trace's: every call enqueues the same kernels, so a call
    with fewer events than the most seen is incomplete and left out, and a
    trace with fewer than reps complete calls is taken again, up to
    `tries` times.  After that the time is spin_ms's (how = "spin_events"),
    which needs no tracer."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warm):
        f()
    torch.cuda.synchronize()
    for attempt in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):          # the tracer may miss the first events
                torch.cuda._sleep(1000)
            for _ in range(reps + 5):
                torch.cuda._sleep(1000)
                f()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        device = sorted((ev.time_range.start, ev.time_range.elapsed_us(), ev.name)
                        for ev in prof.events()
                        if ev.device_type == DeviceType.CUDA)
        calls, current = [], None        # (events, microseconds) per call
        for _, us, name in device:
            if "spin" in name.lower():
                if current is not None:
                    calls.append(tuple(current))
                current = [0, 0.0]
            elif current is not None:
                current[0] += 1
                current[1] += us
        most = max((c[0] for c in calls), default=0)
        complete = [c[1] / 1e3 for c in calls if c[0] == most and most > 0]
        if len(complete) >= reps:
            return statistics.median(complete[-reps:]), "profiler"
        print(f"chip_smoke: device_ms try {attempt + 1}: {len(device)} device "
              f"events, {len(complete)} complete calls of {len(calls)}",
              file=sys.stderr, flush=True)
    print(f"chip_smoke: device_ms: no complete trace in {tries} tries; timing "
          "by events behind a spin instead", file=sys.stderr, flush=True)
    return spin_ms(f, reps, warm), "spin_events"


def timed(f, library, plain, plain_reps=15, **extra):
    """A kernel's numbers: call_ms and library_call_ms by CUDA events
    around one call (median of 15, host work included), kernel_ms and
    library_kernel_ms by device time (median of 15; kernel_ms_by and
    library_kernel_ms_by say how device_ms took it), plain_ms by events."""
    call_ms = cuda_ms(f)
    kernel_ms, kernel_by = device_ms(f)
    library_call_ms = None if library is None else cuda_ms(library)
    library_ms, library_by = (None, None) if library is None else device_ms(library)
    return dict(call_ms=call_ms, kernel_ms=kernel_ms, kernel_ms_by=kernel_by,
                library_call_ms=library_call_ms,
                library_kernel_ms=library_ms, library_kernel_ms_by=library_by,
                plain_ms=cuda_ms(plain, reps=plain_reps,
                                 warm=1 if plain_reps < 15 else 3),
                **extra)


def chol_flops(n):
    # per column: one sqrt, n - j divisions, rank-1 update of t(t+1)/2 entries
    return n + n * (n + 1) // 2 + sum(t * (t + 1) for t in range(n))


def bound(bytes_, flops, flops_per_s=FP64_FLOPS_PER_S):
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def reset_counts():
    from socp_tpu_torch.ops import chol, probes

    for attr in COUNTERS.values():
        setattr(chol, attr, 0)
    for name in probes.launches:
        probes.launches[name] = 0


def read_counts():
    from socp_tpu_torch.ops import chol, probes

    return {**{name: getattr(chol, attr) for name, attr in COUNTERS.items()},
            **probes.launches}


def none_of(launches, names, what):
    check(all(launches[k] == 0 for k in names),
          f"{what}: launched kernels of another path: {launches}")


def phase_device():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    return name


def _kernel_name(mangled):
    """`chol_single_tiles_kernel<double>` from its mangled name: the
    length-prefixed name that ends in "kernel" (the length may follow the
    digits of a hash, so each suffix of a digit run is tried), then the
    template arguments, a type and an int."""
    for m in re.finditer(r"\d+", mangled):
        for start in range(m.start(), m.end()):
            name = mangled[m.end():m.end() + int(mangled[start:m.end()])]
            if name.endswith("kernel") and name.isidentifier():
                args = re.match(r"I([df])(?:Li(\d+)E)?",
                                mangled[m.end() + len(name):])
                if args:
                    name += "<" + ",".join(
                        [{"d": "double", "f": "float"}[args[1]]]
                        + ([args[2]] if args[2] else [])) + ">"
                return name
    return mangled


def ptxas_report(log):
    """Registers, stack and spill bytes of every kernel instance in an
    nvcc -Xptxas=-v log."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = _kernel_name(m[1])
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and fn:
            out[fn] = {"stack": int(m[1]), "spill_stores": int(m[2]),
                       "spill_loads": int(m[3])}
        m = re.search(r"Used (\d+) registers", line)
        if m and fn in out:
            out[fn]["registers"] = int(m[1])
    return out


def phase_build():
    from socp_tpu_torch.ops import _build

    seconds, log = _build.build()
    print(log, file=sys.stderr, flush=True)
    for name in _build.KERNELS:
        _build.kernel(name)
    report = ptxas_report(log)
    spilled = sorted(k for k, v in report.items() if v["spill_stores"])
    if spilled:
        print(f"chip_smoke: spills in {spilled}", file=sys.stderr, flush=True)
    emit({"phase": "build", "seconds": seconds, "kernels": list(_build.KERNELS),
          "ptxas": report})


def batched_timing(dtype, rng, B=B_MAIN, nv=N_MAIN + 2, ks=(1,)):
    """chol_batched at (B, nv) and tri_pair_batched at (B, nv, k) for each
    k in ks (by default config 3's shape: B = 4096, n = 102, k = 1) in one
    dtype, each beside its library call and plain version, with its bound:
    {"chol_batched": ..., "tri_pair_batched": at ks[0],
    "tri_pair_batched k=K": at each further k}."""
    from socp_tpu_torch.ops import chol

    key = "f64" if dtype == torch.float64 else "f32"
    size = 8 if key == "f64" else 4
    rate = FP64_FLOPS_PER_S if key == "f64" else FP32_FLOPS_PER_S
    H = torch.as_tensor(spd_batch(rng, B, nv, kappa=KAPPA[key]), dtype=dtype,
                        device="cuda")
    L = chol.chol_batched(H)
    # least bytes each function must move: L (and H) only by their lower
    # triangle, the Cholesky's whole n x n output, the rhs in and X out
    tri = size * B * nv * (nv + 1) // 2
    full = size * B * nv * nv
    out = {"chol_batched": timed(
        lambda: chol.chol_batched(H), lambda: torch.linalg.cholesky_ex(H),
        lambda: chol.chol_batched_plain(H),
        bound=bound(tri + full, B * chol_flops(nv), rate))}
    for k in ks:
        rhs = torch.as_tensor(rng.standard_normal((B, nv, k)), dtype=dtype,
                              device="cuda")
        rb = size * B * nv * k
        out["tri_pair_batched" if k == ks[0] else f"tri_pair_batched k={k}"] = timed(
            lambda rhs=rhs: chol.tri_pair_batched(L, rhs),
            lambda rhs=rhs: torch.cholesky_solve(rhs, L),
            lambda rhs=rhs: chol.tri_pair_batched_plain(L, rhs),
            bound=bound(tri + 2 * rb, B * 2 * nv * nv * k, rate))
    return out


def phase_kernels():
    """The f64 batched kernels against their plain versions, bit for bit,
    at config 3's and config 4's shapes and across the micro-tile, panel
    and schedule edges (F64_BATCHED), k = 1 and 3 (and P4 at config 4's
    blocks); the non-PD check; timings at config 3's shape and at config
    4's (B = 10,240, n = 10; the pair solve at k = 8 and 1)."""
    from socp_tpu_torch.ops import chol

    rng = np.random.default_rng(SEED)
    dev = torch.device("cuda")
    results = {"chol_batched": [], "tri_pair_batched": []}
    for B, n in F64_BATCHED:
        H = torch.as_tensor(spd_batch(rng, B, n), device=dev)
        L = chol.chol_batched(H)
        results["chol_batched"].append(bit_equal(
            L, chol.chol_batched_plain(H), f"chol_batched B={B} n={n}"))
        for k in (1, 3) + ((P4,) if (B, n) == (K4, NB4) else ()):
            rhs = torch.as_tensor(rng.standard_normal((B, n, k)), device=dev)
            results["tri_pair_batched"].append(bit_equal(
                chol.tri_pair_batched(L, rhs), chol.tri_pair_batched_plain(L, rhs),
                f"tri_pair_batched B={B} n={n} k={k}"))

    nv = N_MAIN + 2
    bad = torch.as_tensor(spd_batch(rng, 64, nv, neg=True), device=dev)
    for f in (chol.chol_batched, chol.chol_batched_plain):
        Lb = f(bad)
        torch.cuda.synchronize()
        check(bool((~torch.isfinite(Lb)).flatten(1).any(1).all()),
              f"{f.__name__}: a non-PD input gave a finite factor")

    timing = batched_timing(torch.float64, rng)
    t4 = batched_timing(torch.float64, rng, K4, NB4, ks=(P4, 1))
    at = f"B={K4},n={NB4}"
    block = {"chol_batched": {at: t4["chol_batched"]},
             "tri_pair_batched": {f"{at},k={P4}": t4["tri_pair_batched"],
                                  f"{at},k=1": t4["tri_pair_batched k=1"]}}
    emit({"phase": "kernels", "batched": [list(x) for x in F64_BATCHED],
          "ks": [1, 3], "block_ks": [1, 3, P4], "bit_equal": True,
          "max_abs_err": {k: max(v) for k, v in results.items()},
          "timing_shape": {"B": B_MAIN, "n": nv, "k": 1},
          **{k: {kk: vv for kk, vv in v.items() if kk != "bound"}
             for k, v in timing.items()},
          "config4": {name: {a: {kk: vv for kk, vv in t.items() if kk != "bound"}
                             for a, t in by.items()}
                      for name, by in block.items()}})
    return results, timing, block


def single_timing(dtype, rng):
    """chol_single and tri_pair_single at the single path's shapes
    (SINGLE_CHOL_AT, SINGLE_PAIR_AT) in one dtype, each beside its library
    call and plain version, with its bound."""
    from socp_tpu_torch.ops import chol

    key = "f64" if dtype == torch.float64 else "f32"
    size = 8 if key == "f64" else 4
    rate = FP64_FLOPS_PER_S if key == "f64" else FP32_FLOPS_PER_S
    kappa = 1e8 if key == "f64" else 1e4
    out = {"chol_single": {}, "tri_pair_single": {}}
    factors = {}
    for n in sorted({n for n in SINGLE_CHOL_AT[key]}
                    | {n for n, _ in SINGLE_PAIR_AT[key]}):
        H = torch.as_tensor(spd_batch(rng, 1, n, kappa=kappa)[0], dtype=dtype,
                            device="cuda")
        factors[n] = (H, chol.chol_single(H))
    for n in SINGLE_CHOL_AT[key]:
        H = factors[n][0]
        tri = size * n * (n + 1) // 2            # least bytes, as phase_kernels
        out["chol_single"][f"n={n}"] = timed(
            lambda: chol.chol_single(H), lambda: torch.linalg.cholesky_ex(H),
            lambda: chol.chol_single_plain(H), plain_reps=5,
            bound=bound(tri + size * n * n, chol_flops(n), rate))
    for n, k in SINGLE_PAIR_AT[key]:
        L = factors[n][1]
        rhs = torch.as_tensor(rng.standard_normal((n, k)), dtype=dtype,
                              device="cuda")
        tri = size * n * (n + 1) // 2
        out["tri_pair_single"][f"n={n},k={k}"] = timed(
            lambda: chol.tri_pair_single(L, rhs),
            lambda: torch.cholesky_solve(rhs, L),
            lambda: chol.tri_pair_single_plain(L, rhs), plain_reps=5,
            bound=bound(tri + 2 * size * n * k, 2 * n * n * k, rate))
    return out


def phase_single_kernels():
    """The f64 single-instance kernels against their plain versions, bit for
    bit, at n = 1 ... 1000 and k = 1, 4, 5; the non-PD check (one tile and
    many); timings at the shapes configs 1 and 2 give them (the Cholesky at
    n = 1, 5, 50, 500, the pair solve at (n, k) = (1, 1), (5, 1), (50, 1),
    (50, 5), (500, 1))."""
    from socp_tpu_torch.ops import chol

    rng = np.random.default_rng(SEED + 1)
    dev = torch.device("cuda")
    results = {"chol_single": [], "tri_pair_single": []}
    for n in SINGLE_NS:
        H = torch.as_tensor(spd_batch(rng, 1, n)[0], device=dev)
        L = chol.chol_single(H)
        results["chol_single"].append(
            bit_equal(L, chol.chol_single_plain(H), f"chol_single n={n}"))
        for k in SINGLE_KS:
            rhs = torch.as_tensor(rng.standard_normal((n, k)), device=dev)
            results["tri_pair_single"].append(bit_equal(
                chol.tri_pair_single(L, rhs), chol.tri_pair_single_plain(L, rhs),
                f"tri_pair_single n={n} k={k}"))

    for n in (20, 50, 500):                  # one tile, then the dataflow
        bad = torch.as_tensor(spd_batch(rng, 1, n, neg=True)[0], device=dev)
        for f in (chol.chol_single, chol.chol_single_plain):
            Lb = f(bad)
            torch.cuda.synchronize()
            check(not bool(torch.isfinite(Lb).all()),
                  f"{f.__name__}: a non-PD input at n={n} gave a finite factor")

    timing = single_timing(torch.float64, rng)
    emit({"phase": "single_kernels", "ns": list(SINGLE_NS), "ks": list(SINGLE_KS),
          "bit_equal": True, "div_rn_pairs": div_rn_check(torch.float64),
          "max_abs_err": {k: max(v) for k, v in results.items()},
          "timing": {name: {at: {kk: vv for kk, vv in t.items() if kk != "bound"}
                            for at, t in by.items()}
                     for name, by in timing.items()}})
    return results, timing


def phase_main(native_dd=False):
    """Config 3 through prepare_batch on the card: the default KKT route,
    or with native_dd the reference's accelerator route (the structured
    assembly, here ConstGram: NB = 2), phase "main_native"."""
    from socp_tpu_torch import SolverConfig, Status, prepare_batch, solve_batch_raw
    from socp_tpu_torch.models.robust_ls import robust_ls_batch

    label = "main_native" if native_dd else "main"
    cfg = SolverConfig(native_dd=native_dd)
    t0 = time.perf_counter()
    c, G, h, dims = robust_ls_batch(SEED, batch=B_MAIN, n=N_MAIN)
    fn, args, layout = prepare_batch(c, G, h, dims, config=cfg, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    check(c.shape[1] == N_MAIN + 2 and layout.m_pad == 312,
          f"config 3 shape: nv={c.shape[1]} m_pad={layout.m_pad}")

    t0 = time.perf_counter()
    fn(*args)[4].cpu()                               # warm-up
    warm_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    out = fn(*args)
    status = out[4].cpu().numpy()                    # syncs on the result
    solve_s = time.perf_counter() - t0
    launches = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(launches["chol_single"] == launches["tri_pair_single"] == 0,
          f"{label}: the batched path launched single-instance kernels: {launches}")
    none_of(launches, F32_KERNELS, f"{label}: config 3 (f64)")

    x = out[0].cpu().numpy()
    k = out[5].cpu().numpy()
    stats = out[6].cpu().numpy()
    n_opt = int(np.sum(status == int(Status.OPTIMAL)))
    check(n_opt == B_MAIN, f"{label}: {n_opt}/{B_MAIN} OPTIMAL")
    pres, dres, gap, relgap = stats[:, 4], stats[:, 5], stats[:, 2], stats[:, 3]
    strict = (pres <= 1e-8) & (dres <= 1e-8) & ((gap <= 1e-8) | (relgap <= 1e-8))
    check(bool(strict.all()),
          f"{label}: {int((~strict).sum())} instances miss the strict 1e-8 tolerances")

    # closed form: ||D x - d|| + rho ||x|| at the returned x (rho = 0.1)
    kk = dims.qs[0] - 1
    D = -G[:, 1:kk + 1, :N_MAIN]
    d = -h[:, 1:kk + 1]
    xs = x[:, :N_MAIN]
    obj = (np.linalg.norm(np.einsum("bkn,bn->bk", D, xs) - d, axis=1)
           + 0.1 * np.linalg.norm(xs, axis=1))
    rel = np.abs(stats[:, 0] - obj) / np.maximum(1.0, np.abs(obj))
    check(bool((rel <= 1e-7).all()),
          f"{label}: pcost vs closed form: max rel {rel.max()}")

    # launches: init 1 + 4, each lockstep iteration 1 + 3 (p = 0)
    n_iter = launches["chol_batched"] - 1
    check(n_iter >= 1 and launches["tri_pair_batched"] == 4 + 3 * n_iter,
          f"{label}: launch ratios {launches}")
    check(int(k.max()) <= n_iter <= int(k.max()) + 1,
          f"{label}: {n_iter} lockstep iterations vs max k {int(k.max())}")

    # 8 instances on the CPU (plain kernels, the same route) against the card
    cpu = solve_batch_raw(c[:8], G[:8], h[:8], dims, config=cfg, device="cpu")
    check(bool((cpu[4] == status[:8]).all()),
          f"{label}: CPU status {cpu[4]} vs {status[:8]}")
    prel = np.abs(cpu[6][:, 0] - stats[:8, 0]) / np.maximum(1.0, np.abs(stats[:8, 0]))
    check(bool((prel <= 1e-8).all()),
          f"{label}: CPU pcost vs card: max rel {prel.max()}")
    # lanes at the lockstep maximum, the stragglers (by instance index)
    stragglers = np.flatnonzero(k == k.max())

    emit({"phase": label, "config": f"robust_ls_batch({SEED}, batch={B_MAIN}, n={N_MAIN})",
          "native_dd": native_dd,
          "B": B_MAIN, "nv": int(c.shape[1]), "m_pad": layout.m_pad,
          "optimal": n_opt, "max_gap": float(gap.max()),
          "max_pres": float(pres.max()), "max_dres": float(dres.max()),
          "max_pcost_rel_closed_form": float(rel.max()),
          "solve_s": solve_s, "solves_per_s": B_MAIN / solve_s,
          "first_call_s": warm_s, "setup_s": setup_s,
          "lockstep_iterations": n_iter,
          "lockstep_iteration_ms": solve_s / n_iter * 1e3,
          "iters_max": int(k.max()), "iters_mean": float(k.mean()),
          "iters_histogram": {int(v): int(n) for v, n in
                              zip(*np.unique(k, return_counts=True))},
          "stragglers": {"count": int(stragglers.size),
                         "first": stragglers[:16].tolist()},
          "launches": launches, "peak_device_gb": peak_gb,
          "cpu_recheck": {"instances": 8, "max_pcost_rel": float(prel.max()),
                          "iters_equal": bool((cpu[5] == k[:8]).all())}})
    return launches, fn, args, solve_s


def _category(name):
    low = name.lower()
    for key, cat in (("chol_batched_kernel", "chol_batched"),
                     ("tri_pair_batched_kernel", "tri_pair_batched"),
                     ("chol_single_", "chol_single"),
                     ("tri_pair_single_kernel", "tri_pair_single"),
                     ("gemm", "cublas"), ("gemv", "cublas"), ("cutlass", "cublas"),
                     ("reduce", "reductions"), ("cat", "cat"),
                     ("elementwise", "elementwise"), ("copy", "copies")):
        if key in low:
            # the kernels' f32 instances are <float...> templates
            return f"{cat}_f32" if "_kernel<float" in low else cat
    return "other"


def phase_profile(run, solve_s, config, tries=3):
    """Device time of one more solve (`run()`, which ends on a host copy of
    its result) by kernel, under torch.profiler.  device_idle_share sets
    that busy time against the wall time of the unprofiled solve of the
    same inputs earlier in this call (solve_s); profiled_idle_share sets it
    against the profiled solve's own wall time, which the profiler's host
    overhead inflates.  The tracer can drop a whole trace: a solve in which
    it saw no device time is profiled again, up to `tries` times, and after
    that the phase says the profile was not measured (the launch counts,
    not the profile, are what show that the solve ran the kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = []
        for ev in prof.key_averages():
            # device-side events only: a host op's device total repeats its
            # kernels'
            if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0:
                kernels.append((ev.self_device_time_total / 1e3, ev.count, ev.key))
        kernels.sort(reverse=True)
        busy = sum(k[0] for k in kernels)
        if busy > 0:
            break
        print(f"chip_smoke: profile {config} try {attempt + 1}: the profiler "
              "saw no device time", file=sys.stderr, flush=True)
    else:
        emit({"phase": "profile", "config": config, "device_busy_ms": None,
              "unprofiled_wall_ms": solve_s * 1e3,
              "not_measured": f"the profiler saw no device time in {tries} "
                              "profiled solves"})
        return
    cats = {}
    for ms, count, name in kernels:
        c = cats.setdefault(_category(name), {"ms": 0.0, "launches": 0})
        c["ms"] += ms
        c["launches"] += count
    # the device time of the port's kernels in this solve, by kernel
    ours = {c: v for c, v in cats.items()
            if c.startswith(("chol_", "tri_pair_"))}
    emit({"phase": "profile", "config": config, "device_busy_ms": busy,
          "unprofiled_wall_ms": solve_s * 1e3,
          "device_idle_share": 1.0 - busy / (solve_s * 1e3),
          "profiled_wall_ms": wall_ms,
          "profiled_idle_share": 1.0 - busy / wall_ms,
          "port_kernels": ours, "by_category": cats,
          "top": [{"name": name[:100], "ms": ms, "count": count}
                  for ms, count, name in kernels[:12]]})


def phase_single(native_dd=False):
    """BASELINE configs 1 and 2 through socp_tpu_torch.solve on the card:
    the default KKT route (with config 2 once more with a Gondzio
    corrector), or with native_dd the structured one (ConstGram: NB = 3
    with orthant rows, and NB = 1), phase "single_native"."""
    from socp_tpu_torch import SolverConfig, Status, solve
    from socp_tpu_torch.models.portfolio import portfolio, portfolio_risk
    from socp_tpu_torch.models.random_socp import random_socp

    prob1, known = random_socp(SEED, n=50, l=10, qs=(10, 14, 20))
    prob2, info = portfolio(SEED, n=500, k=20)
    check((prob2.n, prob2.m, prob2.p, prob2.dims.qs) == (500, 1021, 1, (521,)),
          f"config 2 shape: n={prob2.n} m={prob2.m} p={prob2.p}")
    runs = (
        ("config1", "random_socp(0, n=50, l=10, qs=(10, 14, 20))", prob1, 0),
        ("config2", "portfolio(0, n=500, k=20)", prob2, 0),
        ("config2_gondzio1", "portfolio(0, n=500, k=20)", prob2, 1),
    )
    if native_dd:
        runs = tuple((f"{label}_native", source, prob, g)
                     for label, source, prob, g in runs if g == 0)
    by_config = {}
    out = {}
    for label, source, prob, g in runs:
        cfg = SolverConfig(gondzio_correctors=g, native_dd=native_dd)
        solve(prob, config=cfg, device="cuda")           # warm-up
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        sol = solve(prob, config=cfg, device="cuda")     # ends on host copies
        solve_s = time.perf_counter() - t0
        launches = read_counts()
        reps = []
        for _ in range(2):
            t0 = time.perf_counter()
            solve(prob, config=cfg, device="cuda")
            reps.append(time.perf_counter() - t0)
        solve_s = statistics.median([solve_s] + reps)

        check(sol.status == Status.OPTIMAL and not sol.inaccurate,
              f"{label}: {sol}")
        check(sol.pres <= 1e-8 and sol.dres <= 1e-8
              and (sol.gap <= 1e-8 or sol.relgap <= 1e-8),
              f"{label} misses the strict 1e-8 tolerances: {sol}")
        check(launches["chol_batched"] == launches["tri_pair_batched"] == 0,
              f"{label}: batched kernels launched: {launches}")
        none_of(launches, F32_KERNELS, label)
        # p > 0: init 2 Cholesky + 13 pair solves; per iteration 2 + 10,
        # and 3 pair solves per Gondzio corrector
        n_iter = launches["chol_single"] // 2 - 1
        check(n_iter >= 1 and launches["chol_single"] == 2 + 2 * n_iter
              and launches["tri_pair_single"] == 13 + (10 + 3 * g) * n_iter,
              f"{label}: launch ratios {launches}")
        check(sol.iterations <= n_iter <= sol.iterations + 1,
              f"{label}: {n_iter} loop iterations vs {sol.iterations}")
        if label.startswith("config1"):
            model = {"pcost_rel_known": abs(sol.pcost - known.pcost)
                     / max(1.0, abs(known.pcost))}
            check(model["pcost_rel_known"] <= 1e-6,
                  f"config1 pcost {sol.pcost} vs known {known.pcost}")
        else:
            w = sol.x
            model = {"risk": portfolio_risk(info, w),
                     "sigma_max": info["sigma_max"],
                     "budget_err": abs(float(np.sum(w)) - 1.0),
                     "w_min": float(w.min())}
            check(model["risk"] <= info["sigma_max"] * (1 + 1e-6)
                  and model["budget_err"] < 1e-6 and model["w_min"] >= -1e-7,
                  f"{label}: portfolio checks {model}")
        row = {"phase": "single_native" if native_dd else "single",
               "config": label, "source": source, "native_dd": native_dd,
               "gondzio_correctors": g, "status": sol.status_name,
               "iterations": sol.iterations, "loop_iterations": n_iter,
               "solve_ms": solve_s * 1e3,
               "ms_per_iteration": solve_s * 1e3 / n_iter,
               "pcost": sol.pcost, "gap": sol.gap, "relgap": sol.relgap,
               "pres": sol.pres, "dres": sol.dres, "launches": launches,
               **model}
        if g == 0:
            by_config[label] = launches
            cpu = solve(prob, config=cfg, device="cpu")   # plain kernels
            rel = abs(cpu.pcost - sol.pcost) / max(1.0, abs(sol.pcost))
            check(cpu.status == sol.status and rel <= 1e-8,
                  f"{label}: CPU {cpu} vs card {sol}")
            row["cpu_recheck"] = {"status": cpu.status_name,
                                  "iterations": cpu.iterations,
                                  "pcost_rel": rel}
        emit(row)
        out[label] = (prob, cfg, solve_s)
    if native_dd:
        return by_config, {}
    g0, g1 = out["config2"][2], out["config2_gondzio1"][2]
    emit({"phase": "single_gondzio", "config": "config2",
          "solve_ms": {"gondzio0": g0 * 1e3, "gondzio1": g1 * 1e3}})
    runs = {}
    for label in ("config1", "config2"):
        prob, cfg, solve_s = out[label]
        runs[label] = ((lambda p=prob, c=cfg: solve(p, config=c, device="cuda")),
                       solve_s)
    return by_config, runs


def phase_large_batch():
    """solve_batch of two config-2 instances (portfolio(s, n=500, k=20),
    s = 0, 1) on the card: n = 500 is above what the batched kernels take
    (169 in f64), so the routers factor H and solve with it an instance at
    a time through the single kernels.  The 1 x 1 Schur complement (p = 1)
    stays on the batched kernels.  Held: both OPTIMAL at 1e-8, pcost within
    1e-8 of each instance solved alone, and the launch ratios (a factor: 2
    chol_single for H, 1 chol_batched for S, 2 tri_pair_single for
    H^-1 A'; a back-solve: 4 tri_pair_single, 1 tri_pair_batched)."""
    from socp_tpu_torch import Status, solve, solve_batch
    from socp_tpu_torch.models.portfolio import portfolio

    probs = [portfolio(s, n=500, k=20)[0] for s in (SEED, SEED + 1)]
    stack = {f: np.stack([getattr(p, f) for p in probs])
             for f in ("c", "G", "h", "A", "b")}
    dims = probs[0].dims

    def run():
        return solve_batch(stack["c"], stack["G"], stack["h"], dims,
                           A=stack["A"], b=stack["b"], device="cuda")

    run()                                            # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    sols = run()
    solve_s = time.perf_counter() - t0
    launches = read_counts()
    factors, backsolves = launches["chol_batched"], launches["tri_pair_batched"]
    check(factors >= 2 and launches["chol_single"] == 2 * factors
          and launches["tri_pair_single"] == 2 * (factors + 2 * backsolves),
          f"large_batch: launch ratios {launches}")
    none_of(launches, F32_KERNELS, "large_batch")
    singles = [solve(p, device="cuda") for p in probs]
    rels = []
    for i, (sol, one) in enumerate(zip(sols, singles)):
        check(sol.status == one.status == Status.OPTIMAL and not sol.inaccurate,
              f"large_batch lane {i}: {sol} vs alone {one}")
        check(sol.pres <= 1e-8 and sol.dres <= 1e-8
              and (sol.gap <= 1e-8 or sol.relgap <= 1e-8),
              f"large_batch lane {i} misses the strict 1e-8 tolerances: {sol}")
        rels.append(abs(sol.pcost - one.pcost) / max(1.0, abs(one.pcost)))
        check(rels[-1] <= 1e-8, f"large_batch lane {i}: pcost {sol.pcost} vs "
                                f"alone {one.pcost}")
    emit({"phase": "large_batch", "config": "solve_batch of portfolio(s, n=500, "
          "k=20), s = 0, 1", "B": 2, "n": 500, "solve_ms": solve_s * 1e3,
          "iterations": [s.iterations for s in sols],
          "iterations_alone": [s.iterations for s in singles],
          "pcost_rel_alone": rels, "launches": launches})
    return launches


def phase_block_schur():
    """BASELINE config 4 through parallel.schur.solve_block on the card, at
    the contract of scripts/bench_all.py:144-170 (K = 10,240 blocks of
    nb = 10 vars, block cone R+^4 x Q^6, p = 8: 102,400 vars) with its
    SolverConfig(factor_dtype="dd32") off the TPU (:79), which the block
    path runs in f64.  Held: OPTIMAL and not inaccurate, pres and dres
    <= 1e-8 and gap or relgap <= 1e-8, pcost within 1e-6 of the
    constructed optimum (tests/test_schur.py:64's bound); a CPU re-solve
    (plain kernels) in the same status and iterations with pcost within
    1e-9; the launches of the block path (the init and each loop body: 1
    chol_batched, 1 chol_single, 9 tri_pair_batched, 4 tri_pair_single)
    and no f32 kernel."""
    from socp_tpu_torch import SolverConfig, Status
    from socp_tpu_torch.cones.layout import make_layout
    from socp_tpu_torch.parallel.schur import random_block_problem, solve_block
    from socp_tpu_torch.problem import ConeDims

    cfg = SolverConfig(factor_dtype="dd32")
    t0 = time.perf_counter()
    prob, pstar = random_block_problem(SEED, K=K4, nb=NB4, p=P4,
                                       block_dims=ConeDims(l=4, qs=(6,)))
    setup_s = time.perf_counter() - t0
    check(prob.c.size == 102_400 and prob.G.shape == (K4, 10, NB4),
          f"config 4 shape: c {prob.c.shape}, G {prob.G.shape}")

    def run():
        return solve_block(prob, config=cfg, device="cuda")  # ends on host copies

    t0 = time.perf_counter()
    run()                                            # warm-up
    first_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()             # earlier phases' tensors
    reset_counts()
    t0 = time.perf_counter()
    x, y, s, z, status, k, stats = run()
    solve_s = time.perf_counter() - t0
    launches = read_counts()
    peak_gb = (torch.cuda.max_memory_allocated() - held) / 1e9
    reps = [solve_s]
    for _ in range(2):
        t0 = time.perf_counter()
        run()
        reps.append(time.perf_counter() - t0)

    pcost, gap, relgap, pres, dres = stats[0], stats[2], stats[3], stats[4], stats[5]
    check(status == Status.OPTIMAL and stats[6] == 0.0,
          f"block_schur: status {status}, stats {stats}")
    check(pres <= 1e-8 and dres <= 1e-8 and (gap <= 1e-8 or relgap <= 1e-8),
          f"block_schur misses the strict 1e-8 tolerances: {stats}")
    pcost_rel = abs(pcost - pstar) / max(1.0, abs(pstar))
    print(f"chip_smoke: config 4 pcost {pcost!r} against the constructed "
          f"optimum {pstar!r}: relative error {pcost_rel!r}", flush=True)
    check(pcost_rel <= 1e-6, f"block_schur: pcost {pcost} vs {pstar}")
    check(x.shape == (K4, NB4) and y.shape == (P4,) and s.shape == z.shape
          == (K4, prob.block_dims.dim)
          and all(np.isfinite(a).all() for a in (x, y, s, z)),
          "block_schur: outputs not finite or of the wrong shape")
    factors = launches["chol_batched"]
    check(factors == k + 2 and launches["chol_single"] == factors
          and launches["tri_pair_batched"] == 9 * factors
          and launches["tri_pair_single"] == 4 * factors,
          f"block_schur: launch ratios {launches} for {k} iterations")
    none_of(launches, F32_KERNELS, "block_schur")

    t0 = time.perf_counter()
    cpu = solve_block(prob, config=cfg, device="cpu")       # plain kernels
    cpu_s = time.perf_counter() - t0
    cpu_rel = abs(cpu[6][0] - pcost) / max(1.0, abs(pcost))
    check(cpu[4] == status and cpu[5] == k and cpu_rel <= 1e-9,
          f"block_schur: CPU {cpu[4]} in {cpu[5]}, pcost {cpu[6][0]} vs card "
          f"{status} in {k}, pcost {pcost}")
    emit({"phase": "block_schur",
          "config": f"random_block_problem({SEED}, K={K4}, nb={NB4}, p={P4}, "
                    "block_dims=ConeDims(l=4, qs=(6,))), factor_dtype='dd32'",
          "K": K4, "nb": NB4, "p": P4, "vars": K4 * NB4,
          "m_pad": make_layout(prob.block_dims).m_pad,
          "status": status.name.lower(), "iterations": k,
          "pcost": pcost, "pcost_constructed": pstar, "pcost_rel": pcost_rel,
          "gap": gap, "relgap": relgap, "pres": pres, "dres": dres,
          "solve_s": solve_s, "solve_s_reps": reps,
          "iterations_per_s": k / solve_s, "ms_per_factor": solve_s * 1e3 / factors,
          "first_call_s": first_s, "setup_s": setup_s,
          "launches": launches, "peak_device_gb_of_the_solve": peak_gb,
          "cpu_recheck": {"status": cpu[4].name.lower(), "iterations": cpu[5],
                          "pcost_rel": cpu_rel, "solve_s": cpu_s}})
    return launches, run, statistics.median(reps)


def f32_spd(rng, B, n, neg=False):
    return torch.as_tensor(spd_batch(rng, B, n, kappa=1e4, neg=neg),
                           dtype=torch.float32, device="cuda")


def bit_equal(a, b, what):
    """The kernel's output a against its plain version's b: bit for bit.
    Returns the largest absolute difference (0.0)."""
    torch.cuda.synchronize()
    err = float((a - b).abs().max()) if a.numel() else 0.0
    check(torch.equal(a, b), f"{what}: not bit-equal to plain, max err {err}")
    return err


def div_rn_check(dtype, pairs=1 << 24):
    """div_rn (csrc/div_rn.cuh), the division on the single kernels'
    chains, against the card's own x / p on `pairs` random bit patterns
    (every class of value) and as many log-uniform normal pairs of random
    signs, made from SEED: bit for bit (a NaN for a NaN).  Returns the
    number of pairs."""
    from socp_tpu_torch.ops import _build

    size = torch.finfo(dtype).bits // 8
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)

    def bits():
        return torch.randint(0, 256, (pairs * size,), device="cuda",
                             generator=g, dtype=torch.uint8).view(dtype)

    def log_uniform(sign):
        top = 1000 if size == 8 else 125
        e = torch.randint(-top, top, (pairs,), device="cuda", generator=g)
        m = torch.rand(pairs, device="cuda", generator=g, dtype=torch.float64)
        s = (torch.randint(0, 2, (pairs,), device="cuda", generator=g) * 2 - 1
             if sign else 1)
        return (s * (1 + m) * torch.pow(2.0, e.double())).to(dtype)

    x = torch.cat([bits(), log_uniform(True)])
    p = torch.cat([bits(), log_uniform(True)])
    out = torch.empty_like(x)
    err = _build.kernel(f"div_rn_{'f64' if size == 8 else 'f32'}")(
        x.data_ptr(), p.data_ptr(), out.data_ptr(), x.numel(),
        torch.cuda.current_stream().cuda_stream)
    check(err == 0, f"div_rn launch failed, cudaError {err}")
    want = x / p
    ints = torch.int64 if size == 8 else torch.int32
    same = (out.view(ints) == want.view(ints)) | (out.isnan() & want.isnan())
    check(bool(same.all()), f"div_rn {dtype}: {int((~same).sum())} of "
                            f"{x.numel()} quotients differ from x / p")
    return x.numel()


def phase_f32_kernels():
    """The f32 instances of the four kernels against their plain versions,
    bit for bit; the non-PD check; timings at config 3's shape and the
    single ones at n = 1 and 500 (config 2's in f32 mode) and 128 (P1's)."""
    from socp_tpu_torch.ops import chol

    rng = np.random.default_rng(SEED + 2)
    dev = torch.device("cuda")
    errs = {"chol_f32": [], "tri_pair_f32": []}
    for B, n in F32_BATCHED:
        H = f32_spd(rng, B, n)
        L = chol.chol_batched(H)
        errs["chol_f32"].append(bit_equal(L, chol.chol_batched_plain(H),
                                          f"chol_batched f32 B={B} n={n}"))
        for k in (1, 3):
            rhs = torch.randn((B, n, k), generator=torch.Generator(dev).manual_seed(k),
                              device=dev, dtype=torch.float32)
            errs["tri_pair_f32"].append(bit_equal(
                chol.tri_pair_batched(L, rhs), chol.tri_pair_batched_plain(L, rhs),
                f"tri_pair_batched f32 B={B} n={n} k={k}"))
    for n in F32_SINGLE_NS:
        H = f32_spd(rng, 1, n)[0]
        L = chol.chol_single(H)
        errs["chol_f32"].append(bit_equal(L, chol.chol_single_plain(H),
                                          f"chol_single f32 n={n}"))
        for k in SINGLE_KS:
            rhs = torch.as_tensor(rng.standard_normal((n, k)), dtype=torch.float32,
                                  device=dev)
            errs["tri_pair_f32"].append(bit_equal(
                chol.tri_pair_single(L, rhs), chol.tri_pair_single_plain(L, rhs),
                f"tri_pair_single f32 n={n} k={k}"))

    bad = f32_spd(rng, 64, 102, neg=True)
    for f in (chol.chol_batched, chol.chol_batched_plain):
        Lb = f(bad)
        torch.cuda.synchronize()
        check(bool((~torch.isfinite(Lb)).flatten(1).any(1).all()),
              f"{f.__name__} f32: a non-PD input gave a finite factor")
    for n in (20, 128, 500):                 # one tile, then the dataflow
        bad = f32_spd(rng, 1, n, neg=True)[0]
        for f in (chol.chol_single, chol.chol_single_plain):
            Lb = f(bad)
            torch.cuda.synchronize()
            check(not bool(torch.isfinite(Lb).all()),
                  f"{f.__name__} f32: a non-PD input at n={n} gave a finite factor")

    batched = batched_timing(torch.float32, rng)
    timing = {"chol_f32": {"batched": batched["chol_batched"]},
              "tri_pair_f32": {"batched": batched["tri_pair_batched"]}}
    single = single_timing(torch.float32, rng)
    timing["chol_f32"].update({f"single_{at}": t
                               for at, t in single["chol_single"].items()})
    timing["tri_pair_f32"].update({f"single_{at}": t
                                   for at, t in single["tri_pair_single"].items()})
    emit({"phase": "f32_kernels", "batched": [list(x) for x in F32_BATCHED],
          "single_ns": list(F32_SINGLE_NS), "ks": list(SINGLE_KS),
          "kappa": 1e4, "bit_equal": True,
          "div_rn_pairs": div_rn_check(torch.float32),
          "max_abs_err": {k: max(v) for k, v in errs.items()},
          "timing": {name: {at: {kk: vv for kk, vv in t.items() if kk != "bound"}
                            for at, t in by.items()}
                     for name, by in timing.items()}})
    return errs, timing


def tf32_off():
    """The f32 factor's products (Ghat'Ghat, Ghat' v, Ghat v) must run in
    full f32 on cuBLAS: PyTorch's defaults, which the port never changes."""
    state = {"allow_tf32": torch.backends.cuda.matmul.allow_tf32,
             "float32_matmul_precision": torch.get_float32_matmul_precision()}
    print(f"chip_smoke: f32 matmul settings {state}", flush=True)
    check(state["allow_tf32"] is False
          and state["float32_matmul_precision"] == "highest",
          f"TF32 is on for f32 products: {state}")
    return state


def relaxed_ok(stats):
    """The reference's relaxed ("optimal, inaccurate") tolerances."""
    gap, relgap, pres, dres = stats[:, 2], stats[:, 3], stats[:, 4], stats[:, 5]
    return ((pres <= RELAXED_FEAS) & (dres <= RELAXED_FEAS)
            & ((gap <= RELAXED_GAP) | (relgap <= RELAXED_GAP)))


def phase_f32factor():
    """Config 3 in the mixed-precision mode through prepare_batch."""
    from socp_tpu_torch import SolverConfig, Status, prepare_batch, solve_batch_raw
    from socp_tpu_torch.models.robust_ls import robust_ls_batch

    tf32 = tf32_off()
    cfg = SolverConfig(factor_dtype="float32")
    c, G, h, dims = robust_ls_batch(SEED, batch=B_MAIN, n=N_MAIN)
    fn, args, layout = prepare_batch(c, G, h, dims, config=cfg, device="cuda")
    fn(*args)[4].cpu()                               # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    out = fn(*args)
    status = out[4].cpu().numpy()                    # syncs on the result
    solve_s = time.perf_counter() - t0
    launches = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    none_of(launches, F64_KERNELS + ("chol_single_f32", "tri_pair_single_f32"),
            "config 3 (f32 factor)")

    x = out[0].cpu().numpy()
    k = out[5].cpu().numpy()
    stats = out[6].cpu().numpy()
    n_opt = int(np.sum(status == int(Status.OPTIMAL)))
    check(n_opt == B_MAIN, f"f32factor: {n_opt}/{B_MAIN} OPTIMAL")
    ok = relaxed_ok(stats)
    check(bool(ok.all()), f"f32factor: {int((~ok).sum())} instances miss the "
                          "relaxed tolerances")
    kk = dims.qs[0] - 1                              # closed form, as phase_main
    D = -G[:, 1:kk + 1, :N_MAIN]
    d = -h[:, 1:kk + 1]
    xs = x[:, :N_MAIN]
    obj = (np.linalg.norm(np.einsum("bkn,bn->bk", D, xs) - d, axis=1)
           + 0.1 * np.linalg.norm(xs, axis=1))
    rel = np.abs(stats[:, 0] - obj) / np.maximum(1.0, np.abs(obj))
    check(bool((rel <= RELAXED_GAP).all()),
          f"f32factor pcost vs closed form: max rel {rel.max()}")
    n_iter = launches["chol_batched_f32"] - 1        # init 1 + 4, then 1 + 3
    check(n_iter >= 1 and launches["tri_pair_batched_f32"] == 4 + 3 * n_iter,
          f"f32factor launch ratios {launches}")
    check(int(k.max()) <= n_iter <= int(k.max()) + 1,
          f"f32factor: {n_iter} lockstep iterations vs max k {int(k.max())}")

    cpu = solve_batch_raw(c[:8], G[:8], h[:8], dims, config=cfg, device="cpu")
    check(bool((cpu[4] == status[:8]).all()), f"CPU status {cpu[4]} vs {status[:8]}")
    check(bool((cpu[6][:, 6] == stats[:8, 6]).all()),
          f"CPU inaccurate flags {cpu[6][:, 6]} vs {stats[:8, 6]}")
    prel = np.abs(cpu[6][:, 0] - stats[:8, 0]) / np.maximum(1.0, np.abs(stats[:8, 0]))
    check(bool((prel <= RELAXED_GAP).all()),
          f"f32factor CPU pcost vs card: max rel {prel.max()}")

    emit({"phase": "f32factor",
          "config": f"robust_ls_batch({SEED}, batch={B_MAIN}, n={N_MAIN}), "
                    "factor_dtype='float32'",
          "tf32": tf32, "B": B_MAIN, "nv": int(c.shape[1]), "m_pad": layout.m_pad,
          "optimal": n_opt, "inaccurate": int(stats[:, 6].sum()),
          "max_gap": float(stats[:, 2].max()), "max_pres": float(stats[:, 4].max()),
          "max_dres": float(stats[:, 5].max()),
          "max_pcost_rel_closed_form": float(rel.max()),
          "solve_s": solve_s, "solves_per_s": B_MAIN / solve_s,
          "lockstep_iterations": n_iter,
          "lockstep_iteration_ms": solve_s / n_iter * 1e3,
          "iters_max": int(k.max()), "iters_mean": float(k.mean()),
          "launches": launches, "peak_device_gb": peak_gb,
          "cpu_recheck": {"instances": 8, "max_pcost_rel": float(prel.max()),
                          "flags_equal": True,
                          "iters_equal": bool((cpu[5] == k[:8]).all()),
                          "cpu_iters": cpu[5].tolist(), "card_iters": k[:8].tolist()}})
    return launches, fn, args, solve_s


def phase_f32factor_single():
    """Config 2 in the mixed-precision mode through solve.  The portfolio's
    checks at this mode's tolerances: risk <= sigma_max (1 + 1e-4), budget
    within 1e-4, w >= -1e-4 (feastol_inacc), and status and inaccurate flag
    as the CPU re-solve (plain f32 kernels) says, pcost within 5e-5."""
    from socp_tpu_torch import SolverConfig, Status, solve
    from socp_tpu_torch.models.portfolio import portfolio, portfolio_risk

    tf32_off()
    cfg = SolverConfig(factor_dtype="float32")
    prob, info = portfolio(SEED, n=500, k=20)
    solve(prob, config=cfg, device="cuda")           # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    sol = solve(prob, config=cfg, device="cuda")
    times = [time.perf_counter() - t0]
    launches = read_counts()
    for _ in range(2):
        t0 = time.perf_counter()
        solve(prob, config=cfg, device="cuda")
        times.append(time.perf_counter() - t0)
    solve_s = statistics.median(times)
    none_of(launches, F64_KERNELS + ("chol_batched_f32", "tri_pair_batched_f32"),
            "config 2 (f32 factor)")
    n_iter = launches["chol_single_f32"] // 2 - 1
    check(n_iter >= 1 and launches["chol_single_f32"] == 2 + 2 * n_iter
          and launches["tri_pair_single_f32"] == 13 + 10 * n_iter,
          f"f32factor_single launch ratios {launches}")
    check(sol.iterations <= n_iter <= sol.iterations + 1,
          f"f32factor_single: {n_iter} loop iterations vs {sol.iterations}")
    check(sol.status == Status.OPTIMAL, f"f32factor_single: {sol}")
    st = np.array([[sol.pcost, sol.dcost, sol.gap, sol.relgap, sol.pres, sol.dres]])
    check(bool(relaxed_ok(st).all()), f"f32factor_single tolerances: {sol}")
    w = sol.x
    model = {"risk": portfolio_risk(info, w), "sigma_max": info["sigma_max"],
             "budget_err": abs(float(np.sum(w)) - 1.0), "w_min": float(w.min())}
    check(model["risk"] <= info["sigma_max"] * (1 + RELAXED_FEAS)
          and model["budget_err"] <= RELAXED_FEAS and model["w_min"] >= -RELAXED_FEAS,
          f"f32factor_single: portfolio checks {model}")
    cpu = solve(prob, config=cfg, device="cpu")
    rel = abs(cpu.pcost - sol.pcost) / max(1.0, abs(sol.pcost))
    check(cpu.status == sol.status and cpu.inaccurate == sol.inaccurate
          and rel <= RELAXED_GAP, f"f32factor_single: CPU {cpu} vs card {sol}")
    emit({"phase": "f32factor_single",
          "config": "portfolio(0, n=500, k=20), factor_dtype='float32'",
          "status": sol.status_name, "inaccurate": sol.inaccurate,
          "iterations": sol.iterations, "loop_iterations": n_iter,
          "solve_ms": solve_s * 1e3, "ms_per_iteration": solve_s * 1e3 / n_iter,
          "pcost": sol.pcost, "gap": sol.gap, "relgap": sol.relgap,
          "pres": sol.pres, "dres": sol.dres, "launches": launches, **model,
          "cpu_recheck": {"status": cpu.status_name, "inaccurate": cpu.inaccurate,
                          "iterations": cpu.iterations, "pcost_rel": rel}})
    return launches, (lambda: solve(prob, config=cfg, device="cuda")), solve_s


def phase_probes():
    """The probes at their scripts' shapes and inputs: driven once with the
    counts at 0 (the launches reported), then held to their plain versions
    bit for bit and to the scripts' own checks, and timed."""
    from socp_tpu_torch.ops import chol, probes

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)                   # run_chol's inputs
    A = rng.normal(size=(128, 128)).astype(np.float32)
    H1 = torch.as_tensor(A @ A.T + 128 * np.eye(128, dtype=np.float32), device=dev)
    rng = np.random.default_rng(1)                   # run_eft's
    a = torch.as_tensor(rng.normal(size=(8, 128)).astype(np.float32), device=dev)
    b = torch.as_tensor((rng.normal(size=(8, 128)) * 1e-3).astype(np.float32),
                        device=dev)
    M = torch.arange(64 * 64, dtype=torch.float32, device=dev).reshape(64, 64)
    rng = np.random.default_rng(0)                   # run_fwd's
    A5 = rng.normal(size=(128, 128))
    L5 = np.linalg.cholesky(A5 @ A5.T + 128 * np.eye(128)).astype(np.float32)
    b5 = rng.normal(size=(128, 1)).astype(np.float32)
    LT = torch.as_tensor(L5.T.copy(), device=dev)
    bb = torch.as_tensor(b5, device=dev)

    torch.cuda.synchronize()
    reset_counts()
    out = {"P1": chol.chol_single(H1), "P2": probes.eft(a, b),
           "P3": probes.row_sum(M), "P4": probes.row_reverse(M),
           "P5": probes.fwd_subst(LT, bb)}
    torch.cuda.synchronize()
    launches = read_counts()
    check(launches["chol_single_f32"] == 1
          and all(v == 1 for v in probes.launches.values()),
          f"probes: launches {launches}")

    errs = {"P1": bit_equal(out["P1"], chol.chol_single_plain(H1), "P1"),
            "P2": max(bit_equal(o, r, f"P2 {nm}") for nm, o, r in
                      zip("sepq", out["P2"], probes.eft_plain(a, b))),
            "P3": bit_equal(out["P3"], probes.row_sum_plain(M), "P3"),
            "P4": bit_equal(out["P4"], probes.row_reverse_plain(M), "P4"),
            "P5": bit_equal(out["P5"], probes.fwd_subst_plain(LT, bb), "P5")}
    L = out["P1"].double()
    Hd = H1.double()
    recon = float((L @ L.T - Hd).abs().max() / Hd.abs().max())
    check(recon < 1e-5, f"P1 reconstruction {recon}")
    s, e, p, q = (o.double() for o in out["P2"])
    a64, b64 = a.double(), b.double()
    check(torch.equal(s + e, a64 + b64) and torch.equal(p + q, a64 * b64)
          and bool((e != 0).any()) and bool((q != 0).any()),
          "P2: two-sum / two-prod not exact")
    check(torch.equal(out["P3"][0], M.sum(0)), "P3: row sum")
    check(torch.equal(out["P4"], M.flip(0)), "P4: reversed rows")
    exact = np.linalg.solve(L5.astype(np.float64), b5.astype(np.float64))
    fwd_rel = float(np.abs(out["P5"].cpu().numpy() - exact).max() / np.abs(exact).max())
    check(fwd_rel < 1e-4, f"P5: relative error {fwd_rel}")

    n = 128
    timing = {
        "probe_eft": timed(
            lambda: probes.eft(a, b), None, lambda: probes.eft_plain(a, b),
            bound=bound(6 * 4 * a.numel(), 23 * a.numel(), FP32_FLOPS_PER_S)),
        "probe_read": timed(
            lambda: probes.row_sum(M), lambda: M.sum(0),
            lambda: probes.row_sum_plain(M),
            bound=bound(4 * (M.numel() + M.shape[1]), M.numel(), FP32_FLOPS_PER_S)),
        "probe_write": timed(
            lambda: probes.row_reverse(M), lambda: M.flip(0),
            lambda: probes.row_reverse_plain(M),
            bound=bound(2 * 4 * M.numel(), 0, FP32_FLOPS_PER_S)),
        "probe_fwd": timed(
            lambda: probes.fwd_subst(LT, bb),
            lambda: torch.linalg.solve_triangular(LT.mT, bb, upper=False),
            lambda: probes.fwd_subst_plain(LT, bb),
            bound=bound(4 * (n * (n + 1) // 2 + 2 * n), n * n, FP32_FLOPS_PER_S)),
        "probe_chol": timed(
            lambda: chol.chol_single(H1), lambda: torch.linalg.cholesky_ex(H1),
            lambda: chol.chol_single_plain(H1), plain_reps=5,
            bound=bound(4 * (n * (n + 1) // 2 + n * n), chol_flops(n),
                        FP32_FLOPS_PER_S)),
    }
    emit({"phase": "probes", "bit_equal": True, "max_abs_err": errs,
          "P1_reconstruction": recon, "P2_exact": True, "P5_rel_err": fwd_rel,
          "launches": {k: v for k, v in launches.items() if v},
          "timing": {k: {kk: vv for kk, vv in t.items() if kk != "bound"}
                     for k, t in timing.items()}})
    return launches, errs, timing


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        sys.exit(1)
    import socp_tpu_torch  # noqa: F401  (fails outside the repository)

    kind = phase_device()
    phase_build()
    errs, timing, block_timing = phase_kernels()
    s_errs, s_timing = phase_single_kernels()
    launches, fn, args, solve_s = phase_main()
    phase_profile(lambda: fn(*args)[4].cpu(), solve_s, "config3")
    n_launches, n_fn, n_args, n_solve_s = phase_main(native_dd=True)
    phase_profile(lambda: n_fn(*n_args)[4].cpu(), n_solve_s, "config3_native")
    s_launches, single_runs = phase_single()
    for label, (run, run_s) in single_runs.items():
        phase_profile(run, run_s, label)
    sn_launches, _ = phase_single(native_dd=True)
    lb_launches = phase_large_batch()
    b_launches, b_run, b_solve_s = phase_block_schur()
    phase_profile(b_run, b_solve_s, "config4")
    f_errs, f_timing = phase_f32_kernels()
    f_launches, f_fn, f_args, f_solve_s = phase_f32factor()
    phase_profile(lambda: f_fn(*f_args)[4].cpu(), f_solve_s, "config3_f32factor")
    fs_launches, fs_run, fs_solve_s = phase_f32factor_single()
    phase_profile(fs_run, fs_solve_s, "config2_f32factor")
    p_launches, p_errs, p_timing = phase_probes()
    errs.update(s_errs)
    meta = {
        "chol_batched": ("socp_tpu_torch/csrc/chol_batched.cu",
                         "socp_tpu/ops/pallas_chol.py:298"),
        "tri_pair_batched": ("socp_tpu_torch/csrc/tri_pair_batched.cu",
                             "socp_tpu/ops/pallas_chol.py:388"),
        "chol_single": ("socp_tpu_torch/csrc/chol_single.cu",
                        "socp_tpu/ops/pallas_chol.py:155"),
        "tri_pair_single": ("socp_tpu_torch/csrc/tri_pair_single.cu",
                            "socp_tpu/ops/pallas_chol.py:220"),
    }

    def numbers(t):
        # ms, library_ms: CUDA events around one call, host work included
        # (call_ms, library_call_ms); kernel_ms, library_kernel_ms: device
        # time of the kernels the call enqueues, and how device_ms took it
        return {"ms": t["call_ms"], "call_ms": t["call_ms"],
                "kernel_ms": t["kernel_ms"], "kernel_ms_by": t["kernel_ms_by"],
                "plain_ms": t["plain_ms"],
                "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
                "library_ms": t["library_call_ms"],
                "library_call_ms": t["library_call_ms"],
                "library_kernel_ms": t["library_kernel_ms"],
                "library_kernel_ms_by": t["library_kernel_ms_by"]}

    rows = []
    for name, (source, replaces) in meta.items():
        # launches on every path this script drives with the f64 kernels,
        # each read with the counts set to 0 just before it
        by_path = {"main": launches[name], "main_native": n_launches[name],
                   **{c: v[name] for c, v in s_launches.items()},
                   **{c: v[name] for c, v in sn_launches.items()},
                   "large_batch": lb_launches[name],
                   "block_schur": b_launches[name]}
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": launches[name],
               "launches_by_path": by_path,
               "max_abs_err": max(errs[name])}
        if name in s_timing:
            # at config 2's shape (n = 500, k = 1) with config 2's launches;
            # the other shapes of the path and each config's launches beside
            at = "n=500" if name == "chol_single" else "n=500,k=1"
            row.update(numbers(s_timing[name][at]), at={"n": 500, "k": 1},
                       launches=s_launches["config2"][name],
                       launches_by_config={c: v[name]
                                           for c, v in s_launches.items()},
                       by_shape={a: numbers(t) for a, t in s_timing[name].items()})
        else:
            row.update(numbers(timing[name]))
        # config 4's shapes (the blocks; the Schur factor, n = 8)
        row["by_shape"] = {**row.get("by_shape", {}),
                           **{a: numbers(t)
                              for a, t in block_timing.get(name, {}).items()}}
        rows.append(row)
    # the f32 instances: one row per TPU kernel, at config 3's shape with
    # the single instance's numbers at the single path's shapes beside;
    # launches: the batched instance's in phase 9 plus the single's in 10
    for name, base, replaces in (
            ("chol_f32", "chol", "socp_tpu/ops/pallas_chol.py:68"),
            ("tri_pair_f32", "tri_pair", "socp_tpu/ops/pallas_chol.py:105")):
        t = f_timing[name]
        b_name, s_name = f"{base}_batched_f32", f"{base}_single_f32"
        rows.append({
            "name": name, "route": "cuda",
            "source": f"socp_tpu_torch/csrc/{base}_batched.cu",
            "replaces": replaces,
            "launches": f_launches[b_name] + fs_launches[s_name],
            "launches_by_phase": {"f32factor": {b_name: f_launches[b_name]},
                                  "f32factor_single": {s_name: fs_launches[s_name]}},
            "max_abs_err": max(f_errs[name]),
            **numbers(t["batched"]), "at": {"B": B_MAIN, "n": N_MAIN + 2, "k": 1},
            "single": {"source": f"socp_tpu_torch/csrc/{base}_single.cu",
                       **{at[len("single_"):]: numbers(v) for at, v in t.items()
                          if at.startswith("single_")}}})
    for name, source, replaces, err in (
            ("probe_chol", "socp_tpu_torch/csrc/chol_single.cu",
             "scripts/pallas_probe.py:46", "P1"),
            ("probe_eft", "socp_tpu_torch/csrc/probes.cu",
             "scripts/pallas_probe.py:87", "P2"),
            ("probe_read", "socp_tpu_torch/csrc/probes.cu",
             "scripts/pallas_probe2.py:41", "P3"),
            ("probe_write", "socp_tpu_torch/csrc/probes.cu",
             "scripts/pallas_probe2.py:63", "P4"),
            ("probe_fwd", "socp_tpu_torch/csrc/probes.cu",
             "scripts/pallas_probe2.py:84", "P5")):
        count = "chol_single_f32" if name == "probe_chol" else name
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": p_launches[count],
                     "max_abs_err": p_errs[err], **numbers(p_timing[name])})
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
