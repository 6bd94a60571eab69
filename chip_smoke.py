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
              3, and config 5's (65,536 scenarios and a chunk of 2048, n =
              21 and the 1 x 1 Schur complement); a matrix that is not
              positive definite must give a non-finite factor.  Timed at
              config 3's, config 4's and config 5's shapes.
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
              configs 1, 2 and 4 and the huge cone give them), non-PD
              inputs of one tile and of many; timed as phase 3 at the
              shapes configs 1, 2 and 4 and the huge cone give them
              (SINGLE_CHOL_AT, SINGLE_PAIR_AT); the division on their
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
  7d. admm    BASELINE config 5 (scripts/bench_all.py:177-200):
              scenario_portfolio(0, n=20, n_scenarios=65536) (nv = 21,
              m_pad = 54, p = 1) through parallel.admm.admm_consensus on
              "cuda", rho = 1, two warm-up rounds, then 10 timed rounds,
              three ways: (a) SolverConfig(factor_dtype="dd32") with
              scenario_chunk=2048, bench_all's call off the TPU; (b) the
              same as one batch of 65,536; (c) (b) with native_dd=True.
              Held: every inner solve OPTIMAL, (a) and (b) agree (w_bar
              within 1e-9), (c) and (b) within 1e-7, the launch ratios of a
              p = 1 inner solve (2 chol_batched and 10 tri_pair_batched an
              iteration, 2 + 13 for a cold start) and no other kernel; per
              round its seconds and launches (read at the round's one
              device read, admm._fetch), the solve's peak device memory.
              At bench_all's small scale (S = 256): 10 rounds on the card
              against a CPU re-run of the port (the same rounds and rho,
              w_bar within 1e-8, pres and dres within 1e-6 relative) and
              the CPU re-run against the reference's numbers (REF5); then
              a run to tol 1e-6 held to tests/test_admm.py:12-30's checks
              against the extensive form solved by `solve` on the card.
              Then profiles of one round of (b) ("config5", data
              placement and a cold start included) and of (b)'s timed
              call of 10 rounds ("config5_rounds").
  7e. hugecone  one SOCP with a cone of a million rows through
              parallel.hugecone on "cuda" (no BASELINE config; the
              reference's own scale): (a) scripts/hugecone_bench.py's
              defaults, q = 2^20 + 1, n = 64, l = 16, seed 0 (G 0.54 GB),
              which is primal infeasible at this q (||d|| grows as
              sqrt(q)), so its Farkas certificate is held; (b) the
              multi-SOC fixture of tests/test_hugecone.py:103-123 at n = 64,
              l = 16, qs = (2^19 + 1, 2^19 + 1), p = 4, seed 3, OPTIMAL at
              1e-8.  Each through prepare_huge: the upload, one cold solve,
              3 timed solves reusing it (scripts/hugecone_bench.py:80-96),
              then again with SolverConfig(gondzio_correctors=1).  Held: the
              status; for OPTIMAL the 1e-8 tolerances, s in the cone and
              gap, pres and dres recomputed in numpy; for the certificate z
              in the cone and ||G'z|| <= 1e-8 (-h'z); launches of only
              chol_single and tri_pair_single, in the loop's ratios (1 + 4
              a factor for p = 0, 2 + 13 for p > 0, a corrector 1 or 3
              more), and one device read a loop body; at q = 2^16 + 1 the
              card against the port's CPU path (status, iterations, pcost
              1e-9, x 1e-7).  Then a profile of one steady solve of (a)
              ("hugecone").
  7f. multidevice  the sharded entry points over torch.distributed
              (socp_tpu_torch/parallel/: runtime, mesh, collectives,
              batch): (a) a world of one rank on NCCL, at the full
              contracts, config 3 through solve_batch_sharded (B = 4096),
              config 4 through solve_block(mesh=) (K = 10,240), config 5
              through admm_consensus(mesh=) (S = 65,536, one batch,
              MD_ROUNDS5 rounds, dd32) and the huge cone's run (b)
              through solve_huge(mesh=), each bit-equal to the same call
              with mesh=None on the card, its collectives counted (each a
              NCCL call; none staged) and its launches read; a profile of
              config 4's sharded solve ("config4_mesh1", NCCL kernels as
              category "nccl"); (b) two spawned ranks sharing the card over
              gloo (NCCL refuses two ranks of one communicator on one GPU:
              "Duplicate GPU detected"; gloo's collectives stage through
              the host, counted as "staged"), config 4 and the huge cone
              at full size, config 3 at B3_TWO instances and config 5 at
              S5_TWO scenarios on the 2-D pod mesh; the two ranks' results
              bit-identical, and each held to the one-device run: the same
              status and iterations (rounds, rho), pcost within 1e-9
              relative, x, y, z (w_bar) within 1e-7, except config 4's x,
              which its solve does not fix to 1e-7 (md_held) and which is
              reported.  Seconds of each run with nvidia-smi's line beside;
              every rank killed at a failure or at MD_TIMEOUT_S.
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
 10b. f32carry  the reference's f32-carries mode, dtype=torch.float32
              (TF32 asserted off before and after): (a) config 3 at B =
              4096 through prepare_batch, the f64 default and the f32-factor
              mode, then f32 carries with the default config and with
              refine_in_f64=True, one after another: solves/s, status
              counts, lockstep and per-instance iterations, the launches
              (f32 carries: only chol_batched_f32 and tri_pair_batched_f32,
              in the loop's ratios), and on every instance the f32-mode
              gates of PERF.md section 2 with pres, dres, gap and relgap
              recomputed in numpy f64 and pcost within 5e-5 of the closed
              form; its profile follows ("config3_f32carry"); (b) config 2
              through solve: only the single f32 kernels, the portfolio's
              checks at the relaxed tolerances, pcost within 5e-5 of the
              f64 solve; (c) config 4 at K = 10,240 through solve_block,
              against the f64 solve: only the f32 kernels, in the block
              path's ratios; OPTIMAL would be held at the gates and pcost
              within 5e-5, any other exit must be the reference's own f32
              status at this K (NUMERICAL_ERROR: f32 sums over 102,400
              variables stall above the relaxed gap); (d) config 5 at S =
              65,536 as one batch, ROUNDS5_F32 rounds, against f64: every
              inner solve OPTIMAL, the objective within 5e-5, only the
              batched f32 kernels.  Status, iterations (and the difference
              from f64) and seconds of each.
 11. probes   the ports of the Mosaic probes (scripts/pallas_probe*.py;
              socp_tpu_torch/ops/probes.py, csrc/probes.cu) at the probes'
              own shapes, each bit-equal to its plain version and held to
              its script's own check, and timed as phase 3; P1, the f32
              Cholesky at n = 128, runs the f32 single kernel.  probe_fwd
              also at FWD_SHAPES (n = 100 and 33, k = 1 and 4) and with a
              zero, a negative zero, a subnormal, a huge value and a NaN in
              b, bit for bit; then timed against solve_triangular in turns
              (kernel, library, library, kernel, twice); and an empty
              kernel's launch (probe_empty), the floor under every probe.
 12. examples  the six examples of socp_tpu_torch/examples/ through their
              run() on the card at the reference scripts' sizes, one rank,
              mesh=None, each with the counts at 0 just before it and the
              kernels' plain versions counted (none may run): its f64
              kernels launched (the single ones, the batched ones, or both
              for block_schur and admm_stochastic) and no other.  Held:
              portfolio (seed 7, n = 200) OPTIMAL, not inaccurate, the
              model's checks, pcost within 1e-7 of utils.oracle; warm_start
              (n = 120, 5 days) day 0 within 1e-7 of the oracle and every
              warm pcost within 1e-7 of cold; batched_robust_ls (B = 64,
              n = 50, native_dd) all OPTIMAL at the 1e-8 tolerances (pres,
              dres, and gap or relgap, on every lane), four lanes
              within 1e-7 of the oracle; block_schur (K = 8) OPTIMAL within
              1e-6 of the known optimum; admm_stochastic (S = 32, 100
              rounds) every inner solve OPTIMAL, its rounds and objective
              (1e-9) those of a CPU re-run, the extensive form OPTIMAL
              within 1e-7 of the oracle; huge_cone (q = 8,193) the status
              of a CPU re-run (primal infeasible), held to its certificate
              (huge_held).  Then the portfolio once more inside
              utils.profiling.trace: the trace must name the f64 single
              kernels (the kernels of the entry points chol_single_f64 and
              tri_pair_single_f64).  Its line carries a
              utils.metrics.metric_record a run (wall s, status,
              iterations, launches) and the PhaseTimers report, which is
              also printed.
Then a {"kernels": [...]} line, one row per TPU kernel (11): the f64
batched kernels at config 3's shapes, with their launches in phase 5 (each
f64 row also has "launches_by_path": phases 5, 5n, 7, 7n, 7b, 7c, 7d,
7e, 7f (multidevice_<run> for (a), multidevice_2ranks_<run> for (b)'s
rank 0) and 12 (examples_<name>), and "by_shape": its numbers at config
4's and config 5's shapes, and for the single ones at the single path's and the huge cone's); the
f64 single-instance ones at n = 500, k = 1 with the path's other shapes
beside, with their launches in phase 7's default run of config 2 and, per
config, of configs 1 and 2; the f32 Cholesky and pair solve at B = 4096,
n = 102 with the single instances beside, with their launches in phases 9
and 10 (and 10b's by run beside); the probes (P1 its own row), with their
launches in phase 11, P2-P5 with the empty launch's device time beside
and P5 with its timings in turns.  A
row's "ms" and "library_ms" are event times of one call (call_ms,
library_call_ms), "kernel_ms" and "library_kernel_ms" device times beside
them.  Last, the {"ok": true, ...} line.
Any failed check exits non-zero before the last line is printed.  It needs
CUDA and the repository: without either it exits non-zero.
"""

from __future__ import annotations

import contextlib
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
# config 5: scenario_portfolio(0, n=N5, n_scenarios=S5), inner solves in
# chunks of CHUNK5 (scripts/bench_all.py:177-200); S5_SMALL is its small
# scale, ROUNDS5 its timed rounds
S5, N5, CHUNK5, S5_SMALL, ROUNDS5 = 65536, 20, 2048, 256, 10
# the reference at S5_SMALL, 10 rounds: socp_tpu.parallel.admm.admm_consensus
# with SolverConfig(factor_dtype="dd32"), as bench_all calls it, on the CPU
# with x64 (tests/test_torch_admm.py holds the port's CPU path to the same
# numbers)
REF5 = {"rounds": 10, "rho": 1.0, "pres": 0.010473211701971484,
        "dres": 0.02789616956783297, "objective": -0.1839553781855421}
# the huge cone (socp_tpu_torch/parallel/hugecone.py), at the reference's
# own scale: (a) scripts/hugecone_bench.py's defaults, one SOC of q =
# Q_HUGE with n = N_HUGE, l = L_HUGE, seed 0; (b) tests/test_hugecone.py's
# multi-SOC generator at QS_HUGE, p = P_HUGE, seed 3.  Q_HUGE_SMALL: each
# SOC's q in the card's check against the CPU.
Q_HUGE, N_HUGE, L_HUGE = (1 << 20) + 1, 64, 16
QS_HUGE, P_HUGE, Q_HUGE_SMALL = ((1 << 19) + 1, (1 << 19) + 1), 4, (1 << 16) + 1
# the multidevice phase: ADMM's rounds in it, run (b)'s depth for configs
# 3 and 5 (instances, scenarios), and (b)'s deadline (and its ranks'
# collective timeout), after which every rank is killed
MD_ROUNDS5, B3_TWO, S5_TWO, MD_TIMEOUT_S = 2, 512, 4096, 420
HBM_BYTES_PER_S = 3.35e12           # H100 SXM data sheet
FP64_FLOPS_PER_S = 67e12            # H100 SXM data sheet, FP64 tensor core (the
                                    # card's fastest FP64 rate: a lower bound)
FP32_FLOPS_PER_S = 67e12            # H100 SXM data sheet, FP32 (non-tensor)
# both sides of the panel and tile edges (32) and of the one-block limits
# of the kernels before (169 f64, 240 f32), up to the reference's
# _PALLAS_MAX_N and past it
SINGLE_NS = (1, 2, 4, 5, 8, 31, 32, 33, 50, 64, 65, 169, 170, 333, 500, 768,
             1000)
SINGLE_KS = (1, 4, 5)                   # 5: config 1's p, the k of H^-1 A'
# the shapes the single path gives the kernels: configs 1 and 2 in f64,
# config 4's Schur factor (n = 8, the pair solve at k = 1) and the huge
# cone's (H at n = 64, its solves at k = 1 and H^-1 A' at k = P_HUGE; the
# P_HUGE x P_HUGE Schur factor), config 2 in f32 mode and P1 (n = 128) in
# f32; pair solves as (n, k)
SINGLE_CHOL_AT = {"f64": (1, 4, 5, 8, 50, 64, 500), "f32": (1, 128, 500)}
SINGLE_PAIR_AT = {"f64": ((1, 1), (4, 1), (5, 1), (8, 1), (50, 1), (50, 5),
                          (64, 1), (64, 4), (500, 1)),
                  "f32": ((1, 1), (128, 1), (500, 1))}
# (B, n) of the batched kernels' checks: config 3's shapes, config 4's
# blocks (with k = P4 too), then both sides of the micro-tile (4) and
# panel (32) edges and of the Cholesky's second schedule (above n = 108),
# up to the largest n the wrappers take
F64_BATCHED = ((B_MAIN, N_MAIN + 2), (K4, NB4), (8, 37), (B_MAIN, 3), (64, 1),
               (64, 2), (64, 4), (64, 5), (64, 31), (64, 32), (64, 33),
               (64, 65), (64, 108), (64, 109), (64, 169), (S5, N5 + 1),
               (CHUNK5, N5 + 1), (S5, 1), (CHUNK5, 1))
F32_BATCHED = ((B_MAIN, 1), (B_MAIN, 3), (B_MAIN, 37), (B_MAIN, 102),
               (64, 2), (64, 5), (64, 31), (64, 32), (64, 33), (64, 65),
               (64, 108), (64, 109), (256, 169), (256, 240))
KAPPA = {"f64": 1e8, "f32": 1e4}
F32_SINGLE_NS = (1, 2, 5, 31, 32, 33, 50, 64, 65, 128, 240, 241, 333, 500,
                 768, 1000)
RELAXED_FEAS, RELAXED_GAP = 1e-4, 5e-5  # feastol_inacc, abstol/reltol_inacc
# the f32carry phase: at K4 blocks the reference's own f32 block path
# exits REF4_F32_STATUS (tests/test_torch_f32carry.py REF4_F32); config 5's
# rounds; the probe_fwd shapes held bit for bit ((n, k), P5's first)
REF4_F32_STATUS, ROUNDS5_F32 = "NUMERICAL_ERROR", 2
FWD_SHAPES = ((128, 1), (128, 4), (100, 1), (100, 4), (33, 1), (33, 4))
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


def nvidia_smi():
    """The card's "name, power.limit" as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def sm_clock():
    """The card's SM clock now, in MHz, as nvidia-smi reads it (its text
    where that is not a number)."""
    text = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    try:
        return float(text)
    except ValueError:
        return text


def phase_device():
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
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
    at config 3's, config 4's and config 5's shapes and across the
    micro-tile, panel and schedule edges (F64_BATCHED), k = 1 and 3 (and
    P4 at config 4's blocks); the non-PD check; timings at config 3's
    shape, at config 4's (B = 10,240, n = 10; the pair solve at k = 8 and
    1) and at config 5's (B = 2048 and 65,536, n = 21, k = 1)."""
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
    shapes = {"config4": {
        "chol_batched": {at: t4["chol_batched"]},
        "tri_pair_batched": {f"{at},k={P4}": t4["tri_pair_batched"],
                             f"{at},k=1": t4["tri_pair_batched k=1"]}},
        "config5": {"chol_batched": {}, "tri_pair_batched": {}}}
    # config 5's H (n = 21) in a chunk of 2048 and in one batch of 65,536
    for B in (CHUNK5, S5):
        t5 = batched_timing(torch.float64, rng, B, N5 + 1)
        at = f"B={B},n={N5 + 1}"
        shapes["config5"]["chol_batched"][at] = t5["chol_batched"]
        shapes["config5"]["tri_pair_batched"][f"{at},k=1"] = t5["tri_pair_batched"]
    emit({"phase": "kernels", "batched": [list(x) for x in F64_BATCHED],
          "ks": [1, 3], "block_ks": [1, 3, P4], "bit_equal": True,
          "max_abs_err": {k: max(v) for k, v in results.items()},
          "timing_shape": {"B": B_MAIN, "n": nv, "k": 1},
          **{k: {kk: vv for kk, vv in v.items() if kk != "bound"}
             for k, v in timing.items()},
          **{cfg: {name: {a: {kk: vv for kk, vv in t.items() if kk != "bound"}
                          for a, t in by.items()}
                   for name, by in per.items()}
             for cfg, per in shapes.items()}})
    by_shape = {name: {a: t for per in shapes.values() for a, t in per[name].items()}
                for name in ("chol_batched", "tri_pair_batched")}
    return results, timing, by_shape


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
    for key, cat in (("nccl", "nccl"),      # ncclDevKernel_AllReduce_...
                     ("chol_batched_kernel", "chol_batched"),
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


@contextlib.contextmanager
def admm_rounds():
    """Within it, each ADMM round appends (host clock, launch counts) to
    the list it yields, at the round's one device read
    (parallel.admm._fetch, which waits for the round's work)."""
    from socp_tpu_torch.parallel import admm

    fetch, marks = admm._fetch, []

    def marked(*args):
        out = fetch(*args)
        marks.append((time.perf_counter(), read_counts()))
        return out

    admm._fetch = marked
    try:
        yield marks
    finally:
        admm._fetch = fetch


def run_admm(data, cfg, chunk, rounds, device="cuda", tol=1e-5, dtype=None):
    """admm_consensus on scenario_portfolio's output, as bench_all calls it
    (rho = 1)."""
    from socp_tpu_torch.parallel.admm import admm_consensus

    c, G, h, dims, A, b, info = data
    return admm_consensus(c, G, h, dims, info["n"], A=A, b=b, rho=1.0,
                          outer_iters=rounds, tol=tol, config=cfg,
                          scenario_chunk=chunk, device=device, dtype=dtype)


def timed_admm(label, data, cfg, chunk, rounds):
    """bench_all's config-5 measurement on the card: two warm-up rounds (a
    call of their own), then `rounds` timed rounds from a fresh start.
    Held: every inner solve OPTIMAL, the rounds run, only chol_batched and
    tri_pair_batched launched, in the ratios of a p = 1 inner solve (each
    lockstep iteration 2 + 10, each cold start 2 + 13 more: the chunks of
    round 1).  Returns (result, launches, wall s of the timed call)."""
    S = data[0].shape[0]
    n_ch = S // chunk if chunk and chunk < S else 1
    run_admm(data, cfg, chunk, 2)                    # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()             # earlier phases' tensors
    reset_counts()
    with admm_rounds() as marks:
        t0 = time.perf_counter()
        res = run_admm(data, cfg, chunk, rounds)
        wall = time.perf_counter() - t0
    launches = read_counts()
    peak_gb = (torch.cuda.max_memory_allocated() - held) / 1e9
    check(res.inner_status_ok, f"admm {label}: an inner solve was not OPTIMAL")
    check(res.outer_iterations == rounds == len(marks),
          f"admm {label}: {res.outer_iterations} rounds, {len(marks)} reads")
    none_of(launches, ("chol_single", "tri_pair_single") + F32_KERNELS,
            f"admm {label}")
    per_round, prev_t, prev = [], t0, {k: 0 for k in launches}
    for r, (t, counts) in enumerate(marks):
        chol_r = counts["chol_batched"] - prev["chol_batched"]
        tri_r = counts["tri_pair_batched"] - prev["tri_pair_batched"]
        cold = n_ch if r == 0 else 0
        check(chol_r > 2 * cold and tri_r - 13 * cold == 5 * (chol_r - 2 * cold),
              f"admm {label} round {r}: {chol_r} chol_batched, {tri_r} "
              "tri_pair_batched")
        per_round.append({"s": t - prev_t, "chol_batched": chol_r,
                          "tri_pair_batched": tri_r,
                          # lockstep iterations of the round, over its chunks
                          "lockstep_iterations": (chol_r - 2 * cold) // 2})
        prev_t, prev = t, counts
    print(f"chip_smoke: config 5 ({label}): {wall / rounds!r} s a round, "
          f"{rounds} rounds, pres {res.primal_res!r}, dres {res.dual_res!r}, "
          f"rho {res.rho!r}, inner_status_ok {res.inner_status_ok}, objective "
          f"{res.objective!r}, peak {peak_gb!r} GB", flush=True)
    emit({"phase": "admm", "run": label, "S": S, "scenario_chunk": chunk,
          "chunks": n_ch, "native_dd": cfg.native_dd, "rounds": rounds,
          "s_per_round": wall / rounds, "wall_s": wall,
          "pres": res.primal_res, "dres": res.dual_res, "rho": res.rho,
          "inner_status_ok": res.inner_status_ok, "objective": res.objective,
          "launches": launches,
          "launches_per_round": {k: launches[k] / rounds
                                 for k in ("chol_batched", "tri_pair_batched")},
          "per_round": per_round, "peak_device_gb_of_the_solve": peak_gb})
    return res, launches, wall


def phase_admm():
    """BASELINE config 5 through parallel.admm.admm_consensus on the card
    (module doc, phase 7d).  Returns the launches of runs (a), (b) and (c)
    and, for the profiles, {label: (a call, its unprofiled wall s)}: one
    round of (b) ("config5": data placement and a cold round) and (b)'s
    timed call (two calls back, "config5_rounds": the 10 rounds)."""
    from socp_tpu_torch import SolverConfig, Status, solve
    from socp_tpu_torch.cones.layout import make_layout
    from socp_tpu_torch.models.stochastic import extensive_form, scenario_portfolio

    cfg = SolverConfig(factor_dtype="dd32")
    t0 = time.perf_counter()
    data = scenario_portfolio(SEED, n=N5, n_scenarios=S5)
    setup_s = time.perf_counter() - t0
    c, G, h, dims = data[:4]
    m_pad = make_layout(dims).m_pad
    check(c.shape == (S5, N5 + 1) and G.shape == (S5, 47, N5 + 1) and m_pad == 54,
          f"config 5 shape: c {c.shape}, G {G.shape}, m_pad {m_pad}")

    res_a, launches_a, _ = timed_admm("a_chunked", data, cfg, CHUNK5, ROUNDS5)
    res_b, launches_b, wall_b = timed_admm("b_one_batch", data, cfg, None,
                                           ROUNDS5)
    res_c, launches_c, _ = timed_admm(
        "c_native_dd", data, SolverConfig(factor_dtype="dd32", native_dd=True),
        None, ROUNDS5)
    ab = float(np.abs(res_a.w_bar - res_b.w_bar).max())
    ab_bits = bool(np.array_equal(res_a.w_bar, res_b.w_bar))
    bc = float(np.abs(res_c.w_bar - res_b.w_bar).max())
    print(f"chip_smoke: config 5 w_bar, chunked against one batch: max abs "
          f"{ab!r}, bit-equal {ab_bits}; native_dd against default: max abs "
          f"{bc!r}", flush=True)
    check(ab <= 1e-9, f"admm: chunked and unchunked w_bar differ by {ab}")
    check(bc <= 1e-7, f"admm: native_dd and default w_bar differ by {bc}")

    # bench_all's small scale: the card against the port's CPU path, the
    # CPU path against the reference's numbers
    small = scenario_portfolio(SEED, n=N5, n_scenarios=S5_SMALL)
    chunk = min(S5_SMALL, CHUNK5)
    card = run_admm(small, cfg, chunk, 10)
    t0 = time.perf_counter()
    cpu = run_admm(small, cfg, chunk, 10, device="cpu")
    cpu_s = time.perf_counter() - t0
    w_err = float(np.abs(card.w_bar - cpu.w_bar).max())
    rel = {k: abs(getattr(card, k) - getattr(cpu, k)) / abs(getattr(cpu, k))
           for k in ("primal_res", "dual_res")}
    check(card.inner_status_ok and cpu.inner_status_ok
          and (card.outer_iterations, card.rho) == (cpu.outer_iterations, cpu.rho)
          and w_err <= 1e-8 and max(rel.values()) <= 1e-6,
          f"admm S={S5_SMALL}: card {card} against CPU {cpu}")
    ref_err = {"pres_rel": abs(cpu.primal_res - REF5["pres"]) / REF5["pres"],
               "dres_rel": abs(cpu.dual_res - REF5["dres"]) / REF5["dres"],
               "objective_abs": abs(cpu.objective - REF5["objective"])}
    check(cpu.outer_iterations == REF5["rounds"] and cpu.rho == REF5["rho"]
          and ref_err["pres_rel"] <= 1e-6 and ref_err["dres_rel"] <= 1e-6
          and ref_err["objective_abs"] <= 1e-7,
          f"admm S={S5_SMALL}: CPU {cpu} against the reference {REF5}")

    # to tol 1e-6: tests/test_admm.py:12-30's checks at this scale
    t0 = time.perf_counter()
    conv = run_admm(small, cfg, None, 200, tol=1e-6)
    conv_s = time.perf_counter() - t0
    ext = solve(extensive_form(*small), config=cfg, device="cuda")
    gap = abs(conv.objective - ext.pcost)
    w = conv.w_bar
    print(f"chip_smoke: config 5 at S={S5_SMALL} to tol 1e-6: "
          f"{conv.outer_iterations} rounds, objective {conv.objective!r}; the "
          f"extensive form's pcost {ext.pcost!r} in {ext.iterations} "
          f"iterations: gap {gap!r}", flush=True)
    check(conv.inner_status_ok and conv.primal_res <= 1e-6
          and conv.dual_res <= 1e-6 and ext.status == Status.OPTIMAL
          and gap <= 5e-4 * max(1.0, abs(ext.pcost))
          and abs(w.sum() - 1.0) <= 1e-6 and w.min() >= -1e-6,
          f"admm S={S5_SMALL} to tol 1e-6: {conv}, extensive form {ext}")
    emit({"phase": "admm", "run": "checks",
          "config": f"scenario_portfolio({SEED}, n={N5}, n_scenarios={S5}), "
                    "factor_dtype='dd32', rho=1.0",
          "nv": N5 + 1, "m_pad": m_pad, "setup_s": setup_s,
          "w_bar_chunked_vs_one_batch": ab, "w_bar_bit_equal": ab_bits,
          "w_bar_native_vs_default": bc,
          "small": {"S": S5_SMALL, "card_vs_cpu_w_bar": w_err,
                    "card_vs_cpu_rel": rel, "cpu_vs_reference": ref_err,
                    "cpu_s": cpu_s, "pres": card.primal_res,
                    "dres": card.dual_res, "objective": card.objective,
                    "w_bar_sum": float(card.w_bar.sum()),
                    "w_bar_min": float(card.w_bar.min())},
          "converged": {"S": S5_SMALL, "rounds": conv.outer_iterations,
                        "wall_s": conv_s, "pres": conv.primal_res,
                        "dres": conv.dual_res, "rho": conv.rho,
                        "objective": conv.objective,
                        "extensive_pcost": ext.pcost,
                        "extensive_iterations": ext.iterations,
                        "objective_gap": gap, "w_bar_sum": float(w.sum()),
                        "w_bar_min": float(w.min())}})

    def one_round():                 # data placement and a cold round of (b)
        return run_admm(data, cfg, None, 1)

    t0 = time.perf_counter()
    one_round()
    one_s = time.perf_counter() - t0
    runs = {"config5": (one_round, one_s),
            "config5_rounds": (lambda: run_admm(data, cfg, None, ROUNDS5), wall_b)}
    return {"a": launches_a, "b": launches_b, "c": launches_c}, runs


def huge_soc(seed, n, l, q):
    """scripts/hugecone_bench.py:58-76 (tests/test_hugecone.py:18-42 is the
    same generator): a box |x_i| <= 2 on the first l/2 coordinates, then
    ||B x - d|| <= a'x + 5, one SOC of dimension q.  Returns (c, G, h, l,
    qs, A, b) with no equalities."""
    rng = np.random.default_rng(seed)
    m = l + q
    G = np.zeros((m, n))
    h = np.zeros(m)
    for i in range(l // 2):
        G[2 * i, i] = 1.0
        G[2 * i + 1, i] = -1.0
        h[2 * i] = h[2 * i + 1] = 2.0
    a = rng.normal(size=n) * 0.1
    G[l + 1:] = rng.normal(size=(q - 1, n)) / -np.sqrt(n)   # -B
    h[l + 1:] = rng.normal(size=q - 1) * -0.1                # -d
    G[l] = -a
    h[l] = 5.0
    return rng.normal(size=n), G, h, l, (q,), None, None


def multi_soc(seed, n, l, qs, p):
    """tests/test_hugecone.py:103-123: an orthant, several SOCs and p
    coupling equalities, strictly feasible and bounded."""
    rng = np.random.default_rng(seed)
    m = l + sum(qs)
    G = rng.normal(size=(m, n)) / np.sqrt(n)
    x_star = rng.normal(size=n)
    s = np.empty(m)
    s[:l] = rng.uniform(0.5, 1.5, l)
    off = l
    for q in qs:
        tail = rng.normal(size=q - 1)
        tail *= 0.3 / np.linalg.norm(tail)
        s[off] = 1.0
        s[off + 1:off + q] = tail
        off += q
    h = G @ x_star + s
    A = rng.normal(size=(p, n))
    b = A @ x_star
    c = -(G.T @ rng.uniform(0.1, 1.0, m) + A.T @ rng.normal(size=p))
    return c, G, h, l, tuple(qs), A, b


@contextlib.contextmanager
def huge_reads():
    """Within it, the huge cone's device reads (parallel.hugecone._fetch,
    one a loop body) are counted in the list it yields."""
    from socp_tpu_torch.parallel import hugecone

    fetch, reads = hugecone._fetch, []

    def counted(flags):
        reads.append(1)
        return fetch(flags)

    hugecone._fetch = counted
    try:
        yield reads
    finally:
        hugecone._fetch = fetch


def huge_solve(data, cfg, reps=3):
    """prepare_huge on "cuda" (its upload timed), one cold solve, then `reps`
    solves that reuse the upload, each timed by the host clock to its status
    scalar on the host, as scripts/hugecone_bench.py:80-96 times them.
    Returns (the last solve's host tuple, times, the launches and device
    reads of the first timed solve, its peak device GB, a call that solves
    again)."""
    from socp_tpu_torch.parallel.hugecone import prepare_huge

    c, G, h, l, qs, A, b = data
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn, args, assemble = prepare_huge(c, G, h, l, qs, A=A, b=b, config=cfg,
                                      device="cuda")
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0

    def run():
        out = fn(*args)
        out[8].item()                        # the status scalar on the host
        return out

    t0 = time.perf_counter()
    run()
    cold_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()     # the upload and earlier phases'
    steady = []
    for r in range(reps):
        reset_counts()
        with huge_reads() as reads:
            t0 = time.perf_counter()
            out = run()
            steady.append(time.perf_counter() - t0)
        if r == 0:
            launches, n_reads = read_counts(), len(reads)
            peak_gb = (torch.cuda.max_memory_allocated() - held) / 1e9
    times = {"upload_s": upload_s, "cold_s": cold_s, "steady_s": steady,
             "solve_s": statistics.median(steady)}
    return assemble(out), times, launches, n_reads, peak_gb, run


def huge_held(label, data, res, status_expected):
    """What a huge-cone run must show, recomputed in numpy from the returned
    x, y, s, z and the data: for OPTIMAL (not inaccurate) pres, dres <=
    1e-8, gap or relgap <= 1e-8, s in the cone (lambda_min >= -1e-9), and
    gap, pres and dres agreeing with the returned stats to 1e-6 relative
    or, at the rounding floor of a residual, 1e-12 absolute; for
    PRIMAL_INFEASIBLE a Farkas certificate, z in the cone with h'z + b'y
    < 0 and ||G'z + A'y|| <= 1e-8 (h'z + b'y).  Returns the numbers."""
    c, G, h, l, qs, A, b = data
    x, y, s, z, status, k, stats = res
    A = np.zeros((0, len(c))) if A is None else A
    b = np.zeros(0) if b is None else b

    def lam_min(u):
        out = u[:l].min() if l else np.inf
        off = l
        for q in qs:
            out = min(out, u[off] - np.linalg.norm(u[off + 1:off + q]))
            off += q
        return float(out)

    from socp_tpu_torch import Status

    check(status == status_expected, f"hugecone {label}: status {status.name} "
          f"where {status_expected.name} was expected; stats {stats}")
    check(np.isfinite(stats).all() and all(np.isfinite(v).all()
                                           for v in (x, y, s, z)),
          f"hugecone {label}: non-finite output")
    out = {}
    if status == Status.OPTIMAL:
        gap = float(s @ z)
        pres = max(np.linalg.norm(A @ x - b) / max(1.0, np.linalg.norm(b)),
                   np.linalg.norm(G @ x + s - h) / max(1.0, np.linalg.norm(h)))
        dres = (np.linalg.norm(G.T @ z + A.T @ y + c)
                / max(1.0, np.linalg.norm(c)))
        out = {"gap": gap, "pres": float(pres), "dres": float(dres),
               "lambda_min_s": lam_min(s)}
        for key, v, ret in (("gap", gap, stats[2]), ("pres", pres, stats[4]),
                            ("dres", dres, stats[5])):
            check(abs(v - ret) <= 1e-6 * abs(ret) + 1e-12,
                  f"hugecone {label}: {key} recomputed {v!r}, returned {ret!r}")
        check(stats[6] == 0.0 and stats[4] <= 1e-8 and stats[5] <= 1e-8
              and (stats[2] <= 1e-8 or stats[3] <= 1e-8) and pres <= 1e-8
              and dres <= 1e-8 and out["lambda_min_s"] >= -1e-9,
              f"hugecone {label}: misses the strict tolerances: {stats}, {out}")
        if not len(b):                       # (a): the box and the SOC row
            viol = max(float(np.abs(x[:l // 2]).max()) - 2.0,
                       float(np.linalg.norm(G[l + 1:] @ x - h[l + 1:])
                             + G[l] @ x - 5.0))
            out["constraint_violation"] = viol
            check(viol <= 1e-7, f"hugecone {label}: constraints off by {viol}")
    else:
        hz = float(h @ z + b @ y)
        ray = float(np.linalg.norm(G.T @ z + A.T @ y))
        out = {"hz_by": hz, "farkas_residual": ray, "ratio": ray / -hz,
               "lambda_min_z": lam_min(z),
               "z_max": float(np.abs(z).max())}
        check(hz < 0 and ray <= 1e-8 * -hz
              and out["lambda_min_z"] >= -1e-9 * out["z_max"],
              f"hugecone {label}: not a primal certificate: {out}")
    return out


def phase_hugecone():
    """The huge-cone IPM (parallel.hugecone) on the card at the reference's
    own scale (module doc, phase 7e).  Returns the launches of each run
    and, for the profile, (a call solving (a) again, its s a solve)."""
    from socp_tpu_torch import SolverConfig, Status
    from socp_tpu_torch.parallel.hugecone import solve_huge

    cases = {
        "a": (lambda q: huge_soc(SEED, N_HUGE, L_HUGE, q), Q_HUGE,
              f"hugecone_bench: huge_soc({SEED}, n={N_HUGE}, l={L_HUGE}, "
              f"q={Q_HUGE})",
              # ||d|| grows as sqrt(q) and a'x + 5 cannot keep up (the
              # fixture is infeasible from q = 4097 on): its certificate
              Status.PRIMAL_INFEASIBLE),
        "b": (lambda q: multi_soc(3, N_HUGE, L_HUGE, (q, q), P_HUGE),
              QS_HUGE[0],
              f"multi_soc(3, n={N_HUGE}, l={L_HUGE}, qs={QS_HUGE}, "
              f"p={P_HUGE})", Status.OPTIMAL),
    }
    launches, rows, profile_run = {}, {}, None
    for name, (make, q, source, expect) in cases.items():
        t0 = time.perf_counter()
        data = make(q)
        setup_s = time.perf_counter() - t0
        G = data[1]
        p = 0 if data[5] is None else len(data[6])
        for g in (0, 1):
            label = name if g == 0 else f"{name}_gondzio"
            res, times, counts, n_reads, peak_gb, run = huge_solve(
                data, SolverConfig(gondzio_correctors=g))
            x, y, s, z, status, k, stats = res
            held = huge_held(label, data, res, expect)
            none_of(counts, [kk for kk in counts
                             if kk not in ("chol_single", "tri_pair_single")],
                    f"hugecone {label}")
            per_chol, per_tri, per_corr = (2, 13, 3) if p else (1, 4, 1)
            check(n_reads == k + 1
                  and counts["chol_single"] == per_chol * (n_reads + 1)
                  and counts["tri_pair_single"]
                  == per_tri * (n_reads + 1) + g * per_corr * n_reads,
                  f"hugecone {label}: {n_reads} device reads, {k} iterations, "
                  f"launches {counts}")
            launches[label] = counts
            print(f"chip_smoke: hugecone {label}: {status.name} in {k} "
                  f"iterations, {times['solve_s']!r} s a solve (cold "
                  f"{times['cold_s']!r}), peak {peak_gb!r} GB, launches "
                  f"chol_single {counts['chol_single']}, tri_pair_single "
                  f"{counts['tri_pair_single']}", flush=True)
            rows[label] = {
                "phase": "hugecone", "run": label, "source": source,
                "gondzio_correctors": g, "m": G.shape[0], "n": G.shape[1],
                "p": p, "G_gb": G.nbytes / 1e9, "setup_s": setup_s,
                "status": status.name.lower(), "iterations": k,
                "pcost": stats[0], "dcost": stats[1], "gap": stats[2],
                "relgap": stats[3], "pres": stats[4], "dres": stats[5],
                "recomputed": held, **times,
                "iterations_per_s": k / times["solve_s"],
                "device_reads": n_reads, "launches": counts,
                "peak_device_gb_of_the_solve": peak_gb}
            if label == "a":
                profile_run = (run, times["solve_s"])
            del run
        del data, G

        # the card against the port's CPU path at q = Q_HUGE_SMALL
        small = make(Q_HUGE_SMALL)
        card = solve_huge(*small, device="cuda")
        t0 = time.perf_counter()
        cpu = solve_huge(*small, device="cpu")
        cpu_s = time.perf_counter() - t0
        rel = abs(card[6][0] - cpu[6][0]) / max(1.0, abs(cpu[6][0]))
        x_err = float(np.abs(card[0] - cpu[0]).max())
        check(card[4] == cpu[4] == expect and card[5] == cpu[5]
              and rel <= 1e-9 and x_err <= 1e-7,
              f"hugecone {name} at q={Q_HUGE_SMALL}: card {card[4].name} in "
              f"{card[5]}, pcost {card[6][0]!r}; CPU {cpu[4].name} in "
              f"{cpu[5]}, pcost {cpu[6][0]!r}; x within {x_err}")
        rows[name]["cpu_recheck"] = {
            "q": Q_HUGE_SMALL, "status": cpu[4].name.lower(),
            "iterations": cpu[5], "card_iterations": card[5],
            "pcost_rel": rel, "x_max_abs": x_err, "cpu_s": cpu_s}
    for row in rows.values():
        emit(row)
    return launches, profile_run


# ---- multidevice: the sharded entry points over torch.distributed ----------

def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def md_cases(small):
    """The multidevice phase's runs: name -> (make the data, solve it with
    `mesh` (None: the one-device path), the mesh for a world of n).  Config
    3 through parallel.batch.solve_batch_sharded, config 4 through
    solve_block, config 5 through admm_consensus (one batch, MD_ROUNDS5
    rounds, bench_all's dd32 config) and the huge cone (b) through
    solve_huge.  `small`: configs 3 and 5 at run (b)'s depth (B3_TWO
    instances, S5_TWO scenarios)."""
    from socp_tpu_torch import SolverConfig
    from socp_tpu_torch.models.robust_ls import robust_ls_batch
    from socp_tpu_torch.models.stochastic import scenario_portfolio
    from socp_tpu_torch.parallel.admm import admm_consensus
    from socp_tpu_torch.parallel.batch import solve_batch_sharded
    from socp_tpu_torch.parallel.hugecone import solve_huge
    from socp_tpu_torch.parallel.mesh import batch_mesh, block_mesh
    from socp_tpu_torch.parallel.runtime import pod_mesh
    from socp_tpu_torch.parallel.schur import random_block_problem, solve_block
    from socp_tpu_torch.problem import ConeDims

    dd32 = SolverConfig(factor_dtype="dd32")
    B3 = B3_TWO if small else B_MAIN
    S5_ = S5_TWO if small else S5

    def config5(data, mesh):
        c, G, h, dims, A, b, info = data
        return admm_consensus(c, G, h, dims, info["n"], A=A, b=b, rho=1.0,
                              outer_iters=MD_ROUNDS5, tol=0.0, config=dd32,
                              device="cuda", mesh=mesh)

    return {
        "config3": (lambda: robust_ls_batch(SEED, batch=B3, n=N_MAIN),
                    lambda d, mesh: solve_batch_sharded(*d, mesh=mesh,
                                                        device="cuda"),
                    batch_mesh),
        "config4": (lambda: random_block_problem(
                        SEED, K=K4, nb=NB4, p=P4,
                        block_dims=ConeDims(l=4, qs=(6,)))[0],
                    lambda prob, mesh: solve_block(prob, config=dd32,
                                                   device="cuda", mesh=mesh),
                    block_mesh),
        "config5": (lambda: scenario_portfolio(SEED, n=N5, n_scenarios=S5_),
                    config5,
                    # two ranks: the 2-D pod mesh, a scenario row each
                    lambda n: batch_mesh(n) if n == 1
                    else pod_mesh(scenario_size=n)),
        "hugecone_b": (lambda: multi_soc(3, N_HUGE, L_HUGE, QS_HUGE, P_HUGE),
                       lambda d, mesh: solve_huge(*d, device="cuda",
                                                  mesh=mesh),
                       block_mesh),
    }


def md_outputs(res):
    """A run's outputs as a flat list, for the bitwise comparisons."""
    if hasattr(res, "w_bar"):                        # an ADMMResult
        return [res.w_bar, res.x, res.objective, res.primal_res,
                res.dual_res, res.outer_iterations, res.inner_status_ok,
                res.rho]
    return [np.asarray(v) for v in res]


def md_equal(a, b):
    return len(a) == len(b) and all(np.array_equal(u, v)
                                    for u, v in zip(a, b))


def md_held(name, res, ref):
    """Run (b) against the one-device run: the same status and iterations
    (rounds, rho and the inner status for ADMM), pcost (the objective)
    within 1e-9 relative, x (and w_bar, y, z) within 1e-7.  Config 4's x
    is reported, not held: its solve does not fix it to 1e-7, since some
    blocks' G_i are near singular (sigma_min down to 1.4e-6 at K = 10,240)
    and x_i = G_i^-1 (h_i - s_i) carries s's last digits (one rank against
    two on the CPU: x 0.038 apart, s 3.6e-5, z 3.6e-12, y 2.2e-16, pcost
    5e-14).  Returns the gaps."""
    def gap(a, b):
        a, b = np.asarray(a), np.asarray(b)
        return float(np.abs(a - b).max()) if a.size else 0.0

    if hasattr(res, "w_bar"):
        check((res.outer_iterations, res.rho, res.inner_status_ok)
              == (ref.outer_iterations, ref.rho, ref.inner_status_ok)
              and res.inner_status_ok,
              f"multidevice {name}: rounds, rho or inner status differ")
        gaps = {"objective_rel": abs(res.objective - ref.objective)
                / max(1.0, abs(ref.objective)),
                "x_max_abs": gap(res.x, ref.x),
                "w_bar_max_abs": gap(res.w_bar, ref.w_bar)}
    else:
        x, status, k, stats = res[0], res[4], res[5], np.asarray(res[6])
        rstats = np.asarray(ref[6])
        check(np.array_equal(status, ref[4]) and np.array_equal(k, ref[5]),
              f"multidevice {name}: status or iterations differ")
        pc = np.abs(stats[..., 0] - rstats[..., 0]) / np.maximum(
            1.0, np.abs(rstats[..., 0]))
        gaps = {"pcost_rel": float(np.max(pc)), "x_max_abs": gap(x, ref[0]),
                "y_max_abs": gap(res[1], ref[1]),
                "s_max_abs": gap(res[2], ref[2]),
                "z_max_abs": gap(res[3], ref[3])}
    held = {key: v for key, v in gaps.items()
            if not (name == "config4" and key in ("x_max_abs", "s_max_abs"))
            and key != "s_max_abs"}
    check(max(v for key, v in held.items() if key.endswith("_rel")) <= 1e-9
          and max(v for key, v in held.items() if key.endswith("_abs")) <= 1e-7,
          f"multidevice {name}: two ranks against one: {gaps}")
    return gaps


def md_rank(rank, world, port, outdir):
    """Run (b)'s rank: a gloo group on the card (NCCL refuses two ranks of
    one communicator on one GPU), each sharded run with its collectives,
    launches and seconds; the results pickled to outdir (or the
    traceback, and exit code 1)."""
    import datetime
    import os
    import pickle
    import traceback

    import torch.distributed as dist

    from socp_tpu_torch.parallel import collectives as coll
    from socp_tpu_torch.parallel.runtime import init_distributed

    try:
        init_distributed(rank, world, f"tcp://127.0.0.1:{port}",
                         device="cuda:0", backend="gloo",
                         timeout=datetime.timedelta(seconds=MD_TIMEOUT_S))
        out = {"backend": dist.get_backend()}
        for name, (make, solve, mesh_of) in md_cases(small=True).items():
            data = make()
            mesh = mesh_of(world)
            torch.cuda.synchronize()
            coll.reset_counts()
            reset_counts()
            t0 = time.perf_counter()
            res = solve(data, mesh)
            out[name] = {"res": res, "s": time.perf_counter() - t0,
                         "collectives": coll.counts(),
                         "launches": read_counts()}
            del data
        value = (True, out)
    except Exception:
        value = (False, traceback.format_exc())
    with open(os.path.join(outdir, f"rank{rank}.tmp"), "wb") as f:
        pickle.dump(value, f)
    os.replace(os.path.join(outdir, f"rank{rank}.tmp"),
               os.path.join(outdir, f"rank{rank}.pkl"))
    if value[0]:
        dist.destroy_process_group()
    sys.exit(0 if value[0] else 1)


def md_two_ranks():
    """Run (b): two spawned ranks on the one card; every rank killed at the
    first failure or at the deadline.  Returns each rank's results."""
    import multiprocessing
    import os
    import pickle
    import tempfile

    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    with tempfile.TemporaryDirectory() as d:
        procs = [ctx.Process(target=md_rank, args=(r, 2, port, d))
                 for r in range(2)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + MD_TIMEOUT_S
        try:
            while any(p.exitcode is None for p in procs):
                if (any(p.exitcode not in (None, 0) for p in procs)
                        or time.monotonic() > deadline):
                    break
                time.sleep(0.1)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join(30)
        ranks = []
        for r, p in enumerate(procs):
            path = os.path.join(d, f"rank{r}.pkl")
            check(os.path.exists(path),
                  f"multidevice (b): rank {r} ended with exit code "
                  f"{p.exitcode} and no result (deadline {MD_TIMEOUT_S} s)")
            with open(path, "rb") as f:          # written by md_rank
                ok, value = pickle.load(f)
            check(ok, f"multidevice (b): rank {r} failed:\n{value}")
            ranks.append(value)
    return ranks


def phase_multidevice():
    """The sharded entry points over torch.distributed (module doc, phase
    7f).  (a) a world of one rank on NCCL at the full contracts, each run
    bit-equal to mesh=None, with its collectives counted (every one a NCCL
    call) and a profile of config 4's; (b) two ranks on the one card over
    gloo, against the one-device runs, the ranks bit-identical.  Returns
    the launches of each run, (a)'s and rank 0's of (b)."""
    import torch.distributed as dist

    from socp_tpu_torch.parallel import collectives as coll
    from socp_tpu_torch.parallel.runtime import init_distributed

    t_phase = time.perf_counter()
    init_distributed(0, 1, f"tcp://127.0.0.1:{free_port()}", device="cuda:0")
    check(dist.get_backend() == "nccl",
          f"multidevice (a): backend {dist.get_backend()}")
    launches, alone_small, rows = {}, {}, []
    profile_run = None
    for name, (make, solve, mesh_of) in md_cases(small=False).items():
        t0 = time.perf_counter()
        data = make()
        setup_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        alone = solve(data, None)
        alone_s = time.perf_counter() - t0
        mesh = mesh_of(1)
        torch.cuda.synchronize()
        coll.reset_counts()
        reset_counts()
        t0 = time.perf_counter()
        meshed = solve(data, mesh)
        meshed_s = time.perf_counter() - t0
        counts, kernels = coll.counts(), read_counts()
        check(md_equal(md_outputs(alone), md_outputs(meshed)),
              f"multidevice (a) {name}: mesh of one rank not bit-equal to "
              "mesh=None")
        check(sum(counts.values()) > 0 and counts["staged"] == 0,
              f"multidevice (a) {name}: collectives {counts}")
        path = ("chol_single", "tri_pair_single") if name == "hugecone_b" \
            else ("chol_batched", "tri_pair_batched")
        check(all(kernels[k] > 0 for k in path),
              f"multidevice (a) {name}: launches {kernels}")
        launches[f"multidevice_{name}"] = kernels
        smi = nvidia_smi()
        print(f"chip_smoke: multidevice (a) {name}: one NCCL rank bit-equal "
              f"to mesh=None; {meshed_s!r} s meshed, {alone_s!r} s alone "
              f"[{smi}]; collectives {counts}", flush=True)
        rows.append({"phase": "multidevice", "run": "a", "case": name,
                     "world_size": 1, "backend": "nccl", "bit_equal": True,
                     "setup_s": setup_s, "meshed_s": meshed_s,
                     "alone_s": alone_s, "nvidia_smi": smi,
                     "collectives": counts, "launches": kernels})
        if name == "config4":
            profile_run = (lambda d=data, m=mesh, f=solve: f(d, m), meshed_s)
        del data, alone, meshed
    # (b)'s one-device references at its depth: configs 3 and 5 smaller
    for name, (make, solve, _) in md_cases(small=True).items():
        if name in ("config3", "config5"):
            alone_small[name] = solve(make(), None)
    phase_profile(profile_run[0], profile_run[1], "config4_mesh1")
    del profile_run
    dist.destroy_process_group()

    # (b): two ranks on the one card, against the one-device runs
    t0 = time.perf_counter()
    ranks = md_two_ranks()
    two_s = time.perf_counter() - t0
    check(all(r["backend"] == "gloo" for r in ranks),
          f"multidevice (b): backends {[r['backend'] for r in ranks]}")
    full = md_cases(small=False)
    for name in full:
        res0 = ranks[0][name]["res"]
        check(md_equal(md_outputs(res0), md_outputs(ranks[1][name]["res"])),
              f"multidevice (b) {name}: the two ranks' results differ")
        if name in alone_small:
            ref = alone_small[name]
        else:
            make, solve, _ = full[name]
            ref = solve(make(), None)
        gaps = md_held(name, res0, ref)
        counts = ranks[0][name]["collectives"]
        check(counts["staged"] > 0,
              f"multidevice (b) {name}: collectives {counts}")
        launches[f"multidevice_2ranks_{name}"] = ranks[0][name]["launches"]
        smi = nvidia_smi()
        print(f"chip_smoke: multidevice (b) {name}: 2 ranks on gloo, "
              f"{ranks[0][name]['s']!r} / {ranks[1][name]['s']!r} s "
              f"[{smi}]; against one device {gaps}; collectives {counts}",
              flush=True)
        rows.append({"phase": "multidevice", "run": "b", "case": name,
                     "world_size": 2, "backend": "gloo",
                     "depth": ({"B": B3_TWO} if name == "config3" else
                               {"S": S5_TWO} if name == "config5" else "full"),
                     "ranks_bit_identical": True, "against_one_device": gaps,
                     "s_by_rank": [r[name]["s"] for r in ranks],
                     "nvidia_smi": smi, "collectives": counts,
                     "launches": ranks[0][name]["launches"]})
    for row in rows:
        emit(row)
    emit({"phase": "multidevice", "two_ranks_s": two_s,
          "phase_s": time.perf_counter() - t_phase})
    return launches


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


def f32_gates(label, x, s, z, stats, c, G, h):
    """PERF.md section 2's f32-mode gates on every instance of a batch
    without equalities, its residuals recomputed in numpy f64 from the
    returned (unpadded) iterates and the f64 data: pres and dres <= 1e-4,
    gap or relgap <= 5e-5.  Returns the worst of each."""
    rz = np.einsum("bmn,bn->bm", G, x) + s - h
    rx = np.einsum("bmn,bm->bn", G, z) + c
    pres = np.linalg.norm(rz, axis=1) / np.maximum(1.0, np.linalg.norm(h, axis=1))
    dres = np.linalg.norm(rx, axis=1) / np.maximum(1.0, np.linalg.norm(c, axis=1))
    gap = np.sum(s * z, axis=1)
    pcost = np.sum(c * x, axis=1)
    dcost = pcost + np.sum(z * rz, axis=1) - gap
    with np.errstate(divide="ignore", invalid="ignore"):
        relgap = np.where(pcost < 0, gap / -pcost,
                          np.where(dcost > 0, gap / dcost, np.inf))
    ok = ((pres <= RELAXED_FEAS) & (dres <= RELAXED_FEAS)
          & ((gap <= RELAXED_GAP) | (relgap <= RELAXED_GAP)))
    check(bool(ok.all()), f"f32carry {label}: {int((~ok).sum())} instances "
                          "miss the f32-mode gates (numpy f64 residuals)")
    check(bool(np.allclose(stats[:, 0], pcost, rtol=1e-5, atol=1e-6)),
          f"f32carry {label}: pcost in stats against c'x")
    return {"max_pres": float(pres.max()), "max_dres": float(dres.max()),
            "max_gap": float(gap.max()), "max_relgap": float(relgap.max())}


def phase_f32carry():
    """The reference's f32-carries mode (dtype=torch.float32; module doc,
    phase 10b), each run with the counts set to 0 just before it; TF32 is
    asserted off before and after.  Returns the launches by run and, for
    the profile, config 3's f32-carry solve."""
    from socp_tpu_torch import SolverConfig, Status, prepare_batch, solve
    from socp_tpu_torch.models.portfolio import portfolio, portfolio_risk
    from socp_tpu_torch.models.robust_ls import robust_ls_batch
    from socp_tpu_torch.models.stochastic import scenario_portfolio
    from socp_tpu_torch.parallel.schur import random_block_problem, solve_block
    from socp_tpu_torch.problem import ConeDims

    tf32 = tf32_off()
    f32 = torch.float32
    launches, profile = {}, None

    # (a) config 3: the f64 default, the f32-factor mode, then f32 carries
    # without and with refine_in_f64, one after another in this call
    c, G, h, dims = robust_ls_batch(SEED, batch=B_MAIN, n=N_MAIN)
    kk = dims.qs[0] - 1                              # closed form, as phase_main
    D = -G[:, 1:kk + 1, :N_MAIN]
    d = -h[:, 1:kk + 1]
    c3 = {}
    for label, cfg, dtype in (
            ("c3_f64", SolverConfig(), None),
            ("c3_f32factor", SolverConfig(factor_dtype="float32"), None),
            ("c3", SolverConfig(), f32),
            ("c3_refine_in_f64", SolverConfig(refine_in_f64=True), f32)):
        fn, args, layout = prepare_batch(c, G, h, dims, config=cfg,
                                         dtype=dtype, device="cuda")
        fn(*args)[4].cpu()                           # warm-up
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        out = fn(*args)
        status = out[4].cpu().numpy()                # syncs on the result
        solve_s = time.perf_counter() - t0
        counts = read_counts()
        carry = {str(t.dtype) for t in (*out[:4], out[6])}
        x, s3, z3, stats = (t.double().cpu().numpy() for t in
                            (out[0], out[2], out[3], out[6]))
        s3, z3 = layout.unpad_vec(s3), layout.unpad_vec(z3)
        k = out[5].cpu().numpy()
        xs = x[:, :N_MAIN]
        obj = (np.linalg.norm(np.einsum("bkn,bn->bk", D, xs) - d, axis=1)
               + 0.1 * np.linalg.norm(xs, axis=1))
        rel = np.abs(stats[:, 0] - obj) / np.maximum(1.0, np.abs(obj))
        kernels = (("chol_batched", "tri_pair_batched") if label == "c3_f64"
                   else ("chol_batched_f32", "tri_pair_batched_f32"))
        n_iter = counts[kernels[0]] - 1              # init 1 + 4, then 1 + 3
        check(n_iter >= 1 and counts[kernels[1]] == 4 + 3 * n_iter
              and sum(counts.values()) == sum(counts[n] for n in kernels),
              f"f32carry {label}: launches {counts}")
        n_opt = int(np.sum(status == int(Status.OPTIMAL)))
        check(n_opt == B_MAIN, f"f32carry {label}: {n_opt}/{B_MAIN} OPTIMAL")
        row = {"dtype": "float32" if dtype is f32 else "float64",
               "carries": sorted(carry), "config": repr(cfg),
               "optimal": n_opt, "inaccurate": int(stats[:, 6].sum()),
               "solve_s": solve_s, "solves_per_s": B_MAIN / solve_s,
               "lockstep_iterations": n_iter,
               "lockstep_iteration_ms": solve_s / n_iter * 1e3,
               "iters_max": int(k.max()), "iters_mean": float(k.mean()),
               "max_pcost_rel_closed_form": float(rel.max()),
               "launches": {n: counts[n] for n in kernels}}
        if dtype is f32:
            check(carry == {"torch.float32"}, f"f32carry {label}: carries {carry}")
            check(bool((rel <= RELAXED_GAP).all()),
                  f"f32carry {label}: pcost vs closed form, max rel {rel.max()}")
            row["gates"] = f32_gates(label, x, s3, z3, stats, c, G, h)
        c3[label] = row
        launches[label] = counts
        if label == "c3":
            profile = (lambda fn=fn, args=args: fn(*args)[4].cpu(), solve_s)
        del fn, args, out
    emit({"phase": "f32carry", "run": "config3",
          "config": f"robust_ls_batch({SEED}, batch={B_MAIN}, n={N_MAIN})",
          "tf32": tf32, "runs": c3})

    # (b) config 2 through solve: the single f32 kernels
    prob, info = portfolio(SEED, n=500, k=20)
    f64 = solve(prob, device="cuda")
    solve(prob, dtype=f32, device="cuda")            # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    sol = solve(prob, dtype=f32, device="cuda")
    times = [time.perf_counter() - t0]
    counts = read_counts()
    for _ in range(2):
        t0 = time.perf_counter()
        solve(prob, dtype=f32, device="cuda")
        times.append(time.perf_counter() - t0)
    n_iter = counts["chol_single_f32"] // 2 - 1      # p = 1: 2 + 13, then 2 + 10
    check(n_iter >= 1 and counts["chol_single_f32"] == 2 + 2 * n_iter
          and counts["tri_pair_single_f32"] == 13 + 10 * n_iter
          and sum(counts.values()) == counts["chol_single_f32"]
          + counts["tri_pair_single_f32"],
          f"f32carry config 2: launches {counts}")
    st = np.array([[sol.pcost, sol.dcost, sol.gap, sol.relgap, sol.pres, sol.dres]])
    w = sol.x
    model = {"risk": portfolio_risk(info, w), "sigma_max": info["sigma_max"],
             "budget_err": abs(float(np.sum(w)) - 1.0), "w_min": float(w.min())}
    rel2 = abs(sol.pcost - f64.pcost) / max(1.0, abs(f64.pcost))
    check(sol.status == Status.OPTIMAL and bool(relaxed_ok(st).all())
          and model["risk"] <= info["sigma_max"] * (1 + RELAXED_FEAS)
          and model["budget_err"] <= RELAXED_FEAS
          and model["w_min"] >= -RELAXED_FEAS and rel2 <= RELAXED_GAP,
          f"f32carry config 2: {sol}, {model}, pcost vs f64 {rel2}")
    launches["c2"] = counts
    emit({"phase": "f32carry", "run": "config2",
          "config": f"portfolio({SEED}, n=500, k=20)",
          "status": sol.status_name, "inaccurate": sol.inaccurate,
          "iterations": sol.iterations, "f64_iterations": f64.iterations,
          "loop_iterations": n_iter, "solve_ms": statistics.median(times) * 1e3,
          "solve_ms_reps": [t * 1e3 for t in times], "pcost": sol.pcost,
          "pcost_rel_f64": rel2, "gap": sol.gap, "relgap": sol.relgap,
          "pres": sol.pres, "dres": sol.dres, "launches": counts, **model})

    # (c) config 4, against the f64 solve
    for K in (K4,):
        bprob, pstar = random_block_problem(SEED, K=K, nb=NB4, p=P4,
                                            block_dims=ConeDims(l=4, qs=(6,)))
        t0 = time.perf_counter()
        b64 = solve_block(bprob, device="cuda")
        s64 = time.perf_counter() - t0
        solve_block(bprob, dtype=f32, device="cuda")     # warm-up
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        x4, y4, s4, z4, status, k, stats = solve_block(bprob, dtype=f32,
                                                       device="cuda")
        s32 = time.perf_counter() - t0
        counts = read_counts()
        factors = counts["chol_batched_f32"]
        check(factors == k + 2 and counts["chol_single_f32"] == factors
              and counts["tri_pair_batched_f32"] == 9 * factors
              and counts["tri_pair_single_f32"] == 4 * factors
              and sum(counts.values()) == 15 * factors,
              f"f32carry config 4 K={K}: launches {counts} for {k} iterations")
        check(all(np.isfinite(a).all() for a in (x4, y4, s4, z4)),
              f"f32carry config 4 K={K}: outputs not finite")
        rel4 = abs(stats[0] - b64[6][0]) / max(1.0, abs(b64[6][0]))
        if status == Status.OPTIMAL:
            check(bool(relaxed_ok(stats[None]).all()) and rel4 <= RELAXED_GAP,
                  f"f32carry config 4 K={K}: {stats}, pcost vs f64 {rel4}")
        else:
            # f32 carries cannot certify 102,400 variables: the reference's
            # f32 block path ends so at this K too
            check(status.name == REF4_F32_STATUS,
                  f"f32carry config 4 K={K}: {status.name} in {k}, {stats}")
        launches[f"c4_K{K}"] = counts
        emit({"phase": "f32carry", "run": f"config4_K{K}",
              "config": f"random_block_problem({SEED}, K={K}, nb={NB4}, "
                        f"p={P4}, block_dims=ConeDims(l=4, qs=(6,)))",
              "status": status.name.lower(), "iterations": k,
              "f64_status": b64[4].name.lower(), "f64_iterations": b64[5],
              "iteration_difference": k - b64[5], "solve_s": s32,
              "f64_solve_s": s64, "pcost": stats[0], "f64_pcost": b64[6][0],
              "pcost_rel_f64": rel4, "gap": stats[2], "relgap": stats[3],
              "pres": stats[4], "dres": stats[5], "inaccurate": stats[6],
              "launches": counts})

    # (d) config 5 as one batch, ROUNDS5_F32 rounds, against f64
    data = scenario_portfolio(SEED, n=N5, n_scenarios=S5)
    cfg = SolverConfig()
    t0 = time.perf_counter()
    r64 = run_admm(data, cfg, None, ROUNDS5_F32)
    s64 = time.perf_counter() - t0
    run_admm(data, cfg, None, 1, dtype=f32)          # warm-up
    torch.cuda.synchronize()
    reset_counts()
    with admm_rounds() as marks:
        t0 = time.perf_counter()
        r32 = run_admm(data, cfg, None, ROUNDS5_F32, dtype=f32)
        wall = time.perf_counter() - t0
    counts = read_counts()
    rel5 = abs(r32.objective - r64.objective) / max(1.0, abs(r64.objective))
    check(r32.inner_status_ok and r64.inner_status_ok
          and r32.outer_iterations == len(marks) == ROUNDS5_F32
          and rel5 <= RELAXED_GAP
          and sum(counts.values()) == counts["chol_batched_f32"]
          + counts["tri_pair_batched_f32"],
          f"f32carry config 5: {r32} against f64 {r64}, launches {counts}")
    per_round, prev = [], {n: 0 for n in counts}
    for r, (_, cnt) in enumerate(marks):
        chol_r = cnt["chol_batched_f32"] - prev["chol_batched_f32"]
        per_round.append((chol_r - (2 if r == 0 else 0)) // 2)
        prev = cnt
    launches["c5"] = counts
    emit({"phase": "f32carry", "run": "config5",
          "config": f"scenario_portfolio({SEED}, n={N5}, n_scenarios={S5}), "
                    "one batch, rho=1.0",
          "rounds": r32.outer_iterations, "s_per_round": wall / ROUNDS5_F32,
          "f64_s_per_round": s64 / ROUNDS5_F32, "objective": r32.objective,
          "f64_objective": r64.objective, "objective_rel_f64": rel5,
          "pres": r32.primal_res, "dres": r32.dual_res,
          "f64_pres": r64.primal_res, "f64_dres": r64.dual_res,
          "lockstep_iterations_per_round": per_round, "launches": counts})
    check(tf32_off() == tf32, "f32carry: the f32 matmul settings changed")
    return launches, profile


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
    # probe_fwd at other (n, k), n off the 32-row blocks, bit for bit; and
    # with zeros, a subnormal, a huge value and a NaN in b (the kernel's
    # second pass, IEEE division), where the NaNs and zeros' signs agree too
    rng = np.random.default_rng(5)
    for n_, k_ in FWD_SHAPES[1:]:
        A_ = rng.normal(size=(n_, n_))
        L_ = np.linalg.cholesky(A_ @ A_.T + n_ * np.eye(n_)).astype(np.float32)
        LT_ = torch.as_tensor(L_.T.copy(), device=dev)
        b_ = torch.as_tensor(rng.normal(size=(n_, k_)).astype(np.float32),
                             device=dev)
        bit_equal(probes.fwd_subst(LT_, b_), probes.fwd_subst_plain(LT_, b_),
                  f"P5 n={n_} k={k_}")
    for val in (0.0, -0.0, 1e-40, 3e38, float("nan")):
        b_ = bb.clone()
        b_[5, 0] = val
        got, want = probes.fwd_subst(LT, b_), probes.fwd_subst_plain(LT, b_)
        torch.cuda.synchronize()
        same = ((got.view(torch.int32) == want.view(torch.int32))
                | (got.isnan() & want.isnan()))
        check(bool(same.all()), f"P5 with {val} in b: not bit-equal to plain")

    # the SM clock before, between and after these microsecond timings (a
    # short kernel's time moves with it)
    clocks = [sm_clock()]
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
    # the floor under every probe: an empty kernel, by events around a
    # call and by device time
    from socp_tpu_torch.ops import _build

    empty = _build.kernel("probe_empty")

    def launch_empty():
        err = empty(torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"probe_empty: cudaError {err}")

    clocks.append(sm_clock())
    floor = {"call_ms": cuda_ms(launch_empty)}
    floor["kernel_ms"], floor["kernel_ms_by"] = device_ms(launch_empty)
    # probe_fwd against solve_triangular in turns in this call (kernel,
    # library, library, kernel, twice), by events and by device time
    turns = {"probe_fwd": {"call_ms": [], "kernel_ms": []},
             "solve_triangular": {"call_ms": [], "kernel_ms": []}}
    fwd = (lambda: probes.fwd_subst(LT, bb))
    lib = (lambda: torch.linalg.solve_triangular(LT.mT, bb, upper=False))
    for name, f in (("probe_fwd", fwd), ("solve_triangular", lib),
                    ("solve_triangular", lib), ("probe_fwd", fwd)) * 2:
        turns[name]["call_ms"].append(cuda_ms(f))
        turns[name]["kernel_ms"].append(device_ms(f)[0])
    clocks.append(sm_clock())
    emit({"phase": "probes", "bit_equal": True, "max_abs_err": errs,
          "P1_reconstruction": recon, "P2_exact": True, "P5_rel_err": fwd_rel,
          "P5_shapes_bit_equal": [list(nk) for nk in FWD_SHAPES],
          "launch_floor": floor, "P5_in_turns": turns,
          "sm_clock_mhz": clocks,
          "launches": {k: v for k, v in launches.items() if v},
          "timing": {k: {kk: vv for kk, vv in t.items() if kk != "bound"}
                     for k, t in timing.items()}})
    return launches, errs, timing, floor, turns


@contextlib.contextmanager
def plain_calls():
    """Within it, calls of the four kernels' plain versions (ops.chol's
    *_plain) are counted in the dict it yields."""
    from socp_tpu_torch.ops import chol

    names = [f"{k}_plain" for k in F64_KERNELS]
    saved = {name: getattr(chol, name) for name in names}
    calls = {name: 0 for name in names}

    def counted(name):
        def call(*args):
            calls[name] += 1
            return saved[name](*args)
        return call

    for name in names:
        setattr(chol, name, counted(name))
    try:
        yield calls
    finally:
        for name, f in saved.items():
            setattr(chol, name, f)


def trace_kernels(run, tries=3):
    """Run `run()` inside utils.profiling.trace and read the Chrome trace
    it writes: {category: [kernel names]} of its device kernels (by
    `_category`) and its file's size.  The tracer can drop a trace's
    device events: a trace without any is taken again, up to `tries`
    times."""
    import glob
    import tempfile

    from socp_tpu_torch.utils.profiling import trace

    for attempt in range(tries):
        with tempfile.TemporaryDirectory() as tmp:
            with trace(tmp) as log_dir:
                run()
            files = glob.glob(f"{log_dir}/*.pt.trace.json")
            check(len(files) == 1, f"examples: trace wrote {files}")
            size = len(open(files[0], "rb").read())
            with open(files[0]) as f:
                events = json.load(f)["traceEvents"]
        kernels = {}
        for ev in events:
            if ev.get("cat") == "kernel":
                kernels.setdefault(_category(ev["name"]), set()).add(ev["name"])
        if kernels:
            return {c: sorted(v) for c, v in kernels.items()}, size
        print(f"chip_smoke: examples trace try {attempt + 1}: no device "
              "events", file=sys.stderr, flush=True)
    return {}, size


# the f64 kernels each example's card run launches (the others: none)
EXAMPLE_KERNELS = {
    "portfolio": ("chol_single", "tri_pair_single"),
    "batched_robust_ls": ("chol_batched", "tri_pair_batched"),
    "warm_start": ("chol_single", "tri_pair_single"),
    "block_schur": F64_KERNELS,           # the blocks and the p x p Schur
    "admm_stochastic": F64_KERNELS,       # the scenarios, the extensive form
    "huge_cone": ("chol_single", "tri_pair_single"),
}


def phase_examples():
    """The six examples (socp_tpu_torch/examples/, phase 12) on the card
    at the reference scripts' sizes, one rank, mesh=None: each example's
    run() with the counts at 0 just before it and the plain versions'
    calls counted, each held to the checks of the module doc; then the
    portfolio again inside utils.profiling.trace.  Returns the launches
    by example."""
    from socp_tpu_torch import Status
    from socp_tpu_torch.examples import (admm_stochastic, batched_robust_ls,
                                         block_schur, huge_cone, portfolio,
                                         warm_start)
    from socp_tpu_torch.utils import oracle
    from socp_tpu_torch.utils.metrics import metric_record
    from socp_tpu_torch.utils.profiling import PhaseTimers

    timers = PhaseTimers()
    launches, walls = {}, {}

    def on_card(name, run):
        torch.cuda.synchronize()
        reset_counts()
        # the examples' iteration tables go to stderr
        with plain_calls() as plain, contextlib.redirect_stdout(sys.stderr), \
                timers.phase(name):
            t0 = time.perf_counter()
            r = run()
            torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t0
        got = read_counts()
        check(not any(plain.values()),
              f"examples {name}: plain versions ran on the card: {plain}")
        want = EXAMPLE_KERNELS[name]
        check(all(got[k] > 0 for k in want),
              f"examples {name}: launched {got}, not all of {want}")
        none_of(got, [k for k in got if k not in want], f"examples {name}")
        launches[name] = {k: got[k] for k in want}
        return r

    def near(a, b, tol):
        return abs(a - b) <= tol * max(1.0, abs(b))

    def by_oracle(prob):
        return oracle.solve(prob.c, prob.G, prob.h, prob.dims, A=prob.A,
                            b=prob.b)

    out = {}
    # portfolio: OPTIMAL, the model's checks, pcost against the oracle
    r = on_card("portfolio", portfolio.run)
    ref = by_oracle(r["problem"])
    check(r["status"] == Status.OPTIMAL and not r["inaccurate"]
          and r["risk"] <= r["sigma_max"] * (1 + 1e-6)
          and r["budget_err"] <= 1e-6 and r["w_min"] >= -1e-7
          and ref["status"] == int(Status.OPTIMAL)
          and near(r["pcost"], ref["pcost"], 1e-7),
          f"examples portfolio: {r['solution']}, oracle {ref['status_name']} "
          f"{ref['pcost']!r}")
    out["portfolio"] = {"status": r["status"].name, "iterations": r["iterations"],
                        "pcost": r["pcost"], "oracle_pcost": ref["pcost"],
                        "risk": r["risk"], "budget_err": r["budget_err"],
                        "w_min": r["w_min"], "solve_s": r["wall_s"]}

    # warm_start: day 0 against the oracle, every warm day against cold
    r = on_card("warm_start", warm_start.run)
    ref = by_oracle(r["problem"])
    base = r["base"]
    check(base.status == Status.OPTIMAL and near(base.pcost, ref["pcost"], 1e-7)
          and all(row["warm"].status == row["cold"].status == Status.OPTIMAL
                  and near(row["warm"].pcost, row["cold"].pcost, 1e-7)
                  for row in r["days"]),
          f"examples warm_start: day 0 {base} oracle {ref['pcost']!r}; "
          f"{[(row['cold'], row['warm']) for row in r['days']]}")
    out["warm_start"] = {
        "status": base.status.name, "iterations": base.iterations,
        "day0_pcost": base.pcost, "oracle_pcost": ref["pcost"],
        "iterations_cold": [row["cold"].iterations for row in r["days"]],
        "iterations_warm": [row["warm"].iterations for row in r["days"]],
        "total_cold": r["total_cold"], "total_warm": r["total_warm"]}

    # batched_robust_ls: all OPTIMAL at 1e-8, four lanes against the oracle
    r = on_card("batched_robust_ls", batched_robust_ls.run)
    c, G, h, dims = r["data"]
    x, y, s, z, status, k, stats, _ = r["out"]
    lanes = (0, 21, 42, r["B"] - 1)
    refs = {i: oracle.solve(c[i], G[i], h[i], dims) for i in lanes}
    # the 1e-8 tolerances on every lane: pres, dres and gap or relgap (an
    # OPTIMAL lane may end with its gap above 1e-8 and its relgap below)
    strict = ((stats[:, 4] <= 1e-8) & (stats[:, 5] <= 1e-8)
              & ((stats[:, 2] <= 1e-8) | (stats[:, 3] <= 1e-8)))
    check(r["config"].native_dd and r["optimal"] == r["B"] == 64
          and strict.all() and not stats[:, 6].any()
          and all(near(stats[i, 0], refs[i]["pcost"], 1e-7) for i in lanes),
          f"examples batched_robust_ls: optimal {r['optimal']}/{r['B']}, max "
          f"gap {r['max_gap']}, lanes {[(stats[i, 0], refs[i]['pcost']) for i in lanes]}")
    out["batched_robust_ls"] = {
        "status": "OPTIMAL", "optimal": r["optimal"], "B": r["B"],
        "iterations": r["iterations"], "max_gap": r["max_gap"],
        "max_relgap": float(stats[:, 3].max()),
        "first_s": r["first_s"], "steady_s": r["steady_s"],
        "solves_per_s": r["solves_per_s"],
        "lane_pcost_rel": {i: abs(stats[i, 0] - refs[i]["pcost"])
                           / max(1.0, abs(refs[i]["pcost"])) for i in lanes}}

    # block_schur: OPTIMAL at the known optimum (tests/test_schur.py:64)
    r = on_card("block_schur", block_schur.run)
    check(r["status"] == Status.OPTIMAL and not r["inaccurate"] and r["K"] == 8
          and near(r["pcost"], r["pstar"], 1e-6),
          f"examples block_schur: {r['status'].name} pcost {r['pcost']!r} "
          f"known {r['pstar']!r}")
    out["block_schur"] = {"status": r["status"].name, "K": r["K"],
                          "iterations": r["iterations"], "pcost": r["pcost"],
                          "pstar": r["pstar"], "solve_s": r["wall_s"]}

    # admm_stochastic: every inner solve OPTIMAL, equal to a CPU re-run;
    # the extensive form against the oracle
    r = on_card("admm_stochastic", admm_stochastic.run)
    cpu = admm_stochastic.run(verbose=False, device="cpu")
    res, ext = r["admm"], r["extensive"]
    ref = by_oracle(r["extensive_problem"])
    check(res.inner_status_ok
          and res.outer_iterations == cpu["admm"].outer_iterations
          and abs(res.objective - cpu["objective"])
          <= 1e-9 * abs(cpu["objective"])
          and ext.status == Status.OPTIMAL
          and near(ext.pcost, ref["pcost"], 1e-7),
          f"examples admm_stochastic: rounds {res.outer_iterations} (CPU "
          f"{cpu['admm'].outer_iterations}), objective {res.objective!r} (CPU "
          f"{cpu['objective']!r}), inner ok {res.inner_status_ok}, extensive "
          f"{ext} oracle {ref['pcost']!r}")
    out["admm_stochastic"] = {
        "status": "OPTIMAL" if res.inner_status_ok else "inner_failed",
        "iterations": res.outer_iterations, "objective": res.objective,
        "cpu_objective": cpu["objective"], "pres": res.primal_res,
        "dres": res.dual_res, "rho": res.rho,
        "extensive": {"status": ext.status.name, "iterations": ext.iterations,
                      "pcost": ext.pcost, "oracle_pcost": ref["pcost"]},
        "admm_s": r["admm_s"], "extensive_s": r["extensive_s"]}

    # huge_cone: the status of a CPU re-run, held to its certificate
    r = on_card("huge_cone", huge_cone.run)
    cpu = huge_cone.run(device="cpu")
    check(r["status"] == cpu["status"],
          f"examples huge_cone: {r['status'].name}, CPU {cpu['status'].name}")
    held = huge_held("examples", r["data"], r["result"], cpu["status"])
    out["huge_cone"] = {"status": r["status"].name, "q": r["q"],
                        "iterations": r["iterations"], "resid": r["resid"],
                        "bound": r["bound"], "cpu_iterations": cpu["iterations"],
                        "solve_s": r["wall_s"], **held}

    # the portfolio once more, inside utils.profiling.trace
    kernels, trace_bytes = trace_kernels(
        lambda: portfolio.run(verbose=False, device="cuda"))
    check("chol_single" in kernels and "tri_pair_single" in kernels,
          f"examples: the trace names no f64 single kernels: {kernels}")

    report = timers.report()
    print(report, flush=True)
    records = [metric_record(f"example_{name}", "wall_s", walls[name], "s",
                             mesh_devices=1, status=out[name]["status"],
                             iterations=out[name]["iterations"],
                             launches=launches[name])
               for name in EXAMPLE_KERNELS]
    emit({"phase": "examples", "device": torch.cuda.get_device_name(0),
          "records": records, "checks": out,
          "trace": {"bytes": trace_bytes,
                    "entry_points": {"chol_single_f64": kernels["chol_single"],
                                     "tri_pair_single_f64":
                                         kernels["tri_pair_single"]},
                    "categories": sorted(kernels)},
          "phase_timers": report.splitlines()})
    return launches


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
    a_launches, a_runs = phase_admm()
    for label, (run, run_s) in a_runs.items():
        phase_profile(run, run_s, label)
    h_launches, (h_run, h_solve_s) = phase_hugecone()
    phase_profile(h_run, h_solve_s, "hugecone")
    del h_run
    md_launches = phase_multidevice()
    f_errs, f_timing = phase_f32_kernels()
    f_launches, f_fn, f_args, f_solve_s = phase_f32factor()
    phase_profile(lambda: f_fn(*f_args)[4].cpu(), f_solve_s, "config3_f32factor")
    fs_launches, fs_run, fs_solve_s = phase_f32factor_single()
    phase_profile(fs_run, fs_solve_s, "config2_f32factor")
    fc_launches, (fc_run, fc_solve_s) = phase_f32carry()
    phase_profile(fc_run, fc_solve_s, "config3_f32carry")
    p_launches, p_errs, p_timing, p_floor, p_turns = phase_probes()
    e_launches = phase_examples()
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
                   "block_schur": b_launches[name],
                   "admm": a_launches["b"][name],
                   "admm_chunked": a_launches["a"][name],
                   "admm_native": a_launches["c"][name],
                   **{"hugecone" if run == "a" else f"hugecone_{run}": v[name]
                      for run, v in h_launches.items()},
                   **{run: v[name] for run, v in md_launches.items()},
                   **{f"examples_{ex}": v.get(name, 0)
                      for ex, v in e_launches.items()}}
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
        # config 4's shapes (the blocks; the Schur factor, n = 8) and
        # config 5's (the scenarios' H, n = 21)
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
            "launches_by_phase": {
                "f32factor": {b_name: f_launches[b_name]},
                "f32factor_single": {s_name: fs_launches[s_name]},
                **{f"f32carry_{run}": {kn: v[kn] for kn in (b_name, s_name)}
                   for run, v in fc_launches.items()}},
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
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": p_launches[count],
               "max_abs_err": p_errs[err], **numbers(p_timing[name])}
        if err in ("P2", "P3", "P4", "P5"):
            # an empty launch's device time: the least any probe can take
            row["launch_floor_kernel_ms"] = p_floor["kernel_ms"]
        if err == "P5":
            row["in_turns"] = p_turns
        rows.append(row)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
