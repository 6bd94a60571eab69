#!/usr/bin/env python3
"""What bounds the batched kernels: time variants of their sources on one
card, each built from this checkout's csrc/ with a few lines replaced.

    python3 kernel_variants.py [PREFIX ...]   # from the root of the repository

With prefixes, only the variants whose names start with one of them run
(`cross_`: where each batched kernel's schedule above the register tiles
and the warp panels should start).

Each variant is csrc/chol_batched.cu or csrc/tri_pair_batched.cu with the
text substitutions of VARIANTS applied, to the source or to the headers it
includes (a substitution whose text is not found fails the run: the
sources changed).  They are built by nvcc with
the package's flags into socp_tpu_torch/_build/variants/ (all at once),
loaded with ctypes, run at B = 4096, n = 102, k = 1 (the register tiles
and panels) or, for the small-order schedule's variants, at config 5's
B = 65,536, n = 21, k = 1 or config 4's B = 10,240, n = 10 (k = 8), in
f64 and f32 on inputs made from a numpy seed, and timed by device time
(`device_ms` of chip_smoke.py: torch.profiler, median of 15).  The `cross_`
variants move where a schedule starts (the Cholesky's tile dataflow, the
pair solve's block panels) and time one shape under each schedule; each
row names the schedule its source chose at its shape.  A variant marked `exact`
must stay bit-equal to the plain version; the knock-outs (the chain's
square root, reciprocal and division or the update's arithmetic taken
out) compute something else and only say how much of the time that part
holds.  The `clock` variants also record clock64() marks: per Cholesky
block the cycles loading H, in the step loop and storing L; per pair
solve warp the total, the cycles waiting for block copies, in diagonal
chains and in the blocks beyond them (means over the batch).  Prints the
card's nvidia-smi "name, power.limit" line, then one JSON line per variant
and dtype.  Needs CUDA.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

import chip_smoke as smoke

CHOL, TRI = "chol_batched", "tri_pair_batched"
NO_CHAIN = {"    const T d = sqrt_rn(p);\n    const T r = rcp_of(d);":
            "    const T d = p;\n    const T r = p;",
            "const T q = div_rn(own ? v : T(1), d, r);": "const T q = mul_rn(v, r);"}
NO_UPDATE = {"          acc[s][a][b] = sub_rn(acc[s][a][b], mul_rn(ci[a], ck[b]));":
             "          acc[s][a][b] = ci[a];"}
THREADS = {"constexpr int kTileThreads = 128, kTileSlots = 3;":
           "constexpr int kTileThreads = {t}, kTileSlots = {s};",
           "static_assert(max_n(kTileThreads, kTileSlots) == kMaxN,":
           "static_assert(max_n(kTileThreads, kTileSlots) >= 102,",
           "launch_k<T, kTileThreads, kTileSlots, 3>":
           "launch_k<T, kTileThreads, kTileSlots, {b}>"}
# clock64() marks: a global buffer, read back through prof_read
PROF_HEAD = {"namespace {\n": "namespace {\n__device__ unsigned long long g_prof[4096 * 4];\n",
             "}  // namespace": "}  // namespace\nextern \"C\" int prof_read(void* h) {\n"
             "  return (int)cudaMemcpyFromSymbol(h, g_prof, sizeof(g_prof));\n}\n"}
CHOL_CLOCK = {
    **PROF_HEAD,
    "  const int tid = threadIdx.x;\n":
    "  const int tid = threadIdx.x;\n  const unsigned long long t0 = clock64();\n",
    "  // column 0\n": "  const unsigned long long t1 = clock64();\n  // column 0\n",
    "  // L: the tiles into the packed buffer":
    "  const unsigned long long t2 = clock64();\n  // L: the tiles into the packed buffer",
    "      L[static_cast<size_t>(i) * n + k] = k <= i ? row[k] : T(0);\n    }\n  }\n}":
    "      L[static_cast<size_t>(i) * n + k] = k <= i ? row[k] : T(0);\n    }\n  }\n"
    "  if (tid == 0 && blockIdx.x < 4096) {\n"
    "    unsigned long long* g = g_prof + blockIdx.x * 4;\n"
    "    g[0] = t1 - t0; g[1] = t2 - t1; g[2] = clock64() - t2; g[3] = 0;\n  }\n}",
}
TRI_CLOCK = {
    **PROF_HEAD,
    "  const int lane = threadIdx.x & (kP - 1);\n":
    "  const int lane = threadIdx.x & (kP - 1);\n"
    "  unsigned long long tw = 0, td = 0, to = 0, tb = 0;\n"
    "  const unsigned long long t0 = clock64();\n",
    "    __pipeline_wait_prior(kStages - 1);  // this job's block has landed\n"
    "    __syncwarp();                        // (every lane's copies)\n":
    "    const unsigned long long ta = clock64();\n"
    "    __pipeline_wait_prior(kStages - 1);  // this job's block has landed\n"
    "    __syncwarp();                        // (every lane's copies)\n"
    "    tb = clock64();\n    tw += tb - ta;\n",
    "    __syncwarp();  // the block and the quotients are read before reuse\n"
    "    if (!next(job)) break;":
    "    __syncwarp();  // the block and the quotients are read before reuse\n"
    "    (r == P ? td : to) += clock64() - tb;\n"
    "    if (!next(job)) {\n"
    "      if (lane == 0 && unit < 4096) {\n"
    "        unsigned long long* g = g_prof + unit * 4;\n"
    "        g[0] = clock64() - t0; g[1] = tw; g[2] = td; g[3] = to;\n      }\n"
    "      break;\n    }",
}
# the small-order schedule (n <= 32): its chain (the pivot's square root,
# reciprocal and division) or its update knocked out; its steps skipped
# (only the copies in and out are left); a warp an instance at n = 10
# against two; 8 warps a block against 4; the pair's step loops unrolled
# by 4 (the f64 instance spills) against 2
SMALL_NO_CHAIN = {"const T d = sqrt_rn(p), r = rcp_of(d);": "const T d = p, r = p;",
                  "const T q = div_rn(live && i >= j ? acc[j] : T(1), d, r);":
                  "const T q = mul_rn(acc[j], r);"}
SMALL_NO_UPDATE = {"acc[k] = sub_rn(acc[k], mul_rn(q, mine[k]));": "acc[k] = mine[k];"}
SMALL_COPIES = {"if (j >= n) break;\n    const T p = __shfl_sync":
                "if (j >= 0) break;\n    const T p = __shfl_sync"}
SMALL_WARPS = {"constexpr int kSmallWarps = 4;": "constexpr int kSmallWarps = 8;"}
SMALL_ONE_A_WARP = {"    case 16: return launch_small_k<T, 16, 16>(H, L, batch, n, s);":
                    "    case 16: return launch_small_k<T, 32, 16>(H, L, batch, n, s);"}
TRI_SMALL_NO_DIVISION = {"T q = div_rn(live && i == j ? x : T(1), piv, rp);":
                         "T q = mul_rn(x, rp);"}
TRI_SMALL_L_ONLY = {"for (int base = 0; base < units; base += per_pass) {":
                    "for (int base = 0; base < 0; base += per_pass) {"}
TRI_SMALL_UNROLL4 = {"#pragma unroll 2\n    for (int j = 0;": "#pragma unroll 4\n    for (int j = 0;",
                     "#pragma unroll 2\n    for (int j = n - 1;": "#pragma unroll 4\n    for (int j = n - 1;"}
C5, C4, C4K = (65536, 21, 1), (10240, 10, 1), (10240, 10, 8)
# where the schedules above the register tiles and the warp panels start:
# the Cholesky's tile dataflow from n = 33 (it takes over from 109), or
# not before n = `top` (176 in f64, 252 in f32), with the register-tile
# schedule it replaced between (256 threads of 4 (f64) or 8 (f32) tiles:
# schedule -3); the pair solve's block panels from 33 or never (from 257)
DATAFLOW_EARLY = {"constexpr int kDataflowFrom = kMaxN + 1;":
                  "constexpr int kDataflowFrom = 33;"}
REG256 = {"constexpr int kMaxN = 108;": "constexpr int kMaxN = 256;",
          "static_assert(max_n(kTileThreads, kTileSlots) == kMaxN,":
          "static_assert(max_n(kTileThreads, kTileSlots) == 108,",
          "constexpr int kDataflowFrom = kMaxN + 1;":
          "constexpr int kDataflowFrom = {top} + 1;",
          "  return launch_k<T, kTileThreads, kTileSlots, 3>(H, L, batch, n, s);":
          "  if (n > 108) return launch_k<T, 256, sizeof(T) == 8 ? 4 : 8, 1>(H, L, batch, n, s);\n"
          "  return launch_k<T, kTileThreads, kTileSlots, 3>(H, L, batch, n, s);",
          "  return n >= kDataflowFrom ? -2 : -1;":
          "  return n >= kDataflowFrom ? -2 : n > 108 ? -3 : -1;"}
BLOCK_PANELS_EARLY = {"constexpr int kBlockPanelsFrom = 257;":
                      "constexpr int kBlockPanelsFrom = 33;"}
WARP_PANELS_ALWAYS = {"constexpr int kBlockPanelsFrom = 257;":
                      "constexpr int kBlockPanelsFrom = 1 << 30;"}
CROSS = {}
for Bc, nc in ((64, 109), (64, 128), (64, 144), (64, 160), (64, 176),
               (64, 240), (64, 252), (1024, 128), (1024, 176), (1024, 252),
               (4096, 144)):
    CROSS[f"cross_chol_n{nc}_B{Bc}"] = (CHOL, {}, True, (Bc, nc, 1))
    for key, top in (("f64", 176), ("f32", 252)):
        if nc <= top:
            CROSS[f"cross_chol_reg256_n{nc}_B{Bc}_{key}"] = (
                CHOL, {k: v.format(top=top) for k, v in REG256.items()}, True,
                (Bc, nc, 1), (key,))
CROSS["cross_chol_n102_B4096"] = (CHOL, {}, True, (4096, 102, 1))
CROSS["cross_chol_dataflow_n102_B4096"] = (CHOL, DATAFLOW_EARLY, True,
                                           (4096, 102, 1))
for Bc, nc in ((64, 200), (64, 500), (1024, 200)):
    CROSS[f"cross_tri_n{nc}_B{Bc}"] = (TRI, {}, True, (Bc, nc, 1))
    CROSS[f"cross_tri_other_n{nc}_B{Bc}"] = (
        TRI, BLOCK_PANELS_EARLY if nc < 257 else WARP_PANELS_ALWAYS, True,
        (Bc, nc, 1))
# name -> (source, substitutions, exact[, (B, n, k): config 3's by default[,
# the dtypes it runs in: both by default]])
VARIANTS = {
    "chol": (CHOL, {}, True),
    "chol_no_chain": (CHOL, NO_CHAIN, False),
    "chol_no_chain_no_update": (CHOL, {**NO_CHAIN, **NO_UPDATE}, False),
    "chol_256x2": (CHOL, {k: v.format(t=256, s=2, b=2) for k, v in THREADS.items()}, True),
    "chol_64x6": (CHOL, {k: v.format(t=64, s=6, b=4) for k, v in THREADS.items()}, True),
    "chol_clock": (CHOL, CHOL_CLOCK, True),
    "tri": (TRI, {}, True),
    "tri_no_division": (TRI, {"T q = div_rn(lane == src ? x : T(1), piv, rp);":
                              "T q = mul_rn(x, rp);"}, False),
    "tri_no_rows_beyond": (TRI, {
        "          for (int t = 0; t < kP; ++t) x = sub_rn(x, mul_rn(S[lane][t], qs[t]));":
        "          x = sub_rn(x, S[lane][0]);",
        "          for (int t = nb - 1; t >= 0; --t) {\n"
        "            x = sub_rn(x, mul_rn(S[t][lane], qs[t]));\n          }":
        "          x = sub_rn(x, S[0][lane]);"}, False),
    "tri_3_stages": (TRI, {"constexpr int kStages = 2;": "constexpr int kStages = 3;"}, True),
    "tri_2_warps": (TRI, {"constexpr int kWarps = 4;": "constexpr int kWarps = 2;"}, True),
    "tri_clock": (TRI, TRI_CLOCK, True),
    "chol_small": (CHOL, {}, True, C5),
    "chol_small_no_chain": (CHOL, SMALL_NO_CHAIN, False, C5),
    "chol_small_no_update": (CHOL, SMALL_NO_UPDATE, False, C5),
    "chol_small_copies_only": (CHOL, SMALL_COPIES, False, C5),
    "chol_small_8_warps": (CHOL, SMALL_WARPS, True, C5),
    "chol_small_n10": (CHOL, {}, True, C4),
    "chol_small_n10_one_a_warp": (CHOL, SMALL_ONE_A_WARP, True, C4),
    "tri_small": (TRI, {}, True, C5),
    "tri_small_no_division": (TRI, TRI_SMALL_NO_DIVISION, False, C5),
    "tri_small_l_copy_only": (TRI, TRI_SMALL_L_ONLY, False, C5),
    "tri_small_8_warps": (TRI, SMALL_WARPS, True, C5),
    "tri_small_unroll4": (TRI, TRI_SMALL_UNROLL4, True, C5),
    "tri_small_n10_k8": (TRI, {}, True, C4K),
    **CROSS,
    # the tile dataflow at config 2's width: its walker, or walker and
    # jobs, kept out of line (ptxas allocates their registers apart)
    "tiles_n500": (CHOL, {}, True, (64, 500, 1)),
    "tiles_walk_noinline_n500": (CHOL, {
        "template <typename T>\n__device__ __forceinline__ void walk(":
        "template <typename T>\n__device__ __noinline__ void walk("}, True,
        (64, 500, 1)),
    "tiles_noinline_n500": (CHOL, {
        "template <typename T>\n__device__ __forceinline__ void walk(":
        "template <typename T>\n__device__ __noinline__ void walk(",
        "template <typename T>\n__device__ __forceinline__ void job(":
        "template <typename T>\n__device__ __noinline__ void job("}, True,
        (64, 500, 1)),
}
B, N = smoke.B_MAIN, smoke.N_MAIN + 2


def _texts(name):
    """Variant `name`'s source and the shared headers, with its
    substitutions applied wherever their text is (each must be somewhere)."""
    from socp_tpu_torch.ops import _build

    source, subs, *_ = VARIANTS[name]
    files = {f"{source}.cu": (_build.CSRC / f"{source}.cu").read_text()}
    files.update({h.name: h.read_text() for h in sorted(_build.CSRC.glob("*.cuh"))})
    for old, new in subs.items():
        smoke.check(any(old in t for t in files.values()),
                    f"variant {name}: text not in {source}.cu or a header:\n{old}")
        files = {f: t.replace(old, new) for f, t in files.items()}
    return source, files


def build(out, names):
    """Write and compile the named variants at once (one build for each
    distinct text, in a directory of its own); the loaded libraries."""
    from socp_tpu_torch.ops import _build

    procs, first, key_of = {}, {}, {}
    for name in names:
        source, files = _texts(name)
        key = tuple(sorted(files.items()))
        key_of[name] = key
        if key in first:            # the same texts as an earlier variant
            continue
        first[key] = name
        os.makedirs(out / name, exist_ok=True)
        for f, t in files.items():
            (out / name / f).write_text(t)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out / f"{name}.so"),
             str(out / name / f"{source}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    built = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        smoke.check(proc.returncode == 0, f"variant {name} did not build:\n{log}")
        built[name] = (ctypes.CDLL(str(out / f"{name}.so")),
                       smoke.ptxas_report(log))
    return {name: built[first[key_of[name]]] for name in names}


def main(prefixes=()):
    if not torch.cuda.is_available():
        sys.exit("kernel_variants: CUDA is not available")
    from socp_tpu_torch.ops import _build, chol

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0], flush=True)
    names = [v for v in VARIANTS
             if not prefixes or v.startswith(tuple(prefixes))]
    libs = build(_build.BUILD_DIR / "variants", names)
    P, I = ctypes.c_void_p, ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    for dtype, key in ((torch.float64, "f64"), (torch.float32, "f32")):
        inputs = {}       # (B, n, k) -> H, its plain factor L, rhs, X
        for name, (lib, ptxas) in libs.items():
            source, _, exact, *rest = VARIANTS[name]
            Bv, Nv, Kv = rest[0] if rest else (B, N, 1)
            if key not in (rest[1] if len(rest) > 1 else ("f64", "f32")):
                continue
            if (Bv, Nv, Kv) not in inputs:
                rng = np.random.default_rng(smoke.SEED)
                H = torch.as_tensor(
                    smoke.spd_batch(rng, Bv, Nv, kappa=smoke.KAPPA[key]),
                    dtype=dtype, device="cuda")
                L = chol.chol_batched_plain(H)
                rhs = torch.as_tensor(rng.standard_normal((Bv, Nv, Kv)),
                                      dtype=dtype, device="cuda")
                inputs[Bv, Nv, Kv] = (H, L, rhs, chol.tri_pair_batched_plain(L, rhs))
            H, L, rhs, X = inputs[Bv, Nv, Kv]
            fn = getattr(lib, f"{source}_{key}")
            fn.restype = I
            out = torch.empty_like(H if source == CHOL else rhs)
            if source == CHOL:
                fn.argtypes = [P, P, P, I, I, P]
                lib.chol_batched_scratch_ints.argtypes = [I, I]
                ints = lib.chol_batched_scratch_ints(Bv, Nv)
                scratch = torch.empty(max(ints, 1), dtype=torch.int32,
                                      device="cuda")
                args = (H.data_ptr(), out.data_ptr(), scratch.data_ptr(), Bv,
                        Nv, stream)
                lib.chol_batched_schedule.argtypes = [I]
                schedule = lib.chol_batched_schedule(Nv)
            else:
                fn.argtypes = [P, P, P, I, I, I, P]
                args = (L.data_ptr(), rhs.data_ptr(), out.data_ptr(), Bv, Nv, Kv,
                        stream)
                lib.tri_pair_batched_schedule.argtypes = [I, I]
                schedule = lib.tri_pair_batched_schedule(Nv, Kv)
            smoke.check(fn(*args) == 0, f"variant {name} {key}: launch failed")
            torch.cuda.synchronize()
            equal = torch.equal(out, L if source == CHOL else X)
            smoke.check(equal or not exact,
                        f"variant {name} {key}: not bit-equal to the plain version")
            row = {"variant": name, "dtype": key, "shape": [Bv, Nv, Kv],
                   "schedule": schedule, "bit_equal": equal,
                   "kernel_ms": smoke.device_ms(lambda: fn(*args)),
                   "ptxas": {k: v for k, v in ptxas.items()
                             if ("double" in k) == (key == "f64")}}
            if hasattr(lib, "prof_read"):
                fn(*args)
                buf = np.zeros(4096 * 4, np.uint64)
                lib.prof_read.argtypes = [P]
                smoke.check(lib.prof_read(buf.ctypes.data) == 0, "prof_read")
                cycles = buf.reshape(-1, 4).astype(np.float64).mean(0)
                parts = (("load", "steps", "store") if source == CHOL
                         else ("total", "waiting", "diagonal", "beyond"))
                row["cycles_mean"] = dict(zip(parts, cycles.tolist()))
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
