#!/usr/bin/env python3
"""What bounds the batched kernels: time variants of their sources on one
card, each built from this checkout's csrc/ with a few lines replaced.

    python3 kernel_variants.py          # from the root of the repository

Each variant is csrc/chol_batched.cu or csrc/tri_pair_batched.cu with the
text substitutions of VARIANTS applied (a substitution whose text is not
found fails the run: the sources changed).  They are built by nvcc with
the package's flags into socp_tpu_torch/_build/variants/ (all at once),
loaded with ctypes, run at B = 4096, n = 102, k = 1 in f64 and f32 on
inputs made from a numpy seed, and timed by device time (`device_ms` of
chip_smoke.py: torch.profiler, median of 15).  A variant marked `exact`
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
THREADS = {"constexpr int kThreads1 = 128, kSlots1 = 3;":
           "constexpr int kThreads1 = {t}, kSlots1 = {s};",
           "launch_k<T, kThreads1, kSlots1, 3>": "launch_k<T, kThreads1, kSlots1, {b}>"}
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
# name -> (source, substitutions, exact)
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
}
B, N = smoke.B_MAIN, smoke.N_MAIN + 2


def build(out):
    """Write and compile every variant at once; the loaded libraries."""
    from socp_tpu_torch.ops import _build

    os.makedirs(out, exist_ok=True)
    for header in _build.CSRC.glob("*.cuh"):
        (out / header.name).write_bytes(header.read_bytes())
    procs = {}
    for name, (source, subs, _) in VARIANTS.items():
        text = (_build.CSRC / f"{source}.cu").read_text()
        for old, new in subs.items():
            smoke.check(old in text, f"variant {name}: text not in {source}.cu:\n{old}")
            text = text.replace(old, new)
        (out / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out / f"{name}.so"),
             str(out / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        smoke.check(proc.returncode == 0, f"variant {name} did not build:\n{log}")
        libs[name] = (ctypes.CDLL(str(out / f"{name}.so")),
                      smoke.ptxas_report(log))
    return libs


def main():
    if not torch.cuda.is_available():
        sys.exit("kernel_variants: CUDA is not available")
    from socp_tpu_torch.ops import _build, chol

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0], flush=True)
    libs = build(_build.BUILD_DIR / "variants")
    P, I = ctypes.c_void_p, ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    for dtype, key in ((torch.float64, "f64"), (torch.float32, "f32")):
        rng = np.random.default_rng(smoke.SEED)
        H = torch.as_tensor(smoke.spd_batch(rng, B, N, kappa=smoke.KAPPA[key]),
                            dtype=dtype, device="cuda")
        L = chol.chol_batched_plain(H)
        rhs = torch.as_tensor(rng.standard_normal((B, N, 1)), dtype=dtype,
                              device="cuda")
        X = chol.tri_pair_batched_plain(L, rhs)
        for name, (lib, ptxas) in libs.items():
            source, _, exact = VARIANTS[name]
            fn = getattr(lib, f"{source}_{key}")
            fn.restype = I
            out = torch.empty_like(H if source == CHOL else rhs)
            if source == CHOL:
                fn.argtypes = [P, P, I, I, P]
                args = (H.data_ptr(), out.data_ptr(), B, N, stream)
            else:
                fn.argtypes = [P, P, P, I, I, I, P]
                args = (L.data_ptr(), rhs.data_ptr(), out.data_ptr(), B, N, 1, stream)
            smoke.check(fn(*args) == 0, f"variant {name} {key}: launch failed")
            torch.cuda.synchronize()
            equal = torch.equal(out, L if source == CHOL else X)
            smoke.check(equal or not exact,
                        f"variant {name} {key}: not bit-equal to the plain version")
            row = {"variant": name, "dtype": key, "bit_equal": equal,
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
    main()
