#!/usr/bin/env python3
"""Time the Cholesky and pair-solve kernels of several copies of
socp_tpu_torch on one card with one timer, so that two versions compare
like for like.

    python3 kernel_compare.py ROOT [ROOT ...]

Each ROOT is a directory that holds a `socp_tpu_torch` package: this
checkout (`.`) or an unpacked `git archive` of another commit.  For each
ROOT, in the order given, a fresh process builds that package's four
kernel sources, checks the single kernels bit for bit against their plain
versions at n = 33, 65, 128 and 500 and the batched ones at B = 64 and
n = 33, 65, 102, and times them through the package's own wrappers with
`single_timing` and `batched_timing` of the chip_smoke.py beside this
script, whatever the ROOT: call_ms (CUDA events around one call) and
kernel_ms (device time of the kernels the call enqueues, torch.profiler),
each a median of 15, at the single path's shapes and at config 3's
(B = 4096, n = 102, k = 1), in f64 and f32, on inputs made from the same
seed.  Give the roots
as A B B A to see the drift between runs.  Prints the card's nvidia-smi
"name, power.limit" line, one JSON line per run (with the registers and
spills of the kernels it built), then a summary line: per kernel and
shape, each ROOT's median over its runs.  Needs CUDA.
"""

from __future__ import annotations

import importlib.util
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = ("chol_single", "tri_pair_single", "chol_batched", "tri_pair_batched")
CHECK_NS = (33, 65, 128, 500)
BATCHED_CHECK_NS = (33, 65, 102)


def one(root):
    """Build and time the package under `root` (in this process)."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import numpy as np
    import torch

    import socp_tpu_torch
    from socp_tpu_torch.ops import _build, chol

    package = os.path.dirname(os.path.abspath(socp_tpu_torch.__file__))
    if os.path.dirname(package) != root:
        raise RuntimeError(f"imported {package}, not the package under {root}")
    _, log = _build.build(SOURCES)
    out = {"root": root, "ptxas": smoke.ptxas_report(log)}
    rng = np.random.default_rng(smoke.SEED)
    for dtype, kappa in ((torch.float64, 1e8), (torch.float32, 1e4)):
        for n in CHECK_NS:
            H = torch.as_tensor(smoke.spd_batch(rng, 1, n, kappa=kappa)[0],
                                dtype=dtype, device="cuda")
            rhs = torch.as_tensor(rng.standard_normal((n, 1)), dtype=dtype,
                                  device="cuda")
            L = chol.chol_single(H)
            X = chol.tri_pair_single(L, rhs)
            smoke.check(torch.equal(L, chol.chol_single_plain(H))
                        and torch.equal(X, chol.tri_pair_single_plain(L, rhs)),
                        f"{root}: a kernel differs from its plain version "
                        f"at n={n}, {dtype}")
        for n in BATCHED_CHECK_NS:
            H = torch.as_tensor(smoke.spd_batch(rng, 64, n, kappa=kappa),
                                dtype=dtype, device="cuda")
            rhs = torch.as_tensor(rng.standard_normal((64, n, 1)), dtype=dtype,
                                  device="cuda")
            L = chol.chol_batched(H)
            X = chol.tri_pair_batched(L, rhs)
            smoke.check(torch.equal(L, chol.chol_batched_plain(H))
                        and torch.equal(X, chol.tri_pair_batched_plain(L, rhs)),
                        f"{root}: a batched kernel differs from its plain "
                        f"version at n={n}, {dtype}")
    for dtype, key in ((torch.float64, "f64"), (torch.float32, "f32")):
        rng = np.random.default_rng(smoke.SEED + 1)
        timing = smoke.single_timing(dtype, rng)
        at = f"B={smoke.B_MAIN},n={smoke.N_MAIN + 2},k=1"
        timing.update({name: {at: t} for name, t in
                       smoke.batched_timing(dtype, rng).items()})
        out[key] = {name: {at: {k: v for k, v in t.items() if k != "bound"}
                           for at, t in by.items()}
                    for name, by in timing.items()}
    return out


def main(roots):
    import torch

    if not torch.cuda.is_available():
        sys.exit("kernel_compare: CUDA is not available")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0], flush=True)
    runs = []
    for root in roots:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--one", root],
                              capture_output=True, text=True, timeout=900)
        sys.stderr.write(proc.stderr)
        if proc.returncode:
            sys.exit(f"kernel_compare: {root} failed ({proc.returncode})")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    summary = {}
    for run in runs:
        for key in ("f64", "f32"):
            for name, by in run[key].items():
                for at, t in by.items():
                    cell = summary.setdefault(f"{name}_{key} {at}", {})
                    for metric in ("kernel_ms", "call_ms"):
                        cell.setdefault(run["root"], {}).setdefault(
                            metric, []).append(t[metric])
    for cell in summary.values():
        for root, metrics in cell.items():
            cell[root] = {m: statistics.median(v) for m, v in metrics.items()}
    print(json.dumps({"summary": summary}), flush=True)


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        print(json.dumps(one(sys.argv[2])), flush=True)
    elif len(sys.argv) > 1:
        main(sys.argv[1:])
    else:
        sys.exit(__doc__)
