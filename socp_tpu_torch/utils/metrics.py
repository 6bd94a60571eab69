"""Benchmark-record schema: a copy of `socp_tpu/utils/metrics.py`.

A benchmark of the port emits its records through `metric_record`, so the
contract metrics (IPM iterations/s, KKT factorize ms, KKT solve ms) sit
under the same keys as the reference's records, at one device and on a
mesh.  A record always carries every schema key, null where a benchmark
cannot measure it (`mfu_bf16_pct`, a TPU matrix-unit share, stays null on
the card), so a record of either package diffs cleanly against the other's.
"""

from __future__ import annotations

import json
import sys

SCHEMA = "socp_tpu_bench_v1"

# the contract metrics + utilization axes, always present:
_KEYS = (
    "solves_per_s",            # instance throughput (batched configs)
    "iters_per_s",             # IPM iterations/s (BASELINE primary)
    "kkt_factor_ms",           # KKT factorize ms (BASELINE primary)
    "kkt_solve_ms",            # KKT back-solve ms (BASELINE primary)
    "lockstep_iter_ms",        # wall ms per batched lockstep iteration
    "mfu_bf16_pct",            # achieved MXU bf16 vs device peak
    "achieved_vs_attainable_pct",  # vs the measured roofline ceiling
    "mesh_devices",            # devices the run spanned (1 = single chip)
)


def metric_record(config: str, metric: str, value: float, unit: str,
                  vs_baseline: float | None = None, **fields) -> dict:
    """Build one schema record; unknown axes default to None.

    Extra keyword fields outside the schema (batch sizes, statuses, ...)
    pass through untouched.
    """
    rec = {
        "schema": SCHEMA,
        "config": config,
        "metric": metric,
        "value": round(float(value), 6),
        "unit": unit,
        "vs_baseline": (round(float(vs_baseline), 2)
                        if vs_baseline is not None else None),
    }
    for k in _KEYS:
        v = fields.pop(k, None)
        if v is None:
            rec[k] = None
        elif k == "mesh_devices":
            rec[k] = int(v)
        else:
            rec[k] = round(float(v), 4)
    rec.update(fields)
    return rec


def emit(rec: dict, stream=None) -> None:
    """Print one JSON line (stdout by default)."""
    print(json.dumps(rec), file=stream or sys.stdout, flush=True)
