"""BENCHMARK.json and the files it names: each configuration, traffic mix,
set of limits and metric is a file of its own, found by its name, so a new
cell or metric is new files and no edit.

  configs/<config>.py     sizes, solver settings, generator, reference hooks
  traffic/<traffic>.json  the mix: which driver runs it and its parameters
  drivers/<driver>.py     a closed loop over one kind of entry point
  limits/<cell>.json      the numbers that decide `correct`, with limits
  metrics/<metric>.py     `read(run)` -> a number, or None for nothing read;
                          a reader that serves every `<metric>.<suffix>`
                          alike (the suffix names the cells' end-to-end
                          metric) is one file without the suffix
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


def load_module(path: Path, name: str | None = None):
    """Import a file of the benchmark by its path."""
    if not path.is_file():
        raise FileNotFoundError(f"benchmark: no file {path}")
    mod_name = name or "benchmark._by_path." + path.stem.replace(".", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Spec:
    """BENCHMARK.json, with the files of one cell found by name."""

    def __init__(self, root: Path = ROOT, bench: Path = BENCH):
        self.root, self.bench = Path(root), Path(bench)
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"benchmark: no workload {name!r} in BENCHMARK.json")

    def config_entry(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return c
        raise KeyError(f"benchmark: no configuration {name!r}")

    def config(self, name: str):
        return load_module(self.root / self.config_entry(name)["file"],
                           f"benchmark._configs.{name}")

    def traffic(self, name: str) -> dict:
        return json.loads((self.bench / "traffic" / f"{name}.json").read_text())

    def driver(self, name: str):
        return load_module(self.bench / "drivers" / f"{name}.py",
                           f"benchmark._drivers.{name}")

    def limits(self, cell: str) -> dict:
        return json.loads((self.bench / "limits" / f"{cell}.json").read_text())

    def metrics(self, cell: str, trace: bool) -> list[dict]:
        """The metrics a run of `cell` reports: with trace, the per-layer
        ones, else the end-to-end ones; each listed for the cell, or for
        every cell where it has no `workloads`."""
        group = self.data["per_layer" if trace else "end_to_end"]
        return [m for m in group if cell in m.get("workloads", [cell])]

    def reader(self, metric: str):
        """metrics/<metric>.py, or else metrics/<metric less its last
        dotted suffix>.py."""
        path = self.bench / "metrics" / f"{metric}.py"
        if not path.is_file() and "." in metric:
            path = path.with_name(f"{metric.rsplit('.', 1)[0]}.py")
        return load_module(path, f"benchmark._metrics.{metric.replace('.', '_')}")
