"""Every cell, configuration, mix, limit and metric is a file found by its
name, and a new one is found with no edit."""

import json
import re
import shutil
import subprocess
import sys

import pytest

from benchmark.harness import runner
from benchmark.harness.spec import BENCH, ROOT, Spec

SMALL = {"robust_ls_b4096": {"batch": 4, "n": 6},
         "scenario_portfolio_s65536": {"scenarios": 16}}


def test_every_name_has_its_files():
    spec = Spec()
    for c in spec.data["configs"]:
        config = spec.config(c["name"])
        assert config.NAME == c["name"] and config.SOURCE == c["source"]
        assert list(config.REDUCED) == c["reduced"]
        for key in c["reduced"]:
            assert key in config.SHAPES
    for w in spec.data["workloads"]:
        traffic = spec.traffic(w["traffic"])
        spec.driver(traffic["driver"])
        assert spec.limits(w["name"])["numbers"]
        for trace in (False, True):
            for m in spec.metrics(w["name"], trace):
                assert callable(spec.reader(m["name"]).read)
    for m in spec.data["end_to_end"] + spec.data["per_layer"]:
        spec.reader(m["name"])


def test_benchmark_json_keeps_to_its_form():
    data = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(data) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    name = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"[A-Za-z0-9_/%.-]{1,16}$")
    line = re.compile(r"[^\t\n]{1,200}$")
    for c in data["configs"]:
        assert name.match(c["name"]) and line.match(c["source"])
        assert line.match(c["why"]) and all(name.match(k) for k in c["reduced"])
    for w in data["workloads"]:
        assert all(name.match(w[k]) for k in ("name", "config", "traffic"))
        assert line.match(w["why"]) and w["chips"] == 1
    for m in data["end_to_end"] + data["per_layer"]:
        assert name.match(m["name"]) and unit.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in data["per_layer"]:
        assert line.match(m["layer"]) and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
    for m in data["end_to_end"]:
        assert m["source"] in ("device_trace", "host_clock")
    names = [m["name"] for m in data["end_to_end"] + data["per_layer"]]
    assert len(names) == len(set(names)) and "setup_s" in names
    cells = {w["name"] for w in data["workloads"]}
    e2e = {m["name"] for m in data["end_to_end"]}
    for m in data["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
    for m in data["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        for cell in m["workloads"]:
            mv = next(e for e in data["end_to_end"] if e["name"] == m["moves"])
            assert cell in mv.get("workloads", cells)
    for cell in cells:
        assert [m for m in data["per_layer"] if cell in m.get("workloads", cells)]


def test_a_new_config_cell_and_metric_are_new_files(tmp_path):
    """Copy the benchmark, add a configuration, a mix, a cell's limits and a
    metric as files and entries of BENCHMARK.json, and run the new cell:
    nothing of the harness is edited."""
    root = tmp_path / "checkout"
    bench = root / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__"))
    data = json.loads((ROOT / "BENCHMARK.json").read_text())
    src = (bench / "configs" / "robust_ls_b4096.py").read_text()
    (bench / "configs" / "robust_ls_b16.py").write_text(
        src.replace('NAME = "robust_ls_b4096"', 'NAME = "robust_ls_b16"')
           .replace('"batch": 4096', '"batch": 16'))
    shutil.copy(bench / "traffic" / "dense.json", bench / "traffic" / "dense2.json")
    shutil.copy(bench / "limits" / "robust_ls_b4096.dense.json",
                bench / "limits" / "robust_ls_b16.dense2.json")
    (bench / "metrics" / "instances_per_batch.py").write_text(
        "def read(run):\n"
        "    return sum(c.work['instances'] for c in run.calls) / len(run.calls)\n")
    data["configs"].append({"name": "robust_ls_b16", "source": "test",
                            "file": "benchmark/configs/robust_ls_b16.py",
                            "reduced": [], "why": "test"})
    data["workloads"].append({"name": "robust_ls_b16.dense2", "config": "robust_ls_b16",
                              "traffic": "dense2", "chips": 1, "why": "test"})
    data["end_to_end"].append({"name": "instances_per_batch", "unit": "solves",
                               "better": "higher", "bound": 0.01,
                               "source": "host_clock",
                               "workloads": ["robust_ls_b16.dense2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(data))
    spec = Spec(root, bench)
    result, _ = runner.run_cell("robust_ls_b16.dense2", 5, 0.2, False,
                                device="cpu", sizes={"n": 6}, spec=spec)
    assert result["correct"]
    assert result["metrics"]["instances_per_batch"]["value"] == 16
    assert "setup_s" in result["metrics"]
    assert list(result)[-1] == "checks"


def test_forbidden_modules_compare_whole_top_level_names():
    names = {"socp_tpu_torch": 1, "socp_tpu_torch.api": 1, "jaxlib.xla": 1,
             "socp_tpu.api": 1, "jaxtyping": 1, "flax": 1, "numpy": 1}
    assert runner.forbidden_modules(names) == ["flax", "jaxlib.xla", "socp_tpu.api"]


_IMPORTS = """
import sys
sys.path.insert(0, {root!r})
{body}
bad = sorted(n for n in sys.modules if n.split(".", 1)[0] in {names!r})
print(" ".join(bad))
"""


def _loaded(body, names):
    code = _IMPORTS.format(root=str(ROOT), body=body, names=names)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=300)
    return out.stdout.split()


def test_the_benchmark_imports_no_jax_and_no_reference_package():
    body = """
from benchmark.harness import runner, spec as S
s = S.Spec()
for c in s.data["configs"]:
    s.config(c["name"])
for w in s.data["workloads"]:
    s.driver(s.traffic(w["traffic"])["driver"])
for m in s.data["end_to_end"] + s.data["per_layer"]:
    s.reader(m["name"])
import benchmark.control
import socp_tpu_torch, socp_tpu_torch.parallel.admm
"""
    assert _loaded(body, ("jax", "jaxlib", "flax", "socp_tpu")) == []


def test_the_reference_imports_nothing_of_the_program():
    body = """
import benchmark.reference.conic, benchmark.reference.admm
import benchmark.reference.robust_ls
"""
    assert _loaded(body, ("jax", "jaxlib", "flax", "socp_tpu", "socp_tpu_torch")) == []


def test_run_py_refuses_without_a_card():
    env = {"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"}
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "robust_ls_b4096.dense", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "no CPU fallback" in out.stderr


@pytest.mark.parametrize("cell", [w["name"] for w in Spec().data["workloads"]])
def test_a_sound_run_is_correct(cell):
    spec = Spec()
    sizes = SMALL[spec.cell(cell)["config"]]
    result, readings = runner.run_cell(cell, 2**31 + 99, 0.2, False,
                                       device="cpu", sizes=sizes)
    assert result["correct"], (result["checks"], readings)
    assert result["attempted"] > 0 and result["failed"] == 0
    e2e = {m["name"] for m in spec.metrics(cell, False)}
    assert set(result["metrics"]) == e2e
