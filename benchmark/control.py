"""The controls of the check that decides `correct`: runs that must come
out not correct.

    python3 benchmark/control.py --workload <name> --seeds 1,2,3 --seconds 5 \\
        --control program_f32|reference_f32

`program_f32` runs the cell as benchmark/run.py does, with the program's
own f32 path switched on (`dtype=float32`, its f32-carries mode): the
nearest precision below the configuration's f64.  `reference_f32` puts the
plain reference, computed in float32, in the program's place (the
configuration's `reference_answer`), for a pool of the cell's batches.
Each seed prints one JSON line: every reading and whether it came out
correct.  It needs the cell's CUDA devices, as run.py does.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from benchmark.harness.runner import compare, run_cell  # noqa: E402
from benchmark.harness.spec import Spec  # noqa: E402


def reference_f32(cell_name, seed, device="cuda", sizes=None, spec=None):
    """The readings of the float32 reference in the program's place."""
    spec = spec or Spec()
    cell = spec.cell(cell_name)
    config = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    sizes = dict(sizes or {})
    records = []
    for item in config.pool(seed, traffic["pool"], device, sizes):
        answer = config.reference_answer(item, torch.float32)
        records.append({"item": item, **answer})
    return config.judge(records, device, sizes, traffic)


def control(cell_name, seed, seconds, kind, device="cuda", sizes=None):
    """(readings, correct) of one control run."""
    spec = Spec()
    if kind == "program_f32":
        result, readings = run_cell(cell_name, seed, seconds, False,
                                    device=device, sizes=sizes,
                                    dtype=torch.float32, spec=spec)
        return readings, result["correct"]
    readings = reference_f32(cell_name, seed, device, sizes, spec)
    return readings, compare(readings, spec.limits(cell_name))[0]


def main(argv=None):
    p = argparse.ArgumentParser(prog="benchmark/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--control", choices=("program_f32", "reference_f32"),
                   default="program_f32")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("benchmark: the controls run on CUDA devices", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        readings, correct = control(args.workload, seed, args.seconds,
                                    args.control)
        print(json.dumps({"workload": args.workload, "control": args.control,
                          "seed": seed, "correct": correct,
                          "readings": readings}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
