"""The readings a cell's correctness limits are set from, on the card:
for each seed, a run of the cell with a short window and the check (the
program's readings), and on the first `--control` seeds the control's
readings too (the plain reference in bfloat16 put in the program's place,
on the same sampled units).  One JSON line per seed, then the largest
program reading and the smallest control reading of each number.

    python3 portbench/calibrate.py --workload splash256.run --seconds 5 \\
        --seeds 101,102,...,112 --control 3

Limits go between the two readings (`limits/<cell>.json`), with the more
room above the program's.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated seeds")
    parser.add_argument("--seconds", type=float, default=5.0)
    parser.add_argument("--control", type=int, default=3, help="seeds that also read the control")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    spec = harness.load_spec(Path.cwd())
    files = harness.cell_files(spec, args.workload, Path.cwd())
    program, control = {}, {}
    for k, seed in enumerate(int(s) for s in args.seeds.split(",")):
        record = harness.run_cell(files, seed, args.seconds, False, torch.device("cuda", 0), time.perf_counter(),
                                  control=k < args.control)
        line = {"seed": seed, "units": record["units"], "check_s": record["check_s"],
                "readings": record["readings"], "control": record.get("control_readings")}
        print(json.dumps(line), flush=True)
        for name, value in record["readings"].items():
            program[name] = max(program.get(name, 0.0), value)
        for name, value in (record.get("control_readings") or {}).items():
            control[name] = min(control.get(name, float("inf")), value)
    print(json.dumps({"workload": args.workload, "program_max": program, "control_min": control,
                      "card": harness.card_line()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
