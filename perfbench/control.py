"""The readings behind a cell's limits, on the cell's own cards and sizes.

    python3 perfbench/control.py --workload <name> --seeds 1,2,...,12 \
        --control-seeds 3 --seconds 10 [--fault <name>] [--out <file.jsonl>]

For every seed, in one process: the cell's set-up and a window of
``--seconds`` at its own load, then the widest gap of the program's answers
against the float64 reference (the lower readings).  For the first
``--control-seeds`` seeds also the control: the reference put in the
program's place in bfloat16, the precision below the configuration's
float32, against the float64 reference on the same members (the upper
readings).  With ``--fault`` the program runs with that fault of
``perfbench/faults.py`` planted under the timed path, and its numbers are
the fault's readings.  ``perfbench/tests/test_bench_correct.py`` holds the
control and the faults at sizes a test run can hold.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CONTROL_DTYPE = "bfloat16"


def readings(plan, devices, seed, seconds, control):
    import torch

    from perfbench.harness import gaps, prepare, torch_seed, window

    run = plan.loop.Run(plan, devices, torch_seed(seed))
    prepare(run, devices)
    measured = window(run, seconds, devices)
    run.release()
    reference = run.reference(torch.float64)
    program = gaps(run.answers(), reference)
    if hasattr(run, "scores"):
        program.update(run.scores())
    row = {"seed": seed, "calls": measured.calls, "program": program}
    if control:
        row["control"] = gaps(run.reference(getattr(torch, CONTROL_DTYPE)),
                              reference)
    return row


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control-seeds", type=int, default=3)
    parser.add_argument("--seconds", type=float, default=10)
    parser.add_argument("--fault")
    parser.add_argument("--out")
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    from perfbench.harness import resolve

    plan = resolve(args.workload, ROOT)
    chips = plan.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        sys.exit(f"{args.workload} needs {chips} CUDA device(s).")
    devices = [torch.device("cuda", i) for i in range(chips)]
    seeds = [int(s) for s in args.seeds.split(",")]
    from perfbench.faults import planted

    for k, seed in enumerate(seeds):
        if args.fault:
            with planted(args.fault, plan):
                row = readings(plan, devices, seed, args.seconds, False)
            row["fault"] = args.fault
        else:
            row = readings(plan, devices, seed, args.seconds,
                           k < args.control_seeds)
        row["workload"] = args.workload
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")


if __name__ == "__main__":
    main()
