"""Run cells of the benchmark one process at a time, as the check does, and
keep every run's result line.

    python3 perfbench/measure.py --out <file.jsonl> --tag <set> \
        --workload <name> --seeds 11,12,13 --seconds 10 [--trace 1]

Each run is ``perfbench/run.py`` in a process of its own; its result line
(or its exit code and the end of its standard error) is appended to
``--out`` with the tag, the seed and the run's wall time.  ``--spread``
then prints, for each workload and tag of a file, every metric's median
and the distance between its first and third quartiles as a share of the
median (``statistics.quantiles(values, n=4)``).
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def run_one(workload, seed, seconds, trace):
    cmd = [sys.executable, str(ROOT / "perfbench" / "run.py"), "--workload",
           workload, "--seed", str(seed), "--seconds", str(seconds),
           "--trace", str(trace)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
    wall = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    result = None
    if proc.returncode == 0 and lines:
        result = json.loads(lines[-1])
    return {"workload": workload, "seed": seed, "seconds": seconds,
            "trace": trace, "rc": proc.returncode, "wall_s": wall,
            "result": result, "stderr_tail": proc.stderr[-3000:]}


def spreads(path):
    rows = [json.loads(line) for line in Path(path).read_text().splitlines()]
    groups = {}
    for row in rows:
        if row["result"] is None:
            continue
        key = (row["workload"], row["tag"], row["trace"])
        for name, m in row["result"]["metrics"].items():
            groups.setdefault(key, {}).setdefault(name, []).append(
                m["value"])
    for key, metrics in sorted(groups.items()):
        for name, values in sorted(metrics.items()):
            med = statistics.median(values)
            q = statistics.quantiles(values, n=4) if len(values) > 1 else \
                [med, med, med]
            print(f"{key[0]} {key[1]} trace={key[2]} {name}: n={len(values)} "
                  f"median {med!r} iqr/median {(q[2] - q[0]) / med!r} "
                  f"values {values}")


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", required=True)
    parser.add_argument("--tag", default="")
    parser.add_argument("--workload")
    parser.add_argument("--seeds", default="")
    parser.add_argument("--seconds", type=float, default=10)
    parser.add_argument("--trace", type=int, default=0)
    parser.add_argument("--spread", action="store_true")
    args = parser.parse_args()
    if args.spread:
        spreads(args.out)
        return
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    for seed in (int(s) for s in args.seeds.split(",") if s):
        row = run_one(args.workload, seed, args.seconds, args.trace)
        row["tag"] = args.tag
        with out.open("a") as f:
            f.write(json.dumps(row) + "\n")
        res = row["result"]
        summary = ("no result: " + row["stderr_tail"][-1500:] if res is None
                   else json.dumps({"correct": res["correct"],
                                    "metrics": res["metrics"],
                                    "checks": res["checks"],
                                    "device": res["device"]}))
        print(f"[{args.tag}] {args.workload} seed {seed} trace "
              f"{args.trace} rc {row['rc']} wall {row['wall_s']:.1f} s: "
              f"{summary}", flush=True)


if __name__ == "__main__":
    main()
