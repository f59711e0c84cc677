"""Run one cell of the benchmark of ``rrmpg_tpu_torch`` on this machine's
cards and print its result as the last line of standard output.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (imports, the inputs from the seed, the kernel library, one warm-up
call of every shape) counts in ``setup_s``; then the window runs the
cell's calls back to back for ``--seconds`` and ends with a synchronise.
After it the reference judges what the window produced.  With ``--trace
1`` the window runs under the profiler and the line carries the cell's
per-layer metrics instead of its end-to-end ones.  Without the cards the
cell asks for, or with JAX or the JAX package loaded, the run prints no
result and exits with a code other than 0.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def parse(argv):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from perfbench.harness import execute, resolve

    # One host thread of intra-op work: the window's host side is one
    # Python thread, and idle OpenMP workers would share its cores.
    torch.set_num_threads(1)

    plan = resolve(args.workload, ROOT)
    chips = plan.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); this machine "
              f"has {torch.cuda.device_count()} "
              f"(torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}).", file=sys.stderr)
        return 2
    devices = [torch.device("cuda", i) for i in range(chips)]
    result = execute(plan, devices, args.seed, args.seconds,
                     bool(args.trace), STARTED)
    if result is None:
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
