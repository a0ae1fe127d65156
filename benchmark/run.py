"""Run one cell of the benchmark once and print its result.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine that holds the cards the cell
asks for. The last line of standard output is the result's JSON object;
the numbers compared with the plain reference are the last lines of
standard error, each beside its limit. A run that finds no card, or fewer
cards than the cell asks for, or no program in the checkout, or a JAX
module loaded, exits non-zero and prints no result. `harness.py` says what
a run does.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# the checkout's root in place of this folder, whose module names would
# shadow the standard library's for everything the run imports
sys.path[0] = str(Path(__file__).resolve().parents[1])

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be a whole number >= 0")
    try:
        result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                  t_start=T_START)
    except harness.RunError as e:
        print(f"[bench] no result: {e}", file=sys.stderr, flush=True)
        return e.code
    for name, c in result["checks"].items():
        print(f"[bench] check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
