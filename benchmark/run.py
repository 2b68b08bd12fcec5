"""The benchmark's command.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Runs one cell of BENCHMARK.json on the card it is started on and prints
one JSON object as the last line of standard output: `correct`,
`attempted`, `failed`, `metrics`, `device`, with `--trace 1` also
`breakdown`, and last `compared`, the numbers the check compared, each
with its limit (also the last lines of standard error).  It exits with
another code than 0, and prints no result, without a CUDA card, with fewer
cards than the cell asks for, or with JAX or the JAX package loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark import harness

    cell = harness.Cell(harness.load_spec(ROOT), args.workload, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("benchmark: no CUDA card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {cell.chips} cards wanted, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    try:
        result = harness.run_cell(
            args.workload, args.seed, args.seconds, bool(args.trace),
            root=ROOT, device="cuda:0", t_start=T_START)
    except harness.ForbiddenImport as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
