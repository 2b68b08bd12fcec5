"""The check's control at a cell's own size, on the card.

    python3 benchmark/control.py --workload <name> --seeds 1,2,3 \
        --seconds <s>

For each seed, one run of the cell as `benchmark/run.py` makes it, with
the entry module's `Control` in place of its `Entry`: once the window has
closed, the plain reference in the next precision below the one the
configuration states takes the place of the program's answers, and the
run's own verdict judges it.  Prints one JSON line a seed: `correct`
(which has to be false) and the numbers compared, each with its limit.
The benchmark's own runs never run the control.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        res = harness.run_cell(args.workload, seed, args.seconds, False,
                               root=ROOT, device="cuda:0", control=True,
                               log=lambda s: None)
        print(json.dumps({"seed": seed, "correct": res["correct"],
                          "compared": res["compared"],
                          "seconds": time.perf_counter() - t0}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
