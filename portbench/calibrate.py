"""Readings that a cell's correctness limit is set from, on the chip, in
one process: for each seed a run of the cell (a window at the cell's own
load and sizes), the program's widest gap and, with ``--readings``, the
control's and the planted faults' on the same sample (``check.gaps``:
``control``, ``state_unchanged``, ``token_altered``).  Not part of a
benchmark run.

    python3 portbench/calibrate.py --workload <cell> --seconds 10 \
        --readings control state_unchanged token_altered --seeds 1 2 3

One JSON line per seed.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--readings", nargs="*", default=[],
                    choices=("control", "state_unchanged", "token_altered"))
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    root = pathlib.Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(root / "src"), str(root)]
    from portbench.core import bench, spec

    cell = spec.load_cell(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        result, ctx = bench.run(cell, seed, args.seconds, False, readings=tuple(args.readings))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "gaps": ctx.readings, "tokens": ctx.tokens_compared,
                          "correct": result["correct"], "metrics": result["metrics"],
                          "setup": ctx.setup_parts,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
