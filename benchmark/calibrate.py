#!/usr/bin/env python3
"""Readings from which the limits of `correct` are set: runs a cell on
several seeds in one process, each with a short window, and prints each
seed's compared numbers as a JSON line, then the largest and smallest of
each over the seeds.

    python3 benchmark/calibrate.py --workload <cell> --seeds 11 12 13 \
        [--mode program|control] [--fault <name>] [--seconds 2]

--mode control judges the reference computed in bfloat16 in the
program's place (the configurations state float32); --fault plants one of
benchmark/harness/faults.py under the timed path. The lower reading of a
number is the largest that sound runs of the program give, the upper the
smallest that the control (or, for training, a fault) gives.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--mode", choices=("program", "control"),
                    default="program")
    ap.add_argument("--fault", default=None)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark.harness import core, faults

    rows = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        with faults.planted(args.fault):
            out = core.run_cell(args.workload, seed, args.seconds, False,
                                mode=args.mode, root=ROOT)
        row = dict(seed=seed, mode=args.mode, fault=args.fault,
                   correct=out["correct"], failed=out["failed"],
                   attempted=out["attempted"],
                   checks={k: v["value"] for k, v in out["checks"].items()},
                   metrics={k: v["value"] for k, v in out["metrics"].items()},
                   seconds=time.perf_counter() - t0)
        rows.append(row)
        print(json.dumps(row), flush=True)
    names = rows[0]["checks"]
    summary = {n: dict(max=max(r["checks"][n] for r in rows),
                       min=min(r["checks"][n] for r in rows)) for n in names}
    print(json.dumps(dict(workload=args.workload, mode=args.mode,
                          fault=args.fault, seeds=args.seeds,
                          summary=summary)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
