"""Read the numbers that decide ``correct`` over many seeds, in one process on
the card, to set a cell's limits from (never run by a benchmark run):

    python3 portbench/calibrate.py --workload <cell> [--seeds 12] [--controls 3]
        [--faults 3] [--seconds 2] [--first-seed 4000000000]

Runs the cell ``--seeds`` times as the benchmark runs it (short windows), then
``--controls`` times with the reference in the precision below the stated one
in the program's place, then ``--faults`` times with each fault of
``faults.faults_of`` the cell planted in the timed path, each run on a seed of its own.
Prints one JSON line per run, then a summary line: per number the lower
reading (the largest over the program's runs), the control's least reading
and each fault's least reading.
"""

import contextlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import faults, harness  # noqa: E402


def main(argv):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--first-seed", type=int, default=4_000_000_000)
    args = ap.parse_args(argv)

    cell = harness.load_cell(args.workload)
    kinds = [("program", args.seeds, None), ("control", args.controls, None)]
    kinds += [(f, args.faults, faults.FAULTS[f])
              for f in faults.faults_of(cell)]
    readings = {}
    seed = args.first_seed
    for kind, count, plant in kinds:
        for _ in range(count):
            seed += 7919
            t0 = time.perf_counter()
            with plant() if plant is not None else contextlib.nullcontext():
                res = harness.run_cell(args.workload, seed, args.seconds, False, t0, cell=cell,
                                       control=kind == "control")
            checks = {k: v["value"] for k, v in res["checks"].items()}
            readings.setdefault(kind, []).append(checks)
            print(json.dumps({"kind": kind, "seed": seed, "checks": checks,
                              "metrics": {k: v["value"] for k, v in res["metrics"].items()},
                              "seconds": time.perf_counter() - t0}), flush=True)
    summary = {}
    for name in cell.limits:
        row = {"lower": max(r[name] for r in readings["program"])}
        for kind in readings:
            values = [r[name] for r in readings[kind] if name in r]
            if kind != "program" and values:
                row[kind] = min(values)
        summary[name] = row
    print(json.dumps({"summary": summary}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
