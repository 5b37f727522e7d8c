"""The control of `correct`: the configuration's plain reference, computed
at the precision below the one the configuration states (its module's
`control`), put in the program's place and driven through a short window
of the cell's own traffic, then checked like any run.  It has to come out
not correct.

    python -m jxlbench.control --workload CELL --seeds N[,N...] [--seconds S]

prints one JSON line a seed: the numbers compared with their limits, and
`correct`."""

from __future__ import annotations

import argparse
import json
import sys
import time

from jxlbench import faults, run, spec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    a = ap.parse_args(argv)
    run.pin_caches()
    cell = spec.load_cell(spec.load_benchmark(), a.workload)
    for seed in map(int, a.seeds.split(",")):
        res = run.run_cell(cell, seed, a.seconds, False, t_start=time.perf_counter(),
                           fault=faults.control_of(cell, seed, "cuda"), out=sys.stderr)
        print(json.dumps({"workload": a.workload, "seed": seed, "correct": res["correct"],
                          "attempted": res["attempted"], "checks": res["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
