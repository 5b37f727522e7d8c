"""Every control of `correct` a configuration names: as jxlbench/control.py
does for its module's `control`, each function of its module's `CONTROLS`
(name -> function, with `control`'s arguments) in turn, put in the
program's place and driven through a short window of the cell's own
traffic, then checked like any run.  Each has to come out not correct.

    python -m jxlbench.controls --workload CELL --seeds N[,N...] [--seconds S]

prints one JSON line a seed and control: the control's name, the numbers
compared with their limits, and `correct`.  A configuration without
`CONTROLS` runs its `control` alone."""

from __future__ import annotations

import argparse
import json
import sys
import time
from dataclasses import replace
from types import SimpleNamespace

from jxlbench import faults, run, spec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    a = ap.parse_args(argv)
    run.pin_caches()
    cell = spec.load_cell(spec.load_benchmark(), a.workload)
    codec = cell.codec
    controls = getattr(codec, "CONTROLS", {"control": codec.control})
    for seed in map(int, a.seeds.split(",")):
        for name, fn in controls.items():
            # the cell with this control as its codec's `control`
            one = replace(cell, codec=SimpleNamespace(
                reference=codec.reference, compare=codec.compare, control=fn))
            res = run.run_cell(one, seed, a.seconds, False, t_start=time.perf_counter(),
                               fault=faults.control_of(one, seed, "cuda"), out=sys.stderr)
            print(json.dumps({"workload": a.workload, "seed": seed, "control": name,
                              "correct": res["correct"], "attempted": res["attempted"],
                              "checks": res["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
