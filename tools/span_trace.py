"""A traced run of one benchmark cell that also keeps what its span metrics
read, and the cost of the program's span recorder.

    python3 tools/span_trace.py --workload CELL --seed N --seconds S --out FILE.json
    python3 tools/span_trace.py --span-cost

The first runs the cell as `python3 -m jxlbench.run --trace 1` does (its
result line is printed last, as there) and writes to FILE.json the traced
slice (its ends and every device record, seconds since the epoch) and
every request of the window with its span records; `tools/span_report.py`
reads such files.  The second prints the time a span costs on this host:
a span on a decode's stats, and a copy's span under it (`span(None, ...)`,
which reads the thread's CPU clock), in us, the median of 7 rounds of
20,000 each.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def span_cost(n: int = 20_000, rounds: int = 7) -> dict:
    from j40_tpu_torch.profile import span

    def root() -> float:
        stats: dict = {}
        t0 = time.perf_counter()
        for _ in range(n):
            with span(stats, "finish"):
                pass
        return (time.perf_counter() - t0) / n

    def nested() -> float:
        stats: dict = {}
        with span(stats, "request"):
            t0 = time.perf_counter()
            for _ in range(n):
                with span(None, "copy.htod", cpu=True):
                    pass
            return (time.perf_counter() - t0) / n

    def empty() -> float:
        t0 = time.perf_counter()
        for _ in range(n):
            pass
        return (time.perf_counter() - t0) / n

    base = statistics.median(empty() for _ in range(rounds))
    out = {"span_us": 1e6 * (statistics.median(root() for _ in range(rounds)) - base),
           "copy_span_us": 1e6 * (statistics.median(nested() for _ in range(rounds)) - base)}
    import torch

    if torch.cuda.is_available():
        out.update(copy_cost())
    return out


def copy_cost(n: int = 5_000) -> dict:
    """The program's copy helpers against the bare copies they wrap, on the
    card, one after the other in each of `n` rounds (so both see the same
    host), inside a decode's span: a 24-byte upload from numpy and a fetch
    of a 12-byte device tensor; the medians of the rounds' times and of
    their differences, us."""
    import numpy as np
    import torch

    from j40_tpu_torch.profile import fetch, span, upload

    dev = torch.device("cuda")
    a = np.arange(3, dtype=np.int64)
    x = torch.arange(3, dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    ops = {"to": lambda: torch.from_numpy(np.ascontiguousarray(a)).to(dev),
           "upload": lambda: upload(a, dev),
           "cpu": lambda: x.cpu(),
           "fetch": lambda: fetch(x)}
    took: dict[str, list] = {k: [] for k in ops}
    stats: dict = {}
    with span(stats, "request", cpu=True):
        for _ in range(n):
            for k, op in ops.items():
                t0 = time.perf_counter_ns()
                op()
                took[k].append(time.perf_counter_ns() - t0)
    med = lambda xs: statistics.median(xs) * 1e-3
    return {**{f"{k}_us": med(v) for k, v in took.items()},
            "upload_less_to_us": med([u - t for u, t in zip(took["upload"], took["to"])]),
            "fetch_less_cpu_us": med([f - c for f, c in zip(took["fetch"], took["cpu"])])}


def traced_run(workload: str, seed: int, seconds: float, out: Path) -> dict:
    from jxlbench import run, spec

    run.pin_caches()
    cell = spec.load_cell(spec.load_benchmark(), workload)
    import j40_tpu_torch  # noqa: F401

    kept = {}

    class Keep:
        @staticmethod
        def read(ctx):
            sl = ctx.slice
            kept["slice"] = None if sl is None else {
                "t0": sl.t0, "t1": sl.t1, "device": sl.device, "launches": sl.launches}
            kept["requests"] = [
                {"client": r.client, "seq": r.seq, "ok": r.ok, "spans": r.stats.get("spans", [])}
                for r in ctx.requests]
            kept["per_request"] = ctx.per_request
            return None

    cell.metrics.append(spec.Metric("span_dump", "-", "lower", "program_span", False, {},
                                    reader=Keep))
    result = run.run_cell(cell, seed, seconds, True)
    kept["result"] = result
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(kept))
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int)
    ap.add_argument("--seconds", type=float, default=51)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--span-cost", action="store_true")
    a = ap.parse_args(argv)
    if a.span_cost:
        print(json.dumps(span_cost()), flush=True)
        return 0
    print(json.dumps(traced_run(a.workload, a.seed, a.seconds, a.out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
