"""One run of one cell of the port's benchmark.

    python -m jxlbench.run --workload CELL --seed N --seconds S --trace 0|1

from the root of a checkout that holds BENCHMARK.json and j40_tpu_torch.
In order: make (or read back) the cell's inputs from the seed, set up the
program (torch, the CUDA context, the kernel library and the native host
core, built into build/ and j40_tpu_torch/native/ on a checkout's first
run), warm up every request shape of the cell, drive the cell's traffic
through the program's entry for S seconds, check what the window's
requests returned against the configuration's plain reference, and print
one JSON line as the last line of standard output.  `--trace 1` profiles a
slice of the window and prints the cell's per-layer metrics instead of its
end-to-end ones.  Nothing here imports jax or j40_tpu; a run whose process
holds either once the window has closed fails.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402

# one process with few threads: BLAS and OpenMP pools of their own would
# contend for the host's cores with the clients and the program's own pool
os.environ.update(OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1", MKL_NUM_THREADS="1")

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from types import SimpleNamespace  # noqa: E402

import numpy as np  # noqa: E402

from jxlbench import corpus, spec, traffic  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "j40_tpu")
#: what every compared number reads for an answer of the wrong shape or type
WRONG_SHAPE = 1e9
#: seconds into the window before the traced slice opens
TRACE_LEAD_S = 2.0


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def pin_caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout (the
    port's own library and native core build there already)."""
    build = spec.ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "nv_cache")
    os.environ.setdefault("USE_FLAX", "0")


def power_limit() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=20)
        return r.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


class Sampler:
    """Which answers are kept for the check, `keep` at most: one of each
    client's first two requests, and each other with probability `share`,
    drawn from the seed by (client, request number)."""

    def __init__(self, seed: int, share: float, keep: int):
        self.seed, self.share, self.left = seed, share, keep
        self.lock = threading.Lock()

    def __call__(self, r: traffic.Request) -> bool:
        draw = np.random.default_rng([self.seed % 2**63, 3, r.client + 1, r.seq]).random()
        first = np.random.default_rng([self.seed % 2**63, 4, r.client + 1]).integers(0, 2)
        with self.lock:
            if (draw < self.share or r.seq == first) and self.left > 0:
                self.left -= 1
                return True
        return False


def check(cell: spec.Cell, seed: int, reqs: list, entry_image, device) -> tuple[dict, int]:
    """The largest value of each number compared over every kept answer, and
    the count of answers compared."""
    refs: dict = {}
    worst: dict = {}
    n = 0
    for r in reqs:
        if r.answer is None:
            continue
        got = entry_image(r.answer)
        if r.item not in refs:
            img = corpus.image(cell, seed, r.item)
            refs[r.item] = cell.codec.reference(img, cell.config, device=device)
        ref = refs[r.item]
        if got.shape != ref.shape or got.dtype != ref.dtype:
            nums = {k: WRONG_SHAPE for k in cell.config["limits"]}
        else:
            nums = cell.codec.compare(got.to(device), ref)
        for k, v in nums.items():
            worst[k] = max(worst.get(k, v), v)
        n += 1
        r.answer = None
    return worst, n


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: float | None = None, overrides: dict | None = None, fault=None,
             out=sys.stdout) -> dict:
    """One run; returns the result line's object.  `fault` wraps the timed
    call (the tests' broken paths)."""
    import torch

    t_start = T_START if t_start is None else t_start
    dev = torch.device(device)
    wl = cell.workload
    items, corpus_s = corpus.make(cell, seed, overrides)
    print(f"corpus_s {corpus_s}", file=out, flush=True)

    entry_mod = spec.load_module(spec.PKG / "entries" / f"{wl['entry']}.py")
    entry = entry_mod.Entry(wl.get("entry_args", {}), dev)
    entry.load()
    per_request: dict = {}
    for it in items:  # every request shape, and the launches a request makes
        c0 = entry.counters()
        entry(it.data)
        for k, v in entry.counters().items():
            per_request[k] = per_request.get(k, 0) + (v - c0.get(k, 0)) / len(items)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t_start - corpus_s

    if trace and dev.type == "cuda":
        from jxlbench import trace as T

        T.init()
    call = entry if fault is None else fault(entry, items)
    slices: list = []

    def during(t0: float, t1: float) -> None:
        from jxlbench import trace as T

        span = wl.get("trace_seconds", 4.0)
        time.sleep(max(0.0, t0 + TRACE_LEAD_S - time.perf_counter()))
        while time.perf_counter() + span + 0.5 < t1:
            sl = T.take(span, entry.counters, dev)
            slices.append(sl)
            if sl.lost is None:
                return

    sample = wl.get("sample", {})
    keep = Sampler(seed, sample.get("share", 1.0), sample.get("keep", 8))
    reqs, t0, t1 = traffic.drive(
        lambda i: call(items[i].data), wl["traffic"], len(items), seconds, keep,
        during if trace and dev.type == "cuda" else None)

    found = forbidden_modules()
    if found:
        raise SystemExit(f"forbidden modules loaded in the run: {found}")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    image_of = entry_mod.Entry.image
    del entry, call
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    worst, compared = check(cell, seed, reqs, image_of, dev)
    limits = cell.config["limits"]
    failed = sum(not r.ok for r in reqs)
    checks = {k: {"value": worst.get(k), "limit": lim} for k, lim in limits.items()}
    correct = (failed == 0 and compared > 0
               and all(c["value"] is not None and c["value"] <= c["limit"] for c in checks.values()))
    checks["answers_compared"] = {"value": compared, "limit": "at least 1"}
    checks["failed"] = {"value": failed, "limit": 0}

    good = next((s for s in slices if s.lost is None), None)
    for s in slices:
        if s.lost:
            print(f"trace: a slice lost records ({s.lost}); it is not read", file=out, flush=True)
    ctx = SimpleNamespace(cell=cell, requests=reqs, t0=t0, t1=t1, seconds=seconds, setup_s=setup_s,
                          corpus_s=corpus_s, facts=[it.facts for it in items],
                          per_request=per_request, slice=good)
    metrics = {}
    for m in cell.metrics:
        if m.end_to_end == bool(trace):
            continue
        v = m.reader.read(ctx)
        if v is not None:
            metrics[m.name] = {"value": v, "unit": m.unit}
    result = {"correct": bool(correct), "attempted": len(reqs), "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                         "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                         "count": 1, "memory_peak_bytes": int(peak)}}
    if trace and slices:
        shown = good or slices[-1]
        result["device"].update(busy_s=shown.busy(), window_s=shown.t1 - shown.t0)
        if good is not None:
            result["breakdown"] = good.breakdown()
    if dev.type == "cuda":
        result["device"]["power"] = power_limit()
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    pin_caches()
    cell = spec.load_cell(spec.load_benchmark(), a.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"jxlbench: the cell needs {cell.chips} CUDA device(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    import j40_tpu_torch  # noqa: F401  (the program has to be here before any input is made)

    result = run_cell(cell, a.seed, a.seconds, bool(a.trace))
    found = forbidden_modules()
    if found:
        print(f"jxlbench: forbidden modules loaded in the run: {found}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
