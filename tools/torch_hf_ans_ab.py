"""Interleaved A/B timing, on one CUDA card, of B4's rANS walk from this
checkout's kernel library and from one built out of another copy of
`j40_tpu_torch/csrc/`.

    python3 tools/torch_hf_ans_ab.py OTHER_CSRC_DIR [PAIRS]

Both libraries load into one process (as tools/ab_native.py does for the
host core) and take turns on the same packed inputs: the lanes of
chip_smoke.py's hf_ans_2048 stream (`launch_hf`, uncapped), one call timed
between CUDA events per turn, the order swapped every pair.  Both must give
the host plan's coefficient planes, end every lane and leave the final rANS
state 0x130000.  Prints one JSON line: per library the median ms and ns per
symbol of the longest lane, and the median of the per-pair ratios B / A.
"""

import ctypes
import json
import statistics
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def other_library(csrc: Path, ref):
    """Build the sources of `csrc` (the file names of _build.SOURCES and
    HEADERS) into their own build directory and bind them as `ref` is."""
    from j40_tpu_torch.ops import _build

    saved = _build.SOURCES, _build.HEADERS, _build.BUILD_DIR
    _build.SOURCES = [csrc / s.name for s in saved[0]]
    _build.HEADERS = [csrc / s.name for s in saved[1]]
    _build.BUILD_DIR = REPO / "build" / "ab_other"
    try:
        path = _build.build()
    finally:
        _build.SOURCES, _build.HEADERS, _build.BUILD_DIR = saved
    lib = ctypes.CDLL(str(path))
    for name, fn in ref.__dict__.items():
        if hasattr(fn, "argtypes"):
            g = getattr(lib, name)
            g.argtypes, g.restype = fn.argtypes, fn.restype
    return lib


def main() -> int:
    import torch

    import chip_smoke as CS
    from j40_tpu_torch.ops import _build
    from j40_tpu_torch.ops import device_vardct as DV
    from j40_tpu_torch.ops import hf_kernels as HK

    if not torch.cuda.is_available():
        print("torch_hf_ans_ab: no CUDA device", file=sys.stderr)
        return 2
    pairs = int(sys.argv[2]) if len(sys.argv) > 2 else 20
    dev = torch.device("cuda", torch.cuda.current_device())
    libs = {"A": _build.load_kernels()}
    libs["B"] = other_library(Path(sys.argv[1]).resolve(), libs["A"])

    p = CS.hf_plan(CS.hf_stream(1))
    batch = DV.hf_batches(p["lanes"])[0]
    ncmax = max(ln.gw8 * ln.gh8 for ln in batch)
    d, launch, done_row = DV.pack_hf_batch(p["vd"], p["spec"], batch, p["orders"],
                                           p["ctx"], dev)
    assert HK.design(d["use_prefix"]) == "serial", "hf_ans_2048 is not an rANS stream"
    host = torch.from_numpy(CS.host_coeffs(p["vd"], batch, ncmax)).to(dev)
    longest = None
    for lib in libs.values():
        _build._lib = lib
        out, st = launch(ncmax)
        s = HK.lane_state(st, len(batch), done_row)
        assert torch.equal(out, host) and s["done"].all() and not s["err"].any()
        assert (s["ans_state"] == 0x130000).all()
        longest = int(CS.lane_symbols(out, d["nat"], d["nc"]).max())

    scratch = torch.empty_like(host)
    times: dict[str, list[float]] = {"A": [], "B": []}
    for i in range(pairs + 2):  # the first two pairs warm up
        for k in ("AB" if i % 2 == 0 else "BA"):
            _build._lib = libs[k]
            ms = CS.event_ms(lambda: launch(ncmax, out=scratch))
            if i >= 2:
                times[k].append(ms)
    _build._lib = libs["A"]
    ratio = statistics.median(b / a for a, b in zip(times["A"], times["B"]))
    print(json.dumps({
        "stream": "hf_ans_2048", "lanes": len(batch), "longest_lane_symbols": longest,
        "pairs": pairs, "card": torch.cuda.get_device_name(dev),
        **{k: {"ms": statistics.median(v), "ms_min": min(v), "ms_max": max(v),
               "ns_per_symbol": statistics.median(v) * 1e6 / longest}
           for k, v in times.items()},
        "ratio_b_over_a": ratio}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
