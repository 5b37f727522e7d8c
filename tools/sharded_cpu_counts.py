"""Counts behind PERF.md's multi-device notes, taken on the CPU (no card):

    python3 tools/sharded_cpu_counts.py

1. the sharded lossless path's Squeeze merges on chip_smoke's
   `lossless_sq` stream over 8 shards, through the plain version of kernel
   S1 (`ops/squeeze_kernels._inv_squeeze_h_scan`): the column pairs it
   walks, its calls, and the top-level PyTorch ops of one column pair;
2. how far config 12F-like filtering (gaborish + 3 EPF steps) on 8 shards
   departs from the single-device filtered decode near an LF-group border
   (the single-device plan filters each 2048x2048 group apart): the
   largest difference and the count above 1 level at each distance from
   the border, on a 2304x2304 image.

One JSON line.  Both run the plain versions (`Mesh([cpu] * 8)`).
"""

import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as C  # noqa: E402
from j40_tpu_torch.decode import Decoder  # noqa: E402
from j40_tpu_torch.encode.vardct_enc import VarDCTOptions, encode_vardct  # noqa: E402
from j40_tpu_torch.ops import squeeze_kernels as SQ  # noqa: E402
from j40_tpu_torch.parallel import sharded_lossless as SL  # noqa: E402
from j40_tpu_torch.parallel.mesh import Mesh  # noqa: E402
from j40_tpu_torch.parallel.sharded_decode import decode_sharded  # noqa: E402

MESH = Mesh(["cpu"] * 8, ("rows",))


def column_loop() -> dict:
    from torch.profiler import ProfilerActivity, profile

    counts = {"column_pairs": 0, "calls": 0}
    scan = SQ._inv_squeeze_h_scan

    def counted(down, residu):
        if residu.shape[0]:
            counts["column_pairs"] += residu.shape[1]
            counts["calls"] += 1
        return scan(down, residu)

    SQ._inv_squeeze_h_scan = counted
    try:
        SL.decode_sharded_lossless(C.lossless_sq_stream(), mesh=MESH)
    finally:
        SQ._inv_squeeze_h_scan = scan
    # the ops of a column pair: one scan of 9 pairs less one of 1 pair, / 8
    rng = np.random.default_rng(0)
    ops = []
    for wr in (1, 9):
        down = torch.from_numpy(rng.integers(-50, 50, (4, wr + 1), dtype=np.int32))
        res = torch.from_numpy(rng.integers(-5, 5, (4, wr), dtype=np.int32))
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            scan(down, res)
        ops.append(sum(1 for e in prof.events()
                       if e.name.startswith("aten::") and e.cpu_parent is None))
    counts["ops_per_column_pair"] = (ops[1] - ops[0]) / 8
    return counts


def border_band(size: int = 2304, group: int = 2048) -> dict:
    img = C._test_image(size, size, seed=777)
    data = encode_vardct(img, VarDCTOptions(sharpness=5, custom_restoration=True,
                                            epf_iters=3))
    out = decode_sharded(data, mesh=MESH, apply_filters=True)
    dec = Decoder(data, device="cpu", apply_filters=True, workers=4)
    dec.decode_frame()
    diff = np.abs(out.astype(np.int16) - dec.render_rgba8()[:, :, :3]).max(-1)
    dist = C.lf_border_distance(size, size, group)
    return {str(d): [int(diff[dist == d].max()), int((diff[dist == d] > 1).sum())]
            for d in range(12)} | {"beyond_11": int(diff[dist >= 12].max())}


if __name__ == "__main__":
    print(json.dumps({"column_loop": column_loop(), "border_band": border_band()}))
