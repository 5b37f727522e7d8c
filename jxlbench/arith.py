"""The benchmark's arithmetic: window rates, tails over all requests, the
union of device intervals, the least time of a kernel's work at the
published peaks (peaks.json), and what each kernel's work is, counted from
the stream and the image rather than from the kernel's arguments."""

from __future__ import annotations

import json
import math

from jxlbench import spec

PEAKS = json.loads((spec.PKG / "peaks.json").read_text())

#: least 32-bit integer operations per token of a Modular lane: the table
#: index (2), the rANS step or prefix lookup and the bit drops (8), the
#: hybrid-int lookups, shifts and masks (8), the store (2)
TOKEN_OPS = 20
#: least operations per sample of the tree-walking WP reconstruction: the
#: four sub-predictions (30), the error sums and weights (60), the blend
#: and its clamp (25), the error update (25), 8 a level of the tree walk and
#: its leaf (10)
WP_TREE_OPS_PER_LEVEL, WP_TREE_BASE_OPS = 8, 140 + 10


def rate(amount: float, seconds: float) -> float:
    """Work per second over the whole window."""
    return amount / seconds


def quantile(values, q: float) -> float:
    """The q-quantile of every value, by the nearest rank (no interpolation:
    a tail is a latency some request had).  float('inf') stands for a
    failed request, which is beyond any limit."""
    vals = sorted(values)
    if not vals:
        raise ValueError("no values")
    return vals[max(0, math.ceil(q * len(vals)) - 1)]


def union(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, -math.inf
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    out, cur = [], lo
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(a, b) for a, b in out if b > a]


def least_seconds(nbytes: float, nops: float) -> float:
    """The least time for moving `nbytes` through HBM and doing `nops` fp32
    operations at the published peaks: the longer of the two."""
    return max(nbytes / PEAKS["hbm_bytes_per_s"], nops / PEAKS["fp32_ops_per_s"])


def roofline_pct(nbytes: float, nops: float, seconds: float) -> float:
    return 100.0 * least_seconds(nbytes, nops) / seconds


# -- the work of each kernel stage, per image, from the stream and the image


def tokens_work(facts: dict, channels: int = 3) -> tuple[float, float]:
    """B6: each pass-group section byte read once, each token written once
    as int32."""
    samples = channels * facts["width"] * facts["height"]
    return facts["group_bytes"] + 4.0 * samples, TOKEN_OPS * samples


def wp_tree_work(facts: dict, depth: int, channels: int = 3) -> tuple[float, float]:
    """W3: each token read once as int32, each sample written once as int32."""
    samples = channels * facts["width"] * facts["height"]
    return 8.0 * samples, (WP_TREE_BASE_OPS + WP_TREE_OPS_PER_LEVEL * depth) * samples
