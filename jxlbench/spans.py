"""What the readers of the program's spans share.  A decode records its
spans in the stats it returns (`stats["spans"]`), one record a span:
(name, parent index, start_ns, end_ns, cpu_ns, counts), the times on the
wall clock in ns since the epoch, the clock of the device trace's records,
`cpu_ns` the thread's CPU time inside the span, `counts` a dict of
integers or None.  A program that records no spans gives every reader
nothing to read: it returns None."""

from __future__ import annotations

import bisect

from jxlbench import arith, readers

NAME, PARENT, START, END, CPU, COUNTS = range(6)
#: the blocking copies between host and device
COPY = "copy."
#: the slice's records of each direction of copy, by its spans' name
MEMCPY = {"copy.htod": "Memcpy HtoD", "copy.dtoh": "Memcpy DtoH"}
#: the clock fit's search: offsets within WINDOW seconds, drifts in DRIFTS
#: (seconds a second)
WINDOW = 5e-3
DRIFTS = [k * 1e-5 for k in range(-30, 31)]


def records(r) -> list:
    """The span records of a request's decode (none: a program without
    spans, or a request that failed)."""
    spans = r.stats.get("spans") if isinstance(r.stats, dict) else None
    return [s for s in spans or () if s is not None]


def named(recs: list, name: str) -> list:
    """The records called `name`, or starting with it where it ends in a
    dot (`copy.`: every copy)."""
    if name.endswith("."):
        return [s for s in recs if s[NAME].startswith(name)]
    return [s for s in recs if s[NAME] == name]


def wall_ns(recs: list) -> int:
    return sum(s[END] - s[START] for s in recs)


def cpu_ns(recs: list) -> int:
    return sum(s[CPU] for s in recs)


def mean_ms(ctx, value) -> float | None:
    """Mean over the window's completed requests that recorded spans of
    `value(records)` (ns; None leaves the request out), in ms."""
    vals = [value(recs) for r in readers.completed(ctx) if (recs := records(r))]
    vals = [v for v in vals if v is not None]
    return 1e-6 * sum(vals) / len(vals) if vals else None


def span_mean_ms(ctx, name: str) -> float | None:
    """Mean wall time a completed request spent in the spans `name` (none:
    0), in ms; None where no request recorded one."""
    if not any(named(records(r), name) for r in readers.completed(ctx)):
        return None
    return mean_ms(ctx, lambda recs: wall_ns(named(recs, name)))


def merge(intervals) -> list[tuple[float, float]]:
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def overlap(a: list, b: list) -> float:
    """Length of the intersection of two lists of sorted disjoint intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def in_program(recs: list) -> list[tuple[float, float]]:
    """The stretches (seconds) of a request in which its thread was in the
    program's host code: its `request` span less its copies."""
    copies = [(s[START] * 1e-9, s[END] * 1e-9) for s in named(recs, COPY)]
    out = []
    for req in named(recs, "request"):
        out += arith.gaps(copies, req[START] * 1e-9, req[END] * 1e-9)
    return out


def clock_fit(sl, recs: list) -> dict | None:
    """The device records' clock fitted to the spans' over the slice `sl`.
    Every blocking copy of the program lies in its `copy.*` span, so the
    slice's Memcpy records and the copy spans pair one to one; the shift
    t -> t + a + b (t - sl.t0) that puts the most records inside a span of
    their direction is the two clocks' difference.  For each drift b of
    DRIFTS the offsets a (within WINDOW) that hold the most records form
    intervals; the fit takes, of the drifts that hold the most, the one
    nearest 0, and the middle of its widest interval.  Returns {"a", "b", "held",
    "records", "bound"}: `held` of `records` inside after the shift, and
    `bound` the most by which another shift that holds as many moves a time
    of the slice (the attribution's error), seconds; None where the slice
    has no Memcpy record or `recs` no copy span."""
    import numpy as np

    reach = WINDOW + max(abs(b) for b in DRIFTS) * (sl.t1 - sl.t0)
    pairs: list[tuple] = []  # (record, its start, end, a span's start, end)
    total = 0
    for name, dev in MEMCPY.items():
        sp = sorted((s[START] * 1e-9 - sl.t0, s[END] * 1e-9 - sl.t0) for s in named(recs, name))
        if not sp:
            continue
        starts = [x for x, _ in sp]
        ends = np.array([y for _, y in sp])
        for n, r0, r1 in sl.device:
            if not n.startswith(dev) or not sl.t0 <= r0 <= sl.t1:
                continue
            r0, r1 = r0 - sl.t0, r1 - sl.t0
            hi = bisect.bisect_right(starts, r0 + reach)
            for k in np.nonzero(ends[:hi] >= r1 - reach)[0]:
                pairs.append((total, r0, r1, sp[k][0], sp[k][1]))
            total += 1
    if not pairs:
        return None
    rid, r0, r1, s0, s1 = (np.array(c) for c in zip(*pairs))
    found = []  # (records held, drift, runs of offsets that hold them)
    for b in DRIFTS:
        x, y = s0 - r0 * (1 + b), s1 - r1 * (1 + b)
        keep = (y >= x) & (y >= -WINDOW) & (x <= WINDOW)
        if not keep.any():
            continue
        g = rid[keep]
        x, y = np.clip(x[keep], -WINDOW, WINDOW) + g, np.clip(y[keep], -WINDOW, WINDOW) + g
        # each record's offsets as disjoint closed intervals (records kept
        # apart by adding their index), so a record counts once
        o = np.lexsort((x, g))
        x, y, g = x[o], y[o], g[o]
        reach_y = np.maximum.accumulate(y)
        first = np.r_[True, x[1:] > reach_y[:-1]]
        last = np.r_[first[1:], True]
        lo, hi = x[first] - g[first], reach_y[last] - g[first]
        pts = np.r_[lo, hi]
        step = np.r_[np.ones(len(lo)), -np.ones(len(hi))]
        o = np.lexsort((-step, pts))
        pts, count = pts[o], np.cumsum(step[o])
        most = int(count.max())
        at = np.nonzero(count == most)[0]
        found.append((most, b, [(float(pts[i]), float(pts[i + 1])) for i in at]))
    if not found:
        return None
    most = max(m for m, _, _ in found)
    _, b, runs = min((f for f in found if f[0] == most), key=lambda f: abs(f[1]))
    x, y = max(runs, key=lambda r: r[1] - r[0])
    a = (x + y) / 2
    bound = max(abs(e - a + (bb - b) * t) for m, bb, runs in found if m == most
                for run in runs for e in run for t in (0.0, sl.t1 - sl.t0))
    return {"a": a, "b": b, "held": most, "records": total, "bound": bound}


def shifted(sl, fit: dict | None) -> list:
    """The slice's device records on the spans' clock (`clock_fit`)."""
    if fit is None:
        return list(sl.device)
    a, b = fit["a"], fit["b"]
    return [(n, s + a + b * (s - sl.t0), e + a + b * (e - sl.t0)) for n, s, e in sl.device]
