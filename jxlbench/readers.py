"""What the metric readers (metrics/<name>.py) share: the requests of the
window, means of the program's own stage clocks, and the work and time of a
kernel in the traced slice."""

from __future__ import annotations

from jxlbench import arith


def completed(ctx) -> list:
    """Requests that returned an answer inside the window."""
    return [r for r in ctx.requests if r.ok and r.end <= ctx.t1]


def stat_mean_ms(ctx, *path: str) -> float | None:
    """Mean over the window's completed requests of the program's stage
    clock at `path` in the stats it returned (seconds), in ms.  None where
    the program reported no such clock."""
    vals = []
    for r in completed(ctx):
        v = r.stats
        for k in path:
            v = v.get(k) if isinstance(v, dict) else None
        if v is not None:
            vals.append(float(v))
    return 1e3 * sum(vals) / len(vals) if vals else None


def mean_work(ctx, work) -> tuple[float, float]:
    """(bytes, operations) of one request, averaged over the corpus."""
    w = [work(f) for f in ctx.facts]
    return sum(b for b, _ in w) / len(w), sum(o for _, o in w) / len(w)


def covered(ctx, counter: str, marker) -> float | None:
    """How many requests' worth of `counter`'s launches ran in the slice:
    its marker kernel's records over its launches a request (warm-up)."""
    sl = ctx.slice
    per = ctx.per_request.get(counter, 0)
    if sl is None or per <= 0:
        return None
    n = len(sl.records(marker))
    return n / per if n else None


def roofline(ctx, counter: str, marker, kernels, work) -> float | None:
    """The kernel's share of its roofline in the slice, in %: the least time
    of the work its records did, at the published peaks, over their device
    time.  None when the slice holds none of its records."""
    reqs = covered(ctx, counter, marker)
    if reqs is None:
        return None
    secs = ctx.slice.seconds(kernels)
    if secs <= 0:
        return None
    nbytes, nops = mean_work(ctx, work)
    return arith.roofline_pct(reqs * nbytes, reqs * nops, secs)


def requests_in_slice(ctx) -> float | None:
    """Requests' worth of work the slice holds, by the counted kernel with
    the most launches a request (the finest grain)."""
    from jxlbench.trace import MARKERS

    best = None
    for counter, per in ctx.per_request.items():
        if per > 0 and counter in MARKERS and (best is None or per > ctx.per_request[best]):
            best = counter
    return covered(ctx, best, MARKERS[best]) if best else None
