"""request_p95_ms (host clock), layer entry: the 95th percentile of the
latency of every request of the window, from when its loop sent it (its
`due`) to its answer, over all clients.  A failed request counts as beyond
any limit: it reads as the window plus the grace period.  In a closed loop
that keeps the card full, a tail follows the rate and swings with the
host, so it is a per-layer metric there."""

from jxlbench import arith, traffic


def read(ctx):
    cap = (ctx.seconds + traffic.GRACE_S) * 1e3
    lat = [min(cap, (r.end - r.due) * 1e3) if r.ok else cap for r in ctx.requests]
    return arith.quantile(lat, 0.95) if lat else None
