"""idle_in_host_ms.tiles (device_trace), layer device: the device's idle
time in the traced slice (its window less the union of every CUDA
activity interval) during which at least one client thread was in the
program's host code (the union over every request of its `request` span
less its `copy.*` spans), over the requests' worth of work the slice
holds, in ms.  The device records are first put on the spans' clock by
the fit of the copy spans to the Memcpy records (`spans.clock_fit`)."""

from jxlbench import arith, readers, spans


def read(ctx):
    sl = ctx.slice
    reqs = readers.requests_in_slice(ctx)
    if sl is None or not reqs:
        return None
    host = [iv for r in ctx.requests for iv in spans.in_program(spans.records(r))]
    if not host:
        return None
    dev = spans.shifted(sl, spans.clock_fit(sl, [s for r in ctx.requests
                                                 for s in spans.records(r)]))
    busy = [(max(s, sl.t0), min(e, sl.t1)) for _, s, e in dev if e > sl.t0 and s < sl.t1]
    idle = arith.gaps(busy, sl.t0, sl.t1)
    return 1e3 * spans.overlap(idle, spans.merge(host)) / reqs

