"""host_offcpu_ms.tiles (program_span), layer entry: how long a request's
thread was in the program's host code but not running on a core: the
wall time of its `request` span less its copies', less the thread's CPU
time in the same stretch (the spans' `cpu_ns`), mean a request, in ms.
With more cores than clients, this is mostly the wait for the GIL."""

from jxlbench import spans


def offcpu_ns(recs):
    req = spans.named(recs, "request")
    copies = spans.named(recs, spans.COPY)
    if not req or any(s[spans.CPU] is None for s in req + copies):
        return None
    wall = spans.wall_ns(req) - spans.wall_ns(copies)
    return wall - (spans.cpu_ns(req) - spans.cpu_ns(copies))


def read(ctx):
    return spans.mean_ms(ctx, offcpu_ns)
