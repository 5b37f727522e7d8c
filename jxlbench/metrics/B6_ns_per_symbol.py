"""B6_ns_per_symbol (device_trace), layer kernels: the latency figure of
the Modular token kernel B6 (csrc/tokens.cu), whose lanes are serial: the
mean device time of a `tokens_serial_kernel` record in the traced slice,
over the symbols of the longest lane of a launch (the `longest_lane` count
of the program's `modular.batch` spans, one a launch, mean over the
window's completed requests), in ns."""

from jxlbench import readers, spans

KERNEL = "tokens_serial_kernel"


def read(ctx):
    sl = ctx.slice
    recs = sl.records(KERNEL) if sl is not None else []
    longest = [s[spans.COUNTS]["longest_lane"] for r in readers.completed(ctx)
               for s in spans.named(spans.records(r), "modular.batch")
               if (s[spans.COUNTS] or {}).get("longest_lane")]
    if not recs or not longest:
        return None
    per_record = sum(e - s for _, s, e in recs) / len(recs)
    return 1e9 * per_record / (sum(longest) / len(longest))
