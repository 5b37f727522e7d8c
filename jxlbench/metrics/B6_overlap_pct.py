"""B6_overlap_pct (device_trace), layer kernels: the share of the Modular
token kernel B6's device time (csrc/tokens.cu) that ran beside another B6
launch: 100 x (1 - the union of the slice's `tokens_serial_kernel` records
/ their summed time).  0 where the launches run one after another, as
they do on one stream; 50 for two launches that overlap in full."""

from jxlbench import arith

KERNEL = "tokens_serial_kernel"


def read(ctx):
    sl = ctx.slice
    recs = sl.records(KERNEL) if sl is not None else []
    total = sum(e - s for _, s, e in recs)
    if total <= 0:
        return None
    return 100.0 * (1.0 - arith.union((s, e) for _, s, e in recs) / total)
