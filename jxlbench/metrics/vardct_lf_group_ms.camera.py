"""vardct_lf_group_ms.camera (program_span), layer host entropy: the
VarDCT LF-group sections (the dequantised LF, the varblock placement and
the LLF of the varblocks larger than DCT8), which the program reads on its
pool threads before any pass-group section starts: the wall time of the
program's `vardct.lf_group` spans (vardct/state.py: one an LF group, so
several run at once), summed a frame, mean a request, in ms."""

from jxlbench import spans


def read(ctx):
    return spans.span_mean_ms(ctx, "vardct.lf_group")
