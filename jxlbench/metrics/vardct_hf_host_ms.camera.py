"""vardct_hf_host_ms.camera (program_span), layer host entropy: the
VarDCT pass-group sections the program decodes on the host (those holding
a varblock larger than DCT8, which the card's HF route does not take): the
wall time of the program's `vardct.hf_host` spans (vardct/state.py: one a
section, on the decode's pool threads, so several run at once), summed a
frame, mean a request, in ms."""

from jxlbench import spans


def read(ctx):
    return spans.span_mean_ms(ctx, "vardct.hf_host")
