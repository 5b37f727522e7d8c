"""finish_ms.tiles (program_span), layer host finish and render: the
frame's finish on the host, the inverse transforms (the inverse RCT of a
lossless tile) and upsampling: the program's `finish` span (its
`reconstruct_s`), mean a request, in ms."""

from jxlbench import spans


def read(ctx):
    return spans.span_mean_ms(ctx, "finish")
