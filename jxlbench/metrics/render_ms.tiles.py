"""render_ms.tiles (program_span), layer host finish and render: the
render of the frame to host RGBA, the program's `render` span, mean a
request, in ms."""

from jxlbench import spans


def read(ctx):
    return spans.span_mean_ms(ctx, "render")
