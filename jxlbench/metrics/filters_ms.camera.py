"""filters_ms.camera (program_span), layer filters: the frame-level stage
of the restoration filters (ops/combine.py `filter_frame`): the LF groups'
XYB planes put together into the frame's plane, gaborish (and EPF where
the frame has it) over it, up to the colour kernel's launch: the wall time
of the program's `filters` span, mean a request, in ms.  The launches
queue on the decode's stream; their device time is B9_roofline's."""

from jxlbench import spans


def read(ctx):
    return spans.span_mean_ms(ctx, "filters")
