"""copy_wait_ms.tiles (program_span), layer upload / fetch: the wall time a
request's thread spent in the program's blocking copies between host and
device (its `copy.htod` and `copy.dtoh` spans), mean a request, in ms.  A
blocking copy waits for the work queued before it on the stream, the other
clients' too, so this is the copies' device time (`copy_ms_per_image`) and
the wait behind that work."""

from jxlbench import spans


def read(ctx):
    return spans.span_mean_ms(ctx, spans.COPY)
