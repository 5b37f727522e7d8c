"""B6_roofline (device_trace), layer kernels: the Modular token kernel B6
(csrc/tokens.cu) against its roofline.  Work a tile, from the stream and
the image (arith.tokens_work): each pass-group section byte read once, each
token written once as int32, 20 operations a token; at the published peaks
(peaks.json), over the device time of its records in the slice.  Its
prefix lanes' sync kernels share their names with B4's and are not read."""

from jxlbench import arith, readers

KERNELS = ("tokens_serial_setup", "tokens_serial_kernel", "tokens_sync_setup")
COUNTER, MARKER = "tokens", ("tokens_serial_setup", "tokens_sync_setup")


def read(ctx):
    return readers.roofline(ctx, COUNTER, MARKER, KERNELS, arith.tokens_work)
