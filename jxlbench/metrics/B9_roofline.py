"""B9_roofline (device_trace), layer kernels: gaborish (csrc/filters.cu
gaborish_kernel) over the whole frame's XYB plane against its roofline.
Work a frame (vardct_work.gaborish_work): the (3, H, W) float32 plane of
the frame's 8x8 grid read once and written once; at the published peaks
(peaks.json), over the device time of its records in the slice."""

from jxlbench import readers, vardct_work

KERNELS = ("gaborish_kernel",)
COUNTER, MARKER = "gaborish", "gaborish_kernel"


def read(ctx):
    return readers.roofline(ctx, COUNTER, MARKER, KERNELS, vardct_work.gaborish_work)
