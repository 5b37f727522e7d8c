"""B2_roofline (device_trace), layer kernels: the dequantization and 8x8
inverse DCT of the frame's dense grid (csrc/reconstruct.cu
dct8_kernel<kXyb>, one launch an LF group) against its roofline.  Work a
frame (vardct_work.dense_idct_work): each 8x8 cell's 64 coefficients a
channel read once and its XYB samples written once as float32, from the
frame's size; at the published peaks (peaks.json), over the device time
of its records in the slice.  The filtered route runs no other instance
of the kernel (B1, dct8_kernel<kSrgbU8>, makes no XYB plane)."""

from jxlbench import readers, vardct_work

KERNELS = ("dct8_kernel",)
COUNTER, MARKER = "reconstruct_dct8", "dct8_kernel"


def read(ctx):
    return readers.roofline(ctx, COUNTER, MARKER, KERNELS, vardct_work.dense_idct_work)
