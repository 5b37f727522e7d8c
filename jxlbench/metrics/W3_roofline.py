"""W3_roofline (device_trace), layer kernels: the tree-walking WP wavefront
W3 (csrc/wavefront.cu wp_wavefront_kernel<kTree>) against its roofline.
Work a tile (arith.wp_tree_work): each token read once and each sample
written once as int32, the WP predictor's and the tree walk's operations a
sample at the configuration's tree depth (TREE_DEPTH of its module)."""

from jxlbench import arith, readers

KERNELS = ("wp_wavefront_kernel",)
COUNTER, MARKER = "wavefront_tree", "wp_wavefront_kernel"


def read(ctx):
    depth = getattr(ctx.cell.codec, "TREE_DEPTH", None)
    if depth is None:
        return None
    return readers.roofline(ctx, COUNTER, MARKER, KERNELS,
                            lambda f: arith.wp_tree_work(f, depth))
