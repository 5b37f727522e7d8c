"""The work of the VarDCT route's kernels a frame, counted from the stream
and the image rather than from the kernels' arguments (arith.py's
counterpart for the lossy cells; the published peaks and the roofline
arithmetic are arith.py's).  The frame's 8x8 grid is its size rounded up to
a multiple of 8, which the kernels cover."""

from __future__ import annotations

#: least float32 operations a sample of B2's 8x8 inverse DCT: two passes
#: of 8 multiply-adds a sample (32), the dequantization (3)
IDCT8_OPS = 2 * 8 * 2 + 3
#: least float32 operations a sample of gaborish: 9 multiplies, 8 adds
GABORISH_OPS = 17


def _grid(facts: dict) -> tuple[int, int]:
    return -(-facts["height"] // 8), -(-facts["width"] // 8)


def dense_idct_work(facts: dict) -> tuple[float, float]:
    """B2 (csrc/reconstruct.cu dct8_kernel<kXyb>) over the frame's dense 8x8
    grid, every cell a DCT8 block (the cells under larger varblocks
    decode to zero there and are overlaid after): each coefficient read
    once and each XYB sample written once as float32, with the cell's six
    dequantization and chroma-from-luma factors read once."""
    h8, w8 = _grid(facts)
    cells = h8 * w8
    samples = 3 * 64 * cells
    return 4.0 * samples * 2 + 4.0 * 6 * cells, IDCT8_OPS * samples


def gaborish_work(facts: dict) -> tuple[float, float]:
    """B9 (csrc/filters.cu gaborish_kernel) over the frame's (3, H, W)
    float32 XYB plane: each sample read once and written once."""
    h8, w8 = _grid(facts)
    samples = 3 * 64 * h8 * w8
    return 8.0 * samples, GABORISH_OPS * samples
