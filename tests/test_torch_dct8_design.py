"""A CPU model of the DCT8 kernels' arithmetic (csrc/reconstruct.cu
`dct8_kernel`, B1 and B2), held against their plain versions
(ops/kernels.py) and the Pallas kernels they replace
(j40_tpu/ops/pallas_kernels.py, in interpret mode off the TPU).

The model follows the kernel strip by strip: a strip is a run of up to
STRIP blocks of one block row (the right edge masked); per block, dequant
with the weight table's reciprocals, CfL, the LLF at position 0, pass 1
(the 8-point IDCT over the row frequency of each canonical row) and pass 2
(over the column frequency), then the colour stage; the strip's raster
rows are written whole.  Every output sample starts as a sentinel, so a
strip that misses a block or writes past the edge fails.

Tolerances: XYB samples within 1e-4 absolute (fp32 sums in another order,
the reciprocal weights); quantized sRGB within 1 level, or at 12 bits
within 1e-5 of the value where pre-clamp sRGB lies far outside [0, maxval]
(fp32's relative error), as tests/test_torch_kernels.py holds the plain
versions.  The inputs come from a numpy seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from j40_tpu.ops import pallas_kernels as PK
from j40_tpu_torch.ops import kernels as K
from j40_tpu_torch.ops import reconstruct as R
from j40_tpu_torch.vardct.dct import inverse_matrix
from test_torch_kernels import _consts22, _inputs, _int_close, _t

FTOL = 1e-4
STRIP = 16  # reconstruct.cu kStrip: blocks per CTA tile
# (h8, w8): one block; ragged planes; rows wider than one strip with a
# ragged right edge (45 = 2 * 16 + 13); five strips, the last of one block
SIZES = [(1, 1), (5, 7), (23, 29), (3, 45), (2, 65)]


def kernel_model(coeffs, aux, weights, consts, h8: int, w8: int, mode: str):
    """The kernel's order of operations in PyTorch (float32).  mode: "xyb"
    (B2), "u8" or "i32" (B1).  Returns the (3, 8*h8, 8*w8) raster."""
    G = torch.from_numpy(np.ascontiguousarray(inverse_matrix(8), np.float32))
    rw = (1.0 / weights).T.reshape(3, 8, 8)  # [c, j, i]: coefficient 8j+i
    gs_inv, qbnum = consts[0], consts[6]
    qm = torch.stack([consts[1], torch.ones_like(consts[1]), consts[2]])
    qb = consts[3:6]
    dtype = {"xyb": torch.float32, "u8": torch.uint8, "i32": torch.int32}[mode]
    sentinel = {"xyb": float("nan"), "u8": 0, "i32": -(1 << 30)}[mode]
    out = torch.full((3, 8 * h8, 8 * w8), sentinel, dtype=dtype)
    written = torch.zeros((8 * h8, 8 * w8), dtype=torch.int32)
    for by in range(h8):
        for bx0 in range(0, w8, STRIP):
            nb = min(STRIP, w8 - bx0)
            b = by * w8 + bx0 + torch.arange(nb)
            q = coeffs[:, b].reshape(3, nb, 8, 8)  # [c, bl, j, i]
            small = q.abs() <= 1.0
            adj = torch.where(small, q * qb[:, None, None, None],
                              q - qbnum / torch.where(small, torch.ones_like(q), q))
            mult = (gs_inv * qm)[:, None] * aux[3, b][None, :]
            v = adj * mult[:, :, None, None] * rw[:, None]
            v = torch.stack([v[0] + v[1] * aux[4, b][:, None, None], v[1],
                             v[2] + v[1] * aux[5, b][:, None, None]])
            v[:, :, 0, 0] = aux[0:3, b]
            u = torch.einsum("yi,cbji->cbjy", G, v)    # pass 1, row j
            o = torch.einsum("xj,cbjy->cbyx", G, u)    # pass 2, sample row y
            if mode != "xyb":
                o = K.xyb_to_srgb_ref(o.reshape(3, nb * 8, 8).contiguous(), consts,
                                      mode == "u8").reshape(3, nb, 8, 8)
            rows = o.permute(0, 2, 1, 3).reshape(3, 8, nb * 8)  # staging rows
            out[:, by * 8:by * 8 + 8, bx0 * 8:(bx0 + nb) * 8] = rows
            written[by * 8:by * 8 + 8, bx0 * 8:(bx0 + nb) * 8] += 1
    assert (written == 1).all(), "strips must cover the plane exactly once"
    return out


def _pallas(q, aux, w, consts, h8, w8, mode):
    args = (jnp.asarray(q), jnp.asarray(aux[0:3]), jnp.asarray(aux[3]),
            jnp.asarray(aux[4]), jnp.asarray(aux[5]), jnp.asarray(w),
            jnp.asarray(consts))
    if mode == "xyb":
        return np.asarray(PK.reconstruct_dct8_pallas(*args, h8, w8))
    ref = np.asarray(PK.reconstruct_dct8_srgb_pallas(*args, h8, w8))
    return np.clip(ref, 0, 255) if mode == "u8" else ref


@pytest.mark.parametrize("mode", ["xyb", "u8", "i32"])
@pytest.mark.parametrize("h8,w8", SIZES)
def test_kernel_model_vs_plain_and_pallas(h8, w8, mode):
    q, aux, w = _inputs(h8, w8, exceptions=True)
    c22 = _consts22(4095.0 if mode == "i32" else 255.0)
    consts = c22[:8] if mode == "xyb" else c22
    got = kernel_model(_t(q), _t(aux), _t(w), _t(consts), h8, w8, mode)
    pallas = _pallas(q, aux, w, consts, h8, w8, mode)
    if mode == "xyb":
        plain = K.reconstruct_dct8_ref(_t(q), _t(aux), _t(w), _t(consts), h8, w8)
        assert torch.isfinite(got).all()
        assert (got - plain).abs().max().item() <= FTOL
        np.testing.assert_allclose(got.numpy(), pallas, rtol=0, atol=FTOL)
    else:
        plain = K.reconstruct_dct8_srgb_ref(_t(q), _t(aux), _t(w), _t(consts), h8, w8,
                                            mode == "u8")
        assert got.dtype == plain.dtype
        _int_close(got.numpy(), plain.numpy())
        _int_close(got.numpy(), pallas)


@pytest.mark.parametrize("h8,w8", [(4, 9), (3, 45)])
def test_kernel_model_zero_cells(h8, w8):
    """A mixed group's dense grid: every third cell (its big-block cells)
    zero in coefficients and aux gives exactly 0 in the model, the plain
    version and the Pallas kernel, never 0/0; the other cells agree."""
    q, aux, w = _inputs(h8, w8, exceptions=True, seed=3)
    q[:, ::3] = 0.0
    aux[:, ::3] = 0.0
    c8 = _consts22(255.0)[:8]
    got = kernel_model(_t(q), _t(aux), _t(w), _t(c8), h8, w8, "xyb")
    plain = K.reconstruct_dct8_ref(_t(q), _t(aux), _t(w), _t(c8), h8, w8)
    pallas = _pallas(q, aux, w, c8, h8, w8, "xyb")

    def cells(x):
        return torch.as_tensor(np.array(x)).reshape(3, h8, 8, w8, 8).permute(0, 1, 3, 2, 4) \
            .reshape(3, h8 * w8, 64)

    for x in (got, plain, pallas):
        assert (cells(x)[:, ::3] == 0).all()
    assert (got - plain).abs().max().item() <= FTOL
    np.testing.assert_allclose(got.numpy(), pallas, rtol=0, atol=FTOL)


def test_kernel_model_is_the_separable_idct():
    """Pass 1 then pass 2 with the 8x8 basis is R.idct2d_batch on the
    canonical (transposed) layout of square blocks."""
    rng = np.random.default_rng(9)
    c = torch.from_numpy(rng.normal(size=(17, 64)).astype(np.float32))
    G = torch.from_numpy(np.ascontiguousarray(inverse_matrix(8), np.float32))
    u = torch.einsum("yi,bji->bjy", G, c.reshape(17, 8, 8))
    o = torch.einsum("xj,bjy->byx", G, u)
    ref = R.idct2d_batch(c, 3, 3)
    assert (o - ref).abs().max().item() <= 1e-5
    np.testing.assert_array_equal(K._basis8(), inverse_matrix(8))


def _swz(bl: int, j: int, h: int) -> int:
    """reconstruct.cu swz(): the 16-byte chunk of half h of canonical row j
    within block bl's 64 floats."""
    return 2 * (j ^ (bl & 3)) + (h ^ (j >> 2))


def test_chunk_swizzle_is_a_conflict_free_permutation():
    """Within a block the swizzle permutes the 16 chunks.  Pass 1 (a
    quarter warp of 16-byte loads: one block, rows 0..7, one half) and
    pass 2 (a warp of 4-byte loads: 4 blocks x columns 0..7, one row j)
    each touch all 32 banks once."""
    for bl in range(8):
        assert sorted(_swz(bl, j, h) for j in range(8) for h in range(2)) == list(range(16))
        for h in range(2):  # pass 1: chunk modulo 8 sets 4 of the 32 banks
            assert len({_swz(bl, j, h) % 8 for j in range(8)}) == 8
    for w0 in range(0, 32, 4):  # a warp's 4 blocks, block stride 64 floats
        for j in range(8):
            banks = {(64 * bl + 4 * _swz(bl, j, y >> 2) + (y & 3)) % 32
                     for bl in range(w0, w0 + 4) for y in range(8)}
            assert len(banks) == 32
