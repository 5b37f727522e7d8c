"""Special 8x8 inverse transforms: DCT2x2, DCT4x4, Hornuss, DCT4x8/8x4, AFV
(reference j40.h:5992-6246).

All operate on a flat 64-float coefficient buffer and return an (8, 8) sample
block.  These run host-side or as a batched device gather — they are rare in
practice compared to true DCT blocks.
"""

from __future__ import annotations

import functools

import numpy as np

from .dct import inverse_matrix


def _aux_idct11(out: np.ndarray, inp: np.ndarray, x: int, y: int, s2: int) -> None:
    p, q = y * 8 + x, (y * 2) * 8 + (x * 2)
    c00, c01, c10, c11 = inp[p], inp[p + s2], inp[p + s2 * 8], inp[p + s2 * 9]
    out[q] = c00 + c01 + c10 + c11
    out[q + 1] = c00 + c01 - c10 - c11
    out[q + 8] = c00 - c01 + c10 - c11
    out[q + 9] = c00 - c01 - c10 + c11


def inverse_dct11(buf: np.ndarray) -> np.ndarray:
    """DCT2x2 (j40.h:6002-6013)."""
    buf = buf.astype(np.float32).copy()
    _aux_idct11(buf, buf.copy(), 0, 0, 1)
    scratch = buf.copy()
    for y in range(2):
        for x in range(2):
            _aux_idct11(scratch, buf, x, y, 2)
    out = scratch.copy()
    for y in range(4):
        for x in range(4):
            _aux_idct11(out, scratch, x, y, 4)
    return out.reshape(8, 8)


def inverse_dct22(buf: np.ndarray) -> np.ndarray:
    """DCT4x4 (j40.h:6015-6044)."""
    buf = buf.astype(np.float32).copy()
    _aux_idct11(buf, buf.copy(), 0, 0, 1)
    G4 = inverse_matrix(4)
    # columnar IDCT over the 8x8 grid seen as 4-row stacks (j40__inverse_dct
    # with t=2, rep=16): treat buf as (4, 16) and IDCT along axis 0
    m = buf.reshape(4, 16)
    m = G4 @ m
    # transpose as flat 8x8
    t = m.reshape(8, 8).T.copy()
    m2 = (G4 @ t.reshape(4, 16)).reshape(8, 8)
    out = np.empty((8, 8), dtype=np.float32)
    for y in range(4):
        for x in range(4):
            out[y, x] = m2[y * 2, x * 2]
            out[y, x + 4] = m2[y * 2 + 1, x * 2]
            out[y + 4, x] = m2[y * 2, x * 2 + 1]
            out[y + 4, x + 4] = m2[y * 2 + 1, x * 2 + 1]
    return out


def inverse_hornuss(buf: np.ndarray) -> np.ndarray:
    """Hornuss (j40.h:6046-6065)."""
    buf = buf.astype(np.float32)
    scratch = buf.copy()
    _aux_idct11(scratch, buf, 0, 0, 1)
    out = np.empty((8, 8), dtype=np.float32)
    for y in range(2):
        for x in range(2):
            pos00 = y * 8 + x
            pos11 = (y + 2) * 8 + (x + 2)
            rsum = 0.0
            for iy in range(4):
                for ix in range(4):
                    rsum += scratch[(y + iy * 2) * 8 + (x + ix * 2)]
            sample11 = scratch[pos00] - (rsum - scratch[pos00]) * 0.0625
            save00 = scratch[pos11]
            scratch[pos00] = save00
            scratch[pos11] = 0.0
            for iy in range(4):
                for ix in range(4):
                    out[4 * y + iy, 4 * x + ix] = (
                        scratch[(y + iy * 2) * 8 + (x + ix * 2)] + sample11
                    )
    return out


def inverse_dct32(buf: np.ndarray) -> np.ndarray:
    """DCT8x4 ("DCT32": 8 rows, 4 columns halves) (j40.h:6067-6085)."""
    b = buf.astype(np.float32).copy()
    # butterfly on flat positions 0 and 8 (J40__AT(v,0,1) == buf[8])
    tmp = b[0] + b[8]
    b[8] = b[0] - b[8]
    b[0] = tmp
    # reshape to (w=16, h=4): row-major flat reinterpret
    m = b.reshape(4, 16)  # matrix (h=4, w=16)
    G4, G8 = inverse_matrix(4), inverse_matrix(8)
    m = G4 @ m  # IDCT along h (len 4)
    # reshape back to (8, 8) then transpose
    t = m.ravel().reshape(8, 8).T.copy()  # (h=8, w=8)
    t = G8 @ t  # IDCT along h (len 8)
    # odd/even columns to halves: out(x, y) = t(y, 2x) for x<4, t(y, 2x+1-8)...
    out = np.empty((8, 8), dtype=np.float32)
    out[:, 0:4] = t[:, 0::2]
    out[:, 4:8] = t[:, 1::2]
    return out


def inverse_dct23(buf: np.ndarray) -> np.ndarray:
    """DCT4x8 ("DCT23") (j40.h:6087-6104)."""
    b = buf.astype(np.float32).copy()
    s = b.copy()
    s[0] = b[0] + b[8]  # J40__AT(v,0,1) == flat position 8
    s[8] = b[0] - b[8]
    s = s.reshape(8, 8)
    G4, G8 = inverse_matrix(4), inverse_matrix(8)
    t = s.T.copy()
    t = G8 @ t  # IDCT along len-8 axis
    # transpose back, reshape (4, 16), IDCT along len 4
    m = t.T.copy().ravel().reshape(4, 16)
    m = G4 @ m
    r = m.ravel().reshape(8, 8)
    # odd/even ROWS to halves
    out = np.empty((8, 8), dtype=np.float32)
    out[0:4, :] = r[0::2, :]
    out[4:8, :] = r[1::2, :]
    return out


# AFV basis, transposed (j40.h:6108-6173): AFV_BASIS[i][j] = basis j at pos i
AFV_BASIS = np.array(
    [
        [0.25000000, 0.87690293, 0.00000000, 0.00000000,
         0.00000000, -0.41053776, 0.00000000, 0.00000000,
         0.00000000, 0.00000000, 0.00000000, 0.00000000,
         0.00000000, 0.00000000, 0.00000000, 0.00000000],
        [0.25000000, 0.22065181, 0.00000000, 0.00000000,
         -0.70710678, 0.62354854, 0.00000000, 0.00000000,
         0.00000000, 0.00000000, 0.00000000, 0.00000000,
         0.00000000, 0.00000000, 0.00000000, 0.00000000],
        [0.25000000, -0.10140050, 0.40670076, -0.21255748,
         0.00000000, -0.06435072, -0.45175566, -0.30468475,
         0.30179295, 0.40824829, 0.17478670, -0.21105601,
         -0.14266085, -0.13813540, -0.17437603, 0.11354987],
        [0.25000000, -0.10140050, 0.44444817, 0.30854971,
         0.00000000, -0.06435072, 0.15854504, 0.51126161,
         0.25792363, 0.00000000, 0.08126112, 0.18567181,
         -0.34164468, 0.33022826, 0.07027907, -0.07417505],
        [0.25000000, 0.22065181, 0.00000000, 0.00000000,
         0.70710678, 0.62354854, 0.00000000, 0.00000000,
         0.00000000, 0.00000000, 0.00000000, 0.00000000,
         0.00000000, 0.00000000, 0.00000000, 0.00000000],
        [0.25000000, -0.10140050, 0.00000000, 0.47067023,
         0.00000000, -0.06435072, -0.04038515, 0.00000000,
         0.16272340, 0.00000000, 0.00000000, 0.00000000,
         0.73674975, 0.08755115, -0.29210266, 0.19402893],
        [0.25000000, -0.10140050, 0.19574399, -0.16212052,
         0.00000000, -0.06435072, 0.00741823, -0.29048013,
         0.09520023, 0.00000000, -0.36753980, 0.49215859,
         0.24627108, -0.07946707, 0.36238173, -0.43519050],
        [0.25000000, -0.10140050, 0.29291001, 0.00000000,
         0.00000000, -0.06435072, 0.39351034, -0.06578702,
         0.00000000, -0.40824829, -0.30788221, -0.38525014,
         -0.08574019, -0.46133749, 0.00000000, 0.21918685],
        [0.25000000, -0.10140050, -0.40670076, -0.21255748,
         0.00000000, -0.06435072, -0.45175566, 0.30468475,
         0.30179295, -0.40824829, -0.17478670, 0.21105601,
         -0.14266085, -0.13813540, -0.17437603, 0.11354987],
        [0.25000000, -0.10140050, -0.19574399, -0.16212052,
         0.00000000, -0.06435072, 0.00741823, 0.29048013,
         0.09520023, 0.00000000, 0.36753980, -0.49215859,
         0.24627108, -0.07946707, 0.36238173, -0.43519050],
        [0.25000000, -0.10140050, 0.00000000, -0.47067023,
         0.00000000, -0.06435072, 0.11074166, 0.00000000,
         -0.16272340, 0.00000000, 0.00000000, 0.00000000,
         0.14883399, 0.49724647, 0.29210266, 0.55504438],
        [0.25000000, -0.10140050, 0.11379074, -0.14642919,
         0.00000000, -0.06435072, 0.08298163, -0.23889774,
         -0.35312385, -0.40824829, 0.48266891, 0.17419413,
         -0.04768680, 0.12538059, -0.43266080, -0.25468277],
        [0.25000000, -0.10140050, -0.44444817, 0.30854971,
         0.00000000, -0.06435072, 0.15854504, -0.51126161,
         0.25792363, 0.00000000, -0.08126112, -0.18567181,
         -0.34164468, 0.33022826, 0.07027907, -0.07417505],
        [0.25000000, -0.10140050, -0.29291001, 0.00000000,
         0.00000000, -0.06435072, 0.39351034, 0.06578702,
         0.00000000, 0.40824829, 0.30788221, 0.38525014,
         -0.08574019, -0.46133749, 0.00000000, 0.21918685],
        [0.25000000, -0.10140050, -0.11379074, -0.14642919,
         0.00000000, -0.06435072, 0.08298163, 0.23889774,
         -0.35312385, 0.40824829, -0.48266891, -0.17419413,
         -0.04768680, 0.12538059, -0.43266080, -0.25468277],
        [0.25000000, -0.10140050, 0.00000000, 0.42511496,
         0.00000000, -0.06435072, -0.45175566, 0.00000000,
         -0.60358590, 0.00000000, 0.00000000, 0.00000000,
         -0.14266085, -0.13813540, 0.34875205, 0.11354987],
    ],
    dtype=np.float32,
)


def inverse_afv(buf: np.ndarray, flipx: int, flipy: int) -> np.ndarray:
    """AFV0-3 (j40.h:6183-6246)."""
    buf = buf.astype(np.float32)
    G4, G8 = inverse_matrix(4), inverse_matrix(8)

    scratch_afv = np.empty(16, dtype=np.float32)
    scratch22 = np.empty(16, dtype=np.float32)
    scratch32 = np.empty(32, dtype=np.float32)
    for y in range(0, 8, 2):
        for x in range(8):
            scratch_arr = scratch22 if x % 2 else scratch_afv
            scratch_arr[(y // 2) * 4 + (x // 2)] = buf[y * 8 + x]
    for y in range(1, 8, 2):
        for x in range(8):
            scratch32[x * 4 + (y // 2)] = buf[y * 8 + x]
    scratch_afv[0] = (buf[0] + buf[1] + buf[8]) * 4.0
    scratch22[0] = buf[0] - buf[1] + buf[8]
    scratch32[0] = buf[0] - buf[8]

    afv = AFV_BASIS @ scratch_afv  # 16 samples
    b22 = (G4 @ scratch22.reshape(4, 4)).ravel()
    b32 = (G8 @ scratch32.reshape(8, 4)).ravel()

    s_afv = afv.reshape(4, 4)
    s22 = np.empty((4, 4), dtype=np.float32)
    for y in range(4):
        for x in range(4):
            s22[x, y] = b22[y * 4 + x]  # transposed
    s23 = np.empty((4, 8), dtype=np.float32)
    for y in range(8):
        for x in range(4):
            s23[x, y] = b32[y * 4 + x]  # transposed

    b22f = (G4 @ s22).ravel()
    b23f = (G4 @ s23).ravel()

    out = np.empty((8, 8), dtype=np.float32)
    FLIP = ((0, 1, 2, 3), (7, 6, 5, 4))
    for y in range(4):
        afv_row = FLIP[flipy][y]
        dct22_row = flipy * 4 + y
        dct23_row = (0 if flipy else 4) + y
        for x in range(4):
            out[afv_row, FLIP[flipx][x]] = s_afv[y, x]
            out[dct22_row, (0 if flipx else 4) + x] = b22f[y * 4 + x]
        for x in range(8):
            out[dct23_row, x] = b23f[y * 8 + x]
    return out


# dctsel values realized as dense (64, 64) operators; pure numpy so the
# native host plan (vardct/native_combine.py) carries no jax dependency
_SPECIAL_FNS = {
    1: lambda b: inverse_hornuss(b),
    2: lambda b: inverse_dct11(b),
    3: lambda b: inverse_dct22(b),
    12: lambda b: inverse_dct23(b),
    13: lambda b: inverse_dct32(b),
    14: lambda b: inverse_afv(b, 0, 0),
    15: lambda b: inverse_afv(b, 1, 0),
    16: lambda b: inverse_afv(b, 0, 1),
    17: lambda b: inverse_afv(b, 1, 1),
}


@functools.lru_cache(maxsize=None)
def special_matrix(dctsel: int) -> np.ndarray:
    """(64, 64) matrix M with samples.ravel() == M @ coeffs (float32)."""
    fn = _SPECIAL_FNS[dctsel]
    cols = []
    for i in range(64):
        e = np.zeros(64, dtype=np.float32)
        e[i] = 1.0
        cols.append(fn(e).ravel())
    return np.stack(cols, axis=1).astype(np.float32)
