"""Dequantization matrix reading & synthesis (reference j40.h:4696-4972,
spec I.2).

load_dq_matrix returns an (rows*columns, 3) float32 array of weights in the
canonical coefficient layout (the divisor table for dequantization).
"""

from __future__ import annotations

import numpy as np

from ...frozen.errors import J40Error, check
from ...frozen.io.bits import BitReader
from .tables import (
    DCT_PARAMS,
    DQ_AFV,
    DQ_DCT,
    DQ_DCT2,
    DQ_DCT4,
    DQ_DCT4X8,
    DQ_HORNUSS,
    DQ_LIBRARY,
    DQ_RAW,
    LIBRARY_DCT_PARAMS,
)


class DqMatrix:
    __slots__ = ("mode", "n", "m", "params")

    def __init__(self, mode=DQ_LIBRARY, n=0, m=0, params=None):
        self.mode = mode
        self.n = n
        self.m = m
        self.params = params  # list of (x,y,b) rows, or (rows*cols, 3) array for RAW


def read_dq_matrix(
    r: BitReader,
    rows: int,
    columns: int,
    raw_sidx: int,
    global_tree,
    global_codespec,
    limits,
) -> DqMatrix:
    """Parse one dq matrix header (j40.h:4696-4777)."""
    mode = r.u(3)
    dq = DqMatrix(mode=mode)
    if mode == DQ_RAW:
        from ..modular.decode import Channel, ModularImage, allocate, decode_channel, parse_modular_header
        from ..modular.transforms import inverse_transforms

        denom = r.f16()
        check(abs(denom) > 1e-8, "dqm0")
        m = ModularImage(channels=[Channel(columns, rows) for _ in range(3)])
        parse_modular_header(r, m, global_tree, global_codespec, limits)
        allocate(m)
        for c in range(m.num_channels):
            decode_channel(r, m, c, raw_sidx)
        m.code.finish(r)
        inverse_transforms(m, 8)
        params = np.empty((rows * columns, 3), dtype=np.float32)
        for c in range(3):
            params[:, c] = m.channels[c].data.astype(np.float32).ravel() / denom
        dq.params = params
        dq.n, dq.m = rows, columns
        return dq

    # (requires8x8, nparams, nscaled, ndctparams)
    HOW = (
        (0, 0, 0, 0),
        (1, 3, 3, 0),
        (1, 6, 6, 0),
        (1, 2, 2, 1),
        (1, 1, 0, 1),
        (1, 9, 6, 2),
        (1, 0, 0, 1),
    )
    req8, nparams, nscaled, ndct = HOW[mode]
    if req8:
        check(rows == 8 and columns == 8, "dqm?")
    if nparams + ndct:
        params: list[list[float]] = [[0.0] * 3 for _ in range(nparams)]
        for c in range(3):
            for j in range(nparams):
                params[j][c] = r.f16() * (64.0 if j < nscaled else 1.0)
        for i in range(ndct):  # ReadDctParams
            n = r.u(4) + 1
            if i == 0:
                dq.n = n
            else:
                dq.m = n
            block = [[0.0] * 3 for _ in range(n)]
            for c in range(3):
                for j in range(n):
                    block[j][c] = r.f16() * (64.0 if j == 0 else 1.0)
            params.extend(block)
        dq.params = [tuple(p) for p in params]
    return dq


def interpolate(pos: float, c: int, bands, length: int) -> float:
    """Piecewise exponential interpolation (j40.h:4780-4790)."""
    if length == 1:
        return bands[0][c]
    scaled_pos = pos * (length - 1)
    idx = int(scaled_pos)
    frac = scaled_pos - idx
    a = bands[idx][c]
    b = bands[idx + 1][c]
    return float(a * (b / a) ** frac)


def interpolation_bands(params, n: int):
    """Band synthesis with positivity checks (j40.h:4792-4809)."""
    out = [[0.0] * 3 for _ in range(n)]
    for c in range(3):
        out[0][c] = params[0][c]
        check(out[0][c] > 0, "band")
        for i in range(1, n):
            v = params[i][c]
            out[i][c] = out[i - 1][c] * (1.0 + v) if v > 0 else out[i - 1][c] / (1.0 - v)
            check(out[i][c] > 0, "band")
    return out


def dct_quant_weights(rows: int, columns: int, bands, length: int) -> np.ndarray:
    """(rows*columns, 3) weight table (j40.h:4811-4824)."""
    INV_SQRT2 = 1.0 / 1.414214562373095
    out = np.empty((rows * columns, 3), dtype=np.float32)
    inv_r = 1.0 / (rows - 1) if rows > 1 else 0.0
    inv_c = 1.0 / (columns - 1) if columns > 1 else 0.0
    for c in range(3):
        for y in range(rows):
            for x in range(columns):
                d = float(np.hypot(x * inv_c, y * inv_r))
                out[y * columns + x, c] = interpolate(d * INV_SQRT2, c, bands, length)
    return out


# DCT2 parameter map (j40.h:4879-4889)
_DCT2_MAP = (
    0, 0, 2, 2, 4, 4, 4, 4,
    0, 1, 2, 2, 4, 4, 4, 4,
    2, 2, 3, 3, 4, 4, 4, 4,
    2, 2, 3, 3, 4, 4, 4, 4,
    4, 4, 4, 4, 5, 5, 5, 5,
    4, 4, 4, 4, 5, 5, 5, 5,
    4, 4, 4, 4, 5, 5, 5, 5,
    4, 4, 4, 4, 5, 5, 5, 5,
)

# AFV scratch index map (j40.h:4943-4954)
_AFV_MAP = (
    60, 32, 62, 33, 48, 34, 49, 35,
    0, 1, 2, 3, 4, 5, 6, 7,
    61, 36, 63, 37, 50, 38, 51, 39,
    8, 9, 10, 11, 12, 13, 14, 15,
    52, 40, 53, 41, 54, 42, 55, 43,
    16, 17, 18, 19, 20, 21, 22, 23,
    56, 44, 57, 45, 58, 46, 59, 47,
    24, 25, 26, 27, 28, 29, 30, 31,
)

# precomputed (freqs[i]-lo)/(hi-lo+1e-6) (j40.h:4931-4934)
_AFV_FREQS = (
    0.000000000, 0.373436417, 0.320380100, 0.379332596, 0.066671353, 0.259756761,
    0.530035651, 0.789731061, 0.149436598, 0.559318823, 0.669198646, 0.999999917,
)


def load_dq_matrix(param_idx: int, dq: DqMatrix) -> np.ndarray:
    """Synthesize the final (rows*columns, 3) weight table (j40.h:4828-4972)."""
    dct = DCT_PARAMS[param_idx]
    log_rows, log_columns = dct[0], dct[1]
    mode = dq.mode
    if mode == DQ_RAW:
        return dq.params
    if mode == DQ_LIBRARY:
        mode = dct[3]
        n, m = dct[4], dct[5]
        params = LIBRARY_DCT_PARAMS[dct[2] :]
    else:
        n, m = dq.n, dq.m
        params = dq.params

    rows, columns = 1 << log_rows, 1 << log_columns
    raw = np.empty((rows * columns, 3), dtype=np.float32)

    if mode == DQ_DCT:
        bands = interpolation_bands(params, n)
        raw = dct_quant_weights(rows, columns, bands, n)
    elif mode == DQ_DCT4:
        bands = interpolation_bands(params[2:], n)
        scratch = dct_quant_weights(4, 4, bands, n)
        for c in range(3):
            for y in range(8):
                for x in range(8):
                    raw[y * 8 + x, c] = scratch[(y // 2) * 4 + (x // 2), c]
            raw[1, c] /= params[0][c]
            raw[8, c] /= params[0][c]
            raw[9, c] /= params[1][c]
    elif mode == DQ_DCT2:
        for c in range(3):
            for i in range(64):
                raw[i, c] = params[_DCT2_MAP[i]][c]
            raw[0, c] = -1.0
    elif mode == DQ_HORNUSS:
        for c in range(3):
            raw[:, c] = params[0][c]
            raw[0, c] = 1.0
            raw[1, c] = raw[8, c] = params[1][c]
            raw[9, c] = params[2][c]
    elif mode == DQ_DCT4X8:
        bands = interpolation_bands(params[1:], n)
        scratch = dct_quant_weights(4, 8, bands, n)
        for c in range(3):
            for y in range(8):
                for x in range(8):
                    raw[y * 8 + x, c] = scratch[(y // 2) * 8 + x, c]
            raw[1, c] /= params[0][c]
    elif mode == DQ_AFV:
        bands = interpolation_bands(params[9:], n)
        w48 = dct_quant_weights(4, 8, bands, n)
        bands = interpolation_bands(params[9 + n :], m)
        w44 = dct_quant_weights(4, 4, bands, m)
        bands4 = interpolation_bands(params[5:], 4)
        scratch = np.empty((64, 3), dtype=np.float32)
        for c in range(3):
            scratch[0:32, c] = w48[:, c]
            scratch[32:48, c] = w44[:, c]
            scratch[0, c] = params[0][c]
            scratch[32, c] = params[1][c]
            for i in range(12):
                scratch[i + 48, c] = interpolate(_AFV_FREQS[i], c, bands4, 4)
            scratch[60, c] = 1.0
            for i in range(3):
                scratch[i + 61, c] = params[i + 2][c]
        for c in range(3):
            for i in range(64):
                raw[i, c] = scratch[_AFV_MAP[i], c]
    else:
        raise J40Error("dqm?")
    return raw
