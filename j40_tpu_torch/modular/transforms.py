"""Inverse modular transforms: RCT, Palette, Squeeze (reference
j40.h:4267-4543; Squeeze from spec H.6, which the reference parses but
rejects at j40.h:4518).

RCT and Squeeze are vectorized with numpy (integer-exact); Palette keeps a
scalar path when delta prediction is enabled (sequential WP dependency), and a
vectorized gather otherwise.
"""

from __future__ import annotations

import numpy as np

from ..errors import J40Error, check
from .decode import (
    Channel,
    ModularImage,
    TR_PALETTE,
    TR_RCT,
    TR_SQUEEZE,
    Transform,
    _predict,
)
from .wp import WPState

# 72 signed delta triplets, stored as 36 pairs of +/- (reference
# j40.h:4275-4288; spec Table H.2 has 143 used entries = index 1..143)
_BASE = [
    (0, 0, 0), (4, 4, 4), (11, 0, 0), (0, 0, -13), (0, -12, 0), (-10, -10, -10),
    (-18, -18, -18), (-27, -27, -27), (-18, -18, 0), (0, 0, -32), (-32, 0, 0), (-37, -37, -37),
    (0, -32, -32), (24, 24, 45), (50, 50, 50), (-45, -24, -24), (-24, -45, -45), (0, -24, -24),
    (-34, -34, 0), (-24, 0, -24), (-45, -45, -24), (64, 64, 64), (-32, 0, -32), (0, -32, 0),
    (-32, 0, 32), (-24, -45, -24), (45, 24, 45), (24, -24, -45), (-45, -24, 24), (80, 80, 80),
    (64, 0, 0), (0, 0, -64), (0, -64, -64), (-24, -24, 45), (96, 96, 96), (64, 64, 0),
    (45, -24, -24), (34, -34, 0), (112, 112, 112), (24, -45, -45), (45, 45, -24), (0, -32, 32),
    (24, -24, 45), (0, 96, 96), (45, -24, 24), (24, -45, -24), (-24, -45, 24), (0, -64, 0),
    (96, 0, 0), (128, 128, 128), (64, 0, 64), (144, 144, 144), (96, 96, 0), (-36, -36, 36),
    (45, -24, -45), (45, -45, -24), (0, 0, -96), (0, 128, 128), (0, 96, 0), (45, 24, -45),
    (-128, 0, 0), (24, -45, 24), (-45, 24, -45), (64, 0, -64), (64, -64, -64), (96, 0, 96),
    (45, -45, 24), (24, 45, -45), (64, 64, -64), (128, 128, 0), (0, 0, -128), (-24, 45, -45),
]
PALETTE_DELTAS = []
for t in _BASE:
    PALETTE_DELTAS.append(t)
    PALETTE_DELTAS.append((-t[0], -t[1], -t[2]))

RCT_PERMUTATIONS = ((0, 1, 2), (1, 2, 0), (2, 0, 1), (0, 2, 1), (1, 0, 2), (2, 1, 0))


def inverse_rct(m: ModularImage, tr: Transform) -> None:
    """Inverse reversible color transform (j40.h:4318-4400)."""
    b = tr.begin_c
    cs = [m.channels[b + i] for i in range(3)]
    if cs[0].empty:
        return
    p0, p1, p2 = (c.data.astype(np.int64) for c in cs)
    t = tr.rct_type % 7
    if t == 1:
        p2 = p2 + p0
    elif t == 2:
        p2 = p1 + p0
    elif t == 3:
        p1 = p1 + p0
        p2 = p2 + p0
    elif t == 4:
        p1 = p1 + ((p0 + p2) >> 1)
    elif t == 5:
        p1 = p1 + p0 + (p2 >> 1)
        p2 = p2 + p0
    elif t == 6:  # YCgCo
        tmp = p0 - (p2 >> 1)
        np1 = p2 + tmp
        np2 = tmp - (p1 >> 1)
        p0 = np2 + p1
        p1 = np1
        p2 = np2
    planes = [p0, p1, p2]
    perm = RCT_PERMUTATIONS[tr.rct_type // 7]
    out = [None] * 3
    for i in range(3):
        out[perm[i]] = planes[i]
    for i in range(3):
        m.channels[b + i].data = out[i].astype(np.int32)


def inverse_palette(m: ModularImage, tr: Transform, bpp: int) -> None:
    """Inverse palette transform (j40.h:4402-4490)."""
    first = tr.begin_c + 1
    last = tr.begin_c + tr.num_c
    idxc = m.channels[first]
    pal = m.channels[0]
    width, height = idxc.width, idxc.height
    use_pred = tr.nb_deltas > 0
    use_wp = use_pred and tr.d_pred == 6

    # output channels [first, last], index channel relocated to `last` and
    # repurposed as the final output (j40.h:4409-4433)
    idx_arr = idxc.data  # capture BEFORE idxc.data is repurposed
    new_channels: list[Channel] = []
    for _ in range(first, last):
        new_channels.append(Channel(width, height, idxc.hshift, idxc.vshift))
    m.channels[first:first] = new_channels  # insert before idxc (now at `last`)

    # precompute palette lookup rows
    palp = pal.data if tr.nb_colours > 0 else None

    for i in range(tr.num_c):
        c = m.channels[first + i]
        if idxc.empty:
            c.data = None
            c.width = c.height = 0
            continue
        out = np.zeros((height, width), dtype=np.int32)
        c.data = out

        if not use_pred:
            # vectorized gather (the common cjxl/fjxl case)
            out[:] = _palette_lookup_vec(idx_arr, palp, i, tr, bpp)
        else:
            wp = WPState(m.wp_params, width) if use_wp else None
            lookup_row = _palette_lookup_vec(idx_arr, palp, i, tr, bpp)
            for y in range(height):
                row = out[y]
                prow = out[y - 1] if y > 0 else None
                for x in range(width):
                    idx = int(idx_arr[y][x])
                    val = int(lookup_row[y][x])
                    is_delta = idx < tr.nb_deltas
                    w_ = int(row[x - 1]) if x > 0 else (int(prow[x]) if y > 0 else 0)
                    n_ = int(prow[x]) if y > 0 else w_
                    nw = int(prow[x - 1]) if (x > 0 and y > 0) else w_
                    ne = int(prow[x + 1]) if (x + 1 < width and y > 0) else n_
                    nn = int(out[y - 2][x]) if y > 1 else n_
                    nee = int(prow[x + 2]) if (x + 2 < width and y > 0) else ne
                    ww = int(row[x - 2]) if x > 1 else w_
                    if wp is not None:
                        wp.before_predict(x, y, w_, n_, nw, ne, nn)
                    if is_delta:
                        val += _predict(tr.d_pred, wp, w_, n_, nw, ne, nn, nee, ww)
                    if wp is not None:
                        wp.after_predict(x, y, val)
                    row[x] = val

    # drop the palette meta channel 0
    del m.channels[0]


def _palette_lookup_vec(idx_arr: np.ndarray, palp: np.ndarray | None, i: int,
                        tr: Transform, bpp: int) -> np.ndarray:
    """Vectorized palette index -> sample value (before delta prediction)."""
    idx = idx_arr.astype(np.int64)
    out = np.zeros_like(idx)

    neg = idx < 0
    if neg.any():
        if i < 3:
            d = (~idx[neg]) % 143
            table = np.array([PALETTE_DELTAS[k + 1][i] for k in range(143)], dtype=np.int64)
            v = table[d]
            if bpp > 8:
                v = v << (min(bpp, 24) - 8)
            out[neg] = v
        # else 0

    incolor = (~neg) & (idx < tr.nb_colours)
    if incolor.any():
        out[incolor] = palp[i][idx[incolor]]

    synth = (~neg) & (idx >= tr.nb_colours)
    if synth.any():
        s = idx[synth] - tr.nb_colours
        v = np.zeros_like(s)
        small = s < 64
        if small.any():
            ss = s[small]
            base = (ss >> (2 * i)) if i < 3 else np.zeros_like(ss)
            v[small] = base * ((1 << bpp) - 1) // 4 + (1 << max(0, bpp - 3))
        big = ~small
        if big.any():
            sb = s[big] - 64
            for _ in range(i):
                sb = sb // 5
            v[big] = (sb % 5) * ((1 << bpp) - 1) // 4
        out[synth] = v
    return out


def _smooth_tendency(B: np.ndarray, a: np.ndarray, n: np.ndarray) -> np.ndarray:
    """SmoothTendency (spec H.6.1), vectorized with C-truncating division."""
    B = B.astype(np.int64)
    a = a.astype(np.int64)
    n = n.astype(np.int64)
    diff = np.zeros_like(B)

    inc = (B >= a) & (a >= n)
    if inc.any():
        d = _trunc_div_vec(4 * B[inc] - 3 * n[inc] - a[inc] + 6, 12)
        cond1 = (d - (d & 1)) > 2 * (B[inc] - a[inc])
        d = np.where(cond1, 2 * (B[inc] - a[inc]) + 1, d)
        cond2 = (d + (d & 1)) > 2 * (a[inc] - n[inc])
        d = np.where(cond2, 2 * (a[inc] - n[inc]), d)
        diff[inc] = d

    dec = (B <= a) & (a <= n) & ~inc
    if dec.any():
        d = _trunc_div_vec(4 * B[dec] - 3 * n[dec] - a[dec] - 6, 12)
        cond1 = (d + (d & 1)) < 2 * (B[dec] - a[dec])
        d = np.where(cond1, 2 * (B[dec] - a[dec]) - 1, d)
        cond2 = (d - (d & 1)) < 2 * (a[dec] - n[dec])
        d = np.where(cond2, 2 * (a[dec] - n[dec]), d)
        diff[dec] = d
    return diff


def _trunc_div_vec(x: np.ndarray, d: int) -> np.ndarray:
    """C-style truncation toward zero for vector / positive scalar."""
    q = np.abs(x) // d
    return np.where(x < 0, -q, q)


def _inv_squeeze_h(down: np.ndarray, residu: np.ndarray) -> np.ndarray:
    """Horizontal unsqueeze of one channel (spec H.6.1)."""
    h, wdown = down.shape
    wres = residu.shape[1]
    w = wdown + wres
    out = np.zeros((h, w), dtype=np.int32)
    down = down.astype(np.int64)
    residu = residu.astype(np.int64)
    # sequential in x (left output feeds the next tendency); vector over rows
    left = None
    for x in range(wres):
        avg = down[:, x]
        next_avg = down[:, x + 1] if x + 1 < wdown else avg
        if x > 0:
            left = out[:, 2 * x - 1].astype(np.int64)
        else:
            left = avg
        diff = residu[:, x] + _smooth_tendency(left, avg, next_avg)
        first = avg + _trunc_div_vec(diff, 2)
        out[:, 2 * x] = first
        out[:, 2 * x + 1] = first - diff
    if w & 1:
        out[:, w - 1] = down[:, wdown - 1]
    return out


def _inv_squeeze_v(down: np.ndarray, residu: np.ndarray) -> np.ndarray:
    return _inv_squeeze_h(down.T, residu.T).T


def inverse_squeeze(m: ModularImage, tr: Transform) -> None:
    """Inverse squeeze: merge (down, residual) channel pairs back.

    The channel layout is the forward bookkeeping in reverse: residuals live at
    begin_c+num_c (in place) or at the position where they were appended.
    """
    # residuals sit where the forward bookkeeping inserted them: since inverse
    # transforms run in reverse, the channel list state here matches the state
    # right after this transform's forward application
    offset = tr.offset
    assert offset >= 0
    for k in range(tr.num_c):
        c = m.channels[tr.begin_c + k]
        rc = m.channels[offset + k]
        if tr.horizontal:
            check(rc.height == c.height and c.width >= rc.width >= c.width - 1, "sqzd")
            if c.empty:
                merged = None
            else:
                merged = _inv_squeeze_h(
                    c.data, rc.data if not rc.empty else
                    np.zeros((c.height, rc.width), np.int32))
            c.width = c.width + rc.width
            c.hshift -= 1
        else:
            check(rc.width == c.width and c.height >= rc.height >= c.height - 1, "sqzd")
            if c.empty:
                merged = None
            else:
                merged = _inv_squeeze_v(
                    c.data, rc.data if not rc.empty else
                    np.zeros((rc.height, c.width), np.int32))
            c.height = c.height + rc.height
            c.vshift -= 1
        c.data = merged
    del m.channels[offset : offset + tr.num_c]


def inverse_transforms(m: ModularImage, bpp: int) -> None:
    """Apply all inverse transforms in reverse order (j40.h:4506-4542)."""
    for tr in reversed(m.transforms):
        if tr.id == TR_RCT:
            inverse_rct(m, tr)
        elif tr.id == TR_PALETTE:
            inverse_palette(m, tr, bpp)
        elif tr.id == TR_SQUEEZE:
            inverse_squeeze(m, tr)
        else:
            raise J40Error("xfm?")
