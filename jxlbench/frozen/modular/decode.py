"""Modular image: header, channel decode, prediction (reference
j40.h:3524-4265, spec §10).

Channels are numpy int32 planes (the reference's int16-buffer mode only
changes the overflow check, which we keep for parity).  The per-pixel decode
loop here is the correctness oracle; the production path runs in the native
C++ core (j40_tpu/native) with identical semantics.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..errors import J40Error, check
from ..io.bits import BitReader
from ..limits import MAIN_LV5, Limits
from ..mathutil import unpack_signed
from ..entropy.code import CodeSpec, CodeState, MAX_DIST_MULT
from .tree import NUM_PRED, TreeNode, read_tree
from .wp import WPParams, WPState

INT16_MIN, INT16_MAX = -0x8000, 0x7FFF


@dataclass
class Channel:
    width: int
    height: int
    hshift: int = 0
    vshift: int = 0
    data: np.ndarray | None = None  # int32 (height, width), None until decoded

    @property
    def empty(self) -> bool:
        return self.width <= 0 or self.height <= 0


@dataclass
class Transform:
    id: int  # 0=RCT, 1=Palette, 2=Squeeze
    # RCT
    begin_c: int = 0
    rct_type: int = 0
    # Palette
    num_c: int = 0
    nb_colours: int = 0
    nb_deltas: int = 0
    d_pred: int = 0
    # Squeeze
    implicit: bool = False
    horizontal: bool = False
    in_place: bool = False
    offset: int = -1  # residual insertion offset recorded at parse time


@dataclass
class ModularImage:
    channels: list[Channel]
    transforms: list[Transform] = field(default_factory=list)
    wp_params: WPParams = field(default_factory=WPParams)
    tree: list[TreeNode] | None = None
    codespec: CodeSpec | None = None
    code: CodeState | None = None
    nb_meta_channels: int = 0
    dist_mult: int = 0
    use_global_tree: bool = False
    wide: bool = False  # 32-bit sample buffers (modular_16bit_buffers == 0)
    native: object = None  # NativeStream once the native core takes over

    @property
    def num_channels(self) -> int:
        return len(self.channels)


TR_RCT, TR_PALETTE, TR_SQUEEZE = 0, 1, 2


def _squeeze_channel_effects(m: ModularImage, transforms: list[Transform]) -> None:
    """Apply squeeze bookkeeping to the channel list (spec H.6; the reference
    stubs this at j40.h:3812)."""
    for tr in transforms:
        offset = (tr.begin_c + tr.num_c) if tr.in_place else len(m.channels)
        tr.offset = offset
        for k in range(tr.num_c):
            c = m.channels[tr.begin_c + k]
            check(c.hshift <= 30 and c.vshift <= 30, "sqnm")
            if tr.horizontal:
                w = c.width
                c.width = (w + 1) // 2
                c.hshift += 1
                rw, rh = w - c.width, c.height
            else:
                h = c.height
                c.height = (h + 1) // 2
                c.vshift += 1
                rw, rh = c.width, h - c.height
            residu = Channel(rw, rh, c.hshift, c.vshift)
            m.channels.insert(offset + k, residu)


def default_squeeze_transforms(m: ModularImage) -> list[Transform]:
    """Implicit squeeze parameter sequence (spec H.6.2 / libjxl
    DefaultSqueezeParameters)."""
    first = m.nb_meta_channels
    nb = len(m.channels) - first
    w = m.channels[first].width
    h = m.channels[first].height
    out: list[Transform] = []
    if nb > 2 and m.channels[first + 1].width == w and m.channels[first + 1].height == h:
        # assume channels 1&2 are chroma and squeeze them once, non-in-place;
        # direction: vertical when h >= w (libjxl DefaultSqueezeParameters)
        out.append(
            Transform(TR_SQUEEZE, begin_c=first + 1, num_c=2, in_place=False,
                      horizontal=not (h >= w))
        )
    while w > 8 or h > 8:
        if w > 8:
            out.append(Transform(TR_SQUEEZE, begin_c=first, num_c=nb,
                                 in_place=True, horizontal=True))
            w = (w + 1) // 2
        if h > 8:
            out.append(Transform(TR_SQUEEZE, begin_c=first, num_c=nb,
                                 in_place=True, horizontal=False))
            h = (h + 1) // 2
    return out


def parse_modular_header(
    r: BitReader,
    m: ModularImage,
    global_tree: list[TreeNode] | None = None,
    global_codespec: CodeSpec | None = None,
    limits: Limits = MAIN_LV5,
) -> None:
    """Parse the modular sub-bitstream header (j40.h:3717-3860): WP params,
    transforms (with channel-list effects), tree selection."""
    nb_meta = 0
    check(m.num_channels > 0, "modc")

    m.use_global_tree = bool(r.u(1))
    check(not m.use_global_tree or global_tree is not None, "mtre")

    if r.u(1):  # default WP
        m.wp_params = WPParams()
    else:
        p1 = r.u(5)
        p2 = r.u(5)
        p3 = tuple(r.u(5) for _ in range(5))
        w = tuple(r.u(4) for _ in range(4))
        m.wp_params = WPParams(p1, p2, p3, w)

    nb_transforms = r.u32(0, 0, 1, 0, 2, 4, 18, 8)
    check(nb_transforms <= limits.nb_transforms, "xlim")
    m.transforms = []
    for _ in range(nb_transforms):
        tid = r.u(2)
        if tid == TR_RCT:
            begin_c = r.u32(0, 3, 8, 6, 72, 10, 1096, 13)
            rct_type = r.u32(6, 0, 0, 2, 2, 4, 10, 6)
            check(rct_type < 42, "rctt")
            check(begin_c + 3 <= m.num_channels, "rctc")
            check(begin_c >= nb_meta or begin_c + 3 <= nb_meta, "rctc")
            cs = m.channels[begin_c : begin_c + 3]
            check(
                all((c.width, c.height) == (cs[0].width, cs[0].height) for c in cs),
                "rtcd",
            )
            m.transforms.append(Transform(TR_RCT, begin_c=begin_c, rct_type=rct_type))
        elif tid == TR_PALETTE:
            begin_c = r.u32(0, 3, 8, 6, 72, 10, 1096, 13)
            num_c = r.u32(1, 0, 3, 0, 4, 0, 1, 13)
            end_c = begin_c + num_c
            nb_colours = r.u32(0, 8, 256, 10, 1280, 12, 5376, 16)
            nb_deltas = r.u32(0, 0, 1, 8, 257, 10, 1281, 16)
            d_pred = r.u(4)
            check(d_pred < NUM_PRED, "palp")
            check(end_c <= m.num_channels, "palc")
            if begin_c < nb_meta:
                check(end_c <= nb_meta, "palc")
                nb_meta += 2 - num_c
            else:
                nb_meta += 1
            cs = m.channels[begin_c:end_c]
            check(
                all((c.width, c.height) == (cs[0].width, cs[0].height) for c in cs),
                "pald",
            )
            # channel-list effect: [begin,end) replaced by index channel, and a
            # palette meta channel is prepended (j40.h:3780-3789)
            input_ch = m.channels[begin_c]
            del m.channels[begin_c:end_c]
            m.channels.insert(begin_c, Channel(input_ch.width, input_ch.height,
                                               input_ch.hshift, input_ch.vshift))
            m.channels.insert(0, Channel(nb_colours, num_c, 0, -1))
            m.transforms.append(
                Transform(TR_PALETTE, begin_c=begin_c, num_c=num_c,
                          nb_colours=nb_colours, nb_deltas=nb_deltas, d_pred=d_pred)
            )
        elif tid == TR_SQUEEZE:
            num_sq = r.u32(0, 0, 1, 4, 9, 6, 41, 8)
            if num_sq == 0:
                m.nb_meta_channels = nb_meta
                sqs = default_squeeze_transforms(m)
            else:
                sqs = []
                for _ in range(num_sq):
                    horizontal = bool(r.u(1))
                    in_place = bool(r.u(1))
                    begin_c = r.u32(0, 3, 8, 6, 72, 10, 1096, 13)
                    num_c = r.u32(1, 0, 2, 0, 3, 0, 4, 4)
                    check(begin_c + num_c <= m.num_channels, "sqzc")
                    check(begin_c >= nb_meta, "sqzc")
                    sqs.append(Transform(TR_SQUEEZE, begin_c=begin_c, num_c=num_c,
                                         horizontal=horizontal, in_place=in_place))
            _squeeze_channel_effects(m, sqs)
            m.transforms.extend(sqs)
        else:
            raise J40Error("xfm?")

    m.nb_meta_channels = nb_meta

    if m.use_global_tree:
        m.tree = global_tree
        m.codespec = global_codespec
    else:
        max_tree_size = 1024
        for c in m.channels:
            max_tree_size += c.width * c.height
        max_tree_size = min(1 << 20, max_tree_size)
        m.tree, m.codespec = read_tree(r, max_tree_size, limits)
    m.code = CodeState(m.codespec)

    m.dist_mult = 0
    for c in m.channels[m.nb_meta_channels :]:
        m.dist_mult = max(m.dist_mult, c.width)
    m.dist_mult = min(m.dist_mult, MAX_DIST_MULT)


def allocate(m: ModularImage) -> None:
    for c in m.channels:
        if not c.empty and c.data is None:
            c.data = np.zeros((c.height, c.width), dtype=np.int32)


def _tree_uses_wp(tree: list[TreeNode]) -> bool:
    last = 0
    i = 0
    while i <= last:
        n = tree[i]
        if not n.is_leaf:
            if n.prop == 15:
                return True
            last = max(last, n.right, n.left)
        elif n.predictor == 6:
            return True
        i += 1
    return False


NATIVE_ENV = "J40T_NATIVE"


def _native_enabled() -> bool:
    # the benchmark's copy carries no native core: its encoder never decodes
    return False


def _decode_channel_native(r: BitReader, m: ModularImage, cidx: int, sidx: int) -> bool:
    """Native fast path; returns False if unavailable."""
    if not _native_enabled():
        return False
    from ..native.bindings import NativeStream, tree_to_array, wp_to_array

    c = m.channels[cidx]
    if m.native is None:
        r.ensure_all()  # windowed header readers pull their full source
        data = bytes(r.data)
        m.native = NativeStream(data, r.rel_bits, m.codespec)
        m._tree_arr = tree_to_array(m.tree)
        m._wp_arr = wp_to_array(m.wp_params)
    refs = [
        m.channels[i].data
        for i in range(cidx - 1, -1, -1)
        if (m.channels[i].width, m.channels[i].height,
            m.channels[i].hshift, m.channels[i].vshift)
        == (c.width, c.height, c.hshift, c.vshift)
    ]
    c.data = m.native.decode_modular_channel(
        m._tree_arr, m._wp_arr, m.dist_mult, cidx, sidx, c.width, c.height, refs,
        out=c.data,  # decode in place (may be a strided gmodular-plane view)
        range_max=0x7FFFFFFF if m.wide else 32767,
    )
    # hand the bit position and ANS state back to the Python layer
    r.seek_rel_bits(m.native.bitpos)
    m.code.ans.state = m.native.ans_state
    return True


def decode_channel(
    r: BitReader, m: ModularImage, cidx: int, sidx: int = 0
) -> None:
    """Decode one channel's pixels (j40.h:4127-4240)."""
    c = m.channels[cidx]
    if c.empty:
        return
    if _decode_channel_native(r, m, cidx, sidx):
        return
    width, height = c.width, c.height
    tree = m.tree
    code = m.code
    dist_mult = m.dist_mult
    px = c.data
    assert px is not None

    wp = WPState(m.wp_params, width) if _tree_uses_wp(tree) else None

    # previous compatible channels for properties >= 16
    refcmap = [
        i
        for i in range(cidx - 1, -1, -1)
        if (m.channels[i].width, m.channels[i].height,
            m.channels[i].hshift, m.channels[i].vshift)
        == (width, height, c.hshift, c.vshift)
    ]

    single_leaf = tree[0] if tree[0].is_leaf else None

    for y in range(height):
        row = px[y]
        prow = px[y - 1] if y > 0 else None
        for x in range(width):
            # 8-neighbor fetch with edge substitution (j40.h:3965-3990)
            w_ = row[x - 1] if x > 0 else (prow[x] if y > 0 else 0)
            n_ = prow[x] if y > 0 else w_
            nw = prow[x - 1] if (x > 0 and y > 0) else w_
            ne = prow[x + 1] if (x + 1 < width and y > 0) else n_
            nn = px[y - 2][x] if y > 1 else n_
            nee = prow[x + 2] if (x + 2 < width and y > 0) else ne
            ww = row[x - 2] if x > 1 else w_
            nww = prow[x - 2] if (x > 1 and y > 0) else ww

            if wp is not None:
                wp.before_predict(x, y, int(w_), int(n_), int(nw), int(ne), int(nn))

            node = single_leaf
            if node is None:
                node = tree[0]
                while not node.is_leaf:
                    p = node.prop
                    if p == 0:
                        val = cidx
                    elif p == 1:
                        val = sidx
                    elif p == 2:
                        val = y
                    elif p == 3:
                        val = x
                    elif p == 4:
                        val = abs(int(n_))
                    elif p == 5:
                        val = abs(int(w_))
                    elif p == 6:
                        val = int(n_)
                    elif p == 7:
                        val = int(w_)
                    elif p == 8:
                        val = int(w_) - (int(ww) + int(nw) - int(nww)) if x > 0 else int(w_)
                    elif p == 9:
                        val = int(w_) + int(n_) - int(nw)
                    elif p == 10:
                        val = int(w_) - int(nw)
                    elif p == 11:
                        val = int(nw) - int(n_)
                    elif p == 12:
                        val = int(n_) - int(ne)
                    elif p == 13:
                        val = int(n_) - int(nn)
                    elif p == 14:
                        val = int(w_) - int(ww)
                    elif p == 15:
                        val = wp.max_error_property if wp is not None else 0
                    else:
                        refcidx = (p - 16) // 4
                        check(refcidx < len(refcmap), "trec")
                        refc = m.channels[refcmap[refcidx]].data
                        val = int(refc[y][x])
                        if p & 2:
                            rw = int(refc[y][x - 1]) if x > 0 else 0
                            rn = int(refc[y - 1][x]) if y > 0 else rw
                            rnw = int(refc[y - 1][x - 1]) if (x > 0 and y > 0) else rw
                            val -= _gradient(rw, rn, rnw)
                        if p & 1:
                            val = abs(val)
                    node = tree[node.left if val > node.value else node.right]

            token = code.code(r, node.ctx, dist_mult)
            val = unpack_signed(token) * node.multiplier + node.offset
            val += _predict(node.predictor, wp, int(w_), int(n_), int(nw),
                            int(ne), int(nn), int(nee), int(ww))
            if not m.wide:
                check(INT16_MIN <= val <= INT16_MAX, "povf")
            row[x] = val
            if wp is not None:
                wp.after_predict(x, y, val)


def _gradient(w: int, n: int, nw: int) -> int:
    lo = min(w, n)
    hi = max(w, n)
    return min(max(lo, w + n - nw), hi)


def _trunc_half_sum(a: int, b: int) -> int:
    """C-style (a+b)/2 with truncation toward zero."""
    s = a + b
    return -((-s) // 2) if s < 0 else s // 2


def _predict(pred: int, wp: WPState | None, w: int, n: int, nw: int, ne: int,
             nn: int, nee: int, ww: int) -> int:
    if pred == 0:
        return 0
    if pred == 1:
        return w
    if pred == 2:
        return n
    if pred == 3:
        return _trunc_half_sum(w, n)
    if pred == 4:
        return w if abs(n - nw) < abs(w - nw) else n
    if pred == 5:
        return _gradient(w, n, nw)
    if pred == 6:
        return (wp.pred[4] + 3) >> 3 if wp is not None else 0
    if pred == 7:
        return ne
    if pred == 8:
        return nw
    if pred == 9:
        return ww
    if pred == 10:
        return _trunc_half_sum(w, nw)
    if pred == 11:
        return _trunc_half_sum(n, nw)
    if pred == 12:
        return _trunc_half_sum(n, ne)
    if pred == 13:
        s = 6 * n - 2 * nn + 7 * w + ww + nee + 3 * ne + 8
        return -((-s) // 16) if s < 0 else s // 16
    raise J40Error("pred", f"bad predictor {pred}")


def decode_all_channels(r: BitReader, m: ModularImage, sidx: int = 0) -> None:
    allocate(m)
    for cidx in range(m.num_channels):
        decode_channel(r, m, cidx, sidx)
