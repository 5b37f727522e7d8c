"""Full-featured modular encoder: custom MA trees, WP, RCT, Squeeze,
multi-group with LF-group section routing.

The channel bookkeeping intentionally reuses the decoder's own helpers
(_squeeze_channel_effects, shift-based section routing) so encode and decode
stay structurally in lockstep.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..mathutil import ceil_div
from ..modular.decode import (
    Channel,
    ModularImage,
    TR_PALETTE,
    TR_RCT,
    TR_SQUEEZE,
    Transform,
    _squeeze_channel_effects,
    default_squeeze_transforms,
)
from ..modular.tree import TreeNode
from ..modular.wp import WPParams
from .bitwriter import BitWriter
from .encoder import TOC_U32
from .entropy import EntropyEncoder
from .headers import write_image_metadata, write_signature
from .modular_enc import (
    assign_leaf_contexts,
    encode_channel_tokens,
    forward_rct,
    forward_squeeze_h,
    forward_squeeze_v,
    leaf,
    write_tree,
)

U32_BEGIN_C = ((0, 3), (8, 6), (72, 10), (1096, 13))


def _write_wp_params(sw: BitWriter, wp: WPParams) -> None:
    """WP params field of the modular sub-header (decode.py:145-152,
    j40.h:3723-3734): default bit, else 5-bit p1/p2/p3[5] + 4-bit w[4]."""
    if wp == WPParams():
        sw.u(1, 1)
        return
    sw.u(1, 0)
    sw.u(5, wp.p1)
    sw.u(5, wp.p2)
    for v in wp.p3:
        sw.u(5, v)
    for v in wp.w:
        sw.u(4, v)


def _cluster_map(opt, num_ctx: int) -> list[int] | None:
    if not getattr(opt, "complex_cluster_map", False):
        return None
    # contiguous cluster ids (decoder checks seen == range(n)), a few
    # contexts per cluster
    n_cl = min(256, max(1, (num_ctx + 3) // 4))  # map indices cap at 256
    return [min(i * n_cl // num_ctx, n_cl - 1) for i in range(num_ctx)]


@dataclass
class AdvancedOptions:
    use_prefix: bool = True
    #: emit the context->cluster map via the nested-entropy+MTF form, with
    #: one cluster per up-to-4 contexts (decoder coverage: j40.h:2550-2599)
    complex_cluster_map: bool = False
    #: emit ANS distributions in the flat "evenly distributed" mode 2
    #: (decoder coverage: j40.h:2640-2649); only meaningful with ANS coding
    flat_ans_dists: bool = False
    #: bit-counts shift < 13 quantizes ANS table values (decoder coverage
    #: for the truncated-extra-bits branch, j40.h:2680-2686)
    ans_shift: int = 13
    group_size_shift: int = 8
    tree: list[TreeNode] | None = None  # default: single leaf gradient
    #: emit the tree + ONE code spec globally in LfGlobal (cjxl -e3's
    #: shape, j40.h:6320-6336): every section then decodes against the
    #: shared spec — the premise that lets the decoder's device lanes
    #: batch sections with one LUT set
    global_tree: bool = False
    rct_type: int | None = None  # e.g. 6 for YCgCo
    squeeze: bool = False  # implicit (default-parameter) squeeze
    palette: bool = False  # extract a palette (lossless; needs few colors)
    max_colours: int = 4096
    wp_params: WPParams = field(default_factory=WPParams)
    #: frame upsampling: the encoder input is the LOW-RES (coded) samples;
    #: the signalled image size is display_size (default: coded size * k)
    log_upsampling: int = 0
    display_size: tuple | None = None  # (width, height) at display res
    up_weights: dict | None = None  # custom weight vectors {k: [floats]}


def _build_modular(image: np.ndarray, opt: AdvancedOptions) -> ModularImage:
    """Forward-transform the image into the channel list the decoder will
    reconstruct from."""
    h, w, nc = image.shape
    m = ModularImage(channels=[Channel(w, h) for _ in range(nc)])
    datas = [image[:, :, c].astype(np.int32) for c in range(nc)]
    for ch, d in zip(m.channels, datas):
        ch.data = d

    if opt.palette:
        assert not opt.squeeze, "palette+squeeze chain not supported"
        samples = image.astype(np.int32)
        if opt.rct_type is not None:
            # transform chain: forward RCT first, then palettize the RCT'd
            # samples — the decoder inverts in reverse order (palette then
            # RCT), transforms listed in parse order [RCT, PALETTE]
            assert nc == 3
            rct_planes = forward_rct(
                [samples[:, :, c] for c in range(nc)], opt.rct_type
            )
            samples = np.stack(rct_planes, axis=-1)
            m.transforms.append(
                Transform(TR_RCT, begin_c=0, rct_type=opt.rct_type)
            )
        flat = samples.reshape(-1, nc)
        colors, inv = np.unique(flat, axis=0, return_inverse=True)
        assert len(colors) <= opt.max_colours, "too many colors for palette"
        # channel-list effect mirrors the decoder (decode.py:189-195):
        # [0, nc) -> one index channel, palette meta channel prepended
        idxc = Channel(w, h)
        idxc.data = inv.reshape(h, w).astype(np.int32)
        palc = Channel(len(colors), nc, 0, -1)
        palc.data = np.ascontiguousarray(colors.T).astype(np.int32)
        m.channels = [palc, idxc]
        m.nb_meta_channels = 1
        m.transforms.append(
            Transform(TR_PALETTE, begin_c=0, num_c=nc,
                      nb_colours=len(colors), nb_deltas=0, d_pred=0)
        )
        return m

    if opt.rct_type is not None:
        assert nc == 3
        out = forward_rct([c.data for c in m.channels], opt.rct_type)
        for ch, d in zip(m.channels, out):
            ch.data = d
        m.transforms.append(Transform(TR_RCT, begin_c=0, rct_type=opt.rct_type))

    if opt.squeeze:
        sqs = default_squeeze_transforms(m)
        # bookkeeping and data transform must interleave per step: each step's
        # forward input is the previous step's down-channel output
        for tr in sqs:
            _squeeze_channel_effects(m, [tr])  # records tr.offset, shapes, shifts
            _apply_forward_squeeze(m, [tr])
        m.transforms.extend(sqs)
        # written in the header as a single implicit (num_sq=0) squeeze entry
    return m


def _apply_forward_squeeze(m: ModularImage, sqs) -> None:
    """Fill channel data for the post-squeeze layout.

    _squeeze_channel_effects already reshaped the channel list; we re-run the
    same walk, transforming data as we go.  Channel objects still hold the
    ORIGINAL full-resolution data in the slots that were squeezed (shapes were
    mutated but .data untouched), so process in forward order.
    """
    for tr in sqs:
        for k in range(tr.num_c):
            c = m.channels[tr.begin_c + k]
            rc = m.channels[tr.offset + k]
            full = c.data
            assert full is not None
            if tr.horizontal:
                down, res = forward_squeeze_h(full)
            else:
                down, res = forward_squeeze_v(full)
            assert down.shape == (c.height, c.width), (down.shape, c.height, c.width)
            assert res.shape == (rc.height, rc.width)
            c.data = down
            rc.data = res


def _write_header_and_streams(
    image: np.ndarray, bpp: int, opt: AdvancedOptions
) -> bytes:
    h, wd, nc = image.shape
    assert nc == 3
    m = _build_modular(image, opt)

    tree = opt.tree or [leaf(5)]
    num_ctx = assign_leaf_contexts(tree)

    w = BitWriter()
    write_signature(w)
    k = 1 << opt.log_upsampling
    disp_w, disp_h = opt.display_size or (wd * k, h * k)
    assert ceil_div(disp_w, k) == wd and ceil_div(disp_h, k) == h, \
        "display size inconsistent with coded size and upsampling factor"
    write_image_metadata(w, disp_w, disp_h, bpp=bpp, xyb_encoded=False,
                         up_weights=opt.up_weights)
    w.zero_pad_to_byte()
    _write_frame_header(w, opt)

    group_size = 1 << opt.group_size_shift
    gcolumns = ceil_div(wd, group_size)
    grows = ceil_div(h, group_size)
    num_groups = gcolumns * grows
    gg_size = group_size * 8
    ggcolumns = ceil_div(wd, gg_size)
    ggrows = ceil_div(h, gg_size)
    num_lf_groups = ggcolumns * ggrows
    single = num_groups == 1

    def write_gmodular_header(sw: BitWriter) -> None:
        sw.u(1, 0)  # use_global_tree = false (tree is local to gmodular)
        _write_wp_params(sw, opt.wp_params)
        ntr = len(m.transforms) - (len([t for t in m.transforms if t.id == TR_SQUEEZE]) or 0)
        sq_present = any(t.id == TR_SQUEEZE for t in m.transforms)
        nb_transforms = ntr + (1 if sq_present else 0)
        sw.u32(((0, 0), (1, 0), (2, 4), (18, 8)), nb_transforms)
        for t in m.transforms:
            if t.id == TR_RCT:
                sw.u(2, TR_RCT)
                sw.u32(U32_BEGIN_C, t.begin_c)
                sw.u32(((6, 0), (0, 2), (2, 4), (10, 6)), t.rct_type)
            elif t.id == TR_PALETTE:
                sw.u(2, TR_PALETTE)
                sw.u32(U32_BEGIN_C, t.begin_c)
                sw.u32(((1, 0), (3, 0), (4, 0), (1, 13)), t.num_c)
                sw.u32(((0, 8), (256, 10), (1280, 12), (5376, 16)), t.nb_colours)
                sw.u32(((0, 0), (1, 8), (257, 10), (1281, 16)), t.nb_deltas)
                sw.u(4, t.d_pred)
        if sq_present:
            sw.u(2, TR_SQUEEZE)
            sw.u32(((0, 0), (1, 4), (9, 6), (41, 8)), 0)  # num_sq=0: implicit
        write_tree(sw, tree, opt.use_prefix)
        # leaf code spec + globally decoded channel tokens
        genc = EntropyEncoder(num_ctx, use_prefix=opt.use_prefix,
                      cluster_map=_cluster_map(opt, num_ctx),
                      complex_cluster_map=opt.complex_cluster_map,
                      flat_ans_dists=opt.flat_ans_dists,
                      ans_shift=opt.ans_shift)
        n_global = m.num_channels if single else m.nb_meta_channels
        for ci in range(n_global):
            for ctx, tok in encode_channel_tokens(m, ci, tree, opt.wp_params, 0):
                genc.add(ctx, tok)
        genc.write(sw)

    # global-tree emission: one spec over every section's tokens
    genc_g = None
    if (opt.global_tree and not single
            and not any(t.id == TR_PALETTE for t in m.transforms)):
        genc_g = EntropyEncoder(num_ctx, use_prefix=opt.use_prefix,
                                cluster_map=_cluster_map(opt, num_ctx),
                                complex_cluster_map=opt.complex_cluster_map,
                                flat_ans_dists=opt.flat_ans_dists,
                                ans_shift=opt.ans_shift)

    # LfGlobal section
    lf_global = BitWriter()
    lf_global.u(1, 1)  # LfChannelDequantization all_default
    if genc_g is None:
        lf_global.u(1, 0)  # no global tree
        write_gmodular_header(lf_global)

    if single:
        section = lf_global.finish()
        w.u(1, 0)  # not permuted
        w.zero_pad_to_byte()
        w.u32(TOC_U32, len(section))
        w.zero_pad_to_byte()
        w.out.extend(section)
        return w.finish()

    # multi-group: route channels by shift
    n_global = m.nb_meta_channels
    sections: list[bytes] = [b""]  # LfGlobal finishes below (the global-
    # tree path appends the tree/spec/gmodular tokens first)
    NUM_DCT_PARAMS = 17

    def group_stream(region, minshift, maxshift, sidx) -> bytes:
        gx, gy, gw_, gh_ = region
        picks = []
        for i in range(n_global, m.num_channels):
            gc = m.channels[i]
            mm = min(gc.hshift, gc.vshift)
            if not (minshift <= mm < maxshift):
                continue
            x0 = gx >> gc.hshift
            y0 = gy >> gc.vshift
            cw = min(ceil_div(gw_, 1 << gc.hshift), gc.width - x0)
            chh = min(ceil_div(gh_, 1 << gc.vshift), gc.height - y0)
            if cw <= 0 or chh <= 0:
                continue
            picks.append((i, x0, y0, cw, chh))
        if not picks:
            return b""
        sub = ModularImage(
            channels=[
                Channel(cw, chh, m.channels[i].hshift, m.channels[i].vshift)
                for (i, _, _, cw, chh) in picks
            ]
        )
        for (i, x0, y0, cw, chh), sc in zip(picks, sub.channels):
            sc.data = m.channels[i].data[y0 : y0 + chh, x0 : x0 + cw]
        sw = BitWriter()
        if genc_g is not None:
            # phase 1 collected this stream's tokens; write the header
            # referencing the global tree + this section's token stream
            sw.u(1, 1)  # use_global_tree
            _write_wp_params(sw, opt.wp_params)
            sw.u32(((0, 0), (1, 0), (2, 4), (18, 8)), 0)  # no transforms
            genc_g.write_tokens(sw, stream=sidx)
            return sw.finish()
        sw.u(1, 0)  # use_global_tree = false
        _write_wp_params(sw, opt.wp_params)
        sw.u32(((0, 0), (1, 0), (2, 4), (18, 8)), 0)  # no transforms in groups
        write_tree(sw, tree, opt.use_prefix)
        genc = EntropyEncoder(num_ctx, use_prefix=opt.use_prefix,
                      cluster_map=_cluster_map(opt, num_ctx),
                      complex_cluster_map=opt.complex_cluster_map,
                      flat_ans_dists=opt.flat_ans_dists,
                      ans_shift=opt.ans_shift)
        for ci in range(sub.num_channels):
            for ctx, tok in encode_channel_tokens(sub, ci, tree, opt.wp_params, sidx):
                genc.add(ctx, tok)
        genc.write(sw)
        return sw.finish()

    def collect_stream(region, minshift, maxshift, sidx) -> None:
        gx, gy, gw_, gh_ = region
        picks = []
        for i in range(n_global, m.num_channels):
            gc = m.channels[i]
            mm = min(gc.hshift, gc.vshift)
            if not (minshift <= mm < maxshift):
                continue
            x0 = gx >> gc.hshift
            y0 = gy >> gc.vshift
            cw = min(ceil_div(gw_, 1 << gc.hshift), gc.width - x0)
            chh = min(ceil_div(gh_, 1 << gc.vshift), gc.height - y0)
            if cw <= 0 or chh <= 0:
                continue
            picks.append((i, x0, y0, cw, chh))
        if not picks:
            return
        sub = ModularImage(
            channels=[
                Channel(cw, chh, m.channels[i].hshift, m.channels[i].vshift)
                for (i, _, _, cw, chh) in picks
            ]
        )
        for (i, x0, y0, cw, chh), sc in zip(picks, sub.channels):
            sc.data = m.channels[i].data[y0 : y0 + chh, x0 : x0 + cw]
        for ci in range(sub.num_channels):
            for ctx, tok in encode_channel_tokens(sub, ci, tree,
                                                  opt.wp_params, sidx):
                genc_g.add(ctx, tok, stream=sidx)

    if genc_g is not None:
        # phase 1: collect every section's tokens so ONE spec covers all
        for ggidx in range(num_lf_groups):
            row, col = divmod(ggidx, ggcolumns)
            x0, y0 = col * gg_size, row * gg_size
            region = (x0, y0, min(wd - x0, gg_size), min(h - y0, gg_size))
            collect_stream(region, 3, 10000, 1 + num_lf_groups + ggidx)
        for gidx in range(num_groups):
            row, col = divmod(gidx, gcolumns)
            x0, y0 = col * group_size, row * group_size
            region = (x0, y0, min(wd - x0, group_size),
                      min(h - y0, group_size))
            collect_stream(region, 0, 3,
                           1 + 3 * num_lf_groups + NUM_DCT_PARAMS + gidx)
        gkey = "lfglobal"
        genc_g.streams.setdefault(gkey, [])
        for ci in range(n_global):
            for ctx, tok in encode_channel_tokens(m, ci, tree,
                                                  opt.wp_params, 0):
                genc_g.add(ctx, tok, stream=gkey)
        # LfGlobal: global tree + the shared spec + gmodular header
        lf_global.u(1, 1)  # global tree present
        write_tree(lf_global, tree, opt.use_prefix)
        genc_g.write_spec(lf_global)
        lf_global.u(1, 1)  # gmodular: use_global_tree
        _write_wp_params(lf_global, opt.wp_params)
        lf_global.u32(((0, 0), (1, 0), (2, 4), (18, 8)),
                      len(m.transforms))
        for t in m.transforms:
            if t.id == TR_RCT:
                lf_global.u(2, TR_RCT)
                lf_global.u32(U32_BEGIN_C, t.begin_c)
                lf_global.u32(((6, 0), (0, 2), (2, 4), (10, 6)), t.rct_type)
            elif t.id == TR_SQUEEZE:
                lf_global.u(2, TR_SQUEEZE)
                lf_global.u32(((0, 0), (1, 4), (9, 6), (41, 8)), 0)
        genc_g.write_tokens(lf_global, stream=gkey)

    sections[0] = lf_global.finish()

    for ggidx in range(num_lf_groups):
        row, col = divmod(ggidx, ggcolumns)
        x0, y0 = col * gg_size, row * gg_size
        region = (x0, y0, min(wd - x0, gg_size), min(h - y0, gg_size))
        sections.append(group_stream(region, 3, 10000, 1 + num_lf_groups + ggidx))
    sections.append(b"")  # HfGlobal empty for modular
    for gidx in range(num_groups):
        row, col = divmod(gidx, gcolumns)
        x0, y0 = col * group_size, row * group_size
        region = (x0, y0, min(wd - x0, group_size), min(h - y0, group_size))
        sidx = 1 + 3 * num_lf_groups + NUM_DCT_PARAMS + gidx
        sections.append(group_stream(region, 0, 3, sidx))

    w.u(1, 0)  # not permuted
    w.zero_pad_to_byte()
    for s in sections:
        w.u32(TOC_U32, len(s))
    w.zero_pad_to_byte()
    for s in sections:
        w.out.extend(s)
    return w.finish()


def _write_frame_header(w: BitWriter, opt: AdvancedOptions) -> None:
    w.u(1, 0)  # not all_default
    w.u(2, 0)  # regular
    w.u(1, 1)  # is_modular
    w.u64(0)  # flags
    w.u(1, 0)  # do_ycbcr
    w.u(2, opt.log_upsampling)
    w.u(2, opt.group_size_shift - 7)
    w.u32(((1, 0), (2, 0), (3, 0), (4, 3)), 1)  # num_passes
    w.u(1, 0)  # have_crop
    w.u32(((0, 0), (1, 0), (2, 0), (3, 2)), 0)  # blend replace
    w.u(1, 1)  # is_last
    w.u32(((0, 0), (0, 4), (16, 5), (48, 10)), 0)  # name_len
    w.u(1, 1)  # restoration all_default
    w.u(1, 0)  # (reference quirk) gab_custom
    w.u(1, 0)  # epf_weight_custom
    w.u(1, 0)  # epf_sigma_custom
    w.f16(1.0)  # epf sigma_for_modular
    w.u64(0)  # frame extensions


def encode_modular_advanced(
    image: np.ndarray, bpp: int = 8, options: AdvancedOptions | None = None
) -> bytes:
    return _write_header_and_streams(image, bpp, options or AdvancedOptions())


def synthesize_palette(
    palette: np.ndarray,      # (num_c, nb_colours) int32 palette entries
    indices: np.ndarray,      # (h, w) int32; may be negative (built-in deltas)
    nb_deltas: int = 0,
    d_pred: int = 0,
    bpp: int = 8,
    use_prefix: bool = True,
) -> bytes:
    """Write a single-group modular stream with an arbitrary Palette transform
    (incl. delta-palette/prediction and out-of-range synthetic-color indices)
    for decoder-vs-decoder differential testing — the output image need not
    correspond to any encodable source (reference: j40.h:4402-4490)."""
    num_c, nb_colours = palette.shape
    h, w = indices.shape
    assert num_c == 3, "3 color channels"

    m = ModularImage(channels=[])
    palc = Channel(nb_colours, num_c, 0, -1)
    palc.data = np.ascontiguousarray(palette).astype(np.int32)
    idxc = Channel(w, h)
    idxc.data = np.ascontiguousarray(indices).astype(np.int32)
    m.channels = [palc, idxc]
    m.nb_meta_channels = 1
    m.transforms.append(
        Transform(TR_PALETTE, begin_c=0, num_c=num_c,
                  nb_colours=nb_colours, nb_deltas=nb_deltas, d_pred=d_pred)
    )

    opt = AdvancedOptions(use_prefix=use_prefix, tree=[leaf(0)])
    wbw = BitWriter()
    write_signature(wbw)
    write_image_metadata(wbw, w, h, bpp=bpp, xyb_encoded=False)
    wbw.zero_pad_to_byte()
    _write_frame_header(wbw, opt)

    tree = opt.tree
    num_ctx = assign_leaf_contexts(tree)
    sw = BitWriter()
    sw.u(1, 1)  # LfChannelDequantization all_default
    sw.u(1, 0)  # no global tree
    sw.u(1, 0)  # use_global_tree = false
    sw.u(1, 1)  # default WP
    sw.u32(((0, 0), (1, 0), (2, 4), (18, 8)), 1)  # one transform
    sw.u(2, TR_PALETTE)
    sw.u32(U32_BEGIN_C, 0)
    sw.u32(((1, 0), (3, 0), (4, 0), (1, 13)), num_c)
    sw.u32(((0, 8), (256, 10), (1280, 12), (5376, 16)), nb_colours)
    sw.u32(((0, 0), (1, 8), (257, 10), (1281, 16)), nb_deltas)
    sw.u(4, d_pred)
    write_tree(sw, tree, use_prefix)
    genc = EntropyEncoder(num_ctx, use_prefix=use_prefix)
    for ci in range(m.num_channels):
        for ctx, tok in encode_channel_tokens(m, ci, tree, opt.wp_params, 0):
            genc.add(ctx, tok)
    genc.write(sw)

    section = sw.finish()
    wbw.u(1, 0)  # not permuted
    wbw.zero_pad_to_byte()
    wbw.u32(TOC_U32, len(section))
    wbw.zero_pad_to_byte()
    wbw.out.extend(section)
    return wbw.finish()
