"""Modular-mode JPEG XL encoder.

Produces spec-compliant lossless Modular bitstreams (a capability the
reference decoder does not have; akin to fjxl's output shape): per-channel
MA tree with a single leaf and a configurable predictor, prefix or ANS
entropy coding, single- or multi-group layout with TOC.  Primary consumers:
the differential test harness (our decoder and dj40 must agree bit-exactly on
these files) and users wanting a pure-Python lossless encoder.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..mathutil import ceil_div, pack_signed
from ..modular.decode import _predict
from .bitwriter import BitWriter
from .entropy import EntropyEncoder
from .headers import write_image_metadata, write_signature

TOC_U32 = ((0, 10), (1024, 14), (17408, 22), (4211712, 30))


def _predict_scalar(pred: int, w, n, nw, ne, nn, nee, ww):
    return _predict(pred, None, w, n, nw, ne, nn, nee, ww)


def _channel_tokens_np(data: np.ndarray, predictor: int) -> np.ndarray | None:
    """Vectorized residual tokens (predictors 0/5); None for others."""
    a = data.astype(np.int64)
    if predictor == 0:
        res = a.ravel()
    elif predictor == 5:
        W = np.zeros_like(a)
        W[:, 1:] = a[:, :-1]
        W[1:, 0] = a[:-1, 0]
        N = np.zeros_like(a)
        N[1:, :] = a[:-1, :]
        N[0, :] = W[0, :]
        NW = np.zeros_like(a)
        NW[1:, 1:] = a[:-1, :-1]
        NW[0, :] = W[0, :]
        NW[1:, 0] = W[1:, 0]
        lo = np.minimum(W, N)
        hi = np.maximum(W, N)
        grad = np.minimum(np.maximum(lo, W + N - NW), hi)
        res = (a - grad).ravel()
    else:
        return None
    return np.where(res >= 0, res * 2, -res * 2 - 1)  # vectorized pack_signed


def _channel_tokens(data: np.ndarray, predictor: int) -> list[int]:
    """Residual tokens for one channel in scan order (no WP, no tree)."""
    h, wd = data.shape
    a = data.astype(np.int64)
    if predictor == 0:
        res = a
        return [pack_signed(int(v)) for v in res.ravel()]
    if predictor == 5:
        # vectorized gradient predictor: neighbors with edge substitution
        W = np.zeros_like(a)
        W[:, 1:] = a[:, :-1]
        W[1:, 0] = a[:-1, 0]  # x==0: use N
        N = np.zeros_like(a)
        N[1:, :] = a[:-1, :]
        N[0, :] = W[0, :]
        NW = np.zeros_like(a)
        NW[1:, 1:] = a[:-1, :-1]
        NW[0, :] = W[0, :]
        NW[1:, 0] = W[1:, 0]
        lo = np.minimum(W, N)
        hi = np.maximum(W, N)
        grad = np.minimum(np.maximum(lo, W + N - NW), hi)
        res = a - grad
        return [pack_signed(int(v)) for v in res.ravel()]
    # generic scalar path
    out = []
    for y in range(h):
        for x in range(wd):
            w_ = int(a[y, x - 1]) if x > 0 else (int(a[y - 1, x]) if y > 0 else 0)
            n_ = int(a[y - 1, x]) if y > 0 else w_
            nw = int(a[y - 1, x - 1]) if (x > 0 and y > 0) else w_
            ne = int(a[y - 1, x + 1]) if (x + 1 < wd and y > 0) else n_
            nn = int(a[y - 2, x]) if y > 1 else n_
            nee = int(a[y - 1, x + 2]) if (x + 2 < wd and y > 0) else ne
            ww = int(a[y, x - 2]) if x > 1 else w_
            p = _predict_scalar(predictor, w_, n_, nw, ne, nn, nee, ww)
            out.append(pack_signed(int(a[y, x]) - p))
    return out


def _write_single_leaf_tree(w: BitWriter, predictor: int, use_prefix: bool) -> None:
    """Tree with one leaf: predictor, offset 0, multiplier 1 (6 contexts)."""
    enc = EntropyEncoder(6, use_prefix=use_prefix)
    enc.add(1, 0)  # prop token 0 => leaf
    enc.add(2, predictor)
    enc.add(3, 0)  # offset
    enc.add(4, 0)  # multiplier shift
    enc.add(5, 0)  # multiplier-1
    enc.write(w)


def _write_modular_stream(
    w: BitWriter, channels: list[np.ndarray], predictor: int, use_prefix: bool,
    lz77: bool = False
) -> None:
    """Modular sub-bitstream: header (no transforms, local single-leaf tree)
    followed by all channel tokens."""
    w.u(1, 0)  # use_global_tree = false
    w.u(1, 1)  # default WP params
    w.u32(((0, 0), (1, 0), (2, 4), (18, 8)), 0)  # nb_transforms = 0
    _write_single_leaf_tree(w, predictor, use_prefix)
    # leaf code spec + tokens for all channels (single context); dist_mult is
    # the max channel width (j40.h:3840-3844)
    dist_mult = max(c.shape[1] for c in channels)
    enc = EntropyEncoder(1, use_prefix=use_prefix, lz77=lz77,
                         dist_mult=dist_mult if lz77 else 0)
    for data in channels:
        toks = _channel_tokens_np(data, predictor)
        if toks is not None:
            enc.add_array(0, toks)
        else:
            for t in _channel_tokens(data, predictor):
                enc.add(0, t)
    enc.write(w)


@dataclass
class EncodeOptions:
    predictor: int = 5  # gradient; NOT 6 (WP needs the advanced encoder)
    use_prefix: bool = True  # prefix vs ANS coding
    group_size_shift: int = 8
    permute_toc: bool = False  # exercise the TOC permutation path
    #: emit ONE global tree + code spec in LfGlobal shared by all group
    #: sections (cjxl -e2+ shape; j40.h:6320-6336) instead of per-section
    #: local trees — one histogram over the whole image, and the decoder's
    #: device path can batch all sections against shared LUTs
    global_tree: bool = False
    lz77: bool = False  # RLE-style LZ77 emission in the token stream
    frame_extension_bits: int = 0  # emit a skippable frame-header extension
    ycbcr: bool = False  # store YCbCr samples (do_ycbcr; near-lossless)
    # per-channel (Cb, Y, Cr) subsampling codes: 0=full, 1=420, 2=422, 3=440
    ycbcr_subsample: tuple = (0, 0, 0)
    # with ycbcr: take the input's 3 channels as the STORED (Cb, Y, Cr)
    # planes verbatim (signed int), skipping the RGB->YCbCr forward — lets
    # tests drive the render path with hand-picked plane values
    ycbcr_raw: bool = False
    #: per-extra-channel log2 upsampling factors (frame factor stays 0);
    #: each EC plane must then be supplied at ceil(size / 2^v)
    ec_log_upsampling: tuple = ()


def encode_modular(image: np.ndarray, bpp: int = 8,
                   options: EncodeOptions | None = None,
                   orientation: int = 1,
                   icc: bytes | None = None,
                   extra_channels: list | None = None) -> bytes:
    """Encode (h, w, 3) RGB or (h, w, 4) RGBA losslessly.

    Returns a bare JPEG XL codestream (FF 0A ...).  bpp up to 15 uses 16-bit
    sample buffers (decodable by the reference, j40.h:4225); higher bpp (up
    to 28) switches to 32-bit buffers, which need Level-10 limits to decode
    (`decode_file(data, limits=MAIN_LV10)`; the reference rejects these).
    `orientation` stores the image with an EXIF-style display transform.
    `extra_channels` is a list of (declaration dict, (h, w) plane) pairs for
    explicitly-declared channels (depth, spot colour, named alpha, ...)."""
    opt = options or EncodeOptions()
    assert opt.predictor != 6, "weighted predictor needs encode_modular_advanced"
    assert image.ndim == 3 and image.shape[2] in (1, 2, 3, 4), "need (h,w,1..4)"
    h, wd, nc = image.shape
    grayscale = nc <= 2
    num_alpha = 1 if nc in (2, 4) else 0
    extras = extra_channels or []
    nec = num_alpha + len(extras)

    w = BitWriter()
    write_signature(w)
    write_image_metadata(w, wd, h, bpp=bpp, xyb_encoded=False,
                         num_alpha=num_alpha, grayscale=grayscale,
                         orientation=orientation, want_icc=icc is not None,
                         extra_decls=[d for d, _ in extras],
                         modular_16bit=bpp <= 15)
    if icc is not None:
        from .headers import write_icc

        write_icc(w, icc, use_prefix=opt.use_prefix)

    _write_modular_frame_header(w, num_alpha=nec, opt=opt, im_size=(wd, h))

    channels = [image[:, :, c].astype(np.int32) for c in range(nc)]
    if opt.ycbcr:
        assert not grayscale and bpp == 8, "ycbcr: 8-bit color only"
        if not opt.ycbcr_raw:
            r, g, b = (image[:, :, c].astype(np.float64) for c in range(3))
            # full-range BT.601, channels centered, luma in slot 1 (render
            # side: decode.py render_rgba8 YCbCr branch)
            yv = 0.299 * r + 0.587 * g + 0.114 * b
            cb = -0.168736 * r - 0.331264 * g + 0.5 * b
            cr = 0.5 * r - 0.418688 * g - 0.081312 * b
            channels[0] = np.round(cb).astype(np.int32)
            channels[1] = (np.round(yv) - 128).astype(np.int32)
            channels[2] = np.round(cr).astype(np.int32)
        if any(opt.ycbcr_subsample):
            assert h <= 1 << opt.group_size_shift and wd <= 1 << opt.group_size_shift, \
                "subsampled ycbcr: single-group only"
            for i, code in enumerate(opt.ycbcr_subsample):
                p = channels[i]
                if code in (1, 2):
                    p = p[:, ::2]
                if code in (1, 3):
                    p = p[::2, :]
                channels[i] = np.ascontiguousarray(p)
    channels += [np.asarray(p, dtype=np.int32) for _, p in extras]
    _write_frame_body(w, channels, wd, h, opt)
    return w.finish()


CROP_U32 = ((0, 8), (256, 11), (2304, 14), (18688, 30))


def _write_modular_frame_header(
    w: BitWriter,
    *,
    num_alpha: int,
    opt: EncodeOptions,
    im_size: tuple[int, int],
    frame_size: tuple[int, int] | None = None,
    origin: tuple[int, int] = (0, 0),
    is_last: bool = True,
    duration: int = 0,
    save_as_ref: int = 0,
    have_anim: bool = False,
    blend_mode: int = 0,
    clamp: int = 0,
) -> None:
    """FrameHeader (not all_default; read side frame.py:101-253 field order).

    `frame_size`/`origin` emit the have_crop path; `have_anim` must match the
    image metadata's have_animation (the duration field is conditional on it)."""
    imw, imh = im_size
    fw, fh = frame_size or im_size
    x0, y0 = origin
    w.zero_pad_to_byte()
    w.u(1, 0)  # not all_default
    w.u(2, 0)  # type = regular
    w.u(1, 1)  # is_modular
    w.u64(0)  # flags
    w.u(1, 1 if opt.ycbcr else 0)  # do_ycbcr (xyb_encoded false)
    if opt.ycbcr:
        s0, s1, s2 = opt.ycbcr_subsample
        w.u(6, s0 | (s1 << 2) | (s2 << 4))  # jpeg_upsampling
    w.u(2, 0)  # log_upsampling
    for i in range(num_alpha):
        v = opt.ec_log_upsampling[i] if i < len(opt.ec_log_upsampling) else 0
        w.u(2, v)  # per-extra-channel upsampling
    w.u(2, opt.group_size_shift - 7)  # group_size_shift
    w.u32(((1, 0), (2, 0), (3, 0), (4, 3)), 1)  # num_passes = 1
    have_crop = not (fw == imw and fh == imh and x0 == 0 and y0 == 0)
    w.u(1, 1 if have_crop else 0)
    if have_crop:
        w.u32(CROP_U32, pack_signed(x0))
        w.u32(CROP_U32, pack_signed(y0))
        w.u32(CROP_U32, fw)
        w.u32(CROP_U32, fh)
    full_frame = x0 <= 0 and y0 <= 0 and fw + x0 >= imw and fh + y0 >= imh
    # blending for color + each extra channel; the alpha-weighted modes keep
    # the alpha channel itself on BLEND (over) / REPLACE so it composes sanely
    modes = [blend_mode] + [blend_mode if blend_mode == 2 else 0] * num_alpha
    for mode in modes:
        w.u32(((0, 0), (1, 0), (2, 0), (3, 2)), mode)
        if num_alpha > 0:
            if mode in (2, 3):  # BLEND / MUL_ADD: alpha_chan + clamp
                w.u32(((0, 0), (1, 0), (2, 0), (3, 3)), 0)
                w.u(1, clamp)
            elif mode == 4:  # MUL: clamp
                w.u(1, clamp)
        if not full_frame or mode != 0:
            w.u(2, 0)  # src_ref_frame
    if have_anim:
        w.u32(((0, 0), (1, 0), (0, 8), (0, 32)), duration)
    w.u(1, 1 if is_last else 0)
    if not is_last:
        w.u(2, save_as_ref)
        if full_frame and blend_mode == 0 and (duration == 0 or save_as_ref != 0):
            w.u(1, 0)  # save_before_ct (don't-care for non-XYB modular)
    w.u32(((0, 0), (0, 4), (16, 5), (48, 10)), 0)  # name_len = 0
    w.u(1, 1)  # restoration all_default
    # NOTE: the reference decoder reads gab_custom and epf bits even in the
    # all-default case (j40.h:5338-5366); emit matching zero bits
    w.u(1, 0)  # gab_custom = false
    w.u(1, 0)  # epf_sharp_custom?? -- modular: skipped; epf_weight_custom
    w.u(1, 0)  # epf_sigma_custom
    w.f16(1.0)  # epf sigma_for_modular (modular frames)
    # restoration extensions are NOT read when restoration_all_default is set
    if opt.frame_extension_bits:
        # extensions bitmask + per-extension payload length, then the payload
        # bits the decoder must skip (read side: image.py:181-187).
        # NOTE: the reference's j40__skip (j40.h:1895-1901) double-skips when
        # its bit accumulator already holds >= n bits (the byte-skip half is
        # not in the else branch); payloads of >= 64 bits always take the
        # correct path since the accumulator holds at most 63, so we round
        # the payload up to stay decodable by dj40.
        nbits = max(64, opt.frame_extension_bits)
        w.u64(1)
        w.u64(nbits)
        for _ in range(nbits):
            w.u(1, 0)
    else:
        w.u64(0)  # extensions (frame header)


def _write_frame_body(
    w: BitWriter, channels: list[np.ndarray], wd: int, h: int, opt: EncodeOptions
) -> None:
    """TOC + sections for one modular frame (single- or multi-group)."""
    group_size = 1 << opt.group_size_shift
    gcolumns = ceil_div(wd, group_size)
    grows = ceil_div(h, group_size)
    num_groups = gcolumns * grows
    gg_size = group_size * 8
    ggcolumns = ceil_div(wd, gg_size)
    ggrows = ceil_div(h, gg_size)
    num_lf_groups = ggcolumns * ggrows

    if num_groups == 1:
        # single-section layout
        sw = BitWriter()
        _lf_global_single(sw, channels, opt)
        section = sw.finish()
        w.u(1, 0)  # not permuted
        w.zero_pad_to_byte()
        w.u32(TOC_U32, len(section))
        w.zero_pad_to_byte()
        w.out.extend(section)
        return

    # multi-group layout: LfGlobal + LF groups (empty) + HfGlobal(empty) + groups
    group_slices = []
    for gidx in range(num_groups):
        row, col = divmod(gidx, gcolumns)
        x0 = col * group_size
        y0 = row * group_size
        gw_ = min(wd - x0, group_size)
        gh_ = min(h - y0, group_size)
        group_slices.append([c[y0 : y0 + gh_, x0 : x0 + gw_]
                             for c in channels])

    genc = None
    if opt.global_tree and not opt.lz77:
        # one spec over all sections' tokens, emitted with the global tree
        from .entropy import EntropyEncoder

        genc = EntropyEncoder(1, use_prefix=opt.use_prefix)
        # stream `num_groups` is LfGlobal's own (empty) gmodular stream: its
        # code is still finish()ed by the decoder, which for ANS reads the
        # 32-bit init state even when nothing was decoded (j40.h:2884-2891)
        genc.streams.setdefault(num_groups, [])
        for gidx, chans in enumerate(group_slices):
            for data in chans:
                toks = _channel_tokens_np(data, opt.predictor)
                if toks is not None:
                    genc.add_array(0, toks, stream=gidx)
                else:
                    for t in _channel_tokens(data, opt.predictor):
                        genc.add(0, t, stream=gidx)

    sections: list[bytes] = []
    sw = BitWriter()
    _lf_global_multi(sw, channels, opt, genc)
    sections.append(sw.finish())
    for _ in range(num_lf_groups):
        sections.append(b"")  # no shift>=3 channels -> empty LF group sections
    sections.append(b"")  # HfGlobal: must be empty for modular frames
    for gidx, chans in enumerate(group_slices):
        gsw = BitWriter()
        if genc is not None:
            # header referencing the global tree, then this section's tokens
            gsw.u(1, 1)  # use_global_tree
            gsw.u(1, 1)  # default WP params
            gsw.u32(((0, 0), (1, 0), (2, 4), (18, 8)), 0)  # no transforms
            genc.write_tokens(gsw, stream=gidx)
        else:
            _write_modular_stream(gsw, chans, opt.predictor, opt.use_prefix,
                                  lz77=opt.lz77)
        sections.append(gsw.finish())

    _write_toc(w, sections, opt.permute_toc, opt.use_prefix)


def encode_animation(
    frames,
    bpp: int = 8,
    options: EncodeOptions | None = None,
    tps: tuple[int, int] = (10, 1),
    num_loops: int = 0,
) -> bytes:
    """Encode an animated codestream (a capability beyond the reference,
    which rejects any non-final frame at j40.h:5201).

    `frames` is a list of `(image, duration)`, `(image, duration, (x0, y0))`,
    or `(image, duration, (x0, y0), blend)` tuples; the first frame must be
    image-sized, later frames may be crops composited at `(x0, y0)` over
    reference slot 0.  `blend` is one of "replace" (default), "add", "blend"
    (alpha over; needs an alpha channel), "mul_add", "mul".  `duration` is in
    ticks of `tps[1]/tps[0]` seconds; intermediate frames may use duration 0
    (composited but not displayed)."""
    BLEND_NAMES = {"replace": 0, "add": 1, "blend": 2, "mul_add": 3, "mul": 4}
    opt = options or EncodeOptions()
    items = []
    for fr in frames:
        img = np.asarray(fr[0])
        origin = fr[2] if len(fr) > 2 else (0, 0)
        blend = BLEND_NAMES[fr[3]] if len(fr) > 3 else 0
        assert img.ndim == 3 and img.shape[2] in (1, 2, 3, 4), "need (h,w,1..4)"
        items.append((img, int(fr[1]), origin, blend))
    assert items, "need at least one frame"
    h, wd, nc = items[0][0].shape
    assert items[0][2] == (0, 0), "first frame must be full-size at (0, 0)"
    grayscale = nc <= 2
    num_alpha = 1 if nc in (2, 4) else 0

    w = BitWriter()
    write_signature(w)
    write_image_metadata(
        w, wd, h, bpp=bpp, xyb_encoded=False, num_alpha=num_alpha,
        grayscale=grayscale, animation=(tps[0], tps[1], num_loops),
    )
    for i, (img, duration, (x0, y0), blend) in enumerate(items):
        fh, fw = img.shape[:2]
        assert img.shape[2] == nc, "channel count must match across frames"
        assert blend not in (2, 3) or num_alpha, "alpha-weighted blend needs alpha"
        _write_modular_frame_header(
            w, num_alpha=num_alpha, opt=opt, im_size=(wd, h),
            frame_size=(fw, fh), origin=(x0, y0),
            is_last=(i == len(items) - 1), duration=duration, have_anim=True,
            blend_mode=blend, clamp=1,
        )
        channels = [img[:, :, c].astype(np.int32) for c in range(nc)]
        _write_frame_body(w, channels, fw, fh, opt)
    return w.finish()


def _write_toc(w: BitWriter, sections: list[bytes], permute: bool,
               use_prefix: bool) -> None:
    """Emit the TOC; optionally with a Lehmer-coded section permutation
    (j40.h:5505-5543).  Sizes and payloads are stored in permuted order; the
    decoder's apply_permutation maps them back to role order."""
    n = len(sections)
    if not permute or n <= 1:
        w.u(1, 0)  # not permuted
        w.zero_pad_to_byte()
        for s in sections:
            w.u32(TOC_U32, len(s))
        w.zero_pad_to_byte()
        for s in sections:
            w.out.extend(s)
        return
    from .entropy import EntropyEncoder
    from .permute import add_permutation_tokens, lehmer_encode

    # deterministic nontrivial shuffle: reverse the section order
    shuffle = list(range(n))[::-1]  # stored[j] holds role shuffle[j]
    perm = [0] * n  # perm[i] = stored position of role i
    for j, role in enumerate(shuffle):
        perm[role] = j
    lehmer = lehmer_encode(perm)
    w.u(1, 1)  # permuted
    enc = EntropyEncoder(8, use_prefix=use_prefix)
    add_permutation_tokens(enc, lehmer, n, 0)
    enc.write(w)
    w.zero_pad_to_byte()
    stored = [sections[role] for role in shuffle]
    for s in stored:
        w.u32(TOC_U32, len(s))
    w.zero_pad_to_byte()
    for s in stored:
        w.out.extend(s)


def _lf_global_single(w: BitWriter, channels, opt: EncodeOptions) -> None:
    """LfGlobal for the single-group case: all channels decoded globally."""
    w.u(1, 1)  # LfChannelDequantization all_default
    w.u(1, 0)  # no global tree
    _write_modular_stream(w, channels, opt.predictor, opt.use_prefix,
                          lz77=opt.lz77)


def _lf_global_multi(w: BitWriter, channels, opt: EncodeOptions,
                     genc=None) -> None:
    """LfGlobal for multi-group: gmodular header (no global channels since
    there are no meta channels); with `genc`, also the global tree + the
    shared leaf code spec every section decodes against (j40.h:6320-6336)."""
    w.u(1, 1)  # LfChannelDequantization all_default
    if genc is not None:
        w.u(1, 1)  # global tree present
        _write_single_leaf_tree(w, opt.predictor, opt.use_prefix)
        genc.write_spec(w)  # leaf code spec read at the end of read_tree
        # gmodular header references the global tree; nothing decodes here
        w.u(1, 1)  # use_global_tree
        w.u(1, 1)  # default WP
        w.u32(((0, 0), (1, 0), (2, 4), (18, 8)), 0)  # nb_transforms = 0
        # the decoder still finish()es this (empty) stream's code
        genc.write_tokens(w, stream=max(genc.streams))
        return
    w.u(1, 0)  # no global tree
    # gmodular header: local tree; channels are decoded in the group sections
    w.u(1, 0)  # use_global_tree = false
    w.u(1, 1)  # default WP
    w.u32(((0, 0), (1, 0), (2, 4), (18, 8)), 0)  # nb_transforms = 0
    _write_single_leaf_tree(w, opt.predictor, opt.use_prefix)
    # the leaf code spec is always read at the end of the tree, even though no
    # channel is decoded globally here (read_tree -> read_code_spec(ctx_id))
    EntropyEncoder(1, use_prefix=opt.use_prefix).write(w)
