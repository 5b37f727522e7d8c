"""VarDCT-mode JPEG XL encoder (lossy, 8x8 DCT blocks).

(frozen copy: see jxlbench/frozen_vardct/__init__.py for the commit and
the additions.)

Forward path: sRGB → linear → XYB → per-block DCT → quantize with the library
dequant matrices → HF coefficient streams with the spec's context modeling.
Defaults mirror the decoder's (default block context map, natural orders,
single pass, one HF preset).  LF smoothing is bypassed via the
skip_adapt_lf_smooth frame flag so quantization is exactly invertible modulo
rounding.  Primary consumers: the differential test harness (dj40 PSNR
comparison) and the benchmark input generator.
"""

from __future__ import annotations

import functools

from dataclasses import dataclass

import numpy as np

from ..frozen.headers.image import OPSIN_BIAS, OPSIN_INV_MAT, QUANT_BIAS, QUANT_BIAS_NUM
from ..frozen.mathutil import ceil_div, pack_signed
from .vardct.dct import forward_matrix
from .vardct.dequant import load_dq_matrix
from .vardct.dequant import DqMatrix
from .vardct.order import natural_order
from .vardct.tables import (
    DEFAULT_BLKCTX,
    QM_SCALE,
    TWICE_COEFF_FREQ_CTX,
    TWICE_COEFF_NNZ_CTX,
)
from ..frozen.io.bits import ceil_lg
from ..frozen.encode.bitwriter import BitWriter
from ..frozen.encode.encoder import TOC_U32
from ..frozen.encode.entropy import EntropyEncoder
from ..frozen.encode.headers import write_image_metadata, write_signature

YXB2XYB = (1, 0, 2)


def srgb_to_xyb(rgb: np.ndarray, intensity_target: float = 255.0,
                maxval: float = 255.0) -> np.ndarray:
    """(h, w, 3) uint8/uint16 sRGB -> (3, h, w) float32 XYB, inverting the
    decoder's XYB -> sRGB path (j40.h:7208-7241).  `maxval` is the sample
    maximum ((1<<bpp)-1); >8bpp inputs are uint16."""
    if rgb.dtype == np.uint8 and maxval == 255.0:
        # gamma expansion via a 256-entry LUT: bit-identical to the direct
        # formula (the input has 256 distinct values) and skips ~10M pow calls
        s = np.arange(256, dtype=np.float64) / 255.0
        lut = np.where(s <= 0.04045, s / 12.92, ((s + 0.055) / 1.055) ** 2.4)
        linear = lut[rgb]
    else:
        srgb = rgb.astype(np.float64) / maxval
        linear = np.where(
            srgb <= 0.04045, srgb / 12.92, ((srgb + 0.055) / 1.055) ** 2.4
        )
    inv = np.array(OPSIN_INV_MAT, dtype=np.float64)
    fwd = np.linalg.inv(inv)
    mixed = np.einsum("ij,hwj->hwi", fwd, linear)  # "scaled-cubed" domain
    itscale = 255.0 / intensity_target
    bias = np.array([OPSIN_BIAS] * 3)
    cbrt_bias = np.cbrt(bias)
    # in-place chain (bit-identical to the expression form): these are 8
    # bytes/px/channel passes, and fresh 10s-of-MB temporaries per op are
    # minor-fault-bound on this host (huge pages are off, see __init__)
    p = mixed
    if itscale != 1.0:
        np.divide(p, itscale, out=p)
    np.subtract(p, bias, out=p)
    np.maximum(p, 0.0, out=p)
    np.cbrt(p, out=p)
    np.add(p, cbrt_bias, out=p)
    out = np.empty((3,) + rgb.shape[:2], np.float32)
    out[0] = (p[:, :, 0] - p[:, :, 1]) / 2.0
    out[1] = (p[:, :, 0] + p[:, :, 1]) / 2.0
    out[2] = p[:, :, 2]
    return out


@dataclass
class VarDCTOptions:
    global_scale: int = 32768
    quant_lf: int = 64
    hf_mul: int = 8
    use_prefix: bool = True
    sharpness: int = 0  # per-block EPF sharpness (0 = EPF skips the block)
    custom_order: bool = False  # Lehmer-permuted coefficient order (order 0)
    num_passes: int = 1  # progressive passes (coefficients split additively)
    custom_dq: bool = False  # write custom dequant matrices (all modes)
    num_hf_presets: int = 1  # per-group preset selectors (context offsets)
    # custom HF block context: dict(lf_thr=[[..]x3], qf_thr=[..], map=[..])
    block_ctx: dict | None = None
    # custom LfChannelDequantization scales (must be f16-exact); None = default
    m_lf_scaled: tuple | None = None
    # emit custom RestorationFilter params in the frame header (gab weights,
    # EPF sharp/weight/sigma tables); exercises the parse path
    custom_restoration: bool = False
    epf_iters: int = 2  # with custom_restoration: number of EPF steps (0-3)
    # custom opsin inverse matrix/biases (f16-exact), see write_image_metadata
    opsin: tuple | None = None
    # custom ToneMapping intensity target in nits (f16-exact); None = 255
    intensity_target: float | None = None
    # sample bit depth (8..14; >8 inputs are uint16 and render to RGBA16)
    bpp: int = 8
    # number of clusters for the HF coefficient code spec (1 = the classic
    # single-cluster emission; >= 2 partitions the 495*nb_block_ctx
    # contexts so decoding requires the full context model — the shape
    # real cjxl output has)
    coeff_clusters: int = 1
    # frozen copy: the RestorationFilter as cjxl writes it for a VarDCT
    # frame at -d 0.5 -e 7 (synthesize_vardct): not all_default, gaborish
    # on with the default weights, no EPF
    cjxl_restoration: bool = False


def encode_vardct(image: np.ndarray, options: VarDCTOptions | None = None) -> bytes:
    """Encode (h, w, 3) RGB or (h, w, 4) RGBA uint8 sRGB as a VarDCT frame
    (8x8 blocks; alpha is carried as a losslessly-coded extra channel).

    Any size up to the level-5 limits; images beyond 2048px use the
    multi-LF-group layout."""
    opt = options or VarDCTOptions()
    h, wd, nc = image.shape
    w = BitWriter()
    write_signature(w)
    write_image_metadata(w, wd, h, bpp=opt.bpp, xyb_encoded=True,
                         num_alpha=0 if nc != 4 else 1, opsin=opt.opsin,
                         intensity_target=opt.intensity_target)
    _encode_vardct_frame(w, image, opt)
    return w.finish()


def encode_vardct_animation(
    frames,
    options: VarDCTOptions | None = None,
    tps: tuple[int, int] = (10, 1),
    num_loops: int = 0,
) -> bytes:
    """Animated VarDCT codestream: full-frame REPLACE frames with durations.

    `frames` is a list of (image, duration_ticks); all frames image-sized.
    (The reference rejects any non-final frame, j40.h:5201.)"""
    opt = options or VarDCTOptions()
    imgs = [np.asarray(f[0]) for f in frames]
    h, wd, nc = imgs[0].shape
    w = BitWriter()
    write_signature(w)
    write_image_metadata(w, wd, h, bpp=8, xyb_encoded=True,
                         num_alpha=0 if nc != 4 else 1, opsin=opt.opsin,
                         intensity_target=opt.intensity_target,
                         animation=(tps[0], tps[1], num_loops))
    for i, (img, duration) in enumerate(frames):
        img = np.asarray(img)
        assert img.shape == (h, wd, nc), "frame shape mismatch"
        _encode_vardct_frame(w, img, opt, is_last=(i == len(frames) - 1),
                             duration=int(duration), have_anim=True)
    return w.finish()


def _encode_vardct_frame(w: BitWriter, image: np.ndarray,
                         opt: VarDCTOptions, *, is_last: bool = True,
                         duration: int = 0, have_anim: bool = False) -> None:
    h, wd, nc = image.shape
    alpha = image[:, :, 3] if nc == 4 else None
    if alpha is not None and (h > 256 or wd > 256):
        assert opt.num_passes == 1, "multi-group VarDCT alpha: single pass only"
    image = image[:, :, :3]
    h8, w8 = ceil_div(h, 8), ceil_div(wd, 8)

    # pad to multiple of 8 by edge replication
    pad = np.pad(image, ((0, h8 * 8 - h), (0, w8 * 8 - wd), (0, 0)), mode="edge")
    xyb = srgb_to_xyb(pad, maxval=float((1 << opt.bpp) - 1))  # (3, H, W)

    # forward DCT per 8x8 block: C = F8 @ block @ F8^T / 64
    F8 = forward_matrix(8).astype(np.float64)
    blocks = xyb.reshape(3, h8, 8, w8, 8).transpose(0, 1, 3, 2, 4)  # (3,h8,w8,8,8)
    C = np.einsum("ij,chwjk,lk->chwil", F8, blocks.astype(np.float64), F8) / 64.0
    # canonical layout for square blocks is transposed: W[j,i] = C[i,j]
    Wc = C.transpose(0, 1, 2, 4, 3).reshape(3, h8, w8, 64)

    m_lf_scaled = opt.m_lf_scaled or (1.0 / 4096.0, 1.0 / 512.0, 1.0 / 256.0)
    mult_lf = [
        m_lf_scaled[c] / (opt.global_scale * opt.quant_lf) * 65536 for c in range(3)
    ]
    dq_w = _signaled_dq64(opt, 0)  # DCT8x8 weights as signaled (64, 3)
    mult1 = 65536.0 / opt.global_scale / opt.hf_mul
    mults = (mult1 * QM_SCALE[3], mult1, mult1 * QM_SCALE[2])  # x_qm_scale=3, b_qm=2

    # --- LF (DC) quantization, with B-channel CfL (kb_lf = base_corr_b = 1)
    dc = Wc[:, :, :, 0]  # (3, h8, w8)
    lf_int = np.zeros((3, h8, w8), dtype=np.int64)
    lf_deq = np.zeros((3, h8, w8))
    lf_int[1] = np.round(dc[1] / mult_lf[1])
    lf_deq[1] = lf_int[1] * mult_lf[1]
    lf_int[0] = np.round(dc[0] / mult_lf[0])  # kx_lf = 0
    lf_deq[0] = lf_int[0] * mult_lf[0]
    lf_int[2] = np.round((dc[2] - lf_deq[1]) / mult_lf[2])  # kb_lf = 1
    lf_deq[2] = lf_int[2] * mult_lf[2]

    # --- HF quantization with decoder-exact Y dequant for B CfL
    qbias = np.array(QUANT_BIAS)
    hf_int = np.zeros((3, h8, w8, 64), dtype=np.int64)

    def dequant(q, c):
        qf = q.astype(np.float64)
        small = np.abs(qf) <= 1.0
        adj = np.where(small, qf * qbias[c], qf - QUANT_BIAS_NUM / np.where(qf == 0, 1, qf))
        return adj * (mults[c] / dq_w[:, c])

    hf_int[1] = np.round(Wc[1] * dq_w[:, 1] / mults[1])
    y_deq = dequant(hf_int[1], 1)
    hf_int[0] = np.round(Wc[0] * dq_w[:, 0] / mults[0])  # kx_hf = 0
    hf_int[2] = np.round((Wc[2] - y_deq) * dq_w[:, 2] / mults[2])  # kb_hf = 1
    # LLF position is not HF-coded
    hf_int[:, :, :, 0] = 0

    # --- assemble bitstream: frame header (VarDCT)
    w.zero_pad_to_byte()
    w.u(1, 0)  # not all_default
    w.u(2, 0)  # regular
    w.u(1, 0)  # is_modular = false
    w.u64(128)  # flags: skip_adapt_lf_smooth
    # xyb_encoded -> no do_ycbcr bit
    w.u(2, 0)  # log_upsampling
    if alpha is not None:
        w.u(2, 0)  # alpha channel upsampling
    w.u(3, 3)  # x_qm_scale
    w.u(3, 2)  # b_qm_scale
    w.u32(((1, 0), (2, 0), (3, 0), (4, 3)), opt.num_passes)  # num_passes
    if opt.num_passes > 1:
        w.u32(((0, 0), (1, 0), (2, 0), (3, 1)), 0)  # num_ds = 0
        for _ in range(opt.num_passes - 1):
            w.u(2, 0)  # per-pass shift
    w.u(1, 0)  # have_crop
    for _ in range(1 + (0 if alpha is None else 1)):
        w.u32(((0, 0), (1, 0), (2, 0), (3, 2)), 0)  # blend replace
    if have_anim:
        w.u32(((0, 0), (1, 0), (0, 8), (0, 32)), duration)
    w.u(1, 1 if is_last else 0)
    if not is_last:
        w.u(2, 0)  # save_as_ref
        if duration == 0:
            w.u(1, 0)  # save_before_ct (full REPLACE, duration 0)
    w.u32(((0, 0), (0, 4), (16, 5), (48, 10)), 0)  # name_len
    if opt.custom_restoration:
        _write_custom_restoration(w, opt.epf_iters)
    else:
        w.u(1, 1)  # restoration all_default
        w.u(1, 0)  # (quirk) gab_custom
        w.u(1, 0)  # (quirk) epf_sharp_custom (non-modular)
        w.u(1, 0)  # epf_weight_custom
        w.u(1, 0)  # epf_sigma_custom
    w.u64(0)  # frame extensions

    gcols, grows = ceil_div(wd, 256), ceil_div(h, 256)
    num_groups = gcols * grows

    # split coefficients additively across passes (decoder accumulates with
    # `+=`, j40.h:6989): earlier passes drop |q|<=1 detail
    passes_hf = []
    rem = hf_int
    for _p in range(opt.num_passes - 1):
        coarse = np.where(np.abs(rem) <= 1, 0, rem)
        passes_hf.append(coarse)
        rem = rem - coarse
    passes_hf.append(rem)

    # the per-pass coefficient code SPECs live in HfGlobal while the TOKENS
    # live in the per-(pass, group) sections, so collect all streams first
    coeff_encs = [
        _collect_pass_group_tokens(opt, p_hf, h8, w8, gcols=gcols, grows=grows)
        for p_hf in passes_hf
    ]

    if num_groups == 1 and opt.num_passes == 1:
        sw = BitWriter()
        _write_lf_global(sw, opt, alpha=alpha)
        _write_hf_global(sw, opt, num_groups=1, coeff_encs=coeff_encs)
        _write_lf_group(sw, opt, lf_int, h8, w8)
        # pass group: preset selector is u(ceil_lg(1)) = 0 bits, then tokens
        coeff_encs[0].write_tokens(sw, 0)
        section = sw.finish()
        w.u(1, 0)  # TOC not permuted
        w.zero_pad_to_byte()
        w.u32(TOC_U32, len(section))
        w.zero_pad_to_byte()
        w.out.extend(section)
        return

    # multi-group/multi-pass:
    # LfGlobal + per-LF-group + HfGlobal + per-(pass, group) sections
    gg_cols, gg_rows = ceil_div(wd, 2048), ceil_div(h, 2048)
    sections: list[bytes] = []
    sw = BitWriter()
    _write_lf_global(sw, opt, alpha=alpha, multi_group=True)
    sections.append(sw.finish())
    for ggr in range(gg_rows):
        for ggc in range(gg_cols):
            y0, x0 = ggr * 256, ggc * 256  # in 8px block units
            gh8 = min(h8 - y0, 256)
            gw8 = min(w8 - x0, 256)
            sw = BitWriter()
            _write_lf_group(
                sw, opt, lf_int[:, y0 : y0 + gh8, x0 : x0 + gw8], gh8, gw8
            )
            sections.append(sw.finish())
    sw = BitWriter()
    _write_hf_global(sw, opt, num_groups=num_groups, coeff_encs=coeff_encs)
    sections.append(sw.finish())
    from ..frozen.encode.encoder import _write_modular_stream

    for p_i in range(opt.num_passes):
        for g in range(num_groups):
            sw = BitWriter()
            sw.u(ceil_lg(opt.num_hf_presets), g % opt.num_hf_presets)
            coeff_encs[p_i].write_tokens(sw, g)
            if alpha is not None:
                # the group's slice of each extra channel decodes as a
                # modular sub-stream after the HF tokens (frame_state
                # pass_group -> _modular_group)
                row, col = divmod(g, gcols)
                y0, x0 = row * 256, col * 256
                sl = np.asarray(
                    alpha[y0 : y0 + 256, x0 : x0 + 256], np.int32
                )
                _write_modular_stream(sw, [sl], predictor=5,
                                      use_prefix=opt.use_prefix)
            sections.append(sw.finish())

    w.u(1, 0)  # TOC not permuted
    w.zero_pad_to_byte()
    for sct in sections:
        w.u32(TOC_U32, len(sct))
    w.zero_pad_to_byte()
    for sct in sections:
        w.out.extend(sct)


def _write_custom_restoration(w: BitWriter, epf_iters: int = 2) -> None:
    """Non-default RestorationFilter fields (read side: frame.py:217-243);
    all values f16-exact so the decoders' parses agree bit-for-bit."""
    w.u(1, 0)  # restoration not all_default
    w.u(1, 1)  # gab enabled
    w.u(1, 1)  # gab_custom
    for wt in (0.125, 0.0625, 0.109375, 0.0546875, 0.115234375, 0.061279296875):
        w.f16(wt)
    w.u(2, epf_iters)
    if epf_iters:  # sub-fields only read when epf_iters > 0 (frame.py:230)
        w.u(1, 1)  # epf_sharp_custom (non-modular)
        for i in range(8):
            w.f16(i / 8.0)
        w.u(1, 1)  # epf_weight_custom
        for v in (40.0, 5.0, 3.5):
            w.f16(v)
        w.u(32, 0)  # 32 reserved bits the reference skips
        w.u(1, 1)  # epf_sigma_custom
        for v in (0.5, 0.875, 6.5, 0.6875):  # quant_mul, pass0, pass2, border
            w.f16(v)
    # restoration extensions are read when not all_default
    w.u64(0)


def _write_lf_global(w: BitWriter, opt: VarDCTOptions, alpha=None,
                     multi_group: bool = False) -> None:
    from ..frozen.encode.encoder import _write_modular_stream, _write_single_leaf_tree

    if opt.m_lf_scaled is not None:
        w.u(1, 0)  # LfChannelDequantization not all_default
        for v in opt.m_lf_scaled:
            w.f16(v * 128.0)
    else:
        w.u(1, 1)  # LfChannelDequantization all_default
    w.u32(((1, 11), (2049, 11), (4097, 12), (8193, 16)), opt.global_scale)
    w.u32(((16, 0), (1, 5), (1, 8), (1, 16)), opt.quant_lf)
    if opt.block_ctx is None:
        w.u(1, 1)  # default HF block context
    else:
        from ..frozen.mathutil import pack_signed

        bc = opt.block_ctx
        w.u(1, 0)
        for i in range(3):
            thr = bc["lf_thr"][i]
            w.u(4, len(thr))
            for t in thr:
                w.u32(((0, 4), (16, 8), (272, 16), (65808, 32)), pack_signed(t))
        w.u(4, len(bc["qf_thr"]))
        for t in bc["qf_thr"]:
            w.u32(((0, 2), (4, 3), (12, 5), (44, 8)), t - 1)
        # cluster map over the full context table (simple encoding)
        cmap = bc["map"]
        nclusters = max(cmap) + 1
        w.u(1, 1)  # is_simple
        nbits = (nclusters - 1).bit_length()
        w.u(2, nbits)
        for c in cmap:
            w.u(nbits, c)
    w.u(1, 1)  # LfChannelCorrelation all_default
    w.u(1, 0)  # no global tree
    if alpha is not None:
        if multi_group:
            # gmodular header only: the channels decode in their pass-group
            # sections (same shape as the modular encoder's multi-group
            # LfGlobal; the leaf code spec is read even with no global
            # channels)
            w.u(1, 0)  # use_global_tree = false
            w.u(1, 1)  # default WP
            w.u32(((0, 0), (1, 0), (2, 4), (18, 8)), 0)  # no transforms
            _write_single_leaf_tree(w, 5, opt.use_prefix)
            EntropyEncoder(1, use_prefix=opt.use_prefix).write(w)
        else:
            # single-group layout: the extra channels decode right here
            _write_modular_stream(w, [np.asarray(alpha, np.int32)],
                                  predictor=5, use_prefix=opt.use_prefix)


def _write_hf_global(w: BitWriter, opt: VarDCTOptions, num_groups: int,
                     coeff_encs: list,
                     used_order_indices: tuple = (0,)) -> None:
    if opt.custom_dq:
        w.u(1, 0)  # custom dq matrices follow
        _write_dq_matrices(w, opt)
    else:
        w.u(1, 1)  # default dq matrices
    assert opt.num_hf_presets <= num_groups
    w.u(ceil_lg(num_groups), opt.num_hf_presets - 1)
    for coeff_enc in coeff_encs:
        _write_hf_pass(w, opt, coeff_enc, used_order_indices)


def _write_hf_pass(w: BitWriter, opt: VarDCTOptions, coeff_enc,
                   used_order_indices: tuple = (0,)) -> None:
    if opt.custom_order:
        # Lehmer-permuted orders for every order index the stream uses
        # (the reader walks set bits ascending, 3 channels each,
        # state.py:204-218 / j40.h:6844-6857)
        from .vardct.tables import LOG_ORDER_SIZE
        from ..frozen.encode.permute import add_permutation_tokens, lehmer_encode

        used_bits = 0
        for j in used_order_indices:
            used_bits |= 1 << j
        w.u32(((0x5F, 0), (0x13, 0), (0, 0), (0, 13)), used_bits)
        enc = EntropyEncoder(8, use_prefix=opt.use_prefix)
        for j in sorted(used_order_indices):
            size = 1 << (LOG_ORDER_SIZE[j][0] + LOG_ORDER_SIZE[j][1])
            skip = size // 64
            lehmer = lehmer_encode(_custom_order_perm(size - skip))
            for _c in range(3):
                add_permutation_tokens(enc, lehmer, size, skip)
        enc.write(w)
    else:
        # HfPass for pass 0: used_orders = 0 (all natural)
        w.u(2, 2)  # u32 selector 2 -> value 0, 0 bits
    # coefficient code spec: 495*15*presets contexts (cluster
    # partition per opt.coeff_clusters)
    coeff_enc.write_spec(w)


def _custom_order_perm(n: int = 63) -> list[int]:
    """Deterministic nontrivial shuffle of the n post-LLF positions."""
    return list(range(n))[::-1]


def _effective_order_for(opt: VarDCTOptions, order_idx: int):
    """Coefficient order for one order index, Lehmer-permuted when
    opt.custom_order (the decoder mirror is state.py orders_lehmer)."""
    from .vardct.tables import LOG_ORDER_SIZE

    base = list(natural_order(*LOG_ORDER_SIZE[order_idx]))
    if not opt.custom_order:
        return base
    size = len(base)
    skip = size // 64
    perm = _custom_order_perm(size - skip)
    return base[:skip] + [base[skip + p] for p in perm]


def _effective_order(opt: VarDCTOptions):
    return _effective_order_for(opt, 0)


def _write_lf_group(w: BitWriter, opt: VarDCTOptions, lf_int, h8, w8,
                    dctsels=None, xfromy=None, bfromy=None,
                    hfmul_per_vb=None) -> None:
    """dctsels: per-varblock DctSelect values in raster-corner order
    (defaults to all DCT8x8, one per 8x8 block)."""
    from ..frozen.encode.encoder import _write_modular_stream

    w.u(2, 0)  # extra_precision = 0
    # LfQuant modular image, channels in YXB order
    _write_modular_stream(
        w,
        [lf_int[YXB2XYB[i]].astype(np.int32) for i in range(3)],
        predictor=5,
        use_prefix=opt.use_prefix,
    )
    # HF metadata
    if dctsels is None:
        dctsels = [0] * (h8 * w8)
    nb_varblocks = len(dctsels)
    w.u(ceil_lg(h8 * w8), nb_varblocks - 1)
    w64, h64 = ceil_div(w8 * 8, 64), ceil_div(h8 * 8, 64)
    blockinfo = np.zeros((2, nb_varblocks), dtype=np.int32)
    blockinfo[0, :] = np.asarray(dctsels, dtype=np.int32)
    if hfmul_per_vb is None:
        blockinfo[1, :] = opt.hf_mul - 1
    else:
        blockinfo[1, :] = np.asarray(hfmul_per_vb, np.int32) - 1
    _write_modular_stream(
        w,
        [
            (np.zeros((h64, w64), np.int32) if xfromy is None
             else np.asarray(xfromy, np.int32)),  # XFromY
            (np.zeros((h64, w64), np.int32) if bfromy is None
             else np.asarray(bfromy, np.int32)),  # BFromY
            blockinfo,
            np.full((h8, w8), opt.sharpness, dtype=np.int32),  # Sharpness
        ],
        predictor=0,
        use_prefix=opt.use_prefix,
    )


def _collect_pass_group_tokens(opt: VarDCTOptions, hf_int, h8, w8,
                               gcols: int = 1, grows: int = 1) -> EntropyEncoder:
    """HF coefficient tokens mirroring the decoder's context chain
    (j40.h:6888-7005); one independent stream per 256px group.  With multiple
    HF presets, group g uses preset g % num_hf_presets (context offset
    495*nb_block_ctx*preset, j40.h:7020)."""
    nb_block_ctx = 15
    enc = EntropyEncoder(495 * nb_block_ctx * opt.num_hf_presets,
                         use_prefix=opt.use_prefix,
                         cluster_map=_coeff_cluster_map(opt, nb_block_ctx))
    for grow in range(grows):
        for gcol in range(gcols):
            g = grow * gcols + gcol
            ctxoff = 495 * nb_block_ctx * (g % opt.num_hf_presets)
            _collect_group(opt, enc, g, hf_int, h8, w8,
                           gcol * 32, grow * 32, ctxoff)
    return enc


def _coeff_cluster_map(opt: VarDCTOptions, nb_block_ctx: int):
    """Context->cluster map for the coefficient code spec.  With
    ``coeff_clusters > 1`` the 495*nb_block_ctx contexts partition the way
    cjxl's clustering tends to: nz contexts split by the prediction
    bucket, coefficient contexts by the remaining-nz/frequency index —
    so symbols genuinely code against different ANS distributions and the
    decoder must evaluate the full context chain (j40.h:6929-6992) to
    follow the stream."""
    k = opt.coeff_clusters
    if k <= 1:
        return None
    per = 495 * nb_block_ctx
    cmap = []
    for ctx in range(per * opt.num_hf_presets):
        base = ctx % per
        if base < 37 * nb_block_ctx:           # nz contexts
            bucket = base // nb_block_ctx       # 0..36
            cl = 0 if bucket < 6 else 1
        else:                                   # coefficient contexts
            j = (base - 37 * nb_block_ctx) % 458
            cl = 2 + min(k - 3, j * (k - 2) // 474)
        cmap.append(min(cl, k - 1))
    # clusters must be contiguously numbered from 0
    used = sorted(set(cmap))
    remap = {c: i for i, c in enumerate(used)}
    return [remap[c] for c in cmap]


def _collect_group(opt, enc, stream, hf_int, h8, w8, gx8, gy8, ctxoff=0):
    """Vectorized HF token emission for one 256x256 group (decoder dual of
    j40.h:6888-7005): nonzero counts + ordered coefficients, all contexts and
    the emission mask computed with numpy, interleaved block-major then YXB."""
    order = _effective_order(opt)
    nb_block_ctx = 15
    gw8 = min(w8 - gx8, 32)
    gh8 = min(h8 - gy8, 32)
    nb = gh8 * gw8

    oidx = np.asarray(order[1:64], dtype=np.int64)
    # (nb, 3, 63) ordered coefficients in YXB channel order
    Q = hf_int[:, gy8 : gy8 + gh8, gx8 : gx8 + gw8, :]  # (3, gh8, gw8, 64) XYB
    V = Q.reshape(3, nb, 64)[:, :, oidx][list(YXB2XYB)].transpose(1, 0, 2)
    V = np.ascontiguousarray(V.astype(np.int64))

    nzmask = V != 0
    nz_true = nzmask.sum(axis=2)  # (nb, 3)

    # nonzero-count prediction from left/top group neighbors (j40.h:6959)
    nzg = nz_true.reshape(gh8, gw8, 3)
    left = np.roll(nzg, 1, axis=1)
    top = np.roll(nzg, 1, axis=0)
    pred = np.full_like(nzg, 32)
    if gw8 > 1:
        pred[0, 1:] = left[0, 1:]
    if gh8 > 1:
        pred[1:, 0] = top[1:, 0]
    if gw8 > 1 and gh8 > 1:
        pred[1:, 1:] = (left[1:, 1:] + top[1:, 1:] + 1) >> 1
    pred = pred.reshape(nb, 3)

    bctx = np.asarray([DEFAULT_BLKCTX[13 * cy] for cy in range(3)], np.int64)  # YXB
    predctx = np.where(pred < 8, pred, 4 + pred // 2)
    nzctx = ctxoff + bctx[None, :] + predctx * nb_block_ctx  # (nb, 3)

    # coefficient contexts: remaining-nz before i, freq bucket, prev-nonzero
    cum_excl = np.cumsum(nzmask, axis=2) - nzmask  # nonzeros strictly before i
    nzrem = nz_true[:, :, None] - cum_excl  # (nb, 3, 63)
    valid = nzrem > 0  # exactly the decoder's `while nz > 0` span
    prev = np.empty((nb, 3, 63), np.int64)
    prev[:, :, 0] = (nz_true <= 4).astype(np.int64)  # 1 << (log_size - 4) = 4
    prev[:, :, 1:] = nzmask[:, :, :-1]
    tw_nnz = np.asarray(TWICE_COEFF_NNZ_CTX, np.int64)
    tw_freq = np.asarray(TWICE_COEFF_FREQ_CTX, np.int64)
    cctx = ctxoff + 458 * bctx + 37 * nb_block_ctx  # (3,) per YXB channel
    ctxs = (
        cctx[None, :, None]
        + tw_nnz[np.clip(nzrem, 0, 63)]
        + tw_freq[np.arange(1, 64)][None, None, :]
        + prev
    )
    vals = np.where(V >= 0, V * 2, -V * 2 - 1)  # pack_signed

    # interleave: per block, per YXB channel: [nz token][coeff tokens...]
    all_ctx = np.concatenate([nzctx[:, :, None], ctxs], axis=2)
    all_val = np.concatenate([nz_true[:, :, None], vals], axis=2)
    all_ok = np.concatenate([np.ones((nb, 3, 1), bool), valid], axis=2)
    enc.add_arrays(all_ctx[all_ok], all_val[all_ok], stream)


@functools.lru_cache(maxsize=None)
def _default_dq64(param_idx: int) -> np.ndarray:
    """Library dequant table for one param set, float64 (per-varblock reuse)."""
    return load_dq_matrix(param_idx, DqMatrix()).astype(np.float64)


@functools.lru_cache(maxsize=None)
def _custom_dq_tables(use_prefix: bool) -> tuple:
    """The weight tables a custom_dq stream actually signals, recovered by
    round-tripping _write_dq_matrices through the decoder's own parser —
    quantizing with the signaled weights keeps the encoded content
    physical (mismatched quantize/dequant weights blow coefficients into
    the sRGB saturation region, where cross-decoder clipping differs)."""
    from ..frozen.limits import MAIN_LV5
    from ..frozen.io.bits import BitReader
    from .vardct.dequant import read_dq_matrix
    from .vardct.tables import DCT_PARAMS
    from ..frozen.encode.bitwriter import BitWriter

    w = BitWriter()
    _write_dq_matrices(w, VarDCTOptions(custom_dq=True, use_prefix=use_prefix))
    r = BitReader(w.finish())
    tabs = []
    for i in range(17):
        rows, columns = 1 << DCT_PARAMS[i][0], 1 << DCT_PARAMS[i][1]
        dq = read_dq_matrix(r, rows, columns, 0, None, None, MAIN_LV5)
        tabs.append(load_dq_matrix(i, dq).astype(np.float64))
    return tuple(tabs)


def _signaled_dq64(opt: "VarDCTOptions", param_idx: int) -> np.ndarray:
    """Dequant table for one param set as the stream built with `opt` will
    signal it (library defaults, or the custom_dq matrices)."""
    if not opt.custom_dq:
        return _default_dq64(param_idx)
    return _custom_dq_tables(opt.use_prefix)[param_idx]


@functools.lru_cache(maxsize=None)
def _fwd_matrix64(n: int) -> np.ndarray:
    return forward_matrix(n).astype(np.float64)


@dataclass
class MixedChoice:
    """What the mixed encoder chose for an image (frozen copy: an addition,
    so that a reference can start from the same choices): the frame's
    size, the DctSelect at each varblock's corner (`grid`, (h8, w8)), the
    quantized LF (`lf_int`, (3, h8, w8), XYB), the varblocks in the
    decoder's discovery order (`placements`, (y8, x8, dctsel)) and each
    one's quantized coefficients (`tokens`, [X, Y, B] flat arrays in the
    canonical layout, LLF positions zero), with the options they were
    quantized under."""
    width: int
    height: int
    grid: np.ndarray
    lf_int: np.ndarray
    placements: list
    tokens: list
    options: VarDCTOptions


def choose_mixed(image: np.ndarray, options: VarDCTOptions | None = None,
                 t16: float = 1e-3, t32: float = 5e-4) -> MixedChoice:
    """The choices of `encode_vardct_mixed` (frozen copy: the first half of
    that function, its forward DCTs as matmuls, those of a varblock class
    at once: an einsum of three operands took most of a frame's time; the
    sums in another order may move a coefficient across a rounding
    boundary, so the streams are not the port encoder's byte for byte)."""
    from .vardct.tables import DCT_SELECT

    opt = options or VarDCTOptions()
    h, wd, nc = image.shape
    assert nc == 3, "mixed encoder: RGB only"
    h8, w8 = ceil_div(h, 8), ceil_div(wd, 8)
    pad = np.pad(image, ((0, h8 * 8 - h), (0, w8 * 8 - wd), (0, 0)), mode="edge")
    xyb = srgb_to_xyb(pad).astype(np.float64)

    # per-8x8-cell DC (for LF) and Y-channel HF energy (for the block chooser)
    F8 = forward_matrix(8).astype(np.float64)
    blocks8 = xyb.reshape(3, h8, 8, w8, 8).transpose(0, 1, 3, 2, 4)
    C8 = np.matmul(np.matmul(F8, blocks8), F8.T) / 64.0
    Wc8 = C8.transpose(0, 1, 2, 4, 3).reshape(3, h8, w8, 64)
    energy = (Wc8[1] ** 2).sum(-1) - Wc8[1][..., 0] ** 2  # (h8, w8)

    # LF quantization with B-channel CfL (kb_lf = 1), as in encode_vardct
    m_lf_scaled = opt.m_lf_scaled or (1.0 / 4096.0, 1.0 / 512.0, 1.0 / 256.0)
    mult_lf = [
        m_lf_scaled[c] / (opt.global_scale * opt.quant_lf) * 65536 for c in range(3)
    ]
    dc = Wc8[:, :, :, 0]
    lf_int = np.zeros((3, h8, w8), dtype=np.int64)
    lf_int[1] = np.round(dc[1] / mult_lf[1])
    lf_int[0] = np.round(dc[0] / mult_lf[0])
    lf_int[2] = np.round((dc[2] - lf_int[1] * mult_lf[1]) / mult_lf[2])

    # block chooser: greedy merge of aligned low-energy regions (within
    # image, LF-group and 256px-group bounds — j40.h:6645-6650)
    grid = np.zeros((h8, w8), np.int64)
    covered = np.zeros((h8, w8), bool)

    def fits(y, x, vh8, vw8):
        return (
            y + vh8 <= h8 and x + vw8 <= w8
            and not covered[y : y + vh8, x : x + vw8].any()
            and (x % 256) + vw8 <= 256 and (y % 256) + vh8 <= 256
            and ((x % 256) >> 5) == (((x % 256) + vw8 - 1) >> 5)
            and ((y % 256) >> 5) == (((y % 256) + vh8 - 1) >> 5)
        )

    for (sel, vh8, vw8, thr) in ((5, 4, 4, t32), (4, 2, 2, t16),
                                 (6, 2, 1, t16), (7, 1, 2, t16)):
        for y in range(0, h8 - vh8 + 1, vh8):
            for x in range(0, w8 - vw8 + 1, vw8):
                if fits(y, x, vh8, vw8) and \
                        energy[y : y + vh8, x : x + vw8].max() < thr:
                    covered[y : y + vh8, x : x + vw8] = True
                    grid[y, x] = sel
    covered[:] = False

    mult1 = 65536.0 / opt.global_scale / opt.hf_mul
    mults = (mult1 * QM_SCALE[3], mult1, mult1 * QM_SCALE[2])
    qbias = np.array(QUANT_BIAS)

    def _quantize(flat, wgt):
        """CfL-aware quantization of (3, ..., size) canonical coefficients
        (kx_hf = 0, kb_hf = 1, decoder-exact Y dequant for B)."""
        q = np.zeros(flat.shape, dtype=np.int64)
        q[1] = np.round(flat[1] * wgt[..., 1] / mults[1])
        qf = q[1].astype(np.float64)
        small = np.abs(qf) <= 1.0
        y_deq = np.where(small, qf * qbias[1],
                         qf - QUANT_BIAS_NUM / np.where(qf == 0, 1, qf))
        y_deq = y_deq * (mults[1] / wgt[..., 1])
        q[0] = np.round(flat[0] * wgt[..., 0] / mults[0])
        q[2] = np.round((flat[2] - y_deq) * wgt[..., 2] / mults[2])
        return q

    # vectorized tokens for every 8x8 cell (the dominant class)
    wgt8 = _signaled_dq64(opt, 0)
    hf8 = _quantize(Wc8, wgt8[None, None])  # (3, h8, w8, 64)
    hf8[:, :, :, 0] = 0

    # varblocks in decoder discovery order (per LF group, raster)
    placements = []
    gg_cols, gg_rows = ceil_div(w8, 256), ceil_div(h8, 256)
    for ggr in range(gg_rows):
        for ggc in range(gg_cols):
            for y in range(ggr * 256, min(ggr * 256 + 256, h8)):
                for x in range(ggc * 256, min(ggc * 256 + 256, w8)):
                    if covered[y, x]:
                        continue
                    sel = int(grid[y, x])
                    log_vh, log_vw, _, _ = DCT_SELECT[sel]
                    covered[y : y + (1 << (log_vh - 3)),
                            x : x + (1 << (log_vw - 3))] = True
                    placements.append((y, x, sel))

    tokens: list = [None] * len(placements)
    sels = np.array([p[2] for p in placements], np.int64)
    for sel in np.unique(sels):
        idx = np.flatnonzero(sels == sel)
        y8s = np.array([placements[i][0] for i in idx], np.int64)
        x8s = np.array([placements[i][1] for i in idx], np.int64)
        if sel == 0:
            for i, y8, x8 in zip(idx, y8s, x8s):
                q = hf8[:, y8, x8, :]
                tokens[i] = [q[0], q[1], q[2]]
            continue
        log_vh, log_vw, param_idx, _ = DCT_SELECT[int(sel)]
        N, M = 1 << log_vh, 1 << log_vw
        rows = (y8s[:, None] * 8 + np.arange(N)[None, :])[:, :, None]
        cols = (x8s[:, None] * 8 + np.arange(M)[None, :])[:, None, :]
        blk = xyb[:, rows, cols]  # (3, m, N, M)
        C = np.matmul(np.matmul(_fwd_matrix64(N), blk), _fwd_matrix64(M).T) / (N * M)
        # canonical storage is (2^min, 2^max); C is W when M > N,
        # else W^T (includes square blocks) — vardct/dct.py:108-117
        flat = (C if M > N else C.transpose(0, 1, 3, 2)).reshape(3, len(idx), N * M)
        q = _quantize(flat, _signaled_dq64(opt, param_idx)[: N * M])
        # LLF positions are not HF-coded (decoder fills them from LF)
        vbh8, vbw8 = 1 << (min(log_vh, log_vw) - 3), 1 << (max(log_vh, log_vw) - 3)
        for yy in range(vbh8):
            q[:, :, yy * vbw8 * 8 : yy * vbw8 * 8 + vbw8] = 0
        for k, i in enumerate(idx):
            tokens[i] = [q[0, k], q[1, k], q[2, k]]
    return MixedChoice(wd, h, grid, lf_int, placements, tokens, opt)


def encode_vardct_mixed(image: np.ndarray,
                        options: VarDCTOptions | None = None,
                        t16: float = 1e-3, t32: float = 5e-4,
                        stats_out: dict | None = None) -> bytes:
    """Encode (h, w, 3) RGB with a MIXED varblock layout: flat regions (by
    per-8px-block HF energy of the Y channel) merge into DCT16X16 /
    DCT32X32 / DCT16X8 / DCT8X16 varblocks, detailed regions stay DCT8x8.

    This is the BASELINE config-4 stream shape ("variable blocks") — the
    decode path it exercises is the reference's j40.h:7178-7191 transform
    dispatch over mixed DctSelect classes.  The quantized coefficients come
    from true forward DCTs of each varblock (LLF region left to the
    decoder's LF forward-DCT, j40.h:6669-6683), so content is realistic;
    correctness is gated decoder-vs-decoder (dj40 differential), as
    everywhere else.  (frozen copy: `choose_mixed`, then the stream.)"""
    return encode_choice(choose_mixed(image, options, t16, t32), stats_out)


def encode_choice(ch: MixedChoice, stats_out: dict | None = None) -> bytes:
    """The stream of a `MixedChoice` (frozen copy: an addition)."""
    if stats_out is not None:
        sel_counts: dict[int, int] = {}
        for _, _, sel in ch.placements:
            sel_counts[sel] = sel_counts.get(sel, 0) + 1
        stats_out["nb_varblocks"] = len(ch.placements)
        stats_out["dctsel_counts"] = sel_counts
    return synthesize_vardct(ch.width, ch.height, ch.grid, ch.lf_int, ch.tokens,
                             options=ch.options)


# -- raw-coefficient synthesis (differential test vectors) -------------------


def synthesize_vardct(
    width: int,
    height: int,
    dctsel_grid: np.ndarray,
    lf_int: np.ndarray,
    hf_tokens_per_vb: list[np.ndarray],
    options: VarDCTOptions | None = None,
    xfromy: np.ndarray | None = None,
    bfromy: np.ndarray | None = None,
    hfmul_per_vb: np.ndarray | None = None,
) -> bytes:
    """Build a VarDCT bitstream with explicitly given quantized data.

    dctsel_grid: (h8, w8) int array; the value at each varblock's top-left
    corner chooses its DctSelect (other covered cells ignored).  Varblocks are
    discovered in raster order exactly like the decoder (j40.h:6636-6687).
    lf_int: (3, h8, w8) quantized LF in XYB order.
    hf_tokens_per_vb: per-varblock flat arrays of quantized coefficients in
    canonical layout (LLF region values ignored).

    The resulting file is valid regardless of the coefficient values, which
    makes this ideal for decoder-vs-decoder differential testing across all 27
    DctSelect types.
    """
    from .vardct.tables import DCT_SELECT

    opt = options or VarDCTOptions()
    h8, w8 = ceil_div(height, 8), ceil_div(width, 8)
    assert dctsel_grid.shape == (h8, w8)
    gg_cols, gg_rows = ceil_div(w8, 256), ceil_div(h8, 256)
    gcols, grows = ceil_div(w8, 32), ceil_div(h8, 32)
    num_groups = gcols * grows

    # discover varblocks exactly like the decoder (j40.h:6636-6687): per LF
    # group in raster order, raster scan of the LF group's block grid; a
    # varblock must not cross a 256px group boundary
    covered = np.zeros((h8, w8), dtype=bool)
    placements = []         # (y8, x8, dctsel) global coords, discovery order
    gg_vbs: list[list[int]] = [[] for _ in range(gg_rows * gg_cols)]
    for ggr in range(gg_rows):
        for ggc in range(gg_cols):
            gy0, gx0 = ggr * 256, ggc * 256
            lh8, lw8 = min(h8 - gy0, 256), min(w8 - gx0, 256)
            for y in range(lh8):
                for x in range(lw8):
                    yy, xx = gy0 + y, gx0 + x
                    if covered[yy, xx]:
                        continue
                    dctsel = int(dctsel_grid[yy, xx])
                    log_vh, log_vw, _, _ = DCT_SELECT[dctsel]
                    vh8, vw8 = 1 << (log_vh - 3), 1 << (log_vw - 3)
                    assert y + vh8 <= lh8 and x + vw8 <= lw8, \
                        "varblock crosses the LF group / image bound"
                    assert (x >> 5) == ((x + vw8 - 1) >> 5) and \
                        (y >> 5) == ((y + vh8 - 1) >> 5), \
                        "varblock crosses a 256px group boundary"
                    covered[yy : yy + vh8, xx : xx + vw8] = True
                    gg_vbs[ggr * gg_cols + ggc].append(len(placements))
                    placements.append((yy, xx, dctsel))
    assert len(placements) == len(hf_tokens_per_vb)
    hfmul_all = (
        [opt.hf_mul] * len(placements) if hfmul_per_vb is None
        else [int(v) for v in hfmul_per_vb]
    )

    w = BitWriter()
    write_signature(w)
    write_image_metadata(w, width, height, bpp=8, xyb_encoded=True)
    w.zero_pad_to_byte()
    _write_vardct_frame_header(w, opt)

    # HF tokens: one stream per (pass=0, group); group-local placements
    setup = _blockctx_setup(opt, lf_int, h8, w8)
    nb_block_ctx = setup[1]
    coeff_enc = EntropyEncoder(495 * nb_block_ctx * opt.num_hf_presets,
                               use_prefix=opt.use_prefix)
    by_group: list[list[int]] = [[] for _ in range(num_groups)]
    for i, (y8, x8, _sel) in enumerate(placements):
        by_group[(y8 >> 5) * gcols + (x8 >> 5)].append(i)
    for g in range(num_groups):
        grow, gcol = divmod(g, gcols)
        gy0, gx0 = grow * 32, gcol * 32
        gh8_l, gw8_l = min(h8 - gy0, 32), min(w8 - gx0, 32)
        local = by_group[g]
        ctxoff = 495 * nb_block_ctx * (g % opt.num_hf_presets)
        if (opt.block_ctx is None and len(local) == gh8_l * gw8_l
                and all(placements[i][2] == 0 for i in local)):
            # vectorized path for all-DCT8x8 groups (the dominant case)
            hf_local = np.zeros((3, gh8_l, gw8_l, 64), np.int64)
            for i in local:
                y8l, x8l = placements[i][0] - gy0, placements[i][1] - gx0
                for c in range(3):
                    hf_local[c, y8l, x8l] = hf_tokens_per_vb[i][c]
            _collect_group(opt, coeff_enc, g, hf_local, gh8_l, gw8_l,
                           0, 0, ctxoff)
            continue
        if opt.block_ctx is None and not opt.custom_order and hfmul_per_vb is None:
            # frozen copy: the same tokens as _collect_group_tokens_generic,
            # made with numpy a varblock class at a time
            _collect_group_tokens_vec(
                coeff_enc, g,
                [(placements[i][0] - gy0, placements[i][1] - gx0, placements[i][2])
                 for i in local],
                [hf_tokens_per_vb[i] for i in local], gw8_l, gh8_l, ctxoff)
            continue
        lsetup = (setup[0], setup[1], setup[2], setup[3],
                  setup[4][gy0 : gy0 + gh8_l, gx0 : gx0 + gw8_l], setup[5])
        _collect_group_tokens_generic(
            opt, coeff_enc, g,
            [(placements[i][0] - gy0, placements[i][1] - gx0, placements[i][2])
             for i in local],
            [hf_tokens_per_vb[i] for i in local],
            gw8_l, gh8_l, lsetup, [hfmul_all[i] for i in local], ctxoff,
        )

    def lf_group_section(ggidx: int) -> bytes:
        ggr, ggc = divmod(ggidx, gg_cols)
        gy0, gx0 = ggr * 256, ggc * 256
        lh8, lw8 = min(h8 - gy0, 256), min(w8 - gx0, 256)
        # per-LF-group planes (decoder reads width64 = ceil(local px / 64))
        h64 = ceil_div(min(height - gy0 * 8, 2048), 64)
        w64 = ceil_div(min(width - gx0 * 8, 2048), 64)
        sw = BitWriter()
        _write_lf_group(
            sw, opt, lf_int[:, gy0 : gy0 + lh8, gx0 : gx0 + lw8], lh8, lw8,
            dctsels=[placements[i][2] for i in gg_vbs[ggidx]],
            xfromy=None if xfromy is None
            else xfromy[ggr * 32 : ggr * 32 + h64, ggc * 32 : ggc * 32 + w64],
            bfromy=None if bfromy is None
            else bfromy[ggr * 32 : ggr * 32 + h64, ggc * 32 : ggc * 32 + w64],
            hfmul_per_vb=[hfmul_all[i] for i in gg_vbs[ggidx]],
        )
        return sw.finish()

    used_order_idxs = tuple(sorted(
        {DCT_SELECT[sel][3] for _, _, sel in placements} or {0}))

    if num_groups == 1:
        sw = BitWriter()
        _write_lf_global(sw, opt)
        _write_hf_global(sw, opt, num_groups=1, coeff_encs=[coeff_enc],
                         used_order_indices=used_order_idxs)
        _write_lf_group(sw, opt, lf_int, h8, w8,
                        dctsels=[p[2] for p in placements],
                        xfromy=xfromy, bfromy=bfromy,
                        hfmul_per_vb=hfmul_all)
        coeff_enc.write_tokens(sw)
        section = sw.finish()
        w.u(1, 0)
        w.zero_pad_to_byte()
        w.u32(TOC_U32, len(section))
        w.zero_pad_to_byte()
        w.out.extend(section)
        return w.finish()

    # multi-group: LfGlobal | per-LF-group | HfGlobal | per-group sections
    sections: list[bytes] = []
    sw = BitWriter()
    _write_lf_global(sw, opt, multi_group=True)
    sections.append(sw.finish())
    for ggidx in range(gg_rows * gg_cols):
        sections.append(lf_group_section(ggidx))
    sw = BitWriter()
    _write_hf_global(sw, opt, num_groups=num_groups, coeff_encs=[coeff_enc],
                     used_order_indices=used_order_idxs)
    sections.append(sw.finish())
    for g in range(num_groups):
        sw = BitWriter()
        sw.u(ceil_lg(opt.num_hf_presets), g % opt.num_hf_presets)
        coeff_enc.write_tokens(sw, g)
        sections.append(sw.finish())

    w.u(1, 0)  # TOC not permuted
    w.zero_pad_to_byte()
    for sct in sections:
        w.u32(TOC_U32, len(sct))
    w.zero_pad_to_byte()
    for sct in sections:
        w.out.extend(sct)
    return w.finish()


def _write_vardct_frame_header(w: BitWriter, opt: VarDCTOptions | None = None) -> None:
    w.u(1, 0)  # not all_default
    w.u(2, 0)  # regular
    w.u(1, 0)  # is_modular = false
    w.u64(128)  # flags: skip_adapt_lf_smooth
    w.u(2, 0)  # log_upsampling
    w.u(3, 3)  # x_qm_scale
    w.u(3, 2)  # b_qm_scale
    w.u32(((1, 0), (2, 0), (3, 0), (4, 3)), 1)  # num_passes
    w.u(1, 0)  # have_crop
    w.u32(((0, 0), (1, 0), (2, 0), (3, 2)), 0)  # blend replace
    w.u(1, 1)  # is_last
    w.u32(((0, 0), (0, 4), (16, 5), (48, 10)), 0)  # name_len
    if opt is not None and opt.cjxl_restoration:  # frozen copy: cjxl's filter
        w.u(1, 0)  # restoration not all_default
        w.u(1, 1)  # gab enabled
        w.u(1, 0)  # gab_custom: the default weights
        w.u(2, 0)  # epf_iters
        w.u64(0)  # restoration extensions
    else:
        w.u(1, 1)  # restoration all_default
        w.u(1, 0)  # (quirk) gab_custom
        w.u(1, 0)  # (quirk) epf_sharp_custom
        w.u(1, 0)  # epf_weight_custom
        w.u(1, 0)  # epf_sigma_custom
    w.u64(0)  # frame extensions


def _blockctx_setup(opt, lf_int, h8, w8):
    """Resolve the HF block-context configuration (decoder dual of
    j40.h:6276-6305): returns (ctx_map, nb_block_ctx, nb_qf_thr, lfidx_size,
    lfidx_plane (h8, w8), qf_thr)."""
    from .vardct.tables import DEFAULT_BLKCTX as _DEF

    bc = opt.block_ctx
    if bc is None:
        return _DEF, 15, 0, 1, np.zeros((h8, w8), np.int64), []
    ctx_map = bc["map"]
    nb_block_ctx = max(ctx_map) + 1
    qf_thr = bc["qf_thr"]
    nb_qf_thr = len(qf_thr)
    nlf = [len(bc["lf_thr"][i]) for i in range(3)]
    lfidx_size = (nlf[0] + 1) * (nlf[1] + 1) * (nlf[2] + 1)
    # lfidx precompute mirrors j40__lf_quant (X, *(nb0+1), B, *(nb2+1), Y)
    lfp = np.zeros((h8, w8), np.int64)
    for t in bc["lf_thr"][0]:
        lfp += lf_int[0] > t
    lfp *= nlf[0] + 1
    for t in bc["lf_thr"][2]:
        lfp += lf_int[2] > t
    lfp *= nlf[2] + 1
    for t in bc["lf_thr"][1]:
        lfp += lf_int[1] > t
    return ctx_map, nb_block_ctx, nb_qf_thr, lfidx_size, lfp, qf_thr


def _collect_group_tokens_generic(opt, enc, stream, placements, hf_tokens,
                                  gw8, gh8, setup, hfmul_list, ctxoff=0):
    """HF token emission for ONE 256px group with arbitrary varblocks
    (decoder mirror of j40.h:6888-7005).

    placements: (y8, x8, dctsel) in GROUP-local coordinates, group-raster
    order; the nonzero-prediction plane is group-local (the reference
    allocates it per section, j40.h:6905, so prediction never crosses a
    group boundary)."""
    from .vardct.tables import DCT_SELECT, LOG_ORDER_SIZE

    ctx_map, nb_block_ctx, nb_qf_thr, lfidx_size, lfidx_plane, qf_thr = setup
    eff_orders: dict[int, list[int]] = {}  # order_idx -> effective order
    nonzeros = np.zeros((gh8 * gw8, 3), dtype=np.int32)
    for (y8, x8, dctsel), q_all, hfmul in zip(placements, hf_tokens, hfmul_list):
        log_rows, log_columns, _, order_idx = DCT_SELECT[dctsel]
        log_size = log_rows + log_columns
        order = eff_orders.get(order_idx)
        if order is None:
            # coefficients must be emitted in the same (possibly permuted)
            # order the decoder will read them in; _write_hf_pass signals a
            # used_orders bit for every index this stream touches
            order = eff_orders[order_idx] = _effective_order_for(opt, order_idx)
        nzpos = y8 * gw8 + x8
        hfmul_m1 = hfmul - 1
        qfidx = sum(1 for t in qf_thr if hfmul_m1 >= t)
        lfidx = int(lfidx_plane[y8, x8])
        bctx0 = (order_idx * (nb_qf_thr + 1) + qfidx) * lfidx_size + lfidx
        bctxc = 13 * (nb_qf_thr + 1) * lfidx_size
        for c_yxb in range(3):
            c = YXB2XYB[c_yxb]
            q = np.asarray(q_all[c], dtype=np.int64)
            assert q.shape[0] == 1 << log_size
            bctx = ctx_map[bctx0 + bctxc * c_yxb]
            llf = 1 << (log_size - 6)
            nz_true = int(np.count_nonzero(q[[order[i] for i in range(llf, 1 << log_size)]]))
            assert nz_true <= 63 << (log_size - 6)
            if x8 > 0:
                if y8 > 0:
                    pred = (nonzeros[nzpos - 1][c] + nonzeros[nzpos - gw8][c] + 1) >> 1
                else:
                    pred = nonzeros[nzpos - 1][c]
            else:
                pred = nonzeros[nzpos - gw8][c] if y8 > 0 else 32
            nzctx = ctxoff + bctx + (pred if pred < 8 else 4 + pred // 2) * nb_block_ctx
            enc.add(nzctx, nz_true, stream)
            qnz = ceil_div(nz_true, llf)
            for i in range(1 << (log_rows - 3)):
                for j in range(1 << (log_columns - 3)):
                    nonzeros[nzpos + i * gw8 + j][c] = qnz
            cctx = ctxoff + 458 * bctx + 37 * nb_block_ctx
            prev = 1 if nz_true <= (1 << (log_size - 4)) else 0
            nz = nz_true
            i = llf
            while nz > 0 and i < (1 << log_size):
                ctx = (
                    cctx
                    + TWICE_COEFF_NNZ_CTX[ceil_div(nz, llf)]
                    + TWICE_COEFF_FREQ_CTX[i >> (log_size - 6)]
                    + prev
                )
                v = int(q[order[i]])
                enc.add(ctx, pack_signed(v), stream)
                prev = 1 if v != 0 else 0
                nz -= prev
                i += 1


def _collect_group_tokens_vec(enc, stream, placements, hf_tokens, gw8, gh8,
                              ctxoff=0):
    """`_collect_group_tokens_generic` for the default HF block context and
    the natural orders, vectorized (frozen copy: an addition).  The tokens,
    their contexts and their order are the same: the nonzero count of each
    varblock's channel (YXB), predicted from the group's nonzeros plane at
    the cells left of and above its corner (both belong to varblocks found
    before it), then its coefficients in the order up to the last nonzero
    one.  Each varblock class makes its tokens at once; a sort by
    (varblock, channel, position) puts them in the decoder's order."""
    from .vardct.tables import DCT_SELECT, LOG_ORDER_SIZE

    n = len(placements)
    if n == 0:
        return
    nb_block_ctx = 15
    tw_nnz = np.asarray(TWICE_COEFF_NNZ_CTX, np.int64)
    tw_freq = np.asarray(TWICE_COEFF_FREQ_CTX, np.int64)
    sels = np.array([p[2] for p in placements], np.int64)
    ys = np.array([p[0] for p in placements], np.int64)
    xs = np.array([p[1] for p in placements], np.int64)
    classes = {int(sel): np.flatnonzero(sels == sel) for sel in np.unique(sels)}
    nz_true = np.zeros((n, 3), np.int64)
    ordered = {}
    plane = np.zeros((gh8, gw8, 3), np.int64)
    for sel, idx in classes.items():
        log_rows, log_columns, _, order_idx = DCT_SELECT[sel]
        size = 1 << (log_rows + log_columns)
        llf = size >> 6
        order = np.asarray(natural_order(*LOG_ORDER_SIZE[order_idx]), np.int64)
        # (m, 3 YXB, size) in the coefficient order
        q = np.stack([np.stack([np.asarray(hf_tokens[i][c], np.int64)
                                for c in YXB2XYB]) for i in idx])[:, :, order]
        ordered[sel] = q
        nz_true[idx] = np.count_nonzero(q[:, :, llf:], axis=2)
        qnz = -(-nz_true[idx] // llf)
        for dy in range(1 << (log_rows - 3)):
            for dx in range(1 << (log_columns - 3)):
                plane[ys[idx] + dy, xs[idx] + dx] = qnz
    left = plane[ys, np.maximum(xs - 1, 0)]
    top = plane[np.maximum(ys - 1, 0), xs]
    pred = np.where((xs > 0)[:, None],
                    np.where((ys > 0)[:, None], (left + top + 1) >> 1, left),
                    np.where((ys > 0)[:, None], top, 32))
    predctx = np.where(pred < 8, pred, 4 + pred // 2)
    keys, ctxs, vals = [], [], []
    for sel, idx in classes.items():
        log_rows, log_columns, _, order_idx = DCT_SELECT[sel]
        log_size = log_rows + log_columns
        size, llf = 1 << log_size, 1 << (log_size - 6)
        bctx = np.asarray([DEFAULT_BLKCTX[order_idx + 13 * c] for c in range(3)], np.int64)
        q = ordered[sel][:, :, llf:]
        m, span = len(idx), size - llf
        nzctx = ctxoff + bctx[None, :] + predctx[idx] * nb_block_ctx
        nzmask = q != 0
        nzt = nz_true[idx]
        nzrem = nzt[:, :, None] - (np.cumsum(nzmask, axis=2) - nzmask)
        valid = nzrem > 0
        prev = np.empty((m, 3, span), np.int64)
        prev[:, :, 0] = nzt <= (1 << (log_size - 4))
        prev[:, :, 1:] = nzmask[:, :, :-1]
        pos = np.arange(llf, size)
        cctx = ctxoff + 458 * bctx + 37 * nb_block_ctx
        cc = (cctx[None, :, None] + tw_nnz[-(-np.clip(nzrem, 0, None) // llf)]
              + tw_freq[pos >> (log_size - 6)][None, None, :] + prev)
        all_ctx = np.concatenate([nzctx[:, :, None], cc], axis=2)
        all_val = np.concatenate([nzt[:, :, None], np.where(q >= 0, 2 * q, -2 * q - 1)],
                                 axis=2)
        all_ok = np.concatenate([np.ones((m, 3, 1), bool), valid], axis=2)
        key = (idx[:, None, None] * 3 + np.arange(3)[None, :, None]) * 1025 \
            + np.arange(span + 1)[None, None, :]
        keys.append(key[all_ok])
        ctxs.append(all_ctx[all_ok])
        vals.append(all_val[all_ok])
    order = np.argsort(np.concatenate(keys), kind="stable")
    enc.add_arrays(np.concatenate(ctxs)[order], np.concatenate(vals)[order], stream)


def _collect_tokens_generic(opt, placements, hf_tokens, h8, w8,
                            lf_int=None, hfmul_per_vb=None) -> EntropyEncoder:
    """Single-group HF token collection for arbitrary varblock layouts
    (back-compat wrapper over _collect_group_tokens_generic)."""
    setup = _blockctx_setup(opt, lf_int, h8, w8)
    nb_block_ctx = setup[1]
    enc = EntropyEncoder(495 * nb_block_ctx * opt.num_hf_presets,
                         use_prefix=opt.use_prefix)
    hfmul_list = (
        [opt.hf_mul] * len(placements) if hfmul_per_vb is None
        else [int(v) for v in hfmul_per_vb]
    )
    _collect_group_tokens_generic(opt, enc, 0, placements, hf_tokens,
                                  w8, h8, setup, hfmul_list)
    return enc


# -- custom dequant matrix emission (exercises all j40.h:4696-4777 modes) ----


def _write_dq_matrices(w: BitWriter, opt: VarDCTOptions) -> None:
    """Write all 17 dq matrix headers with a mix of encoding modes.

    Values are f16-exact so decode is deterministic across implementations.
    Mode assignment: 8x8 sets use the parametric modes (0 -> DCT bands,
    1 -> Hornuss, 2 -> DCT2, 3 -> DCT4, 9 -> DCT4X8, 10 -> AFV); every
    non-8x8 set uses RAW, because the reference restricts modes 1-6 to 8x8
    matrices (j40.h:4751-4754 requires8x8 covers mode 6 too).
    """
    from .vardct.tables import DCT_PARAMS
    from ..frozen.encode.encoder import _write_modular_stream

    def params_block(per_param, nscaled):
        # the reader iterates channel-outer (j40.h:4757-4759): for each
        # channel, all params, scaled by 64 for j < nscaled
        for c in range(3):
            for j, v in enumerate(per_param):
                w.f16(v[c] / (64.0 if j < nscaled else 1.0))

    def dct_params(n, first):
        # ReadDctParams: n, then channel-outer values, first scaled by 64
        w.u(4, n - 1)
        for c in range(3):
            w.f16(first[c] / 64.0)
            for j in range(1, n):
                w.f16(-0.5)

    for idx in range(17):
        log_r, log_c = DCT_PARAMS[idx][0], DCT_PARAMS[idx][1]
        rows, cols = 1 << log_r, 1 << log_c
        if log_r != 3 or log_c != 3:  # RAW: the only custom mode for non-8x8
            w.u(3, 7)
            w.f16(0.125)  # denom -> weights = int / 0.125 = int * 8
            # track the library weights per position/channel (realistic
            # custom matrices stay near library magnitudes; order-of-
            # magnitude-finer weights would inflate coefficient density
            # far beyond any cjxl output) while still exercising the RAW
            # modular decode path with per-position variation
            dflt = _default_dq64(idx)  # (rows*cols, 3) library weights
            chans = [
                np.maximum(1, np.round(dflt[:, c] * 0.125))
                .astype(np.int32).reshape(rows, cols)
                for c in range(3)
            ]
            _write_modular_stream(
                w, chans, predictor=0, use_prefix=opt.use_prefix,
            )
        elif idx == 1:  # Hornuss: 3 params, x64
            w.u(3, 1)
            params_block([(256.0, 64.0, 16.0), (3072.0, 768.0, 192.0),
                          (3072.0, 768.0, 192.0)], nscaled=3)
        elif idx == 2:  # DCT2: 6 params, x64
            w.u(3, 2)
            params_block([(v, v / 2.0, v / 4.0) for v in
                          (3840.0, 2560.0, 1280.0, 640.0, 448.0, 320.0)],
                         nscaled=6)
        elif idx == 3:  # DCT4: 2 params (x64) + dct_params
            w.u(3, 3)
            params_block([(2.0,) * 3, (2.0,) * 3], nscaled=2)
            dct_params(4, (2048.0, 512.0, 128.0))
        elif idx == 9:  # DCT4X8: 1 param (unscaled) + dct_params
            w.u(3, 4)
            params_block([(2.0,) * 3], nscaled=0)
            dct_params(4, (2048.0, 512.0, 128.0))
        elif idx == 10:  # AFV: 9 params (first 6 x64) + 2 dct_params
            w.u(3, 5)
            params_block(
                [(v,) * 3 for v in (3072.0, 3072.0, 256.0, 256.0, 256.0, 448.0)]
                + [(-0.25,) * 3] * 3,
                nscaled=6,
            )
            dct_params(4, (2048.0, 512.0, 128.0))
            dct_params(4, (2048.0, 512.0, 128.0))
        else:  # 8x8 DCT with custom bands (set 0)
            w.u(3, 6)
            # first-band values near the library's {3150, 560, 512}
            # (f16-exact): weight magnitude sets quantization fineness,
            # so staying at library scale keeps the coefficient density
            # of a custom_dq stream comparable to a default one
            dct_params(5, (3152.0, 560.0, 512.0))
