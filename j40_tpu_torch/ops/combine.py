"""Device-side LF-group reconstruction: per-DctSelect-class batching.

Counterpart of j40_tpu/ops/combine_jax.py.  Every inverse transform in JPEG
XL is linear, so the 8x8 special transforms (Hornuss, DCT2x2, DCT4x4,
DCT4x8, DCT8x4, AFV0-3) are dense 64x64 matrices and the large DCTs
two-sided basis products, batched per class.  One structure on every
device: an all-DCT8 LF group takes the fused kernel (kernels.
reconstruct_dct8_full); a mixed group runs its dense 8x8 grid through the
dequant+IDCT kernel, overlays each other class (`_mixed_xyb`), then the
colour kernel.  With the restoration filters on, every group builds its
XYB plane that second way (the fused kernel leaves no XYB plane to filter).
port: the decode then filters the whole frame (`filter_frame`): the
groups' planes are put together into the frame's 8-padded plane, gaborish
and EPF (ops/filter_kernels.py) run over it once, mirroring only at the
frame's edges, then the colour kernel; combine_jax filters each group's
plane apart, mirrored at every LF-group border (ROADMAP C.3).  CUDA
tensors reach the kernels, CPU tensors their plain versions.

The host half (`lf_group_inputs`) gathers one LF group's upload arrays in
numpy; `to_device` makes tensors of them (`gather_lf_group`: both, in a
`vardct.gather` span).
"""

from __future__ import annotations

import numpy as np
import torch

from ..mathutil import ceil_div
from ..profile import span
from ..streams import device_cache, shared
from ..vardct import special
from ..vardct.tables import DCT_SELECT, QM_SCALE
from . import filter_kernels, kernels
from .filters import epf_params, epf_rs8
from .reconstruct import cfl_batch, dequant_hf_batch, idct2d_batch

# small on-device caches for constant tables, keyed by content: these arrays
# repeat across decodes (library dequant weights, opsin constants); decodes
# on several streams read them (streams.shared)
_DEVICE_CACHE: dict = {}


def _cached_device(key, np_arr: np.ndarray, device: torch.device) -> torch.Tensor:
    k = (key, str(device))
    ent = _DEVICE_CACHE.get(k)
    if ent is None or ent[0] != np_arr.tobytes():
        ent = (np_arr.tobytes(), torch.from_numpy(np.ascontiguousarray(np_arr)).to(device))
        _DEVICE_CACHE[k] = ent
    return shared(ent[1])


# dctsel values handled by dense 64x64 matrices; vardct/special.py (pure
# numpy) makes the operators, shared with the native host plan
_SPECIAL_FNS = frozenset(special._SPECIAL_FNS)


@device_cache(maxsize=None)
def _special_on(dctsel: int, device: torch.device) -> torch.Tensor:
    m = np.asarray(special.special_matrix(dctsel), np.float32)
    return torch.from_numpy(np.ascontiguousarray(m)).to(device)


def _class_pipeline(
    coeffs,      # (3, N, size)
    llf,         # (3, N, llfsize)
    llf_idx,     # (llfsize,) int64 canonical positions of LLF coeffs
    hfmul_inv,   # (N,)
    kx, kb,      # (N,)
    weights,     # (size, 3)
    global_scale_inv, qm_scales, quant_bias, quant_bias_num,
    dctsel: int,
):
    """Dequant + CfL + LLF substitution + inverse transform for one class.

    Returns (3, N, rows, cols) float32 samples."""
    log_rows, log_columns, _, _ = DCT_SELECT[dctsel]
    deq = dequant_hf_batch(coeffs, weights, hfmul_inv, global_scale_inv,
                           qm_scales, quant_bias, quant_bias_num)
    cf = cfl_batch(deq, kx, kb)
    cf[:, :, llf_idx] = llf
    n = cf.shape[1]
    flat = cf.reshape(3 * n, -1)
    if dctsel in _SPECIAL_FNS:
        out = torch.matmul(flat, _special_on(dctsel, flat.device).T)
        return out.reshape(3, n, 8, 8)
    out = idct2d_batch(flat, log_rows, log_columns)
    return out.reshape(3, n, 1 << log_rows, 1 << log_columns)


def _exceptions(exc, vals, fill: int):
    """The exception list of a packed upload: capacity bucketed to powers of
    two (at least 64), slot 0 and the padding slots pointing at flat index 0
    with its exact value `fill`, so duplicate writes carry the same value;
    entries 1.. hold the flat positions `exc` and their exact `vals`."""
    cap = max(64, 1 << int(len(exc)).bit_length())
    exc_idx = np.zeros(cap, np.int32)
    exc_val = np.full(cap, np.int32(fill), np.int32)
    if len(exc):
        exc_idx[1 : 1 + len(exc)] = exc
        exc_val[1 : 1 + len(exc)] = vals
    return exc_idx, exc_val


def _pack_i8(arr: np.ndarray):
    """Narrowest lossless upload: clipped int8 plane + exact-value exception
    list (quantized HF coeffs rarely exceed |127|).  Exception capacity is
    bucketed to powers of two.  Padding entries point at flat index 0 with
    its exact value, so duplicate writes carry the same value."""
    flat = arr.reshape(-1)
    cup = np.clip(arr, -127, 127).astype(np.int8)
    exc = np.flatnonzero(np.abs(flat) > 127).astype(np.int64)
    fill = round(float(flat[0])) if flat.size else 0
    return (cup, *_exceptions(exc, np.round(flat[exc]).astype(np.int32), fill))


def _pack_i4(arr: np.ndarray):
    """Nibble-packed upload: values in [-8, 7] as 4-bit biased codes, two
    per byte along the last axis, plus an exact exception list.  Halves the
    host->device bytes of the int8 pack on sparse/low-amplitude coefficient
    planes (photo-like VarDCT content has |q| <= 7 for most coefficients);
    noisy planes keep int8 through the byte accounting in
    `pack_coeffs_auto`."""
    assert arr.shape[-1] % 2 == 0
    q = np.round(arr).astype(np.int32)
    flat = q.reshape(-1)
    u = (np.clip(q, -8, 7) + 8).astype(np.uint8)
    packed = (u[..., 0::2] | (u[..., 1::2] << 4)).astype(np.uint8)
    exc = np.flatnonzero((flat < -8) | (flat > 7)).astype(np.int64)
    return (packed, *_exceptions(exc, flat[exc], flat[0] if flat.size else 0))


def pack_coeffs_auto(arr: np.ndarray):
    """Pick the narrowest lossless upload encoding for a coefficient plane:
    4-bit biased nibbles vs clipped int8, each with an exact-value exception
    list.  Returns (kind, packed, exc_idx, exc_val) with kind in
    {"i4", "i8"}; the byte accounting includes the 8-byte-per-entry
    exception cost so noisy planes keep the int8 form."""
    # coefficient planes are integral-valued f32, so the magnitude tests run
    # on the float array without a rounding pass
    a = np.abs(arr.reshape(-1))
    n = a.size
    bytes4 = n // 2 + 8 * int(np.count_nonzero(a > 7))
    bytes8 = n + 8 * int(np.count_nonzero(a > 127))
    if bytes4 < bytes8:
        return ("i4", *_pack_i4(arr))
    return ("i8", *_pack_i8(arr))


def _opsin_tail14(im) -> np.ndarray:
    """consts[8:22]: opsin_inv (9) | opsin_bias (3) | itscale | maxval —
    the XYB->sRGB section consumed by index in the kernels."""
    return np.concatenate(
        [
            np.asarray(im.opsin_inv_mat, np.float32).ravel(),
            np.asarray(im.opsin_bias, np.float32),
            np.asarray(
                [255.0 / im.intensity_target, (1 << im.bpp) - 1], np.float32
            ),
        ]
    )


def _pack_consts22(vs, im, f, consts) -> np.ndarray:
    return np.concatenate(
        [
            np.asarray(
                [
                    consts["global_scale_inv"],
                    consts["qm_scales"][0],
                    consts["qm_scales"][2],
                    consts["quant_bias"][0],
                    consts["quant_bias"][1],
                    consts["quant_bias"][2],
                    consts["quant_bias_num"],
                    0.0,
                ],
                dtype=np.float32,
            ),
            _opsin_tail14(im),
        ]
    )


def _plan_aux_dct8(vs, gg, im, f, voffs, offs):
    """Per-block dequant/CfL auxiliary planes + kernel constants of an
    all-DCT8 LF group, blocks in raster order: (aux (6,n) f32, weights,
    consts22); the same arrays `lf_group_inputs` gathers for such a group
    (counterpart of combine_jax._plan_aux_dct8, used by the device-resident
    route of ops/device_vardct.py)."""
    n = len(voffs)
    kx_lf = np.float32(vs.base_corr_x + vs.x_factor_lf * vs.inv_colour_factor)
    kb_lf = np.float32(vs.base_corr_b + vs.b_factor_lf * vs.inv_colour_factor)
    lidx = offs >> 6
    lx = gg.llfcoeffs[0][lidx]
    ly = gg.llfcoeffs[1][lidx]
    lb = gg.llfcoeffs[2][lidx]
    cy, cx = np.divmod(np.arange(n), gg.width8)
    kx = (
        vs.base_corr_x
        + vs.inv_colour_factor * np.asarray(gg.xfromy)[cy // 8, cx // 8]
    ).astype(np.float32)
    kb = (
        vs.base_corr_b
        + vs.inv_colour_factor * np.asarray(gg.bfromy)[cy // 8, cx // 8]
    ).astype(np.float32)
    aux = np.stack([
        (lx + ly * kx_lf).astype(np.float32),
        ly.astype(np.float32),
        (lb + ly * kb_lf).astype(np.float32),
        np.asarray(gg.vb_hfmul_inv)[voffs].astype(np.float32),
        kx, kb,
    ])
    consts = dict(
        global_scale_inv=np.float32(65536.0 / vs.global_scale),
        qm_scales=np.array(
            [QM_SCALE[f.x_qm_scale], 1.0, QM_SCALE[f.b_qm_scale]], np.float32
        ),
        quant_bias=np.asarray(im.quant_bias, np.float32),
        quant_bias_num=np.float32(im.quant_bias_num),
    )
    param_idx = DCT_SELECT[0][2]
    return aux, vs.dq_weights[param_idx], _pack_consts22(vs, im, f, consts)


def _dct8_raster(gg):
    """An all-DCT8 group's varblock offsets in raster order and their
    coefficient offsets."""
    blocks_arr = np.asarray(gg.blocks)
    assert ((blocks_arr >> 20) == 2).all(), "not an all-DCT8x8 group"
    voffs = (blocks_arr & 0xFFFFF).reshape(-1)
    return blocks_arr, voffs, np.asarray(gg.vb_coeffoff)[voffs]


def _dct8_coeffs(gg, offs) -> np.ndarray:
    """(3, n, 64) float32: the blocks at coefficient offsets `offs`."""
    cidx = offs[:, None] + np.arange(64)[None, :]
    return np.stack([gg.coeffs[c][cidx] for c in range(3)]).astype(np.float32)


def gather_full_dct8(vs, gg, im, f):
    """Host gather for an all-DCT8x8 LF group, blocks in raster order:
    returns (coeffs (3,n,64) f32, aux (6,n) f32, weights (64,3), consts22)
    (counterpart of combine_jax.gather_full_dct8; the reference that the
    one-pass `gather_pack_dct8_i8` is held against)."""
    _, voffs, offs = _dct8_raster(gg)
    return (_dct8_coeffs(gg, offs), *_plan_aux_dct8(vs, gg, im, f, voffs, offs))


def gather_pack_dct8_i8(vs, gg, im, f):
    """`gather_full_dct8` with the clamped-int8 upload form made in one
    native pass over the coefficient planes (no dense f32 intermediate;
    `native/core.cpp::j40t_gather_pack_dct8`).  Returns ((i8 (3,n,64),
    exc_idx, exc_val, n_gt7, fill0), aux, weights, consts22): the
    exceptions (|v| > 127) in image-flat order, n_gt7 the count of |v| > 7
    (the i4-or-i8 choice of the batch path), fill0 the exact value of flat
    position 0 (counterpart of combine_jax.gather_pack_dct8_i8)."""
    from ..native.bindings import gather_pack_dct8, pack_coeffs_i8

    blocks_arr, voffs, offs = _dct8_raster(gg)
    packed = gather_pack_dct8(gg.coeffs, blocks_arr, offs=np.asarray(gg.vb_coeffoff))
    if packed is None:  # no native library: dense gather + numpy pack
        coeffs = _dct8_coeffs(gg, offs)
        packed = (*pack_coeffs_i8(coeffs), int(coeffs.reshape(-1)[0]))
    return (packed, *_plan_aux_dct8(vs, gg, im, f, voffs, offs))


def _llf_positions(dctsel: int) -> np.ndarray:
    """Canonical positions of a class's LLF coefficients: y*(2^max)+x."""
    log_rows, log_columns, _, _ = DCT_SELECT[dctsel]
    vh8 = 1 << (min(log_rows, log_columns) - 3)
    vw8 = 1 << (max(log_rows, log_columns) - 3)
    return np.array(
        [y * (vw8 * 8) + x for y in range(vh8) for x in range(vw8)], np.int64
    )


def _mixed_xyb(
    dense,       # (3, h8*w8, 64) int8 coeffs on the full 8x8 grid (big-block
                 # cells zero; overlaid below)
    exc_idx, exc_val,
    aux,         # (6, h8*w8): llf x/y/b (LF-CfL applied), hfmul_inv, kx, kb
    weights8,    # (64, 3) DCT8 dequant table
    consts22,
    bigs,        # tuple per big class: (coeffs(3,n,size), llf(3,n,llfsize),
                 #   hfmul_inv(n,), kx(n,), kb(n,), weights(size,3),
                 #   scatter_idx(n*rows*cols,) int64 into the raster plane)
    big_ds: tuple,
    h8: int, w8: int,
):
    """The (3, 8*h8, 8*w8) float32 XYB plane of an LF group: the dense 8x8
    grid runs the fused dequant+IDCT kernel (big-block cells decode to
    zero), then each non-8x8 class is batch-transformed and overlaid with one
    scatter (the reference's per-varblock dispatch loop, j40.h:7178-7191,
    recast as class-batched work)."""
    d = kernels.unpack_i8(dense, exc_idx, exc_val)
    samples = kernels.reconstruct_dct8(d, aux, weights8, consts22[:8], h8, w8)
    flat = samples.reshape(3, -1)
    qm_scales = torch.stack([consts22[1], torch.ones_like(consts22[1]), consts22[2]])
    for ds, (bc, bllf, bhf, bkx, bkb, bw, bidx) in zip(big_ds, bigs):
        llf_idx = torch.from_numpy(_llf_positions(ds)).to(flat.device)
        s = _class_pipeline(
            bc.to(torch.float32), bllf, llf_idx, bhf, bkx, bkb, bw,
            consts22[0], qm_scales, consts22[3:6], consts22[6], ds,
        )
        flat[:, bidx] = s.reshape(3, -1)
    return flat.reshape(3, h8 * 8, w8 * 8)


def lf_group_inputs(vs, gg, im) -> dict:
    """Host gather of one LF group's reconstruction inputs, as numpy.

    kind "dct8" (every cell a DCT8x8 block): i8 (3,n,64) int8, exc_idx,
    exc_val (int32), aux (6,n), weights (64,3), consts22 (22,).  kind
    "mixed": the same for the dense 8x8 grid (big-block cells zero) plus
    `bigs`, one tuple per other class: (dctsel, coeffs (3,m,size), llf
    (3,m,llfsize), hfmul_inv, kx, kb, weights (size,3), scatter index into
    the raster plane).  Both carry h8, w8, to_u8 and the group's (ggh, ggw).
    With the restoration filters on and something to filter, `filters`
    holds the frame's gaborish weights (None when off), its EPF parameters
    (None when it runs no EPF step) and `rs8`, the (h8, w8) float32
    per-block reciprocal sigmas; a frame with neither filter keeps the
    fused path.
    """
    f = vs.fs.f
    ggw8, ggh8 = gg.width8, gg.height8
    kx_lf = np.float32(vs.base_corr_x + vs.x_factor_lf * vs.inv_colour_factor)
    kb_lf = np.float32(vs.base_corr_b + vs.b_factor_lf * vs.inv_colour_factor)

    # group varblocks by dctsel (host, vectorized over the block map)
    blocks_arr = np.asarray(gg.blocks)
    corner_mask = (blocks_arr >> 20) >= 2
    cy, cx = np.nonzero(corner_mask)
    ds_all = (blocks_arr[cy, cx] >> 20) - 2
    voff_all = blocks_arr[cy, cx] & 0xFFFFF
    corner_y = np.empty(gg.nb_varblocks, dtype=np.int64)
    corner_x = np.empty(gg.nb_varblocks, dtype=np.int64)
    corner_y[voff_all] = cy
    corner_x[voff_all] = cx
    classes = {int(ds): voff_all[ds_all == ds] for ds in np.unique(ds_all)}

    consts = dict(
        global_scale_inv=np.float32(65536.0 / vs.global_scale),
        qm_scales=np.array(
            [QM_SCALE[f.x_qm_scale], 1.0, QM_SCALE[f.b_qm_scale]], np.float32
        ),
        quant_bias=np.asarray(im.quant_bias, np.float32),
        quant_bias_num=np.float32(im.quant_bias_num),
    )
    n8 = ggh8 * ggw8
    out = dict(
        h8=ggh8, w8=ggw8, to_u8=im.bpp == 8, ggh=gg.height, ggw=gg.width,
        consts22=_pack_consts22(vs, im, f, consts),
    )
    p8 = DCT_SELECT[0][2]
    if vs.dq_weights[p8] is None:
        # the dense-grid kernel always runs the DCT8 table, even when the
        # stream itself has no 8x8 varblocks (lazy loading skips it then)
        from ..vardct.dequant import load_dq_matrix

        vs.dq_weights[p8] = load_dq_matrix(p8, vs.dq_matrix[p8])
    if set(classes) == {0}:
        # every cell a DCT8 block: one native pass gathers and packs the
        # coefficients (no dense f32 plane; combine_jax.gather_pack_dct8_i8)
        (cup, exc, vals, _, fill0), aux, weights, _ = gather_pack_dct8_i8(vs, gg, im, f)
        out.update(kind="dct8", i8=cup, aux=aux, weights=weights, bigs=[])
        out["exc_idx"], out["exc_val"] = _exceptions(exc, vals, fill0)
    else:
        dense = np.zeros((3, n8, 64), np.float32)
        aux = np.zeros((6, n8), np.float32)
        bigs = []
        for ds, voffs in sorted(classes.items()):
            log_rows, log_columns, param_idx, _ = DCT_SELECT[ds]
            rows, cols = 1 << log_rows, 1 << log_columns
            size = rows * cols
            llfsize = len(_llf_positions(ds))
            offs = np.asarray(gg.vb_coeffoff)[voffs]
            y8s, x8s = corner_y[voffs], corner_x[voffs]
            lidx = (offs[:, None] >> 6) + np.arange(llfsize)[None, :]
            lx = gg.llfcoeffs[0][lidx]
            ly = gg.llfcoeffs[1][lidx]
            lb = gg.llfcoeffs[2][lidx]
            llf = np.stack([lx + ly * kx_lf, ly, lb + ly * kb_lf]).astype(np.float32)
            hfmul_inv = np.asarray(gg.vb_hfmul_inv)[voffs].astype(np.float32)
            kx = (
                vs.base_corr_x
                + vs.inv_colour_factor * np.asarray(gg.xfromy)[y8s // 8, x8s // 8]
            ).astype(np.float32)
            kb = (
                vs.base_corr_b
                + vs.inv_colour_factor * np.asarray(gg.bfromy)[y8s // 8, x8s // 8]
            ).astype(np.float32)
            cidx = offs[:, None] + np.arange(size)[None, :]
            if ds == 0:
                pos = y8s * ggw8 + x8s
                for c in range(3):
                    dense[c][pos] = gg.coeffs[c][cidx]
                aux[0:3, pos] = llf[:, :, 0]
                aux[3, pos] = hfmul_inv
                aux[4, pos] = kx
                aux[5, pos] = kb
            else:
                coeffs = np.stack(
                    [gg.coeffs[c][cidx] for c in range(3)]
                ).astype(np.float32)
                W = ggw8 * 8
                ys = y8s[:, None, None] * 8 + np.arange(rows)[None, :, None]
                xs = x8s[:, None, None] * 8 + np.arange(cols)[None, None, :]
                bidx = (ys * W + xs).astype(np.int32).reshape(-1)
                bigs.append((int(ds), coeffs, llf, hfmul_inv, kx, kb,
                             vs.dq_weights[param_idx], bidx))
        cup, exc_idx, exc_val = _pack_i8(dense)
        out.update(kind="mixed" if bigs else "dct8", i8=cup, exc_idx=exc_idx,
                   exc_val=exc_val, aux=aux, weights=vs.dq_weights[p8], bigs=bigs)
    if frame_filters(vs):
        epf = epf_params(f) if f.epf_iters > 0 else None
        out["filters"] = dict(
            gab=f.gab_weights if f.gab_enabled else None, epf=epf,
            rs8=epf_rs8(vs, gg, 8 * ggh8, 8 * ggw8, False) if epf else None)
    return out


def to_device(inputs: dict, device) -> dict:
    """Tensors on `device` for the arrays of `lf_group_inputs` (constant
    tables through a small content-keyed cache)."""
    dev = torch.device(device)

    def t(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

    out = dict(inputs)
    out.update(
        i8=t(inputs["i8"]), exc_idx=t(inputs["exc_idx"]),
        exc_val=t(inputs["exc_val"]), aux=t(inputs["aux"], np.float32),
        weights=_cached_device("w8", np.asarray(inputs["weights"], np.float32), dev),
        consts22=_cached_device("pc22", inputs["consts22"], dev),
        bigs=[
            (ds, t(c, np.float32), t(llf, np.float32), t(hf, np.float32),
             t(kx, np.float32), t(kb, np.float32),
             _cached_device(("w", ds), np.asarray(w, np.float32), dev),
             t(bidx).long())
            for ds, c, llf, hf, kx, kb, w, bidx in inputs["bigs"]
        ],
    )
    filt = inputs.get("filters")
    if filt is not None and filt["rs8"] is not None:
        out["filters"] = dict(filt, rs8=t(filt["rs8"], np.float32))
    return out


def xyb_plane(d: dict):
    """One LF group's (3, 8*h8, 8*w8) float32 XYB plane from the device
    tensors of `to_device`: the dense 8x8 grid, then each other class."""
    return _mixed_xyb(
        d["i8"], d["exc_idx"], d["exc_val"], d["aux"], d["weights"],
        d["consts22"], tuple(b[1:] for b in d["bigs"]),
        tuple(b[0] for b in d["bigs"]), d["h8"], d["w8"])


def reconstruct_inputs(d: dict):
    """Run one LF group's unfiltered reconstruction on the device tensors
    of `to_device`: (3, 8*h8, 8*w8) uint8 (8 bpp) or int32 sRGB planes (a
    frame with restoration filters goes through `filter_frame`)."""
    if d["kind"] == "dct8":
        return kernels.reconstruct_dct8_full(
            d["i8"], d["exc_idx"], d["exc_val"], d["aux"], d["weights"],
            d["consts22"], d["h8"], d["w8"], d["to_u8"])
    return kernels.xyb_to_srgb(xyb_plane(d), d["consts22"], d["to_u8"])


def gather_lf_group(vs, gg, im, device) -> dict:
    """One LF group's reconstruction inputs as tensors on `device`
    (`lf_group_inputs`, then `to_device`), in a `vardct.gather` span that
    counts the group's 8x8 cells and `big_cells`, those under varblocks
    larger than DCT8."""
    with span(None, "vardct.gather") as sp:
        inp = lf_group_inputs(vs, gg, im)
        sp.counts.update(cells=inp["h8"] * inp["w8"],
                         big_cells=sum(b[1].shape[1] * b[1].shape[2] // 64
                                       for b in inp["bigs"]))
        return to_device(inp, device)


def frame_filters(vs) -> bool:
    """Whether the frame's reconstruction filters the whole frame: the
    restoration filters are on and the frame has gaborish or EPF (then
    `lf_group_inputs` gives a `filters` entry)."""
    f = vs.fs.f
    return bool(getattr(vs.fs, "apply_filters", False) and (f.gab_enabled or f.epf_iters > 0))


def lf_group_xyb_async(vs, gg, im, device) -> dict:
    """Dispatch one LF group's XYB plane for `filter_frame`, WITHOUT
    fetching: {"plane": (3, 8*h8, 8*w8) float32, "rs8": its (h8, w8) EPF
    sigmas or None, "consts22", "to_u8"}."""
    d = gather_lf_group(vs, gg, im, device)
    return dict(plane=xyb_plane(d), rs8=d["filters"]["rs8"], consts22=d["consts22"],
                to_u8=d["to_u8"])


def filter_frame(vs, groups: dict):
    """The restoration filters over the whole frame, then the colour kernel.

    `groups` maps every LF group's index to its `lf_group_xyb_async`.  The
    groups' planes are put together into the frame's (3, 8*H8, 8*W8) plane
    (an LF group is 2048 pixels a side but at the frame's right and bottom
    edges, so the groups' 8-padded planes tile it), with their sigmas into
    the frame's (H8, W8) ones; gaborish, then the EPF steps, run over it
    once, mirroring at the frame's edges only, as the sharded plan
    (ops/sharded_filters.py) filters a frame on one shard.  Returns the
    (3, 8*H8, 8*W8) uint8 (8 bpp) or int32 sRGB planes, not fetched.  The
    stage, from the assembly to the colour kernel's launch, is span
    `filters`, which counts the EPF steps run (`epf_iters`)."""
    f = vs.fs.f
    epf = epf_params(f) if f.epf_iters > 0 else None
    first = groups[min(groups)]
    dev = first["plane"].device
    H8, W8 = ceil_div(f.height, 8), ceil_div(f.width, 8)
    with span(None, "filters", epf_iters=f.epf_iters if epf else 0):
        frame = torch.empty((3, 8 * H8, 8 * W8), dtype=torch.float32, device=dev)
        rs8 = torch.empty((H8, W8), dtype=torch.float32, device=dev) if epf else None
        for ggidx, g in groups.items():
            gg = vs.lf_groups[ggidx]
            _, ph, pw = g["plane"].shape
            frame[:, gg.top : gg.top + ph, gg.left : gg.left + pw] = g["plane"]
            if epf:
                rs8[gg.top // 8 : (gg.top + ph) // 8,
                    gg.left // 8 : (gg.left + pw) // 8] = g["rs8"]
        if f.gab_enabled:
            frame = filter_kernels.gaborish(frame, f.gab_weights)
        if epf:
            frame = filter_kernels.epf_device(frame, rs8, **epf)
        return kernels.xyb_to_srgb(frame, first["consts22"], first["to_u8"])


def combine_lf_group_torch(vs, gg, im, device) -> np.ndarray:
    """Reconstruction of one LF group: returns (3, ggh, ggw) int32 planes.

    Matches VarDCTState.dequant_hf + _combine_lf_group (numpy oracle) within
    float tolerance."""
    dev, ggh, ggw = combine_lf_group_torch_async(vs, gg, im, device)
    return dev[:, :ggh, :ggw].cpu().numpy().astype(np.int32)


def combine_lf_group_torch_async(vs, gg, im, device):
    """Dispatch one LF group's reconstruction; returns (device tensor, ggh,
    ggw) WITHOUT fetching — callers with several LF groups dispatch them all
    so the launches queue on the stream while the host goes on."""
    return reconstruct_inputs(gather_lf_group(vs, gg, im, device)), gg.height, gg.width
