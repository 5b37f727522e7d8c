"""Device-side LF-group reconstruction: per-DctSelect-class batching.

Counterpart of j40_tpu/ops/combine_jax.py.  Every inverse transform in JPEG
XL is linear, so the 8x8 special transforms (Hornuss, DCT2x2, DCT4x4,
DCT4x8, DCT8x4, AFV0-3) are dense 64x64 matrices and the large DCTs
two-sided basis products, batched per class.  One structure on every
device: an all-DCT8 LF group takes the fused kernel (kernels.
reconstruct_dct8_full); a mixed group runs its dense 8x8 grid through the
dequant+IDCT kernel, overlays each other class, then the colour kernel
(`_mixed_full`).  CUDA tensors reach the kernels, CPU tensors their plain
versions.

The host half (`lf_group_inputs`) gathers one LF group's upload arrays in
numpy; `to_device` makes tensors of them.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..errors import Unsupported
from ..vardct import special
from ..vardct.tables import DCT_SELECT, QM_SCALE
from . import kernels
from .reconstruct import cfl_batch, dequant_hf_batch, idct2d_batch

# small on-device caches for constant tables, keyed by content: these arrays
# repeat across decodes (library dequant weights, opsin constants)
_DEVICE_CACHE: dict = {}


def _cached_device(key, np_arr: np.ndarray, device: torch.device) -> torch.Tensor:
    k = (key, str(device))
    ent = _DEVICE_CACHE.get(k)
    if ent is None or ent[0] != np_arr.tobytes():
        ent = (np_arr.tobytes(), torch.from_numpy(np.ascontiguousarray(np_arr)).to(device))
        _DEVICE_CACHE[k] = ent
    return ent[1]


# dctsel values handled by dense 64x64 matrices; vardct/special.py (pure
# numpy) makes the operators, shared with the native host plan
_SPECIAL_FNS = frozenset(special._SPECIAL_FNS)


@functools.lru_cache(maxsize=None)
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


def _pack_i8(arr: np.ndarray):
    """Narrowest lossless upload: clipped int8 plane + exact-value exception
    list (quantized HF coeffs rarely exceed |127|).  Exception capacity is
    bucketed to powers of two.  Padding entries point at flat index 0 with
    its exact value, so duplicate writes carry the same value."""
    flat = arr.reshape(-1)
    cup = np.clip(arr, -127, 127).astype(np.int8)
    exc = np.flatnonzero(np.abs(flat) > 127).astype(np.int64)
    cap = max(64, 1 << int(len(exc)).bit_length())
    exc_idx = np.zeros(cap, np.int32)
    exc_val = np.full(
        cap,
        np.int32(round(float(flat[0]))) if flat.size else np.int32(0),
        np.int32,
    )
    if len(exc):
        exc_idx[1 : 1 + len(exc)] = exc
        exc_val[1 : 1 + len(exc)] = np.round(flat[exc]).astype(np.int32)
    return cup, exc_idx, exc_val


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


def _llf_positions(dctsel: int) -> np.ndarray:
    """Canonical positions of a class's LLF coefficients: y*(2^max)+x."""
    log_rows, log_columns, _, _ = DCT_SELECT[dctsel]
    vh8 = 1 << (min(log_rows, log_columns) - 3)
    vw8 = 1 << (max(log_rows, log_columns) - 3)
    return np.array(
        [y * (vw8 * 8) + x for y in range(vh8) for x in range(vw8)], np.int64
    )


def _mixed_full(
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
    h8: int, w8: int, to_u8: bool,
):
    """Reconstruction of a mixed-DctSelect LF group: the dense 8x8 grid runs
    the fused dequant+IDCT kernel (big-block cells decode to zero), then each
    non-8x8 class is batch-transformed and overlaid with one scatter, then
    the colour kernel (the reference's per-varblock dispatch loop,
    j40.h:7178-7191, recast as class-batched work)."""
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
    plane = flat.reshape(3, h8 * 8, w8 * 8)
    return kernels.xyb_to_srgb(plane, consts22, to_u8)


def lf_group_inputs(vs, gg, im) -> dict:
    """Host gather of one LF group's reconstruction inputs, as numpy.

    kind "dct8" (every cell a DCT8x8 block): i8 (3,n,64) int8, exc_idx,
    exc_val (int32), aux (6,n), weights (64,3), consts22 (22,).  kind
    "mixed": the same for the dense 8x8 grid (big-block cells zero) plus
    `bigs`, one tuple per other class: (dctsel, coeffs (3,m,size), llf
    (3,m,llfsize), hfmul_inv, kx, kb, weights (size,3), scatter index into
    the raster plane).  Both carry h8, w8, to_u8 and the group's (ggh, ggw).
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
    p8 = DCT_SELECT[0][2]
    if vs.dq_weights[p8] is None:
        # the dense-grid kernel always runs the DCT8 table, even when the
        # stream itself has no 8x8 varblocks (lazy loading skips it then)
        from ..vardct.dequant import load_dq_matrix

        vs.dq_weights[p8] = load_dq_matrix(p8, vs.dq_matrix[p8])
    cup, exc_idx, exc_val = _pack_i8(dense)
    out.update(kind="mixed" if bigs else "dct8", i8=cup, exc_idx=exc_idx,
               exc_val=exc_val, aux=aux, weights=vs.dq_weights[p8], bigs=bigs)
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
    return out


def reconstruct_inputs(d: dict):
    """Run one LF group's reconstruction on the device tensors of
    `to_device`: (3, 8*h8, 8*w8) uint8 (8 bpp) or int32 sRGB planes."""
    if d["kind"] == "dct8":
        return kernels.reconstruct_dct8_full(
            d["i8"], d["exc_idx"], d["exc_val"], d["aux"], d["weights"],
            d["consts22"], d["h8"], d["w8"], d["to_u8"])
    return _mixed_full(
        d["i8"], d["exc_idx"], d["exc_val"], d["aux"], d["weights"],
        d["consts22"], tuple(b[1:] for b in d["bigs"]),
        tuple(b[0] for b in d["bigs"]), d["h8"], d["w8"], d["to_u8"])


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
    if getattr(vs.fs, "apply_filters", False):
        # the Decoder refuses this first; kept for direct callers
        raise Unsupported(message="restoration filters on the torch backend "
                          "are not ported yet: ROADMAP A.6")
    inp = lf_group_inputs(vs, gg, im)
    return reconstruct_inputs(to_device(inp, device)), inp["ggh"], inp["ggw"]
