"""Native multithreaded LF-group reconstruction (host execution plan).

ctypes front-end for `j40t_combine_lf_group` (native/reconstruct.cpp): the
host dual of ops/combine_jax.py used when the decoder's execution planner
picks the host backend.  The inverse-transform basis matrices are derived
here from the same Python DCT library both backends share
(vardct/dct.inverse_matrix, ops/combine_jax.special_matrix), so there is a
single source of truth for the transform definitions.

Math parity: mirrors VarDCTState.dequant_hf + _combine_lf_group
(j40.h:7045-7247); validated against the numpy oracle in
tests/test_native_combine.py.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from .tables import DCT_SELECT, QM_SCALE

# dctsel values realized as dense 64x64 operators (8x8 special transforms)
_DENSE_DS = (1, 2, 3, 12, 13, 14, 15, 16, 17)


@functools.lru_cache(maxsize=1)
def _transform_blob() -> tuple[np.ndarray, np.ndarray]:
    """(cls_tab (27,5) int32, mats float32 blob).

    cls_tab row: kind (0 separable / 1 dense), log_rows, log_cols, off_a,
    off_b — offsets into `mats` of Gr/Gc (separable) or the 64x64 dense
    operator (off_b unused)."""
    from .dct import inverse_matrix
    from .special import special_matrix

    mats: list[np.ndarray] = []
    offsets: dict = {}
    pos = 0

    def add(key, arr):
        nonlocal pos
        if key not in offsets:
            a = np.ascontiguousarray(arr, dtype=np.float32)
            offsets[key] = pos
            mats.append(a.ravel())
            pos += a.size
        return offsets[key]

    cls_tab = np.zeros((27, 5), dtype=np.int32)
    for ds in range(27):
        lr, lc, _, _ = DCT_SELECT[ds]
        if ds in _DENSE_DS:
            off = add(("dense", ds), special_matrix(ds))
            cls_tab[ds] = (1, lr, lc, off, 0)
        else:
            off_a = add(("g", 1 << lr), inverse_matrix(1 << lr))
            off_b = add(("g", 1 << lc), inverse_matrix(1 << lc))
            cls_tab[ds] = (0, lr, lc, off_a, off_b)
    return cls_tab, np.concatenate(mats)


_registered = False


def _get_lib():
    global _registered
    from ..native.bindings import get_lib

    lib = get_lib()
    if lib is None or not hasattr(lib, "j40t_combine_lf_group"):
        return None
    if not _registered:
        lib.j40t_combine_lf_group.restype = ctypes.c_int32
        lib.j40t_combine_lf_group.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # coeffs
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # llf
            ctypes.c_int32, ctypes.c_int32,                     # ggh8, ggw8
            ctypes.c_int32, ctypes.c_int32,                     # ggh, ggw
            ctypes.c_void_p, ctypes.c_void_p,  # vb_coeffoff, vb_hfmul_inv
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # dctsel, cy, cx
            ctypes.c_int32,                                     # nb_varblocks
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,   # xfromy/bfromy
            ctypes.c_void_p, ctypes.c_void_p,                   # cls_tab, mats
            ctypes.POINTER(ctypes.c_void_p),                    # dq_w[27]
            ctypes.c_void_p,                                    # consts
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # dst
            ctypes.c_int64, ctypes.c_int32,  # dst_stride, px_stride
            ctypes.c_int32, ctypes.c_int32,  # dst_is_u8, samples_only
            ctypes.c_int32, ctypes.c_int32,  # rect_y0, rect_x0
            ctypes.c_int32, ctypes.c_int32,  # rect_h, rect_w
            ctypes.c_int32,                  # nthreads
        ]
        lib.j40t_gaborish.restype = ctypes.c_int32
        lib.j40t_gaborish.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # planes
            ctypes.c_int32, ctypes.c_int32,                     # h, w
            ctypes.c_void_p, ctypes.c_int32,                    # weights, nthr
        ]
        lib.j40t_epf.restype = ctypes.c_int32
        lib.j40t_epf.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # planes
            ctypes.c_int32, ctypes.c_int32,                     # h, w
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,  # recip, h8, w8
            ctypes.c_int32, ctypes.c_float, ctypes.c_float,  # iters, p0, p2
            ctypes.c_void_p, ctypes.c_float,  # channel_scale, border_sad_mul
            ctypes.c_float, ctypes.c_int32,   # sigma_for_modular, nthreads
        ]
        lib.j40t_xyb_to_srgb.restype = ctypes.c_int32
        lib.j40t_xyb_to_srgb.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # samples
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,  # h, w, sstride
            ctypes.c_void_p,                                  # consts
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # dst
            ctypes.c_int64, ctypes.c_int32,  # dst_stride, px_stride
            ctypes.c_int32, ctypes.c_int32,  # dst_is_u8, nthreads
        ]
        _registered = True
    return lib


def native_combine_available() -> bool:
    from ..modular.decode import _native_enabled

    return _native_enabled() and _get_lib() is not None


def _consts_array(vs, im, f) -> np.ndarray:
    cbrt_bias = np.cbrt(np.asarray(im.opsin_bias, dtype=np.float32))
    return np.concatenate([
        [65536.0 / vs.global_scale, QM_SCALE[f.x_qm_scale],
         QM_SCALE[f.b_qm_scale]],
        np.asarray(im.quant_bias, np.float32), [im.quant_bias_num],
        [vs.base_corr_x + vs.x_factor_lf * vs.inv_colour_factor,
         vs.base_corr_b + vs.b_factor_lf * vs.inv_colour_factor,
         vs.base_corr_x, vs.base_corr_b, vs.inv_colour_factor],
        np.asarray(im.opsin_inv_mat, np.float32).ravel(),
        np.asarray(im.opsin_bias, np.float32), cbrt_bias,
        [255.0 / im.intensity_target, (1 << im.bpp) - 1],
    ]).astype(np.float32)


def _gg_native_ctx(vs, gg, im):
    """Per-LF-group invariants for the native calls, computed once and
    cached on the LfGroup: group-granular pipelining invokes the kernel
    per 256^2 group and any per-call Python work serializes the section
    workers on the GIL."""
    ctx = getattr(gg, "_native_ctx", None)
    if ctx is not None:
        return ctx
    f = vs.fs.f
    cls_tab, mats = _transform_blob()
    blocks_arr = np.asarray(gg.blocks)
    cy, cx = np.nonzero((blocks_arr >> 20) >= 2)
    voff_all = blocks_arr[cy, cx] & 0xFFFFF
    corner_y8 = np.zeros(gg.nb_varblocks, dtype=np.int32)
    corner_x8 = np.zeros(gg.nb_varblocks, dtype=np.int32)
    corner_y8[voff_all] = cy
    corner_x8[voff_all] = cx
    dctsel = np.ascontiguousarray(gg.vb_dctsel, dtype=np.int32)
    coeffoff = np.ascontiguousarray(gg.vb_coeffoff, dtype=np.int64)
    hfmul_inv = np.ascontiguousarray(gg.vb_hfmul_inv, dtype=np.float32)
    xfromy = np.ascontiguousarray(gg.xfromy, dtype=np.float32)
    bfromy = np.ascontiguousarray(gg.bfromy, dtype=np.float32)
    dq_ptrs = (ctypes.c_void_p * 27)()
    keepalive = []
    for ds in np.unique(dctsel):
        # reciprocal, channel-major (3, size): the kernel multiplies by
        # contiguous per-channel rows instead of dividing stride-3 gathers
        w = vs.dq_weights[DCT_SELECT[int(ds)][2]]
        winv = np.ascontiguousarray(
            (np.float32(1.0) / np.asarray(w, np.float32)).T, dtype=np.float32
        )
        keepalive.append(winv)
        dq_ptrs[int(ds)] = winv.ctypes.data
    consts = _consts_array(vs, im, f)
    ctx = (cls_tab, mats, corner_y8, corner_x8, dctsel, coeffoff, hfmul_inv,
           xfromy, bfromy, dq_ptrs, consts, keepalive)
    gg._native_ctx = ctx
    return ctx


def combine_lf_group_native(vs, gg, im, dst, nthreads: int = 1,
                            samples_only: bool = False,
                            rect: tuple | None = None) -> None:
    """Reconstruct one LF group into `dst` — three (H, W) plane arrays
    (uint8 or int32) covering the whole frame; writes the gg window.

    `rect` (y0, x0, h, w), in gg pixel coordinates and 8-aligned at the
    origin, restricts the work to the varblocks whose corners lie inside —
    group-granular pipelining (varblocks never cross 256^2 group borders,
    j40.h:6636-6687, so any union of whole groups is self-contained).

    With `samples_only`, `dst` is instead three float32 (h, w) planes
    receiving the pre-XYB samples (for restoration filtering; finish with
    xyb_to_srgb_native)."""
    lib = _get_lib()
    f = vs.fs.f
    ctx = _gg_native_ctx(vs, gg, im)
    (cls_tab, mats, corner_y8, corner_x8, dctsel, coeffoff, hfmul_inv,
     xfromy, bfromy, dq_ptrs, consts, _keep) = ctx

    ry0, rx0, rh, rw = rect if rect is not None else (0, 0, gg.height, gg.width)
    nb_varblocks = gg.nb_varblocks

    is_u8 = dst[0].dtype == np.uint8
    itemsize = dst[0].itemsize
    stride = dst[0].strides[0] // itemsize
    px_stride = dst[0].strides[1] // itemsize  # 4 for an interleaved canvas
    if samples_only:
        assert dst[0].dtype == np.float32 and px_stride == 1
        dst_ptrs = [d.ctypes.data for d in dst]
    else:
        dst_ptrs = [
            d.ctypes.data
            + (gg.top + ry0) * d.strides[0]
            + (gg.left + rx0) * d.strides[1]
            for d in dst
        ]

    rc = lib.j40t_combine_lf_group(
        gg.coeffs[0].ctypes.data, gg.coeffs[1].ctypes.data,
        gg.coeffs[2].ctypes.data,
        gg.llfcoeffs[0].ctypes.data, gg.llfcoeffs[1].ctypes.data,
        gg.llfcoeffs[2].ctypes.data,
        gg.height8, gg.width8, gg.height, gg.width,
        coeffoff.ctypes.data, hfmul_inv.ctypes.data,
        dctsel.ctypes.data, corner_y8.ctypes.data, corner_x8.ctypes.data,
        nb_varblocks,
        xfromy.ctypes.data, bfromy.ctypes.data, xfromy.shape[1],
        cls_tab.ctypes.data, mats.ctypes.data, dq_ptrs, consts.ctypes.data,
        dst_ptrs[0], dst_ptrs[1], dst_ptrs[2],
        stride, px_stride, 1 if is_u8 else 0,
        1 if samples_only else 0, ry0, rx0, rh, rw, max(1, nthreads),
    )
    assert rc == 0


def xyb_to_srgb_native(samples, vs, im, f, dst, top: int, left: int,
                       nthreads: int = 1) -> None:
    """XYB->sRGB of a (3, h, w) float32 sample block into the `dst` planes'
    (top, left) window (the post-filter finish of a samples_only pass)."""
    lib = _get_lib()
    consts = _consts_array(vs, im, f)
    h, w = samples.shape[1], samples.shape[2]
    assert samples.dtype == np.float32 and samples.flags.c_contiguous
    itemsize = dst[0].itemsize
    stride = dst[0].strides[0] // itemsize
    px_stride = dst[0].strides[1] // itemsize
    is_u8 = dst[0].dtype == np.uint8
    dst_ptrs = [
        d.ctypes.data + top * d.strides[0] + left * d.strides[1] for d in dst
    ]
    rc = lib.j40t_xyb_to_srgb(
        samples[0].ctypes.data, samples[1].ctypes.data,
        samples[2].ctypes.data, h, w, w, consts.ctypes.data,
        dst_ptrs[0], dst_ptrs[1], dst_ptrs[2],
        stride, px_stride, 1 if is_u8 else 0, max(1, nthreads),
    )
    assert rc == 0


def gaborish_native(samples: np.ndarray, weights, nthreads: int = 1) -> None:
    """In-place 3x3 gaborish over (3, H, W) float32 planes
    (native/reconstruct.cpp dual of ops/filters.gaborish)."""
    lib = _get_lib()
    assert samples.dtype == np.float32 and samples.flags.c_contiguous
    w = np.asarray(weights, np.float32).reshape(3, 2)
    w = np.ascontiguousarray(w)
    h, wid = samples.shape[1], samples.shape[2]
    rc = lib.j40t_gaborish(
        samples[0].ctypes.data, samples[1].ctypes.data,
        samples[2].ctypes.data, h, wid, w.ctypes.data, max(1, nthreads),
    )
    assert rc == 0


def epf_native(samples: np.ndarray, vs, gg, nthreads: int = 1) -> None:
    """In-place EPF (up to 3 steps) over (3, H, W) float32 planes
    (native/reconstruct.cpp dual of ops/filters.epf for VarDCT frames)."""
    from ..ops.filters import epf_recip_sigmas

    lib = _get_lib()
    f = vs.fs.f
    if f.epf_iters <= 0:
        return
    assert samples.dtype == np.float32 and samples.flags.c_contiguous
    recip = epf_recip_sigmas(vs, gg)
    recip = np.ascontiguousarray(recip, np.float32)
    cs = np.ascontiguousarray(f.epf_channel_scale, np.float32)
    h, w = samples.shape[1], samples.shape[2]
    rc = lib.j40t_epf(
        samples[0].ctypes.data, samples[1].ctypes.data,
        samples[2].ctypes.data, h, w,
        recip.ctypes.data, recip.shape[0], recip.shape[1],
        f.epf_iters, f.epf_pass0_sigma_scale, f.epf_pass2_sigma_scale,
        cs.ctypes.data, f.epf_border_sad_mul, f.epf_sigma_for_modular,
        max(1, nthreads),
    )
    assert rc == 0
