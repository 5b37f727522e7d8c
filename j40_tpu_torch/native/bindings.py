"""ctypes bindings for the native host core (libj40t.so).

The native core carries the hot serial loops (clustered entropy decode,
modular prediction, HF coefficients); Python remains the orchestrator and
correctness oracle.  If the library is missing it is built on first use; if
that fails, callers fall back to the pure-Python path.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import numpy as np

from ..entropy.code import CodeSpec

_DIR = Path(__file__).resolve().parent
_LIB_PATH = _DIR / "libj40t.so"
_lib = None
_tried = False


def get_lib():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not _LIB_PATH.exists():
        try:
            subprocess.run(
                ["make", "-C", str(_DIR)], capture_output=True, check=True
            )
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError:
        return None

    lib.j40t_stream_new.restype = ctypes.c_void_p
    lib.j40t_stream_new.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
    ]
    lib.j40t_stream_free.argtypes = [ctypes.c_void_p]
    lib.j40t_stream_bitpos.restype = ctypes.c_int64
    lib.j40t_stream_bitpos.argtypes = [ctypes.c_void_p]
    lib.j40t_stream_error.restype = ctypes.c_int32
    lib.j40t_stream_error.argtypes = [ctypes.c_void_p]
    lib.j40t_stream_ans_state.restype = ctypes.c_uint32
    lib.j40t_stream_ans_state.argtypes = [ctypes.c_void_p]
    lib.j40t_decode_symbols.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.c_int32, ctypes.POINTER(ctypes.c_int32),
    ]
    lib.j40t_decode_modular_channel.restype = ctypes.c_int32
    lib.j40t_decode_modular_channel.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,   # tree
        ctypes.POINTER(ctypes.c_int32),                   # wp params
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,   # dist_mult, cidx, sidx
        ctypes.c_int32, ctypes.c_int32,                   # width, height
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_int32,  # refs
        ctypes.POINTER(ctypes.c_int32),                   # out
        ctypes.c_int32, ctypes.c_int32,                   # out_stride, ref_stride
        ctypes.c_int64,                                   # range_max
    ]
    lib.j40t_decode_hf_group.restype = ctypes.c_int32
    lib.j40t_decode_hf_group.argtypes = [
        ctypes.c_void_p, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_void_p),
    ]
    lib.j40t_pack_i8.restype = ctypes.c_int64
    lib.j40t_pack_i8.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,   # src, count
        ctypes.POINTER(ctypes.c_int8), ctypes.c_int32,    # dst, lim
        ctypes.c_int64,                                   # exc_base
        ctypes.POINTER(ctypes.c_int32),                   # exc_idx out
        ctypes.POINTER(ctypes.c_int32),                   # exc_val out
        ctypes.c_int64,                                   # exc_cap
        ctypes.POINTER(ctypes.c_int64),                   # n_gt7 out
    ]
    lib.j40t_pack_i4_chunk.restype = ctypes.c_int64
    lib.j40t_pack_i4_chunk.argtypes = [
        ctypes.POINTER(ctypes.c_int8), ctypes.c_int64,    # src, count
        ctypes.POINTER(ctypes.c_uint8),                   # dst nibbles
        ctypes.POINTER(ctypes.c_int32),                   # exc_idx out
        ctypes.POINTER(ctypes.c_int32),                   # exc_val out
        ctypes.c_int64,                                   # exc_cap
    ]
    lib.j40t_gather_pack_dct8.restype = ctypes.c_int64
    lib.j40t_gather_pack_dct8.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int8), ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
    ]
    lib.j40t_place_varblocks.restype = ctypes.c_int32
    lib.j40t_place_varblocks.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,   # dctsel, nb
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,   # ggw8, ggh8, log_gsize8
        ctypes.POINTER(ctypes.c_int32),                   # dct_select table
        ctypes.POINTER(ctypes.c_int32),                   # blocks out
        ctypes.POINTER(ctypes.c_int64),                   # coeffoff out
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),  # x8, y8
        ctypes.POINTER(ctypes.c_uint32),                  # used[2]
    ]
    lib.j40t_render_interleave.restype = ctypes.c_int32
    lib.j40t_render_interleave.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32,                   # h, w
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,  # out, depth, bpp
        ctypes.c_int32,                                   # nthreads
    ]
    _lib = lib
    return _lib


def render_interleave(planes, alpha, out: np.ndarray, depth: int, bpp: int,
                      nthreads: int) -> bool:
    """Fused clamp+interleave render of int32 planes into (h, w, 4) RGBA
    (the reference's clamp+scale, j40.h:7910-7962).  Returns False when the
    native library or the layout preconditions are unavailable; the caller
    falls back to the numpy per-channel path."""
    lib = get_lib()
    if lib is None:
        return False
    h, w = planes[0].shape
    srcs = list(planes) + [alpha]
    ptrs, strides = [], []
    for p in srcs:
        if p is None:
            ptrs.append(None)
            strides.append(0)
            continue
        if p.dtype != np.int32 or p.strides[1] != 4 or p.strides[0] % 4:
            return False
        ptrs.append(p.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        strides.append(p.strides[0] // 4)
    rc = lib.j40t_render_interleave(
        ptrs[0], ptrs[1], ptrs[2], ptrs[3],
        strides[0], strides[1], strides[2], strides[3],
        h, w, out.ctypes.data_as(ctypes.c_void_p), depth, bpp, nthreads)
    return rc == 0


def place_varblocks(dctsel_arr: np.ndarray, ggw8: int, ggh8: int,
                    log_gsize8: int, dct_select_blob: np.ndarray):
    """Native greedy varblock placement (j40.h:6636-6687).

    Returns (blocks, coeffoff_arr, vb_x8, vb_y8, used_dct, used_order);
    raises J40Error("vblk"/"dct?") exactly where the Python loop would."""
    lib = get_lib()
    nb = len(dctsel_arr)
    src = np.asarray(dctsel_arr)
    dctsel_arr = np.ascontiguousarray(src, dtype=np.int32)
    # the int32 cast wraps; out-of-range values must raise "dct?" like the
    # Python oracle rather than alias into the valid 0..26 range
    if not np.array_equal(dctsel_arr, src):
        from ..errors import J40Error

        raise J40Error("dct?")
    blocks = np.zeros((ggh8, ggw8), dtype=np.int32)
    coeffoff = np.zeros(nb, dtype=np.int64)
    vb_x8 = np.zeros(nb, dtype=np.int32)
    vb_y8 = np.zeros(nb, dtype=np.int32)
    used = np.zeros(2, dtype=np.uint32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    rc = lib.j40t_place_varblocks(
        dctsel_arr.ctypes.data_as(i32p), nb, ggw8, ggh8, log_gsize8,
        dct_select_blob.ctypes.data_as(i32p),
        blocks.ctypes.data_as(i32p),
        coeffoff.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        vb_x8.ctypes.data_as(i32p), vb_y8.ctypes.data_as(i32p),
        used.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
    )
    if rc != 0:
        from ..errors import J40Error

        raise J40Error("vblk" if rc == 1 else "dct?")
    return blocks, coeffoff, vb_x8, vb_y8, int(used[0]), int(used[1])


def pack_coeffs_i8(coeffs: np.ndarray, lim: int = 127):
    """One-pass f32 -> clamped int8 pack with exception list and a |v|>7
    census (for the i4-vs-i8 upload choice).  Runs GIL-free in the native
    core; numpy fallback when the library is unavailable.

    Returns (i8 array same shape, exc_idx int32 flat indices into coeffs,
    exc_val int32 exact values, n_gt7)."""
    coeffs = np.ascontiguousarray(coeffs, dtype=np.float32)
    flat = coeffs.reshape(-1)
    lib = get_lib()
    if lib is None:
        iv = flat.astype(np.int32)
        exc = np.flatnonzero(np.abs(iv) > lim).astype(np.int32)
        return (
            np.clip(iv, -lim, lim).astype(np.int8).reshape(coeffs.shape),
            exc, iv[exc], int(np.count_nonzero(np.abs(iv) > 7)),
        )
    dst = np.empty(coeffs.shape, np.int8)
    cap = 4096
    while True:
        exc_idx = np.empty(cap, np.int32)
        exc_val = np.empty(cap, np.int32)
        n_gt7 = np.zeros(1, np.int64)
        n = lib.j40t_pack_i8(
            flat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), flat.size,
            dst.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)), lim, 0,
            exc_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            exc_val.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap,
            n_gt7.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        if n >= 0:
            return dst, exc_idx[:n], exc_val[:n], int(n_gt7[0])
        cap = min(cap * 8, flat.size + 1)


def gather_pack_dct8(coeffs3, blocks: np.ndarray, offs: np.ndarray,
                     lim: int = 127):
    """Fused native gather+pack over an all-DCT8x8 raster placement map:
    one pass from the per-channel f32 coefficient planes to the clamped
    int8 upload slab.  Returns (i8 (3,n,64), exc_idx, exc_val, n_gt7,
    fill0) with image-flat exception indices, or None when the native
    library is unavailable (callers fall back to the dense gather)."""
    lib = get_lib()
    if lib is None:
        return None
    blocks = np.ascontiguousarray(blocks, dtype=np.int32)
    offs = np.ascontiguousarray(offs, dtype=np.int64)
    n = blocks.size
    planes = [np.ascontiguousarray(coeffs3[c], dtype=np.float32)
              for c in range(3)]
    ptrs = (ctypes.c_void_p * 3)()
    for c in range(3):
        ptrs[c] = planes[c].ctypes.data
    dst = np.empty((3, n, 64), np.int8)
    cap = 4096
    while True:
        exc_idx = np.empty(cap, np.int32)
        exc_val = np.empty(cap, np.int32)
        n_gt7 = np.zeros(1, np.int64)
        ne = lib.j40t_gather_pack_dct8(
            ptrs, blocks.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            n, offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            dst.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)), lim,
            exc_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            exc_val.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap,
            n_gt7.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        if ne >= 0:
            exc_idx, exc_val = exc_idx[:ne], exc_val[:ne]
            break
        cap = min(cap * 8, 3 * n * 64 + 1)
    # exact value of flat position 0 (the exception scatter's fill target)
    fill0 = int(exc_val[0]) if ne and exc_idx[0] == 0 else int(dst[0, 0, 0])
    return dst, exc_idx, exc_val, int(n_gt7[0]), fill0


def pack_i4_chunk(i8_slab: np.ndarray, exc_hint: int = 4096):
    """One native pass: int8 slab -> packed 4-bit nibbles + |v|>7 exception
    list (indices flat into the slab; values are the slab's, so entries the
    i8 clamp already truncated must be patched by the caller from the exact
    per-image lists).  Replaces the numpy clip/view/pair/flatnonzero chain
    in chunk assembly.  Returns (nibbles uint8 last-dim-halved, exc_idx,
    exc_val) or None without the native library."""
    lib = get_lib()
    if lib is None:
        return None
    flat = np.ascontiguousarray(i8_slab).reshape(-1)
    assert flat.size % 2 == 0
    dst = np.empty(i8_slab.shape[:-1] + (i8_slab.shape[-1] // 2,), np.uint8)
    cap = max(64, 1 << int(exc_hint).bit_length())
    while True:
        exc_idx = np.empty(cap, np.int32)
        exc_val = np.empty(cap, np.int32)
        ne = lib.j40t_pack_i4_chunk(
            flat.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)), flat.size,
            dst.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            exc_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            exc_val.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap,
        )
        if ne >= 0:
            return dst, exc_idx[:ne], exc_val[:ne]
        cap = min(cap * 8, flat.size + 1)


def serialize_spec(spec: CodeSpec) -> np.ndarray | None:
    """Flatten a CodeSpec into the int32 blob parse_spec() expects.

    Returns None if the spec isn't representable (shouldn't happen)."""
    out = [
        1 if spec.use_prefix_code else 0,
        1 if spec.lz77_enabled else 0,
        spec.min_symbol,
        spec.min_length,
    ]
    if spec.lz_len_config is not None:
        c = spec.lz_len_config
        out += [c.split_exp, c.msb_in_token, c.lsb_in_token]
    else:
        out += [0, 0, 0]
    out += [spec.num_dist, spec.num_clusters, spec.log_alpha_size]
    out += list(spec.cluster_map)
    for cl in spec.clusters:
        out += [cl.config.split_exp, cl.config.msb_in_token, cl.config.lsb_in_token]
        if spec.use_prefix_code:
            # entries are len | (LSB-first pattern << 4): simple flat-4 codes
            # are not canonical, so exact patterns must travel with the spec
            pc = cl.prefix
            if pc.single_symbol is not None:
                alpha = pc.single_symbol + 1
                entries = [0] * alpha
                entries[pc.single_symbol] = 1
                if alpha == 1:
                    entries = [1]
            else:
                emap = {}
                for l in range(1, pc.max_len + 1):
                    for pat, sym in pc.by_len[l].items():
                        emap[sym] = l | (pat << 4)
                alpha = max(emap) + 1
                entries = [emap.get(s, 0) for s in range(alpha)]
            out.append(alpha)
            out += entries
        else:
            out += list(cl.D)
    return np.asarray(out, dtype=np.int32)


def serialize_spec_cached(spec: CodeSpec) -> np.ndarray | None:
    """Per-spec memoized blob: one HfGlobal code spec serves every pass
    group of the frame (192 sections at 12MP), so the flattening — Python
    loops over prefix-code pattern maps — must not repeat per section."""
    blob = getattr(spec, "_native_blob", None)
    if blob is None:
        blob = serialize_spec(spec)
        spec._native_blob = blob
    return blob


class NativeStream:
    """One entropy-coded stream decoded natively; wraps J40TStream."""

    def __init__(self, data: bytes, bitpos: int, spec: CodeSpec):
        lib = get_lib()
        assert lib is not None
        blob = serialize_spec_cached(spec)
        self._data = data  # keep alive
        self._blob = blob
        self.lib = lib
        self.handle = lib.j40t_stream_new(
            data,
            len(data),
            bitpos,
            blob.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(blob),
        )
        if not self.handle:
            raise RuntimeError("native stream init failed")

    def __del__(self):
        if getattr(self, "handle", None):
            self.lib.j40t_stream_free(self.handle)
            self.handle = None

    @property
    def bitpos(self) -> int:
        return self.lib.j40t_stream_bitpos(self.handle)

    @property
    def error(self) -> bool:
        return bool(self.lib.j40t_stream_error(self.handle))

    @property
    def ans_state(self) -> int:
        return self.lib.j40t_stream_ans_state(self.handle)

    def decode_symbols(self, ctxs: np.ndarray, dist_mult: int = 0) -> np.ndarray:
        """Batch-decode len(ctxs) symbols (contexts given per symbol)."""
        ctxs = np.ascontiguousarray(ctxs, dtype=np.int32)
        out = np.empty(len(ctxs), dtype=np.int32)
        self.lib.j40t_decode_symbols(
            self.handle,
            ctxs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(ctxs), dist_mult,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        if self.error:
            from ..errors import ShortInput

            raise ShortInput("native decode overrun")
        return out

    def decode_modular_channel(self, tree_arr: np.ndarray, wp_arr: np.ndarray,
                               dist_mult: int, cidx: int, sidx: int,
                               width: int, height: int,
                               refs: list[np.ndarray],
                               out: np.ndarray | None = None,
                               range_max: int = 32767) -> np.ndarray:
        """Decode into `out` (int32, contiguous rows; may be a strided view
        such as a sub-rectangle of the gmodular plane) or a fresh array."""
        if (out is None or out.dtype != np.int32
                or out.strides[1] != 4 or out.shape != (height, width)):
            out = np.empty((height, width), dtype=np.int32)
        out_stride = out.strides[0] // 4
        # all refs must share one stride for the C ABI (they come from the
        # same modular image, so this holds; fall back to copies otherwise)
        ref_stride = width
        if refs:
            ok = all(r.dtype == np.int32 and r.strides[1] == 4 for r in refs)
            if not ok or len({r.strides[0] for r in refs}) != 1:
                refs = [np.ascontiguousarray(r, dtype=np.int32) for r in refs]
            ref_stride = refs[0].strides[0] // 4
        ref_ptrs = (ctypes.c_void_p * max(1, len(refs)))()
        for i, rarr in enumerate(refs):
            ref_ptrs[i] = rarr.ctypes.data
        rc = self.lib.j40t_decode_modular_channel(
            self.handle,
            tree_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(tree_arr) // 8,
            wp_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            dist_mult, cidx, sidx, width, height,
            ref_ptrs, len(refs),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            out_stride, ref_stride, range_max,
        )
        if rc == 1:
            from ..errors import J40Error

            raise J40Error("povf")
        if rc == 2:
            from ..errors import J40Error

            raise J40Error("trec")
        if rc == 3:
            from ..errors import ShortInput

            raise ShortInput("native decode overrun")
        return out


def tree_to_array(tree) -> np.ndarray:
    """Flatten TreeNode list to the 8-int32 wire format."""
    arr = np.zeros((len(tree), 8), dtype=np.int32)
    for i, n in enumerate(tree):
        arr[i] = (n.prop, n.value, n.left, n.right, n.ctx, n.predictor,
                  n.offset, n.multiplier)
    return arr.ravel()


def wp_to_array(wp) -> np.ndarray:
    return np.asarray(
        [wp.p1, wp.p2, *wp.p3, *wp.w], dtype=np.int32
    )
