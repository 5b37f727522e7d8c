"""VarDCT decode state (reference j40.h:6250-7247).

Host-side entropy/bookkeeping stages (LfGlobal, LfGroup metadata, HF
coefficient decode) feed device-friendly arrays; the reconstruction
(dequant → CfL → IDCT → XYB→sRGB) has both a numpy oracle (combine here) and
the PyTorch/CUDA path in ops/combine.py.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..errors import check
from ..io.bits import BitReader, ceil_lg
from ..mathutil import ceil_div, unpack_signed
from ..profile import span  # port: the decode's spans
from ..entropy.code import CodeSpec, CodeState, read_cluster_map, read_code_spec
from ..headers.frame import read_permutation, apply_permutation
from .dct import forward_dct2d_scaled_for_llf, forward_matrix, inverse_dct2d, lf2llf_scales
from .dequant import DqMatrix, load_dq_matrix, read_dq_matrix
from .order import natural_order
from .special import (
    inverse_afv,
    inverse_dct11,
    inverse_dct22,
    inverse_dct23,
    inverse_dct32,
    inverse_hornuss,
)
from .tables import (
    DCT_SELECT,
    DEFAULT_BLKCTX,
    LOG_ORDER_SIZE,
    NUM_DCT_PARAMS,
    NUM_DCT_SELECT,
    NUM_ORDERS,
    QM_SCALE,
    TWICE_COEFF_FREQ_CTX,
    TWICE_COEFF_NNZ_CTX,
)

YXB2XYB = (1, 0, 2)

# int32 [27*4] DctSelect table blob shared with the native core
# (j40t_decode_hf_group / j40t_place_varblocks): log_rows, log_cols,
# param_idx, order_idx per entry
DCT_SELECT_BLOB = np.ascontiguousarray(
    [v for row in DCT_SELECT for v in row], dtype=np.int32
)


def fill_large_llf(lfquant, llfcoeffs, logs, y8, x8, coeffoff) -> int:
    """port: the LLF coefficients of varblocks larger than DCT8
    (j40.h:6669-6683), one stacked forward DCT a shape of LF block.
    `logs` holds each varblock's (log_rows, log_columns), `y8`/`x8` its
    top-left LF cell and `coeffoff` its coefficient offset.  The operations
    and their order are `forward_dct2d_scaled_for_llf`'s, so each block
    comes out bit for bit as that function gives it.  Returns the number of
    varblocks filled."""
    shape = logs[:, 0] * 16 + logs[:, 1]
    for key in np.unique(shape):
        at = np.nonzero(shape == key)[0]
        log_vh, log_vw = divmod(int(key), 16)
        vh8, vw8 = 1 << (log_vh - 3), 1 << (log_vw - 3)
        ys = y8[at, None, None] + np.arange(vh8)[:, None]
        xs = x8[at, None, None] + np.arange(vw8)
        dst = (coeffoff[at] >> 6)[:, None] + np.arange(vh8 * vw8)
        fh, fw = forward_matrix(vh8), forward_matrix(vw8).T
        sh, sw = lf2llf_scales(log_vh - 3)[:, None], lf2llf_scales(log_vw - 3)[None, :]
        for c in range(3):
            f = fh @ lfquant[c][ys, xs].astype(np.float32, copy=False) @ fw
            f = f * sh * sw
            if vw8 <= vh8:  # canonical layout transposes when columns <= rows
                f = f.swapaxes(1, 2)
            llfcoeffs[c][dst] = f.reshape(len(at), vh8 * vw8)
    return len(shape)


def _use_u8_planes(im, f) -> bool:
    """Whether reconstruction can write uint8 planes directly: a full-frame
    last frame with no blending or upsampling at 8bpp never needs wider
    intermediate math (the compositor reads the planes verbatim; the
    upsampling kernel's negative lobes overshoot [0, 255] and must keep
    int32 planes until render clips)."""
    return (
        im.bpp == 8
        and f.is_last
        and f.log_upsampling == 0
        and f.x0 == 0 and f.y0 == 0
        and f.disp_width == im.width
        and f.disp_height == im.height
        and f.blend_info.mode == 0
    )


@dataclass
class LfGroup:
    idx: int
    left: int
    top: int
    width: int
    height: int

    @property
    def width8(self):
        return ceil_div(self.width, 8)

    @property
    def height8(self):
        return ceil_div(self.height, 8)

    @property
    def width64(self):
        return ceil_div(self.width, 64)

    @property
    def height64(self):
        return ceil_div(self.height, 64)

    xfromy: np.ndarray | None = None  # (h64, w64) int
    bfromy: np.ndarray | None = None
    sharpness: np.ndarray | None = None  # (h8, w8)
    nb_varblocks: int = 0
    blocks: np.ndarray | None = None  # (h8, w8) int32: (dctsel+2)<<20|voff at corners
    vb_coeffoff: np.ndarray | None = None  # per varblock
    vb_qfidx: np.ndarray | None = None
    vb_hfmul_inv: np.ndarray | None = None
    vb_dctsel: np.ndarray | None = None
    llfcoeffs: list | None = None  # [3] x (w8*h8,) float32
    coeffs: list | None = None  # [3] x (w8*h8*64,) float32
    lfindices: np.ndarray | None = None  # (h8, w8) uint8
    loaded: bool = False
    native_ctx: tuple | None = None  # contiguous views shared by HF sections


class VarDCTState:
    def __init__(self, frame_state):
        self.fs = frame_state
        f = frame_state.f
        self.global_scale = 0
        self.quant_lf = 0
        self.lf_thr = [[], [], []]
        self.qf_thr = []
        self.nb_lf_thr = [0, 0, 0]
        self.nb_qf_thr = 0
        self.block_ctx_map: list[int] = list(DEFAULT_BLKCTX)
        self.block_ctx_size = len(DEFAULT_BLKCTX)
        self.nb_block_ctx = 15
        self.inv_colour_factor = 1 / 84.0
        self.x_factor_lf = 0
        self.b_factor_lf = 0
        self.base_corr_x = 0.0
        self.base_corr_b = 1.0
        self.dct_select_used = 0
        self.order_used = 0
        self.dct_select_loaded = 0
        self.order_loaded = 0
        self.dq_matrix: list[DqMatrix] = [DqMatrix() for _ in range(NUM_DCT_PARAMS)]
        self.dq_weights: list[np.ndarray | None] = [None] * NUM_DCT_PARAMS
        self.num_hf_presets = 1
        # orders[pass][order_idx][c] -> lehmer list or None
        self.orders_lehmer = [
            [[None] * 3 for _ in range(NUM_ORDERS)] for _ in range(f.num_passes)
        ]
        self.orders = [[[None] * 3 for _ in range(NUM_ORDERS)] for _ in range(f.num_passes)]
        self.coeff_codespec: list[CodeSpec | None] = [None] * f.num_passes
        self.lf_groups: dict[int, LfGroup] = {}
        # serializes the shared lazy materialization (dq weights, orders,
        # used-bitsets) when LF-group sections decode on parallel threads
        import threading

        self._lock = threading.Lock()
        # device reconstructions dispatched early (while other LF groups'
        # sections are still entropy-decoding); consumed by combine()
        self._predispatched: dict[int, tuple] = {}
        self._dispatch_lock = threading.Lock()
        self.block_ctx_map_u8: np.ndarray | None = None
        self._order_ptr_cache: dict[int, tuple] = {}
        self._native_dst: list | None = None  # host-plan output planes
        self._native_rgba: np.ndarray | None = None  # interleaved canvas
        self._native_groups_done: set[tuple] = set()  # (ggidx, gy, gx)

    # -- LfGlobal (VarDCT part, j40.h:6271-6313) ---------------------------

    def read_lf_global(self, r: BitReader) -> None:
        f = self.fs.f
        self.global_scale = r.u32(1, 11, 2049, 11, 4097, 12, 8193, 16)
        self.quant_lf = r.u32(16, 0, 1, 5, 1, 8, 1, 16)

        if r.u(1):  # default HF block context
            self.block_ctx_map = list(DEFAULT_BLKCTX)
            self.block_ctx_size = len(DEFAULT_BLKCTX)
            self.nb_block_ctx = 15
            self.nb_qf_thr = 0
            self.nb_lf_thr = [0, 0, 0]
        else:
            self.block_ctx_size = 39
            for i in range(3):
                self.nb_lf_thr[i] = r.u(4)
                self.lf_thr[i] = [
                    unpack_signed(r.u32(0, 4, 16, 8, 272, 16, 65808, 32))
                    for _ in range(self.nb_lf_thr[i])
                ]
                self.block_ctx_size *= self.nb_lf_thr[i] + 1
            self.nb_qf_thr = r.u(4)
            self.qf_thr = [
                r.u32(0, 2, 4, 3, 12, 5, 44, 8) + 1 for _ in range(self.nb_qf_thr)
            ]
            self.block_ctx_size *= self.nb_qf_thr + 1
            check(self.block_ctx_size <= 39 * 64, "hfbc")
            self.nb_block_ctx, self.block_ctx_map = read_cluster_map(
                r, self.block_ctx_size, 16
            )

        if not r.u(1):  # LfChannelCorrelation not all_default
            self.inv_colour_factor = 1.0 / r.u32(84, 0, 256, 0, 2, 8, 258, 16)
            self.base_corr_x = r.f16()
            self.base_corr_b = r.f16()
            self.x_factor_lf = r.u(8) - 127
            self.b_factor_lf = r.u(8) - 127

    # -- HfGlobal + HfPass (j40.h:6819-6870) -------------------------------

    def read_hf_global(self, r: BitReader) -> None:
        fs, f = self.fs, self.fs.f
        sidx_base = 1 + 3 * f.num_lf_groups
        if not r.u(1):  # custom dq matrices
            from .tables import DCT_PARAMS

            for i in range(NUM_DCT_PARAMS):
                dct = DCT_PARAMS[i]
                rows, columns = 1 << dct[0], 1 << dct[1]
                self.dq_matrix[i] = read_dq_matrix(
                    r, rows, columns, sidx_base + i,
                    fs.global_tree, fs.global_codespec, fs.limits,
                )

        self.num_hf_presets = r.u(ceil_lg(f.num_groups)) + 1

        for p in range(f.num_passes):
            used_orders = r.u32(0x5F, 0, 0x13, 0, 0, 0, 0, 13)
            code = None
            if used_orders > 0:
                spec = read_code_spec(r, 8)
                code = CodeState(spec)
            for j in range(NUM_ORDERS):
                if used_orders >> j & 1:
                    size = 1 << (LOG_ORDER_SIZE[j][0] + LOG_ORDER_SIZE[j][1])
                    for c in range(3):
                        self.orders_lehmer[p][j][c] = read_permutation(
                            r, code, size, size // 64
                        )
            if used_orders > 0:
                code.finish(r)
            self.coeff_codespec[p] = read_code_spec(
                r, 495 * self.nb_block_ctx * self.num_hf_presets
            )

    # -- LF group (j40.h:6722-6789) ----------------------------------------

    def _decode_modular_subimage(self, r: BitReader, shapes, sidx):
        from ..modular.decode import (
            Channel,
            ModularImage,
            allocate,
            decode_channel,
            parse_modular_header,
        )
        from ..modular.transforms import inverse_transforms

        fs = self.fs
        m = ModularImage(channels=[Channel(w, h) for (w, h) in shapes])
        parse_modular_header(r, m, fs.global_tree, fs.global_codespec, fs.limits)
        allocate(m)
        for c in range(m.num_channels):
            decode_channel(r, m, c, sidx)
        m.code.finish(r)
        inverse_transforms(m, fs.im.bpp)
        return m

    def read_lf_group(self, r: BitReader, ggidx: int) -> None:
        # port: an LF group's section is a `vardct.lf_group` span, which counts
        # its varblocks and `llf_blocks`, those larger than DCT8 whose LLF the
        # batched fill computed (0 where it did not engage)
        with span(None, "vardct.lf_group") as sp:
            fs, f = self.fs, self.fs.f
            region = fs._lf_group_region(ggidx)
            gg = LfGroup(idx=ggidx, left=region[0], top=region[1],
                         width=region[2], height=region[3])
            ggw8, ggh8 = gg.width8, gg.height8

            # LfQuant (j40.h:6747-6761)
            check(not f.use_lf_frame, "TODO", "lf frames")
            extra_prec = r.u(2)
            m = self._decode_modular_subimage(
                r, [(ggw8, ggh8)] * 3, sidx=1 + ggidx
            )
            lfquant, lfindices = self._lf_quant(extra_prec, m, gg)
            gg.lfindices = lfindices

            # HF metadata (j40.h:6766-6778)
            nb_varblocks = r.u(ceil_lg(ggw8 * ggh8)) + 1
            m = self._decode_modular_subimage(
                r,
                [
                    (gg.width64, gg.height64),
                    (gg.width64, gg.height64),
                    (nb_varblocks, 2),
                    (ggw8, ggh8),
                ],
                sidx=1 + 2 * f.num_lf_groups + ggidx,
            )
            llf_blocks = self._hf_metadata(nb_varblocks, m, lfquant, gg)
            sp.counts.update(varblocks=nb_varblocks, llf_blocks=llf_blocks)
            gg.loaded = True
            self.lf_groups[ggidx] = gg
            with self._lock:
                self._prepare_dq_matrices()
                self._prepare_orders()

    def _lf_quant(self, extra_prec: int, m, gg: LfGroup):
        """Dequantize LF, build lfindices, smooth (j40.h:6492-6583)."""
        f = self.fs.f
        ggw8, ggh8 = gg.width8, gg.height8
        lfquant = []
        for c in range(3):
            mult_lf = (
                f.m_lf_scaled[c]
                / (self.global_scale * self.quant_lf)
                * (65536 >> extra_prec)
            )
            chan = m.channels[YXB2XYB[c]].data
            lfquant.append((chan.astype(np.float32) * np.float32(mult_lf)))
        lfindices = np.zeros((ggh8, ggw8), dtype=np.int32)
        c0 = m.channels[YXB2XYB[0]].data
        c1 = m.channels[YXB2XYB[1]].data
        c2 = m.channels[YXB2XYB[2]].data
        for t in self.lf_thr[0]:
            lfindices += c0 > t
        lfindices *= self.nb_lf_thr[0] + 1
        for t in self.lf_thr[2]:
            lfindices += c2 > t
        lfindices *= self.nb_lf_thr[2] + 1
        for t in self.lf_thr[1]:
            lfindices += c1 > t

        if not f.skip_adapt_lf_smooth:
            self._smooth_lf(gg, lfquant)
        return lfquant, lfindices.astype(np.uint8)

    def _smooth_lf(self, gg: LfGroup, lfquant) -> None:
        """3x3 self-gating LF smoothing (j40.h:6492-6542), float32 parity."""
        f = self.fs.f
        W0 = np.float32(0.05226273532324128)
        W1 = np.float32(0.20345139757231578)
        W2 = np.float32(0.0334829185968739)
        ggh8, ggw8 = lfquant[0].shape
        if ggh8 <= 2 or ggw8 <= 2:
            return
        inv_m_lf = [
            np.float32(self.global_scale * self.quant_lf / f.m_lf_scaled[c] / 65536.0)
            for c in range(3)
        ]
        orig = [q.copy() for q in lfquant]
        wa = [None] * 3
        diff = [None] * 3
        gap = np.full((ggh8 - 2, ggw8 - 2), 0.5, dtype=np.float32)
        for c in range(3):
            q = orig[c]
            wa[c] = (
                (q[:-2, :-2] * W2 + q[:-2, 1:-1] * W1 + q[:-2, 2:] * W2)
                + (q[1:-1, :-2] * W1 + q[1:-1, 1:-1] * W0 + q[1:-1, 2:] * W1)
                + (q[2:, :-2] * W2 + q[2:, 1:-1] * W1 + q[2:, 2:] * W2)
            )
            diff[c] = np.abs(wa[c] - q[1:-1, 1:-1]) * inv_m_lf[c]
            gap = np.maximum(gap, diff[c])
        gap = np.maximum(np.float32(0.0), np.float32(3.0) - np.float32(4.0) * gap)
        for c in range(3):
            center = orig[c][1:-1, 1:-1]
            lfquant[c][1:-1, 1:-1] = (wa[c] - center) * gap + center

    def _hf_metadata(self, nb_varblocks: int, m, lfquant, gg: LfGroup) -> int:
        """Varblock placement & LLF (j40.h:6585-6710).  port: returns the
        number of varblocks whose LLF `fill_large_llf` computed (0 on the
        all-DCT8 fast path and on the Python loop)."""
        f = self.fs.f
        log_gsize8 = f.group_size_shift - 3
        ggw8, ggh8 = gg.width8, gg.height8

        gg.xfromy = m.channels[0].data
        gg.bfromy = m.channels[1].data
        gg.sharpness = m.channels[3].data
        blockinfo = m.channels[2].data  # (2, nb_varblocks)

        blocks = np.zeros((ggh8, ggw8), dtype=np.int32)
        dctsel_arr = blockinfo[0].astype(np.int64)
        hfmul_m1 = blockinfo[1].astype(np.int64)
        coeffoff_arr = np.zeros(nb_varblocks, dtype=np.int64)
        vb_dctsel = np.zeros(nb_varblocks, dtype=np.int32)

        llfcoeffs = [np.zeros(ggw8 * ggh8, dtype=np.float32) for _ in range(3)]
        coeffs = [np.zeros(ggw8 * ggh8 * 64, dtype=np.float32) for _ in range(3)]

        # fast path: every varblock is DCT8x8 in raster order (the dominant
        # case for photographic content and our encoder's output)
        if (
            nb_varblocks == ggw8 * ggh8
            and not dctsel_arr.any()
        ):
            with self._lock:
                self.dct_select_used |= 1
                self.order_used |= 1
            blocks[:] = (2 << 20) | np.arange(nb_varblocks, dtype=np.int32).reshape(
                ggh8, ggw8
            )
            coeffoff_arr[:] = np.arange(nb_varblocks, dtype=np.int64) * 64
            vb_dctsel[:] = 0
            for c in range(3):
                llfcoeffs[c][:] = lfquant[c].ravel()
            self._finish_hf_metadata(
                nb_varblocks, m, gg, blocks, coeffoff_arr, vb_dctsel, hfmul_m1,
                llfcoeffs, coeffs,
            )
            return 0

        llf_blocks = self._hf_metadata_native(
            nb_varblocks, m, lfquant, gg, blocks, dctsel_arr, hfmul_m1,
            coeffoff_arr, vb_dctsel, llfcoeffs, coeffs, log_gsize8,
        )
        if llf_blocks is not None:
            return llf_blocks

        voff = 0
        coeffoff = 0
        used_dct = used_order = 0  # merged under the lock below (int |= races)
        for y0 in range(ggh8):
            for x0 in range(ggw8):
                if blocks[y0, x0]:
                    continue
                check(voff < nb_varblocks, "vblk")
                dctsel = int(dctsel_arr[voff])
                check(0 <= dctsel < NUM_DCT_SELECT, "dct?")
                log_vh, log_vw, param_idx, order_idx = DCT_SELECT[dctsel]
                used_dct |= 1 << dctsel
                used_order |= 1 << order_idx
                coeffoff_arr[voff] = coeffoff
                vb_dctsel[voff] = dctsel
                vw8, vh8 = 1 << (log_vw - 3), 1 << (log_vh - 3)
                x1, y1 = x0 + vw8 - 1, y0 + vh8 - 1
                check(x1 < ggw8 and (x0 >> log_gsize8) == (x1 >> log_gsize8), "vblk")
                check(y1 < ggh8 and (y0 >> log_gsize8) == (y1 >> log_gsize8), "vblk")
                blocks[y0 : y0 + vh8, x0 : x0 + vw8] = (1 << 20) | voff
                blocks[y0, x0] = (dctsel + 2) << 20 | voff

                # LLF coefficients from dequantized LF (j40.h:6669-6683)
                if log_vw <= 3 and log_vh <= 3:
                    for c in range(3):
                        llfcoeffs[c][coeffoff >> 6] = lfquant[c][y0, x0]
                else:
                    for c in range(3):
                        lf_block = lfquant[c][y0 : y0 + vh8, x0 : x0 + vw8]
                        llfcoeffs[c][
                            (coeffoff >> 6) : (coeffoff >> 6) + vh8 * vw8
                        ] = forward_dct2d_scaled_for_llf(lf_block)
                coeffoff += 1 << (log_vw + log_vh)
                voff += 1
        check(voff == nb_varblocks, "vblk")
        with self._lock:
            self.dct_select_used |= used_dct
            self.order_used |= used_order
        self._finish_hf_metadata(
            nb_varblocks, m, gg, blocks, coeffoff_arr, vb_dctsel, hfmul_m1,
            llfcoeffs, coeffs,
        )
        return 0

    def _hf_metadata_native(self, nb_varblocks, m, lfquant, gg, blocks,
                            dctsel_arr, hfmul_m1, coeffoff_arr, vb_dctsel,
                            llfcoeffs, coeffs, log_gsize8) -> int | None:
        """Native greedy varblock placement + vectorized LLF fill.  The
        Python loop below is the oracle; this path removes a per-8px-cell
        GIL-bound cost that serializes the pool on mixed-class frames.
        port: returns the number of varblocks larger than DCT8 whose LLF
        `fill_large_llf` computed; None where the native core is off."""
        from ..modular.decode import _native_enabled

        if not _native_enabled():
            return None
        from ..native.bindings import place_varblocks

        ggw8, ggh8 = gg.width8, gg.height8
        blocks[:], coeffoff_arr[:], vb_x8, vb_y8, used_dct, used_order = (
            place_varblocks(
                dctsel_arr, ggw8, ggh8, log_gsize8, DCT_SELECT_BLOB
            )
        )
        vb_dctsel[:] = dctsel_arr
        with self._lock:
            self.dct_select_used |= used_dct
            self.order_used |= used_order

        # LLF coefficients from dequantized LF (j40.h:6669-6683): 8x8
        # varblocks copy their single LF sample (vectorized gather); larger
        # blocks forward-DCT their LF rect, one stack a shape (port)
        sel_logs = np.asarray(
            [[row[0], row[1]] for row in DCT_SELECT], dtype=np.int32
        )
        logs = sel_logs[dctsel_arr]
        small = (logs[:, 0] <= 3) & (logs[:, 1] <= 3)
        si = np.nonzero(small)[0]
        if len(si):
            dst = (coeffoff_arr[si] >> 6).astype(np.int64)
            ys, xs = vb_y8[si], vb_x8[si]
            for c in range(3):
                llfcoeffs[c][dst] = lfquant[c][ys, xs]
        big = np.nonzero(~small)[0]
        llf_blocks = fill_large_llf(lfquant, llfcoeffs, logs[big], vb_y8[big],
                                    vb_x8[big], coeffoff_arr[big])
        self._finish_hf_metadata(
            nb_varblocks, m, gg, blocks, coeffoff_arr, vb_dctsel, hfmul_m1,
            llfcoeffs, coeffs,
        )
        return llf_blocks

    def _finish_hf_metadata(self, nb_varblocks, m, gg, blocks, coeffoff_arr,
                            vb_dctsel, hfmul_m1, llfcoeffs, coeffs):
        # qfidx & hfmul (j40.h:6692-6700)
        qfidx = np.zeros(nb_varblocks, dtype=np.int32)
        for t in self.qf_thr:
            qfidx += (hfmul_m1 >= t).astype(np.int32)
        gg.nb_varblocks = nb_varblocks
        gg.blocks = blocks
        gg.vb_coeffoff = coeffoff_arr
        gg.vb_qfidx = qfidx
        gg.vb_hfmul_inv = (1.0 / (hfmul_m1.astype(np.float64) + 1.0)).astype(np.float32)
        gg.vb_dctsel = vb_dctsel
        gg.llfcoeffs = llfcoeffs
        gg.coeffs = coeffs

    def _prepare_dq_matrices(self) -> None:
        not_loaded = self.dct_select_used & ~self.dct_select_loaded
        if not not_loaded:
            return
        for i in range(NUM_DCT_SELECT):
            if not_loaded >> i & 1:
                param_idx = DCT_SELECT[i][2]
                if self.dq_weights[param_idx] is None:
                    self.dq_weights[param_idx] = load_dq_matrix(
                        param_idx, self.dq_matrix[param_idx]
                    )
                self.dct_select_loaded |= 1 << i
        # also mark

    def _prepare_orders(self) -> None:
        f = self.fs.f
        not_loaded = self.order_used & ~self.order_loaded
        if not not_loaded:
            return
        for i in range(NUM_ORDERS):
            if not_loaded >> i & 1:
                log_rows, log_columns = LOG_ORDER_SIZE[i]
                base = list(natural_order(log_rows, log_columns))
                skip = 1 << (log_rows + log_columns - 6)
                for p in range(f.num_passes):
                    for c in range(3):
                        lehmer = self.orders_lehmer[p][i][c]
                        perm = base[:skip] + apply_permutation(base[skip:], lehmer)
                        self.orders[p][i][c] = perm
                self.order_loaded |= 1 << i

    # -- pass group HF coefficients (j40.h:6888-7005) ----------------------

    def read_pass_group(self, r: BitReader, pass_: int, gidx: int) -> None:
        f = self.fs.f
        row, col = divmod(gidx, f.gcolumns)
        ggidx = (row // 8) * f.ggcolumns + (col // 8)
        gg = self.lf_groups[ggidx]
        gx_in_gg = (col % 8) << f.group_size_shift
        gy_in_gg = (row % 8) << f.group_size_shift
        gw = min(f.width - (col << f.group_size_shift), f.group_size)
        gh = min(f.height - (row << f.group_size_shift), f.group_size)

        # port: a section decoded on the host is a `vardct.hf_host` span,
        # which counts the varblocks whose corners lie in the group
        corners = np.asarray(gg.blocks)[gy_in_gg >> 3 : (gy_in_gg + gh + 7) >> 3,
                                        gx_in_gg >> 3 : (gx_in_gg + gw + 7) >> 3]
        with span(None, "vardct.hf_host", varblocks=int(((corners >> 20) >= 2).sum())):
            ctxoff = 495 * self.nb_block_ctx * r.u(ceil_lg(self.num_hf_presets))
            self._hf_coeffs(r, ctxoff, pass_, gx_in_gg, gy_in_gg, gw, gh, gg)

    def _hf_coeffs_native(self, r, ctxoff, pass_, gx_in_gg, gy_in_gg, gw, gh,
                          gg: LfGroup) -> bool:
        from ..modular.decode import _native_enabled

        if not _native_enabled():
            return False
        import ctypes

        from ..native.bindings import NativeStream, get_lib

        lib = get_lib()
        gw8, gh8 = ceil_div(gw, 8), ceil_div(gh, 8)
        r.ensure_all()
        data = bytes(r.data)
        ns = NativeStream(data, r.rel_bits, self.coeff_codespec[pass_])
        # per-LF-group context arrays: converted once, reused by all 64
        # member groups x passes (the conversions are pure rework per section)
        nat = gg.native_ctx
        if nat is None:
            nat = gg.native_ctx = (
                np.ascontiguousarray(gg.blocks, dtype=np.int32),
                np.ascontiguousarray(gg.vb_coeffoff, dtype=np.int64),
                np.ascontiguousarray(gg.vb_qfidx, dtype=np.int32),
                np.ascontiguousarray(gg.lfindices, dtype=np.uint8),
            )
        blocks, coeffoff, qfidx, lfind = nat
        bcm = self.block_ctx_map_u8
        if bcm is None:
            bcm = self.block_ctx_map_u8 = np.ascontiguousarray(
                self.block_ctx_map, dtype=np.uint8
            )
        dct_sel = DCT_SELECT_BLOB
        # per-pass order pointer table (lazily rebuilt if more orders load)
        cached = self._order_ptr_cache.get(pass_)
        loaded = self.order_loaded
        if cached is not None and cached[0] == loaded:
            order_arrs, order_ptrs = cached[1], cached[2]
        else:
            order_arrs = []
            order_ptrs = (ctypes.c_void_p * (13 * 3))()
            for oi in range(13):
                for c in range(3):
                    o = self.orders[pass_][oi][c]
                    if o is None:
                        order_ptrs[oi * 3 + c] = None
                    else:
                        arr = np.ascontiguousarray(o, dtype=np.int32)
                        order_arrs.append(arr)
                        order_ptrs[oi * 3 + c] = arr.ctypes.data
            self._order_ptr_cache[pass_] = (loaded, order_arrs, order_ptrs)
        coeff_ptrs = (ctypes.c_void_p * 3)()
        for c in range(3):
            assert gg.coeffs[c].dtype == np.float32 and gg.coeffs[c].flags.c_contiguous
            coeff_ptrs[c] = gg.coeffs[c].ctypes.data
        lfidx_size = (
            (self.nb_lf_thr[0] + 1) * (self.nb_lf_thr[1] + 1) * (self.nb_lf_thr[2] + 1)
        )
        rc = lib.j40t_decode_hf_group(
            ns.handle,
            ctxoff,
            blocks.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            gg.width8,
            gw8,
            gh8,
            coeffoff.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            qfidx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            lfind.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            gg.width8,
            gx_in_gg // 8,
            gy_in_gg // 8,
            bcm.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            self.nb_block_ctx,
            self.nb_qf_thr,
            lfidx_size,
            dct_sel.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            order_ptrs,
            coeff_ptrs,
        )
        check(rc == 0, "coef" if rc == 1 else "shrt", f"native hf rc={rc}")
        r.seek_rel_bits(ns.bitpos)
        code = CodeState(self.coeff_codespec[pass_])
        code.ans.state = ns.ans_state
        code.finish(r)
        return True

    def _hf_coeffs(self, r, ctxoff, pass_, gx_in_gg, gy_in_gg, gw, gh, gg: LfGroup):
        f = self.fs.f
        if self._hf_coeffs_native(r, ctxoff, pass_, gx_in_gg, gy_in_gg, gw, gh, gg):
            return
        gw8, gh8 = ceil_div(gw, 8), ceil_div(gh, 8)
        code = CodeState(self.coeff_codespec[pass_])
        lfidx_size = (
            (self.nb_lf_thr[0] + 1) * (self.nb_lf_thr[1] + 1) * (self.nb_lf_thr[2] + 1)
        )
        nonzeros = np.zeros((gh8 * gw8, 3), dtype=np.int32)

        for y8 in range(gh8):
            for x8 in range(gw8):
                ggx8, ggy8 = x8 + gx_in_gg // 8, y8 + gy_in_gg // 8
                nzpos = y8 * gw8 + x8
                voff = int(gg.blocks[ggy8, ggx8])
                dctsel = voff >> 20
                if dctsel < 2:
                    continue
                dctsel -= 2
                voff &= 0xFFFFF
                log_rows, log_columns, _, order_idx = DCT_SELECT[dctsel]
                log_size = log_rows + log_columns
                coeffoff = int(gg.vb_coeffoff[voff])
                qfidx_v = int(gg.vb_qfidx[voff])
                lfidx = int(gg.lfindices[ggy8, ggx8])
                bctx0 = (order_idx * (self.nb_qf_thr + 1) + qfidx_v) * lfidx_size + lfidx
                bctxc = 13 * (self.nb_qf_thr + 1) * lfidx_size

                for c_yxb in range(3):
                    c = YXB2XYB[c_yxb]
                    coeffs = gg.coeffs[c]
                    order = self.orders[pass_][order_idx][c]
                    bctx = self.block_ctx_map[bctx0 + bctxc * c_yxb]

                    if x8 > 0:
                        if y8 > 0:
                            nz = (nonzeros[nzpos - 1][c] + nonzeros[nzpos - gw8][c] + 1) >> 1
                        else:
                            nz = nonzeros[nzpos - 1][c]
                    else:
                        nz = nonzeros[nzpos - gw8][c] if y8 > 0 else 32
                    assert nz < 64
                    nzctx = ctxoff + bctx + (nz if nz < 8 else 4 + nz // 2) * self.nb_block_ctx
                    nz = code.code(r, nzctx)
                    check(nz <= (63 << (log_size - 6)), "coef")

                    qnz = ceil_div(nz, 1 << (log_size - 6))
                    for i in range(1 << (log_rows - 3)):
                        for j in range(1 << (log_columns - 3)):
                            nonzeros[nzpos + i * gw8 + j][c] = qnz
                    cctx = ctxoff + 458 * bctx + 37 * self.nb_block_ctx

                    prev = 1 if nz <= (1 << (log_size - 4)) else 0
                    i = 1 << (log_size - 6)
                    while nz > 0 and i < (1 << log_size):
                        ctx = (
                            cctx
                            + TWICE_COEFF_NNZ_CTX[ceil_div(nz, 1 << (log_size - 6))]
                            + TWICE_COEFF_FREQ_CTX[i >> (log_size - 6)]
                            + prev
                        )
                        ucoeff = code.code(r, ctx)
                        coeffs[coeffoff + order[i]] += np.float32(unpack_signed(ucoeff))
                        prev = 1 if ucoeff != 0 else 0
                        nz -= prev
                        i += 1
                    check(nz == 0, "coef")
        code.finish(r)

    # -- reconstruction (host oracle; j40.h:7053-7247) ---------------------

    def dequant_hf(self, gg: LfGroup) -> None:
        f = self.fs.f
        im = self.fs.im
        x_qm = QM_SCALE[f.x_qm_scale]
        b_qm = QM_SCALE[f.b_qm_scale]
        qbias = im.quant_bias
        qbias_num = im.quant_bias_num
        for voff in range(gg.nb_varblocks):
            dctsel = int(gg.vb_dctsel[voff])
            log_rows, log_columns, param_idx, _ = DCT_SELECT[dctsel]
            size = 1 << (log_rows + log_columns)
            mult1 = np.float32(65536.0 / self.global_scale * gg.vb_hfmul_inv[voff])
            mults = (
                np.float32(mult1 * x_qm),
                mult1,
                np.float32(mult1 * b_qm),
            )
            w = self.dq_weights[param_idx]
            off = int(gg.vb_coeffoff[voff])
            for c in range(3):
                q = gg.coeffs[c][off : off + size]
                small = (q >= -1.0) & (q <= 1.0)
                q_adj = np.where(small, q * np.float32(qbias[c]),
                                 q - np.float32(qbias_num) / np.where(q == 0, 1, q))
                gg.coeffs[c][off : off + size] = q_adj * (mults[c] / w[:size, c])

    def _native_output_planes(self) -> list:
        """Allocate (once, thread-safe) the host-plan output planes: an
        interleaved RGBA canvas when the frame has no extra channels and
        qualifies for the u8 fast path, else planar u8/int32."""
        with self._dispatch_lock:
            if self._native_dst is not None:
                return self._native_dst
            f, im = self.fs.f, self.fs.im
            if _use_u8_planes(im, f):
                if im.num_extra_channels == 0:
                    rgba = np.zeros((f.height, f.width, 4), dtype=np.uint8)
                    rgba[:, :, 3] = 255
                    self._native_rgba = rgba
                    self._native_dst = [rgba[:, :, c] for c in range(3)]
                else:
                    self._native_dst = [
                        np.zeros((f.height, f.width), dtype=np.uint8)
                        for _ in range(3)
                    ]
            else:
                self._native_dst = [
                    np.zeros((f.height, f.width), dtype=np.int32)
                    for _ in range(3)
                ]
            return self._native_dst

    def dispatch_pass_group_native(self, gidx: int) -> None:
        """Host-plan dual of dispatch_group_async at GROUP granularity:
        reconstruct one 256^2 group's varblocks on the calling
        section-worker thread the moment its last pass section finishes
        entropy decode (varblocks never cross group borders,
        j40.h:6636-6687, so the rect is self-contained) — reconstruction
        rides inside the sections stage even for single-LF-group frames."""
        f = self.fs.f
        grow, gcol = divmod(gidx, f.gcolumns)
        ggidx = (grow // 8) * f.ggcolumns + (gcol // 8)
        gg = self.lf_groups.get(ggidx)
        if gg is None:
            return
        key = (ggidx, grow % 8, gcol % 8)
        with self._dispatch_lock:
            if key in self._native_groups_done:
                return
            self._native_groups_done.add(key)
        from .native_combine import combine_lf_group_native

        dst = self._native_output_planes()
        gsize = f.group_size
        y0 = (grow % 8) * gsize
        x0 = (gcol % 8) * gsize
        rect = (y0, x0, min(gsize, gg.height - y0), min(gsize, gg.width - x0))
        combine_lf_group_native(
            self, gg, self.fs.im, dst, nthreads=1, rect=rect
        )

    def dispatch_group_async(self, ggidx: int) -> None:
        """Dispatch one LF group's device reconstruction as soon as its last
        section finishes entropy decode — called from the decode worker
        threads so host entropy of later LF groups overlaps device
        upload/compute of earlier ones (the j40.h:7749-7776 per-section
        independence turned into a host/device pipeline)."""
        with self._dispatch_lock:
            if ggidx in self._predispatched or ggidx not in self.lf_groups:
                return
            # port: the torch combine on the decoder's device; with the
            # whole-frame filters, the group's XYB plane (combine())
            from ..ops.combine import (
                combine_lf_group_torch_async, frame_filters, lf_group_xyb_async,
            )

            dispatch = (lf_group_xyb_async if frame_filters(self)
                        else combine_lf_group_torch_async)
            self._predispatched[ggidx] = dispatch(
                self, self.lf_groups[ggidx], self.fs.im, self.fs.device
            )

    def combine(self, gmodular) -> None:
        """Reconstruct all LF groups into gmodular int16 planes
        (j40.h:7862-7882 + 7099-7247). Numpy oracle version."""
        fs, f, im = self.fs, self.fs.f, self.fs.im
        check(not f.do_ycbcr and im.cspace.value != "grey", "TODO", "ycbcr/grey vardct")

        from ..modular.decode import Channel

        # prepend the three reconstructed color channels, KEEPING any decoded
        # extra channels (the reference drops them here, j40.h:7869-7874, so
        # VarDCT frames lose alpha in dj40; we preserve them)
        color = [Channel(f.width, f.height) for _ in range(3)]
        for c in color:
            c.data = np.zeros((f.height, f.width), dtype=np.int32)
        gmodular.channels = color + gmodular.channels
        gmodular.nb_meta_channels = 0

        backend = getattr(self.fs, "backend", "numpy")
        if backend in ("numpy", "native"):
            # host execution plan: multithreaded native reconstruct
            # (native/reconstruct.cpp) — the fastest path when the
            # host<->device link would dominate (see SCALING.md)
            from .native_combine import (
                combine_lf_group_native,
                native_combine_available,
                xyb_to_srgb_native,
            )

            if native_combine_available():
                # planes may be an interleaved RGBA canvas (render becomes a
                # no-op: the kernel's px_stride-4 stores replace a 4x-sized
                # post-hoc interleave copy); groups whose sections finished
                # early were already reconstructed on the section workers
                # (dispatch_group_native)
                apply_f = getattr(self.fs, "apply_filters", False)
                dst = self._native_output_planes()
                nthr = getattr(self.fs, "workers", 1)
                gsize = f.group_size
                for ggidx in sorted(self.lf_groups.keys()):
                    gg = self.lf_groups[ggidx]
                    if not apply_f and self._native_groups_done:
                        # group-granular pipelining ran: reconstruct only
                        # the groups whose sections finished last
                        for gy in range((gg.height + gsize - 1) // gsize):
                            for gx in range((gg.width + gsize - 1) // gsize):
                                if (ggidx, gy, gx) in self._native_groups_done:
                                    continue
                                y0, x0 = gy * gsize, gx * gsize
                                rect = (
                                    y0, x0,
                                    min(gsize, gg.height - y0),
                                    min(gsize, gg.width - x0),
                                )
                                combine_lf_group_native(
                                    self, gg, im, dst, nthr, rect=rect
                                )
                        continue
                    if apply_f:
                        # native samples -> native restoration filters ->
                        # native XYB (same per-LF-group mirrored-border
                        # filtering as the oracle path)
                        from .native_combine import (
                            epf_native,
                            gaborish_native,
                        )

                        samples = np.zeros(
                            (3, gg.height, gg.width), dtype=np.float32
                        )
                        combine_lf_group_native(
                            self, gg, im, list(samples), nthr,
                            samples_only=True,
                        )
                        if f.gab_enabled:
                            gaborish_native(samples, f.gab_weights, nthr)
                        epf_native(samples, self, gg, nthr)
                        xyb_to_srgb_native(
                            samples, self, im, f, dst, gg.top, gg.left, nthr,
                        )
                    else:
                        combine_lf_group_native(self, gg, im, dst, nthr)
                for c in range(3):
                    gmodular.channels[c].data = dst[c]
                return

        if backend in ("torch", "device"):  # port: the device backends
            # dispatch every LF group first: the runtime's async queue
            # pipelines uploads/compute/fetches across groups (matters for
            # >2048px images with several LF groups); groups whose sections
            # finished early were already dispatched from the decode threads
            # (dispatch_group_async), overlapping entropy with device work
            import torch

            from ..ops.combine import (
                combine_lf_group_torch_async, filter_frame, frame_filters,
                lf_group_xyb_async,
            )
            from ..profile import fetch

            whole = frame_filters(self)
            dispatch = lf_group_xyb_async if whole else combine_lf_group_torch_async
            done = {}
            for ggidx in sorted(self.lf_groups.keys()):
                res = self._predispatched.pop(ggidx, None)
                done[ggidx] = res if res is not None else dispatch(
                    self, self.lf_groups[ggidx], im, fs.device)
            if whole:
                # port: the restoration filters over the whole frame's plane
                # (ops/combine.filter_frame), not each LF group's apart, so
                # nothing mirrors at an LF-group border (ROADMAP C.3); the
                # frame is then one plane at (0, 0)
                from types import SimpleNamespace

                pending = [(SimpleNamespace(top=0, left=0, height=f.height, width=f.width),
                            (filter_frame(self, done), f.height, f.width))]
            else:
                pending = [(self.lf_groups[g], res) for g, res in done.items()]
            # the device path emits pre-clipped uint8 for 8bpp streams; keep
            # that dtype end to end (a 12MP int32 round-trip costs ~0.5s of
            # pure memcpy on this host) unless blending needs wider math
            if (
                pending
                and pending[0][1][0].dtype == torch.uint8  # port: torch dtype
                and _use_u8_planes(im, f)
            ):
                for c in range(3):
                    gmodular.channels[c].data = np.zeros(
                        (f.height, f.width), dtype=np.uint8
                    )
            if getattr(self.fs, "keep_device_output", False):
                # retain the on-device u8 planes for render_rgba8_device();
                # the loop below still fetches each for the host canvas
                self.device_planes = [
                    (gg.top, gg.left, gg.height, gg.width, dev, ggh, ggw)
                    for gg, (dev, ggh, ggw) in pending
                ]
            for gg, (dev, ggh, ggw) in pending:
                arr = fetch(dev[:, :ggh, :ggw]).numpy()  # port: the fetch
                dst_dtype = gmodular.channels[0].data.dtype
                if arr.dtype == np.uint8 and dst_dtype != np.uint8:
                    arr = arr.astype(dst_dtype)
                elif arr.dtype != np.uint8:
                    arr = np.clip(
                        arr.astype(np.int32),
                        np.iinfo(np.int16).min, np.iinfo(np.int16).max,
                    )
                for c in range(3):
                    gmodular.channels[c].data[
                        gg.top : gg.top + gg.height, gg.left : gg.left + gg.width
                    ] = arr[c]
            return
        for ggidx in sorted(self.lf_groups.keys()):
            gg = self.lf_groups[ggidx]
            self.dequant_hf(gg)
            self._combine_lf_group(gg, gmodular)

    def _combine_lf_group(self, gg: LfGroup, gmodular) -> None:
        f, im = self.fs.f, self.fs.im
        ggw, ggh = gg.width, gg.height
        ggw8, ggh8 = gg.width8, gg.height8
        samples = [np.zeros((ggh, ggw), dtype=np.float32) for _ in range(3)]

        kx_lf = np.float32(self.base_corr_x + self.x_factor_lf * self.inv_colour_factor)
        kb_lf = np.float32(self.base_corr_b + self.b_factor_lf * self.inv_colour_factor)

        for y8 in range(ggh8):
            for x8 in range(ggw8):
                voff = int(gg.blocks[y8, x8])
                dctsel = voff >> 20
                if dctsel < 2:
                    continue
                dctsel -= 2
                voff &= 0xFFFFF
                log_rows, log_columns, _, _ = DCT_SELECT[dctsel]
                size = 1 << (log_rows + log_columns)
                coeffoff = int(gg.vb_coeffoff[voff])
                kx_hf = np.float32(
                    self.base_corr_x
                    + self.inv_colour_factor * float(gg.xfromy[y8 // 8, x8 // 8])
                )
                kb_hf = np.float32(
                    self.base_corr_b
                    + self.inv_colour_factor * float(gg.bfromy[y8 // 8, x8 // 8])
                )
                effvh = min(ggh - y8 * 8, 1 << log_rows)
                effvw = min(ggw - x8 * 8, 1 << log_columns)
                vh8 = 1 << (min(log_rows, log_columns) - 3)
                vw8 = 1 << (max(log_rows, log_columns) - 3)

                for c in range(3):
                    cf = gg.coeffs[c][coeffoff : coeffoff + size].copy()
                    if c == 0:
                        cf = cf + gg.coeffs[1][coeffoff : coeffoff + size] * kx_hf
                    elif c == 2:
                        cf = cf + gg.coeffs[1][coeffoff : coeffoff + size] * kb_hf
                    llf = gg.llfcoeffs[c][(coeffoff >> 6) : (coeffoff >> 6) + vh8 * vw8]
                    if c == 0:
                        llf = llf + gg.llfcoeffs[1][(coeffoff >> 6) : (coeffoff >> 6) + vh8 * vw8] * kx_lf
                    elif c == 2:
                        llf = llf + gg.llfcoeffs[1][(coeffoff >> 6) : (coeffoff >> 6) + vh8 * vw8] * kb_lf
                    # overwrite LLF positions (canonical layout rows of width vw8*8)
                    for y in range(vh8):
                        cf[y * vw8 * 8 : y * vw8 * 8 + vw8] = llf[y * vw8 : (y + 1) * vw8]

                    if dctsel == 1:
                        out = inverse_hornuss(cf)
                    elif dctsel == 2:
                        out = inverse_dct11(cf)
                    elif dctsel == 3:
                        out = inverse_dct22(cf)
                    elif dctsel == 12:
                        out = inverse_dct23(cf)
                    elif dctsel == 13:
                        out = inverse_dct32(cf)
                    elif dctsel in (14, 15, 16, 17):
                        flip = ((0, 0), (1, 0), (0, 1), (1, 1))[dctsel - 14]
                        out = inverse_afv(cf, flip[0], flip[1])
                    else:
                        out = inverse_dct2d(cf, log_rows, log_columns)
                    samples[c][y8 * 8 : y8 * 8 + effvh, x8 * 8 : x8 * 8 + effvw] = out[
                        :effvh, :effvw
                    ]

        # restoration filters (implemented per j40.h:7251-7624, which the
        # reference never invokes; opt-in via Decoder(apply_filters=True))
        if getattr(self.fs, "apply_filters", False):
            from ..ops.filters import epf, gaborish

            arr = np.stack(samples)
            if f.gab_enabled:
                arr = gaborish(arr, f.gab_weights)
            arr = epf(arr, self, gg, is_modular=False)
            samples = [arr[0], arr[1], arr[2]]

        # XYB -> linear sRGB -> sRGB' -> int planes (j40.h:7208-7241)
        cbrt_bias = np.cbrt(np.array(im.opsin_bias, dtype=np.float32))
        itscale = np.float32(255.0 / im.intensity_target)
        X, Y, B = samples
        p = [Y + X, Y - X, B]
        mixed = []
        for c in range(3):
            pp = p[c] - cbrt_bias[c]
            mixed.append((pp * pp * pp + np.float32(im.opsin_bias[c])) * itscale)
        inv = np.array(im.opsin_inv_mat, dtype=np.float32)
        maxval = np.float32((1 << im.bpp) - 1)
        for c in range(3):
            v = mixed[0] * inv[c][0] + mixed[1] * inv[c][1] + mixed[2] * inv[c][2]
            v = np.where(
                v <= 0.0031308,
                np.float32(12.92) * v,
                np.float32(1.055) * np.power(np.maximum(v, 1e-30), np.float32(1 / 2.4))
                - np.float32(0.055),
            )
            out = (maxval * v + np.float32(0.5)).astype(np.int32)
            gmodular.channels[c].data[
                gg.top : gg.top + ggh, gg.left : gg.left + ggw
            ] = np.clip(out, np.iinfo(np.int16).min, np.iinfo(np.int16).max)
