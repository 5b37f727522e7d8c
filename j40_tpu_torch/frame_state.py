"""Per-frame decode state and section decoding.

Modular path: LfGlobal global channels → ModularLfGroup (squeeze LF channels,
which the reference rejects at j40.h:6735 but we support per spec §8.4) →
pass-group channels → inverse transforms.
VarDCT path: see j40_tpu.vardct.

Stream indices (sidx) follow libjxl's ModularStreamId so MA-tree property 1
matches: 0 global, 1+gg LF, 1+G+gg modular-LF, 1+2G+gg HF meta, 1+3G+i quant
tables, 1+3G+17+pass*num_groups+g pass groups.
"""

from __future__ import annotations

from .errors import Unsupported, check
from .headers.frame import FrameHeader
from .headers.image import CSpace, ImageMetadata
from .io.bits import BitReader
from .limits import Limits
from .mathutil import ceil_div
from .modular.decode import (
    Channel,
    ModularImage,
    allocate,
    decode_channel,
    parse_modular_header,
)
from .modular.transforms import inverse_transforms
from .modular.tree import read_tree

NUM_DCT_PARAMS = 17  # kNumQuantTables


class FrameState:
    def __init__(self, im: ImageMetadata, f: FrameHeader, limits: Limits):
        self.im = im
        self.f = f
        self.limits = limits
        self.global_tree = None
        self.global_codespec = None
        self.gmodular: ModularImage | None = None
        self.num_gm_channels = 0
        self.vardct = None  # set for VarDCT frames by lf_global

    # -- LfGlobal ----------------------------------------------------------

    def lf_global(self, r: BitReader) -> None:
        im, f = self.im, self.f
        if f.has_patches:
            raise Unsupported(message="patches")
        if f.has_splines:
            raise Unsupported(message="splines")
        if f.has_noise:
            raise Unsupported(message="noise")

        if not r.u(1):  # LfChannelDequantization not all_default
            f.m_lf_scaled = [r.f16() / 128.0 for _ in range(3)]

        if not f.is_modular:
            from .vardct.state import VarDCTState

            self.vardct = VarDCTState(self)
            self.vardct.read_lf_global(r)

        # gmodular channel list (j40.h:3619-3654)
        num_channels = im.num_extra_channels
        ncolor = 0
        if f.is_modular:
            ncolor = (
                1
                if (not f.do_ycbcr and not im.xyb_encoded and im.cspace is CSpace.GREY)
                else 3
            )
            num_channels += ncolor
        channels = []
        for i in range(num_channels):
            hs = vs = 0
            if i < ncolor and f.do_ycbcr and f.jpeg_upsampling:
                # chroma subsampling (the reference rejects this at
                # j40.h:6749): per-channel 2-bit code, (Cb, Y, Cr) order
                code = (f.jpeg_upsampling >> (2 * i)) & 3
                hs = 1 if code in (1, 2) else 0
                vs = 1 if code in (1, 3) else 0
            elif i >= ncolor and f.ec_log_upsampling:
                # EC upsampling beyond the frame factor codes the channel
                # at the correspondingly reduced resolution (spec §5.2)
                hs = vs = f.ec_log_upsampling[i - ncolor] - f.log_upsampling
            channels.append(
                Channel(ceil_div(f.width, 1 << hs), ceil_div(f.height, 1 << vs),
                        hs, vs)
            )
        self.gmodular = ModularImage(
            channels=channels, wide=not im.modular_16bit_buffers
        )

        if r.u(1):  # global tree present
            max_tree_size = min(
                1 << 22, 1024 + f.width * f.height * max(num_channels, 1) // 16
            )
            self.global_tree, self.global_codespec = read_tree(r, max_tree_size, self.limits)

        if num_channels > 0:
            parse_modular_header(
                r, self.gmodular, self.global_tree, self.global_codespec, self.limits
            )
            allocate(self.gmodular)
            if f.width <= f.group_size and f.height <= f.group_size:
                self.num_gm_channels = self.gmodular.num_channels
            else:
                self.num_gm_channels = self.gmodular.nb_meta_channels
            for i in range(self.num_gm_channels):
                decode_channel(r, self.gmodular, i, 0)
            self.gmodular.code.finish(r)
        else:
            self.num_gm_channels = 0

    # -- HfGlobal ----------------------------------------------------------

    def hf_global(self, r: BitReader) -> None:
        assert self.vardct is not None
        self.vardct.read_hf_global(r)

    # -- LF group sections -------------------------------------------------

    def lf_group(self, r: BitReader, ggidx: int) -> None:
        f = self.f
        if self.vardct is not None:
            self.vardct.read_lf_group(r, ggidx)
        # ModularLfGroup: channels with hshift>=3 and vshift>=3 (spec §8.4)
        self._modular_group(
            r,
            sidx=1 + f.num_lf_groups + ggidx,
            region=self._lf_group_region(ggidx),
            minshift=3,
            maxshift=10000,
        )

    # -- pass group sections -----------------------------------------------

    def pass_group(self, r: BitReader, pass_: int, gidx: int) -> None:
        f = self.f
        if self.vardct is not None:
            self.vardct.read_pass_group(r, pass_, gidx)
        self._modular_group(
            r,
            sidx=1 + 3 * f.num_lf_groups + NUM_DCT_PARAMS + pass_ * f.num_groups + gidx,
            region=self._group_region(gidx),
            minshift=0,
            maxshift=3,
        )

    # -- shared modular group machinery ------------------------------------

    def _group_region(self, gidx: int) -> tuple[int, int, int, int]:
        f = self.f
        row, col = divmod(gidx, f.gcolumns)
        x0 = col << f.group_size_shift
        y0 = row << f.group_size_shift
        return (x0, y0, min(f.width - x0, f.group_size), min(f.height - y0, f.group_size))

    def _lf_group_region(self, ggidx: int) -> tuple[int, int, int, int]:
        f = self.f
        ggsize = 8 << f.group_size_shift
        row, col = divmod(ggidx, f.ggcolumns)
        x0 = col * ggsize
        y0 = row * ggsize
        return (x0, y0, min(f.width - x0, ggsize), min(f.height - y0, ggsize))

    def modular_picks(
        self, region: tuple[int, int, int, int], minshift: int, maxshift: int
    ) -> list[tuple[int, int, int, int, int]]:
        """Channels of `region`'s modular sub-stream as (gm channel index,
        x0, y0, w, h) sub-rects (j40.h:3656-3715 channel split).

        NOTE: the reference sizes shifted sub-channels with a FLOOR shift
        (`gw >> hshift`, flagged "should be ceil?" at j40.h:3676); we use
        ceil per spec/libjxl.  The difference is unobservable in the
        reference since every shifted-channel feature it would apply to
        (squeeze, chroma subsampling) is rejected before reaching here."""
        gm = self.gmodular
        gx, gy, gw, gh = region
        picks = []  # (gm channel index, sub-rect)
        for i in range(self.num_gm_channels, gm.num_channels):
            gc = gm.channels[i]
            m = min(gc.hshift, gc.vshift)
            if not (minshift <= m < maxshift):
                continue
            x0 = gx >> gc.hshift
            y0 = gy >> gc.vshift
            w = min(ceil_div(gw, 1 << gc.hshift), gc.width - x0)
            h = min(ceil_div(gh, 1 << gc.vshift), gc.height - y0)
            if w <= 0 or h <= 0:
                continue
            picks.append((i, x0, y0, w, h))
        return picks

    def _modular_group(
        self,
        r: BitReader,
        sidx: int,
        region: tuple[int, int, int, int],
        minshift: int,
        maxshift: int,
    ) -> None:
        """Decode the modular sub-stream covering `region` (j40.h:3656-3715)."""
        gm = self.gmodular
        picks = self.modular_picks(region, minshift, maxshift)
        if not picks:
            return
        sub = ModularImage(
            channels=[
                Channel(w, h, gm.channels[i].hshift, gm.channels[i].vshift)
                for (i, _, _, w, h) in picks
            ],
            wide=gm.wide,
        )
        parse_modular_header(r, sub, self.global_tree, self.global_codespec, self.limits)
        direct = not sub.transforms
        if direct:
            # no group-local transforms: decode straight into the gmodular
            # plane sub-rectangles (strided views; saves the copy-back)
            for (i, x0, y0, w, h), sc in zip(picks, sub.channels):
                sc.data = gm.channels[i].data[y0 : y0 + h, x0 : x0 + w]
        allocate(sub)
        for ci in range(sub.num_channels):
            decode_channel(r, sub, ci, sidx)
        sub.code.finish(r)
        if not direct:
            inverse_transforms(sub, self.im.bpp)
            check(sub.num_channels == len(picks), "gmod",
                  "group transforms changed channel count")
            for (i, x0, y0, w, h), sc in zip(picks, sub.channels):
                gm.channels[i].data[y0 : y0 + h, x0 : x0 + w] = sc.data

    # -- finalize ----------------------------------------------------------

    def finish(self) -> None:
        if self.gmodular is not None and self.gmodular.num_channels > 0:
            inverse_transforms(self.gmodular, self.im.bpp)
        if self.vardct is not None:
            self.vardct.combine(self.gmodular)
