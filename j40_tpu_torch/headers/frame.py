"""Frame header and TOC (reference j40.h:5039-5655, spec §9, §9.4).

The TOC produces the decode plan: per-section byte ranges with dependency
ordering (pass-group sections relocated after the LF group they depend on).
This plan is exactly what the sharded pipeline scatters across devices.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..errors import Unsupported, check
from ..io.bits import BitReader, ceil_lg
from ..limits import MAIN_LV5, Limits
from ..mathutil import ceil_div, unpack_signed
from ..entropy.code import CodeState, read_code_spec
from .image import ImageMetadata

MAX_PASSES = 11

FRAME_REGULAR = 0
FRAME_LF = 1
FRAME_REFONLY = 2
FRAME_REGULAR_SKIPPROG = 3

BLEND_REPLACE = 0
BLEND_ADD = 1
BLEND_BLEND = 2
BLEND_MUL_ADD = 3
BLEND_MUL = 4


@dataclass
class BlendInfo:
    mode: int = BLEND_REPLACE
    alpha_chan: int = 0
    clamp: int = 0
    src_ref_frame: int = 0


@dataclass
class FrameHeader:
    is_last: bool = True
    type: int = FRAME_REGULAR
    is_modular: bool = False
    has_noise: bool = False
    has_patches: bool = False
    has_splines: bool = False
    use_lf_frame: bool = False
    skip_adapt_lf_smooth: bool = False
    do_ycbcr: bool = False
    jpeg_upsampling: int = 0
    log_upsampling: int = 0
    ec_log_upsampling: list[int] = field(default_factory=list)
    group_size_shift: int = 8
    x_qm_scale: int = 3
    b_qm_scale: int = 2
    num_passes: int = 1
    shift: list[int] = field(default_factory=lambda: [0])
    log_ds: list[int] = field(default_factory=lambda: [3, 0])
    lf_level: int = 0
    x0: int = 0
    y0: int = 0
    width: int = 0
    height: int = 0
    duration: int = 0
    timecode: int = 0
    # display-resolution frame size (== width/height unless log_upsampling)
    disp_width: int = 0
    disp_height: int = 0
    blend_info: BlendInfo = field(default_factory=BlendInfo)
    ec_blend_info: list[BlendInfo] = field(default_factory=list)
    save_as_ref: int = 0
    save_before_ct: bool = True
    name: str = ""
    gab_enabled: bool = True
    gab_weights: list = field(
        default_factory=lambda: [[0.115169525, 0.061248592] for _ in range(3)]
    )
    epf_iters: int = 2
    epf_sharp_lut: list = field(default_factory=lambda: [i / 7.0 for i in range(8)])
    epf_channel_scale: list = field(default_factory=lambda: [40.0, 5.0, 3.5])
    epf_quant_mul: float = 0.46
    epf_pass0_sigma_scale: float = 0.9
    epf_pass2_sigma_scale: float = 6.5
    epf_border_sad_mul: float = 2.0 / 3.0
    epf_sigma_for_modular: float = 1.0
    m_lf_scaled: list = field(
        default_factory=lambda: [1.0 / 4096.0, 1.0 / 512.0, 1.0 / 256.0]
    )
    # group grid, computed at the end of parsing
    grows: int = 0
    gcolumns: int = 0
    ggrows: int = 0
    ggcolumns: int = 0
    num_groups: int = 0
    num_lf_groups: int = 0

    @property
    def group_size(self) -> int:
        return 1 << self.group_size_shift


def read_frame_header(
    r: BitReader, im: ImageMetadata, limits: Limits = MAIN_LV5
) -> FrameHeader:
    f = FrameHeader(width=im.width, height=im.height)
    r.zero_pad_to_byte()

    if not r.u(1):  # not all_default
        full_frame = True
        f.type = r.u(2)
        f.is_modular = bool(r.u(1))
        flags = r.u64()
        f.has_noise = bool(flags & 1)
        f.has_patches = bool(flags >> 1 & 1)
        f.has_splines = bool(flags >> 4 & 1)
        f.use_lf_frame = bool(flags >> 5 & 1)
        f.skip_adapt_lf_smooth = bool(flags >> 7 & 1)
        if not im.xyb_encoded:
            f.do_ycbcr = bool(r.u(1))
        if not f.use_lf_frame:
            if f.do_ycbcr:
                f.jpeg_upsampling = r.u(6)
            # upsampling (the reference rejects any non-zero value at
            # j40.h:5245-5250; we implement the spec upsampler, see
            # ops/upsample.py).  Per-EC factors may exceed the frame factor:
            # the surplus becomes the channel's hshift/vshift (the EC is
            # coded at ceil(disp/ec_k)); factors below the frame factor are
            # not representable (libjxl rejects them too), and a surplus
            # shift of 3 would route the channel to ModularLfGroup sections
            # (a TODO in the reference at j40.h:6735 and here).
            f.log_upsampling = r.u(2)
            f.ec_log_upsampling = []
            for _ in range(im.num_extra_channels):
                v = r.u(2)
                if v < f.log_upsampling:
                    raise Unsupported(
                        message="per-EC upsampling below the frame factor")
                if v - f.log_upsampling > 2:
                    raise Unsupported(
                        message="per-EC upsampling shift > 2 (LfGroup-coded "
                                "modular channels)")
                f.ec_log_upsampling.append(v)
        if f.is_modular:
            f.group_size_shift = 7 + r.u(2)
        elif im.xyb_encoded:
            f.x_qm_scale = r.u(3)
            f.b_qm_scale = r.u(3)
        if f.type != FRAME_REFONLY:
            f.num_passes = r.u32(1, 0, 2, 0, 3, 0, 4, 3)
            if f.num_passes > 1:
                # downsample schedule (j40.h:5259-5281)
                f.shift = [0] * f.num_passes
                f.log_ds = [3] + [0] * f.num_passes
                num_ds = r.u32(0, 0, 1, 0, 2, 0, 3, 1)
                check(num_ds < f.num_passes, "pass")
                for i in range(f.num_passes - 1):
                    f.shift[i] = r.u(2)
                f.shift[f.num_passes - 1] = 0
                log_ds = []
                for i in range(num_ds):
                    log_ds.append(r.u(2))
                    if i > 0:
                        check(log_ds[i - 1] >= log_ds[i], "pass")
                ppass = 0
                for i in range(num_ds):
                    p = r.u32(0, 0, 1, 0, 2, 0, 0, 3)
                    check((ppass < p < f.num_passes) if i > 0 else p == 0, "pass")
                    while ppass < p:
                        ppass += 1
                        f.log_ds[ppass] = log_ds[i - 1] if i > 0 else 3
                while ppass < f.num_passes:
                    ppass += 1
                    f.log_ds[ppass] = log_ds[num_ds - 1] if num_ds > 0 else 3
        if f.type == FRAME_LF:
            f.lf_level = r.u(2) + 1
        elif r.u(1):  # have_crop
            if f.type != FRAME_REFONLY:
                f.x0 = unpack_signed(r.u32(0, 8, 256, 11, 2304, 14, 18688, 30))
                f.y0 = unpack_signed(r.u32(0, 8, 256, 11, 2304, 14, 18688, 30))
            f.width = r.u32(0, 8, 256, 11, 2304, 14, 18688, 30)
            f.height = r.u32(0, 8, 256, 11, 2304, 14, 18688, 30)
            check(f.width <= limits.width and f.height <= limits.height, "slim")
            check(f.width * f.height <= limits.pixels, "slim")
            full_frame = (
                f.x0 <= 0
                and f.y0 <= 0
                and f.width + f.x0 >= im.width
                and f.height + f.y0 >= im.height
            )
        if f.type in (FRAME_REGULAR, FRAME_REGULAR_SKIPPROG):
            blends = [f.blend_info] + [BlendInfo() for _ in range(im.num_extra_channels)]
            f.ec_blend_info = blends[1:]
            for blend in blends:
                blend.mode = r.u32(0, 0, 1, 0, 2, 0, 3, 2)
                if im.num_extra_channels > 0:
                    if blend.mode in (BLEND_BLEND, BLEND_MUL_ADD):
                        blend.alpha_chan = r.u32(0, 0, 1, 0, 2, 0, 3, 3)
                        blend.clamp = r.u(1)
                    elif blend.mode == BLEND_MUL:
                        blend.clamp = r.u(1)
                if not full_frame or blend.mode != BLEND_REPLACE:
                    blend.src_ref_frame = r.u(2)
            if im.anim_tps_denom:
                f.duration = r.u32(0, 0, 1, 0, 0, 8, 0, 32)
                if im.anim_have_timecodes:
                    f.timecode = r.u(32)
            f.is_last = bool(r.u(1))
        else:
            f.is_last = False
        if f.type != FRAME_LF and not f.is_last:
            f.save_as_ref = r.u(2)
        if f.type == FRAME_REFONLY or (
            full_frame
            and f.type in (FRAME_REGULAR, FRAME_REGULAR_SKIPPROG)
            and f.blend_info.mode == BLEND_REPLACE
            and (f.duration == 0 or f.save_as_ref != 0)
            and not f.is_last
        ):
            f.save_before_ct = bool(r.u(1))
        else:
            f.save_before_ct = f.type == FRAME_LF
        # frame name
        from .image import read_name

        f.name = read_name(r)
        # RestorationFilter — NOTE: mirrors the reference bug-for-bug
        # (j40.h:5338-5366): the gab_custom/epf bits are read even when
        # restoration_all_default is set, since dj40 is our differential oracle
        restoration_all_default = bool(r.u(1))
        f.gab_enabled = True if restoration_all_default else bool(r.u(1))
        if f.gab_enabled:
            if r.u(1):  # gab_custom
                f.gab_weights = [[r.f16(), r.f16()] for _ in range(3)]
        f.epf_iters = 2 if restoration_all_default else r.u(2)
        if f.epf_iters:
            if not f.is_modular and r.u(1):  # epf_sharp_custom
                f.epf_sharp_lut = [r.f16() for _ in range(8)]
            if r.u(1):  # epf_weight_custom
                f.epf_channel_scale = [r.f16() for _ in range(3)]
                r.skip(32)
            if r.u(1):  # epf_sigma_custom
                if not f.is_modular:
                    f.epf_quant_mul = r.f16()
                f.epf_pass0_sigma_scale = r.f16()
                f.epf_pass2_sigma_scale = r.f16()
                f.epf_border_sad_mul = r.f16()
            if f.is_modular:
                f.epf_sigma_for_modular = r.f16()
        if not restoration_all_default:
            from .image import read_extensions

            read_extensions(r)
        from .image import read_extensions

        read_extensions(r)

    if im.xyb_encoded and im.want_icc:
        f.save_before_ct = True
    # with upsampling the frame is coded at 1/k resolution: group math and
    # all section decoding use the reduced size; disp_* keep the display
    # size for the upsample->blend->render stages (spec §5.2)
    f.disp_width, f.disp_height = f.width, f.height
    if f.log_upsampling:
        k = 1 << f.log_upsampling
        f.width = ceil_div(f.width, k)
        f.height = ceil_div(f.height, k)
    f.grows = ceil_div(f.height, f.group_size)
    f.gcolumns = ceil_div(f.width, f.group_size)
    f.num_groups = f.grows * f.gcolumns
    f.ggrows = ceil_div(f.height, 8 * f.group_size)
    f.ggcolumns = ceil_div(f.width, 8 * f.group_size)
    f.num_lf_groups = f.ggrows * f.ggcolumns
    return f


# -- TOC --------------------------------------------------------------------


@dataclass
class Section:
    idx: int  # LF group index (pass < 0) or group index
    codeoff: int
    size: int
    pass_: int  # negative = LF group section


@dataclass
class Toc:
    single_size: int = 0
    lf_global_codeoff: int = 0
    lf_global_size: int = 0
    hf_global_codeoff: int = 0
    hf_global_size: int = 0
    sections: list[Section] = field(default_factory=list)
    end_codeoff: int = 0


def read_permutation(r: BitReader, code: CodeState, size: int, skip: int) -> list[int] | None:
    """Lehmer-coded permutation (j40.h:5428-5457)."""
    end = code.code(r, min(7, ceil_lg(size + 1)))
    check(end <= size - skip, "perm")
    if end == 0:
        return None
    arr = []
    prev = 0
    for i in range(end):
        prev = code.code(r, min(7, ceil_lg(prev + 1)))
        check(prev < size - (skip + i), "perm")
        arr.append(prev)
    return arr


def apply_permutation(target: list, lehmer: list[int] | None) -> list:
    """Apply a Lehmer permutation in place semantics (j40.h:5460-5472)."""
    if not lehmer:
        return target
    out = list(target)
    pos = 0
    for x in lehmer:
        v = out[pos + x]
        del out[pos + x]
        out.insert(pos, v)
        pos += 1
    return out


def read_toc(r: BitReader, f: FrameHeader) -> Toc:
    toc = Toc()
    nsections = (
        1
        if (f.num_passes == 1 and f.num_groups == 1)
        else 1 + f.num_lf_groups + 1 + f.num_passes * f.num_groups
    )

    lehmer = None
    if r.u(1):  # permuted
        spec = read_code_spec(r, 8)
        code = CodeState(spec)
        lehmer = read_permutation(r, code, nsections, 0)
        code.finish(r)
    r.zero_pad_to_byte()

    if nsections == 1:
        toc.single_size = r.u32(0, 10, 1024, 14, 17408, 22, 4211712, 30)
        r.zero_pad_to_byte()
        base = r.bits_consumed // 8  # codestream offset of the section start
        toc.end_codeoff = base + toc.single_size
        return toc

    sizes = [r.u32(0, 10, 1024, 14, 17408, 22, 4211712, 30) for _ in range(nsections)]
    r.zero_pad_to_byte()

    base = r.bits_consumed // 8
    sections: list[Section] = []
    codeoff = base
    for i in range(nsections):
        sections.append(Section(idx=0, codeoff=codeoff, size=sizes[i], pass_=0))
        codeoff += sizes[i]
    toc.end_codeoff = codeoff

    sections = apply_permutation(sections, lehmer)

    toc.lf_global_codeoff = sections[0].codeoff
    toc.lf_global_size = sections[0].size
    sections[0].codeoff = -1
    for i in range(f.num_lf_groups):
        sections[i + 1].pass_ = -1
        sections[i + 1].idx = i
    toc.hf_global_codeoff = sections[f.num_lf_groups + 1].codeoff
    toc.hf_global_size = sections[f.num_lf_groups + 1].size
    sections[f.num_lf_groups + 1].codeoff = -1
    for p in range(f.num_passes):
        sbase = 1 + f.num_lf_groups + 1 + p * f.num_groups
        for i in range(f.num_groups):
            sections[sbase + i].pass_ = p
            sections[sbase + i].idx = i

    # dependency reordering: pass-group sections whose codeoff precedes their
    # LF group section get relocated right after it (j40.h:5563-5626)
    relocated: dict[int, list[Section]] = {}
    for ggrow in range(f.ggrows):
        for ggcol in range(f.ggcolumns):
            ggidx = ggrow * f.ggcolumns + ggcol
            ggcodeoff = sections[1 + ggidx].codeoff
            gbase = 1 + f.num_lf_groups + 1
            grows_in_gg = min((ggrow + 1) * 8, f.grows) - ggrow * 8
            gcols_in_gg = min((ggcol + 1) * 8, f.gcolumns) - ggcol * 8
            for p in range(f.num_passes):
                for gr in range(grows_in_gg):
                    for gc in range(gcols_in_gg):
                        gidx = (ggrow * 8 + gr) * f.gcolumns + (ggcol * 8 + gc)
                        s = sections[gbase + p * f.num_groups + gidx]
                        if s.codeoff > ggcodeoff:
                            continue
                        relocated.setdefault(ggidx, []).append(
                            Section(s.idx, s.codeoff, s.size, s.pass_)
                        )
                        s.codeoff = -1

    remaining = sorted(
        (s for s in sections if s.codeoff >= 0), key=lambda s: s.codeoff
    )
    out: list[Section] = []
    for s in remaining:
        out.append(s)
        if s.pass_ < 0 and s.idx in relocated:
            out.extend(sorted(relocated[s.idx], key=lambda t: t.codeoff))
    toc.sections = out
    assert len(out) == nsections - 2
    return toc
