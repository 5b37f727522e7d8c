"""Image header & metadata parsing (reference: j40.h:2919-3327, spec §6-§10).

All defaults (sRGB chromaticities, opsin inverse matrix, quant biases) match
the reference byte-for-byte so downstream float math agrees with dj40.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

from ..errors import Unsupported, check
from ..io.bits import BitReader
from ..limits import MAIN_LV5, Limits
from ..mathutil import unpack_signed


class ECType(enum.IntEnum):
    ALPHA = 0
    DEPTH = 1
    SPOT_COLOUR = 2
    SELECTION_MASK = 3
    BLACK = 4
    CFA = 5
    THERMAL = 6
    NON_OPTIONAL = 15
    OPTIONAL = 16


class Orientation(enum.IntEnum):
    TL = 1
    TR = 2
    BR = 3
    BL = 4
    LT = 5
    RT = 6
    RB = 7
    LB = 8


class CSpace(enum.Enum):
    CHROMA = "chroma"
    GREY = "grey"
    XYB = "xyb"


# transfer function constants; gamma_or_tf > 0 means gamma value scaled by 1e7
TF_709 = -1
TF_UNKNOWN = -2
TF_LINEAR = -8
TF_SRGB = -13
TF_PQ = -16
TF_DCI = -17
TF_HLG = -18
GAMMA_MAX = 10000000

SRGB_CHROMA = (
    (0.3127, 0.3290),  # white (D65)
    (0.639998686, 0.330010138),  # red
    (0.300003784, 0.600003357),  # green
    (0.150002046, 0.059997204),  # blue
)

OPSIN_INV_MAT = (
    (11.031566901960783, -9.866943921568629, -0.16462299647058826),
    (-3.254147380392157, 4.418770392156863, -0.16462299647058826),
    (-3.6588512862745097, 2.7129230470588235, 1.9459282392156863),
)
OPSIN_BIAS = -0.0037930732552754493
QUANT_BIAS = (
    1.0 - 0.05465007330715401,
    1.0 - 0.07005449891748593,
    1.0 - 0.049935103337343655,
)
QUANT_BIAS_NUM = 0.145


@dataclass
class ExtraChannel:
    type: ECType = ECType.ALPHA
    bpp: int = 8
    exp_bits: int = 0
    dim_shift: int = 0
    name: str = ""
    alpha_associated: bool = False
    spot: tuple[float, float, float, float] | None = None
    cfa_channel: int = 0


@dataclass
class ImageMetadata:
    width: int = 0
    height: int = 0
    orientation: Orientation = Orientation.TL
    intr_width: int = 0
    intr_height: int = 0
    bpp: int = 8
    exp_bits: int = 0
    anim_tps_num: int = 0
    anim_tps_denom: int = 0
    anim_nloops: int = 0
    anim_have_timecodes: bool = False
    cspace: CSpace = CSpace.CHROMA
    cpoints: tuple = SRGB_CHROMA
    gamma_or_tf: int = TF_SRGB
    render_intent: int = 1  # relative
    intensity_target: float = 255.0
    min_nits: float = 0.0
    linear_below: float = 0.0
    modular_16bit_buffers: bool = True
    ec_info: list[ExtraChannel] = field(default_factory=list)
    xyb_encoded: bool = True
    opsin_inv_mat: tuple = OPSIN_INV_MAT
    opsin_bias: tuple = (OPSIN_BIAS, OPSIN_BIAS, OPSIN_BIAS)
    quant_bias: tuple = QUANT_BIAS
    quant_bias_num: float = QUANT_BIAS_NUM
    want_icc: bool = False
    icc: bytes | None = None
    #: custom upsampling weight vectors keyed by factor (2/4/8); absent
    #: factors use the spec defaults (ops/upsample.py).  The reference
    #: rejects any cw_mask (j40.h:3320 analog); we decode them per spec.
    up_weights: dict = field(default_factory=dict)

    @property
    def num_extra_channels(self) -> int:
        return len(self.ec_info)

    @property
    def animated(self) -> bool:
        return self.anim_tps_denom != 0


def read_signature(r: BitReader) -> None:
    check(r.u(16) == 0x0AFF, "!jxl", "bad signature")  # bytes FF 0A


def read_size_header(r: BitReader) -> tuple[int, int]:
    """SizeHeader (j40.h:3008-3031): returns (width, height)."""
    div8 = r.u(1)
    h = (r.u(5) + 1) * 8 if div8 else r.u32(1, 9, 1, 13, 1, 18, 1, 30)
    ratio = r.u(3)
    if ratio == 0:
        w = (r.u(5) + 1) * 8 if div8 else r.u32(1, 9, 1, 13, 1, 18, 1, 30)
    elif ratio == 7:
        check(h < 0x40000000, "bigg")
        w = h * 2
    else:
        num, den = ((1, 1), (6, 5), (4, 3), (3, 2), (16, 9), (5, 4))[ratio - 1]
        w = h * num // den
    return w, h


def read_bit_depth(r: BitReader) -> tuple[int, int]:
    """BitDepth (j40.h:3033-3048): returns (bpp, exp_bits)."""
    if r.u(1):  # float samples
        bpp = r.u32(32, 0, 16, 0, 24, 0, 1, 6)
        exp_bits = r.u(4) + 1
        mant = bpp - exp_bits - 1
        check(2 <= mant <= 23, "bpp?")
        check(2 <= exp_bits <= 8, "exp?")
        return bpp, exp_bits
    bpp = r.u32(8, 0, 10, 0, 12, 0, 1, 6)
    check(1 <= bpp <= 31, "bpp?")
    return bpp, 0


def read_name(r: BitReader) -> str:
    """UTF-8 name (j40.h:3050-3080).  NOTE: the reference's verifier requires
    `i + c < len` STRICTLY for the final character, which rejects every
    nonempty name ("name" error); that is a bug we do not replicate — valid
    UTF-8 names are accepted here per spec."""
    length = r.u32(0, 0, 0, 4, 16, 5, 48, 10)
    raw = bytes(r.u(8) for _ in range(length))
    try:
        s = raw.decode("utf-8", errors="strict")
    except UnicodeDecodeError:
        check(False, "name", "invalid UTF-8 in name")
    # surrogates/overlongs already rejected by strict codec
    return s


def read_customxy(r: BitReader) -> tuple[float, float]:
    def one() -> float:
        return unpack_signed(r.u32(0, 19, 0x80000, 19, 0x100000, 20, 0x200000, 21)) / 100000.0

    return one(), one()


def read_extensions(r: BitReader) -> None:
    """Skip extension payloads (j40.h:3088-3102).  NOTE: the reference's
    j40__skip double-skips payloads of < 64 bits whenever its accumulator
    already holds the whole payload (j40.h:1895-1901 falls through to the
    byte-skip); we skip exactly per spec."""
    extensions = r.u64()
    nbits = 0
    for i in range(64):
        if (extensions >> i) & 1:
            nbits += r.u64()
    r.skip(nbits)


def read_image_metadata(r: BitReader, limits: Limits = MAIN_LV5) -> ImageMetadata:
    im = ImageMetadata()
    im.width, im.height = read_size_header(r)
    check(im.width <= limits.width and im.height <= limits.height, "slim")
    check(im.width * im.height <= limits.pixels, "slim")

    if not r.u(1):  # not all_default
        extra_fields = r.u(1)
        if extra_fields:
            im.orientation = Orientation(r.u(3) + 1)
            if r.u(1):  # have_intr_size
                im.intr_width, im.intr_height = read_size_header(r)
            if r.u(1):  # have_preview
                raise Unsupported(message="preview")
            if r.u(1):  # have_animation
                im.anim_tps_num = r.u32(100, 0, 1000, 0, 1, 10, 1, 30)
                im.anim_tps_denom = r.u32(1, 0, 1001, 0, 1, 8, 1, 10)
                im.anim_nloops = r.u32(0, 0, 0, 3, 0, 16, 0, 32)
                im.anim_have_timecodes = bool(r.u(1))
        im.bpp, im.exp_bits = read_bit_depth(r)
        check(im.bpp <= limits.bpp, "fbpp")
        im.modular_16bit_buffers = bool(r.u(1))
        check(
            im.modular_16bit_buffers or not limits.needs_modular_16bit_buffers, "fm32"
        )
        nec = r.u32(0, 0, 1, 0, 2, 4, 1, 12)
        check(nec <= limits.num_extra_channels, "elim")
        for _ in range(nec):
            ec = ExtraChannel()
            if r.u(1):  # d_alpha: default alpha channel
                pass
            else:
                t = r.enum()
                # unknown types are a decode error, not a crash (j40.h:3206)
                try:
                    ec.type = ECType(t)
                except ValueError:
                    check(False, "ect?", f"unknown extra channel type {t}")
                ec.bpp, ec.exp_bits = read_bit_depth(r)
                ec.dim_shift = r.u32(0, 0, 3, 0, 4, 0, 1, 3)
                ec.name = read_name(r)
                if ec.type == ECType.ALPHA:
                    ec.alpha_associated = bool(r.u(1))
                elif ec.type == ECType.SPOT_COLOUR:
                    ec.spot = (r.f16(), r.f16(), r.f16(), r.f16())
                elif ec.type == ECType.CFA:
                    ec.cfa_channel = r.u32(1, 0, 0, 2, 3, 4, 19, 8)
                elif ec.type == ECType.BLACK:
                    check(limits.ec_black_allowed, "fblk")
            check(ec.bpp <= limits.bpp, "fbpp")
            im.ec_info.append(ec)
        im.xyb_encoded = bool(r.u(1))
        if not r.u(1):  # ColourEncoding not all_default
            im.want_icc = bool(r.u(1))
            cspace = r.enum()
            check(cspace in (0, 1, 2, 3), "csp?")
            im.cspace = {0: CSpace.CHROMA, 1: CSpace.GREY, 2: CSpace.XYB, 3: CSpace.CHROMA}[cspace]
            cpoints = [list(p) for p in SRGB_CHROMA]
            if not im.want_icc:
                if cspace != 2:  # not XYB
                    wp = r.enum()
                    if wp == 1:  # D65 default
                        pass
                    elif wp == 2:
                        cpoints[0] = list(read_customxy(r))
                    elif wp == 10:  # E
                        cpoints[0] = [1 / 3.0, 1 / 3.0]
                    elif wp == 11:  # DCI
                        cpoints[0] = [0.314, 0.351]
                    else:
                        check(False, "wpt?")
                    if cspace != 1:  # not grey
                        pr = r.enum()
                        if pr == 1:  # sRGB default
                            pass
                        elif pr == 2:
                            cpoints[1] = list(read_customxy(r))
                            cpoints[2] = list(read_customxy(r))
                            cpoints[3] = list(read_customxy(r))
                        elif pr == 9:  # BT.2100
                            cpoints[1:] = [[0.708, 0.292], [0.170, 0.797], [0.131, 0.046]]
                        elif pr == 11:  # P3
                            cpoints[1:] = [[0.680, 0.320], [0.265, 0.690], [0.150, 0.060]]
                        else:
                            check(False, "prm?")
                if r.u(1):  # have_gamma
                    im.gamma_or_tf = r.u(24)
                    check(0 < im.gamma_or_tf <= GAMMA_MAX, "gama")
                    if cspace == 2:
                        check(im.gamma_or_tf == 3333333, "gama")
                else:
                    im.gamma_or_tf = -r.enum()
                    check(
                        im.gamma_or_tf
                        in (TF_709, TF_UNKNOWN, TF_LINEAR, TF_SRGB, TF_PQ, TF_DCI, TF_HLG),
                        "tfn?",
                    )
                im.render_intent = r.enum()
                check(im.render_intent in (0, 1, 2, 3), "itt?")
            im.cpoints = tuple(tuple(p) for p in cpoints)
        if extra_fields:
            if not r.u(1):  # ToneMapping not all_default
                im.intensity_target = r.f16()
                check(im.intensity_target > 0, "tone")
                im.min_nits = r.f16()
                check(0 < im.min_nits <= im.intensity_target, "tone")
                relative = r.u(1)
                im.linear_below = r.f16()
                if relative:
                    check(0 <= im.linear_below <= 1, "tone")
                    im.linear_below *= -1.0
                else:
                    check(im.linear_below >= 0, "tone")
        read_extensions(r)
    if not r.u(1):  # not default_m
        if im.xyb_encoded:
            im.opsin_inv_mat = tuple(tuple(r.f16() for _ in range(3)) for _ in range(3))
            im.opsin_bias = tuple(r.f16() for _ in range(3))
            im.quant_bias = tuple(r.f16() for _ in range(3))
            im.quant_bias_num = r.f16()
        cw_mask = r.u(3)
        # custom upsampling weight vectors (spec CustomTransformData; the
        # reference rejects these): bit 0/1/2 -> up2/up4/up8, n(n+1)/2
        # f16 weights each with n = 5k/2
        for bit, k in ((1, 2), (2, 4), (4, 8)):
            if cw_mask & bit:
                n = 5 * k // 2
                im.up_weights[k] = [r.f16() for _ in range(n * (n + 1) // 2)]
    return im
