"""Encoder-side image/frame header emission for the supported subset.

Emits headers that the reference decoder (dj40) accepts; used both by the
user-facing encoder and to synthesize differential-test bitstreams.
"""

from __future__ import annotations

from .bitwriter import BitWriter

U32_SIZE = ((1, 9), (1, 13), (1, 18), (1, 30))


def write_signature(w: BitWriter) -> None:
    w.u(8, 0xFF)
    w.u(8, 0x0A)


def write_size_header(w: BitWriter, width: int, height: int) -> None:
    if width % 8 == 0 and height % 8 == 0 and width <= 256 and height <= 256:
        w.u(1, 1)  # div8
        w.u(5, height // 8 - 1)
        w.u(3, 0)  # ratio: explicit
        w.u(5, width // 8 - 1)
    else:
        w.u(1, 0)
        w.u32(U32_SIZE, height)
        w.u(3, 0)
        w.u32(U32_SIZE, width)


def write_image_metadata(
    w: BitWriter,
    width: int,
    height: int,
    *,
    bpp: int = 8,
    xyb_encoded: bool = False,
    modular_16bit: bool = True,
    num_alpha: int = 0,
    intensity_target: float | None = None,
    grayscale: bool = False,
    animation: tuple[int, int, int] | None = None,
    orientation: int = 1,
    want_icc: bool = False,
    opsin: tuple | None = None,  # (inv_mat 3x3, bias 3, quant_bias 3, qb_num)
    extra_decls: list[dict] | None = None,  # explicit extra-channel decls
    up_weights: dict | None = None,  # custom upsampling weights {k: [f16...]}
) -> None:
    """`animation` = (tps_numerator, tps_denominator, num_loops) enables the
    extra_fields/have_animation path (read side: image.py:204-208);
    `orientation` is the EXIF-style 1-8 code (1 = identity)."""
    write_size_header(w, width, height)
    extra_fields = (animation is not None or orientation != 1
                    or intensity_target is not None)
    if (bpp == 8 and xyb_encoded and num_alpha == 0
            and intensity_target is None and not grayscale
            and not extra_fields and not want_icc and opsin is None
            and not extra_decls and not up_weights):
        w.u(1, 1)  # all_default
        w.u(1, 1)  # default_m
        return
    w.u(1, 0)  # not all_default
    w.u(1, 1 if extra_fields else 0)  # extra_fields
    if extra_fields:
        w.u(3, orientation - 1)
        w.u(1, 0)  # have_intr_size
        w.u(1, 0)  # have_preview
        w.u(1, 1 if animation else 0)  # have_animation
        if animation:
            tps_num, tps_denom, nloops = animation
            w.u32(((100, 0), (1000, 0), (1, 10), (1, 30)), tps_num)
            w.u32(((1, 0), (1001, 0), (1, 8), (1, 10)), tps_denom)
            w.u32(((0, 0), (0, 3), (0, 16), (0, 32)), nloops)
            w.u(1, 0)  # have_timecodes
    # BitDepth: integer samples
    w.u(1, 0)
    w.u32(((8, 0), (10, 0), (12, 0), (1, 6)), bpp)
    w.u(1, 1 if modular_16bit else 0)
    decls = extra_decls or []
    w.u32(((0, 0), (1, 0), (2, 4), (1, 12)), num_alpha + len(decls))
    for _ in range(num_alpha):
        w.u(1, 1)  # d_alpha: default alpha channel
    for d in decls:
        # explicit declaration (read side: image.py:217-235)
        w.u(1, 0)  # not d_alpha
        w.enum(d["type"])
        w.u(1, 0)  # integer bit depth
        w.u32(((8, 0), (10, 0), (12, 0), (1, 6)), d.get("bpp", 8))
        w.u32(((0, 0), (3, 0), (4, 0), (1, 3)), 0)  # dim_shift
        name = d.get("name", "").encode("utf-8")
        w.u32(((0, 0), (0, 4), (16, 5), (48, 10)), len(name))
        for b in name:
            w.u(8, b)
        if d["type"] == 0:  # alpha
            w.u(1, d.get("alpha_associated", 0))
        elif d["type"] == 2:  # spot colour
            for v in d.get("spot", (1.0, 0.0, 0.0, 0.5)):
                w.f16(v)
        elif d["type"] == 5:  # CFA
            w.u32(((1, 0), (0, 2), (3, 4), (19, 8)), d.get("cfa_channel", 1))
    w.u(1, 1 if xyb_encoded else 0)
    if want_icc:
        # only the colour space enum is read when an ICC payload follows
        # (read side: image.py:237-243)
        w.u(1, 0)  # ColourEncoding not all_default
        w.u(1, 1)  # want_icc
        w.enum(1 if grayscale else 0)  # colour space
    elif grayscale:
        w.u(1, 0)  # ColourEncoding not all_default
        w.u(1, 0)  # want_icc = false
        w.enum(1)  # colour space: grey
        w.enum(1)  # white point: D65 (no primaries for grey)
        w.u(1, 0)  # no gamma -> transfer function enum
        w.enum(13)  # sRGB transfer
        w.enum(1)  # render intent: relative
    else:
        w.u(1, 1)  # ColourEncoding all_default (sRGB)
    if extra_fields:
        if intensity_target is not None:
            # ToneMapping (read side: image.py:285-297); values f16-exact
            w.u(1, 0)  # not all_default
            w.f16(intensity_target)
            w.f16(0.0009765625)  # min_nits
            w.u(1, 0)  # relative_to_max_display = false
            w.f16(0.0)  # linear_below
        else:
            w.u(1, 1)  # ToneMapping all_default
    w.u64(0)  # extensions: none
    if opsin is not None or up_weights:
        assert opsin is not None or not xyb_encoded, \
            "custom up_weights with xyb_encoded requires explicit opsin"
        w.u(1, 0)  # not default_m
        if xyb_encoded:
            # custom opsin inverse matrix / biases (read side:
            # image.py:299-307); values must be f16-exact
            inv_mat, bias, quant_bias, qb_num = opsin
            for row in inv_mat:
                for v in row:
                    w.f16(v)
            for v in bias:
                w.f16(v)
            for v in quant_bias:
                w.f16(v)
            w.f16(qb_num)
        up_weights = up_weights or {}
        mask = (1 if 2 in up_weights else 0) | (2 if 4 in up_weights else 0) \
            | (4 if 8 in up_weights else 0)
        w.u(3, mask)  # cw_mask (read side: image.py:318-326); f16-exact
        for k in (2, 4, 8):
            if k in up_weights:
                n = 5 * k // 2
                ws = list(up_weights[k])
                assert len(ws) == n * (n + 1) // 2
                for v in ws:
                    w.f16(v)
    else:
        w.u(1, 1)  # default_m


def icc_context(idx: int, prev: int, pprev: int) -> int:
    """41-context model for ICC bytes (read side: headers/icc.py:45-66)."""
    if idx <= 128:
        return 0
    if prev < 16:
        ctx = prev + 3 if prev < 2 else 5
    elif prev > 240:
        ctx = 6 + (1 if prev == 255 else 0)
    elif 97 <= (prev | 32) <= 122:
        ctx = 1
    elif prev == 44 or prev == 46 or 48 <= prev < 58:
        ctx = 2
    else:
        ctx = 8
    if pprev < 16:
        ctx += 2 * 8
    elif pprev > 240:
        ctx += 3 * 8
    elif 97 <= (pprev | 32) <= 122:
        ctx += 0
    elif pprev == 44 or pprev == 46 or 48 <= pprev < 58:
        ctx += 1 * 8
    else:
        ctx += 4 * 8
    return ctx


def write_icc(w: BitWriter, payload: bytes, use_prefix: bool = True) -> None:
    """Entropy-coded ICC stream (read side: headers/icc.py; spec §14).

    `payload` is the raw command stream; the leading varint carries the
    nominal output size (we use the payload length, which satisfies the
    reference's enc_size/21 sanity bound)."""
    from .entropy import EntropyEncoder

    varint = []
    v = len(payload)
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            varint.append(b | 0x80)
        else:
            varint.append(b)
            break
    w.u64(len(varint) + len(payload))
    enc = EntropyEncoder(41, use_prefix=use_prefix)
    idx = 0
    for b in varint:
        enc.add(0, b)
        idx += 1
    byte = prev = 0
    for b in payload:
        pprev, prev = prev, byte
        enc.add(icc_context(idx, prev, pprev), b)
        byte = b
        idx += 1
    enc.write(w)
