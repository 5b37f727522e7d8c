"""Entropy-coded ICC payload (reference j40.h:3329-3435, spec §14).

The encoded command stream is decoded (it must be, to advance the bitstream)
and returned raw; like the reference, we do not reconstruct the actual ICC
profile from the command stream yet.
"""

from __future__ import annotations

from ..errors import J40Error, check
from ..io.bits import BitReader
from ..limits import MAIN_LV5, Limits
from ..entropy.code import CodeState, read_code_spec


def _icc_varint(r: BitReader, code: CodeState, index: list[int], size: int) -> int:
    value = 0
    shift = 0
    while shift < 63:
        check(index[0] < size, "icc?")
        index[0] += 1
        b = code.code(r, 0)
        value |= (b & 0x7F) << shift
        if b < 128:
            return value
        shift += 7
    raise J40Error("vint")


def read_icc(r: BitReader, limits: Limits = MAIN_LV5) -> bytes:
    enc_size = r.u64()
    spec = read_code_spec(r, 41)
    code = CodeState(spec)
    index = [0]
    output_size = _icc_varint(r, code, index, enc_size)
    check(output_size <= limits.icc_size, "plim")
    # a valid command stream never exceeds 21 bytes per output byte (j40.h:3371)
    check(output_size >= enc_size // 21, "icc?")

    data = bytearray()
    byte = prev = pprev = 0
    while index[0] < enc_size:
        pprev = prev
        prev = byte
        ctx = 0
        if index[0] > 128:
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
        byte = code.code(r, ctx)
        data.append(byte & 0xFF)
        index[0] += 1
    code.finish(r)
    return bytes(data)
