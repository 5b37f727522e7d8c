"""ISOBMFF container handling (reference: j40.h:1390-1650, ISO/IEC 18181-2).

Design difference from the reference: instead of maintaining an incremental
codestream-offset→file-offset map over a pull source, the host assembles the
full contiguous codestream up front (sections are then sliced out of it by the
TOC).  This is the right shape for the TPU pipeline, whose decode plan wants
all section byte ranges before dispatch.  Box ordering/cardinality rules match
the reference: `jxll`/`jxli` at most once, `jxlc` precludes `jxlp`, `jxlp`
final-index bit terminates the codestream sequence, `brob`-wrapped jxl boxes
rejected.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

from ..errors import ShortInput, check

JXL_BOX = bytes.fromhex("0000000c4a584c200d0a870a")
FTYP_BOX = bytes.fromhex("00000014667479706a786c20000000006a786c20")


@dataclass
class Container:
    """Parsed container: contiguous codestream plus auxiliary box payloads."""

    codestream: bytes
    is_bare: bool = False
    level: int | None = None  # from jxll
    frame_index_box: bytes | None = None  # from jxli (unparsed)
    other_boxes: list[tuple[bytes, bytes]] = field(default_factory=list)
    #: False when parsed with allow_partial and the input ended mid-box; the
    #: codestream then holds every byte recoverable so far (streaming decode)
    complete: bool = True


def _read_box_header(data: bytes, pos: int) -> tuple[bytes, int, int] | None:
    """Returns (type, payload_start, payload_end) or None at EOF.

    payload_end == -1 means the box extends to end of file (size 0).
    """
    if pos == len(data):
        return None
    if pos + 8 > len(data):
        raise ShortInput("truncated box header")
    (size32,) = struct.unpack_from(">I", data, pos)
    type_ = data[pos + 4 : pos + 8]
    if size32 == 0:
        return type_, pos + 8, -1
    if size32 == 1:
        if pos + 16 > len(data):
            raise ShortInput("truncated extended box header")
        (size64,) = struct.unpack_from(">Q", data, pos + 8)
        check(size64 >= 16, "boxx")
        return type_, pos + 16, pos + size64
    check(size32 >= 8, "boxx")
    return type_, pos + 8, pos + size32


def parse_container(data: bytes, allow_partial: bool = False) -> Container:
    """Detect bare codestream vs box container and extract the codestream.

    With ``allow_partial`` (streaming), a truncated box does not raise: the
    available prefix of a truncated codestream box is still recovered (a large
    `jxlc` payload arriving in chunks is usable immediately) and the returned
    container is marked ``complete=False``."""
    if len(data) < 2:
        raise ShortInput("container signature needs 2 bytes")
    if data[0] == 0xFF and data[1] == 0x0A:
        return Container(codestream=data, is_bare=True)
    check(data[:2] == JXL_BOX[:2], "!jxl")
    if allow_partial and len(data) < len(JXL_BOX) + len(FTYP_BOX):
        if (JXL_BOX + FTYP_BOX).startswith(data):
            raise ShortInput("truncated container signature")
    check(data[: len(JXL_BOX)] == JXL_BOX, "!jxl")
    off = len(JXL_BOX)
    check(data[off : off + len(FTYP_BOX)] == FTYP_BOX, "ftyp")
    pos = off + len(FTYP_BOX)

    seen_jxll = seen_jxli = seen_jxlc = seen_jxlp = False
    no_more_codestream = False
    parts: list[bytes] = []
    cont = Container(codestream=b"")

    while True:
        try:
            hdr = _read_box_header(data, pos)
        except ShortInput:
            if not allow_partial:
                raise
            cont.complete = False
            break
        if hdr is None:
            break
        type_, start, end = hdr
        payload = data[start:] if end == -1 else data[start:end]
        if end != -1 and end > len(data):
            if not allow_partial:
                raise ShortInput("truncated box payload")
            # recover the available prefix of a truncated codestream box
            cont.complete = False
            if type_ == b"jxlc" and not (seen_jxlp or seen_jxlc or no_more_codestream):
                parts.append(data[start:])
                seen_jxlc = True
            elif type_ == b"jxlp" and not (seen_jxlc or no_more_codestream):
                if len(data) - start >= 4:
                    parts.append(data[start + 4 :])
                    seen_jxlp = True
            break

        if type_ == b"jxll":
            check(not seen_jxll, "box?")
            seen_jxll = True
            if payload:
                cont.level = payload[0]
        elif type_ == b"jxli":
            check(not seen_jxli, "box?")
            seen_jxli = True
            cont.frame_index_box = payload
        elif type_ == b"jxlc":
            check(not no_more_codestream, "box?")
            check(not (seen_jxlp or seen_jxlc), "box?")
            seen_jxlc = True
            no_more_codestream = True
            parts.append(payload)
        elif type_ == b"jxlp":
            check(not no_more_codestream, "box?")
            check(not seen_jxlc, "box?")
            seen_jxlp = True
            check(len(payload) >= 4, "jxlp")
            # the reference treats a CLEAR top bit of the 4-byte index as the
            # final partial codestream (j40.h:1557)
            if not (payload[0] >> 7):
                no_more_codestream = True
            parts.append(payload[4:])
        elif type_ == b"brob":
            check(len(payload) > 4, "brot")
            inner = payload[:4]
            check(inner != b"brob" and inner[:3] != b"jxl", "brot")
            cont.other_boxes.append((b"brob", payload))
        else:
            cont.other_boxes.append((type_, payload))

        if end == -1:
            break
        pos = end

    check(seen_jxlc or seen_jxlp, "shrt" if not parts else "box?")
    cont.codestream = b"".join(parts)
    if allow_partial and len(cont.codestream) < 2:
        raise ShortInput("codestream signature not yet available")
    check(cont.codestream[:2] == b"\xff\x0a", "!jxl")
    return cont


def _box(type_: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + type_ + payload


def wrap_container(
    codestream: bytes,
    *,
    jxlp_parts: int = 0,
    level: int | None = None,
    extra_boxes: list[tuple[bytes, bytes]] | None = None,
) -> bytes:
    """Wrap a bare codestream in an ISOBMFF container (encoder dual of
    parse_container; reference read side j40.h:1479-1604).

    jxlp_parts > 0 splits the codestream across that many `jxlp` boxes (the
    final one with the index top bit CLEAR, matching the reference's
    final-part convention); otherwise a single `jxlc` box is used.

    NOTE: the reference decoder can fail ("shrt") on permuted-TOC streams
    split across jxlp parts — its incremental codeoff->fileoff map cannot
    always seek out-of-order sections across box boundaries (the
    "TODO honor containers" at j40.h:1905; whether it fails depends on where
    the part boundaries land).  Our contiguous-codestream design decodes
    these fine."""
    out = bytearray()
    out += JXL_BOX
    out += FTYP_BOX
    if level is not None:
        out += _box(b"jxll", bytes([level]))
    for type_, payload in extra_boxes or []:
        out += _box(type_, payload)
    if jxlp_parts <= 1:
        out += _box(b"jxlc", codestream)
    else:
        n = jxlp_parts
        step = max(1, len(codestream) // n)
        for i in range(n):
            part = (
                codestream[i * step : (i + 1) * step]
                if i < n - 1
                else codestream[(n - 1) * step :]
            )
            # 4-byte big-endian index; top bit SET on non-final parts
            idx = i | (0x80000000 if i < n - 1 else 0)
            out += _box(b"jxlp", struct.pack(">I", idx) + part)
    return bytes(out)
