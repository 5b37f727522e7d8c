"""PNG and APNG writers for the CLI, on zlib, struct and numpy alone
(port: the JAX CLI writes through Pillow, which the GPU machine lacks; the
reference's dj40.c likewise carries its own writer, stb_image_write).

8-bit RGBA only, every row with the Up filter (type 2), zlib at its default
level.  An APNG holds every frame whole (no regions, no blending): frame 0
is the default image, and each frame shows for its delay.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload)))


def _rgba(rgba_u8) -> np.ndarray:
    a = np.ascontiguousarray(rgba_u8)
    if a.dtype != np.uint8 or a.ndim != 3 or a.shape[2] != 4 or 0 in a.shape[:2]:
        raise ValueError(f"need a (h, w, 4) uint8 array, got {a.dtype} {a.shape}")
    return a


def _ihdr(h: int, w: int) -> bytes:
    # 8 bits a sample, colour type 6 (RGBA), deflate, adaptive filters,
    # no interlace
    return _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0))


def _deflate(a: np.ndarray) -> bytes:
    """The zlib stream of the filtered scanlines: each row minus the row
    above (mod 256), the first row as it is, a filter byte 2 before each."""
    h, w = a.shape[:2]
    rows = a.reshape(h, w * 4)
    up = rows.copy()
    up[1:] -= rows[:-1]
    return zlib.compress(np.concatenate([np.full((h, 1), 2, np.uint8), up], 1).tobytes())


def write_png(path, rgba_u8) -> None:
    """Write a (h, w, 4) uint8 image as an 8-bit RGBA PNG."""
    a = _rgba(rgba_u8)
    with open(path, "wb") as f:
        f.write(SIGNATURE + _ihdr(*a.shape[:2]) + _chunk(b"IDAT", _deflate(a))
                + _chunk(b"IEND", b""))


def write_apng(path, frames, delays_ms, loops: int) -> None:
    """Write equal-sized (h, w, 4) uint8 frames as an animated PNG: frame i
    shows for delays_ms[i] milliseconds (an integer below 65536), and the
    animation plays `loops` times (0: forever)."""
    frames = [_rgba(f) for f in frames]
    delays = [int(d) for d in delays_ms]
    if not frames or len(delays) != len(frames):
        raise ValueError(f"{len(frames)} frames, {len(delays)} delays")
    h, w = frames[0].shape[:2]
    if any(f.shape[:2] != (h, w) for f in frames):
        raise ValueError("APNG frames of different sizes")
    if not all(0 <= d <= 0xFFFF for d in delays):
        raise ValueError(f"frame delays {delays} ms: each must be below 65536")
    out = [SIGNATURE, _ihdr(h, w), _chunk(b"acTL", struct.pack(">II", len(frames), loops))]
    seq = 0
    for i, (f, d) in enumerate(zip(frames, delays)):
        # the whole canvas, delay d/1000 s, dispose none, blend source
        out.append(_chunk(b"fcTL", struct.pack(">IIIIIHHBB", seq, w, h, 0, 0, d, 1000,
                                               0, 0)))
        seq += 1
        z = _deflate(f)
        if i == 0:
            out.append(_chunk(b"IDAT", z))
        else:
            out.append(_chunk(b"fdAT", struct.pack(">I", seq) + z))
            seq += 1
    out.append(_chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(b"".join(out))
