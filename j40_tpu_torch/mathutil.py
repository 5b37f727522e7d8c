"""Small integer/math helpers shared across layers (reference: j40.h:587-817)."""

from __future__ import annotations


def unpack_signed(u: int) -> int:
    """Zig-zag decode: 0,1,2,3,... -> 0,-1,1,-2,... (j40.h:610-615).

    Note j40 maps odd u to negative: (u+1)>>1 negated for odd u.
    """
    return -((u + 1) >> 1) if (u & 1) else (u >> 1)


def pack_signed(v: int) -> int:
    """Zig-zag encode, inverse of unpack_signed."""
    return (-v * 2 - 1) if v < 0 else (v * 2)


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def floor_avg(a: int, b: int) -> int:
    """Overflow-free floor((a+b)/2) — trivial in Python, kept for parity."""
    return (a + b) >> 1


def clamp(v, lo, hi):
    return lo if v < lo else hi if v > hi else v
