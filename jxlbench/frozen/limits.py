"""Decode resource limits (reference: j40.h:1147-1188).

The Main profile Level 5 limits are the default, matching the reference's
hardcoded choice (j40.h:8131); Level 10 is provided for completeness.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Limits:
    pixels: int
    width: int
    height: int
    icc_size: int
    bpp: int
    ec_black_allowed: bool
    num_extra_channels: int
    needs_modular_16bit_buffers: bool
    nb_transforms: int
    tree_depth: int
    zf_pixels: int  # pixel cap for zero-fill allocations


MAIN_LV5 = Limits(
    pixels=1 << 28,
    width=1 << 18,
    height=1 << 18,
    icc_size=1 << 22,
    bpp=16,
    ec_black_allowed=False,
    num_extra_channels=4,
    needs_modular_16bit_buffers=True,
    nb_transforms=8,
    tree_depth=64,
    zf_pixels=1 << 28,
)

MAIN_LV10 = Limits(
    pixels=1 << 40,
    width=1 << 30,
    height=1 << 30,
    icc_size=1 << 28,
    bpp=32,
    ec_black_allowed=True,
    num_extra_channels=256,
    needs_modular_16bit_buffers=False,
    nb_transforms=1 << 31 - 1,
    tree_depth=2048,
    zf_pixels=1 << 30,
)
