"""Photo-density content from a seed: smooth shading over several scales,
a fine ripple a channel and sensor-like grain (sigma 0.7), as the port's
own probes make it (chip_smoke.hf_image and photo_images).

The wavelengths are fixed by the image's index in its corpus, so every
seed gets the same set of densities; the seed moves the phases and draws
the grain."""

from __future__ import annotations

import numpy as np


def make(height: int, width: int, seed: int, index: int) -> np.ndarray:
    """(height, width, 3) uint8 sRGB."""
    rng = np.random.default_rng([seed % 2**63, index])
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    px, py, pd, *pc = rng.uniform(0.0, 2 * np.pi, 6).astype(np.float32)
    base = (96 + 60 * np.sin(xx / (31.0 + index % 7) + px) * np.cos(yy / (23.0 + index % 5) + py)
            + 40 * np.sin((xx + yy) / (71.0 + index % 11) + pd))
    out = np.empty((height, width, 3), np.uint8)
    for c in range(3):
        plane = base + 10 * np.sin(xx / (9.0 + 2 * c) + pc[c])
        plane += rng.normal(0, 0.7, (height, width)).astype(np.float32)
        out[:, :, c] = plane.clip(0, 255)
    return out
