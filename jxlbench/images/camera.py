"""Camera-frame content from a seed: what a phone camera's 12 MP frame of
an outdoor scene holds, in the three kinds of region an encoder's varblock
chooser tells apart.

- smooth: a sky graded top to bottom, building walls lit across their
  width, and defocused blobs (bokeh) of the out-of-focus background;
- textured: foliage-like grain (noise at three scales, the coarsest a leaf
  cluster's) over a fixed share of the ground, and a finer ground texture;
- edges: the walls' outlines and rows of windows, and the horizon.

Every pixel carries sensor noise (sigma 0.8 levels).  As images/photo.py
does, the scene's proportions are fixed (the horizon's height, the share
of the ground under foliage, the walls' number and sizes, the blobs'
number and sizes, the noises' strengths), so every seed gives frames of
the same density; the seed moves the layout (where the walls, the foliage
and the blobs are, the horizon's wave) and draws every noise and colour.
Everything is float32 numpy, in one pass a feature, so a 4096x3072 frame
takes a few seconds."""

from __future__ import annotations

import numpy as np

#: the share of the ground under foliage
FOLIAGE = 0.5
#: the walls' widths and tops as shares of the frame's width and height
WALLS = ((0.10, 0.20), (0.07, 0.35), (0.12, 0.25), (0.06, 0.40))
#: the blobs' radii as shares of the frame's shorter side
BLOBS = (0.03, 0.04, 0.05, 0.06, 0.07, 0.08)


def _field(rng, h: int, w: int, cell: int) -> np.ndarray:
    """(h, w) float32 noise that varies over `cell` pixels: a grid of
    normal samples, `cell` pixels apart, bilinearly upsampled."""
    gh, gw = h // cell + 2, w // cell + 2
    g = rng.standard_normal((gh, gw)).astype(np.float32)
    ys = np.arange(h, dtype=np.float32) / cell
    xs = np.arange(w, dtype=np.float32) / cell
    y0, x0 = ys.astype(np.int64), xs.astype(np.int64)
    fy, fx = (ys - y0)[:, None], (xs - x0)[None, :]
    top = g[y0][:, x0] * (1 - fx) + g[y0][:, x0 + 1] * fx
    bot = g[y0 + 1][:, x0] * (1 - fx) + g[y0 + 1][:, x0 + 1] * fx
    return top * (1 - fy) + bot * fy


def _grain(rng, h: int, w: int) -> np.ndarray:
    """(h, w) float32 fine grain: normal noise averaged over 2x2 pixels."""
    n = rng.standard_normal((h + 1, w + 1)).astype(np.float32)
    return 0.5 * (n[:-1, :-1] + n[1:, :-1] + n[:-1, 1:] + n[1:, 1:])


def make(height: int, width: int, seed: int, index: int) -> np.ndarray:
    """(height, width, 3) uint8 sRGB."""
    rng = np.random.default_rng([seed % 2**63, index, 12])
    h, w = height, width
    yy = np.arange(h, dtype=np.float32)[:, None]
    xx = np.arange(w, dtype=np.float32)[None, :]
    img = np.empty((3, h, w), np.float32)

    # sky above a wavy horizon at 0.28 of the height, graded from deep
    # to pale blue
    horizon = h * (0.28 + 0.03 * np.sin(2 * np.pi * xx / w * 3 + rng.uniform(0, 2 * np.pi)))
    t = yy / float(horizon.max())
    sky = np.array([70, 120, 190], np.float32) + rng.uniform(-15, 15, 3).astype(np.float32)
    for c, top in enumerate(sky):
        img[c] = top + (235 - top) * 0.8 * t
    below = yy >= horizon

    # ground: brown-grey with a fine texture, darker towards the bottom
    ground = np.array([110, 100, 85], np.float32) + rng.uniform(-20, 20, 3).astype(np.float32)
    gtex = 9.0 * _grain(rng, h, w) + 10.0 * _field(rng, h, w, 24)
    for c in range(3):
        img[c] = np.where(below, ground[c] * (1.1 - 0.3 * yy / h) + gtex, img[c])

    # foliage over a fixed share of the ground, where a low-frequency field
    # is highest
    leaf = (22.0 * _grain(rng, h, w) + 18.0 * _field(rng, h, w, 6)
            + 14.0 * _field(rng, h, w, 40))
    field = _field(rng, h, w, max(64, w // 12))
    mask = below & (field > np.quantile(field[np.broadcast_to(below, field.shape)],
                                        1.0 - FOLIAGE))
    green = np.array([60, 105, 45], np.float32) + rng.uniform(-15, 15, 3).astype(np.float32)
    for c, k in enumerate((0.8, 1.0, 0.6)):
        img[c] = np.where(mask, green[c] + k * leaf, img[c])

    # walls, one in each quarter of the width: flat, lit across their
    # width, with rows of dark windows
    for k, (ws, top) in enumerate(WALLS):
        ww = int(ws * w)
        x0 = int(k * w / 4 + rng.uniform(0, max(1.0, w / 4 - ww)))
        x1 = min(w, x0 + ww)
        y0, y1 = int(top * h), int(0.95 * h)
        wall = rng.uniform(120, 215, 3).astype(np.float32)
        light = (1.0 - 0.25 * (xx[:, x0:x1] - x0) / max(1, x1 - x0)).astype(np.float32)
        pitch = 64 + 8 * k
        win = (((yy[y0:y1] - y0) % pitch) < pitch // 2) & (((xx[:, x0:x1] - x0) % pitch) > pitch // 3)
        for c in range(3):
            block = wall[c] * light + np.zeros((y1 - y0, 1), np.float32)
            img[c, y0:y1, x0:x1] = np.where(win, 0.35 * block, block)

    # defocused blobs: smooth discs of light in the background
    for r in BLOBS:
        r *= min(h, w)
        cy, cx = rng.uniform(0.1 * h, 0.6 * h), rng.uniform(0, w)
        ys, xs = slice(max(0, int(cy - 2 * r)), min(h, int(cy + 2 * r))), \
            slice(max(0, int(cx - 2 * r)), min(w, int(cx + 2 * r)))
        d2 = ((yy[ys] - cy) ** 2 + (xx[:, xs] - cx) ** 2) / (r * r)
        a = np.exp(-d2 * d2).astype(np.float32)
        tint = rng.uniform(180, 250, 3).astype(np.float32)
        for c in range(3):
            img[c, ys, xs] += a * (tint[c] - img[c, ys, xs])

    img += 0.8 * rng.standard_normal((3, h, w)).astype(np.float32)
    return np.ascontiguousarray(img.clip(0, 255).round().astype(np.uint8).transpose(1, 2, 0))
