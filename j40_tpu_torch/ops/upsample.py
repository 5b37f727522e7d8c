"""Frame upsampling (spec §5.2 Upsampler; `log_upsampling > 0`).

The reference parses `log_upsampling`/`ec_log_upsampling` but rejects any
non-zero value (j40.h:3638, 5245-5250), so this is a beyond-reference
feature verified by construction properties and golden pins (see
tests/test_upsample.py), not by dj40 differentials.

Model (matching the spec/libjxl Upsampler):

- A factor-k upsampling (k in {2, 4, 8}) is defined by a weight vector of
  n(n+1)/2 values, n = 5k/2 (15 / 55 / 210): the upper triangle, row-major,
  of a symmetric n x n matrix V.
- V tiles into (k/2)^2 distinct 5x5 phase kernels
  ``K[py][px][ky][kx] = V[5*py + ky][5*px + kx]`` for py, px < k/2; phases
  p >= k/2 use the kernel of phase k-1-p mirrored along that axis, making
  the operator equivariant under image flips.
- Output pixel (k*i + py, k*j + px) is the 5x5 correlation of K[py][px]
  with the input window centered at (i, j), with mirrored borders
  (half-sample reflection, the j40.h:7328 mirror), and the result is
  clamped to the [min, max] of that input window (anti-ringing clamp).
- Each phase kernel is normalized to unit sum so flat regions are
  preserved exactly; the default tables already sum to 1 per phase (the
  normalization is an exact no-op for them — asserted in tests — and makes
  custom weight vectors scale-invariant).

Default weight tables: the spec's default up2/up4 weights are embedded
below; their per-phase unit sums and ramp-interpolation centroids are
verified in tests (both properties would fail for perturbed constants).
Default up8 weights are not available in this environment (210 constants,
no retrievable source) — factor-8 upsampling therefore requires explicit
custom weights in the image header (`cw_mask & 4`); default up8 raises
Unsupported.  See FUTURE.md.
"""

from __future__ import annotations

import functools

import numpy as np

from ..errors import Unsupported

# spec default weight tables (upper triangle, row-major; n = 5k/2)
UP2_WEIGHTS = np.array([
    -0.01716200, -0.03452303, -0.04022174, -0.02921014, -0.00624645,
    0.14111091, 0.28896755, 0.00278718, -0.01610267, 0.56661550,
    0.03777607, -0.01986694, -0.03144731, -0.01185068, -0.00213539,
], dtype=np.float64)

UP4_WEIGHTS = np.array([
    -0.02419067, -0.03491987, -0.03693351, -0.03094285, -0.00529785,
    -0.01663432, -0.03556863, -0.03888905, -0.03516850, -0.00989469,
    0.23651958, 0.33392945, -0.01073543, -0.01313181, -0.03556694,
    0.13048175, 0.40103025, 0.03951150, -0.02077584, 0.46914198,
    -0.00209270, -0.01484589, -0.04064806, 0.18942530, 0.56279892,
    0.06674400, -0.02335494, -0.03551682, -0.00754830, -0.02267919,
    -0.02363578, 0.00315804, -0.03399098, -0.01359519, -0.00091653,
    -0.00335467, -0.01163294, -0.01610294, -0.00974088, -0.00191622,
    -0.01095446, -0.03198464, -0.04455121, -0.02799790, -0.00645912,
    0.06390599, 0.22963888, 0.00630981, -0.01897349, 0.67537268,
    0.08483369, -0.02534994, -0.02205197, -0.01667999, -0.00384443,
], dtype=np.float64)


def default_weights(k: int) -> np.ndarray:
    if k == 2:
        return UP2_WEIGHTS
    if k == 4:
        return UP4_WEIGHTS
    raise Unsupported(
        message="default up8 weights unavailable; supply custom weights"
    )


def triangle_to_symmetric(weights: np.ndarray, n: int) -> np.ndarray:
    """Expand the row-major upper-triangle vector into the n x n symmetric
    matrix V (index(y<=x) = n*y - y*(y-1)/2 + (x - y))."""
    w = np.asarray(weights, dtype=np.float64)
    assert w.size == n * (n + 1) // 2, (w.size, n)
    V = np.zeros((n, n))
    iu = np.triu_indices(n)
    V[iu] = w
    V.T[iu] = w
    return V


@functools.lru_cache(maxsize=8)
def _kernels_cached(key: tuple, k: int) -> np.ndarray:
    return _kernels(np.array(key, dtype=np.float64), k)


def _kernels(weights: np.ndarray, k: int) -> np.ndarray:
    """(k, k, 5, 5) per-phase kernels, normalized to unit sum."""
    half = k // 2
    V = triangle_to_symmetric(weights, 5 * half)
    K = np.zeros((k, k, 5, 5))
    for py in range(k):
        my, ey = (True, k - 1 - py) if py >= half else (False, py)
        for px in range(k):
            mx, ex = (True, k - 1 - px) if px >= half else (False, px)
            ker = V[5 * ey : 5 * ey + 5, 5 * ex : 5 * ex + 5]
            if my:
                ker = ker[::-1, :]
            if mx:
                ker = ker[:, ::-1]
            s = ker.sum()
            if abs(s) < 1e-8:
                raise Unsupported(message="degenerate upsampling weights")
            K[py, px] = ker / s
    return K


def kernels(weights: np.ndarray | None, k: int) -> np.ndarray:
    if weights is None:
        weights = default_weights(k)
    return _kernels_cached(tuple(np.asarray(weights, np.float64).tolist()), k)


def _mirror_pad2(p: np.ndarray) -> np.ndarray:
    """Half-sample mirror (abcd -> ba|abcd|dc), the j40.h:7328 convention."""
    return np.pad(p, 2, mode="symmetric")


def upsample_plane(
    plane: np.ndarray, k: int, weights: np.ndarray | None = None
) -> np.ndarray:
    """Upsample one (H, W) plane by factor k; returns (k*H, k*W) float64."""
    if k == 1:
        return plane.astype(np.float64)
    K = kernels(weights, k)
    p = _mirror_pad2(plane.astype(np.float64))
    H, W = plane.shape
    # per-pixel 5x5 window min/max for the anti-ringing clamp
    wmin = p[:H, :W].copy()
    wmax = p[:H, :W].copy()
    for dy in range(5):
        for dx in range(5):
            if dy == 0 and dx == 0:
                continue
            win = p[dy : dy + H, dx : dx + W]
            np.minimum(wmin, win, out=wmin)
            np.maximum(wmax, win, out=wmax)
    out = np.empty((k * H, k * W))
    for py in range(k):
        for px in range(k):
            acc = np.zeros((H, W))
            ker = K[py, px]
            for dy in range(5):
                for dx in range(5):
                    acc += ker[dy, dx] * p[dy : dy + H, dx : dx + W]
            out[py::k, px::k] = np.clip(acc, wmin, wmax)
    return out


def upsample_channel_int(
    plane: np.ndarray, k: int, weights: np.ndarray | None = None
) -> np.ndarray:
    """Integer-plane upsampling: float kernel, round-half-away to the
    plane's dtype (modular sample planes are integer end to end)."""
    out = upsample_plane(plane, k, weights)
    if np.issubdtype(plane.dtype, np.integer):
        return np.round(out).astype(plane.dtype)
    return out.astype(plane.dtype)
