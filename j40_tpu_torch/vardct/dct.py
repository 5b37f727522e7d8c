"""DCT library (reference j40.h:5657-6248; Perera-Liu self-recursive radix-2
DCT-II/III).

Two forms are provided:
- the recursion itself (numpy, float32) — the correctness oracle matching the
  reference's operation order;
- dense matrix operators built FROM the recursion — what the TPU path uses:
  an NxM inverse DCT becomes two MXU matmuls (basis.T @ C @ basis), batched
  over varblocks (see j40_tpu.ops.dct_kernels).

Conventions (j40.h:5944-5990): coefficients for non-square blocks are stored
transposed so that width >= height; inverse_dct2d(buf, lr, lc) consumes that
layout and emits row-major (2^lr, 2^lc) samples.
"""

from __future__ import annotations

import functools

import numpy as np

SQRT2 = np.float32(1.4142135623730951)


@functools.lru_cache(maxsize=None)
def half_secants(n: int) -> np.ndarray:
    """[k] = 1/(2 cos((k+0.5)/2^(n+1) pi)) for 0 <= k < 2^n (j40.h:5690)."""
    k = np.arange(1 << n)
    return (0.5 / np.cos((k + 0.5) / (1 << (n + 1)) * np.pi)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def lf2llf_scales(n_log: int) -> np.ndarray:
    """[k] = 1/(cos(k pi/2^(n_log+4)) cos(k pi/2^(n_log+3)) cos(k pi/2^(n_log+2)) 2^n_log)."""
    n = 1 << n_log
    k = np.arange(n)
    v = 1.0 / (
        np.cos(k * np.pi / (1 << (4 + n_log)))
        * np.cos(k * np.pi / (1 << (3 + n_log)))
        * np.cos(k * np.pi / (1 << (2 + n_log)))
        * n
    )
    return v.astype(np.float32)


def _forward_dct_1d(x: np.ndarray) -> np.ndarray:
    """Unscaled forward DCT-II along axis 0 (j40.h:5764-5800); x: (N, ...)."""
    N = x.shape[0]
    if N == 1:
        return x.copy()
    if N == 2:
        return np.stack([x[0] + x[1], x[0] - x[1]])
    hs = half_secants(int(np.log2(N)) - 1)
    half = N // 2
    a = x[:half]
    b = x[half:][::-1]
    lo = _forward_dct_1d(a + b)
    hi = _forward_dct_1d(((a - b).T * hs).T)
    out = np.empty_like(x)
    out[0::2] = lo
    # B matrix: out[1] = sqrt2*hi[0] + hi[1]; out[2i+1] = hi[i] + hi[i+1]; last = hi[-1]
    out[1] = SQRT2 * hi[0] + (hi[1] if half > 1 else 0)
    for i in range(1, half - 1):
        out[i * 2 + 1] = hi[i] + hi[i + 1]
    if half > 1:
        out[N - 1] = hi[half - 1]
    return out


def _inverse_dct_1d(x: np.ndarray) -> np.ndarray:
    """Inverse of _forward_dct_1d scaled such that
    inverse(forward(v)/N) == v (j40.h:5802-5841)."""
    N = x.shape[0]
    if N == 1:
        return x.copy()
    if N == 2:
        return np.stack([x[0] + x[1], x[0] - x[1]])
    hs = half_secants(int(np.log2(N)) - 1)
    half = N // 2
    lo_in = x[0::2]
    hi_in = np.empty_like(lo_in)
    hi_in[0] = SQRT2 * x[1]
    for i in range(1, half):
        hi_in[i] = x[i * 2 - 1] + x[i * 2 + 1]
    lo = _inverse_dct_1d(lo_in)
    hi = _inverse_dct_1d(hi_in)
    hi = (hi.T * hs).T
    out = np.empty_like(x)
    out[:half] = lo + hi
    out[half:] = (lo - hi)[::-1]
    return out


@functools.lru_cache(maxsize=None)
def forward_matrix(n: int) -> np.ndarray:
    """Matrix F with F @ x == unscaled forward DCT (float32, from recursion)."""
    return _forward_dct_1d(np.eye(n, dtype=np.float32))


@functools.lru_cache(maxsize=None)
def inverse_matrix(n: int) -> np.ndarray:
    """Matrix G with G @ c == inverse DCT; G == n * F^-1."""
    return _inverse_dct_1d(np.eye(n, dtype=np.float32))


def inverse_dct2d(coeffs: np.ndarray, log_rows: int, log_columns: int) -> np.ndarray:
    """Inverse 2-D DCT (j40.h:5972-5990).

    `coeffs` is flat, in the canonical (possibly transposed) layout of size
    2^(lr+lc); returns (2^lr, 2^lc) samples.
    """
    rows, columns = 1 << log_rows, 1 << log_columns
    # canonical storage W is (2^min, 2^max) row-major; the (rows, columns)
    # coefficient matrix C is W when columns > rows, else W^T (this includes
    # square blocks, j40.h:5978-5985)
    if log_columns > log_rows:
        c = coeffs.reshape(rows, columns)
    else:
        c = coeffs.reshape(columns, rows).T
    # samples = G_rows @ C @ G_columns^T
    out = inverse_matrix(rows) @ c @ inverse_matrix(columns).T
    return out.astype(np.float32)


def forward_dct2d_scaled_for_llf(lf: np.ndarray) -> np.ndarray:
    """Forward DCT of the (vh8, vw8) dequantized LF block, scaled for LLF
    coefficients (j40.h:5944-5970).  Returns flat (vh8*vw8,) in the canonical
    transposed layout (width >= height)."""
    vh8, vw8 = lf.shape
    f = forward_matrix(vh8) @ lf.astype(np.float32) @ forward_matrix(vw8).T
    log_r = int(np.log2(vh8))
    log_c = int(np.log2(vw8))
    f = f * lf2llf_scales(log_r)[:, None] * lf2llf_scales(log_c)[None, :]
    if vw8 <= vh8:  # canonical layout transposes when columns <= rows
        f = f.T
    return np.ascontiguousarray(f).ravel()
