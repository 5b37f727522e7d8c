"""Device-side VarDCT reconstruction in plain PyTorch (float32).

Counterpart of j40_tpu/ops/reconstruct.py.  The host entropy stage produces,
per LF group, dense per-class batches of quantized coefficients; everything
after that — dequantization, chroma-from-luma, batched IDCT, XYB→sRGB — is
tensor code here.  These functions are also the building blocks of the
plain versions that ops/kernels.py holds beside each CUDA kernel.

- The IDCT of an (N, r, c) batch is two products against small basis
  matrices (fp32; TF32 stays off, see ops/kernels.resolve_device).
- The per-block scalars (HfMul^-1, CfL factors) broadcast along the batch
  dim.
"""

from __future__ import annotations

import numpy as np
import torch

from ..streams import device_cache
from ..vardct.dct import forward_matrix, inverse_matrix, lf2llf_scales


@device_cache(maxsize=None)
def _matrix(kind: str, n: int, device: torch.device) -> torch.Tensor:
    """Basis matrices on `device`, made once per (kind, size, device) and
    read by decodes on several streams."""
    mats = {"g": inverse_matrix, "f": forward_matrix}
    return torch.from_numpy(np.ascontiguousarray(mats[kind](n))).to(device)


@device_cache(maxsize=None)
def _llf_scales(log_rows: int, log_columns: int,
                device: torch.device) -> torch.Tensor:
    s = lf2llf_scales(log_rows - 3)[:, None] * lf2llf_scales(log_columns - 3)[None, :]
    return torch.from_numpy(np.ascontiguousarray(s)).to(device)


def idct2d_batch(coeffs: torch.Tensor, log_rows: int, log_columns: int) -> torch.Tensor:
    """Batched inverse 2-D DCT.

    coeffs: (N, size) canonical-layout coefficients; returns (N, rows, cols).
    """
    rows, columns = 1 << log_rows, 1 << log_columns
    if log_columns > log_rows:
        c = coeffs.reshape(-1, rows, columns)
    else:
        c = coeffs.reshape(-1, columns, rows).transpose(1, 2)
    Gr = _matrix("g", rows, coeffs.device)
    Gc = _matrix("g", columns, coeffs.device)
    return torch.matmul(torch.matmul(Gr, c), Gc.T)


def llf_forward_batch(lf_blocks: torch.Tensor, log_rows: int, log_columns: int) -> torch.Tensor:
    """Batched scaled forward DCT of dequantized LF blocks
    (device dual of vardct.dct.forward_dct2d_scaled_for_llf).

    lf_blocks: (N, vh8, vw8); returns (N, vh8*vw8) canonical flat.
    """
    vh8, vw8 = 1 << (log_rows - 3), 1 << (log_columns - 3)
    F_r = _matrix("f", vh8, lf_blocks.device)
    F_c = _matrix("f", vw8, lf_blocks.device)
    f = torch.matmul(torch.matmul(F_r, lf_blocks), F_c.T)
    f = f * _llf_scales(log_rows, log_columns, lf_blocks.device)[None]
    if vw8 <= vh8:
        f = f.transpose(1, 2)
    return f.reshape(f.shape[0], -1)


def dequant_hf_batch(
    q: torch.Tensor,          # (3, N, size) raw decoded coefficient sums
    weights: torch.Tensor,    # (size, 3) dequant weight table for this class
    hfmul_inv: torch.Tensor,  # (N,)
    global_scale_inv,         # scalar 65536/global_scale
    qm_scales: torch.Tensor,  # (3,) [x_qm, 1, b_qm]
    quant_bias: torch.Tensor,  # (3,)
    quant_bias_num,           # scalar
) -> torch.Tensor:
    """Quant-bias adjustment + dequantization (j40.h:7053-7097)."""
    small = q.abs() <= 1.0
    safe = torch.where(q == 0, torch.ones_like(q), q)
    adj = torch.where(small, q * quant_bias[:, None, None], q - quant_bias_num / safe)
    mult = (global_scale_inv * qm_scales)[:, None, None] * hfmul_inv[None, :, None]
    return adj * mult / weights.T[:, None, :]


def cfl_batch(coeffs: torch.Tensor, kx: torch.Tensor, kb: torch.Tensor) -> torch.Tensor:
    """Chroma-from-luma: X += Y*kx, B += Y*kb per block (j40.h:7152-7175).

    coeffs: (3, N, size) in XYB order; kx/kb: (N,)."""
    x = coeffs[0] + coeffs[1] * kx[:, None]
    b = coeffs[2] + coeffs[1] * kb[:, None]
    return torch.stack([x, coeffs[1], b])


def xyb_to_srgb_u8(
    samples: torch.Tensor,     # (3, H, W) XYB
    opsin_inv: torch.Tensor,   # (3, 3)
    opsin_bias: torch.Tensor,  # (3,)
    itscale,                   # scalar 255/intensity_target
    maxval,                    # scalar (1<<bpp)-1
) -> torch.Tensor:
    """XYB → linear sRGB → gamma → quantized int planes (j40.h:7208-7241).

    Returns (3, H, W) int32 (pre-clamp, matching the reference's cast)."""
    X, Y, B = samples[0], samples[1], samples[2]
    p = torch.stack([Y + X, Y - X, B])
    cbrt_bias = torch.sign(opsin_bias) * opsin_bias.abs().pow(1.0 / 3.0)
    pp = p - cbrt_bias[:, None, None]
    mixed = (pp * pp * pp + opsin_bias[:, None, None]) * itscale
    v = torch.einsum("cd,dhw->chw", opsin_inv, mixed)
    srgb = torch.where(
        v <= 0.0031308,
        12.92 * v,
        1.055 * torch.pow(torch.clamp_min(v, 1e-30), 1.0 / 2.4) - 0.055,
    )
    # float -> int32 truncates toward zero, as the reference's cast does
    return (maxval * srgb + 0.5).to(torch.int32)


def smooth_lf(lfquant: torch.Tensor, inv_m_lf: torch.Tensor) -> torch.Tensor:
    """Adaptive LF smoothing, 3x3 self-gating stencil (j40.h:6492-6542).

    lfquant: (3, H8, W8); edges pass through.  Per-LF-group local: no
    cross-group halo is needed (the stencil never crosses the group edge)."""
    W0, W1, W2 = 0.05226273532324128, 0.20345139757231578, 0.0334829185968739
    q = lfquant
    wa = (
        q[:, :-2, :-2] * W2 + q[:, :-2, 1:-1] * W1 + q[:, :-2, 2:] * W2
        + q[:, 1:-1, :-2] * W1 + q[:, 1:-1, 1:-1] * W0 + q[:, 1:-1, 2:] * W1
        + q[:, 2:, :-2] * W2 + q[:, 2:, 1:-1] * W1 + q[:, 2:, 2:] * W2
    )
    center = q[:, 1:-1, 1:-1]
    diff = (wa - center).abs() * inv_m_lf[:, None, None]
    gap = torch.clamp_min(diff.amax(dim=0), 0.5)
    gap = torch.clamp_min(3.0 - 4.0 * gap, 0.0)
    sm = (wa - center) * gap[None] + center
    out = q.clone()
    out[:, 1:-1, 1:-1] = sm
    return out


def reconstruct_dct8_plane(
    coeffs: np.ndarray,      # (3, N, 64) raw coefficients, N = h8*w8 raster
    llf: np.ndarray,         # (3, N) dequantized LF (one per block)
    hfmul_inv: np.ndarray,   # (N,)
    kx: np.ndarray,          # (N,) per-block CfL factors
    kb: np.ndarray,
    weights: np.ndarray,     # (64, 3)
    consts: dict,
    h8: int,
    w8: int,
    device=None,
):
    """Full pipeline for the all-DCT8x8 case on `device` (CUDA unless the
    caller names another): returns (3, H, W) int32 sRGB-quantized planes."""
    from .kernels import resolve_device

    dev = resolve_device(device)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)

    return _reconstruct_dct8_jit(
        t(coeffs), t(llf), t(hfmul_inv), t(kx), t(kb), t(weights),
        t(consts["global_scale_inv"]),
        t(consts["qm_scales"]),
        t(consts["quant_bias"]),
        t(consts["quant_bias_num"]),
        t(consts["opsin_inv"]),
        t(consts["opsin_bias"]),
        t(consts["itscale"]),
        t(consts["maxval"]),
        h8,
        w8,
    )


def _reconstruct_dct8_jit(
    coeffs, llf, hfmul_inv, kx, kb, weights,
    global_scale_inv, qm_scales, quant_bias, quant_bias_num,
    opsin_inv, opsin_bias, itscale, maxval, h8, w8,
):
    """Body of the JAX package's entry(): dequant + CfL + LLF + IDCT +
    XYB→sRGB for an all-DCT8x8 plane (the name keeps its counterpart's;
    PyTorch runs it eagerly)."""
    deq = dequant_hf_batch(
        coeffs, weights, hfmul_inv, global_scale_inv, qm_scales,
        quant_bias, quant_bias_num,
    )
    cf = cfl_batch(deq, kx, kb)
    # LLF substitution at canonical position 0
    cf[:, :, 0] = llf
    blocks = idct2d_batch(cf.reshape(-1, 64), 3, 3).reshape(3, h8 * w8, 8, 8)
    # (3, h8*w8, 8, 8) -> (3, H, W)
    samples = (
        blocks.reshape(3, h8, w8, 8, 8)
        .permute(0, 1, 3, 2, 4)
        .reshape(3, h8 * 8, w8 * 8)
    )
    return xyb_to_srgb_u8(samples, opsin_inv, opsin_bias, itscale, maxval)
