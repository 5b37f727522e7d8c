"""A plain reference of a lossy (VarDCT) JPEG XL frame's reconstruction,
from what the encoder chose, in float64 PyTorch.

It starts from the encoder's choices, not from a stream: the quantized LF,
the varblocks (their place and DctSelect) and their quantized HF
coefficients, the quantizer's settings (global scale, quant_lf, the HF
multiplier, the X and B quant-matrix scales), the chroma-from-luma
factors, the gaborish weights and the XYB constants.  The dequant weights
are the format's default tables, computed here from the format's
parameters (`default_weights`), as a frame whose dequant matrices are all
default asks.  Then, in the format's order (ISO/IEC 18181-1, chapters on
LF and HF dequantization, the DCTs, the restoration filters and XYB):

1. LF dequantization: each 8x8 cell's LF sample, the quantized value times
   m_lf / (global_scale * quant_lf) (no extra precision), then
   chroma-from-luma on the LF (X += kx_lf * Y, B += kb_lf * Y).  The LF
   smoothing is skipped, as the frame's flag (skip_adapt_lf_smooth) says.
2. HF dequantization with the quant bias: a quantized value q in [-1, 1]
   becomes q * bias[c], any other q - bias_num / q, times
   65536 / global_scale / hf_mul * qm_scale[c] / weight[position, c],
   the weight a channel's default table at the coefficient: its bands
   b_0 = p_0, b_i = b_(i-1) (1 + p_i) where p_i > 0, else
   b_(i-1) / (1 - p_i), interpolated exponentially at the coefficient's
   distance from the corner, hypot(x / (C - 1), y / (R - 1)) * (n - 1) /
   (sqrt(2) + 1e-6) in band steps.
3. Chroma from luma on the HF: X += kx_hf * Y, B += kb_hf * Y (the
   dequantized Y).
4. The LLF coefficients of each varblock (its top-left (rows/8, columns/8)
   coefficients) from the LF samples it covers: their forward DCT, scaled
   by 1 / (cos(k pi / 2^(n+4)) cos(k pi / 2^(n+3)) cos(k pi / 2^(n+2)) 2^n)
   along each axis of 2^n cells (for a DCT8, the LF sample itself).
5. The inverse DCT of each varblock size: samples = F_R^T C F_C, with F_N
   the N-point DCT-II, F[k, n] = c_k cos(pi (2n + 1) k / (2N)), c_0 = 1,
   c_k = sqrt(2), and C the (R, C) coefficient matrix (the stream's layout
   keeps the wider side as rows of the canonical buffer: C is that buffer
   when C > R, else its transpose).
6. Gaborish over the whole frame: a 3x3 blur, weights 1, w1 (edges) and w2
   (corners) a channel, normalised to sum 1, the frame's edge samples
   repeated past its edges (the half-sample mirror at one sample).
7. XYB to sRGB: (Y + X, Y - X, B) less cbrt(bias), cubed, plus bias,
   times 255 / intensity_target, through the inverse opsin matrix, then
   the sRGB transfer curve, rounded half up to 8 bits and clamped.

Departures from the format, each on purpose:
- the frame is reconstructed on its whole 8x8 grid and filtered there,
  then cropped: where a side is not a multiple of 8, the format filters the
  cropped frame (the port's ragged-edge rule, ROADMAP C.4);
- EPF is not implemented: the frames this serves write no EPF step;
- only DCT8, DCT16x16, DCT32x32, DCT16x8 and DCT8x16 varblocks are
  reconstructed (the other DctSelect classes are refused), and only with
  the default dequant tables (a frame that signals its own is not);
- only an 8-bit, three-channel frame with no extra channels is rendered.

`reconstruct` takes two switches for the controls of a comparison:
`gaborish_mode="none"` (the frame without gaborish) or "lf_groups"
(gaborish on each 2048x2048 LF group apart, its edge samples repeated at
every LF-group border), and `idct_dtype=torch.bfloat16` (the inverse
DCTs' products in bfloat16).

Plain torch and numpy only: no JAX and nothing of the decoder under test.
"""

from __future__ import annotations

import math

import numpy as np
import torch

#: the varblock shapes reconstructed, as (log2 rows, log2 columns)
SHAPES = ((3, 3), (4, 4), (5, 5), (4, 3), (3, 4))
#: an LF group's side in pixels
LF_GROUP = 2048
#: the format's default dequant parameters of those shapes, in its DCT
#: mode (ISO/IEC 18181-1, the default quantization tables; libjxl
#: lib/jxl/quant_weights.cc): by (log2 of the shorter side, log2 of the
#: longer), for X, Y and B, the first band's weight, then each later
#: band's step; DCT16x8 and DCT8x16 share one table
DEFAULT_DQ = {
    (3, 3): ((3150.0, 0.0, -0.4, -0.4, -0.4, -2.0),
             (560.0, 0.0, -0.3, -0.3, -0.3, -0.3),
             (512.0, -2.0, -1.0, 0.0, -1.0, -2.0)),
    (4, 4): ((8996.8725711814115328, -1.3000777393353804, -0.49424529824571225,
              -0.439093774457103443, -0.6350101832695744, -0.90177264050827612,
              -1.6162099239887414),
             (3191.48366296844234752, -0.67424582104194355, -0.80745813428471001,
              -0.44925837484843441, -0.35865440981033403, -0.31322389111877305,
              -0.37615025315725483),
             (1157.50408145487200256, -2.0531423165804414, -1.4, -0.50687130033378396,
              -0.42708730624733904, -1.4856834539296244, -4.9209142884401604)),
    (5, 5): ((15718.40830982518931456, -1.025, -0.98, -0.9012, -0.4, -0.48819395464,
              -0.421064, -0.27),
             (7305.7636810695983104, -0.8041958212306401, -0.7633036457487539,
              -0.55660379990111464, -0.49785304658857626, -0.43699592683512467,
              -0.40180866526242109, -0.27321683125358037),
             (3803.53173721215041536, -3.060733579805728, -2.0413270132490346,
              -2.0235650159727417, -0.5495389509954993, -0.4, -0.4, -0.3)),
    (3, 4): ((7240.7734393502, -0.7, -0.7, -0.2, -0.2, -0.2, -0.5),
             (1448.15468787004, -0.5, -0.5, -0.5, -0.2, -0.2, -0.2),
             (506.854140754517, -1.4, -0.2, -0.5, -0.5, -1.5, -3.6)),
}


def dct_matrix(n: int, device, dtype=torch.float64) -> torch.Tensor:
    """F_n: F[k, i] = c_k cos(pi (2i + 1) k / (2n)), c_0 = 1, c_k = sqrt(2)."""
    k = torch.arange(n, dtype=torch.float64, device=device)[:, None]
    i = torch.arange(n, dtype=torch.float64, device=device)[None, :]
    f = torch.cos(math.pi * (2 * i + 1) * k / (2 * n))
    f[1:] *= math.sqrt(2.0)
    return f.to(dtype)


def llf_scales(n_log: int, device) -> torch.Tensor:
    """The LLF scale of each of 2^n_log LF coefficients along one axis."""
    k = torch.arange(1 << n_log, dtype=torch.float64, device=device)
    return 1.0 / (torch.cos(k * math.pi / (1 << (n_log + 4)))
                  * torch.cos(k * math.pi / (1 << (n_log + 3)))
                  * torch.cos(k * math.pi / (1 << (n_log + 2))) * (1 << n_log))


def default_weights(shape, device) -> torch.Tensor:
    """(rows * columns, 3) float64: the default dequant weight of each HF
    coefficient of a varblock of `shape` (log2 rows, log2 columns), X, Y
    and B, in the stream's layout (the shorter side as rows)."""
    lr, lc = sorted(shape)
    R, C = 1 << lr, 1 << lc
    y = torch.arange(R, dtype=torch.float64, device=device) / (R - 1)
    x = torch.arange(C, dtype=torch.float64, device=device) / (C - 1)
    dist = torch.hypot(y[:, None], x[None, :]).reshape(-1)
    out = []
    for params in DEFAULT_DQ[(lr, lc)]:
        bands = [params[0]]
        for v in params[1:]:
            bands.append(bands[-1] * (1.0 + v) if v > 0 else bands[-1] / (1.0 - v))
        b = torch.tensor(bands, dtype=torch.float64, device=device)
        pos = dist * (len(bands) - 1) / (math.sqrt(2.0) + 1e-6)
        i = pos.floor().long()
        out.append(b[i] * (b[i + 1] / b[i]) ** (pos - i))
    return torch.stack(out, dim=1)


def _dequant_hf(q: torch.Tensor, weights: torch.Tensor, p: dict) -> torch.Tensor:
    """(m, 3, size) quantized HF -> dequantized, chroma from luma applied."""
    bias = torch.tensor(p["quant_bias"], dtype=torch.float64, device=q.device)[None, :, None]
    small = q.abs() <= 1.0
    adj = torch.where(small, q * bias, q - p["quant_bias_num"] / torch.where(q == 0, 1.0, q))
    mult = 65536.0 / p["global_scale"] / p["hf_mul"]
    qm = torch.tensor(p["qm_scales"], dtype=torch.float64, device=q.device)
    d = adj * (mult * qm)[None, :, None] / weights.T[None]
    x, y, b = d[:, 0], d[:, 1], d[:, 2]
    return torch.stack([x + p["kx_hf"] * y, y, b + p["kb_hf"] * y], dim=1)


def xyb_plane(p: dict, device, idct_dtype=torch.float64) -> torch.Tensor:
    """The frame's (3, 8*h8, 8*w8) float64 XYB samples before any filter."""
    lf_int = torch.as_tensor(np.asarray(p["lf_int"]), device=device).to(torch.float64)
    _, h8, w8 = lf_int.shape
    mlf = torch.tensor(p["m_lf_scaled"], dtype=torch.float64, device=device)
    lf = lf_int * (mlf * 65536.0 / (p["global_scale"] * p["quant_lf"]))[:, None, None]
    lf = torch.stack([lf[0] + p["kx_lf"] * lf[1], lf[1], lf[2] + p["kb_lf"] * lf[1]])
    out = torch.zeros((3, 8 * h8, 8 * w8), dtype=torch.float64, device=device)
    for shape, vb in p["varblocks"].items():
        if tuple(shape) not in SHAPES:
            raise ValueError(f"varblock shape {shape} is not reconstructed here")
        lr, lc = shape
        R, C = 1 << lr, 1 << lc
        r8, c8 = R // 8, C // 8
        y8 = torch.as_tensor(np.asarray(vb["y8"]), device=device).long()
        x8 = torch.as_tensor(np.asarray(vb["x8"]), device=device).long()
        m = len(y8)
        if m == 0:
            continue
        q = torch.as_tensor(np.asarray(vb["q"]), device=device).to(torch.float64)
        d = _dequant_hf(q, default_weights(shape, device), p)  # (m, 3, R*C), the stream's layout
        coef = d.reshape(m, 3, R, C) if C > R else d.reshape(m, 3, C, R).transpose(2, 3)
        coef = coef.clone()
        # the LLF coefficients from the LF samples the varblock covers
        ys = y8[:, None, None] + torch.arange(r8, device=device)[None, :, None]
        xs = x8[:, None, None] + torch.arange(c8, device=device)[None, None, :]
        block = lf[:, ys, xs].permute(1, 0, 2, 3)  # (m, 3, r8, c8)
        llf = dct_matrix(r8, device) @ block @ dct_matrix(c8, device).T
        llf = llf * llf_scales(lr - 3, device)[:, None] * llf_scales(lc - 3, device)[None, :]
        coef[:, :, :r8, :c8] = llf
        fr, fc = dct_matrix(R, device, idct_dtype), dct_matrix(C, device, idct_dtype)
        samples = (fr.T @ coef.to(idct_dtype) @ fc).to(torch.float64)  # (m, 3, R, C)
        rows = (8 * y8[:, None] + torch.arange(R, device=device)[None, :])[:, :, None]
        cols = (8 * x8[:, None] + torch.arange(C, device=device)[None, :])[:, None, :]
        out[:, rows, cols] = samples.permute(1, 0, 2, 3)
    return out


def gaborish(plane: torch.Tensor, weights) -> torch.Tensor:
    """The 3x3 gaborish blur of a (3, H, W) plane, edge samples repeated."""
    out = torch.empty_like(plane)
    pad = torch.nn.functional.pad(plane[None], (1, 1, 1, 1), mode="replicate")[0]
    H, W = plane.shape[1:]
    for c in range(3):
        w1, w2 = (float(v) for v in weights[c])
        s = 1.0 + 4 * w1 + 4 * w2
        p = pad[c]
        out[c] = (p[1:H + 1, 1:W + 1]
                  + w1 * (p[:H, 1:W + 1] + p[2:, 1:W + 1] + p[1:H + 1, :W] + p[1:H + 1, 2:])
                  + w2 * (p[:H, :W] + p[:H, 2:] + p[2:, :W] + p[2:, 2:])) / s
    return out


def to_srgb8(plane: torch.Tensor, p: dict) -> torch.Tensor:
    """(3, H, W) XYB -> (3, H, W) uint8 sRGB."""
    x, y, b = plane
    bias = torch.tensor(p["opsin_bias"], dtype=torch.float64, device=plane.device)
    if bias.dim() == 0:
        bias = bias.repeat(3)
    cbrt_bias = torch.sign(bias) * bias.abs() ** (1.0 / 3.0)
    mixed = torch.stack([y + x, y - x, b]) - cbrt_bias[:, None, None]
    mixed = (mixed ** 3 + bias[:, None, None]) * (255.0 / p["intensity_target"])
    inv = torch.tensor(p["opsin_inv_mat"], dtype=torch.float64, device=plane.device)
    lin = torch.einsum("ij,jhw->ihw", inv, mixed)
    v = torch.where(lin <= 0.0031308, 12.92 * lin,
                    1.055 * lin.clamp_min(1e-30) ** (1 / 2.4) - 0.055)
    return torch.floor(255.0 * v + 0.5).clamp(0, 255).to(torch.uint8)


def reconstruct(p: dict, device="cpu", gaborish_mode: str = "frame",
                idct_dtype=torch.float64) -> torch.Tensor:
    """The frame as (height, width, 4) uint8 RGBA (alpha 255) on `device`.

    `p` holds the encoder's choices: width, height, lf_int (3, h8, w8)
    XYB; varblocks {(log2 rows, log2 columns): {y8, x8, q (m, 3, rows *
    columns) XYB in the stream's coefficient layout}}; m_lf_scaled (3), global_scale, quant_lf, hf_mul,
    qm_scales (3), quant_bias (3), quant_bias_num, kx_lf, kb_lf, kx_hf,
    kb_hf; gab_weights ([w1, w2] a channel, or None: no gaborish);
    opsin_inv_mat (3x3), opsin_bias, intensity_target.  `gaborish_mode`
    "frame" (the format), "none" or "lf_groups"; `idct_dtype` the inverse
    DCTs' precision (the module's docstring)."""
    with _no_tf32():
        plane = xyb_plane(p, device, idct_dtype)
        gab = p.get("gab_weights")
        if gab is not None and gaborish_mode == "frame":
            plane = gaborish(plane, gab)
        elif gab is not None and gaborish_mode == "lf_groups":
            out = torch.empty_like(plane)
            _, H, W = plane.shape
            for y0 in range(0, H, LF_GROUP):
                for x0 in range(0, W, LF_GROUP):
                    sl = (slice(None), slice(y0, y0 + LF_GROUP), slice(x0, x0 + LF_GROUP))
                    out[sl] = gaborish(plane[sl], gab)
            plane = out
        elif gaborish_mode not in ("frame", "none", "lf_groups"):
            raise ValueError(f"gaborish_mode {gaborish_mode!r}")
        rgb = to_srgb8(plane, p)[:, : p["height"], : p["width"]]
    out = torch.full((p["height"], p["width"], 4), 255, dtype=torch.uint8, device=device)
    out[..., :3] = rgb.permute(1, 2, 0)
    return out


class _no_tf32:
    """TF32 off for the block (float64 products never take it; the switch
    keeps a float32 caller's setting from reaching a later change here)."""

    def __enter__(self):
        self.old = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32 = self.old
        return False
