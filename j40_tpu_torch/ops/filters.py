"""Restoration filters: gaborish and EPF (reference j40.h:7251-7624).

The reference implements both but never invokes them (README: "currently
ignored"); we implement them faithfully AND wire them into the decode
pipeline behind `Decoder(apply_filters=True)`.  Filters operate on the XYB
sample planes of one LF group with mirrored borders (the reference's
`j40__epf` asserts group-sized planes), which keeps the sharded multi-group
pipeline collective-free; spec-style whole-image filtering would need a halo
exchange between neighboring groups.

Two halves: numpy (the oracle; the host plan and the numpy reconstruction
use it) and plain PyTorch on tensors of any device (the counterpart of the
JAX package's XLA filters, kept in lockstep with it).  The torch half is
what the CUDA kernels of ops/filter_kernels.py are held against;
`Decoder(backend="torch", apply_filters=True)` runs those kernels.

NOTE: the reference's EPF distance tables index kernels as (dx, dy) while
its sampling step uses (dy, dx); being dead code this was likely never
noticed — we replicate the reference behavior exactly.
"""

from __future__ import annotations

import numpy as np
import torch

# kernel tables (j40.h:7579-7583), in the reference's (k0, k1) order
KERNELS12 = (
    (0, -2), (-1, -1), (-1, 0), (-1, 1), (0, -2), (0, -1), (0, 1), (0, 2),
    (-1, 1), (-1, 0), (-1, 1), (0, 2),
)
KERNELS4 = ((0, -1), (-1, 0), (1, 0), (0, 1))

SIGMA_THRESHOLD = 0.3
POS_MULT = 1.9330952441687859  # -1.65 * 4 * (sqrt(0.5) - 1)


def _mirror_index(coords: np.ndarray, size: int) -> np.ndarray:
    c = coords.copy()
    while True:
        neg = c < 0
        over = c >= size
        if not (neg.any() or over.any()):
            return c
        c = np.where(neg, -c - 1, c)
        c = np.where(over, size * 2 - 1 - c, c)


def gaborish(channels: np.ndarray, weights) -> np.ndarray:
    """3x3 normalized blur with per-channel weights (j40.h:7271-7326).

    channels: (3, H, W) float32; weights: [(w1, w2)] * 3.  Borders use edge
    replication (the reference's incremental line handling is equivalent)."""
    out = np.empty_like(channels)
    for c in range(3):
        w0 = 1.0
        w1, w2 = weights[c]
        wsum = np.float32(w0 + w1 * 4 + w2 * 4)
        w0, w1, w2 = (np.float32(w0) / wsum, np.float32(w1) / wsum,
                      np.float32(w2) / wsum)
        p = np.pad(channels[c], 1, mode="edge").astype(np.float32)
        out[c] = (
            p[:-2, :-2] * w2 + p[:-2, 1:-1] * w1 + p[:-2, 2:] * w2
            + p[1:-1, :-2] * w1 + p[1:-1, 1:-1] * w0 + p[1:-1, 2:] * w1
            + p[2:, :-2] * w2 + p[2:, 1:-1] * w1 + p[2:, 2:] * w2
        )
    return out


def _mirror_pad(img: np.ndarray, pad: int) -> np.ndarray:
    """Pad with the reference's mirror1d convention (half-sample mirror)."""
    h, w = img.shape
    ys = _mirror_index(np.arange(-pad, h + pad), h)
    xs = _mirror_index(np.arange(-pad, w + pad), w)
    return img[np.ix_(ys, xs)]


def epf_recip_sigmas(vs, gg) -> np.ndarray | None:
    """Per-8x8-block f(sigma) plane (j40.h:7374-7427); None for modular."""
    f = vs.fs.f
    # NOTE: the reference rejects a zero quant*sharp_lut entry with "epf0"
    # (j40.h:7384) — but the DEFAULT sharp_lut[0] is 0, so its EPF could never
    # run.  libjxl's semantics: sigma below the threshold skips the block, so
    # a zero entry maps to "skip" (recip = -1 via the 1/0.3 clamp below).
    lut = np.array([f.epf_quant_mul * s for s in f.epf_sharp_lut], dtype=np.float32)
    with np.errstate(divide="ignore"):
        inv_lut = np.where(lut > 0, 1.0 / np.where(lut > 0, lut, 1.0), np.float32(np.inf))
    sharp = np.asarray(gg.sharpness)
    if (sharp & ~7).any() or (sharp < 0).any():
        from ..errors import J40Error

        raise J40Error("shrp")
    rs = inv_lut[sharp & 7]
    voff = np.asarray(gg.blocks) & 0xFFFFF
    rs = rs * gg.vb_hfmul_inv[voff]
    rs = np.where(rs > 1.0 / SIGMA_THRESHOLD, np.float32(-1.0), rs).astype(np.float32)
    return rs


def epf_step(
    channels: np.ndarray,        # (3, H, W)
    sigma_scale: float,
    recip_sigmas: np.ndarray | None,  # (H8, W8) or None (modular)
    kernels,
    dist_uses_cross: bool,
    channel_scale,
    border_sad_mul: float,
    sigma_for_modular: float = 1.0,
) -> np.ndarray:
    """One EPF pass (j40.h:7429-7576), vectorized numpy."""
    _, H, W = channels.shape
    if recip_sigmas is None:
        if sigma_for_modular < SIGMA_THRESHOLD:
            return channels
        recip = np.full(((H + 7) // 8, (W + 7) // 8), 1.0 / sigma_for_modular,
                        dtype=np.float32)
    else:
        recip = recip_sigmas

    sigma_scale = np.float32(sigma_scale * POS_MULT)
    border_scale = np.float32(sigma_scale * border_sad_mul)

    # per-pixel recip sigma and border flag
    ys = np.arange(H)
    xs = np.arange(W)
    rs_px = recip[np.minimum(ys // 8, recip.shape[0] - 1)[:, None],
                  np.minimum(xs // 8, recip.shape[1] - 1)[None, :]]
    border = ((((xs[None, :] + 1) | (ys[:, None] + 1)) & 7) < 2)
    inv_sigma_pos = np.where(border, rs_px * border_scale, rs_px * sigma_scale)

    # distance planes: D[k][c] with shape (H+2, W+2):
    # D(x+1, y+1) = |in(x, y) - in(x+dx, y+dy)| with dx=k0, dy=k1 (j40.h:7471)
    pad3 = np.stack([_mirror_pad(channels[c], 3) for c in range(3)])  # (3, H+6, W+6)
    nk = len(kernels)
    D = np.empty((nk, 3, H + 2, W + 2), dtype=np.float32)
    for k, (k0, k1) in enumerate(kernels):
        dx, dy = k0, k1  # reference passes (kernels[k][0], kernels[k][1]) as (dx, dy)
        base = pad3[:, 2 : 2 + H + 2, 2 : 2 + W + 2]
        off = pad3[:, 2 + dy : 2 + dy + H + 2, 2 + dx : 2 + dx + W + 2]
        D[k] = np.abs(base - off)

    scale = np.asarray(channel_scale, dtype=np.float32)
    # cross taps around (y+1, x+1) in D-coordinates
    sum_weights = np.ones((H, W), dtype=np.float32)
    sum_channels = channels.astype(np.float32).copy()
    pad2 = pad3[:, 1:-1, 1:-1]  # (3, H+4, W+4), offset 2

    for k, (k0, k1) in enumerate(kernels):
        if dist_uses_cross:
            dist = np.zeros((H, W), dtype=np.float32)
            for c in range(3):
                d = D[k][c]
                dist += scale[c] * (
                    d[1 : 1 + H, 1 : 1 + W]
                    + d[1 : 1 + H, 0:W] + d[0:H, 1 : 1 + W]
                    + d[2 : 2 + H, 1 : 1 + W] + d[1 : 1 + H, 2 : 2 + W]
                )
        else:
            dist = np.zeros((H, W), dtype=np.float32)
            for c in range(3):
                dist += scale[c] * D[k][c][1 : 1 + H, 1 : 1 + W]
        weight = np.maximum(np.float32(0.0), np.float32(1.0) + dist * inv_sigma_pos)
        sum_weights += weight
        # sampling uses (dy=k0, dx=k1) — note the transposition vs distances
        dy, dx = k0, k1
        shifted = pad2[:, 2 + dy : 2 + dy + H, 2 + dx : 2 + dx + W]
        sum_channels += shifted * weight[None]

    out = sum_channels / sum_weights[None]
    # pixels in skipped blocks (recip < 0) are left untouched
    skip = rs_px < 0.0
    return np.where(skip[None], channels, out).astype(np.float32)


def epf(channels: np.ndarray, vs, gg, is_modular: bool = False) -> np.ndarray:
    """Full EPF (up to 3 steps, j40.h:7578-7622)."""
    f = vs.fs.f
    if f.epf_iters <= 0:
        return channels
    recip = None if is_modular else epf_recip_sigmas(vs, gg)
    kw = dict(
        channel_scale=f.epf_channel_scale,
        border_sad_mul=f.epf_border_sad_mul,
        sigma_for_modular=f.epf_sigma_for_modular,
    )
    if f.epf_iters >= 3:
        channels = epf_step(channels, f.epf_pass0_sigma_scale, recip, KERNELS12,
                            True, **kw)
    if f.epf_iters >= 1:
        channels = epf_step(channels, 1.0, recip, KERNELS4, True, **kw)
    if f.epf_iters >= 2:
        channels = epf_step(channels, f.epf_pass2_sigma_scale, recip, KERNELS4,
                            False, **kw)
    return channels


# ---------------------------------------------------------------- torch path


def _mirror_on(n: int, pad: int, device) -> torch.Tensor:
    """Half-sample mirror indices of [-pad, n + pad) as a tensor."""
    return torch.from_numpy(_mirror_index(np.arange(-pad, n + pad), n)).to(device)


def gaborish_torch(channels: torch.Tensor, weights) -> torch.Tensor:
    """Plain PyTorch gaborish (counterpart of gaborish_jax): (3, H, W)
    float32 in and out, weights normalized in double precision as there."""
    p = torch.nn.functional.pad(channels[None], (1, 1, 1, 1), mode="replicate")[0]
    return gaborish_taps(p, weights)


def gaborish_taps(p: torch.Tensor, weights) -> torch.Tensor:
    """The 3x3 gaborish sums of a (3, H + 2, W + 2) plane whose border
    rows and columns are already in place (a pad, or a row shard's halo
    rows): (3, H, W), rows top to bottom, each left to right."""
    norm = []
    for c in range(3):
        w1, w2 = weights[c]
        wsum = 1.0 + w1 * 4 + w2 * 4
        norm.append((1.0 / wsum, w1 / wsum, w2 / wsum))
    w0n, w1n, w2n = (torch.tensor([n[i] for n in norm], dtype=torch.float32,
                                  device=p.device).view(3, 1, 1)
                     for i in range(3))
    return (
        p[:, :-2, :-2] * w2n + p[:, :-2, 1:-1] * w1n + p[:, :-2, 2:] * w2n
        + p[:, 1:-1, :-2] * w1n + p[:, 1:-1, 1:-1] * w0n + p[:, 1:-1, 2:] * w1n
        + p[:, 2:, :-2] * w2n + p[:, 2:, 1:-1] * w1n + p[:, 2:, 2:] * w2n
    )


def step_scales(sigma_scale: float, border_sad_mul: float) -> tuple[float, float]:
    """The fp32 sigma scales of one EPF step, inside and on the border of
    an 8x8 block (as _epf_step_jax_rows forms them)."""
    ss = np.float32(sigma_scale * POS_MULT)
    return float(ss), float(ss * np.float32(border_sad_mul))


def _epf_step_torch(channels, rs_px, sigma_scale: float, kernels,
                    dist_uses_cross: bool, channel_scale, border_sad_mul: float):
    """One EPF pass in plain PyTorch (counterpart of _epf_step_jax):
    channels (3, H, W) float32, rs_px (H, W) per-pixel reciprocal sigma,
    negative where the block is skipped."""
    rows = channels[:, _mirror_on(channels.shape[1], 3, channels.device)]
    return _epf_step_torch_rows(rows, channels, rs_px, 0, sigma_scale, kernels,
                                dist_uses_cross, channel_scale, border_sad_mul)


def _epf_step_torch_rows(rows, channels, rs_px, y0: int, sigma_scale: float,
                         kernels, dist_uses_cross: bool, channel_scale,
                         border_sad_mul: float):
    """EPF pass given 3 halo rows on each side (counterpart of
    _epf_step_jax_rows): rows (3, H + 6, W), channels = rows[:, 3:-3], y0 the
    global row of row 0 (for the 8x8 border flag)."""
    _, H, W = channels.shape
    dev = channels.device
    ss, bs = step_scales(sigma_scale, border_sad_mul)
    ys = y0 + torch.arange(H, device=dev)
    xs = torch.arange(W, device=dev)
    border = (((xs[None, :] + 1) | (ys[:, None] + 1)) & 7) < 2
    inv_sigma = torch.where(border, rs_px * bs, rs_px * ss)

    pad3 = rows[:, :, _mirror_on(W, 3, dev)]  # (3, H + 6, W + 6)
    pad2 = pad3[:, 1:-1, 1:-1]
    base = pad3[:, 2: 2 + H + 2, 2: 2 + W + 2]
    scale = [float(np.float32(s)) for s in channel_scale]
    sum_weights = torch.ones((H, W), dtype=torch.float32, device=dev)
    sum_channels = channels
    for k0, k1 in kernels:
        dx, dy = k0, k1  # distances use (dx, dy) = (k0, k1); see epf_step
        d = (base - pad3[:, 2 + dy: 2 + dy + H + 2, 2 + dx: 2 + dx + W + 2]).abs()
        dist = torch.zeros((H, W), dtype=torch.float32, device=dev)
        for c in range(3):
            dc = d[c]
            if dist_uses_cross:
                dist = dist + scale[c] * (
                    dc[1: 1 + H, 1: 1 + W]
                    + dc[1: 1 + H, 0:W] + dc[0:H, 1: 1 + W]
                    + dc[2: 2 + H, 1: 1 + W] + dc[1: 1 + H, 2: 2 + W]
                )
            else:
                dist = dist + scale[c] * dc[1: 1 + H, 1: 1 + W]
        weight = torch.clamp_min(1.0 + dist * inv_sigma, 0.0)
        sum_weights = sum_weights + weight
        dy, dx = k0, k1  # sampling transposes the taps (reference parity)
        sum_channels = sum_channels + pad2[:, 2 + dy: 2 + dy + H,
                                           2 + dx: 2 + dx + W] * weight[None]
    out = sum_channels / sum_weights[None]
    return torch.where((rs_px < 0.0)[None], channels, out)


def epf_step_list(iters: int, p0_scale: float, p2_scale: float) -> list:
    """The EPF steps of a frame, in order: (sigma_scale, kernels, cross)."""
    steps = []
    if iters >= 3:
        steps.append((p0_scale, KERNELS12, True))
    if iters >= 1:
        steps.append((1.0, KERNELS4, True))
    if iters >= 2:
        steps.append((p2_scale, KERNELS4, False))
    return steps


def epf_steps_torch(channels, rs_px, *, iters: int, channel_scale,
                    p0_scale: float, p2_scale: float, border_sad_mul: float):
    """Up to three EPF steps in plain PyTorch (counterpart of _epf_steps_jit)."""
    for ss, kernels, cross in epf_step_list(iters, p0_scale, p2_scale):
        channels = _epf_step_torch(channels, rs_px, ss, kernels, cross,
                                   channel_scale, border_sad_mul)
    return channels


def epf_params(f) -> dict:
    """A frame's EPF parameters as keyword arguments of epf_steps_torch."""
    return dict(
        iters=int(f.epf_iters),
        channel_scale=tuple(float(s) for s in f.epf_channel_scale),
        p0_scale=float(f.epf_pass0_sigma_scale),
        p2_scale=float(f.epf_pass2_sigma_scale),
        border_sad_mul=float(f.epf_border_sad_mul),
    )


def epf_rs8(vs, gg, H: int, W: int, is_modular: bool) -> np.ndarray | None:
    """Per-8x8-block reciprocal sigmas of an (H, W) plane; None when EPF
    leaves a modular plane as it is."""
    f = vs.fs.f
    if not is_modular:
        return epf_recip_sigmas(vs, gg)
    if f.epf_sigma_for_modular < SIGMA_THRESHOLD:
        return None
    return np.full(((H + 7) // 8, (W + 7) // 8), 1.0 / f.epf_sigma_for_modular,
                   dtype=np.float32)


def rs_per_pixel(rs8: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(H, W) per-pixel reciprocal sigma from the per-block plane."""
    return rs8.repeat_interleave(8, 0).repeat_interleave(8, 1)[:H, :W]


def epf_torch(channels, vs, gg, is_modular: bool = False):
    """Plain PyTorch EPF of a (3, H, W) tensor (counterpart of epf_jax); the
    per-block sigma plane is computed on the host.  The decode path runs the
    kernels instead (ops/filter_kernels.py)."""
    f = vs.fs.f
    if f.epf_iters <= 0:
        return channels
    _, H, W = channels.shape
    rs8 = epf_rs8(vs, gg, H, W, is_modular)
    if rs8 is None:
        return channels
    rs_px = rs_per_pixel(torch.from_numpy(rs8).to(channels.device), H, W)
    return epf_steps_torch(channels, rs_px, **epf_params(f))
