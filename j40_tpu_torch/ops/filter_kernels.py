"""The three CUDA kernels of the restoration filters, their plain PyTorch
versions and their wrappers.

Counterpart of j40_tpu/ops/pallas_filters.py; the kernels themselves are in
csrc/filters.cu.  As in ops/kernels.py, each wrapper takes a CUDA tensor to
its kernel (or raises) and a CPU tensor to its plain version, built from the
torch half of ops/filters.py; nothing falls back from a failed build or
launch.  Launches count in `kernels.launches`.

| wrapper       | plain version     | TPU kernel replaced                  |
| epf_step      | epf_step_ref      | pallas_filters._epf_step_kernel (B7) |
| epf_step_rows | epf_step_rows_ref | the same, through epf_step_pallas_rows |
| epf_fused     | epf_fused_ref     | pallas_filters._epf_fused_kernel (B8) |
| gaborish      | gaborish_ref      | pallas_filters._gaborish_kernel (B9) |
| gaborish_rows | gaborish_rows_ref | the same kernel, for sharded_filters._gaborish_rows |

Every plane is (3, H, W) float32; EPF reads its reciprocal sigmas per 8x8
block, `rs8` of shape (ceil(H/8), ceil(W/8)), negative where the block is
skipped.  An EPF step is (sigma_scale, kind) with kind 0 = 12-tap cross,
1 = 4-tap cross, 2 = 4-tap plain (csrc/filters.cu StepKind).  The `_rows`
entries filter one row shard of a sharded decode (ops/sharded_filters.py):
their input is the shard's stripe, its H rows between halo rows that came
from the neighbouring shards (3 a side for EPF, 1 for gaborish), and they
return (3, H, W); the columns mirror (EPF) or replicate (gaborish) as on a
plane.  A shard starts on a multiple of 8 rows of the image, so the 8x8
border flag and the block sigmas are its own.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import filters as F
from . import kernels as K

STEP_KERNELS = {0: (F.KERNELS12, True), 1: (F.KERNELS4, True), 2: (F.KERNELS4, False)}
_STEP_KIND = {v: k for k, v in STEP_KERNELS.items()}


class _EpfParams(ctypes.Structure):
    """csrc/filters.cu J40ttEpfParams."""
    _fields_ = [
        ("nsteps", ctypes.c_int), ("kind", ctypes.c_int * 3),
        ("sigma_scale", ctypes.c_float * 3), ("border_scale", ctypes.c_float * 3),
        ("channel_scale", ctypes.c_float * 3),
    ]


def _params(steps, channel_scale, border_sad_mul) -> _EpfParams:
    p = _EpfParams()
    p.nsteps = len(steps)
    for s, (sigma_scale, kind) in enumerate(steps):
        p.kind[s] = kind
        p.sigma_scale[s], p.border_scale[s] = F.step_scales(sigma_scale, border_sad_mul)
    for c in range(3):
        p.channel_scale[c] = channel_scale[c]
    return p


def frame_steps(iters: int, p0_scale: float, p2_scale: float) -> tuple:
    """A frame's EPF steps as (sigma_scale, kind), in order."""
    return tuple((ss, _STEP_KIND[(kern, cross)])
                 for ss, kern, cross in F.epf_step_list(iters, p0_scale, p2_scale))


def _check_plane(channels, rs8=None, halo: int = 0) -> tuple[int, int]:
    """(H, W) of a (3, H + 2 * halo, W) float32 input, checked with its
    block sigmas."""
    if channels.dim() != 3 or channels.shape[0] != 3 or channels.shape[1] <= 2 * halo:
        raise ValueError(f"channels: want (3, H + {2 * halo}, W), got "
                         f"{tuple(channels.shape)}")
    _, Hs, W = channels.shape
    K._check("channels", channels, (3, Hs, W))
    H = Hs - 2 * halo
    if rs8 is not None:
        K._check("rs8", rs8, (-(-H // 8), -(-W // 8)))
    return H, W


# ---------------------------------------------------------------- plain versions


def gaborish_ref(channels, weights):
    """Plain version of `gaborish`."""
    return F.gaborish_torch(channels, weights)


def gaborish_rows_ref(rows, weights):
    """Plain version of `gaborish_rows` (counterpart of
    sharded_filters._gaborish_rows): rows from the stripe, columns
    edge-replicated."""
    p = torch.nn.functional.pad(rows[None], (1, 1, 0, 0), mode="replicate")[0]
    return F.gaborish_taps(p, weights)


def epf_step_rows_ref(rows, rs8, sigma_scale: float, kind: int, channel_scale,
                      border_sad_mul: float):
    """Plain version of `epf_step_rows` (F._epf_step_torch_rows)."""
    _, Hs, W = rows.shape
    kern, cross = STEP_KERNELS[kind]
    return F._epf_step_torch_rows(rows, rows[:, 3:-3], F.rs_per_pixel(rs8, Hs - 6, W), 0,
                                  sigma_scale, kern, cross, channel_scale, border_sad_mul)


def epf_step_ref(channels, rs8, sigma_scale: float, kind: int, channel_scale,
                 border_sad_mul: float):
    """Plain version of `epf_step`."""
    _, H, W = channels.shape
    kern, cross = STEP_KERNELS[kind]
    return F._epf_step_torch(channels, F.rs_per_pixel(rs8, H, W), sigma_scale,
                             kern, cross, channel_scale, border_sad_mul)


def epf_fused_ref(channels, rs8, steps, channel_scale, border_sad_mul: float):
    """Plain version of `epf_fused`: the chain of single steps, which the
    fused pass equals on planes whose sides are multiples of 8."""
    for sigma_scale, kind in steps:
        channels = epf_step_ref(channels, rs8, sigma_scale, kind, channel_scale,
                                border_sad_mul)
    return channels


# ---------------------------------------------------------------- wrappers


def _gab_weights(weights):
    """The normalized (w0, w1, w2) of each channel, as the kernel takes them."""
    norm = []
    for w1, w2 in weights:
        ws = 1.0 + 4 * float(w1) + 4 * float(w2)
        norm += [1.0 / ws, float(w1) / ws, float(w2) / ws]
    return (ctypes.c_float * 9)(*norm)


def gaborish(channels, weights):
    """3x3 normalized gaborish of a (3, H, W) float32 plane, edges
    replicated; weights [(w1, w2)] * 3 (counterpart of gaborish_pallas)."""
    H, W = _check_plane(channels)
    if not K._on_cuda(channels):
        return gaborish_ref(channels, weights)
    out = torch.empty_like(channels)
    K._launch("gaborish", "j40tt_gaborish", channels.device, channels.data_ptr(),
              out.data_ptr(), H, W, _gab_weights(weights))
    return out


def gaborish_rows(rows, weights):
    """Gaborish of one row shard: `rows` (3, H + 2, W) float32, its H rows
    between a neighbour's row above and below; returns (3, H, W)
    (counterpart of sharded_filters._gaborish_rows)."""
    H, W = _check_plane(rows, halo=1)
    if not K._on_cuda(rows):
        return gaborish_rows_ref(rows, weights)
    out = torch.empty((3, H, W), dtype=torch.float32, device=rows.device)
    K._launch("gaborish_rows", "j40tt_gaborish_rows", rows.device, rows.data_ptr(),
              out.data_ptr(), H, W, _gab_weights(weights))
    return out


def _epf_step_launch(name: str, fn: str, src, rs8, H: int, W: int, sigma_scale: float,
                     kind: int, channel_scale, border_sad_mul: float):
    p = _params(((sigma_scale, kind),), channel_scale, border_sad_mul)
    out = torch.empty((3, H, W), dtype=torch.float32, device=src.device)
    K._launch(name, fn, src.device, src.data_ptr(), rs8.data_ptr(), out.data_ptr(),
              H, W, ctypes.byref(p))
    return out


def epf_step(channels, rs8, sigma_scale: float, kind: int, channel_scale,
             border_sad_mul: float):
    """One EPF step of a (3, H, W) float32 plane of any size (counterpart of
    _epf_step_pallas)."""
    H, W = _check_plane(channels, rs8)
    if kind not in STEP_KERNELS:
        raise ValueError(f"EPF step kind {kind}")
    if not K._on_cuda(channels, rs8):
        return epf_step_ref(channels, rs8, sigma_scale, kind, channel_scale,
                            border_sad_mul)
    return _epf_step_launch("epf_step", "j40tt_epf_step", channels, rs8, H, W,
                            sigma_scale, kind, channel_scale, border_sad_mul)


def epf_step_rows(rows, rs8, sigma_scale: float, kind: int, channel_scale,
                  border_sad_mul: float):
    """One EPF step of a row shard: `rows` (3, H + 6, W) float32, its H rows
    between 3 rows of each neighbour, rs8 the shard's (ceil(H/8), ceil(W/8))
    block sigmas; returns (3, H, W) (counterpart of epf_step_pallas_rows,
    whose sigma_scale is this one times POS_MULT)."""
    H, W = _check_plane(rows, rs8, halo=3)
    if kind not in STEP_KERNELS:
        raise ValueError(f"EPF step kind {kind}")
    if not K._on_cuda(rows, rs8):
        return epf_step_rows_ref(rows, rs8, sigma_scale, kind, channel_scale,
                                 border_sad_mul)
    return _epf_step_launch("epf_step_rows", "j40tt_epf_step_rows", rows, rs8, H, W,
                            sigma_scale, kind, channel_scale, border_sad_mul)


def epf_fused(channels, rs8, steps, channel_scale, border_sad_mul: float):
    """All EPF steps (1-3, as (sigma_scale, kind)) of a (3, H, W) float32
    plane whose sides are multiples of 8, in one pass (counterpart of
    _epf_fused_pallas)."""
    H, W = _check_plane(channels, rs8)
    if H % 8 or W % 8 or not 1 <= len(steps) <= 3:
        raise ValueError(f"epf_fused: {len(steps)} steps on a {H}x{W} plane")
    if any(kind not in STEP_KERNELS for _, kind in steps):
        raise ValueError(f"EPF step kinds {steps}")
    if not K._on_cuda(channels, rs8):
        return epf_fused_ref(channels, rs8, steps, channel_scale, border_sad_mul)
    p = _params(steps, channel_scale, border_sad_mul)
    out = torch.empty_like(channels)
    K._launch("epf_fused", "j40tt_epf_fused", channels.device, channels.data_ptr(),
              rs8.data_ptr(), out.data_ptr(), H, W, ctypes.byref(p))
    return out


def epf_device(channels, rs8, *, iters: int, channel_scale, p0_scale: float,
               p2_scale: float, border_sad_mul: float):
    """The EPF step chain of a frame (counterpart of epf_pallas), with the
    reference's dispatch by shape: one fused pass when H and W are
    multiples of 8, else one single-step launch per step."""
    steps = frame_steps(iters, p0_scale, p2_scale)
    if not steps:
        return channels
    _, H, W = channels.shape
    if H % 8 == 0 and W % 8 == 0:
        return epf_fused(channels, rs8, steps, channel_scale, border_sad_mul)
    for sigma_scale, kind in steps:
        channels = epf_step(channels, rs8, sigma_scale, kind, channel_scale,
                            border_sad_mul)
    return channels


def epf_from_state(channels, vs, gg, is_modular: bool = False):
    """EPF of a (3, H, W) plane with the per-block sigmas and parameters of
    the frame state (counterpart of epf_pallas_from_state).  The decode path
    splits the same two steps: ops/combine.lf_group_inputs gathers the
    sigmas with the same `epf_rs8` on the host, in the decode workers, and
    filter_frame calls epf_device on the card, over the whole frame."""
    f = vs.fs.f
    if f.epf_iters <= 0:
        return channels
    _, H, W = channels.shape
    rs8 = F.epf_rs8(vs, gg, H, W, is_modular)
    if rs8 is None:
        return channels
    rs8 = torch.from_numpy(np.ascontiguousarray(rs8, np.float32)).to(channels.device)
    return epf_device(channels, rs8, **F.epf_params(f))
