"""The three CUDA kernels of the VarDCT reconstruction, their plain PyTorch
versions and their wrappers, and what every wrapper of the port shares:
the device rule, the checks, the launch and its count.

Counterpart of j40_tpu/ops/pallas_kernels.py; the kernels themselves are
in csrc/reconstruct.cu.  Each wrapper takes a CUDA tensor to its kernel
(or raises) and a CPU tensor to its plain version; nothing falls back from
a failed build or launch.  `launches` counts the kernel launches, so a run
can show that its main path went through the kernels.

| wrapper                 | plain version               | TPU kernel replaced      |
| reconstruct_dct8_srgb   | reconstruct_dct8_srgb_ref   | pallas_kernels._srgb_kernel |
| reconstruct_dct8        | reconstruct_dct8_ref        | pallas_kernels._kernel      |
| xyb_to_srgb             | xyb_to_srgb_ref             | pallas_kernels._xyb_kernel  |
"""

from __future__ import annotations

import functools
import threading

import numpy as np
import torch

from ..vardct.dct import inverse_dct2d, inverse_matrix
from . import reconstruct as R

#: kernel launches since the last reset_launches(), by wrapper name (the
#: filter wrappers of ops/filter_kernels.py, the HF entropy wrappers of
#: ops/hf_kernels.py, the token wrapper of ops/token_kernels.py, the
#: wavefront wrappers of ops/wavefront_kernels.py and the Squeeze wrapper
#: of ops/squeeze_kernels.py count here too)
launches = {"reconstruct_dct8_srgb": 0, "reconstruct_dct8": 0, "xyb_to_srgb": 0,
            "epf_step": 0, "epf_step_rows": 0, "epf_fused": 0, "gaborish": 0,
            "gaborish_rows": 0, "hf": 0, "hf_ctx": 0, "tokens": 0, "wavefront": 0,
            "wavefront_mixed": 0, "wavefront_wp": 0, "wavefront_wp_codes": 0,
            "wavefront_tree": 0, "unsqueeze": 0}
_launch_lock = threading.Lock()


def reset_launches() -> None:
    with _launch_lock:
        for k in launches:
            launches[k] = 0


def _count(name: str) -> None:
    with _launch_lock:
        launches[name] += 1


def resolve_device(device=None) -> torch.device:
    """The device a decode runs on: CUDA unless the caller names another.
    Raises where CUDA is asked for (or implied) and absent — the port never
    carries on on the CPU by itself."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the torch backend runs on the GPU; pass "
            "device='cpu' to run its plain PyTorch version instead")
    # fp32 everywhere: TF32 keeps a 10-bit mantissa, and the 64-term IDCT
    # sums lose more than 16 gray levels at that precision (the JAX package
    # pins Precision.HIGHEST for the same reason, pallas_kernels.py:78-80)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@functools.lru_cache(maxsize=None)
def idct8_matrix() -> np.ndarray:
    """(64, 64) K with samples.ravel() == K @ canonical_coeffs (float32)."""
    cols = []
    for i in range(64):
        e = np.zeros(64, dtype=np.float32)
        e[i] = 1.0
        cols.append(inverse_dct2d(e, 3, 3).ravel())
    return np.stack(cols, axis=1).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _basis8() -> np.ndarray:
    """The 8-point inverse DCT basis G (float32, host memory), which the
    DCT8 kernels take by value: samples = G @ c @ G.T, as R.idct2d_batch."""
    return np.ascontiguousarray(inverse_matrix(8), dtype=np.float32)


# ---------------------------------------------------------------- plain versions


def _qm_scales(consts: torch.Tensor) -> torch.Tensor:
    return torch.stack([consts[1], torch.ones_like(consts[1]), consts[2]])


def reconstruct_dct8_ref(coeffs, aux, weights, consts, h8: int, w8: int):
    """Plain version of `reconstruct_dct8`: (3, 8*h8, 8*w8) float32 XYB."""
    deq = R.dequant_hf_batch(coeffs, weights, aux[3], consts[0],
                             _qm_scales(consts), consts[3:6], consts[6])
    cf = R.cfl_batch(deq, aux[4], aux[5])
    cf[:, :, 0] = aux[0:3]
    blocks = R.idct2d_batch(cf.reshape(-1, 64), 3, 3)
    return (
        blocks.reshape(3, h8, w8, 8, 8)
        .permute(0, 1, 3, 2, 4)
        .reshape(3, h8 * 8, w8 * 8)
    )


def xyb_to_srgb_ref(plane, consts22, to_u8: bool):
    """Plain version of `xyb_to_srgb`: (3, H, W) int32, or clamped uint8."""
    out = R.xyb_to_srgb_u8(plane, consts22[8:17].reshape(3, 3),
                           consts22[17:20], consts22[20], consts22[21])
    return out.clamp(0, 255).to(torch.uint8) if to_u8 else out


def reconstruct_dct8_srgb_ref(coeffs, aux, weights, consts22, h8: int, w8: int,
                              to_u8: bool):
    """Plain version of `reconstruct_dct8_srgb`."""
    return xyb_to_srgb_ref(reconstruct_dct8_ref(coeffs, aux, weights, consts22,
                                                h8, w8), consts22, to_u8)


# ---------------------------------------------------------------- wrappers


def _check(name, t: torch.Tensor, shape, dtype=torch.float32) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{name}: want contiguous {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}")


def _on_cuda(*ts: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU ones; raises on a mix."""
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError(f"tensors on several devices: {[str(t.device) for t in ts]}")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type == "cuda"


def _launch(name: str, fn, device: torch.device, *args) -> None:
    from ._build import load_kernels

    lib = load_kernels()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, fn)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn}: {lib.j40tt_error_string(rc).decode()} ({rc})")
    _count(name)


def _entropy_scratch(fn: str, device, *args) -> torch.Tensor:
    """The int32 scratch an entropy entry point needs (`fn` gives its size
    from the launch's shapes)."""
    from ._build import load_kernels

    n = int(getattr(load_kernels(), fn)(*args))
    return torch.empty(max(n, 2), dtype=torch.int32, device=device)


def _sync_stats(stats_out, scratch: torch.Tensor, L: int, W: int) -> None:
    """Put a sync-design launch's statistics into `stats_out["sync"]`, when
    the caller passed a dict: (L, 4) int32 on the card, per lane the rounds
    of the chase (the fused first included), the longest chase in
    subsequences, the subsequences re-decoded after the first round and the
    subsequences."""
    if stats_out is None:
        return
    from ._build import load_kernels

    at = int(load_kernels().j40tt_sync_stats_at(L, W))
    stats_out["sync"] = scratch[at:at + 4 * L].view(L, 4).clone()


def _check_dct8(coeffs, aux, weights, consts, n_consts, h8, w8):
    n = h8 * w8
    _check("coeffs", coeffs, (3, n, 64))
    _check("aux", aux, (6, n))
    _check("weights", weights, (64, 3))
    _check("consts", consts, (n_consts,))


def reconstruct_dct8_srgb(coeffs, aux, weights, consts22, h8: int, w8: int,
                          to_u8: bool = True):
    """Fused dequant + CfL + LLF + IDCT + XYB→sRGB of an all-DCT8 plane.

    coeffs (3, n, 64) float32 raw coefficients (n = h8*w8, raster order),
    aux (6, n) = llf x/y/b, hfmul_inv, kx, kb; weights (64, 3); consts22
    (22,).  Returns (3, 8*h8, 8*w8) raster sRGB, uint8 (clamped) when
    `to_u8`, else int32 (pre-clamp)."""
    _check_dct8(coeffs, aux, weights, consts22, 22, h8, w8)
    if not _on_cuda(coeffs, aux, weights, consts22):
        return reconstruct_dct8_srgb_ref(coeffs, aux, weights, consts22, h8, w8, to_u8)
    dev = coeffs.device
    out = torch.empty((3, 8 * h8, 8 * w8), device=dev,
                      dtype=torch.uint8 if to_u8 else torch.int32)
    _launch("reconstruct_dct8_srgb", "j40tt_reconstruct_dct8_srgb", dev,
            coeffs.data_ptr(), aux.data_ptr(), weights.data_ptr(),
            _basis8().ctypes.data, consts22.data_ptr(), out.data_ptr(),
            h8 * w8, h8, w8, int(to_u8))
    return out


def reconstruct_dct8(coeffs, aux, weights, consts, h8: int, w8: int):
    """Fused dequant + CfL + LLF + IDCT of an all-DCT8 plane (no colour
    stage): returns (3, 8*h8, 8*w8) float32 raster XYB.  Zero cells (zero
    coefficients and aux) give zero samples.  consts: the first 8 entries
    of consts22."""
    _check_dct8(coeffs, aux, weights, consts, 8, h8, w8)
    if not _on_cuda(coeffs, aux, weights, consts):
        return reconstruct_dct8_ref(coeffs, aux, weights, consts, h8, w8)
    dev = coeffs.device
    out = torch.empty((3, 8 * h8, 8 * w8), device=dev, dtype=torch.float32)
    _launch("reconstruct_dct8", "j40tt_reconstruct_dct8", dev,
            coeffs.data_ptr(), aux.data_ptr(), weights.data_ptr(),
            _basis8().ctypes.data, consts.data_ptr(), out.data_ptr(),
            h8 * w8, h8, w8)
    return out


def xyb_to_srgb(plane, consts22, to_u8: bool = True):
    """Pointwise (3, H, W) float32 XYB → sRGB, uint8 (clamped) when `to_u8`,
    else int32 (pre-clamp)."""
    if plane.dim() != 3:
        raise ValueError(f"plane: want (3, H, W), got {tuple(plane.shape)}")
    _check("plane", plane, (3, plane.shape[1], plane.shape[2]))
    _check("consts22", consts22, (22,))
    if not _on_cuda(plane, consts22):
        return xyb_to_srgb_ref(plane, consts22, to_u8)
    dev = plane.device
    out = torch.empty(plane.shape, device=dev,
                      dtype=torch.uint8 if to_u8 else torch.int32)
    npix = plane.shape[1] * plane.shape[2]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    grid = max(1, min(-(-npix // 256), 8 * sms))
    _launch("xyb_to_srgb", "j40tt_xyb_to_srgb", dev, plane.data_ptr(),
            consts22.data_ptr(), out.data_ptr(), npix, int(to_u8), grid)
    return out


def unpack_i8(cup, exc_idx, exc_val):
    """Rebuild the exact float32 coefficient plane from the clipped int8
    upload (or the int32 values of `unpack_i4`) and its exception list
    (combine._pack_i8, _pack_i4).  The padding entries all write flat
    index 0 with its own exact value, so duplicate writes agree whatever
    their order."""
    dense = cup.to(torch.float32)
    dense.view(-1)[exc_idx.long()] = exc_val.to(torch.float32)
    return dense


def unpack_i4(packed, shape):
    """Inverse of combine._pack_i4 before the exception scatter: biased
    nibbles, two a byte along the last axis, to int32 values in [-8, 7]
    (counterpart of combine_jax.unpack_i4_jax, a torch op on either
    device)."""
    lo = (packed & 0x0F).to(torch.int32) - 8
    hi = (packed >> 4).to(torch.int32) - 8
    return torch.stack([lo, hi], dim=-1).reshape(shape)


def reconstruct_dct8_full(cup, exc_idx, exc_val, aux, weights, consts22,
                          h8: int, w8: int, to_u8: bool = True, kind: str = "i8"):
    """Single-dispatch reconstruction of an all-DCT8 plane from its upload
    form `kind`, clipped int8 ("i8") or 4-bit nibbles ("i4"), each with its
    exception list (counterpart of pallas_kernels.reconstruct_dct8_full and
    of the packed branches of parallel/batch.py's `_chunk_rgba`): the
    unpack and the exception scatter as torch ops, then B1."""
    if kind == "i4":
        cup = unpack_i4(cup, (3, h8 * w8, 64))
    elif kind != "i8":
        raise ValueError(f"upload kind {kind!r}: use 'i8' or 'i4'")
    dense = unpack_i8(cup, exc_idx, exc_val)
    return reconstruct_dct8_srgb(dense, aux, weights, consts22, h8, w8, to_u8)
