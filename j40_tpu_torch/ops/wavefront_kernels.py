"""The Modular wavefronts on the card: the CUDA kernels' wrappers, beside
their plain PyTorch versions in ops/device_entropy.py.

Counterpart of the lax.scan programs of j40_tpu/ops/device_entropy.py
(jax.jit device programs, no pl.pallas_call); the kernels are in
csrc/wavefront.cu.  Each wrapper takes CUDA tensors to its kernel (or
raises) and CPU tensors to its plain version; nothing falls back from a
failed build or launch.  Launches count in `kernels.launches`, one
counter a kernel instance: `wavefront` (W1, the gradient),
`wavefront_mixed` (W1, per-pixel codes), `wavefront_wp` (W2, WP alone),
`wavefront_wp_codes` (W2, per-pixel codes 0-12), `wavefront_tree` (W3).

| wrapper         | plain version                       | JAX program replaced |
| plain_wavefront | device_entropy._plain_wavefront     | gradient_reconstruct, mixed_reconstruct (W1) |
| wp_wavefront    | device_entropy._wp_reconstruct      | _wp_reconstruct (W2) |
| tree_wavefront  | device_entropy._tree_wp_reconstruct | _tree_wp_reconstruct (W3) |

Every result equals the plain version's bit for bit, planes and overflow
flags alike.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import device_entropy as DE
from . import kernels as K

#: props an MA tree walk reads on the card (modular/decode.py:355-401)
N_PROPS = 16
#: the dynamic shared memory a CTA may take (csrc/wavefront.cu's kSmemCap:
#: sm_90's 227 KB a block, less 1 KB for W2's static table), and the rows
#: whose ring it holds: 12 B a row in W1, 120 B a row in W2.  A Modular
#: group is at most 1024 rows; the wrappers refuse a taller plane on CUDA.
SMEM_CAP = 227 * 1024 - 1024
MAX_ROWS_PLAIN = SMEM_CAP // 12
MAX_ROWS_WP = SMEM_CAP // 120


def _planes(name: str, t: torch.Tensor, height: int, width: int) -> int:
    if t.dim() != 3 or tuple(t.shape[1:]) != (height, width):
        raise ValueError(f"{name}: want (L, {height}, {width}), got {tuple(t.shape)}")
    K._check(name, t, tuple(t.shape), torch.int32)
    return t.shape[0]


def _rows(height: int, most: int) -> None:
    if height > most:
        raise ValueError(f"height {height}: the kernel's ring holds at most {most} rows "
                         f"in shared memory")


def plain_wavefront(res, pcode, height: int, width: int):
    """W1: reconstruct (L, H, W) int32 planes on the y + x wavefront, with
    the gradient predictor everywhere (pcode None) or per-pixel int32
    codes (L, H, W) (0: zero, 1: W, 2: N, else the gradient)."""
    L = _planes("res", res, height, width)
    if pcode is not None:
        K._check("pcode", pcode, (L, height, width), torch.int32)
    if not K._on_cuda(res, *(() if pcode is None else (pcode,))):
        return DE._plain_wavefront(res, pcode, height, width)
    _rows(height, MAX_ROWS_PLAIN)
    out = torch.empty_like(res)
    K._launch("wavefront" if pcode is None else "wavefront_mixed", "j40tt_wavefront",
              res.device, res.data_ptr(), 0 if pcode is None else pcode.data_ptr(),
              out.data_ptr(), L, height, width)
    return out


def _params(params) -> np.ndarray:
    """The 11 int32 of csrc/wavefront.cu's J40ttWpParams."""
    return np.ascontiguousarray([params.p1, params.p2, *params.p3, *params.w], np.int32)


def _launch_wp(name, res, pcode, tree, depth, cidx, sidx, height, width, params):
    _rows(height, MAX_ROWS_WP)
    L = res.shape[0]
    out = torch.empty_like(res)
    ovf = torch.empty(L, dtype=torch.bool, device=res.device)
    p = _params(params)
    K._launch(name, "j40tt_wavefront_wp", res.device, res.data_ptr(),
              0 if pcode is None else pcode.data_ptr(),
              0 if tree is None else tree.data_ptr(),
              0 if tree is None else tree.shape[0], depth, cidx,
              0 if sidx is None else sidx.data_ptr(),
              p.ctypes.data, out.data_ptr(), ovf.data_ptr(), L, height, width)
    return out, ovf


def wp_wavefront(res, pcode, height: int, width: int, params):
    """W2: reconstruct (L, H, W) int32 planes on the d = 2y + x wavefront of
    the self-correcting predictor, WP everywhere (pcode None) or per-pixel
    int32 codes 0-12 (others predict 0); `params` the WPParams.  Returns
    (planes, overflow flag (L,) bool)."""
    L = _planes("res", res, height, width)
    if pcode is not None:
        K._check("pcode", pcode, (L, height, width), torch.int32)
    if not K._on_cuda(res, *(() if pcode is None else (pcode,))):
        return DE._wp_reconstruct(res, pcode, height, width, params, pcode is not None)
    return _launch_wp("wavefront_wp" if pcode is None else "wavefront_wp_codes", res,
                      pcode, None, 0, 0, None, height, width, params)


@functools.lru_cache(maxsize=64)
def _tree_meta(tree_key) -> tuple[np.ndarray, int]:
    """(nodes, 7) int64 of a flattened tree and its depth
    (device_entropy._tree_depth, which the plain version walks too); raises
    on a tree the kernel cannot walk: a property outside 0-15, or a child
    index out of range, the root's or another branch's child (so no
    cycle)."""
    arr = np.asarray(tree_key, np.int64).reshape(-1, 7)
    n = arr.shape[0]
    if n == 0:
        raise ValueError("tree: no nodes")
    branch = arr[:, 0] >= 0
    if (arr[branch, 0] >= N_PROPS).any():
        raise ValueError(f"tree: a property outside 0-{N_PROPS - 1}")
    kids = arr[branch][:, 2:4].ravel()
    if ((kids <= 0) | (kids >= n)).any() or len(np.unique(kids)) != len(kids):
        raise ValueError("tree: a child index out of range, the root or shared")
    return arr, DE._tree_depth(tree_key)


@functools.lru_cache(maxsize=64)
def _device_tree(tree_key, device: torch.device) -> torch.Tensor:
    """A tree's nodes on the card, copied once a (tree, device)."""
    return torch.from_numpy(_tree_meta(tree_key)[0]).to(device)


def tree_wavefront(res, tree_key, cidx: int, sidx, height: int, width: int, params):
    """W3: the WP wavefront with the MA-tree walk in the step (W2's tree
    mode): per pixel, properties 0-15 pick a leaf of `tree_key` (tuples
    (prop, value, left, right, predictor, offset, multiplier), leaves prop <
    0), whose predictor, multiplier and offset apply to the RAW residual;
    `cidx` the channel index, `sidx` the lanes' stream indices (L,).
    Returns (planes, overflow flag (L,) bool)."""
    L = _planes("res", res, height, width)
    sidx_t = DE._long(sidx, res.device).to(torch.int32).contiguous()
    if tuple(sidx_t.shape) != (L,):
        raise ValueError(f"sidx: want ({L},), got {tuple(sidx_t.shape)}")
    key = tuple(map(tuple, tree_key))
    depth = _tree_meta(key)[1]
    if not K._on_cuda(res, sidx_t):
        return DE._tree_wp_reconstruct(res, height, width, params, tree_key, cidx, sidx)
    return _launch_wp("wavefront_tree", res, None, _device_tree(key, res.device), depth,
                      int(cidx), sidx_t, height, width, params)
