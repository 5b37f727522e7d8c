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
flags alike.  A call takes any number of planes of one shape, one CTA a
plane: the Modular route sends every slot of a class that shares a shape
and a kernel in one call.

The kernels' design (csrc/wavefront.cu): a plane is a chain of D = k*H + W
- k diagonals (k = 1 for W1, 2 for W2), so its time is D times one step's
latency.  A warp owns a band of 32 rows, one lane a row; the row above
comes from the lane above by shuffle, and for a band's first row from the
band above through a ring in shared memory, each value beside its
sequence number in one 64-bit word (no CTA barrier and no fence a
diagonal).  Residuals and codes come a chunk of steps ahead, by cp.async
into each warp's shared memory.  A plane taller than the CTA gives each
warp several bands, which is deadlock-free up to a width
(csrc's `tall_width_limit`); W3's tree lives in shared memory as one int4
a node.  The wrappers check a launch against the limits the library
reports (`limits()`: rows a CTA, those widths, the most tree nodes), so
no copy of them lives here.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..profile import upload
from ..streams import device_cache
from . import device_entropy as DE
from . import kernels as K

#: props an MA tree walk reads on the card (modular/decode.py:355-401)
N_PROPS = 16
#: the fields of csrc/wavefront.cu's j40tt_wavefront_limits
_LIMITS = ("threads_plain", "threads_mixed", "threads_wp", "tall_width_plain",
           "tall_width_mixed", "tall_width_wp", "plain_chunk", "plain_ring", "wp_chunk",
           "wp_ring", "tree_nodes")


@functools.lru_cache(maxsize=1)
def limits() -> dict:
    """The kernels' limits, as the built library reports them: rows a CTA
    (`threads_plain` W1, `threads_mixed` W1 with codes, `threads_wp` W2),
    the widest plane taller than a CTA that each takes (`tall_width_*`: its
    bands hand off deadlock-free up to that width; a Modular group is at
    most 1024 on a side), the chunks and rings of the hand-off, and the
    most nodes of a W3 tree (`tree_nodes`, in shared memory).  Builds the
    library; only the CUDA branches ask."""
    from ._build import load_kernels

    out = (ctypes.c_int * len(_LIMITS))()
    load_kernels().j40tt_wavefront_limits(out)
    return dict(zip(_LIMITS, out))


def _planes(name: str, t: torch.Tensor, height: int, width: int) -> int:
    if t.dim() != 3 or tuple(t.shape[1:]) != (height, width):
        raise ValueError(f"{name}: want (L, {height}, {width}), got {tuple(t.shape)}")
    K._check(name, t, tuple(t.shape), torch.int32)
    return t.shape[0]


def _fits(kind: str, height: int, width: int) -> None:
    """Raise ValueError on a plane kernel `kind` ("plain", "mixed", "wp")
    does not take (csrc's fits)."""
    if height < 1 or width < 1 or height * width >= 1 << 31:
        raise ValueError(f"plane {height}x{width}: want 1 <= H * W < 2^31")
    lim = limits()
    threads, tall_width = lim[f"threads_{kind}"], lim[f"tall_width_{kind}"]
    if height > threads and width > tall_width:
        raise ValueError(f"plane of {height} rows, more than a CTA's {threads}: its "
                         f"bands hand off deadlock-free up to width {tall_width}, "
                         f"got {width}")


def plain_wavefront(res, pcode, height: int, width: int):
    """W1: reconstruct (L, H, W) int32 planes on the y + x wavefront, with
    the gradient predictor everywhere (pcode None) or per-pixel int32
    codes (L, H, W) (0: zero, 1: W, 2: N, else the gradient)."""
    L = _planes("res", res, height, width)
    if pcode is not None:
        K._check("pcode", pcode, (L, height, width), torch.int32)
    if not K._on_cuda(res, *(() if pcode is None else (pcode,))):
        return DE._plain_wavefront(res, pcode, height, width)
    _fits("plain" if pcode is None else "mixed", height, width)
    out = torch.empty_like(res)
    K._launch("wavefront" if pcode is None else "wavefront_mixed", "j40tt_wavefront",
              res.device, res.data_ptr(), 0 if pcode is None else pcode.data_ptr(),
              out.data_ptr(), L, height, width)
    return out


def _params(params) -> np.ndarray:
    """The 11 int32 of csrc/wavefront.cu's J40ttWpParams."""
    return np.ascontiguousarray([params.p1, params.p2, *params.p3, *params.w], np.int32)


def _launch_wp(name, res, pcode, tree, depth, cidx, sidx, height, width, params):
    _fits("wp", height, width)
    L = res.shape[0]
    out = torch.empty_like(res)
    ovf = torch.empty(L, dtype=torch.bool, device=res.device)
    p = _params(params)
    K._launch(name, "j40tt_wavefront_wp", res.device, res.data_ptr(),
              0 if pcode is None else pcode.data_ptr(),
              0 if tree is None else tree.data_ptr(),
              0 if tree is None else tree.shape[0], depth,
              0 if cidx is None else cidx.data_ptr(),
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
                      pcode, None, 0, None, None, height, width, params)


@functools.lru_cache(maxsize=64)
def _tree_meta(tree_key) -> tuple[np.ndarray, int]:
    """A flattened tree's nodes as the kernel reads them, (nodes, 4) int64
    (a branch: property, value, left, right; a leaf: -1, predictor,
    offset, multiplier), and its depth (device_entropy._tree_depth, which
    the plain version walks too).  Raises on a tree no walk can take, on
    any device: no nodes, a property outside 0-15, or a child index out of
    range, the root's or another branch's child (so no cycle)."""
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
    packed = np.where(branch[:, None], arr[:, :4],
                      np.stack([np.full(n, -1), arr[:, 4], arr[:, 5], arr[:, 6]], 1))
    return packed, DE._tree_depth(tree_key)


def _tree_pack(tree_key) -> np.ndarray:
    """The nodes as the card's shared memory holds them, one int4 each;
    raises on a field outside int32."""
    packed = _tree_meta(tree_key)[0]
    if (packed < -(1 << 31)).any() or (packed >= 1 << 31).any():
        raise ValueError("tree: a value, predictor, offset or multiplier outside int32")
    return packed.astype(np.int32)


@device_cache(maxsize=64)
def _device_tree(tree_key, device: torch.device) -> torch.Tensor:
    """A tree's packed nodes on the card, copied once a (tree, device) and
    read by decodes on several streams;
    raises on a tree larger than the kernel's shared memory holds."""
    most = limits()["tree_nodes"]
    if len(tree_key) > most:
        raise ValueError(f"tree: {len(tree_key)} nodes, more than the {most} that fit "
                         f"in shared memory")
    return upload(_tree_pack(tree_key), device)


def tree_wavefront(res, tree_key, cidx, sidx, height: int, width: int, params):
    """W3: the WP wavefront with the MA-tree walk in the step (W2's tree
    mode): per pixel, properties 0-15 pick a leaf of `tree_key` (tuples
    (prop, value, left, right, predictor, offset, multiplier), leaves prop <
    0), whose predictor, multiplier and offset apply to the RAW residual;
    `cidx` the channel index, one for every plane or one a plane (L,);
    `sidx` the planes' stream indices (L,).  Returns (planes, overflow flag
    (L,) bool)."""
    L = _planes("res", res, height, width)
    sidx_t = DE._long(sidx, res.device).to(torch.int32).contiguous()
    cidx_t = DE._long(cidx, res.device).to(torch.int32).expand(L).contiguous()
    for name, t in (("sidx", sidx_t), ("cidx", cidx_t)):
        if tuple(t.shape) != (L,):
            raise ValueError(f"{name}: want ({L},), got {tuple(t.shape)}")
    key = tuple(map(tuple, tree_key))
    depth = _tree_meta(key)[1]
    if not K._on_cuda(res, sidx_t):
        # the plain version takes one channel index: a call a channel
        out, ovf = torch.empty_like(res), torch.empty(L, dtype=torch.bool)
        for c in torch.unique(cidx_t).tolist():
            at = torch.nonzero(cidx_t == c)[:, 0]
            out[at], ovf[at] = DE._tree_wp_reconstruct(res[at], height, width, params,
                                                       tree_key, c, sidx_t[at])
        return out, ovf
    return _launch_wp("wavefront_tree", res, None, _device_tree(key, res.device), depth,
                      cidx_t, sidx_t, height, width, params)
