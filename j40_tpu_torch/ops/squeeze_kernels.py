"""The inverse Squeeze merge on the card: the CUDA kernel's wrapper beside
its plain PyTorch version.

Counterpart of j40_tpu/parallel/sharded_lossless.py's `_inv_squeeze_h_scan`
(a jax.lax.scan inside the jax.jit program of the sharded lossless decode,
no pl.pallas_call); the kernel is in csrc/squeeze.cu.  The wrapper takes
CUDA tensors to its kernel (or raises) and CPU tensors to its plain
version; nothing falls back from a failed build or launch.  Launches count
in `kernels.launches["unsqueeze"]`.

| wrapper   | plain version                                        | JAX program replaced     |
| unsqueeze | unsqueeze_ref (_inv_squeeze_h_scan; .T when vertical) | _inv_squeeze_h_scan (S1) |

A merge is spec H.6.2 with SmoothTendency (H.6.1) in int32: each chain (a
row of a horizontal merge, a column of a vertical one) is a walk over its
column pairs, carrying the last sample written, and the chains are
independent.  The kernel cuts each chain into segments that a warp's
lanes walk at once from both ends of their input's range, then re-walks
the few pairs before the two ends met (csrc/squeeze.cu; modelled on the
CPU by tools/squeeze_model.py).  It reads its inputs through
their strides (a column shard is a view of the whole plane and is not
copied) and writes a contiguous output; both versions equal the spec
oracle (modular/transforms.py `_inv_squeeze_h`, `_inv_squeeze_v`) bit for
bit wherever no int32 sum wraps, and each other everywhere.
"""

from __future__ import annotations

import torch

from . import kernels as K


def _trunc_div(x, d: int):
    """Integer division rounding toward zero (C's `/`)."""
    return torch.div(x, d, rounding_mode="trunc")


def _tendency_terms(a, n):
    """The parts of SmoothTendency that do not read B (the left neighbour
    the scan carries), for a whole plane at once: the loop then launches
    only the B-dependent ops."""
    return a >= n, a <= n, 3 * n + a, 2 * (a - n)


def _smooth_tendency(B, a, n, terms=None):
    """SmoothTendency (spec H.6.1), branchless int32 (oracle:
    modular.transforms._smooth_tendency); `terms` = _tendency_terms(a, n)."""
    ge, le, k, an2 = _tendency_terms(a, n) if terms is None else terms
    inc = (B >= a) & ge
    dec = (B <= a) & le & ~inc
    t = 4 * B - k
    ba2 = 2 * (B - a)

    d_inc = _trunc_div(t + 6, 12)
    d_inc = torch.where((d_inc - (d_inc & 1)) > ba2, ba2 + 1, d_inc)
    d_inc = torch.where((d_inc + (d_inc & 1)) > an2, an2, d_inc)

    d_dec = _trunc_div(t - 6, 12)
    d_dec = torch.where((d_dec + (d_dec & 1)) < ba2, ba2 - 1, d_dec)
    d_dec = torch.where((d_dec - (d_dec & 1)) < an2, an2, d_dec)

    return torch.where(inc, d_inc, torch.where(dec, d_dec, 0))


def _inv_squeeze_h_scan(down, residu):
    """Horizontal unsqueeze: a loop over output column pairs, rows
    vectorized (bit-equal to modular.transforms._inv_squeeze_h in int32;
    j40_tpu's lax.scan)."""
    h, wd = down.shape
    wr = residu.shape[1]
    w = wd + wr
    if wr == 0 or h == 0:
        return torch.cat([down, residu], dim=1) if wr else down
    # next_avg = down[:, x+1] (clamped to the last column when x+1 == wd)
    nxt = down[:, 1:] if wd > wr else torch.cat([down[:, 1:], down[:, -1:]], dim=1)
    avg_all = down[:, :wr]
    terms = _tendency_terms(avg_all, nxt[:, :wr])
    firsts, seconds = [], []
    left = down[:, 0]
    for x in range(wr):
        avg = avg_all[:, x]
        diff = residu[:, x] + _smooth_tendency(left, avg, None,
                                               tuple(t[:, x] for t in terms))
        first = avg + _trunc_div(diff, 2)
        left = first - diff
        firsts.append(first)
        seconds.append(left)
    out = torch.stack([torch.stack(firsts, 1), torch.stack(seconds, 1)], 2).reshape(h, 2 * wr)
    if w & 1:
        out = torch.cat([out, down[:, -1:]], dim=1)
    return out


def unsqueeze_ref(down, residu, horizontal: bool):
    """The plain version of `unsqueeze`: the column-pair loop, a vertical
    merge as the loop over the transposes."""
    if horizontal:
        return _inv_squeeze_h_scan(down, residu)
    return _inv_squeeze_h_scan(down.T, residu.T).T


def _merge_shape(down, residu, horizontal: bool) -> tuple[int, int, int]:
    """(chains, wd, wr) of a merge; raises ValueError on one no merge takes."""
    for name, t in (("down", down), ("residu", residu)):
        if t.dtype != torch.int32 or t.dim() != 2:
            raise ValueError(f"{name}: want a 2-D int32 plane, got {t.dtype} "
                             f"{tuple(t.shape)}")
    ax = 0 if horizontal else 1
    chains, wd, wr = down.shape[ax], down.shape[1 - ax], residu.shape[1 - ax]
    if residu.shape[ax] != chains:
        raise ValueError(f"down {tuple(down.shape)} and residu {tuple(residu.shape)}: "
                         f"{'heights' if horizontal else 'widths'} differ")
    if wd not in (wr, wr + 1):
        raise ValueError(f"down {tuple(down.shape)} and residu {tuple(residu.shape)}: "
                         f"want {'wd' if horizontal else 'hd'} = "
                         f"{'wr' if horizontal else 'hr'} or one more")
    return chains, wd, wr


def unsqueeze(down, residu, horizontal: bool):
    """S1: one inverse Squeeze merge of int32 planes.  Horizontal: down (h,
    wd), residu (h, wr) -> (h, wd + wr); vertical: down (hd, w), residu (hr,
    w) -> (hd + hr, w); wd = wr or wr + 1 (hd = hr or hr + 1).  Inputs may
    be views with any strides; on the card the output is contiguous, and a
    merge with no output sample launches nothing."""
    chains, wd, wr = _merge_shape(down, residu, horizontal)
    if not K._on_cuda(down, residu):
        return unsqueeze_ref(down, residu, horizontal)
    w = wd + wr
    out = torch.empty((chains, w) if horizontal else (w, chains), dtype=torch.int32,
                      device=down.device)
    if out.numel():
        K._launch("unsqueeze", "j40tt_unsqueeze", down.device, down.data_ptr(),
                  *down.stride(), residu.data_ptr(), *residu.stride(), out.data_ptr(),
                  chains, wd, wr, int(horizontal))
    return out
