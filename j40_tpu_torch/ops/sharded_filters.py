"""Sharded whole-image restoration filtering with halo exchange.

Counterpart of j40_tpu/ops/sharded_filters.py.  The per-LF-group filters
(ops/filters.py) mirror at group borders, so a sharded decode needs no
communication.  This module is the spec-faithful alternative: the image is
row-sharded across a device mesh (parallel/mesh.py), and before each 3x3
gaborish pass and each EPF step every shard receives its neighbours' edge
rows (`mesh.exchange`, the counterpart of `jax.lax.ppermute`), then filters
its stripe through the rows entries of kernels B9 and B7
(filter_kernels.gaborish_rows, epf_step_rows).  The image's outer borders
mirror their own edge rows, as the unsharded filters do.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.mesh import axis_devices, exchange
from . import filter_kernels as FK
from .filters import rs_per_pixel


def halo_stripes(xs: list, devices: list, k: int) -> list:
    """Each shard's (3, h + 2k, W) stripe: its rows between the last k rows
    of the shard above and the first k of the shard below, exchanged over
    the mesh; the first and last shards mirror their own edge rows (the
    half-sample mirror, which for k = 1 is edge replication)."""
    above, below = exchange(devices, [x[:, -k:] for x in xs], [x[:, :k] for x in xs])
    return [torch.cat([x[:, :k].flip(1) if a is None else a, x,
                       x[:, -k:].flip(1) if b is None else b], dim=1)
            for x, a, b in zip(xs, above, below)]


def _gaborish_rows(tile, top_halo, bottom_halo, weights):
    """Filter one row shard given 1-row halos from the neighbour shards:
    tile (3, h, W), halos (3, W); kernel B9's rows entry on a CUDA tile."""
    return FK.gaborish_rows(
        torch.cat([top_halo[:, None], tile, bottom_halo[:, None]], dim=1), weights)


def _shards(channels, mesh, axis: str):
    devices = axis_devices(mesh, axis)
    x = torch.as_tensor(np.asarray(channels, np.float32))
    return devices, [p.to(d).contiguous()
                     for p, d in zip(torch.chunk(x, len(devices), dim=1), devices)]


def sharded_gaborish(channels, weights, mesh, axis: str = "rows"):
    """Whole-image gaborish over a row-sharded (3, H, W) array (H a multiple
    of the mesh's `axis`): each shard receives its neighbours' edge rows;
    outer image borders replicate (matching ops.filters.gaborish).  Returns
    (3, H, W) float32 on the first shard's device."""
    if channels.shape[1] % len(axis_devices(mesh, axis)):
        raise ValueError(f"{channels.shape[1]} rows do not split evenly over the mesh")
    devices, xs = _shards(channels, mesh, axis)
    outs = [FK.gaborish_rows(s, weights) for s in halo_stripes(xs, devices, 1)]
    return torch.cat([o.to(devices[0]) for o in outs], dim=1)


def sharded_epf(channels, rs_px, mesh, *, iters: int = 2,
                channel_scale=(40.0, 5.0, 3.5), border_sad_mul: float = 2.0 / 3.0,
                p0_scale: float = 0.9, p2_scale: float = 6.5, axis: str = "rows"):
    """Whole-image EPF row-sharded over a device mesh.

    Each of the up-to-3 steps exchanges 3-row halos with mesh neighbours
    before filtering its shard; outer borders use the half-sample mirror
    like the unsharded path.  `rs_px` is the per-pixel reciprocal-sigma
    plane (ops.filters.epf_recip_sigmas expanded to pixels), constant on
    each 8x8 block: the kernel reads it per block.  Shard heights must be
    multiples of 8 so the 8x8 border/sigma blocks stay shard-local.
    Returns (3, H, W) float32 on the first shard's device.

    The step's sigma scale goes to the kernel as the XLA route takes it
    (`sscale`, with `border_sad_mul`); j40_tpu's Pallas route takes it
    times POS_MULT, and the border scale as that times border_sad_mul."""
    n = len(axis_devices(mesh, axis))
    _, H, W = channels.shape
    if H % n or (H // n) % 8:
        raise ValueError("shard rows must be 8-aligned")
    rs_px = torch.as_tensor(np.asarray(rs_px, np.float32))
    rs8 = rs_px[::8, ::8].contiguous()
    if not torch.equal(rs_per_pixel(rs8, H, W), rs_px):
        raise ValueError("rs_px is not constant on 8x8 blocks")
    devices, xs = _shards(channels, mesh, axis)
    rss = [r.to(d).contiguous() for r, d in zip(torch.chunk(rs8, n, dim=0), devices)]
    for ss, kind in FK.frame_steps(iters, p0_scale, p2_scale):
        xs = [FK.epf_step_rows(s, r, ss, kind, tuple(channel_scale), border_sad_mul)
              for s, r in zip(halo_stripes(xs, devices, 3), rss)]
    return torch.cat([x.to(devices[0]) for x in xs], dim=1)
