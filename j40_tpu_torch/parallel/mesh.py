"""A device mesh for one controller (counterpart of jax.sharding.Mesh).

j40_tpu's sharded programs run under one controller: one call builds a
`Mesh`, runs `shard_map` with `ppermute` halos and returns the whole image.
The port keeps that shape.  A `Mesh` is a grid of `torch.device`s named by
axis; each shard's tensors live on its own device, and a halo exchange is a
copy to the neighbour's device (`exchange`), a peer copy over NVLink between
two GPUs.  A device may appear more than once: `Mesh([cuda:0] * 8)` runs
every shard, every exchange and every kernel launch of an 8-way program on
one card, as j40_tpu's tests run theirs on 8 virtual CPU devices, and the
CPU tests build `Mesh([cpu] * 8)`.  The port never swaps in a device that
the caller did not name.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.kernels import resolve_device


class Mesh:
    """`devices`: an array (any nesting of sequences) of torch.device or
    device strings, one axis per name in `axis_names`."""

    def __init__(self, devices, axis_names):
        self.devices = np.vectorize(torch.device, otypes=[object])(
            np.asarray(devices, dtype=object))
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-D devices for axes {self.axis_names}")
        #: axis name -> size, as jax.sharding.Mesh.shape
        self.shape = dict(zip(self.axis_names, self.devices.shape))


def axis_devices(mesh: Mesh, axis: str, at: int = 0) -> list:
    """The devices along `axis`, at index `at` of the mesh's other axis (a
    mesh has one or two)."""
    k = mesh.axis_names.index(axis)
    devs = np.moveaxis(mesh.devices, k, -1)
    return list(devs.reshape(-1, devs.shape[-1])[at])


def default_mesh(n_devices: int | None = None) -> Mesh:
    """A 1-D ("rows",) mesh of the first `n_devices` CUDA devices (all of
    them by default); raises without CUDA, or with fewer devices than
    asked for."""
    resolve_device(None)
    count = torch.cuda.device_count()
    n = count if n_devices is None else int(n_devices)
    if not 1 <= n <= count:
        raise RuntimeError(f"{n} CUDA devices asked for, {count} present")
    return Mesh([torch.device("cuda", i) for i in range(n)], ("rows",))


def exchange(devices, down, up):
    """One halo exchange along a row of shards (the counterpart of
    `ppermute` over the pairs (i, i+1) and (i+1, i)): shard i sends
    `down[i]` to the shard below it and `up[i]` to the shard above.
    Returns (from_above, from_below): from_above[i] is down[i-1] on
    devices[i], None for the first shard; from_below[i] is up[i+1] on
    devices[i], None for the last.  Copies are non-blocking; on the same
    device the tensor itself is returned."""
    n = len(devices)
    from_above = [None] + [down[i - 1].to(devices[i], non_blocking=True)
                           for i in range(1, n)]
    from_below = [up[i + 1].to(devices[i], non_blocking=True)
                  for i in range(n - 1)] + [None]
    return from_above, from_below
