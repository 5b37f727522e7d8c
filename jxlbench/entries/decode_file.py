"""The program's one-image entry: `decode_file(data, backend, workers)`,
which returns host RGBA.  `entry_args` of the workload file are its
keyword arguments."""

from __future__ import annotations

import torch


def _copy(stats: dict) -> dict:
    return {k: dict(v) if isinstance(v, dict) else v for k, v in stats.items()}


class Entry:
    def __init__(self, args: dict, device: torch.device):
        import j40_tpu_torch
        from j40_tpu_torch.ops import kernels

        self._decode = j40_tpu_torch.decode_file
        self._launches = kernels.launches
        self.args = dict(args)
        self.device = device

    def load(self) -> None:
        """Build or load the kernel library and the native host core."""
        from j40_tpu_torch.native.bindings import get_lib

        if self.device.type == "cuda":
            from j40_tpu_torch.ops._build import load_kernels

            load_kernels()
        get_lib()

    def counters(self) -> dict:
        return dict(self._launches)

    def __call__(self, data: bytes) -> tuple:
        dec, rgba = self._decode(data, device=self.device, **self.args)
        return rgba, _copy(dec.stats)

    @staticmethod
    def image(answer) -> torch.Tensor:
        """The answer as an (h, w, 4) uint8 CPU tensor."""
        return torch.from_numpy(answer)
