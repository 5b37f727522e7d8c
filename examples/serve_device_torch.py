"""Serving example: decode JPEG XL straight into a PyTorch model's input on the GPU.

`Decoder(..., keep_device_output=True).render_rgba8_device()` assembles the
decoded RGBA on the card from the reconstruction's uint8 planes (kernel B1
on an all-DCT8 VarDCT frame), so the image is not uploaded from the host:
the toy model below reads the same CUDA tensor.  (The decoder still
fetches each plane for its host canvas.)

Run:  python examples/serve_device_torch.py  (a synthetic test image; needs
a CUDA device)
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch import nn  # noqa: E402

from j40_tpu_torch.decode import Decoder  # noqa: E402
from j40_tpu_torch.encode.vardct_enc import encode_vardct  # noqa: E402


class ToyModel(nn.Module):
    """Stand-in for an inference model: global-average-pool the RGB."""

    def forward(self, rgba_u8: torch.Tensor) -> torch.Tensor:
        x = rgba_u8[..., :3].to(torch.float32) / 255.0
        return x.mean(dim=(0, 1))


def synthetic_blob() -> bytes:
    """The synthetic 512x512 image of seed 0, VarDCT-encoded."""
    rng = np.random.default_rng(0)
    img = (np.cumsum(rng.integers(-2, 3, size=(512, 512, 3)), axis=1) % 200 + 20
           ).astype(np.uint8)
    return encode_vardct(img)


def main(device=None) -> tuple[torch.Tensor, torch.Tensor, Decoder]:
    """Decode the test image on `device` (None: CUDA, raising without it)
    and run the model on the decoded tensor; returns (rgba, feature, the
    decoder)."""
    dec = Decoder(synthetic_blob(), backend="torch", keep_device_output=True, device=device)
    dec.decode_frame()
    t0 = time.perf_counter()
    rgba = dec.render_rgba8_device()  # (h, w, 4) uint8 on the decoder's device
    feat = ToyModel()(rgba)           # stays there
    if rgba.is_cuda:
        torch.cuda.synchronize(rgba.device)
    dt = time.perf_counter() - t0
    print(f"device: {tuple(rgba.shape)} {rgba.dtype} on {rgba.device} "
          f"(route {dec.stats['device_output']})")
    print(f"model output {feat.cpu().numpy()} in {dt * 1e3:.1f} ms after decode")
    return rgba, feat, dec


if __name__ == "__main__":
    main()
