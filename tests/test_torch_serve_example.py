"""examples/serve_device_torch.py, the serving example of the port, on the
CPU: its toy model's feature is the mean of the decoded RGB / 255, read
from the decoder's tensor (the host render, uploaded on no route)."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from j40_tpu_torch.decode import Decoder

EXAMPLE = Path(__file__).resolve().parents[1] / "examples" / "serve_device_torch.py"


@pytest.fixture(scope="module")
def example():
    spec = importlib.util.spec_from_file_location("serve_device_torch", EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_serve_device_torch_on_cpu(example, capsys):
    rgba, feat, dec = example.main(device="cpu")
    assert rgba.shape == (512, 512, 4) and rgba.dtype == torch.uint8
    assert rgba.device.type == "cpu" and dec.stats["device_output"] == "planes"
    host = Decoder(example.synthetic_blob(), backend="torch", device="cpu")
    host.decode_frame()
    ref = host.render_rgba8()
    np.testing.assert_array_equal(rgba.numpy(), ref)
    want = (torch.from_numpy(ref[..., :3]).to(torch.float32) / 255.0).mean(dim=(0, 1))
    assert torch.equal(feat, want)
    out = capsys.readouterr().out
    assert "(512, 512, 4) torch.uint8 on cpu" in out and "ms after decode" in out


def test_serve_device_torch_needs_cuda_by_default(example):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example.main()
