"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need a CUDA device (the kernels have no CPU mode) and skip elsewhere;
the file imports no jax, so it runs on a machine with only PyTorch:

    python -m pytest tests/test_torch_cuda.py -m cuda

Tolerances: float samples within 1e-4 absolute (fp32 sums in another order
and FMA contraction); quantized sRGB within 1 level, or within 1e-5 of the
value where pre-clamp sRGB lies far outside [0, maxval].
"""

import numpy as np
import pytest
import torch

from j40_tpu_torch.decode import Decoder
from j40_tpu_torch.encode.vardct_enc import (
    VarDCTOptions, encode_vardct, encode_vardct_mixed,
)
from j40_tpu_torch.headers.image import (
    OPSIN_BIAS, OPSIN_INV_MAT, QUANT_BIAS, QUANT_BIAS_NUM,
)
from j40_tpu_torch.ops import kernels as K
from j40_tpu_torch.vardct.dequant import DqMatrix, load_dq_matrix

pytestmark = pytest.mark.cuda
FTOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _consts22(maxval):
    return torch.tensor(np.concatenate([
        [65536.0 / 32768.0, 0.8, 1.25, *QUANT_BIAS, QUANT_BIAS_NUM, 0.0],
        np.asarray(OPSIN_INV_MAT, np.float64).ravel(),
        [OPSIN_BIAS] * 3, [1.0, maxval],
    ]).astype(np.float32))


def _inputs(h8, w8, seed=0):
    """Coefficients with exceptions (|q| > 127) and zero cells, aux in the
    ranges of a real LF group, the DCT8 weights."""
    rng = np.random.default_rng(seed + 100 * h8 + w8)
    n = h8 * w8
    q = rng.integers(-6, 7, size=(3, n, 64)).astype(np.float32)
    q[rng.random(q.shape) < 0.6] = 0.0
    m = rng.random(q.shape) < 0.01
    q[m] = rng.choice([-1, 1], m.sum()) * rng.integers(128, 400, m.sum())
    y = rng.uniform(0.05, 0.6, n)
    aux = np.stack([
        rng.normal(size=n) * 0.01, y, y + rng.normal(size=n) * 0.05,
        rng.uniform(0.1, 0.2, n), rng.normal(size=n) * 0.05,
        1.0 + rng.normal(size=n) * 0.05,
    ]).astype(np.float32)
    q[:, ::3] = 0.0
    aux[:, ::3] = 0.0
    return [torch.from_numpy(a) for a in (q, aux, load_dq_matrix(0, DqMatrix()))]


def _int_close(a, b):
    a, b = a.cpu().to(torch.int64), b.cpu().to(torch.int64)
    assert a.shape == b.shape
    d = (a - b).abs()
    assert (d <= torch.clamp_min(1e-5 * b.abs(), 1)).all(), d.max()


@pytest.mark.parametrize("h8,w8", [(1, 1), (5, 7), (8, 8), (23, 29), (128, 128)])
def test_dct8_kernels_vs_plain(cuda, h8, w8):
    args = [t.to(cuda) for t in _inputs(h8, w8)]
    for maxval, to_u8 in ((255.0, True), (4095.0, False)):
        c22 = _consts22(maxval).to(cuda)
        got = K.reconstruct_dct8_srgb(*args, c22, h8, w8, to_u8)
        assert got.dtype == (torch.uint8 if to_u8 else torch.int32)
        _int_close(got, K.reconstruct_dct8_srgb_ref(*args, c22, h8, w8, to_u8))
    got = K.reconstruct_dct8(*args, c22[:8], h8, w8)
    ref = K.reconstruct_dct8_ref(*args, c22[:8], h8, w8)
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max().item() <= FTOL


@pytest.mark.parametrize("shape", [(3, 1, 1), (3, 37, 61), (3, 300, 2048)])
def test_xyb_kernel_vs_plain(cuda, shape):
    rng = np.random.default_rng(shape[1])
    plane = torch.from_numpy(rng.normal(size=shape).astype(np.float32) * 0.3).to(cuda)
    c22 = _consts22(255.0).to(cuda)
    for to_u8 in (False, True):
        _int_close(K.xyb_to_srgb(plane, c22, to_u8),
                   K.xyb_to_srgb_ref(plane, c22, to_u8))


def test_unpack_i8_duplicates(cuda):
    """Padding entries of the exception list all hit flat index 0 with its
    exact value: the rebuilt plane is exact whatever order they land in."""
    cup = torch.full((3, 4, 64), 100, dtype=torch.int8)
    idx = torch.zeros(64, dtype=torch.int32)
    val = torch.full((64,), -300, dtype=torch.int32)
    idx[1], val[1] = 5, 250
    d = K.unpack_i8(cup.to(cuda), idx.to(cuda), val.to(cuda)).cpu().view(-1)
    assert d[0].item() == -300 and d[5].item() == 250 and d[1].item() == 100


def test_wrappers_refuse_mixed_devices(cuda):
    q, aux, w = _inputs(2, 3)
    with pytest.raises(ValueError):
        K.reconstruct_dct8_srgb(q.to(cuda), aux, w.to(cuda),
                                _consts22(255.0).to(cuda), 2, 3)


def _noise(rng, h, w):
    return (np.cumsum(np.cumsum(rng.integers(-2, 3, size=(h, w, 3)), 0), 1)
            % 200 + 20).astype(np.uint8)


def _mixed():
    img = _noise(np.random.default_rng(7), 200, 2300)  # two LF groups
    img[:64, :256] = img[3, 3]
    return encode_vardct_mixed(img)


def _bpp12():
    rng = np.random.default_rng(5)
    img = (np.cumsum(np.cumsum(rng.integers(-20, 21, (96, 112, 3)), 0), 1)
           % 3800 + 100).astype(np.uint16)
    return encode_vardct(img, VarDCTOptions(bpp=12))


@pytest.mark.parametrize("make,want", [
    (lambda: encode_vardct(_noise(np.random.default_rng(1), 77, 61)),
     {"reconstruct_dct8_srgb"}),
    (_mixed, {"reconstruct_dct8_srgb", "reconstruct_dct8", "xyb_to_srgb"}),
    (_bpp12, {"reconstruct_dct8_srgb"}),
], ids=["dct8_ragged", "mixed_two_lf_groups", "dct8_12bit"])
def test_decode_on_card_vs_cpu(cuda, make, want):
    data = make()
    outs = []
    for dev in ("cuda", "cpu"):
        K.reset_launches()
        dec = Decoder(data, device=dev, workers=4)
        dec.decode_frame()
        launched = {k for k, v in K.launches.items() if v}
        assert launched == (want if dev == "cuda" else set()), K.launches
        outs.append(np.stack([np.asarray(c, np.int64) for c in dec.frame.canvas[:3]]))
    assert np.abs(outs[0] - outs[1]).max() <= 1
