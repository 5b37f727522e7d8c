"""The port's plain PyTorch reconstruction (j40_tpu_torch/ops/reconstruct.py)
against its JAX counterpart (j40_tpu/ops/reconstruct.py) on the same numpy
inputs.

Tolerances: float outputs rtol = atol = 1e-5, because the fp32 sums run in
another order; quantized sRGB within 1 level, because a sample that lands
that close to a rounding boundary may round either way.  Pre-clamp sRGB far
outside [0, maxval] (entry()'s random inputs reach -2e6) carries fp32's
relative error instead, so there the bound is 1e-5 of the value.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from j40_tpu.ops import reconstruct as J
from j40_tpu.vardct.tables import DCT_SELECT
from j40_tpu_torch.ops import reconstruct as T

FTOL = dict(rtol=1e-5, atol=1e-5)
SHAPES = sorted({(lr, lc) for lr, lc, _, _ in DCT_SELECT})
LLF_SHAPES = [s for s in SHAPES if min(s) >= 3]


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _int_close(a, b):
    a, b = np.asarray(a, np.int64), np.asarray(b, np.int64)
    d = np.abs(a - b)
    assert (d <= np.maximum(1, 1e-5 * np.abs(b))).all(), d.max()


@pytest.mark.parametrize("log_rows,log_columns", SHAPES)
def test_idct2d_batch(log_rows, log_columns):
    rng = np.random.default_rng(log_rows * 16 + log_columns)
    size = 1 << (log_rows + log_columns)
    # scaled so the samples are O(1), as decoded XYB samples are
    x = (rng.normal(size=(5, size)) / np.sqrt(size)).astype(np.float32)
    ref = np.asarray(J.idct2d_batch(jnp.asarray(x), log_rows, log_columns))
    got = T.idct2d_batch(_t(x), log_rows, log_columns).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, **FTOL)


@pytest.mark.parametrize("log_rows,log_columns", LLF_SHAPES)
def test_llf_forward_batch(log_rows, log_columns):
    rng = np.random.default_rng(7 + log_rows * 16 + log_columns)
    vh8, vw8 = 1 << (log_rows - 3), 1 << (log_columns - 3)
    x = rng.normal(size=(4, vh8, vw8)).astype(np.float32)
    ref = np.asarray(J.llf_forward_batch(jnp.asarray(x), log_rows, log_columns))
    got = T.llf_forward_batch(_t(x), log_rows, log_columns).numpy()
    np.testing.assert_allclose(got, ref, **FTOL)


def test_dequant_and_cfl():
    rng = np.random.default_rng(3)
    q = rng.integers(-40, 41, size=(3, 50, 64)).astype(np.float32)
    q[rng.random(q.shape) < 0.5] = 0.0
    w = rng.uniform(0.05, 2.0, size=(64, 3)).astype(np.float32)
    hf = rng.uniform(0.05, 1.0, size=50).astype(np.float32)
    qm = np.array([0.8, 1.0, 1.25], np.float32)
    qb = np.array([-0.0009, -0.0008, -0.0011], np.float32)
    args = (np.float32(2.0), qm, qb, np.float32(0.145))
    ref = np.asarray(J.dequant_hf_batch(
        jnp.asarray(q), jnp.asarray(w), jnp.asarray(hf),
        *[jnp.asarray(a) for a in args]))
    got = T.dequant_hf_batch(_t(q), _t(w), _t(hf), *[_t(np.asarray(a)) for a in args])
    np.testing.assert_allclose(got.numpy(), ref, **FTOL)

    kx = rng.normal(size=50).astype(np.float32)
    kb = rng.normal(size=50).astype(np.float32)
    ref2 = np.asarray(J.cfl_batch(jnp.asarray(ref), jnp.asarray(kx), jnp.asarray(kb)))
    got2 = T.cfl_batch(got, _t(kx), _t(kb)).numpy()
    np.testing.assert_allclose(got2, ref2, **FTOL)


def _colour_args():
    from j40_tpu.headers.image import OPSIN_BIAS, OPSIN_INV_MAT

    return (np.asarray(OPSIN_INV_MAT, np.float32),
            np.asarray([OPSIN_BIAS] * 3, np.float32),
            np.float32(255.0 / 255.0))


@pytest.mark.parametrize("maxval", [255.0, 4095.0])
def test_xyb_to_srgb_u8(maxval):
    rng = np.random.default_rng(int(maxval))
    plane = (rng.normal(size=(3, 37, 53)) * [[[0.02]], [[0.3]], [[0.3]]]).astype(np.float32)
    inv, bias, its = _colour_args()
    ref = np.asarray(J.xyb_to_srgb_u8(
        jnp.asarray(plane), jnp.asarray(inv), jnp.asarray(bias),
        jnp.float32(its), jnp.float32(maxval)))
    got = T.xyb_to_srgb_u8(_t(plane), _t(inv), _t(bias),
                           torch.tensor(its), torch.tensor(np.float32(maxval)))
    assert got.dtype == torch.int32
    _int_close(got.numpy(), ref)


def test_smooth_lf():
    rng = np.random.default_rng(11)
    lf = rng.normal(size=(3, 19, 23)).astype(np.float32)
    inv_m = np.array([4096.0, 512.0, 256.0], np.float32) / 100
    ref = np.asarray(J.smooth_lf(jnp.asarray(lf), jnp.asarray(inv_m)))
    got = T.smooth_lf(_t(lf), _t(inv_m)).numpy()
    np.testing.assert_allclose(got, ref, **FTOL)


def test_entry_body_on_entry_inputs():
    """_reconstruct_dct8_jit on __graft_entry__'s own example inputs."""
    fn, args = __graft_entry__.entry()
    ref = np.asarray(fn(*args))
    targs = [_t(np.asarray(a)) for a in args]
    got = T._reconstruct_dct8_jit(*targs, h8=8, w8=8)
    assert got.shape == ref.shape and got.dtype == torch.int32
    _int_close(got.numpy(), ref)


def test_reconstruct_dct8_plane():
    args = [np.asarray(a) for a in __graft_entry__._example_inputs(4, 6)]
    consts = dict(
        global_scale_inv=args[6], qm_scales=args[7], quant_bias=args[8],
        quant_bias_num=args[9], opsin_inv=args[10], opsin_bias=args[11],
        itscale=args[12], maxval=args[13],
    )
    ref = np.asarray(J.reconstruct_dct8_plane(*args[:6], consts, 4, 6))
    got = T.reconstruct_dct8_plane(*args[:6], consts, 4, 6, device="cpu")
    assert got.shape == (3, 32, 48)
    _int_close(got.numpy(), ref)
