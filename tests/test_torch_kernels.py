"""Each kernel's plain PyTorch version (j40_tpu_torch/ops/kernels.py) against
the Pallas kernel it replaces (j40_tpu/ops/pallas_kernels.py, which runs in
interpret mode off the TPU), on the same numpy inputs.  The CUDA kernels
against these plain versions: tests/test_torch_cuda.py.

Tolerances: float samples within 1e-4 absolute (fp32 sums in another
order, and the kernels' FMA contraction); quantized sRGB within 1 level
(a sample that close to a rounding boundary may round either way), or
within 1e-5 of the value where pre-clamp sRGB lies far outside [0, maxval]
and carries fp32's relative error instead.  The inputs follow the ranges
of a real stream's LF group (hfmul_inv 1/8, CfL factors near 0 and 1).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from j40_tpu.headers.image import (
    OPSIN_BIAS, OPSIN_INV_MAT, QUANT_BIAS, QUANT_BIAS_NUM,
)
from j40_tpu.ops import combine_jax as CJ
from j40_tpu.ops import pallas_kernels as PK
from j40_tpu.vardct.dequant import DqMatrix, load_dq_matrix
from j40_tpu_torch.ops import combine as TC
from j40_tpu_torch.ops import kernels as K

FTOL = 1e-4
# (h8, w8): one 64-block plane, and a ragged one that is a multiple of
# neither the Pallas tile (512) nor the CUDA tile (16)
SIZES = [(8, 8), (23, 29)]


def _consts22(maxval):
    return np.concatenate([
        [65536.0 / 32768.0, 0.8, 1.25, *QUANT_BIAS, QUANT_BIAS_NUM, 0.0],
        np.asarray(OPSIN_INV_MAT, np.float64).ravel(),
        [OPSIN_BIAS] * 3, [1.0, maxval],
    ]).astype(np.float32)


def _inputs(h8, w8, exceptions, seed=0):
    """Integer coefficients (3, n, 64) as float32, aux (6, n), weights."""
    rng = np.random.default_rng(seed + 100 * h8 + w8)
    n = h8 * w8
    q = rng.integers(-6, 7, size=(3, n, 64)).astype(np.float32)
    q[rng.random(q.shape) < 0.6] = 0.0
    if exceptions:
        m = rng.random(q.shape) < 0.01
        q[m] = rng.choice([-1, 1], m.sum()) * rng.integers(128, 400, m.sum())
    y = rng.uniform(0.05, 0.6, n)
    aux = np.stack([
        rng.normal(size=n) * 0.01, y, y + rng.normal(size=n) * 0.05,
        rng.uniform(0.1, 0.2, n), rng.normal(size=n) * 0.05,
        1.0 + rng.normal(size=n) * 0.05,
    ]).astype(np.float32)
    return q, aux, load_dq_matrix(0, DqMatrix())


def _int_close(a, b):
    a, b = np.asarray(a, np.int64), np.asarray(b, np.int64)
    assert a.shape == b.shape
    d = np.abs(a - b)
    assert (d <= np.maximum(1, 1e-5 * np.abs(b))).all(), d.max()


def _t(a):
    return torch.from_numpy(np.array(a))


def test_idct8_matrix_is_the_pallas_one():
    np.testing.assert_array_equal(K.idct8_matrix(), PK.idct8_matrix())


@pytest.mark.parametrize("h8,w8", SIZES)
def test_reconstruct_dct8_srgb_ref_vs_pallas(h8, w8):
    q, aux, w = _inputs(h8, w8, exceptions=False)
    c22 = _consts22(255.0)
    ref = np.asarray(PK.reconstruct_dct8_srgb_pallas(
        jnp.asarray(q), jnp.asarray(aux[0:3]), jnp.asarray(aux[3]),
        jnp.asarray(aux[4]), jnp.asarray(aux[5]), jnp.asarray(w),
        jnp.asarray(c22), h8, w8))
    got = K.reconstruct_dct8_srgb_ref(_t(q), _t(aux), _t(w), _t(c22), h8, w8,
                                      to_u8=False)
    assert got.dtype == torch.int32
    _int_close(got.numpy(), ref)


@pytest.mark.parametrize("to_u8", [True, False])
@pytest.mark.parametrize("exceptions", [False, True])
@pytest.mark.parametrize("h8,w8", SIZES)
def test_reconstruct_dct8_full_vs_pallas(h8, w8, exceptions, to_u8):
    q, aux, w = _inputs(h8, w8, exceptions)
    c22 = _consts22(255.0 if to_u8 else 4095.0)
    packed = TC._pack_i8(q)
    for a, b in zip(packed, CJ._pack_i8(q)):
        np.testing.assert_array_equal(a, b)
    cup, eidx, evals = packed
    assert (len(np.flatnonzero(np.abs(q) > 127)) > 0) == exceptions
    ref = np.asarray(PK.reconstruct_dct8_full(
        jnp.asarray(cup), jnp.asarray(eidx), jnp.asarray(evals),
        jnp.asarray(aux), jnp.asarray(w), jnp.asarray(c22), h8, w8, to_u8))
    dense = K.unpack_i8(_t(cup), _t(eidx), _t(evals))
    np.testing.assert_array_equal(dense.numpy(), q)
    got = K.reconstruct_dct8_full(_t(cup), _t(eidx), _t(evals), _t(aux),
                                  _t(w), _t(c22), h8, w8, to_u8)
    assert got.dtype == (torch.uint8 if to_u8 else torch.int32)
    _int_close(got.numpy(), ref)


@pytest.mark.parametrize("h8,w8", SIZES)
def test_reconstruct_dct8_ref_vs_pallas(h8, w8):
    q, aux, w = _inputs(h8, w8, exceptions=True)
    q[:, ::3] = 0.0  # zero cells, as a mixed group's big-block cells are
    aux[:, ::3] = 0.0
    c8 = _consts22(255.0)[:8]
    ref = np.asarray(PK.reconstruct_dct8_pallas(
        jnp.asarray(q), jnp.asarray(aux[0:3]), jnp.asarray(aux[3]),
        jnp.asarray(aux[4]), jnp.asarray(aux[5]), jnp.asarray(w),
        jnp.asarray(c8), h8, w8))
    got = K.reconstruct_dct8(_t(q), _t(aux), _t(w), _t(c8), h8, w8).numpy()
    assert got.shape == ref.shape == (3, 8 * h8, 8 * w8)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=FTOL)


@pytest.mark.parametrize("shape", [(3, 37, 64), (3, 300, 2048)])
def test_xyb_to_srgb_ref_vs_pallas(shape):
    """H is a multiple of neither Pallas stripe height (40 and 32 rows)."""
    rng = np.random.default_rng(shape[1])
    plane = rng.normal(size=shape).astype(np.float32) * 0.3
    plane[0] *= 0.05
    c22 = _consts22(255.0)
    ref = np.asarray(PK.xyb_to_srgb_pallas(jnp.asarray(plane), jnp.asarray(c22)))
    for to_u8 in (False, True):
        got = K.xyb_to_srgb(_t(plane), _t(c22), to_u8).numpy()
        _int_close(got, np.clip(ref, 0, 255) if to_u8 else ref)


def test_wrappers_refuse_bad_inputs():
    q, aux, w = _inputs(2, 3, exceptions=False)
    c22 = _t(_consts22(255.0))
    with pytest.raises(ValueError):
        K.reconstruct_dct8_srgb(_t(q)[:, :5], _t(aux), _t(w), c22, 2, 3)
    with pytest.raises(ValueError):
        K.reconstruct_dct8(_t(q).double(), _t(aux), _t(w), c22[:8], 2, 3)
    with pytest.raises(ValueError):
        K.xyb_to_srgb(_t(q).reshape(3, 48, 8).transpose(1, 2), c22)
