"""The port's modular wavefronts (j40_tpu_torch/ops/device_entropy.py, torch
half) against j40_tpu's XLA ones on the same seeded residual planes.

Everything is integer: planes, overflow flags and the blend product must be
EQUAL.  Where a lane's WP error state leaves the exactness envelope (the
overflow flag), only the flag is compared: that lane returns to the host,
and JAX's 12-bit-limb product and the port's int64 one may differ there.
"""

import numpy as np
import pytest
import torch

from j40_tpu.modular.wp import WPParams as JWPParams
from j40_tpu.ops import device_entropy as JDE
from j40_tpu_torch.modular.wp import WPParams
from j40_tpu_torch.ops import device_entropy as DE

L, H, W = 3, 13, 17


def _res(seed, lo=-9, hi=10, shape=(L, H, W)):
    return np.random.default_rng(seed).integers(lo, hi, size=shape).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_unpack_signed():
    u = np.arange(0, 200, dtype=np.int32).reshape(2, 100)
    np.testing.assert_array_equal(DE.unpack_signed_dev(_t(u)).numpy(),
                                  np.asarray(JDE.unpack_signed_dev(u)))


@pytest.mark.parametrize("predictor", [0, 1, 2, 5])
@pytest.mark.parametrize("shape", [(L, H, W), (2, 1, 9), (2, 7, 1), (1, 40, 72)])
def test_reconstruct_channel(predictor, shape):
    res = _res(predictor + shape[1], shape=shape)
    got = DE.reconstruct_channel(_t(res), predictor, shape[1], shape[2])
    want = JDE.reconstruct_channel(__import__("jax").numpy.asarray(res), predictor,
                                   shape[1], shape[2])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_gradient_reconstruct_corner():
    res = np.zeros((2, 40, 72), np.int32)
    res[:, 0, 0] = 100
    got = DE.gradient_reconstruct(_t(res), 40, 72)
    np.testing.assert_array_equal(got.numpy(), np.full_like(res, 100))


@pytest.mark.parametrize("codes", [(0, 1, 2, 5), (5, 1), (2,)])
def test_mixed_reconstruct(codes):
    res = _res(3)
    pcode = np.random.default_rng(4).choice(codes, size=res.shape).astype(np.int32)
    got = DE.mixed_reconstruct(_t(res), _t(pcode), H, W)
    want = JDE.mixed_reconstruct(res, pcode, H, W)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


PARAMS = {
    "default": (WPParams(), JWPParams()),
    "custom": (WPParams(p1=9, p2=14, p3=(2, 11, 5, 1, 3), w=(11, 13, 14, 12)),
               JWPParams(p1=9, p2=14, p3=(2, 11, 5, 1, 3), w=(11, 13, 14, 12))),
}


def _same_wp(got, want):
    (gv, gf), (wv, wf) = got, want
    wv, wf = np.asarray(wv), np.asarray(wf)
    np.testing.assert_array_equal(gf.numpy(), wf)
    keep = ~wf
    np.testing.assert_array_equal(gv.numpy()[keep], wv[keep])
    return wf


@pytest.mark.parametrize("params", list(PARAMS))
@pytest.mark.parametrize("shape", [(L, H, W), (2, 1, 11), (2, 9, 2)])
def test_wp_reconstruct(params, shape):
    p, jp = PARAMS[params]
    res = _res(7 + shape[2], lo=-40, hi=41, shape=shape)
    got = DE.wp_reconstruct_ovf(_t(res), None, shape[1], shape[2], p)
    flags = _same_wp(got, JDE.wp_reconstruct_ovf(res, None, shape[1], shape[2], jp))
    assert not flags.any()
    np.testing.assert_array_equal(DE.wp_reconstruct(_t(res), None, shape[1], shape[2], p),
                                  got[0])


@pytest.mark.parametrize("params", list(PARAMS))
def test_wp_reconstruct_mixed_predictors(params):
    """Per-pixel codes 0-12 (every predictor the d = 2y+x skew orders)."""
    p, jp = PARAMS[params]
    res = _res(11, lo=-30, hi=31)
    pcode = np.random.default_rng(12).integers(0, 13, size=res.shape).astype(np.int32)
    got = DE.wp_reconstruct_ovf(_t(res), _t(pcode), H, W, p)
    assert not _same_wp(got, JDE.wp_reconstruct_ovf(res, pcode, H, W, jp)).any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_wp_large_magnitudes_flag(seed):
    """int16-range residuals that swing hard: the overflow flag equals
    JAX's lane for lane, and the kept lanes equal it exactly."""
    rng = np.random.default_rng(seed)
    res = rng.choice([-30000, -1, 0, 1, 30000], size=(6, 24, 31)).astype(np.int32)
    res[::2] = rng.integers(-20000, 20001, size=res[::2].shape)
    p, jp = PARAMS["default"]
    got = DE.wp_reconstruct_ovf(_t(res), None, 24, 31, p)
    _same_wp(got, JDE.wp_reconstruct_ovf(res, None, 24, 31, jp))


def test_wp_flag_raised():
    """A plane that drives the error state past 2^24 is flagged on both."""
    res = np.zeros((2, 8, 40), np.int32)
    res[0, :, ::2] = 2 ** 28
    res[0, :, 1::2] = -2 ** 28
    p, jp = PARAMS["default"]
    flags = _same_wp(DE.wp_reconstruct_ovf(_t(res), None, 8, 40, p),
                     JDE.wp_reconstruct_ovf(res, None, 8, 40, jp))
    assert flags.tolist() == [True, False]


def _key(spec):
    """tests/test_device_modular.py:169-177's tree specs as device_modular's
    flattened tree keys: branches (prop, value, left, right), leaves (-pred,)
    or (-pred, offset, multiplier)."""
    out = []
    for n in spec:
        if n[0] < 0 or (len(n) == 1):
            pred = -n[0]
            off, mult = (n[1], n[2]) if len(n) == 3 else (0, 1)
            out.append((-1, 0, 0, 0, pred, off, mult))
        else:
            out.append((*n, 0, 0, 0))
    return tuple(out)


TREES = {
    "w_branch": [(7, 0, 1, 2), (-5,), (-1,)],
    "e3_wp": [(15, 0, 1, 2), (-6,), (-5,)],
    "mixed": [(0, 0, 1, 2), (8, 3, 3, 4), (-5,), (-2,), (-1,)],
    "offsets": [(1, 40, 1, 2), (-6, 3, 2), (9, -2, 3, 4), (-12, -1, 1), (-4, 0, 3)],
}


@pytest.mark.parametrize("tree", list(TREES))
@pytest.mark.parametrize("cidx", [0, 2])
def test_tree_wp_reconstruct(tree, cidx):
    key = _key(TREES[tree])
    res = _res(21 + cidx, lo=-12, hi=13)
    sidx = np.asarray([30, 41, 52], np.int32)
    p, jp = PARAMS["custom" if tree == "offsets" else "default"]
    got = DE.tree_wp_reconstruct(_t(res), key, cidx, _t(sidx), H, W, p)
    want = JDE.tree_wp_reconstruct(res, key, cidx, sidx, H, W, jp)
    assert not _same_wp(got, want).any()


def test_mul_shr24():
    rng = np.random.default_rng(5)
    a = rng.integers(-(2 ** 30) + 1, 2 ** 30, size=4000).astype(np.int32)
    b = rng.integers(1, 2 ** 24 + 1, size=4000).astype(np.int32)
    a[:4] = [0, -1, 2 ** 30 - 1, -(2 ** 30) + 1]
    b[:4] = [2 ** 24, 1, 2 ** 24, 2 ** 24]
    got = DE._mul_shr24(_t(a), _t(b)).numpy()
    np.testing.assert_array_equal(got, np.asarray(JDE._mul_shr24(a, b)))
    np.testing.assert_array_equal(got, (a.astype(np.int64) * b) >> 24)


def test_ilog2_and_half_sum():
    n = np.arange(1, 5000, dtype=np.int32)
    np.testing.assert_array_equal(DE._ilog2(_t(n)).numpy(), np.asarray(JDE._ilog2(n)))
    a, b = _res(8, -50, 51, (400,)), _res(9, -50, 51, (400,))
    np.testing.assert_array_equal(DE._trunc_half_sum_dev(_t(a), _t(b)).numpy(),
                                  np.asarray(JDE._trunc_half_sum_dev(a, b)))
