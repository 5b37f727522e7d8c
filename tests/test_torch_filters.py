"""The restoration filters of the port, module by module: the torch half of
`j40_tpu_torch/ops/filters.py` against the JAX package's XLA filters, and
the plain versions of the three filter kernels (`ops/filter_kernels.py`,
which the CPU runs in place of csrc/filters.cu) against the Pallas kernels
they replace, run in interpret mode as tests/test_filters.py runs them.

Inputs are made from a numpy seed.  Tolerance: atol=2e-3 on samples of
scale 50, as tests/test_filters.py holds the Pallas EPF to the oracle: the
sums of up to 13 weighted taps run in another order.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from j40_tpu.ops import filters as JF
from j40_tpu.ops import pallas_filters as PF
from j40_tpu_torch.ops import filter_kernels as FK
from j40_tpu_torch.ops import filters as TF

ATOL = 2e-3
CS = (40.0, 5.0, 3.5)
BSM = 2.78
GAB_W = ((0.115, 0.061), (0.1, 0.05), (0.12, 0.06))
# (kind, sigma scale): bench.py _bench_device_filters' three steps
STEPS = [(0, 0.9), (1, 1.0), (2, 6.5)]


def _plane(h, w, seed, skip=(0, 1)):
    """(3, h, w) samples of scale 50 and per-block reciprocal sigmas with
    one skipped block."""
    rng = np.random.default_rng(seed)
    ch = rng.normal(size=(3, h, w)).astype(np.float32) * 50
    rs8 = (np.abs(rng.normal(size=(-(-h // 8), -(-w // 8)))) * 0.05
           + 0.02).astype(np.float32)
    rs8[min(skip[0], rs8.shape[0] - 1), min(skip[1], rs8.shape[1] - 1)] = -1.0
    return ch, rs8


def _rs_px(rs8, h, w):
    return np.repeat(np.repeat(rs8, 8, 0), 8, 1)[:h, :w]


def _close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)


def test_gaborish_torch_vs_jax():
    ch, _ = _plane(37, 61, 1)
    _close(TF.gaborish_torch(torch.from_numpy(ch), GAB_W),
           JF.gaborish_jax(ch, GAB_W))


def test_gaborish_ref_vs_pallas():
    ch, _ = _plane(37, 61, 2)
    _close(FK.gaborish_ref(torch.from_numpy(ch), GAB_W),
           PF.gaborish_pallas(ch, GAB_W))
    # the wrapper takes a CPU tensor to its plain version
    _close(FK.gaborish(torch.from_numpy(ch), GAB_W), JF.gaborish(ch, GAB_W))


@pytest.mark.parametrize("kind,ss", STEPS, ids=["12cross", "4cross", "4plain"])
def test_epf_step_vs_jax_and_pallas(kind, ss):
    h, w = 37, 61
    ch, rs8 = _plane(h, w, 3 + kind)
    kern, cross = FK.STEP_KERNELS[kind]
    rs_px = _rs_px(rs8, h, w)
    t = TF._epf_step_torch(torch.from_numpy(ch), torch.from_numpy(rs_px), ss,
                           kern, cross, CS, BSM)
    ref = FK.epf_step_ref(torch.from_numpy(ch), torch.from_numpy(rs8), ss, kind,
                          CS, BSM)
    np.testing.assert_array_equal(t.numpy(), ref.numpy())
    _close(t, JF._epf_step_jax(ch, rs_px, ss, kern, cross, CS, BSM))
    sigma, border = TF.step_scales(ss, BSM)
    _close(ref, PF._epf_step_pallas(ch, rs_px, kernels=kern, cross=cross,
                                    sigma_scale=sigma, border_scale=border,
                                    channel_scale=CS))
    _close(ref, JF.epf_step(ch, ss, rs8, kern, cross, CS, BSM))
    # the skipped block passes through untouched
    np.testing.assert_array_equal(ref.numpy()[:, :8, 8:16], ch[:, :8, 8:16])
    assert np.abs(ref.numpy() - ch).max() > 1.0  # the other blocks moved


@pytest.mark.parametrize("y0", [5, 16])
def test_epf_step_rows_vs_jax(y0):
    h, w = 24, 43
    rng = np.random.default_rng(y0)
    rows = rng.normal(size=(3, h + 6, w)).astype(np.float32) * 50
    rs_px = (np.abs(rng.normal(size=(h, w))) * 0.05 + 0.02).astype(np.float32)
    rs_px[3:9, 10:20] = -1.0
    for kind, ss in STEPS:
        kern, cross = FK.STEP_KERNELS[kind]
        got = TF._epf_step_torch_rows(
            torch.from_numpy(rows), torch.from_numpy(rows[:, 3:-3]),
            torch.from_numpy(rs_px), y0, ss, kern, cross, CS, BSM)
        _close(got, JF._epf_step_jax_rows(rows, rows[:, 3:-3], rs_px, y0, ss,
                                          kern, cross, CS, BSM))


@pytest.mark.parametrize("iters", [1, 2, 3])
def test_epf_fused_ref_vs_pallas(iters):
    h, w = 48, 64
    ch, rs8 = _plane(h, w, 10 + iters, skip=(2, 3))
    steps = FK.frame_steps(iters, 0.9, 6.5)
    assert [k for _, k in steps] == {1: [1], 2: [1, 2], 3: [0, 1, 2]}[iters]
    ref = FK.epf_fused_ref(torch.from_numpy(ch), torch.from_numpy(rs8), steps,
                           CS, BSM)
    # h and w are multiples of 8, so epf_pallas takes _epf_fused_pallas
    _close(ref, PF.epf_pallas(ch, _rs_px(rs8, h, w), iters=iters,
                              channel_scale=CS, p0_scale=0.9, p2_scale=6.5,
                              border_sad_mul=BSM))
    got = FK.epf_fused(torch.from_numpy(ch), torch.from_numpy(rs8), steps, CS, BSM)
    np.testing.assert_array_equal(got.numpy(), ref.numpy())
    _close(got, TF.epf_steps_torch(
        torch.from_numpy(ch), torch.from_numpy(_rs_px(rs8, h, w)), iters=iters,
        channel_scale=CS, p0_scale=0.9, p2_scale=6.5, border_sad_mul=BSM))


@pytest.mark.parametrize("h,w,route", [(37, 61, "step"), (48, 64, "fused"),
                                       (40, 61, "step"), (16, 8, "fused")])
def test_epf_device_dispatch(h, w, route, monkeypatch):
    """One fused pass on planes whose sides are multiples of 8, one
    single-step call per step otherwise (pallas_filters.epf_pallas's rule)."""
    calls = []
    for name in ("epf_step", "epf_fused"):
        real = getattr(FK, name)
        monkeypatch.setattr(FK, name, lambda *a, _n=name, _r=real, **k:
                            calls.append(_n) or _r(*a, **k))
    ch, rs8 = _plane(h, w, 20)
    got = FK.epf_device(torch.from_numpy(ch), torch.from_numpy(rs8), iters=3,
                        channel_scale=CS, p0_scale=0.9, p2_scale=6.5,
                        border_sad_mul=BSM)
    assert calls == (["epf_fused"] if route == "fused" else ["epf_step"] * 3)
    _close(got, JF._epf_steps_jit()(ch, _rs_px(rs8, h, w), iters=3,
                                    channel_scale=CS, p0_scale=0.9, p2_scale=6.5,
                                    border_sad_mul=BSM))


def _modular_state(iters):
    f = SimpleNamespace(
        epf_iters=iters, epf_channel_scale=[40.0, 5.0, 3.5], epf_quant_mul=0.46,
        epf_pass0_sigma_scale=0.9, epf_pass2_sigma_scale=6.5,
        epf_border_sad_mul=2 / 3, epf_sigma_for_modular=1.0,
        epf_sharp_lut=[i / 7.0 for i in range(8)],
    )
    return SimpleNamespace(fs=SimpleNamespace(f=f))


@pytest.mark.parametrize("iters", [0, 2, 3])
@pytest.mark.parametrize("h,w", [(32, 32), (29, 35)])
def test_epf_from_state_vs_jax(iters, h, w):
    ch = np.random.default_rng(6).normal(size=(3, h, w)).astype(np.float32) * 0.1
    vs = _modular_state(iters)
    ref = np.asarray(JF.epf_jax(ch, vs, None, is_modular=True))
    _close(TF.epf_torch(torch.from_numpy(ch), vs, None, is_modular=True), ref)
    _close(FK.epf_from_state(torch.from_numpy(ch), vs, None, is_modular=True), ref)
    if iters:
        assert np.abs(ref - ch).max() > 1e-3


def test_wrappers_check_inputs():
    ch, rs8 = _plane(37, 61, 30)
    t, r = torch.from_numpy(ch), torch.from_numpy(rs8)
    with pytest.raises(ValueError):
        FK.gaborish(t[:2], GAB_W)
    with pytest.raises(ValueError):
        FK.gaborish(t.transpose(1, 2), GAB_W)
    with pytest.raises(ValueError):
        FK.epf_step(t, r[:, :-1], 1.0, 1, CS, BSM)
    with pytest.raises(ValueError):
        FK.epf_step(t.double(), r, 1.0, 1, CS, BSM)
    with pytest.raises(ValueError):
        FK.epf_step(t, r, 1.0, 3, CS, BSM)
    with pytest.raises(ValueError):  # the fused pass wants 8-multiple sides
        FK.epf_fused(t, r, FK.frame_steps(3, 0.9, 6.5), CS, BSM)
