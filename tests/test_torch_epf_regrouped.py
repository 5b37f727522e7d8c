"""The EPF step as kernels B7 and B8 regroup it (csrc/filters.cu: B7's
column walk `epf_step_kernel`, B8's `epf_region`), modelled in PyTorch and
held against the plain versions (`filter_kernels.epf_step_ref`,
`epf_fused_ref`) and against the JAX package's fused EPF filter in Pallas
interpret mode.

The kernels sum each tap's distance over its 5-point cross from one
channel-weighted difference field per distinct offset (the 12-tap step's
seven offsets as five fields V1, V2, H1, DA, DB shifted, the 4-tap cross
step's four as V1 and H1), add a repeated tap's weight times its count, and
multiply the weighted sums by one reciprocal of the weight sum; the plain
versions weight each channel's cross sum, visit all twelve table entries
and divide.  The model sums a cross in B7's order, the row's horizontal
3-sum first and then the positions above and below, ((left + centre) +
right) + up + down (B8 adds centre, left, up, down, right).  Only fp32
rounding differs.  Tolerances: 2e-3 absolute on
samples of scale 50 (as tests/test_torch_filters.py holds the Pallas EPF),
1e-5 absolute on samples of scale 0.1 (XYB planes; chip_smoke.py's
XYB_ATOL).
"""

import numpy as np
import pytest
import torch

from j40_tpu.ops import pallas_filters as PF
from j40_tpu_torch.ops import filter_kernels as FK
from j40_tpu_torch.ops import filters as TF

CS = (40.0, 5.0, 3.5)
BSM = 2.78
# (field offset (dy, dx), the field's shift (sy, sx), sample (ky, kx),
# count) of each distinct tap, in csrc/filters.cu tap_of's order
V1, V2, H1, DA, DB = (-1, 0), (-2, 0), (0, -1), (-1, -1), (-1, 1)
TAPS = {
    0: [(V2, (0, 0), (0, -2), 2), (DA, (0, 0), (-1, -1), 1), (H1, (0, 0), (-1, 0), 2),
        (DB, (1, -1), (-1, 1), 3), (V1, (0, 0), (0, -1), 1), (V1, (1, 0), (0, 1), 1),
        (V2, (2, 0), (0, 2), 2)],
    1: [(V1, (0, 0), (0, -1), 1), (H1, (0, 0), (-1, 0), 1), (H1, (0, 1), (1, 0), 1),
        (V1, (1, 0), (0, 1), 1)],
}


def regrouped_step(ch, rs8, sigma_scale, kind, cs=CS, bsm=BSM):
    """One EPF step of a (3, H, W) plane as epf_region computes it."""
    _, H, W = ch.shape
    dev = ch.device
    pad = ch[:, TF._mirror_on(H, 3, dev)][:, :, TF._mirror_on(W, 3, dev)]

    def at(t, dy, dx):  # t at plane positions shifted by (dy, dx), |d| <= 3
        return t[..., 3 + dy:3 + dy + H, 3 + dx:3 + dx + W]

    def diff(q, o):  # D_o at plane positions shifted by q
        s = at(pad, *q)
        p = at(pad, q[0] + o[0], q[1] + o[1])
        d = cs[0] * (s[0] - p[0]).abs()
        d = d + cs[1] * (s[1] - p[1]).abs()
        return d + cs[2] * (s[2] - p[2]).abs()

    ss, bs = TF.step_scales(sigma_scale, bsm)
    ys, xs = torch.arange(H, device=dev), torch.arange(W, device=dev)
    border = (((xs[None, :] + 1) | (ys[:, None] + 1)) & 7) < 2
    rs = TF.rs_per_pixel(rs8, H, W)
    inv = torch.where(border, rs * bs, rs * ss)
    sw = torch.ones((H, W), device=dev)
    acc = ch.clone()
    if kind == 2:  # the plain step: distance partner (k1, k0), sample (k0, k1)
        for k0, k1 in TF.KERNELS4:
            w = torch.clamp_min(1.0 + diff((0, 0), (k1, k0)) * inv, 0.0)
            sw = sw + w
            acc = acc + at(pad, k0, k1) * w
    else:
        for o, (sy, sx), (ky, kx), m in TAPS[kind]:
            # B7's order: ((left + centre) + right) + up + down
            dist = (diff((sy, sx - 1), o) + diff((sy, sx), o) + diff((sy, sx + 1), o)
                    + diff((sy - 1, sx), o) + diff((sy + 1, sx), o))
            w = m * torch.clamp_min(1.0 + dist * inv, 0.0)
            sw = sw + w
            acc = acc + at(pad, ky, kx) * w
    return torch.where((rs < 0)[None], ch, acc * (1.0 / sw))


def test_tap_tables_are_the_reference_tables():
    """The distinct taps, their counts and their fields and shifts stand
    for KERNELS12 and KERNELS4: each distance offset (k1, k0) is its field's
    offset, or its negation -o, which is the shift (D_-o(q) = D_o(q - o))."""
    for kind, table in ((0, TF.KERNELS12), (1, TF.KERNELS4)):
        counts: dict = {}
        for k0, k1 in table:
            counts[(k0, k1)] = counts.get((k0, k1), 0) + 1
        assert {t[2]: t[3] for t in TAPS[kind]} == counts
        for o, (sy, sx), (k0, k1), _ in TAPS[kind]:
            assert (k1, k0) == (o if (sy, sx) == (0, 0) else (sy, sx))
            assert (sy, sx) in ((0, 0), (-o[0], -o[1]))


def _plane(h, w, seed, scale):
    rng = np.random.default_rng(seed)
    ch = torch.from_numpy(rng.normal(size=(3, h, w)).astype(np.float32) * scale)
    rs8 = (np.abs(rng.normal(size=(-(-h // 8), -(-w // 8)))) * 0.05 / scale * 50
           + 0.02).astype(np.float32)
    rs8[rs8.shape[0] // 2, rs8.shape[1] // 2] = -1.0
    return ch, torch.from_numpy(rs8)


@pytest.mark.parametrize("scale,atol", [(50.0, 2e-3), (0.1, 1e-5)])
@pytest.mark.parametrize("h,w", [(37, 61), (48, 64), (8, 16), (9, 3), (2, 17), (65, 113)])
def test_regrouped_step_vs_plain(h, w, scale, atol):
    ch, rs8 = _plane(h, w, h * w, scale)
    for kind, ss in ((0, 0.9), (1, 1.0), (2, 6.5)):
        got = regrouped_step(ch, rs8, ss, kind)
        want = FK.epf_step_ref(ch, rs8, ss, kind, CS, BSM)
        assert (got - want).abs().max().item() <= atol, kind


@pytest.mark.parametrize("iters", [1, 2, 3])
def test_regrouped_chain_vs_fused_ref_and_pallas(iters):
    """The chain of regrouped steps (what B8 computes on a plane whose sides
    are multiples of 8) against epf_fused_ref and the interpret-mode Pallas
    fused filter."""
    h, w = 48, 64
    ch, rs8 = _plane(h, w, 10 + iters, 50.0)
    steps = FK.frame_steps(iters, 0.9, 6.5)
    got = ch
    for ss, kind in steps:
        got = regrouped_step(got, rs8, ss, kind)
    ref = FK.epf_fused_ref(ch, rs8, steps, CS, BSM)
    assert (got - ref).abs().max().item() <= 2e-3
    rs_px = np.repeat(np.repeat(rs8.numpy(), 8, 0), 8, 1)[:h, :w]
    pallas = PF.epf_pallas(ch.numpy(), rs_px, iters=iters, channel_scale=CS, p0_scale=0.9,
                           p2_scale=6.5, border_sad_mul=BSM)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=0, atol=2e-3)
