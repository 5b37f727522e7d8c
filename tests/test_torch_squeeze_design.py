"""The CPU model of kernel S1's schedule (tools/squeeze_model.py: csrc/
squeeze.cu, the inverse Squeeze merge), held bit for bit against its plain
version (`ops/squeeze_kernels.unsqueeze_ref`) and j40_tpu's lax.scan
(`j40_tpu.parallel.sharded_lossless._inv_squeeze_h_scan`), as
tests/test_torch_wavefront_design.py models W1-W3: segments walked from
both ends of their input's range, the resolve, the re-walk, the wrap
margin; negative cases; the shared-memory layout's slots and banks; and
SmoothTendency's monotonicity and range, exhaustively on a small range.

It imports j40_tpu inside its tests only."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from j40_tpu_torch.ops import squeeze_kernels as SQ

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
from squeeze_model import (  # noqa: E402
    COL_WARPS, LANES, REGION_STAGGER, SEG_LENS, _pair, merge_inputs, model_unsqueeze, ramp,
    region_words, slots,
)

# ------------------------------------------------------------------ inputs

#: (chains, wd, wr): test_torch_unsqueeze.SHAPES; chains of several
#: segments with a ragged last one; chains of three windows (seg 16)
SHAPES = [(1, 1, 0), (6, 1, 1), (6, 2, 1), (1, 9, 8), (5, 16, 16), (7, 17, 16),
          (33, 40, 40), (33, 41, 40), (0, 5, 4), (9, 513, 512), (5, 100, 100),
          (3, 1101, 1100)]
VALUES = ("14bit", "int32", "near_edge")


def stream_merges(h=192, w=320, seed=77, shards=4):
    """The merges of a small Squeeze + YCgCo stream
    (AdvancedOptions(squeeze=True, rct_type=6), the card test's 192x320) as
    the sharded decode hands them to S1 on `shards` CPU shards: [(down,
    residu, horizontal), ...]."""
    from j40_tpu_torch.encode.advanced import AdvancedOptions, encode_modular_advanced
    from j40_tpu_torch.parallel import sharded_lossless as SL
    from j40_tpu_torch.parallel.mesh import Mesh

    rng = np.random.default_rng(seed)
    img = (np.cumsum(np.cumsum(rng.integers(-2, 3, size=(h, w, 3)), 0), 1) % 256).astype(np.uint8)
    data = encode_modular_advanced(img, options=AdvancedOptions(squeeze=True, rct_type=6))
    calls, orig = [], SL.unsqueeze

    def keep(down, residu, horizontal):
        calls.append((down.clone(), residu.clone(), horizontal))
        return orig(down, residu, horizontal)

    SL.unsqueeze = keep
    try:
        SL.decode_sharded_lossless(data, mesh=Mesh(["cpu"] * shards, ("rows",)))
    finally:
        SL.unsqueeze = orig
    return calls


def _jax_merge(down, residu, horizontal):
    import jax.numpy as jnp

    from j40_tpu.parallel import sharded_lossless as J

    if horizontal:
        return np.asarray(J._inv_squeeze_h_scan(jnp.asarray(down), jnp.asarray(residu)))
    return np.asarray(jnp.swapaxes(J._inv_squeeze_h_scan(
        jnp.swapaxes(jnp.asarray(down), 0, 1), jnp.swapaxes(jnp.asarray(residu), 0, 1)), 0, 1))


def _check(down, residu, horizontal, jax=True, **kw):
    """The model's output equals the plain version's (and j40_tpu's)."""
    d, r = torch.from_numpy(down), torch.from_numpy(residu)
    got, counts = model_unsqueeze(d, r, horizontal, **kw)
    want = SQ.unsqueeze_ref(d, r, horizontal)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    if jax and got.numel():
        np.testing.assert_array_equal(got.numpy(), _jax_merge(down, residu, horizontal))
    return counts


# ------------------------------------------------------------------- tests

@pytest.mark.parametrize("values", VALUES)
@pytest.mark.parametrize("chains,wd,wr", SHAPES)
@pytest.mark.parametrize("horizontal", [True, False], ids=["h", "v"])
def test_model_vs_plain_and_jax(horizontal, chains, wd, wr, values):
    down, residu = merge_inputs(horizontal, chains, wd, wr, values, 1000 * chains + wr)
    counts = _check(down, residu, horizontal)
    if values != "14bit" and chains and wr:
        # every window of such a chain is outside the margin: walked in full
        assert counts["margin_windows"] == chains * counts["windows"] and not counts["met"]
    elif chains and wr:
        assert not counts["margin_windows"]
        assert counts["met"] + counts["unmet"] == counts["segments"]


@pytest.mark.parametrize("seg", SEG_LENS)
@pytest.mark.parametrize("horizontal", [True, False], ids=["h", "v"])
def test_model_every_segment_length(horizontal, seg):
    """Each segment length the kernel instantiates, on chains of several
    windows with a ragged last segment."""
    down, residu = merge_inputs(horizontal, 4, 2 * LANES * seg + 13, 2 * LANES * seg + 12,
                                "14bit", seg)
    counts = _check(down, residu, horizontal, jax=False, seg=seg)
    assert counts["windows"] == 3 and counts["met"] > 0.9 * counts["segments"]


@pytest.mark.parametrize("horizontal", [True, False], ids=["h", "v"])
@pytest.mark.parametrize("chains,wd,wr", [(128, 512, 512), (3, 100, 99), (2, 1101, 1100)])
def test_model_ramp_never_meets(horizontal, chains, wd, wr):
    """The slope -1 ramp with zero residuals: no segment meets but a
    window's first (its input is exact) and the chain's last (its last
    pair's next average clamped, or zero past the chain, cuts the
    dependence), and the resolve walks them one after another."""
    down, residu = ramp(horizontal, chains, wd, wr)
    counts = _check(down, residu, horizontal, jax=(chains, wd) != (128, 512))
    per_chain = counts["windows"] * chains
    assert per_chain <= counts["met"] <= per_chain + chains
    assert counts["unmet"] == counts["segments"] - counts["met"]
    # round k walks lane k (lanes 0 and 1 in the first)
    assert counts["rounds"] == max(1, min(LANES, -(-wr // counts["seg"])) - 1)


def test_model_stream_merges():
    """Every merge of a small Squeeze + YCgCo stream on 4 shards: equal,
    nearly every segment meets within a few pairs, none outside the
    margin."""
    calls = stream_merges()
    assert len(calls) > 20
    totals = dict(segments=0, met=0, longest_rewalk=0, margin_windows=0)
    for k, (down, residu, horizontal) in enumerate(calls):
        counts = _check(down.numpy(), residu.numpy(), horizontal, jax=k % 5 == 0)
        for key in totals:
            totals[key] = (max if key == "longest_rewalk" else sum)((totals[key], counts[key]))
    assert not totals["margin_windows"]
    assert totals["met"] >= 0.95 * totals["segments"], totals
    assert totals["longest_rewalk"] <= 16, totals


@pytest.mark.parametrize("case", ["no_margin", "short_rewalk", "one_end"])
def test_model_negative_cases(case):
    """What each part of the design guards against: without the margin
    check a full-range int32 chain merges wrong; a re-walk one pair short leaves
    a wrong pair; both walks started from one end (tendency 0) miss the
    true walk."""
    values, kw = {"no_margin": ("int32", dict(margin=None)),
                  "short_rewalk": ("14bit", dict(rewalk_short=1)),
                  "one_end": ("14bit", dict(one_end=True))}[case]
    down, residu = merge_inputs(True, 64, 200, 200, values, 0)
    d, r = torch.from_numpy(down), torch.from_numpy(residu)
    got, _ = model_unsqueeze(d, r, True, **kw)
    assert not torch.equal(got, SQ.unsqueeze_ref(d, r, True))


@pytest.mark.parametrize("L", SEG_LENS)
def test_layout_slots_and_banks(L):
    """The padded rows of a warp's window: every (lane, slot) its own word
    inside the region, and at each step the 32 lanes' reads of down,
    residu and the outputs in 32 distinct banks.  The column kernel stages
    and stores 32 / COL_WARPS consecutive slots of its COL_WARPS columns
    (thread i: slot i / COL_WARPS, column i % COL_WARPS) an instruction:
    32 distinct banks for the residu and output rows, whose slots of one
    instruction never straddle two lanes' rows.  A CTA of either kernel
    (4 warps) stays within 48 KB, so no launch needs the opt-in."""
    total = 0
    for name, (stride, first, per, words) in slots(L).items():
        idx = np.array([[s * stride + first + k for k in range(per)] for s in range(LANES)])
        assert len(np.unique(idx)) == idx.size and idx.max() < words, name
        for k in range(per):
            assert len(np.unique(idx[:, k] % 32)) == LANES, (name, k)
        total += words
    assert region_words(L) == total + REGION_STAGGER == LANES * (4 * L + 5) + REGION_STAGGER
    assert max(COL_WARPS, 4) * region_words(L) * 4 <= 48 * 1024
    per = 32 // COL_WARPS  # slots of a column an instruction
    i = np.arange(32)
    col = (i % COL_WARPS) * region_words(L)
    res_stride, out_stride = slots(L)["res"][0], slots(L)["out"][0]
    for t0 in range(0, LANES * (L + 1) - per + 1, per):  # residu slot t is word t of the row
        assert len(np.unique((col + t0 + i // COL_WARPS) % 32)) == 32
    assert (2 * L) % per == 0
    for q0 in range(0, LANES * 2 * L, per):
        q = q0 + i // COL_WARPS
        assert len(np.unique((col + q // (2 * L) * out_stride + q % (2 * L)) % 32)) == 32
    assert res_stride == L + 1


def test_smooth_tendency_monotone_and_bounded():
    """The two facts the design rests on, exhaustively on the port's
    _smooth_tendency for a, n, B in [-40, 40]: T(B, a, n) non-decreasing in
    B and within [min(0, 2(a - n)), max(0, 2(a - n))] (0 where a == n)."""
    r = torch.arange(-40, 41, dtype=torch.int32)
    B, a, n = torch.meshgrid(r, r, r, indexing="ij")
    T = SQ._smooth_tendency(B, a, n)
    assert (T[1:] >= T[:-1]).all()
    an2 = 2 * (a - n)
    assert ((T >= torch.clamp(an2, max=0)) & (T <= torch.clamp(an2, min=0))).all()
    assert (T[a == n] == 0).all()


def test_pair_left_non_increasing():
    """A pair's new `left` is non-increasing in the `left` it reads, for a,
    n, B in [-40, 40] and residuals in [-20, 20]; so two walks that bracket
    the true one keep bracketing it, with the ends swapped each pair."""
    r = torch.arange(-40, 41, dtype=torch.int32)
    B, a, n = torch.meshgrid(r, r, r, indexing="ij")
    for res in range(-20, 21):
        _, left = _pair(B, a, n, torch.full_like(B, res))
        assert (left[1:] <= left[:-1]).all(), res
