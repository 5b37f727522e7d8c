"""The inverse Squeeze merge's plain version (j40_tpu_torch/ops/squeeze_kernels.py,
the CPU branch of `unsqueeze`, which kernel S1 is held to on the card)
against j40_tpu's scan (`j40_tpu.parallel.sharded_lossless._inv_squeeze_h_scan`,
a vertical merge as the scan of the transposes, as j40_tpu's program runs
it) and the spec oracle (`modular.transforms._inv_squeeze_h`/`_v`), on
planes made from a numpy seed, both axes, equal bit for bit.

The oracle computes in int64, so it is held only where no int32 sum wraps
(samples of at most 2^26 in magnitude); near the int32 edge the plain
version and j40_tpu's scan, both int32 with two's-complement wrap, still
agree bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from j40_tpu.parallel import sharded_lossless as J
from j40_tpu_torch.modular import transforms as T
from j40_tpu_torch.ops import squeeze_kernels as SQ

# (chains, wd, wr): wr = 0; wd == wr (the last next average clamped) and
# wd == wr + 1 (odd width: down's last sample appended); one chain; more
# pairs than the kernel's 32-pair chunk; no chain
SHAPES = [(1, 1, 0), (6, 1, 1), (6, 2, 1), (1, 9, 8), (5, 16, 16), (7, 17, 16),
          (33, 40, 40), (33, 41, 40), (0, 5, 4)]
VALUES = {"14bit": (-(1 << 13), 1 << 13), "int32": (-(1 << 31), 1 << 31),
          "near_edge": None}


def _plane(rng, shape, values):
    if values == "near_edge":  # within 1000 of either end of int32
        v = rng.integers(0, 1000, shape, dtype=np.int64)
        v = np.where(rng.random(shape) < 0.5, (1 << 31) - 1 - v, -(1 << 31) + v)
    else:
        v = rng.integers(*VALUES[values], shape, dtype=np.int64)
    return v.astype(np.int32)


def _jax_merge(down, residu, horizontal):
    if horizontal:
        return np.asarray(J._inv_squeeze_h_scan(jnp.asarray(down), jnp.asarray(residu)))
    return np.asarray(jnp.swapaxes(J._inv_squeeze_h_scan(
        jnp.swapaxes(jnp.asarray(down), 0, 1), jnp.swapaxes(jnp.asarray(residu), 0, 1)), 0, 1))


@pytest.mark.parametrize("values", list(VALUES))
@pytest.mark.parametrize("chains,wd,wr", SHAPES)
@pytest.mark.parametrize("horizontal", [True, False], ids=["h", "v"])
def test_plain_vs_jax_scan_and_oracle(horizontal, chains, wd, wr, values):
    rng = np.random.default_rng(1000 * chains + 10 * wd + wr)
    if horizontal:
        down, residu = _plane(rng, (chains, wd), values), _plane(rng, (chains, wr), values)
    else:
        down, residu = _plane(rng, (wd, chains), values), _plane(rng, (wr, chains), values)
    got = SQ.unsqueeze(torch.from_numpy(down), torch.from_numpy(residu), horizontal).numpy()
    want_shape = (chains, wd + wr) if horizontal else (wd + wr, chains)
    assert got.shape == want_shape and got.dtype == np.int32
    if chains:
        np.testing.assert_array_equal(got, _jax_merge(down, residu, horizontal))
    if values == "14bit":
        oracle = T._inv_squeeze_h if horizontal else T._inv_squeeze_v
        np.testing.assert_array_equal(got, oracle(down, residu))


def test_smooth_tendency_every_sign_case():
    """Every (B, a, n) of -6..6 and the same scaled by 2^20: increasing,
    decreasing and flat neighbourhoods, each clamp taken and not, against
    j40_tpu and the oracle."""
    r = np.arange(-6, 7)
    B, a, n = (v.ravel() for v in np.meshgrid(r, r, r, indexing="ij"))
    B, a, n = (np.concatenate([v, v << 20, (v << 20) + 3]).astype(np.int32) for v in (B, a, n))
    b64, a64, n64 = (v.astype(np.int64) for v in (B, a, n))
    inc = (b64 >= a64) & (a64 >= n64)
    dec = (b64 <= a64) & (a64 <= n64) & ~inc
    d_inc = T._trunc_div_vec(4 * b64 - 3 * n64 - a64 + 6, 12)
    d_dec = T._trunc_div_vec(4 * b64 - 3 * n64 - a64 - 6, 12)
    cases = {
        "inc, first clamp": inc & (d_inc - (d_inc & 1) > 2 * (b64 - a64)),
        "inc, second clamp": inc & (d_inc + (d_inc & 1) > 2 * (a64 - n64)),
        "inc, no clamp": inc & (d_inc - (d_inc & 1) <= 2 * (b64 - a64))
                         & (d_inc + (d_inc & 1) <= 2 * (a64 - n64)),
        "dec, first clamp": dec & (d_dec + (d_dec & 1) < 2 * (b64 - a64)),
        "dec, second clamp": dec & (d_dec - (d_dec & 1) < 2 * (a64 - n64)),
        "dec, no clamp": dec & (d_dec + (d_dec & 1) >= 2 * (b64 - a64))
                         & (d_dec - (d_dec & 1) >= 2 * (a64 - n64)),
        "neither": ~inc & ~dec,
    }
    assert all(m.any() for m in cases.values()), {k: int(m.sum()) for k, m in cases.items()}
    got = SQ._smooth_tendency(*(torch.from_numpy(v) for v in (B, a, n))).numpy()
    np.testing.assert_array_equal(got, np.asarray(J._smooth_tendency(
        *(jnp.asarray(v) for v in (B, a, n)))))
    np.testing.assert_array_equal(got, T._smooth_tendency(B, a, n))


@pytest.mark.parametrize("horizontal", [True, False], ids=["h", "v"])
def test_column_shard_views(horizontal):
    """The shards a sharded merge gives the wrapper, non-contiguous views of
    the whole planes, merge as their contiguous copies do."""
    rng = np.random.default_rng(3)
    shape_d, shape_r = ((40, 17), (40, 16)) if horizontal else ((17, 40), (16, 40))
    down = torch.from_numpy(_plane(rng, shape_d, "14bit"))
    residu = torch.from_numpy(_plane(rng, shape_r, "14bit"))
    ax = 0 if horizontal else 1
    for a, b in zip(torch.tensor_split(down, 3, dim=ax), torch.tensor_split(residu, 3, dim=ax)):
        assert horizontal or not a.is_contiguous()
        np.testing.assert_array_equal(SQ.unsqueeze(a, b, horizontal).numpy(),
                                      SQ.unsqueeze(a.contiguous(), b.contiguous(),
                                                   horizontal).numpy())


@pytest.mark.parametrize("case", ["heights", "too_wide", "too_narrow", "dtype", "dims"])
def test_unsqueeze_refuses(case):
    down, residu = torch.zeros(4, 5, dtype=torch.int32), torch.zeros(4, 4, dtype=torch.int32)
    if case == "heights":
        residu = torch.zeros(3, 4, dtype=torch.int32)
    elif case == "too_wide":
        down = torch.zeros(4, 6, dtype=torch.int32)
    elif case == "too_narrow":
        down = torch.zeros(4, 3, dtype=torch.int32)
    elif case == "dtype":
        down = down.to(torch.int64)
    else:
        down = down[None]
    with pytest.raises(ValueError):
        SQ.unsqueeze(down, residu, True)
