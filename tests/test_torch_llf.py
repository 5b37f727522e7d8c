"""The LLF coefficients of varblocks larger than DCT8, as the port's native
varblock placement fills them (`vardct/state.py::fill_large_llf`: one
stacked forward DCT a shape of LF block, not one call a varblock).

Checked: for each of the 17 shapes of LF block that DctSelect allows, on
random LF planes and a random valid layout with blocks at the group's right
and bottom edges, the batched fill equals `forward_dct2d_scaled_for_llf`
block by block, bit for bit; a mixed camera stream of two LF groups reads
the same `llfcoeffs`, `blocks` and `vb_coeffoff` with the native core as
through the Python placement loop (the oracle), and the same `llfcoeffs`
as `j40_tpu`'s host decode; each LF group's `vardct.lf_group` span counts
its varblocks and the batched ones.
"""

import functools
import json

import numpy as np
import pytest

from j40_tpu.decode import Decoder as JDecoder
from j40_tpu_torch.decode import Decoder as TDecoder
from j40_tpu_torch.modular import decode as MD
from j40_tpu_torch.vardct.dct import forward_dct2d_scaled_for_llf
from j40_tpu_torch.vardct.state import fill_large_llf
from j40_tpu_torch.vardct.tables import DCT_SELECT
from jxlbench import spec
from jxlbench.images import camera

NAME, PARENT, START, END, CPU, COUNTS = range(6)
#: the LF-block shapes (vh8, vw8) of the varblocks larger than DCT8
SHAPES = sorted({(1 << (lh - 3), 1 << (lw - 3)) for lh, lw, *_ in DCT_SELECT
                 if lh > 3 or lw > 3})
#: (height, width): two LF groups side by side, and one above the other
FRAMES = [(256, 2304), (2304, 256)]


def test_shapes():
    assert len(SHAPES) == 17
    assert SHAPES[0] == (1, 2) and SHAPES[-1] == (32, 32)


def _layout(rng, shapes, ggh8, ggw8):
    """A valid raster layout of DCT8 cells and varblocks of `shapes`:
    (logs, y8, x8, coeffoff) a varblock.  The last of `shapes` sits in the
    group's bottom right corner; elsewhere each shape goes where it first
    fits, and then a varblock that fits is placed where it reaches the right
    or bottom edge, and elsewhere with probability 1/2."""
    ch, cw = shapes[-1]
    covered = np.zeros((ggh8, ggw8), bool)
    covered[ggh8 - ch:, ggw8 - cw:] = True  # kept for the corner block
    logs, ys, xs, offs = [], [], [], []
    off = 0
    seen = set()
    for y in range(ggh8):
        for x in range(ggw8):
            vh8 = vw8 = 1
            if (y, x) == (ggh8 - ch, ggw8 - cw):
                vh8, vw8 = ch, cw
            elif covered[y, x]:
                continue
            elif fits := [(h, w) for h, w in shapes if y + h <= ggh8 and x + w <= ggw8
                          and not covered[y:y + h, x:x + w].any()]:
                fresh = [s for s in fits if s not in seen]
                h, w = fresh[0] if fresh else fits[rng.integers(len(fits))]
                if fresh or y + h == ggh8 or x + w == ggw8 or rng.random() < 0.5:
                    vh8, vw8 = h, w
                    seen.add((h, w))
            covered[y:y + vh8, x:x + vw8] = True
            logs.append((vh8.bit_length() + 2, vw8.bit_length() + 2))
            ys.append(y)
            xs.append(x)
            offs.append(off)
            off += 64 * vh8 * vw8
    assert covered.all()
    return (np.asarray(logs, np.int32), np.asarray(ys, np.int64),
            np.asarray(xs, np.int64), np.asarray(offs, np.int64))


@pytest.mark.parametrize("shapes", [[s] for s in SHAPES]
                         + [sorted(SHAPES, key=lambda s: -s[0] * s[1])],
                         ids=[f"{h}x{w}" for h, w in SHAPES] + ["all"])
def test_batched_fill_matches_per_block(shapes):
    rng = np.random.default_rng(sum(h * 37 + w for h, w in shapes))
    vh8 = max(h for h, _ in shapes)
    vw8 = max(w for _, w in shapes)
    ggh8, ggw8 = 2 * vh8 + 5, 2 * vw8 + 7
    lfquant = [(rng.standard_normal((ggh8, ggw8)) * 10.0 ** rng.integers(-3, 3))
               .astype(np.float32) for _ in range(3)]
    logs, y8, x8, coeffoff = _layout(rng, shapes, ggh8, ggw8)
    big = np.nonzero((logs[:, 0] > 3) | (logs[:, 1] > 3))[0]
    ends = [(y8[i] + (1 << (logs[i, 0] - 3)), x8[i] + (1 << (logs[i, 1] - 3))) for i in big]
    assert any(e[0] == ggh8 for e in ends) and any(e[1] == ggw8 for e in ends)
    assert {(1 << (logs[i, 0] - 3), 1 << (logs[i, 1] - 3)) for i in big} == set(shapes)

    want = [np.zeros(ggh8 * ggw8, np.float32) for _ in range(3)]
    for i in big:
        h, w = 1 << (logs[i, 0] - 3), 1 << (logs[i, 1] - 3)
        o = coeffoff[i] >> 6
        for c in range(3):
            want[c][o:o + h * w] = forward_dct2d_scaled_for_llf(
                lfquant[c][y8[i]:y8[i] + h, x8[i]:x8[i] + w])
    got = [np.zeros(ggh8 * ggw8, np.float32) for _ in range(3)]
    assert fill_large_llf(lfquant, got, logs[big], y8[big], x8[big], coeffoff[big]) == len(big)
    for c in range(3):
        assert got[c].tobytes() == want[c].tobytes()


@functools.lru_cache(maxsize=None)
def _stream(h, w) -> bytes:
    """A camera photo in the benchmark's photo_d05e7 shape: mixed DCT8 to
    DCT32 varblocks, two LF groups."""
    from jxlbench.frozen_vardct import vardct_enc as V

    cfg = json.loads((spec.PKG / "configs" / "photo_d05e7.json").read_text())
    codec = spec.load_module(spec.PKG / "configs" / "photo_d05e7.py")
    return V.encode_choice(codec.choose(camera.make(h, w, 2**31 + 2027, 0), cfg))


def _lf_state(cls, data, **kw):
    """The decoder and the VarDCT state after the headers and LF groups."""
    dec = cls(data, max_passes=0, **kw)
    dec.decode_frame(_defer_finish=True)
    return dec, dec._deferred[2].vardct


@pytest.mark.parametrize("hw", FRAMES, ids=["wide", "tall"])
def test_native_llf_matches_python_loop(hw, monkeypatch):
    if not MD._native_enabled():
        pytest.skip("native core unavailable")
    data = _stream(*hw)
    dec, native = _lf_state(TDecoder, data, device="cpu", workers=2)
    monkeypatch.setattr(MD, "_native_enabled", lambda: False)
    pdec, python = _lf_state(TDecoder, data, device="cpu", workers=2)
    assert sorted(native.lf_groups) == sorted(python.lf_groups) == [0, 1]
    large = {}
    for ggidx, gg in native.lf_groups.items():
        pg = python.lf_groups[ggidx]
        np.testing.assert_array_equal(gg.blocks, pg.blocks)
        np.testing.assert_array_equal(gg.vb_coeffoff, pg.vb_coeffoff)
        for c in range(3):
            assert gg.llfcoeffs[c].tobytes() == pg.llfcoeffs[c].tobytes()
        large[gg.nb_varblocks] = sum(DCT_SELECT[d][0] > 3 or DCT_SELECT[d][1] > 3
                                     for d in gg.vb_dctsel)
    assert sum(large.values()) > 0
    # one span an LF group, with its varblocks; the batch engaged on the
    # native core only
    for d, engaged in ((dec, True), (pdec, False)):
        spans = [s for s in d.stats["spans"] if s[NAME] == "vardct.lf_group"]
        assert len(spans) == 2
        assert all(d.stats["spans"][s[PARENT]][NAME] == "sections" for s in spans)
        assert sorted(s[COUNTS]["varblocks"] for s in spans) == sorted(large)
        assert sorted(s[COUNTS]["llf_blocks"] for s in spans) == sorted(
            large[s[COUNTS]["varblocks"]] if engaged else 0 for s in spans)


@pytest.mark.parametrize("hw", FRAMES, ids=["wide", "tall"])
def test_llf_matches_j40_tpu(hw):
    data = _stream(*hw)
    _, port = _lf_state(TDecoder, data, device="cpu", workers=2)
    # one worker: j40_tpu's first concurrent LF-group decode in a process
    # can race on its lazy set-up
    _, ref = _lf_state(JDecoder, data, backend="numpy", workers=1)
    assert sorted(port.lf_groups) == sorted(ref.lf_groups) == [0, 1]
    for ggidx, gg in port.lf_groups.items():
        rg = ref.lf_groups[ggidx]
        np.testing.assert_array_equal(gg.blocks, rg.blocks)
        for c in range(3):
            assert gg.llfcoeffs[c].tobytes() == rg.llfcoeffs[c].tobytes()
