"""Lossy camera photos in cjxl's -d 0.5 -e 7 shape (the benchmark's
configuration photo_d05e7: mixed DCT8-DCT32 varblocks, gaborish on, no
EPF) through `decode_file(..., apply_filters=True)`, held against the plain
float64 reference of the format (tools/photo_reference.py) on frames that
span two LF groups, so that a border between LF groups runs through them.

Checked: the port within the configuration's limits of the reference
everywhere, the seam too (the restoration filters run over the whole
frame, not each LF group apart); each of the configuration's three
controls outside them; the same pixels as the sharded plan on one shard;
`decode_file` without `apply_filters` as before; and the VarDCT route's
spans (`vardct.lf_group`, `vardct.hf`, `vardct.hf_host`, `vardct.gather`,
`filters`, the fetch) in the decode's tree, on the pool's threads too, with their counts.
On the CPU every kernel site takes its plain version.
"""

import functools
import json
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))

import photo_reference as R  # noqa: E402

from j40_tpu_torch.decode import Decoder, decode_file  # noqa: E402
from j40_tpu_torch.vardct.tables import DCT_SELECT  # noqa: E402
from jxlbench import spec  # noqa: E402
from jxlbench.images import camera  # noqa: E402

CFG = json.loads((spec.PKG / "configs" / "photo_d05e7.json").read_text())
CODEC = spec.load_module(spec.PKG / "configs" / "photo_d05e7.py")
SEED = 2**31 + 2027
NAME, PARENT, START, END, CPU, COUNTS = range(6)
#: (height, width): two LF groups side by side, and one above the other
FRAMES = [(256, 2304), (2304, 256)]


@functools.lru_cache(maxsize=None)
def _frame(h, w, index=0):
    """(image, the encoder's choices, the stream)."""
    img = camera.make(h, w, SEED, index)
    ch = CODEC.choose(img, CFG)
    from jxlbench.frozen_vardct import vardct_enc as V

    return img, ch, V.encode_choice(ch)


@functools.lru_cache(maxsize=None)
def _reference(h, w, mode="frame", dtype=torch.float64):
    return R.reconstruct(CODEC.inputs(_frame(h, w)[1]), "cpu", gaborish_mode=mode,
                         idct_dtype=dtype)


def _passes(nums) -> bool:
    return all(nums[k] <= lim for k, lim in CFG["limits"].items())


@functools.lru_cache(maxsize=None)
def _port(h, w, **kw):
    dec, rgba = decode_file(_frame(h, w)[2], backend="torch", device="cpu", workers=4, **kw)
    return dec, torch.from_numpy(rgba)


@pytest.mark.parametrize("h,w", FRAMES)
def test_filtered_decode_matches_the_reference(h, w):
    dec, got = _port(h, w, apply_filters=True)
    assert dec.stats["num_lf_groups"] == 2
    nums = CODEC.compare(got, _reference(h, w))
    assert _passes(nums), nums
    # across the seam too: the rows or columns within 8 pixels of it
    seam = (slice(2040, 2056), slice(None)) if h > w else (slice(None), slice(2040, 2056))
    d = (got[seam][..., :3].int() - _reference(h, w)[seam][..., :3].int()).abs()
    assert int(d.max()) <= 1


def test_the_reference_module_is_the_benchmarks():
    """The benchmark keeps its own copy of the reference, the same code."""
    assert (ROOT / "tools" / "photo_reference.py").read_bytes() == \
        (spec.PKG / "photo_reference.py").read_bytes()


@pytest.mark.parametrize("sel", [0, 4, 5, 6, 7])
def test_the_default_dequant_tables(sel):
    """The reference computes the default dequant tables from the format's
    parameters; the frozen encoder quantizes with the port's tables, and
    both equal the reference's (to float32's rounding)."""
    from j40_tpu_torch.vardct.dequant import DqMatrix, load_dq_matrix
    from jxlbench.frozen_vardct import vardct_enc as V
    from jxlbench.frozen_vardct.vardct.tables import DCT_SELECT

    lr, lc, param_idx, _ = DCT_SELECT[sel]
    ours = R.default_weights((lr, lc), "cpu").numpy()
    assert ours.shape == (1 << (lr + lc), 3)
    for table in (V._default_dq64(param_idx), load_dq_matrix(param_idx, DqMatrix())):
        np.testing.assert_allclose(table[: 1 << (lr + lc)], ours, rtol=1e-6, atol=0)


@pytest.mark.parametrize("control", sorted(CODEC.CONTROLS))
def test_each_control_fails(control):
    """A frame whose LF-group border runs through foliage and ground: each
    control is outside the limits (the LF-group one only at the seam)."""
    h, w = 2304, 256
    img = _frame(h, w)[0]
    nums = CODEC.compare(CODEC.CONTROLS[control](img, CFG), _reference(h, w))
    assert not _passes(nums), nums


def test_the_host_plan_keeps_the_lf_group_seam():
    """The host plan still filters each LF group apart: the reference's
    LF-group control, within a level, and off the whole-frame reference."""
    h, w = 2304, 256
    dec = Decoder(_frame(h, w)[2], backend="numpy", apply_filters=True)
    dec.decode_frame()
    host = torch.from_numpy(dec.render_rgba8())
    assert CODEC.compare(host, _reference(h, w, "lf_groups"))["max_diff"] <= 1
    assert not _passes(CODEC.compare(host, _reference(h, w)))


@pytest.mark.parametrize("h,w", FRAMES)
def test_the_sharded_plan_on_one_shard_agrees(h, w):
    """The whole-frame filters are what the sharded plan computes on one
    shard (ops/sharded_filters.py)."""
    from j40_tpu_torch.parallel.mesh import Mesh
    from j40_tpu_torch.parallel.sharded_decode import decode_sharded

    one = decode_sharded(_frame(h, w)[2], mesh=Mesh(["cpu"], ("rows",)), apply_filters=True)
    got = _port(h, w, apply_filters=True)[1][..., :3].numpy()
    assert one.shape == got.shape
    assert int(np.abs(one.astype(np.int16) - got).max()) <= 1


@pytest.mark.parametrize("backend", ["torch", "numpy"])
def test_decode_file_without_filters_is_unchanged(backend, monkeypatch):
    """No `apply_filters`: the frame decodes as a Decoder without filters
    does, byte for byte, and nothing filters."""
    from j40_tpu_torch.ops import combine

    monkeypatch.setattr(combine, "filter_frame", lambda *a: pytest.fail("filtered"))
    data = _frame(256, 2304)[2]
    kw = {} if backend == "numpy" else {"device": "cpu"}
    _, rgba = decode_file(data, backend=backend, workers=4, **kw)
    dec = Decoder(data, backend=backend, workers=4, **kw)
    while not dec.done:
        dec.decode_frame()
    np.testing.assert_array_equal(rgba, dec.render_rgba8())
    np.testing.assert_array_equal(rgba, decode_file(data, backend=backend, workers=4,
                                                    apply_filters=False, **kw)[1])


def _lane_frame():
    """Two LF groups: the first 2048 pixels a smooth ramp (its sections
    hold larger varblocks: the host decodes them), the last 8 pixels grain,
    so that the second group's one section is all DCT8 and short: the
    card's HF route takes it (here its plain version)."""
    ramp = np.linspace(40, 200, 2048, dtype=np.float32)
    img = np.empty((64, 2056, 3), np.uint8)
    img[:, :2048] = np.stack([ramp, ramp[::-1], 0.5 * ramp + 60], -1)[None].round()
    img[:, 2048:] = np.random.default_rng(5).integers(60, 90, (64, 8, 3), dtype=np.uint8)
    ch = CODEC.choose(img, CFG)
    from jxlbench.frozen_vardct import vardct_enc as V

    return img, ch, V.encode_choice(ch)


def test_spans_on_pool_threads(monkeypatch):
    from j40_tpu_torch.ops import combine
    from j40_tpu_torch.vardct import state as VS

    threads = {"gather": set(), "hf_host": set()}
    gather, read_pg = combine.lf_group_inputs, VS.VarDCTState.read_pass_group

    def lf_group_inputs(*a):
        threads["gather"].add(threading.get_ident())
        return gather(*a)

    def read_pass_group(self, *a):
        threads["hf_host"].add(threading.get_ident())
        return read_pg(self, *a)

    monkeypatch.setattr(combine, "lf_group_inputs", lf_group_inputs)
    monkeypatch.setattr(VS.VarDCTState, "read_pass_group", read_pass_group)
    img, ch, data = _lane_frame()
    dec, rgba = decode_file(data, backend="device", device="cpu", workers=4,
                            apply_filters=True)
    spans = dec.stats["spans"]
    assert all(s is not None for s in spans)
    me = threading.get_ident()
    assert threads["gather"] - {me} and threads["hf_host"] - {me}, threads

    def named(n):
        return [s for s in spans if s[NAME] == n]

    def ancestors(s):
        out = []
        while s[PARENT] >= 0:
            s = spans[s[PARENT]]
            out.append(s[NAME])
        return out

    for s in spans:  # every span lies inside its parent, under the one request
        if s[PARENT] >= 0:
            p = spans[s[PARENT]]
            assert p[START] <= s[START] and s[END] <= p[END], (s, p)
    assert [s[NAME] for s in spans if s[PARENT] == -1] == ["request"]
    hf = named("vardct.hf")
    assert len(hf) == 1 and hf[0][COUNTS] == {"lanes": 1}
    assert ancestors(hf[0]) == ["sections", "request"]
    host = named("vardct.hf_host")
    assert len(host) == 8 and all(ancestors(s) == ["sections", "request"] for s in host)
    # every varblock of the frame: the host's sections' and the lane's DCT8 cells
    assert sum(s[COUNTS]["varblocks"] for s in host) + 8 == len(ch.placements)
    # one LF-group span a group on the pool, its varblocks, and the LLF of
    # every varblock larger than DCT8 from the batched fill
    lf = named("vardct.lf_group")
    assert len(lf) == 2 and all(ancestors(s) == ["sections", "request"] for s in lf)
    assert sum(s[COUNTS]["varblocks"] for s in lf) == len(ch.placements)
    large = sum(DCT_SELECT[sel][:2] != (3, 3) for _, _, sel in ch.placements)
    assert large > 0 and sum(s[COUNTS]["llf_blocks"] for s in lf) == large
    gathers = named("vardct.gather")
    assert len(gathers) == 2
    assert sorted(s[COUNTS]["cells"] for s in gathers) == [8 * 1, 8 * 256]
    big = sum(4 ** (lr - 3) * len(v["y8"]) if lr == lc else 2 * len(v["y8"])
              for (lr, lc), v in CODEC.inputs(ch)["varblocks"].items() if (lr, lc) != (3, 3))
    assert sum(s[COUNTS]["big_cells"] for s in gathers) == big > 0
    assert all(ancestors(s)[-1] == "request" for s in gathers)
    (filt,) = named("filters")
    assert filt[COUNTS] == {"epf_iters": 0} and ancestors(filt) == ["finish", "request"]
    fetches = [s for s in named("copy.dtoh") if ancestors(s)[0] == "finish"]
    assert len(fetches) == 1 and fetches[0][START] >= filt[END]
    nums = CODEC.compare(torch.from_numpy(rgba), R.reconstruct(CODEC.inputs(ch), "cpu"))
    assert _passes(nums), nums
