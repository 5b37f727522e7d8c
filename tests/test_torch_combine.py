"""The whole slice: VarDCT streams decoded to RGBA by the port
(`j40_tpu_torch`, device="cpu", i.e. every kernel site through its plain
version) against `j40_tpu`'s `backend="jax"` (with and without the Pallas
kernels in interpret mode) and against its host plan (`backend="numpy"`).

Also, per LF group: the reconstruction inputs the port gathers
(`ops/combine.lf_group_inputs`) are identical between the two packages'
host layers, and the same arrays give the same pixels through the JAX
functions (`reconstruct_dct8_full`, `_mixed_full`) and the port's.

Tolerance: 1 gray level at the stream's own depth (8 bits, or 12 for the
12-bit stream), the bar the JAX package holds against the reference: fp32
sums in another order may tip a sample across a rounding boundary.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from j40_tpu.decode import Decoder as JDecoder
from j40_tpu.encode.vardct_enc import (
    VarDCTOptions, encode_vardct, encode_vardct_mixed, synthesize_vardct,
)
from j40_tpu.ops import combine_jax as CJ
from j40_tpu.ops import pallas_kernels as PK
from j40_tpu.vardct.tables import DCT_SELECT, NUM_DCT_SELECT
from j40_tpu_torch.decode import Decoder as TDecoder
from j40_tpu_torch.ops import combine as TC
from j40_tpu_torch.ops import kernels as TK


def _noise(rng, h, w, lo=-2, hi=3):
    return (np.cumsum(np.cumsum(rng.integers(lo, hi, size=(h, w, 3)), 0), 1)
            % 200 + 20).astype(np.uint8)


def _flatphoto():
    """tests/test_mixed_vardct.py's flatphoto: 32x32 and graded bands."""
    rng = np.random.default_rng(777)
    img = _noise(rng, 384, 512)
    img[:128, :256] = img[10, 10]
    img[256:, 384:] = (np.linspace(40, 80, 128)[:, None, None]
                       + np.zeros((128, 128, 3))).astype(np.uint8)
    return img


def _synth(dctsel, reps=2):
    """One stream of a single DctSelect (tests/test_vardct.py's _synth)."""
    rng = np.random.default_rng(1000 + dctsel)
    log_vh, log_vw, _, _ = DCT_SELECT[dctsel]
    vh, vw = 1 << log_vh, 1 << log_vw
    if max(vh, vw) > 128:
        reps = 1
    H, W = vh * reps, vw * reps
    h8, w8 = H // 8, W // 8
    grid = np.full((h8, w8), dctsel, dtype=np.int32)
    lf_int = rng.integers(-40, 40, size=(3, h8, w8))
    hf = []
    for _ in range(reps * reps):
        q = rng.integers(-3, 4, size=(3, vh * vw))
        q[rng.random((3, vh * vw)) < 0.85] = 0
        hf.append(q)
    return synthesize_vardct(W, H, grid, lf_int, hf)


def _two_lf_groups():
    """tests/test_mixed_vardct.py's 2560x128 two-LF-group stream, plus a flat
    band so that the first LF group is mixed and the second all DCT8."""
    rng = np.random.default_rng(21)
    img = np.cumsum(rng.integers(-2, 3, (128, 2560, 3)), axis=1).astype(np.uint8)
    img[:32, :256] = img[3, 3]
    return encode_vardct_mixed(img)


def _bpp12():
    rng = np.random.default_rng(5)
    img = (np.cumsum(np.cumsum(rng.integers(-20, 21, (96, 112, 3)), 0), 1)
           % 3800 + 100).astype(np.uint16)
    return encode_vardct(img, VarDCTOptions(bpp=12))


# name -> (function making the stream, decode workers)
STREAMS = {
    "dct8_256x192": (lambda: encode_vardct(_noise(np.random.default_rng(1), 192, 256)), 1),
    "dct8_61x77_ragged": (lambda: encode_vardct(_noise(np.random.default_rng(2), 77, 61)), 1),
    "mixed_flatphoto": (lambda: encode_vardct_mixed(_flatphoto()), 1),
    "mixed_two_lf_groups": (_two_lf_groups, 4),
    "dct8_12bit": (_bpp12, 1),
    **{f"dctsel{d}": (functools.partial(_synth, d), 1) for d in range(NUM_DCT_SELECT)},
}


@functools.lru_cache(maxsize=None)
def _stream(name) -> bytes:
    return STREAMS[name][0]()


def _pixels(dec) -> np.ndarray:
    """(3, h, w) int64 colour samples at the stream's own depth."""
    if dec.image.bpp == 8:
        return dec.render_rgba8()[:, :, :3].transpose(2, 0, 1).astype(np.int64)
    return np.stack([np.asarray(c, np.int64) for c in dec.frame.canvas[:3]])


def _decode(cls, name, **kw):
    dec = cls(_stream(name), workers=STREAMS[name][1], **kw)
    dec.decode_frame()
    return _pixels(dec)


@functools.lru_cache(maxsize=None)
def _port_pixels(name):
    return _decode(TDecoder, name, device="cpu")


def _assert_close(a, b):
    assert a.shape == b.shape, (a.shape, b.shape)
    d = np.abs(a.astype(np.int64) - b.astype(np.int64))
    assert d.max() <= 1, d.max()


def _deferred_state(cls, name, **kw):
    dec = cls(_stream(name), **kw)
    dec.decode_frame(_defer_finish=True)
    return dec._deferred[2]


@pytest.mark.parametrize("name", list(STREAMS))
def test_lf_group_inputs_identical(name):
    ts = _deferred_state(TDecoder, name, device="cpu")
    js = _deferred_state(JDecoder, name, backend="numpy")
    assert sorted(ts.vardct.lf_groups) == sorted(js.vardct.lf_groups)
    for ggidx, gg in ts.vardct.lf_groups.items():
        a = TC.lf_group_inputs(ts.vardct, gg, ts.im)
        jgg = js.vardct.lf_groups[ggidx]
        b = TC.lf_group_inputs(js.vardct, jgg, js.im)
        assert a.keys() == b.keys()
        for k in a:
            if k == "bigs":
                assert len(a[k]) == len(b[k])
                for x, y in zip(a[k], b[k]):
                    for u, v in zip(x, y):
                        np.testing.assert_array_equal(u, v)
            else:
                np.testing.assert_array_equal(a[k], b[k])
        if a["kind"] == "dct8":
            # the JAX package's own gather of an all-DCT8 group
            coeffs, aux, weights, c22 = CJ.gather_full_dct8(
                js.vardct, jgg, js.im, js.f)
            for u, v in zip((a["i8"], a["exc_idx"], a["exc_val"]),
                            CJ._pack_i8(coeffs)):
                np.testing.assert_array_equal(u, v)
            np.testing.assert_array_equal(a["aux"], aux)
            np.testing.assert_array_equal(a["weights"], weights)
            np.testing.assert_array_equal(a["consts22"], c22)


@pytest.mark.parametrize("name", list(STREAMS))
def test_group_functions_match_jax(name):
    """Same upload arrays through JAX's reconstruct_dct8_full / _mixed_full
    (Pallas kernels in interpret mode) and the port's functions."""
    st = _deferred_state(TDecoder, name, device="cpu")
    kinds = set()
    for gg in st.vardct.lf_groups.values():
        inp = TC.lf_group_inputs(st.vardct, gg, st.im)
        kinds.add(inp["kind"])
        j = {k: jnp.asarray(inp[k]) for k in
             ("i8", "exc_idx", "exc_val", "aux", "weights", "consts22")}
        if inp["kind"] == "dct8":
            ref = PK.reconstruct_dct8_full(
                j["i8"], j["exc_idx"], j["exc_val"], j["aux"], j["weights"],
                j["consts22"], inp["h8"], inp["w8"], inp["to_u8"])
        else:
            bigs = tuple(tuple(jnp.asarray(a) for a in b[1:]) for b in inp["bigs"])
            ref = CJ._mixed_full(
                j["i8"], j["exc_idx"], j["exc_val"], j["aux"], j["weights"],
                j["consts22"], bigs, tuple(b[0] for b in inp["bigs"]),
                inp["h8"], inp["w8"], inp["to_u8"])
        got = TC.reconstruct_inputs(TC.to_device(inp, "cpu"))
        assert got.dtype == (torch.uint8 if inp["to_u8"] else torch.int32)
        _assert_close(got.numpy(), np.asarray(ref))
        planes = TC.combine_lf_group_torch(st.vardct, gg, st.im, "cpu")
        assert planes.shape == (3, gg.height, gg.width)
        np.testing.assert_array_equal(planes, got[:, :gg.height, :gg.width].numpy())
    if name == "mixed_two_lf_groups":
        assert kinds == {"mixed", "dct8"}, kinds
    elif name.startswith("mixed") or (name.startswith("dctsel") and name != "dctsel0"):
        assert kinds == {"mixed"}, kinds
    else:
        assert kinds == {"dct8"}, kinds


@pytest.mark.parametrize("interp", [False, True], ids=["xla", "pallas_interp"])
@pytest.mark.parametrize("name", list(STREAMS))
def test_decode_matches_jax(name, interp, monkeypatch):
    if interp:
        monkeypatch.setenv("J40T_PALLAS", "interp")
    else:
        monkeypatch.delenv("J40T_PALLAS", raising=False)
    _assert_close(_port_pixels(name), _decode(JDecoder, name, backend="jax"))


@pytest.mark.parametrize("name", list(STREAMS))
def test_decode_matches_host_plan(name):
    TK.reset_launches()
    got = _port_pixels.__wrapped__(name)
    # on the CPU every kernel site takes its plain version: nothing launches
    assert not any(TK.launches.values()), TK.launches
    _assert_close(got, _decode(JDecoder, name, backend="numpy"))
    _assert_close(got, _decode(TDecoder, name, backend="numpy"))
