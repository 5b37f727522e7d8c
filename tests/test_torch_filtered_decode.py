"""The restoration-filter slice as a whole: VarDCT streams decoded with
`apply_filters=True` by the port (`j40_tpu_torch`, device="cpu", so every
kernel site takes its plain version) against `j40_tpu`'s
`Decoder(backend="jax", apply_filters=True)` and against the host plan
(`backend="numpy"`, native C++ filters) of both packages.

The port follows the JAX package's device plan (combine_jax.py:553-578):
it filters the 8-padded plane, then crops.  The host plan filters the
cropped plane.  On images whose sides are not multiples of 8 the two
plans disagree near the ragged bottom and right edges, by far more than a
gray level (the filters move pixels by up to ~200 levels at these
settings); that gap lies in the reference package itself and is asserted
here as a known one (ROADMAP C).  The port filters the whole frame's
plane, where the JAX package and both host plans filter each LF group's
apart, mirrored at its borders: on a frame of several LF groups they
disagree next to a border between LF groups, and agree away from it
(ROADMAP C.3; tests/test_torch_photo_reference.py holds the port against
the format there).

Tolerance: 1 gray level at the stream's own depth, the bar the JAX
package holds against the reference: fp32 sums in another order may tip a
sample across a rounding boundary.
"""

import functools

import numpy as np
import pytest

from j40_tpu.decode import Decoder as JDecoder
from j40_tpu_torch.decode import Decoder as TDecoder
from j40_tpu_torch.encode.vardct_enc import (
    VarDCTOptions, encode_vardct, encode_vardct_mixed,
)
from j40_tpu_torch.ops import kernels as TK


def _noise(rng, h, w):
    return (np.cumsum(np.cumsum(rng.integers(-2, 3, size=(h, w, 3)), 0), 1)
            % 200 + 20).astype(np.uint8)


def _flatphoto():
    """tests/test_torch_combine.py's flatphoto: 32x32 and graded bands."""
    img = _noise(np.random.default_rng(777), 384, 512)
    img[:128, :256] = img[10, 10]
    img[256:, 384:] = (np.linspace(40, 80, 128)[:, None, None]
                       + np.zeros((128, 128, 3))).astype(np.uint8)
    return img


def _two_lf_groups():
    """tests/test_torch_combine.py's 2560x128 stream: LF group 0 mixed,
    LF group 1 all DCT8."""
    rng = np.random.default_rng(21)
    img = np.cumsum(rng.integers(-2, 3, (128, 2560, 3)), axis=1).astype(np.uint8)
    img[:32, :256] = img[3, 3]
    return encode_vardct_mixed(img)


def _epf_opts(e, **kw):
    return VarDCTOptions(sharpness=5, custom_restoration=True, epf_iters=e, **kw)


def _bpp12():
    rng = np.random.default_rng(5)
    img = (np.cumsum(np.cumsum(rng.integers(-20, 21, (96, 112, 3)), 0), 1)
           % 3800 + 100).astype(np.uint16)
    return encode_vardct(img, _epf_opts(3, bpp=12))


# name -> (function making the stream, decode workers)
STREAMS = {
    **{f"dct8_64x80_epf{e}": (functools.partial(
        lambda e: encode_vardct(_noise(np.random.default_rng(77), 64, 80), _epf_opts(e)),
        e), 1) for e in range(4)},
    **{f"dct8_61x77_ragged_epf{e}": (functools.partial(
        lambda e: encode_vardct(_noise(np.random.default_rng(78), 77, 61), _epf_opts(e)),
        e), 1) for e in (1, 3)},
    "mixed_flatphoto": (lambda: encode_vardct_mixed(_flatphoto()), 1),
    "mixed_two_lf_groups": (_two_lf_groups, 4),
    "dct8_12bit_epf3": (_bpp12, 1),
}
RAGGED = [n for n in STREAMS if "ragged" in n]
ALIGNED = [n for n in STREAMS if n not in RAGGED]
#: streams of several LF groups: the columns of their borders
SEAMS = {"mixed_two_lf_groups": [2048]}
#: how far a difference at an LF-group border reaches: gaborish 1 pixel,
#: then the EPF steps 3 + 2 + 1
SEAM_REACH = 7


@functools.lru_cache(maxsize=None)
def _stream(name) -> bytes:
    return STREAMS[name][0]()


@functools.lru_cache(maxsize=None)
def _pixels(cls, name, **kw) -> np.ndarray:
    """(3, h, w) int64 colour samples at the stream's own depth."""
    dec = cls(_stream(name), workers=STREAMS[name][1], **kw)
    dec.decode_frame()
    if dec.image.bpp == 8:
        return dec.render_rgba8()[:, :, :3].transpose(2, 0, 1).astype(np.int64)
    return np.stack([np.asarray(c, np.int64) for c in dec.frame.canvas[:3]])


def _port(name):
    return _pixels(TDecoder, name, device="cpu", apply_filters=True)


def _max_diff(a, b) -> int:
    assert a.shape == b.shape, (a.shape, b.shape)
    return int(np.abs(a - b).max())


def _agrees(name, got, other) -> None:
    """Within 1 level; on a stream of several LF groups, within 1 level
    away from its borders, and off by more at them (the known gap, C.3)."""
    if name not in SEAMS:
        assert _max_diff(got, other) <= 1
        return
    far = np.ones(got.shape[2], bool)
    for x in SEAMS[name]:
        far[x - SEAM_REACH : x + SEAM_REACH] = False
    assert _max_diff(got[:, :, far], other[:, :, far]) <= 1
    assert _max_diff(got, other) > 1


@pytest.mark.parametrize("name", list(STREAMS))
def test_filtered_decode_matches_jax(name):
    TK.reset_launches()
    got = _port(name)
    # on the CPU every kernel site takes its plain version: nothing launches
    assert not any(TK.launches.values()), TK.launches
    _agrees(name, got, _pixels(JDecoder, name, backend="jax", apply_filters=True))


@pytest.mark.parametrize("name", ALIGNED)
def test_filtered_decode_matches_host_plan(name):
    got = _port(name)
    _agrees(name, got, _pixels(TDecoder, name, backend="numpy", apply_filters=True))
    _agrees(name, got, _pixels(JDecoder, name, backend="numpy", apply_filters=True))


@pytest.mark.parametrize("name", RAGGED)
def test_ragged_gap_against_host_plan(name):
    """The known gap: the port (and backend="jax") filter the 8-padded
    plane, the host plan the cropped one.  Away from the last 3 rows and
    columns they agree within 1 level; at the ragged edges they do not."""
    got = _port(name)
    host = _pixels(TDecoder, name, backend="numpy", apply_filters=True)
    _, h, w = got.shape
    assert h % 8 and w % 8
    assert _max_diff(got[:, :h - 3, :w - 3], host[:, :h - 3, :w - 3]) <= 1
    assert _max_diff(got, host) > 1  # the gap is real, and lies at the edges
    assert _max_diff(got, _pixels(JDecoder, name, backend="jax",
                                  apply_filters=True)) <= 1


@pytest.mark.parametrize("name", list(STREAMS))
def test_filters_ran(name):
    """The filtered output differs from the unfiltered one."""
    plain = _pixels(TDecoder, name, device="cpu")
    assert _max_diff(_port(name), plain) > 1


def test_filtered_groups_take_the_xyb_route(monkeypatch):
    """An all-DCT8 group with filters on builds its XYB plane through the
    dense-grid kernel (B2) and never the fused sRGB kernel (B1), then
    gaborish, EPF and the colour kernel, in that order."""
    from j40_tpu_torch.ops import combine as TC
    from j40_tpu_torch.ops import filter_kernels as FK

    calls = []
    for mod, name in ((TC.kernels, "reconstruct_dct8"), (TC.kernels, "xyb_to_srgb"),
                      (TC.kernels, "reconstruct_dct8_srgb"),
                      (FK, "gaborish"), (FK, "epf_fused"), (FK, "epf_step")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _n=name, _r=real, **k:
                            calls.append(_n) or _r(*a, **k))
    dec = TDecoder(_stream("dct8_64x80_epf3"), device="cpu", apply_filters=True)
    dec.decode_frame()
    assert calls == ["reconstruct_dct8", "gaborish", "epf_fused", "xyb_to_srgb"]


@pytest.mark.parametrize("gab", [True, False])
def test_nothing_to_filter_keeps_the_fused_route(gab, monkeypatch):
    """With EPF off and gaborish off, a filtered decode's all-DCT8 group
    carries no `filters` entry and takes the fused kernel (B1); with
    gaborish on it carries the weights and no sigmas."""
    from j40_tpu_torch.ops import combine as TC

    dec = TDecoder(_stream("dct8_64x80_epf0"), backend="numpy", apply_filters=True)
    dec.decode_frame(_defer_finish=True)
    st = dec._deferred[2]
    st.vardct.fs.f.gab_enabled = gab
    inp = TC.lf_group_inputs(st.vardct, st.vardct.lf_groups[0], st.im)
    if gab:
        assert inp["filters"]["epf"] is None and inp["filters"]["rs8"] is None
        return
    assert "filters" not in inp
    calls = []
    real = TC.kernels.reconstruct_dct8_full
    monkeypatch.setattr(TC.kernels, "reconstruct_dct8_full",
                        lambda *a: calls.append(1) or real(*a))
    TC.reconstruct_inputs(TC.to_device(inp, "cpu"))
    assert calls == [1]


def test_decoder_without_device_raises_without_cuda():
    """apply_filters=True defaults to CUDA as the unfiltered path does, and
    raises where there is none; it never runs on the CPU by itself."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TDecoder(_stream("dct8_64x80_epf3"), apply_filters=True)
