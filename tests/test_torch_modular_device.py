"""The whole slice: `Decoder(data, backend="device", device="cpu")` on
lossless Modular streams, the modular device lanes (ops/device_modular.py)
with the token kernel's plain version and the torch-op wavefronts.

Its RGBA must EQUAL the port's own host plan (`backend="numpy"`) and
j40_tpu's `backend="device"` and `backend="numpy"` (lossless: no slack),
and it must take the same sections as j40_tpu's device path: the lane,
ctx-lane, ntree-lane and token counts of `stats["device_modular"]` equal
j40_tpu's.  Corrupt sections raise the host's error codes, an int16
overflow raises "povf", and ineligible streams take the host chains
without raising.

Streams are small versions of tests/test_device_modular.py's: 128-pixel
groups and few rows, so that the plain lockstep decoder's lanes stay short.
The MA-tree streams (static, neighbour-property and WP trees) are in
tests/test_torch_modular_trees.py.
"""

import numpy as np
import pytest

from j40_tpu.decode import Decoder as JDecoder
from j40_tpu_torch.decode import Decoder as TDecoder
from j40_tpu_torch.encode.advanced import AdvancedOptions, encode_modular_advanced
from j40_tpu_torch.encode.encoder import EncodeOptions, encode_modular
from j40_tpu_torch.encode.modular_enc import branch, leaf
from j40_tpu_torch.errors import J40Error, ShortInput
from j40_tpu_torch.ops import device_modular as DM
from j40_tpu_torch.ops import kernels as TK

COUNTS = ("lanes", "ctx_lanes", "ntree_lanes", "tokens")


def _img(h, w, nc=3, seed=7):
    rng = np.random.default_rng(seed)
    return (np.cumsum(np.cumsum(rng.integers(-2, 3, size=(h, w, nc)), axis=0), axis=1)
            % 256).astype(np.uint8)


def _enc(h=16, w=136, seed=7, nc=3, **kw):
    return lambda: encode_modular(_img(h, w, nc, seed),
                                  options=EncodeOptions(group_size_shift=7, **kw))


def _adv(tree, h=16, w=136, seed=7, **kw):
    return lambda: encode_modular_advanced(
        _img(h, w, seed=seed), options=AdvancedOptions(tree=tree, group_size_shift=7, **kw))


# name -> (stream, the stats key that must count lanes; None: all host)
STREAMS = {
    **{f"predictor{p}": (_enc(seed=p, predictor=p), "lanes") for p in (0, 1, 2, 5)},
    "ans_local": (_enc(use_prefix=False), "lanes"),
    "prefix_global": (_enc(global_tree=True), "lanes"),
    "ans_global": (_enc(use_prefix=False, global_tree=True), "lanes"),
    "rgba_alpha": (_enc(nc=4, seed=3), "lanes"),
    # host-only streams: LZ77, an unsupported predictor, cross-channel
    # tree properties (>= 16)
    "lz77_host": (lambda: encode_modular(
        np.stack([np.tile(np.arange(16, dtype=np.uint8), (16, 10))[:, :150]] * 3, -1),
        options=EncodeOptions(lz77=True, group_size_shift=7)), None),
    "predictor4_host": (_enc(seed=9, predictor=4), None),
    "ref_channel_tree_host": (_adv([branch(0, 0, 1, 4), branch(16, 0, 2, 3), leaf(5),
                                    leaf(1), leaf(5)], seed=19), None),
}

_CACHE: dict = {}


def _stream(name) -> bytes:
    if name not in _CACHE:
        _CACHE[name] = STREAMS[name][0]()
    return _CACHE[name]


def _decode(cls, data, **kw):
    dec = cls(data, **kw)
    while not dec.done:
        dec.decode_frame()
    return dec, dec.render_rgba8()


def check_route(data, key):
    """The device route's RGBA equals the port's host plan and j40_tpu's
    two plans, and it takes j40_tpu's lanes (`key`: the stats count that
    must be positive; None: no section is eligible)."""
    TK.reset_launches()
    dec, got = _decode(TDecoder, data, backend="device", device="cpu")
    assert not any(TK.launches.values()), TK.launches  # plain versions on the CPU
    _, host = _decode(TDecoder, data, backend="numpy")
    np.testing.assert_array_equal(got, host)
    jdec, jdev = _decode(JDecoder, data, backend="device")
    np.testing.assert_array_equal(got, jdev)
    _, jhost = _decode(JDecoder, data, backend="numpy")
    np.testing.assert_array_equal(got, jhost)

    dm, jdm = dec.stats.get("device_modular"), jdec.stats.get("device_modular")
    if key is None:
        assert dm is None and jdm is None, "the device path ran on an ineligible stream"
        return
    assert dm[key] > 0
    assert {k: dm.get(k) for k in COUNTS} == {k: jdm.get(k) for k in COUNTS}


@pytest.mark.parametrize("name", list(STREAMS))
def test_device_route_matches_host_and_jax(name):
    check_route(_stream(name), STREAMS[name][1])


def test_streaming_resume():
    """The device path keeps the section-granular resume bookkeeping: a
    decode cut mid-frame resumes after push() and ends equal to the host
    plan."""
    data = _stream("predictor5")
    half = len(data) // 2
    dec = TDecoder(data[:half], backend="device", device="cpu", streaming=True)
    with pytest.raises(ShortInput):
        dec.decode_frame()
    dec.push(data[half:])
    dec.decode_frame()
    _, host = _decode(TDecoder, data, backend="numpy")
    np.testing.assert_array_equal(dec.render_rgba8(), host)


def _section(data):
    """(codestream offset, size) of the first pass-group section."""
    dec = TDecoder(data, backend="numpy", max_passes=0)
    dec.decode_frame(_defer_finish=True)
    f, toc, state = dec._deferred
    sections = [s for s in toc.sections if s.pass_ == 0]
    assert DM.plan_lanes(dec, state, sections), "no eligible section"
    s = sections[0]
    assert dec.src.read(s.codeoff, s.size) == data[s.codeoff:s.codeoff + s.size]
    return s.codeoff, s.size


def _outcome(data, backend):
    try:
        return _decode(TDecoder, data, backend=backend, device="cpu")[1]
    except J40Error as e:
        return e.code


@pytest.mark.parametrize("name", ["ans_global", "predictor5"])
@pytest.mark.parametrize("where", [0.3, 0.7, 1.0], ids=["early", "late", "last"])
def test_corrupt_section_raises_as_the_host(name, where):
    """One flipped byte in the first pass-group section: the device route
    ends as the host plan does, with the same error code (ans?, shrt, pad0,
    excs) or the same pixels."""
    data = _stream(name)
    off, size = _section(data)
    bad = bytearray(data)
    bad[off + min(int(size * where), size - 1)] ^= 0x5A
    host, device = _outcome(bytes(bad), "numpy"), _outcome(bytes(bad), "device")
    if isinstance(host, str) or isinstance(device, str):
        assert device == host
    else:
        np.testing.assert_array_equal(device, host)


def test_int16_overflow_raises_povf():
    """Samples past the int16 range on a 16-bit-buffer image (bpp 15): the
    device lanes raise "povf" as the host does."""
    rng = np.random.default_rng(1)
    img = (rng.integers(0, 2000, size=(16, 136, 3)) + 31000).astype(np.uint16)
    img[5:9, 20:40] = 40000
    data = encode_modular(img, bpp=15, options=EncodeOptions(group_size_shift=7))
    _section(data)  # the sections are eligible: the device lanes take them
    assert _outcome(data, "numpy") == "povf"
    assert _outcome(data, "device") == "povf"
