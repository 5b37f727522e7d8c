"""The whole slice: `Decoder(data, backend="device", device="cpu")`, the
on-chip HF entropy route (ops/device_vardct.py) with every kernel site
through its plain version.

Its RGBA must EQUAL the port's own `backend="torch"` on the same stream
(the coefficients are exact integers, and a device-resident LF group runs
the same reconstruction on the same values) and lie within 1 gray level of
`j40_tpu`'s `backend="jax"` (the bar of tests/test_torch_combine.py).  The
route must take every eligible section (single pass, all-DCT8 cells, a
spec one of the kernels takes), keep every fully covered LF group on the
device, and raise the host plan's error codes on a corrupt section.

Streams have at least 2 groups (a single-section frame takes no lanes)
and stay small, so that the plain versions' lockstep walks stay short.
"""

import numpy as np
import pytest

from j40_tpu.decode import Decoder as JDecoder
from j40_tpu_torch.decode import Decoder as TDecoder
from j40_tpu_torch.encode.encoder import encode_modular
from j40_tpu_torch.encode.vardct_enc import VarDCTOptions, encode_vardct, encode_vardct_mixed
from j40_tpu_torch.errors import J40Error
from j40_tpu_torch.ops import kernels as TK


def _smooth(h, w, seed=1, noise=0.5):
    """A smooth photo-like image (few HF coefficients: short lanes)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    return np.stack([
        96 + 60 * np.sin(xx / 29) * np.cos(yy / 23) + 10 * np.sin(xx / (9 + 2 * c))
        + rng.normal(0, noise, (h, w)) for c in range(3)], -1).clip(0, 255).astype(np.uint8)


def _mixed():
    """A flat patch in the first group merges into large varblocks: that
    group takes the host path, the second group's DCT8 lane writes back.
    (The merge thresholds are low: at the default ones the whole smooth
    image merges and no cell stays DCT8.)"""
    img = _smooth(16, 264, seed=2)
    img[:16, :64] = img[3, 3]
    return encode_vardct_mixed(img, t16=1e-6, t32=1e-6)


def _two_lf_groups():
    """Like tests/test_torch_combine.py's two-LF-group stream, at 16 rows
    so that the lanes stay short: a flat patch makes the first LF group
    mixed (its DCT8 sections write back), the second is all DCT8 (kept on
    the device)."""
    img = _smooth(16, 2064, seed=3)
    img[:16, :64] = img[3, 3]
    return encode_vardct_mixed(img, t16=1e-6, t32=1e-6)


# name -> (stream, decode options)
STREAMS = {
    "prefix": (lambda: encode_vardct(_smooth(16, 264)), {}),
    "ans": (lambda: encode_vardct(_smooth(16, 264), VarDCTOptions(use_prefix=False)), {}),
    "ans_5clusters": (lambda: encode_vardct(
        _smooth(24, 272, seed=4), VarDCTOptions(use_prefix=False, coeff_clusters=5)), {}),
    "mixed": (_mixed, {}),
    "two_lf_groups": (_two_lf_groups, {}),
    "two_lf_groups_workers4": (_two_lf_groups, {"workers": 4}),
    "filters": (lambda: encode_vardct(_smooth(16, 264, seed=5), VarDCTOptions(
        sharpness=5, custom_restoration=True, epf_iters=3)), {"apply_filters": True}),
}

_CACHE: dict = {}


def _stream(name) -> bytes:
    make = STREAMS[name][0]
    if make not in _CACHE:
        _CACHE[make] = make()
    return _CACHE[make]


def _decode(cls, data, **kw):
    dec = cls(data, **kw)
    dec.decode_frame()
    return dec, dec.render_rgba8()


def _expected_route(data):
    """(eligible sections, fully covered LF groups) from j40_tpu's host
    state: a pass-group section is eligible when every cell of its group is
    a DCT8 varblock corner; an LF group stays on the device when all its
    sections are."""
    jd = JDecoder(data, backend="numpy")
    jd.decode_frame(_defer_finish=True)
    f, toc, st = jd._deferred
    per_gg: dict[int, list[bool]] = {}
    for s in toc.sections:
        if s.pass_ != 0:
            continue
        row, col = divmod(s.idx, f.gcolumns)
        gg = st.vardct.lf_groups[(row // 8) * f.ggcolumns + (col // 8)]
        y0, x0 = (row % 8) * f.group_size // 8, (col % 8) * f.group_size // 8
        h8 = -(-min(f.height - row * f.group_size, f.group_size) // 8)
        w8 = -(-min(f.width - col * f.group_size, f.group_size) // 8)
        ok = bool((gg.blocks[y0:y0 + h8, x0:x0 + w8] >> 20 == 2).all())
        per_gg.setdefault(gg.idx, []).append(ok)
    return (sum(sum(v) for v in per_gg.values()),
            sum(all(v) for v in per_gg.values()))


@pytest.mark.parametrize("name", list(STREAMS))
def test_device_route_matches_torch_and_jax(name):
    data = _stream(name)
    kw = STREAMS[name][1]
    TK.reset_launches()
    dec, got = _decode(TDecoder, data, backend="device", device="cpu", **kw)
    # on the CPU every kernel site takes its plain version: nothing launches
    assert not any(TK.launches.values()), TK.launches
    assert dec.stats["num_groups"] >= 2
    _, torch_rgba = _decode(TDecoder, data, backend="torch", device="cpu", **kw)
    np.testing.assert_array_equal(got, torch_rgba)
    _, jax_rgba = _decode(JDecoder, data, backend="jax", **kw)
    assert np.abs(got.astype(int) - jax_rgba.astype(int)).max() <= 1

    lanes, covered = _expected_route(data)
    stats = dec.stats["device_vardct"]
    assert lanes > 0 and stats["lanes"] == lanes
    want_resident = 0 if kw.get("apply_filters") else covered
    assert stats["resident_ggs"] == want_resident
    assert stats["kernel"] == ("ctx" if "clusters" in name else "simple")
    if name.startswith("two_lf") or name == "mixed":
        assert lanes < dec.stats["num_groups"]  # the mixed groups took the host


def _section_bytes(data):
    """(codestream offset, size) of each pass-group section."""
    dec = TDecoder(data, device="cpu", max_passes=0)
    dec.decode_frame(_defer_finish=True)
    toc = dec._deferred[1]
    secs = [(s.codeoff, s.size) for s in toc.sections if s.pass_ == 0]
    assert all(dec.src.read(o, n) == data[o:o + n] for o, n in secs)  # bare codestream
    return secs


def _outcome(cls, data, **kw):
    try:
        return _decode(cls, data, device="cpu", **kw)[1]
    except J40Error as e:
        return e.code


@pytest.mark.parametrize("name", ["prefix", "ans", "ans_5clusters"])
@pytest.mark.parametrize("where", [0.3, 0.7, 1.0], ids=["early", "late", "last"])
def test_corrupt_section_raises_as_the_host(name, where):
    """One flipped byte in the first pass-group section: the device route
    ends as the host plan does, with the same error code, or with the same
    pixels when the stream still decodes."""
    data = _stream(name)
    off, size = _section_bytes(data)[0]
    pos = off + min(int(size * where), size - 1)
    bad = bytearray(data)
    bad[pos] ^= 0x5A
    bad = bytes(bad)
    host = _outcome(TDecoder, bad, backend="numpy")
    device = _outcome(TDecoder, bad, backend="device")
    if isinstance(host, str) or isinstance(device, str):
        assert device == host
    else:
        assert np.abs(device.astype(int) - host.astype(int)).max() <= 1


def test_modular_frame_raises():
    """A modular frame under the device backend, once refused, now takes
    the modular device lanes (tests/test_torch_modular_device.py holds them
    in full): it decodes to the host plan's pixels and raises nothing."""
    from j40_tpu_torch.encode.encoder import EncodeOptions

    data = encode_modular(_smooth(16, 264), options=EncodeOptions(group_size_shift=7))
    dec, got = _decode(TDecoder, data, backend="device", device="cpu")
    assert dec.stats["device_modular"]["lanes"] == 3
    np.testing.assert_array_equal(got, _decode(TDecoder, data, backend="numpy")[1])
