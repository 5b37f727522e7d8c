"""Batch serving and device-resident output of the port
(`j40_tpu_torch.parallel.batch`, `Decoder.render_rgba8_device`) on the CPU,
against `j40_tpu`'s functions of the same names on the same streams.

- The upload packers (`_pack_i4`, `pack_coeffs_auto`, `gather_full_dct8`,
  `gather_pack_dct8_i8`) and the chunk assembler (`_assemble_chunk`) are
  byte-equal to `j40_tpu.ops.combine_jax`'s and `j40_tpu.parallel.batch`'s;
  `kernels.unpack_i4` equals `unpack_i4_jax`.
- The batch outputs are exactly equal to per-image port decodes
  (`decode_file(..., device="cpu")`, where every kernel site takes its plain
  version), and within 1 gray level of `j40_tpu`'s `decode_batch_device`
  (Pallas in interpret mode) and of the host plan: fp32 sums in another
  order may tip a sample across a rounding boundary, the bar the JAX
  package holds against the reference.
- The on-card HF batch is exactly equal to the pack path: the same
  coefficients reach the same B1 plain version.
"""

import functools

import numpy as np
import pytest
import torch

from j40_tpu.decode import Decoder as JDecoder
from j40_tpu.ops import combine_jax as CJ
from j40_tpu.parallel import batch as JB
from j40_tpu_torch.decode import Decoder, decode_file
from j40_tpu_torch.encode.encoder import encode_modular
from j40_tpu_torch.encode.vardct_enc import VarDCTOptions, encode_vardct, encode_vardct_mixed
from j40_tpu_torch.ops import combine as TC
from j40_tpu_torch.ops import kernels as K
from j40_tpu_torch.parallel import batch as PB


def _noise(rng, h, w):
    """tests/test_parallel.py's serving images: a random walk along rows."""
    return (np.cumsum(rng.integers(-2, 3, size=(h, w, 3)), axis=1) % 180 + 30).astype(np.uint8)


def _photo(h, w, seed):
    """A smooth photo-like image with some grain (short HF lanes: the plain
    B4 walk is one lockstep step per symbol)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    return np.stack([
        96 + 60 * np.sin(xx / (29 + seed % 5)) * np.cos(yy / 23)
        + 10 * np.sin(xx / (9 + 2 * c)) + rng.normal(0, 0.7, (h, w))
        for c in range(3)], -1).clip(0, 255).astype(np.uint8)


@functools.lru_cache(maxsize=None)
def _serving(nimg: int) -> tuple:
    """nimg 64x64 all-DCT8 streams, seeded as tests/test_parallel.py's."""
    rng = np.random.default_rng(5)
    return tuple(encode_vardct(_noise(rng, 64, 64)) for _ in range(nimg))


@functools.lru_cache(maxsize=None)
def _hf_corpus(name: str) -> tuple:
    """Three 32x300 photo streams, two pass-group sections each: "ans" one
    rANS spec per image, "prefix" one prefix-code spec per image (each
    image's own code, so one kernel call mixes several specs)."""
    opts = VarDCTOptions(use_prefix=False) if name == "ans" else VarDCTOptions()
    return tuple(encode_vardct(_photo(32, 300, s), opts) for s in range(3))


@functools.lru_cache(maxsize=None)
def _port_rgba(blob: bytes) -> np.ndarray:
    return decode_file(blob, device="cpu")[1]


def _host_rgba(blob: bytes) -> np.ndarray:
    return decode_file(blob, backend="numpy")[1]


def _within1(a, b):
    assert a.shape == b.shape, (a.shape, b.shape)
    d = np.abs(a.astype(np.int64) - b.astype(np.int64))
    assert d.max() <= 1, d.max()


def _deferred(cls, blob, **kw):
    d = cls(blob, **kw)
    d.decode_frame(_defer_finish=True)
    f, _toc, state = d._deferred
    return state.vardct, state.vardct.lf_groups[0], d.image, f


# ---------------------------------------------------------------- packers


def _coeff_planes():
    """Coefficient planes of the packers' tests: a real stream's (from
    gather_full_dct8), a sparse low-amplitude one with outliers beyond the
    nibble and int8 ranges, and a noisy one that keeps int8."""
    rng = np.random.default_rng(7)
    real = CJ.gather_full_dct8(*_deferred(JDecoder, _serving(1)[0], backend="numpy"))[0]
    sparse = rng.integers(-6, 7, (3, 50, 64)).astype(np.float32)
    pos = rng.integers(0, sparse.size, 40)
    sparse.reshape(-1)[pos] = rng.integers(-300, 300, 40)
    noisy = rng.integers(-120, 120, (3, 50, 64)).astype(np.float32)
    noisy.reshape(-1)[rng.integers(0, noisy.size, 9)] = -1000
    return {"real": real, "sparse": sparse, "noisy": noisy}


@pytest.mark.parametrize("name", ["real", "sparse", "noisy"])
def test_packers_byte_equal(name):
    arr = _coeff_planes()[name]
    for got, want in zip(TC._pack_i4(arr), CJ._pack_i4(arr)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    for got, want in zip(TC._pack_i8(arr), CJ._pack_i8(arr)):
        np.testing.assert_array_equal(got, want)
    kind, *got = TC.pack_coeffs_auto(arr)
    jkind, *want = CJ.pack_coeffs_auto(arr)
    assert kind == jkind == {"real": "i8", "sparse": "i4", "noisy": "i8"}[name]
    for u, v in zip(got, want):
        assert u.dtype == v.dtype
        np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("name", ["real", "sparse"])
def test_unpack_i4_matches_jax(name):
    """unpack_i4 equals unpack_i4_jax, and with the exception scatter
    (reconstruct_dct8_full's "i4" unpack) gives the plane back exactly."""
    import jax.numpy as jnp

    arr = _coeff_planes()[name]
    packed, exc_idx, exc_val = TC._pack_i4(arr)
    got = K.unpack_i4(torch.from_numpy(packed), arr.shape)
    want = np.asarray(CJ.unpack_i4_jax(jnp.asarray(packed), arr.shape))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    dense = K.unpack_i8(got, torch.from_numpy(exc_idx), torch.from_numpy(exc_val))
    np.testing.assert_array_equal(dense.numpy(), arr)


@pytest.mark.parametrize("blob", ["dct8_64", "dct8_61x77"])
def test_gathers_byte_equal(blob):
    """gather_full_dct8 and the native gather_pack_dct8_i8 on the port's
    host state equal the JAX package's on its own, and the packed form is
    the dense gather's int8 pack."""
    data = (_serving(1)[0] if blob == "dct8_64"
            else encode_vardct(_noise(np.random.default_rng(2), 77, 61)))
    tstate = _deferred(Decoder, data, device="cpu")
    jstate = _deferred(JDecoder, data, backend="numpy")
    for got, want in zip(TC.gather_full_dct8(*tstate), CJ.gather_full_dct8(*jstate)):
        np.testing.assert_array_equal(got, want)
    (packed, *rest), ((jpacked, *jrest)) = (TC.gather_pack_dct8_i8(*tstate),
                                            CJ.gather_pack_dct8_i8(*jstate))
    for got, want in zip((*packed, *rest), (*jpacked, *jrest)):
        np.testing.assert_array_equal(got, want)
    coeffs = TC.gather_full_dct8(*tstate)[0]
    i8, eidx, evals, _gt7, fill0 = packed
    np.testing.assert_array_equal(i8, np.clip(coeffs, -127, 127).astype(np.int8))
    for got, want in zip(TC._exceptions(eidx, evals, fill0), TC._pack_i8(coeffs)[1:]):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("amp,want", [(6, "i4"), (110, "i8")])
def test_assemble_chunk_byte_equal(amp, want):
    """Both upload kinds, 3 images in a chunk of 4 (a padded tail) with
    exceptions beyond +-127 (one at each image's flat position 0), against
    JAX's assembler; and the chunk unpacks to the coefficients exactly."""
    from j40_tpu_torch.native.bindings import pack_coeffs_i8

    rng = np.random.default_rng(11)
    h8, w8 = 2, 8
    n = h8 * w8
    plans, origs = [], []
    for i in range(3):
        c = rng.integers(-amp, amp + 1, (3, n, 64)).astype(np.float32)
        pos = rng.integers(0, c.size, 7)
        c.reshape(-1)[pos] = rng.integers(-500, 500, 7)
        c.reshape(-1)[0] = 300 + i
        aux = rng.normal(size=(6, n)).astype(np.float32)
        aux[4] = aux[4, 0]  # CfL factors are per 64px tile
        aux[5] = aux[5, 0]
        plans.append(((*pack_coeffs_i8(c), int(c.reshape(-1)[0])), aux, None, None))
        origs.append(c)
    got = PB._assemble_chunk(plans, 4, n, h8, w8)
    ref = JB._assemble_chunk(plans, 4, n, h8, w8)
    assert got[0] == ref[0] == want
    for u, v in zip(got[1:], ref[1:]):
        assert u.dtype == v.dtype
        np.testing.assert_array_equal(u, v)
    kind, cup, exc_idx, exc_val, aux, kgrids = (
        x if isinstance(x, str) else torch.from_numpy(x) for x in got)
    if kind == "i4":
        cup = K.unpack_i4(cup, (3, 4 * n, 64))
    dense = K.unpack_i8(cup, exc_idx, exc_val).numpy()
    for i, c in enumerate(origs):
        np.testing.assert_array_equal(dense[:, i * n:(i + 1) * n], c)
    assert not dense[:, 3 * n:].any()


def test_reconstruct_kinds_agree():
    """reconstruct_dct8_full gives, from each packed upload kind of one LF
    group's coefficients, the pixels of B1 on the dense coefficients."""
    vs, gg, im, _f = _deferred(Decoder, _serving(1)[0], device="cpu")
    inp = TC.lf_group_inputs(vs, gg, im)
    coeffs = K.unpack_i8(*(torch.from_numpy(inp[k]) for k in ("i8", "exc_idx", "exc_val")))
    args = [torch.from_numpy(np.asarray(inp[k], np.float32))
            for k in ("aux", "weights", "consts22")]
    want = K.reconstruct_dct8_srgb(coeffs, *args, inp["h8"], inp["w8"], True)
    for kind in ("i8", "i4"):
        up = [torch.from_numpy(a) for a in getattr(TC, f"_pack_{kind}")(coeffs.numpy())]
        got = K.reconstruct_dct8_full(*up, *args, inp["h8"], inp["w8"], True, kind=kind)
        assert torch.equal(got, want), kind
    with pytest.raises(ValueError, match="upload kind"):
        K.reconstruct_dct8_full(*up, *args, inp["h8"], inp["w8"], True, kind="f32")


# ---------------------------------------------------------------- batch paths


@pytest.mark.parametrize("nimg,chunk", [(5, 2), (4, 4)])
def test_decode_batch_device(monkeypatch, nimg, chunk):
    """The serving path on the CPU: exactly the per-image port decodes
    (a padded tail chunk at 5 images / chunk 2), within 1 level of
    j40_tpu's decode_batch_device (Pallas interpret mode) and of the host
    plan; the tensor stays on the device unless fetched."""
    blobs = list(_serving(nimg))
    K.reset_launches()
    st: dict = {}
    out = PB.decode_batch_device(blobs, workers=2, chunk=chunk, stats_out=st, device="cpu")
    assert not any(K.launches.values()), K.launches  # plain versions on the CPU
    assert isinstance(out, torch.Tensor) and out.is_contiguous()
    assert out.shape == (nimg, 64, 64, 4) and out.dtype == torch.uint8
    assert st.keys() >= {"images", "chunk", "upload_bytes", "pack_s", "entropy_s",
                         "dispatch_block_s", "pack_kind", "dispatch_issued_s",
                         "ready_s", "total_s"}
    assert st["images"] == nimg and st["upload_bytes"] > 0 and st["pack_kind"] == "i8"
    fetched = PB.decode_batch_device(blobs, workers=2, chunk=chunk, fetch=True, device="cpu")
    np.testing.assert_array_equal(fetched, out.numpy())
    monkeypatch.setenv("J40T_PALLAS", "interp")
    jax_out = JB.decode_batch_device(blobs, workers=2, chunk=chunk, fetch=True)
    for blob, got, ref in zip(blobs, fetched, jax_out):
        np.testing.assert_array_equal(got, _port_rgba(blob))
        _within1(got, ref)
        _within1(got, _host_rgba(blob))


def test_decode_batch_device_i4(monkeypatch):
    """A flat corpus packs to nibbles: the "i4" kind through the whole path
    of decode_batch_device and of decode_batch's fused route, still exactly
    the per-image decodes."""
    blobs = [encode_vardct(_photo(64, 64, s)) for s in range(3)]
    st: dict = {}
    out = PB.decode_batch_device(blobs, workers=2, chunk=2, fetch=True, stats_out=st,
                                 device="cpu")
    assert st["pack_kind"] == "i4"
    for blob, got in zip(blobs, out):
        np.testing.assert_array_equal(got, _port_rgba(blob))
    # decode_batch's fused route packs the same way
    monkeypatch.setattr(PB, "_decode_batch_roundrobin", None)
    for blob, got in zip(blobs, PB.decode_batch(blobs, workers=2, device="cpu")):
        np.testing.assert_array_equal(got, _port_rgba(blob))


def test_decode_batch_routes(monkeypatch):
    """decode_batch(backend="torch"): a uniform batch takes the fused route
    (one B1 call a chunk, no per-image decode), a mixed batch round-robin;
    both give the per-image decodes exactly."""
    calls = []
    real = PB._decode_batch_roundrobin
    monkeypatch.setattr(PB, "_decode_batch_roundrobin",
                        lambda *a, **kw: calls.append(a) or real(*a, **kw))
    blobs = list(_serving(3))
    outs = PB.decode_batch(blobs, workers=2, device="cpu")
    assert calls == []
    for blob, got in zip(blobs, outs):
        np.testing.assert_array_equal(got, _port_rgba(blob))

    rng = np.random.default_rng(9)
    img = _noise(rng, 150, 260)
    img[:64, :128] = img[3, 3]
    mixed = [blobs[0], encode_vardct_mixed(img), encode_vardct(_noise(rng, 40, 48))]
    outs = PB.decode_batch(mixed, workers=2, device="cpu")
    assert len(calls) == 1
    for blob, got in zip(mixed, outs):
        np.testing.assert_array_equal(got, _port_rgba(blob))
    host = PB.decode_batch(mixed, workers=2, backend="numpy")
    for got, ref in zip(outs, host):
        _within1(got, ref)


@pytest.mark.parametrize("corpus", ["ans", "prefix"])
def test_decode_batch_device_hf(corpus):
    """The on-card HF batch: one B4 call over all images' sections, each
    image against its own code spec; exactly the pack path's output and the
    per-image decodes."""
    blobs = list(_hf_corpus(corpus))
    specs = []
    for b in blobs:
        vd = _deferred(Decoder, b, device="cpu", max_passes=0)[0]
        specs.append(vd.coeff_codespec[0])
    assert all(s.use_prefix_code == (corpus == "prefix") for s in specs)
    if corpus == "prefix":  # the call mixes different code specs
        from j40_tpu_torch.native.bindings import serialize_spec

        assert len({serialize_spec(s).tobytes() for s in specs}) == len(specs)
    st: dict = {}
    out = PB.decode_batch_device_hf(blobs, workers=2, chunk=2, fetch=True, stats_out=st,
                                    device="cpu")
    assert st["kernel_calls"] == 1 and st["images"] == 3
    ref = PB.decode_batch_device(blobs, workers=2, chunk=2, fetch=True, device="cpu")
    np.testing.assert_array_equal(out, ref)
    for blob, got in zip(blobs, out):
        want = _port_rgba(blob)
        np.testing.assert_array_equal(got[:want.shape[0], :want.shape[1]], want)


def test_non_uniform_batches_raise(monkeypatch):
    """The device paths refuse non-uniform batches with ValueError, as
    j40_tpu's do."""
    rng = np.random.default_rng(3)
    sizes = [encode_vardct(_noise(rng, 64, 64)), encode_vardct(_noise(rng, 64, 72))]
    with pytest.raises(ValueError, match="non-uniform"):
        PB.decode_batch_device(sizes, workers=2, chunk=2, device="cpu")
    monkeypatch.setenv("J40T_PALLAS", "interp")
    with pytest.raises(ValueError, match="non-uniform"):
        JB.decode_batch_device(sizes, workers=2, chunk=2)
    img = _noise(rng, 150, 260)
    img[:64, :128] = img[3, 3]
    with pytest.raises(ValueError, match="non-uniform"):
        PB.decode_batch_device([sizes[0], encode_vardct_mixed(img)], workers=2, chunk=2,
                               device="cpu")
    hf = [encode_vardct(_photo(32, 300, 0)), encode_vardct(_photo(40, 300, 1))]
    with pytest.raises(ValueError, match="non-uniform"):
        PB.decode_batch_device_hf(hf, workers=2, chunk=2, device="cpu")


# ---------------------------------------------------------------- device output


@pytest.mark.parametrize("backend", ["torch", "device"])
def test_render_rgba8_device_planes(backend):
    """keep_device_output=True on a VarDCT stream of two LF groups (one
    mixed): render_rgba8_device assembles the kept u8 planes, a tensor on
    the decoder's device equal to render_rgba8()."""
    rng = np.random.default_rng(21)
    img = np.cumsum(rng.integers(-2, 3, (64, 2304, 3)), axis=1).astype(np.uint8)
    img[:32, :256] = img[3, 3]
    dec = Decoder(encode_vardct_mixed(img), backend=backend, device="cpu",
                  keep_device_output=True, workers=2)
    dec.decode_frame()
    got = dec.render_rgba8_device()
    assert dec.stats["device_output"] == "planes"
    assert len(dec._device_planes) == 2
    assert got.device.type == "cpu" and got.dtype == torch.uint8 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), dec.render_rgba8())


def test_render_rgba8_device_host_render():
    """A Modular stream keeps no device planes: render_rgba8_device uploads
    the host render and says so."""
    rng = np.random.default_rng(4)
    dec = Decoder(encode_modular(_noise(rng, 40, 56)), device="cpu",
                  keep_device_output=True)
    dec.decode_frame()
    got = dec.render_rgba8_device()
    assert dec.stats["device_output"] == "host_render"
    np.testing.assert_array_equal(got.numpy(), dec.render_rgba8())


def test_isolation_scan_covers_parallel():
    """tests/test_torch_isolation.py's import scan walks the new package."""
    from test_torch_isolation import PORT, test_no_forbidden_imports

    files = set(PORT.rglob("*.py"))
    for name in ("__init__.py", "batch.py"):
        path = PORT / "parallel" / name
        assert path in files
        test_no_forbidden_imports(path)


def test_hf_assembly_forms_agree():
    """The two gathers of decode_batch_device_hf's chunk assembly: the one
    a chunk (images sharing one section layout) and the one an image (any
    layout) give the same (3, k*n, 64) blocks, a ragged tail repeating the
    last image."""
    rng = np.random.default_rng(17)
    dense = torch.from_numpy(rng.normal(size=(6, 3, 5, 64)).astype(np.float32))
    lane_b = torch.from_numpy(rng.integers(0, 2, 7))
    cell_b = torch.from_numpy(rng.integers(0, 5, 7))
    offs = [0, 2, 4, 4]
    got = PB._assemble_hf_chunk(dense, lane_b, cell_b, torch.tensor(offs))
    want = torch.cat([PB._assemble_hf(dense, lane_b + o, cell_b) for o in offs], dim=1)
    assert got.is_contiguous() and got.shape == (3, 28, 64)
    assert torch.equal(got, want)
    assert torch.equal(want[:, 7:14], dense[lane_b + 2, :, cell_b, :].permute(1, 0, 2))
