"""The port's multi-device decode (j40_tpu_torch/parallel/{mesh,sharded_decode,
sharded_lossless,sharded_entropy}.py, ops/sharded_filters.py, graft_entry.py)
against j40_tpu's functions of the same names, on the same inputs.

j40_tpu runs on the 8 virtual CPU devices of tests/conftest.py; the port
runs on `Mesh([cpu] * n)`, whose wrappers take their kernels' plain
versions.  Bars: 1e-5 absolute on filtered planes (samples of order 1, fp32
sums in another order); 1 gray level on VarDCT output (a sample that close
to a rounding boundary may round either way), 17 units at 16 bits (one
12-bit level); exact on the lossless and entropy paths.
"""

import numpy as np
import pytest
import torch

from j40_tpu.decode import decode_file
from j40_tpu.encode.advanced import AdvancedOptions, encode_modular_advanced
from j40_tpu.encode.encoder import EncodeOptions, encode_modular
from j40_tpu.encode.vardct_enc import VarDCTOptions, encode_vardct, encode_vardct_mixed
from j40_tpu_torch.ops import filter_kernels as FK
from j40_tpu_torch.ops import sharded_filters as TSF
from j40_tpu_torch.parallel import mesh as TM
from j40_tpu_torch.parallel import sharded_decode as TSD
from j40_tpu_torch.parallel import sharded_entropy as TSE
from j40_tpu_torch.parallel import sharded_lossless as TSL

FTOL = 1e-5


def _jax_mesh(n, shape=None, axes=("rows",)):
    import jax
    from jax.sharding import Mesh

    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} JAX devices (tests/conftest.py's virtual CPU mesh)")
    devs = np.array(jax.devices()[:n])
    return Mesh(devs.reshape(shape) if shape else devs, axes)


def _mesh(n, shape=None, axes=("rows",)):
    devs = np.array([torch.device("cpu")] * n, dtype=object)
    return TM.Mesh(devs.reshape(shape) if shape else devs, axes)


def _walk(shape, seed, lo=-2, hi=3, mod=180, base=30, axes=(1,)):
    rng = np.random.default_rng(seed)
    x = rng.integers(lo, hi, size=shape)
    for a in axes:
        x = np.cumsum(x, axis=a)
    return (x % mod + base).astype(np.uint8)


def _host(blob, **kw):
    from j40_tpu_torch.decode import Decoder

    d = Decoder(blob, backend="numpy", **kw)
    d.decode_frame()
    return d


def _maxdiff(a, b):
    return int(np.abs(a.astype(np.int64) - b[..., :3].astype(np.int64)).max())


# ---------------------------------------------------------------- inputs

def _stream(name):
    """(blob, mesh size) of each decode case, at tests/test_parallel.py's
    sizes."""
    if name == "multi_lf":  # two LF groups, filters off
        return encode_vardct(_walk((128, 2560, 3), 60)), 8
    if name == "ragged_filtered":  # 237 rows over 4 shards, gaborish + EPF
        img = _walk((237, 520, 3), 61, mod=200, base=20, axes=(0, 1))
        return encode_vardct(img, VarDCTOptions(sharpness=7)), 4
    if name == "mixed_overlay":  # non-aligned shards: the overlay
        img = _walk((320, 512, 3), 7, mod=200, base=20)
        img[:96, :192] = img[4, 4]
        return encode_vardct_mixed(img), 8
    if name == "mixed_compute":  # 2 group rows on 2 shards: classes in-shard
        img = _walk((512, 256, 3), 6)
        img[:64, :96] = img[3, 3]
        return encode_vardct_mixed(img), 2
    if name == "bit16":
        rng = np.random.default_rng(84)
        img = (np.cumsum(np.cumsum(rng.integers(-20, 21, (96, 112, 3)), 0), 1)
               % 3800 + 100).astype(np.uint16)
        return encode_vardct(img, VarDCTOptions(bpp=12)), 4
    raise KeyError(name)


DECODE_CASES = {
    # name: (apply_filters, path); "plan" runs plan_frame + _run_sharded
    "multi_lf": (False, "decode"),
    "ragged_filtered": (True, "decode"),
    "mixed_overlay": (True, "decode"),
    "mixed_compute": (False, "plan"),
}


@pytest.fixture(scope="module")
def jax_ref():
    """j40_tpu's result of each case, computed once per module."""
    cache = {}

    def get(name, *args):
        key = (name, *args)
        if key not in cache:
            cache[key] = _JAX[name](*args)
        return cache[key]

    return get


def _jax_decode(name):
    from j40_tpu.parallel import sharded_decode as J

    blob, n = _stream(name)
    filters, path = DECODE_CASES[name]
    if path == "plan":
        plan = J.plan_frame(blob, owners=n)
        return J._run_sharded([plan], _jax_mesh(n), ("rows",), filters)[0]
    return J.decode_sharded(blob, mesh=_jax_mesh(n), apply_filters=filters)


def _jax_bit16():
    from j40_tpu.parallel.sharded_decode import decode_sharded

    blob, n = _stream("bit16")
    return decode_sharded(blob, mesh=_jax_mesh(n), apply_filters=True, bit_depth=16)


def _batch_blobs():
    rng = np.random.default_rng(62)
    return [encode_vardct((np.cumsum(rng.integers(-2, 3, size=(96, 320, 3)), axis=1)
                           % 180 + 30).astype(np.uint8)) for _ in range(2)]


def _jax_batch():
    from j40_tpu.parallel.sharded_decode import decode_sharded_batch

    return decode_sharded_batch(_batch_blobs(), _jax_mesh(8, (2, 4), ("img", "rows")),
                                apply_filters=False)


def _lossless_blob(rct_type):
    img = _walk((192, 320, 3), 77, lo=-3, hi=4, mod=210, base=20)
    opts = AdvancedOptions(squeeze=True, rct_type=rct_type) if rct_type else \
        AdvancedOptions(squeeze=True)
    return encode_modular_advanced(img, options=opts)


def _jax_lossless(rct_type):
    from j40_tpu.parallel.sharded_lossless import decode_sharded_lossless

    return decode_sharded_lossless(_lossless_blob(rct_type), mesh=_jax_mesh(4))


def _ycbcr_blob(subsample):
    # tests/test_parallel.py::test_sharded_lossless_ycbcr's stream
    rng = np.random.default_rng(85)
    img = (np.cumsum(rng.integers(-3, 4, (96, 128, 3)), 1) % 200).astype(np.uint8)
    return encode_modular(img, options=EncodeOptions(ycbcr=True, ycbcr_subsample=subsample))


def _jax_lossless_ycbcr(subsample):
    from j40_tpu.parallel.sharded_lossless import decode_sharded_lossless

    return decode_sharded_lossless(_ycbcr_blob(subsample), mesh=_jax_mesh(4))


def _entropy_blob():
    # 8 sections of 128x8 (the plain token decoder takes ~0.25 ms a symbol
    # step on the CPU), global tree, rANS
    img = _walk((8, 128 * 8, 3), 5, lo=-3, hi=4, mod=200, base=20)
    return encode_modular(img, options=EncodeOptions(
        global_tree=True, use_prefix=False, group_size_shift=7))


def _jax_entropy():
    from j40_tpu.parallel.sharded_entropy import decode_modular_sections_sharded

    planes, _, _ = decode_modular_sections_sharded(_entropy_blob(), mesh=_jax_mesh(8),
                                                   axis="rows", use_pallas=False)
    return planes


def _filter_inputs(seed):
    rng = np.random.default_rng(seed)
    img = (rng.normal(size=(3, 64, 48)) * 0.1).astype(np.float32)
    rs = rng.uniform(0.5, 2.5, size=(8, 6)).astype(np.float32)
    rs[3, 2] = -1.0  # a skipped block
    return img, np.repeat(np.repeat(rs, 8, 0), 8, 1)


def _jax_epf(route):
    import os

    from j40_tpu.ops.sharded_filters import sharded_epf

    img, rs_px = _filter_inputs(45)
    old = os.environ.get("J40T_PALLAS")
    if route == "pallas":  # the per-shard Pallas kernel in interpret mode
        os.environ["J40T_PALLAS"] = "interp"
    try:
        return np.asarray(sharded_epf(img, rs_px, _jax_mesh(8), iters=3))
    finally:
        if old is None:
            os.environ.pop("J40T_PALLAS", None)
        else:
            os.environ["J40T_PALLAS"] = old


_JAX = {"decode": _jax_decode, "bit16": _jax_bit16, "batch": _jax_batch,
        "lossless": _jax_lossless, "lossless_ycbcr": _jax_lossless_ycbcr,
        "entropy": _jax_entropy, "epf": _jax_epf}


# ---------------------------------------------------------------- the mesh

def test_mesh_shape_and_exchange():
    m = _mesh(8, (2, 4), ("img", "rows"))
    assert m.shape == {"img": 2, "rows": 4} and m.axis_names == ("img", "rows")
    assert TM.axis_devices(m, "rows", 1) == [torch.device("cpu")] * 4
    assert len(TM.axis_devices(m, "img")) == 2
    xs = [torch.full((2,), float(i)) for i in range(4)]
    above, below = TM.exchange([torch.device("cpu")] * 4, xs, [x + 10 for x in xs])
    assert above[0] is None and below[-1] is None
    assert [float(a[0]) for a in above[1:]] == [0.0, 1.0, 2.0]
    assert [float(b[0]) for b in below[:-1]] == [11.0, 12.0, 13.0]


def test_default_mesh_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.default_mesh(2)
    blob = encode_vardct(_walk((16, 16, 3), 1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TSD.decode_sharded(blob)


# ---------------------------------------------------------------- filters

def test_rows_entries_vs_jax_rows():
    """The plain versions of B7's and B9's rows entries against
    j40_tpu's row-shard filters on one stripe with foreign halo rows."""
    import jax.numpy as jnp

    from j40_tpu.ops.filters import KERNELS12, _epf_step_jax_rows
    from j40_tpu.ops.sharded_filters import _gaborish_rows

    rng = np.random.default_rng(3)
    rows = rng.normal(size=(3, 16 + 6, 40)).astype(np.float32)
    rs8 = rng.uniform(0.5, 2.5, size=(2, 5)).astype(np.float32)
    rs8[1, 3] = -1.0
    rs_px = np.repeat(np.repeat(rs8, 8, 0), 8, 1)
    ref = np.asarray(_epf_step_jax_rows(jnp.asarray(rows), jnp.asarray(rows[:, 3:-3]),
                                        jnp.asarray(rs_px), 0, 0.9, KERNELS12, True,
                                        (40.0, 5.0, 3.5), 2.78))
    got = FK.epf_step_rows(torch.from_numpy(rows), torch.from_numpy(rs8), 0.9, 0,
                           (40.0, 5.0, 3.5), 2.78)
    assert got.shape == (3, 16, 40)
    np.testing.assert_allclose(got.numpy(), ref, atol=FTOL)

    w = [(0.115, 0.061), (0.2, 0.05), (0.1, 0.02)]
    g = rows[:, 2:-2]
    ref = np.asarray(_gaborish_rows(jnp.asarray(g[:, 1:-1]), jnp.asarray(g[:, 0]),
                                    jnp.asarray(g[:, -1]), w))
    got = TSF._gaborish_rows(torch.from_numpy(g[:, 1:-1]), torch.from_numpy(g[:, 0]),
                             torch.from_numpy(g[:, -1]), w)
    np.testing.assert_allclose(got.numpy(), ref, atol=FTOL)


def test_rows_calls_step_by_step():
    """chip_smoke.py's kernel rows and tools/torch_kernel_ab.py's B7 rows
    cases take call n k + 1 of B7's rows entry as step k of shard 1: a
    filtered decode on n shards runs the EPF steps one after another, each
    on shards 0 .. n - 1 (chip_smoke.keep_rows_calls keeps the calls)."""
    import chip_smoke

    img = _walk((64, 96, 3), 5, mod=200, base=20, axes=(0, 1))
    blob = encode_vardct(img, VarDCTOptions(sharpness=5, custom_restoration=True,
                                            epf_iters=3))
    n = 4
    with chip_smoke.keep_rows_calls() as calls:
        TSD.decode_sharded(blob, mesh=_mesh(n), apply_filters=True)
    assert [a[3] for a in calls["epf"]] == [k for k in range(3) for _ in range(n)]
    assert len(calls["gab"]) == n
    for k in range(3):
        assert tuple(calls["epf"][n * k + 1][0].shape) == (3, 64 // n + 6, 96)
    assert FK.epf_step_rows.__name__ == "epf_step_rows"  # restored


def test_sharded_gaborish():
    from j40_tpu.ops.sharded_filters import sharded_gaborish

    img = np.random.default_rng(44).normal(size=(3, 64, 48)).astype(np.float32)
    weights = [[0.115169525, 0.061248592]] * 3
    ref = np.asarray(sharded_gaborish(img, weights, _jax_mesh(8)))
    got = TSF.sharded_gaborish(img, weights, _mesh(8))
    assert got.shape == (3, 64, 48)
    np.testing.assert_allclose(got.numpy(), ref, atol=FTOL)


@pytest.mark.parametrize("route", ["xla", "pallas"])
def test_sharded_epf(jax_ref, route):
    """Against both of j40_tpu's per-shard routes: its XLA step and its
    Pallas kernel B7 (interpret mode), which take the sigma scale in
    different forms."""
    img, rs_px = _filter_inputs(45)
    got = TSF.sharded_epf(img, rs_px, _mesh(8), iters=3)
    np.testing.assert_allclose(got.numpy(), jax_ref("epf", route), atol=FTOL)


def test_sharded_epf_refuses_unaligned_shards():
    img, rs_px = _filter_inputs(45)
    with pytest.raises(ValueError, match="8-aligned"):
        TSF.sharded_epf(img[:, :48], rs_px[:48], _mesh(4))
    rs_px = rs_px.copy()
    rs_px[0, 0] += 1.0
    with pytest.raises(ValueError, match="8x8 blocks"):
        TSF.sharded_epf(img, rs_px, _mesh(8))


# ---------------------------------------------------------------- VarDCT

@pytest.mark.parametrize("name", list(DECODE_CASES))
def test_decode_sharded(jax_ref, name):
    blob, n = _stream(name)
    filters, path = DECODE_CASES[name]
    if path == "plan":
        plan = TSD.plan_frame(blob, owners=n)
        assert plan.classes, "expected non-8x8 classes"
        got = TSD._run_sharded([plan], _mesh(n), ("rows",), filters)[0]
        assert plan.overlay is None, "group-aligned shards compute the classes"
    else:
        got = TSD.decode_sharded(blob, mesh=_mesh(n), apply_filters=filters)
    ref = jax_ref("decode", name)
    assert got.shape == ref.shape and got.dtype == np.uint8
    assert _maxdiff(got, ref) <= 1
    assert _maxdiff(got, _host(blob, apply_filters=filters).render_rgba8()) <= 1


def test_decode_sharded_ragged_width():
    """The mixed_compute path on a ragged width: a 512x252 mixed stream
    whose flat right band takes DCT32 varblocks up to x = 224, so one
    reaches past W = 252 into the 8-padded grid.  Held against the port's
    host plan, not against j40_tpu: its shard program crops each shard to
    W before it scatters the varblocks with row stride W
    (j40_tpu/parallel/sharded_decode.py:599-634), so such a varblock wraps
    into columns 0.. of the next rows (183 levels off on this stream).
    The port scatters before the crop."""
    img = _walk((512, 252, 3), 6)
    img[:, 160:] = img[3, 200]
    blob = encode_vardct_mixed(img)
    plan = TSD.plan_frame(blob, owners=2)
    assert any((np.asarray(e["px"]) + 8 * e["vw8"] > 252).any()
               for e in plan.classes.values()), "no varblock past the ragged edge"
    got = TSD._run_sharded([plan], _mesh(2), ("rows",), False)[0]
    assert plan.overlay is None, "group-aligned shards compute the classes"
    assert got.shape == (512, 252, 3) and got.dtype == np.uint8
    assert _maxdiff(got, _host(blob).render_rgba8()) <= 1


def test_decode_sharded_batch(jax_ref):
    blobs = _batch_blobs()
    outs = TSD.decode_sharded_batch(blobs, _mesh(8, (2, 4), ("img", "rows")),
                                    apply_filters=False)
    for blob, got, ref in zip(blobs, outs, jax_ref("batch")):
        assert _maxdiff(got, ref) <= 1
        assert _maxdiff(got, decode_file(blob)[1]) <= 1


def test_decode_sharded_16bit(jax_ref):
    blob, n = _stream("bit16")
    got = TSD.decode_sharded(blob, mesh=_mesh(n), apply_filters=True, bit_depth=16)
    assert got.dtype == np.uint16
    assert _maxdiff(got, jax_ref("bit16")) <= 17
    assert _maxdiff(got, _host(blob, apply_filters=True).render_rgba16()) <= 17


# ---------------------------------------------------------------- lossless

@pytest.mark.parametrize("rct_type", [0, 6])
def test_sharded_lossless(jax_ref, rct_type):
    blob = _lossless_blob(rct_type)
    got = TSL.decode_sharded_lossless(blob, mesh=_mesh(4))
    np.testing.assert_array_equal(got, jax_ref("lossless", rct_type))
    np.testing.assert_array_equal(got, _host(blob, workers=2).render_rgba8())


@pytest.mark.parametrize("subsample", [(0, 0, 0), (1, 0, 1)], ids=["444", "420"])
def test_sharded_lossless_ycbcr(jax_ref, subsample):
    """YCbCr frames, chroma full or 2x subsampled (replicated in the
    render): the f32 BT.601 render equal to j40_tpu's, within 1 level of
    the host plan's f64."""
    blob = _ycbcr_blob(subsample)
    got = TSL.decode_sharded_lossless(blob, mesh=_mesh(4))
    np.testing.assert_array_equal(got, jax_ref("lossless_ycbcr", subsample))
    assert np.abs(got.astype(np.int64) - _host(blob).render_rgba8()).max() <= 1


def test_sharded_lossless_palette_raises():
    from j40_tpu_torch.errors import Unsupported

    rng = np.random.default_rng(8)
    pal = rng.integers(0, 255, (5, 3), dtype=np.uint8)
    blob = encode_modular_advanced(pal[rng.integers(0, 5, (64, 64))],
                                   options=AdvancedOptions(palette=True))
    with pytest.raises(Unsupported):
        TSL.decode_sharded_lossless(blob, mesh=_mesh(2))


def test_trunc_div_and_smooth_tendency():
    """The int32 helpers of the plain merge (ops/squeeze_kernels.py) against
    j40_tpu's on every sign case."""
    import jax.numpy as jnp

    from j40_tpu.parallel import sharded_lossless as J
    from j40_tpu_torch.ops import squeeze_kernels as SQ

    rng = np.random.default_rng(1)
    a, b, n = (rng.integers(-300, 300, 4000).astype(np.int32) for _ in range(3))
    for d in (2, 12):
        np.testing.assert_array_equal(SQ._trunc_div(torch.from_numpy(a), d).numpy(),
                                      np.asarray(J._trunc_div(jnp.asarray(a), d)))
    got = SQ._smooth_tendency(*(torch.from_numpy(v) for v in (b, a, n)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(J._smooth_tendency(
        *(jnp.asarray(v) for v in (b, a, n)))))


# ---------------------------------------------------------------- entropy

def test_sharded_entropy(jax_ref):
    blob = _entropy_blob()
    planes, lanes, dec = TSE.decode_modular_sections_sharded(blob, _mesh(8), axis="rows")
    np.testing.assert_array_equal(planes, jax_ref("entropy"))
    gm = dec._deferred[2].gmodular
    for k, ln in enumerate(lanes):
        for c, (gi, x0, y0, w, h) in enumerate(ln.picks):
            np.testing.assert_array_equal(planes[k, c],
                                          gm.channels[gi].data[y0:y0 + h, x0:x0 + w])
    assert len(lanes) == 8


def test_sharded_entropy_refuses_local_trees():
    blob = encode_modular(_walk((8, 256, 3), 2), options=EncodeOptions(group_size_shift=7))
    with pytest.raises(ValueError):
        TSE.decode_modular_sections_sharded(blob, _mesh(2))


# ---------------------------------------------------------------- entry points

def test_entry_twin():
    """graft_entry.entry() against __graft_entry__.entry(): the same
    function of the same inputs (relative bound on pre-clamp values far
    outside [0, 255], as tests/test_torch_reconstruct.py)."""
    import __graft_entry__

    from j40_tpu_torch import graft_entry

    fn, args = graft_entry.entry(device="cpu")
    jfn, jargs = __graft_entry__.entry()
    for a, j in zip(args, jargs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(j))
    got, ref = fn(*args).numpy().astype(np.int64), np.asarray(jfn(*jargs), np.int64)
    assert got.shape == ref.shape == (3, 64, 64)
    assert (np.abs(got - ref) <= np.maximum(1, 1e-5 * np.abs(ref))).all()


def test_dryrun_multichip_cpu():
    from j40_tpu_torch.graft_entry import dryrun_multichip

    out = dryrun_multichip(8, device="cpu")
    assert out["mesh"] == (2, 4) and out["lossless_bit_exact"]
    assert out["entropy_planes_exact"] == 3 * out["entropy_sections"] >= 24
