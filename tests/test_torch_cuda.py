"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need a CUDA device (the kernels have no CPU mode) and skip elsewhere;
the file imports no jax, so it runs on a machine with only PyTorch:

    python -m pytest tests/test_torch_cuda.py -m cuda

Tolerances: float samples within 1e-4 absolute (fp32 sums in another order
and FMA contraction); quantized sRGB within 1 level, or within 1e-5 of the
value where pre-clamp sRGB lies far outside [0, maxval].  The filters,
on samples of scale 50: within 2e-3 absolute (sums of up to 13 weighted
taps with FMA contraction, as tests/test_filters.py holds the Pallas EPF).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from j40_tpu_torch.decode import Decoder
from j40_tpu_torch.encode.vardct_enc import (
    VarDCTOptions, encode_vardct, encode_vardct_mixed,
)
from j40_tpu_torch.headers.image import (
    OPSIN_BIAS, OPSIN_INV_MAT, QUANT_BIAS, QUANT_BIAS_NUM,
)
from j40_tpu_torch.ops import filter_kernels as FK
from j40_tpu_torch.ops import kernels as K
from j40_tpu_torch.vardct.dequant import DqMatrix, load_dq_matrix

pytestmark = pytest.mark.cuda
FTOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _consts22(maxval):
    return torch.tensor(np.concatenate([
        [65536.0 / 32768.0, 0.8, 1.25, *QUANT_BIAS, QUANT_BIAS_NUM, 0.0],
        np.asarray(OPSIN_INV_MAT, np.float64).ravel(),
        [OPSIN_BIAS] * 3, [1.0, maxval],
    ]).astype(np.float32))


def _inputs(h8, w8, seed=0):
    """Coefficients with exceptions (|q| > 127) and zero cells, aux in the
    ranges of a real LF group, the DCT8 weights."""
    rng = np.random.default_rng(seed + 100 * h8 + w8)
    n = h8 * w8
    q = rng.integers(-6, 7, size=(3, n, 64)).astype(np.float32)
    q[rng.random(q.shape) < 0.6] = 0.0
    m = rng.random(q.shape) < 0.01
    q[m] = rng.choice([-1, 1], m.sum()) * rng.integers(128, 400, m.sum())
    y = rng.uniform(0.05, 0.6, n)
    aux = np.stack([
        rng.normal(size=n) * 0.01, y, y + rng.normal(size=n) * 0.05,
        rng.uniform(0.1, 0.2, n), rng.normal(size=n) * 0.05,
        1.0 + rng.normal(size=n) * 0.05,
    ]).astype(np.float32)
    q[:, ::3] = 0.0
    aux[:, ::3] = 0.0
    return [torch.from_numpy(a) for a in (q, aux, load_dq_matrix(0, DqMatrix()))]


def _int_close(a, b):
    a, b = a.cpu().to(torch.int64), b.cpu().to(torch.int64)
    assert a.shape == b.shape
    d = (a - b).abs()
    assert (d <= torch.clamp_min(1e-5 * b.abs(), 1)).all(), d.max()


# the separable kernel's strips are runs of up to 16 blocks of one block
# row: w8 of 1, 15, 17, 33 and 300 at h8 of 1 and 3 put the ragged right
# edge and the 8-byte u8 rows of odd w8 at each place in a strip
@pytest.mark.parametrize("h8,w8", [(1, 1), (5, 7), (8, 8), (23, 29), (128, 128),
                                   (1, 15), (1, 17), (1, 33), (1, 300), (3, 1),
                                   (3, 15), (3, 17), (3, 33), (3, 300)])
def test_dct8_kernels_vs_plain(cuda, h8, w8):
    args = [t.to(cuda) for t in _inputs(h8, w8)]
    for maxval, to_u8 in ((255.0, True), (4095.0, False)):
        c22 = _consts22(maxval).to(cuda)
        got = K.reconstruct_dct8_srgb(*args, c22, h8, w8, to_u8)
        assert got.dtype == (torch.uint8 if to_u8 else torch.int32)
        _int_close(got, K.reconstruct_dct8_srgb_ref(*args, c22, h8, w8, to_u8))
    got = K.reconstruct_dct8(*args, c22[:8], h8, w8)
    ref = K.reconstruct_dct8_ref(*args, c22[:8], h8, w8)
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max().item() <= FTOL


@pytest.mark.parametrize("h8,w8", [(4, 9), (3, 45), (256, 256)])
def test_dct8_zero_cells_and_full_group(cuda, h8, w8):
    """B2 on a mixed-style grid (every third cell zero in coefficients and
    aux, as a mixed group's big-block cells are) gives exactly 0 there and
    agrees with the plain version elsewhere, up to a full 2048x2048 LF
    group (the main path's shape)."""
    q, aux, w = (t.to(cuda) for t in _inputs(h8, w8))
    c8 = _consts22(255.0)[:8].to(cuda)
    got = K.reconstruct_dct8(q, aux, w, c8, h8, w8)
    ref = K.reconstruct_dct8_ref(q, aux, w, c8, h8, w8)
    cells = got.reshape(3, h8, 8, w8, 8).permute(0, 1, 3, 2, 4).reshape(3, h8 * w8, 64)
    assert (cells[:, ::3] == 0).all()
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max().item() <= FTOL


@pytest.mark.parametrize("shape", [(3, 1, 1), (3, 37, 61), (3, 300, 2048)])
def test_xyb_kernel_vs_plain(cuda, shape):
    rng = np.random.default_rng(shape[1])
    plane = torch.from_numpy(rng.normal(size=shape).astype(np.float32) * 0.3).to(cuda)
    c22 = _consts22(255.0).to(cuda)
    for to_u8 in (False, True):
        _int_close(K.xyb_to_srgb(plane, c22, to_u8),
                   K.xyb_to_srgb_ref(plane, c22, to_u8))


def test_unpack_i8_duplicates(cuda):
    """Padding entries of the exception list all hit flat index 0 with its
    exact value: the rebuilt plane is exact whatever order they land in."""
    cup = torch.full((3, 4, 64), 100, dtype=torch.int8)
    idx = torch.zeros(64, dtype=torch.int32)
    val = torch.full((64,), -300, dtype=torch.int32)
    idx[1], val[1] = 5, 250
    d = K.unpack_i8(cup.to(cuda), idx.to(cuda), val.to(cuda)).cpu().view(-1)
    assert d[0].item() == -300 and d[5].item() == 250 and d[1].item() == 100


def test_wrappers_refuse_mixed_devices(cuda):
    q, aux, w = _inputs(2, 3)
    with pytest.raises(ValueError):
        K.reconstruct_dct8_srgb(q.to(cuda), aux, w.to(cuda),
                                _consts22(255.0).to(cuda), 2, 3)


CS = (40.0, 5.0, 3.5)
GAB_W = ((0.115, 0.061), (0.1, 0.05), (0.12, 0.06))


def _skipped_blocks(rs8: np.ndarray) -> torch.Tensor:
    """The block sigmas with the middle block skipped and, where the table
    holds it, block (3, 7) too: its rows 24-31 hold the edge between B7's
    first two walks down a strip (after 25, 27 or 29 rows by step kind), its
    columns 56-63 the edge between the first two 60-column strips."""
    rs8.flat[rs8.size // 2] = -1.0
    if rs8.shape[0] > 3 and rs8.shape[1] > 7:
        rs8[3, 7] = -1.0
    return torch.from_numpy(rs8)


# B7 walks 60-column strips (64 with the halo), 25-29 rows a warp: planes
# smaller than a strip and than the halo (5x3, 9x3, 2x17, 8x2), rows that
# are not 16-byte aligned (W = 3, 61, 113, 1021: the 4-byte copies), rows
# that are (16-byte copies on interior strips: 256x2048, 384x4096), two
# strips and two 12-tap walks that fill the plane exactly (50x120), and
# walks of many warps down a tall plane (1023x1021, 384x4096)
@pytest.mark.parametrize("h,w", [(5, 3), (37, 61), (48, 64), (16, 8), (200, 72), (1023, 1021),
                                 (256, 2048), (9, 3), (2, 17), (8, 2), (64, 112), (65, 113),
                                 (130, 70), (384, 4096), (50, 120)])
def test_filter_kernels_vs_plain(cuda, h, w):
    """B7 (each step kind), B8 (1-3 steps, 8-multiple planes) and B9 against
    their plain versions, with skipped blocks."""
    rng = np.random.default_rng(h * w)
    ch = torch.from_numpy(rng.normal(size=(3, h, w)).astype(np.float32) * 50)
    rs8 = _skipped_blocks(
        np.abs(rng.normal(size=(-(-h // 8), -(-w // 8)))).astype(np.float32) * 0.05 + 0.02)
    g, r = ch.to(cuda), rs8.to(cuda)
    K.reset_launches()
    got = FK.gaborish(g, GAB_W)
    assert (got.cpu() - FK.gaborish_ref(ch, GAB_W)).abs().max().item() <= 2e-3
    for kind, ss in ((0, 0.9), (1, 1.0), (2, 6.5)):
        got = FK.epf_step(g, r, ss, kind, CS, 2.78)
        ref = FK.epf_step_ref(ch, rs8, ss, kind, CS, 2.78)
        assert (got.cpu() - ref).abs().max().item() <= 2e-3
    want = {"gaborish": 1, "epf_step": 3, "epf_fused": 0}
    if h % 8 == 0 and w % 8 == 0:
        for iters in (1, 2, 3):
            steps = FK.frame_steps(iters, 0.9, 6.5)
            got = FK.epf_fused(g, r, steps, CS, 2.78)
            ref = FK.epf_fused_ref(ch, rs8, steps, CS, 2.78)
            assert (got.cpu() - ref).abs().max().item() <= 2e-3
        want["epf_fused"] = 3
    torch.cuda.synchronize()
    assert {k: K.launches[k] for k in want} == want


@pytest.mark.parametrize("h,w", [(8, 2), (8, 3), (16, 61), (48, 64), (200, 72), (384, 4096),
                                 (16, 3), (40, 29), (72, 112), (136, 1021)])
def test_rows_filter_kernels_vs_plain(cuda, h, w):
    """B7's and B9's rows entries (a row shard's stripe with its
    neighbours' halo rows) against their plain versions, each step kind,
    with skipped blocks."""
    rng = np.random.default_rng(h + w)
    rows = torch.from_numpy(rng.normal(size=(3, h + 6, w)).astype(np.float32) * 50)
    rs8 = _skipped_blocks(
        np.abs(rng.normal(size=(-(-h // 8), -(-w // 8)))).astype(np.float32) * 0.05 + 0.02)
    g, r = rows.to(cuda), rs8.to(cuda)
    K.reset_launches()
    gab = rows[:, 2:-2].contiguous()
    got = FK.gaborish_rows(gab.to(cuda), GAB_W)
    assert got.shape == (3, h, w)
    assert (got.cpu() - FK.gaborish_rows_ref(gab, GAB_W)).abs().max().item() <= 2e-3
    for kind, ss in ((0, 0.9), (1, 1.0), (2, 6.5)):
        got = FK.epf_step_rows(g, r, ss, kind, CS, 2.78)
        ref = FK.epf_step_rows_ref(rows, rs8, ss, kind, CS, 2.78)
        assert got.shape == (3, h, w)
        assert (got.cpu() - ref).abs().max().item() <= 2e-3
    torch.cuda.synchronize()
    assert {k: K.launches[k] for k in ("gaborish_rows", "epf_step_rows")} == {
        "gaborish_rows": 1, "epf_step_rows": 3}


def test_sharded_decode_on_card(cuda):
    """decode_sharded on Mesh([cuda:0] * 8), filtered and ragged (8 row
    shards exchanging halos on one card), against a 1-shard mesh and
    against Mesh([cpu] * 8) (the plain versions); B2, B9 rows, B7 rows
    and B3 once a shard (B7 rows once a shard and step)."""
    from j40_tpu_torch.parallel.mesh import Mesh
    from j40_tpu_torch.parallel.sharded_decode import decode_sharded

    img = _noise(np.random.default_rng(11), 253, 192)
    data = encode_vardct(img, VarDCTOptions(sharpness=5, custom_restoration=True,
                                            epf_iters=3))
    K.reset_launches()
    got = decode_sharded(data, mesh=Mesh([cuda] * 8, ("rows",)), apply_filters=True)
    torch.cuda.synchronize()
    assert {k: v for k, v in K.launches.items() if v} == {
        "reconstruct_dct8": 8, "gaborish_rows": 8, "epf_step_rows": 24, "xyb_to_srgb": 8}
    one = decode_sharded(data, mesh=Mesh([cuda], ("rows",)), apply_filters=True)
    cpu = decode_sharded(data, mesh=Mesh(["cpu"] * 8, ("rows",)), apply_filters=True)
    assert got.shape == (253, 192, 3)
    assert np.abs(got.astype(np.int64) - one).max() <= 1
    assert np.abs(got.astype(np.int64) - cpu).max() <= 1


def _noise(rng, h, w):
    return (np.cumsum(np.cumsum(rng.integers(-2, 3, size=(h, w, 3)), 0), 1)
            % 200 + 20).astype(np.uint8)


def _mixed():
    img = _noise(np.random.default_rng(7), 200, 2300)  # two LF groups
    img[:64, :256] = img[3, 3]
    return encode_vardct_mixed(img)


def _bpp12():
    rng = np.random.default_rng(5)
    img = (np.cumsum(np.cumsum(rng.integers(-20, 21, (96, 112, 3)), 0), 1)
           % 3800 + 100).astype(np.uint16)
    return encode_vardct(img, VarDCTOptions(bpp=12))


@pytest.mark.parametrize("make,want", [
    (lambda: encode_vardct(_noise(np.random.default_rng(1), 77, 61)),
     {"reconstruct_dct8_srgb"}),
    (_mixed, {"reconstruct_dct8_srgb", "reconstruct_dct8", "xyb_to_srgb"}),
    (_bpp12, {"reconstruct_dct8_srgb"}),
], ids=["dct8_ragged", "mixed_two_lf_groups", "dct8_12bit"])
def test_decode_on_card_vs_cpu(cuda, make, want):
    data = make()
    outs = []
    for dev in ("cuda", "cpu"):
        K.reset_launches()
        dec = Decoder(data, device=dev, workers=4)
        dec.decode_frame()
        launched = {k for k, v in K.launches.items() if v}
        assert launched == (want if dev == "cuda" else set()), K.launches
        outs.append(np.stack([np.asarray(c, np.int64) for c in dec.frame.canvas[:3]]))
    assert np.abs(outs[0] - outs[1]).max() <= 1


def test_filtered_decode_on_card_vs_cpu(cuda):
    """Decoder(apply_filters=True): B2 -> B9 -> B8 -> B3 on the card, held
    against device="cpu" (the plain versions)."""
    img = _noise(np.random.default_rng(3), 200, 2300)  # two LF groups
    data = encode_vardct(img, VarDCTOptions(sharpness=5, custom_restoration=True,
                                            epf_iters=3))
    outs = []
    for dev in ("cuda", "cpu"):
        K.reset_launches()
        dec = Decoder(data, device=dev, workers=4, apply_filters=True)
        dec.decode_frame()
        launched = {k for k, v in K.launches.items() if v}
        assert launched == ({"reconstruct_dct8", "gaborish", "epf_fused", "xyb_to_srgb"}
                            if dev == "cuda" else set()), K.launches
        outs.append(dec.render_rgba8().astype(np.int64))
    assert np.abs(outs[0] - outs[1]).max() <= 1


def _photo(h, w, seed):
    """A smooth photo-like image with some grain: lanes of a few thousand
    symbols at most, short enough for the plain versions on the CPU."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    return np.stack([
        96 + 60 * np.sin(xx / 29) * np.cos(yy / 23) + 10 * np.sin(xx / (9 + 2 * c))
        + rng.normal(0, 0.7, (h, w)) for c in range(3)], -1).clip(0, 255).astype(np.uint8)


HF_STREAMS = {
    "prefix": dict(),
    "ans": dict(use_prefix=False),
    "ctx": dict(use_prefix=False, coeff_clusters=5),
}


def _hf_plan(name):
    """The device route's lanes of a three-section stream: (vardct state,
    spec, ctx_mode, lanes, orders_yxb), as ops/device_vardct.py plans them."""
    from j40_tpu_torch.ops import device_vardct as DV

    data = encode_vardct(_photo(24, 600, 3), VarDCTOptions(**HF_STREAMS[name]))
    dec = Decoder(data, device="cpu", max_passes=0)
    dec.decode_frame(_defer_finish=True)
    f, toc, state = dec._deferred
    plan = DV.hf_lanes(dec, state, f, [s for s in toc.sections if s.pass_ == 0])
    assert plan is not None and len(plan[2]) == 3 and plan[1] == (name == "ctx")
    return (state.vardct, *plan)


@pytest.mark.parametrize("name", list(HF_STREAMS))
def test_hf_kernels_vs_plain(cuda, name):
    """B4 (prefix, ANS) and B5 against their plain versions: a capped walk,
    its resumption from the snapshot and an uncapped walk give the same
    planes and snapshots, exactly (integer state, integer coefficients)."""
    from j40_tpu_torch.ops import device_vardct as DV

    vd, spec, ctx, lanes, orders = _hf_plan(name)
    ncmax = max(ln.gw8 * ln.gh8 for ln in lanes)
    results = []
    for dev in ("cuda", "cpu"):
        _, launch, done_row = DV.pack_hf_batch(vd, spec, lanes, orders, ctx, dev)
        K.reset_launches()
        out, st = launch(ncmax, cap_steps=300)
        capped = (out.clone(), st)
        resumed = launch(ncmax, cap_steps=300, init=st, out=out)
        full = launch(ncmax)
        torch.cuda.synchronize()
        assert K.launches["hf_ctx" if ctx else "hf"] == (3 if dev == "cuda" else 0)
        results.append([t.cpu() for t in (*capped, *resumed, *full)])
    for a, b in zip(*results):
        assert torch.equal(a, b)
    st = results[0][-1]
    assert not st[done_row][:3].eq(0).any() and not st[6].any()
    assert not results[0][1][done_row].all()  # the cap did stop the walk


@pytest.mark.parametrize("name", list(HF_STREAMS))
def test_device_route_on_card_vs_cpu(cuda, name):
    """Decoder(backend="device"): B4 or B5, then B1 on the resident LF
    group, on the card; the same RGBA as device="cpu" and as
    backend="torch" on the card."""
    data = encode_vardct(_photo(24, 600, 5), VarDCTOptions(**HF_STREAMS[name]))
    outs = []
    for backend, dev in (("device", "cuda"), ("device", "cpu"), ("torch", "cuda")):
        K.reset_launches()
        dec = Decoder(data, backend=backend, device=dev, workers=4)
        dec.decode_frame()
        launched = {k for k, v in K.launches.items() if v}
        want = {"reconstruct_dct8_srgb"}
        if backend == "device":
            want.add("hf_ctx" if name == "ctx" else "hf")
            assert dec.stats["device_vardct"]["lanes"] == 3
        assert launched == (want if dev == "cuda" else set()), K.launches
        outs.append(dec.render_rgba8())
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0], outs[2])


def _lossless(h, w, seed=7):
    rng = np.random.default_rng(seed)
    return (np.cumsum(np.cumsum(rng.integers(-2, 3, size=(h, w, 3)), 0), 1)
            % 256).astype(np.uint8)


#: 9-node static-property tree of tests/test_device_modular.py:133-143
def _static_tree():
    from j40_tpu_torch.encode.modular_enc import branch, leaf

    return [branch(0, 0, 1, 2), branch(3, 60, 3, 4), branch(2, 10, 5, 6), leaf(5),
            leaf(1), leaf(2), branch(1, 25, 7, 8), leaf(0), leaf(5, offset=3)]


def _modular(name):
    """Small lossless streams of 128-pixel groups, one per token mode and
    lane kind: local trees give each lane its own table row, global trees
    one shared row; static trees per-token clusters; the e3 tree the
    in-wavefront walk."""
    from j40_tpu_torch.encode.advanced import AdvancedOptions, encode_modular_advanced
    from j40_tpu_torch.encode.encoder import EncodeOptions, encode_modular
    from j40_tpu_torch.encode.modular_enc import branch, leaf

    img = _lossless(16, 136)
    kw = dict(group_size_shift=7)
    if name.startswith("plain"):
        return encode_modular(img, options=EncodeOptions(
            use_prefix="prefix" in name, global_tree="global" in name, **kw))
    tree = {"static": _static_tree(), "e3": [branch(15, 0, 1, 2), leaf(6), leaf(5)],
            "wp": [leaf(6)]}[name.split("_")[0]]
    return encode_modular_advanced(img, options=AdvancedOptions(
        tree=tree, use_prefix="prefix" in name, global_tree="global" in name,
        complex_cluster_map=name.startswith("static"), **kw))


MODULAR = ["plain_prefix_local", "plain_ans_local", "plain_prefix_global",
           "plain_ans_global", "static_prefix", "static_ans", "e3_ans_global",
           "wp_prefix"]


def _lane_batches(data):
    """The device route's lane batches of a stream, as
    ops/device_modular.try_device_pass_groups groups them."""
    from j40_tpu_torch.ops import device_modular as DM

    dec = Decoder(data, backend="numpy", max_passes=0)
    dec.decode_frame(_defer_finish=True)
    f, toc, state = dec._deferred
    lanes = DM.plan_lanes(dec, state, [s for s in toc.sections if s.pass_ == 0])
    kinds = {}
    for ln in lanes:
        kind = "ctx" if ln.ctx is not None else "ntree" if ln.ntree is not None else "plain"
        kinds.setdefault((ln.spec.use_prefix_code, kind), []).append(ln)
    return list(kinds.values())


@pytest.mark.parametrize("name", MODULAR)
def test_token_kernel_vs_plain(cuda, name):
    """The token kernel (B6) against its plain version, on the card and on
    the CPU, from the same packed inputs: shared rows (global trees),
    per-lane rows (local trees) and per-token clusters (static trees),
    prefix and rANS; uncapped, and capped below the lanes' counts."""
    from j40_tpu_torch.ops import device_modular as DM
    from j40_tpu_torch.ops import token_kernels as TKN
    from j40_tpu_torch.ops.hf_kernels import to_device

    batches = _lane_batches(_modular(name))
    assert batches
    for lanes in batches:
        packed = DM.pack_lanes(lanes)
        if "global" in name:
            assert packed["sym"].shape[0] == 1
        cap = min(ln.nsym for ln in lanes) // 2
        for n_steps in (None, cap):
            K.reset_launches()
            d = to_device(packed, cuda)
            got = TKN.launch_tokens(d, n_steps)
            plain = TKN.launch_tokens(d, n_steps, decode=TKN.decode_tokens_ref)
            cpu = TKN.launch_tokens(to_device(packed, "cpu"), n_steps)
            torch.cuda.synchronize()
            assert K.launches["tokens"] == 1
            for a, b, c in zip(got, plain, cpu):
                assert torch.equal(a.cpu(), b.cpu()) and torch.equal(a.cpu(), c)


#: the wavefront kernels' launch counters (ops/wavefront_kernels.py)
WAVEFRONTS = ("wavefront", "wavefront_mixed", "wavefront_wp", "wavefront_wp_codes",
              "wavefront_tree")


@pytest.mark.parametrize("name", MODULAR)
def test_modular_device_route_on_card_vs_cpu(cuda, name):
    """Decoder(backend="device") on a Modular stream: the token kernel and
    the wavefront kernels on the card give device="cpu"'s RGBA and the
    host plan's, bit for bit, with every eligible section on the card and
    one wavefront launch a (class, kernel): the slots of a class that share
    a shape and a kernel go as one batch of planes (`wavefronts`, against
    `reconstructions`, one a (class, slot); a static tree's slot whose
    predictor is 0, 1 or 2 everywhere takes a cumsum)."""
    from test_torch_modular_fused import _counts

    data = _modular(name)
    lanes = sum(len(b) for b in _lane_batches(data))
    recon, launches = _counts(data)
    _, host = _decode_rgba(data, backend="numpy")
    for dev in ("cuda", "cpu"):
        K.reset_launches()
        dec, rgba = _decode_rgba(data, backend="device", device=dev, workers=4)
        assert K.launches["tokens"] == (len(_lane_batches(data)) if dev == "cuda" else 0)
        dm = dec.stats["device_modular"]
        assert dm.get("lanes", 0) + dm.get("ctx_lanes", 0) + dm.get("ntree_lanes", 0) == lanes
        waves = sum(K.launches[k] for k in WAVEFRONTS)
        assert (dm["reconstructions"], dm["wavefronts"]) == (recon, launches)
        assert 0 < launches < recon
        assert waves == (dm["wavefronts"] if dev == "cuda" else 0)
        if not name.startswith("static"):
            assert 3 * dm["wavefronts"] == dm["reconstructions"]
        np.testing.assert_array_equal(rgba, host)


# ------------------------------------------------ the wavefronts (W1-W3)

#: (L, H, W): the design test's shapes (tests/test_torch_wavefront_design.py),
#: planes taller than a CTA's rows (W1 1024, W1 with codes and W2 512: a
#: warp walks 2 or 3 bands), a Modular group of 1024 rows, odd widths, the
#: main path's 16 lanes of 256x256 and the fused launch's 48 (3 slots of
#: 16 lanes)
WF_SHAPES = [(3, 13, 17), (2, 1, 9), (2, 7, 1), (2, 9, 2), (2, 70, 6), (2, 1100, 3),
             (2, 600, 4), (1, 1024, 1024), (3, 77, 255), (16, 256, 256), (48, 256, 256)]


def _wf_case(L, H, W, seed=0):
    from test_torch_wavefront_design import _res

    rng = np.random.default_rng(seed + H * 7 + W)
    res = torch.from_numpy(_res(seed + H + W, (L, H, W)))
    codes = torch.from_numpy(rng.integers(-2, 15, size=(L, H, W)).astype(np.int32))
    return res, codes


def _same_wf(got, want, name):
    torch.cuda.synchronize()
    assert K.launches[name] == 1, K.launches
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for a, b in zip(got, want):
        assert a.device.type == "cuda" and a.dtype == b.dtype
        assert torch.equal(a.cpu(), b.cpu())


@pytest.mark.parametrize("mode", ["gradient", "mixed"])
@pytest.mark.parametrize("L,H,W", WF_SHAPES)
def test_wavefront_w1_vs_plain(cuda, mode, L, H, W):
    """W1 (plain_wavefront): the gradient, and per-pixel codes (outside
    0-2 the gradient), equal to the plain version on the CPU."""
    from j40_tpu_torch.ops import wavefront_kernels as WK

    res, codes = _wf_case(L, H, W)
    codes = codes if mode == "mixed" else None
    K.reset_launches()
    got = WK.plain_wavefront(res.to(cuda), None if codes is None else codes.to(cuda), H, W)
    _same_wf(got, WK.plain_wavefront(res, codes, H, W),
             "wavefront" if codes is None else "wavefront_mixed")


@pytest.mark.parametrize("params", ["default", "custom"])
@pytest.mark.parametrize("mode", ["wp", "codes"])
@pytest.mark.parametrize("L,H,W", WF_SHAPES)
def test_wavefront_w2_vs_plain(cuda, params, mode, L, H, W):
    """W2 (wp_wavefront): WP alone, and per-pixel codes -2..14 (outside
    0-12 predict 0); planes and overflow flags equal to the plain
    version's."""
    from test_torch_wavefront_design import PARAMS

    from j40_tpu_torch.ops import wavefront_kernels as WK

    res, codes = _wf_case(L, H, W, 1)
    codes = codes if mode == "codes" else None
    p = PARAMS[params]
    K.reset_launches()
    got = WK.wp_wavefront(res.to(cuda), None if codes is None else codes.to(cuda), H, W, p)
    _same_wf(got, WK.wp_wavefront(res, codes, H, W, p),
             "wavefront_wp" if codes is None else "wavefront_wp_codes")


def _big_tree(branches: int, seed: int):
    """A complete binary tree of `branches` branches over properties 0-15,
    leaves with codes 0-13, offsets and multipliers: 2 * branches + 1
    nodes."""
    rng = np.random.default_rng(seed)
    return tuple(
        (int(rng.integers(0, 16)), int(rng.integers(-20, 20)), 2 * i + 1, 2 * i + 2, 0, 0, 0)
        if i < branches else
        (-1, 0, 0, 0, int(rng.integers(0, 14)), int(rng.integers(-3, 4)),
         int(rng.integers(-2, 4)))
        for i in range(2 * branches + 1))


@pytest.mark.parametrize("tree", ["e3", "offsets", "deep", "big"])
@pytest.mark.parametrize("L,H,W", [WF_SHAPES[0], WF_SHAPES[1], WF_SHAPES[3], WF_SHAPES[6],
                                   WF_SHAPES[8], WF_SHAPES[-2], WF_SHAPES[-1]])
def test_wavefront_w3_vs_plain(cuda, tree, L, H, W):
    """W3 (tree_wavefront): the MA-tree walk in the step, on the design
    test's trees and a 6001-node tree (96 KB of shared memory)."""
    from test_torch_wavefront_design import PARAMS, TREES

    from j40_tpu_torch.ops import wavefront_kernels as WK

    res, _ = _wf_case(L, H, W, 2)
    key = _big_tree(3000, 5) if tree == "big" else TREES[tree]
    p = PARAMS["custom" if tree == "offsets" else "default"]
    sidx = torch.arange(30, 30 + L, dtype=torch.int32)
    cidx = torch.arange(L, dtype=torch.int32) % 3  # a channel a plane, as the route sends
    K.reset_launches()
    got = WK.tree_wavefront(res.to(cuda), key, cidx.to(cuda), sidx.to(cuda), H, W, p)
    _same_wf(got, WK.tree_wavefront(res, key, cidx, sidx, H, W, p), "wavefront_tree")


@pytest.mark.parametrize("mode", ["wp", "codes", "tree"])
def test_wavefront_overflow_flags(cuda, mode):
    """Lanes whose WP error state passes 2^24 are flagged as the plain
    version flags them, and run to their end in range; the others stay
    exact."""
    from test_torch_wavefront_design import PARAMS, TREES

    from j40_tpu_torch.ops import wavefront_kernels as WK

    rng = np.random.default_rng(3)
    res = np.zeros((4, 8, 40), np.int32)
    res[0, :, ::2], res[0, :, 1::2] = 2 ** 28, -2 ** 28
    res[2] = rng.choice([-2 ** 30, -1, 0, 1, 2 ** 30], size=(8, 40))
    res[3] = rng.integers(-30000, 30001, size=(8, 40))
    res = torch.from_numpy(res)
    codes = torch.from_numpy(rng.integers(0, 13, size=(4, 8, 40)).astype(np.int32))
    p = PARAMS["default"]
    K.reset_launches()
    if mode == "tree":
        sidx = torch.arange(4, dtype=torch.int32)
        got = WK.tree_wavefront(res.to(cuda), TREES["deep"], 1, sidx.to(cuda), 8, 40, p)
        want = WK.tree_wavefront(res, TREES["deep"], 1, sidx, 8, 40, p)
    else:
        c = codes if mode == "codes" else None
        got = WK.wp_wavefront(res.to(cuda), None if c is None else c.to(cuda), 8, 40, p)
        want = WK.wp_wavefront(res, c, 8, 40, p)
    _same_wf(got, want, {"wp": "wavefront_wp", "codes": "wavefront_wp_codes",
                         "tree": "wavefront_tree"}[mode])
    assert want[1][0] and not want[1][1]


def test_wavefront_wrappers_refuse(cuda):
    """A mix of devices, a wrong dtype, a tree the kernel cannot walk and a
    tree larger than shared memory raise; nothing falls back to the torch
    ops.  A tree of as many nodes as the library reports it holds runs and
    equals the plain version."""
    from test_torch_wavefront_design import PARAMS

    from j40_tpu_torch.ops import wavefront_kernels as WK

    res, codes = _wf_case(2, 9, 11)
    with pytest.raises(ValueError):
        WK.plain_wavefront(res.to(cuda), codes, 9, 11)
    with pytest.raises(ValueError):
        WK.wp_wavefront(res.to(cuda).float(), None, 9, 11, PARAMS["default"])
    with pytest.raises(ValueError):
        WK.tree_wavefront(res.to(cuda), ((16, 0, 1, 2, 0, 0, 0), (-1, 0, 0, 0, 5, 0, 1),
                                         (-1, 0, 0, 0, 1, 0, 1)), 0, [0, 1], 9, 11,
                          PARAMS["default"])
    most = WK.limits()["tree_nodes"]
    big = _big_tree(most // 2, 7)
    assert len(big) > most
    K.reset_launches()
    with pytest.raises(ValueError, match="shared memory"):
        WK.tree_wavefront(res.to(cuda), big, 0, [0, 1], 9, 11, PARAMS["default"])
    assert K.launches["wavefront_tree"] == 0
    full = _big_tree((most - 1) // 2, 7)
    assert len(full) in (most - 1, most)
    sidx = torch.tensor([0, 1], dtype=torch.int32)
    got = WK.tree_wavefront(res.to(cuda), full, 0, sidx.to(cuda), 9, 11, PARAMS["default"])
    _same_wf(got, WK.tree_wavefront(res, full, 0, sidx, 9, 11, PARAMS["default"]),
             "wavefront_tree")


@pytest.mark.parametrize("kernel", ["plain", "mixed", "wp", "codes", "tree"])
def test_wavefront_planes_at_the_ring_limit(cuda, kernel):
    """A plane taller than a CTA's rows (a warp walks two bands) as wide as
    its hand-off rings keep deadlock-free runs and equals the plain
    version; one column more is refused with ValueError, before any launch
    (a Modular group is at most 1024 on a side).  The library's limits are
    the design test's model: its rows a CTA, chunks and rings, and the
    widths its model of the hand-off shows deadlock-free."""
    import test_torch_wavefront_design as D
    from test_torch_wavefront_design import PARAMS, TREES

    from j40_tpu_torch.ops import wavefront_kernels as WK

    lim = WK.limits()
    model = dict(
        plain_chunk=D.PLAIN_CHUNK, plain_ring=D.PLAIN_RING, wp_chunk=D.WP_CHUNK,
        wp_ring=D.WP_RING, **{f"threads_{t}": n for t, n in D.THREADS.items()},
        **{f"tall_width_{t}": D.tall_width_limit(1, 0, D.THREADS[t] // 32, D.PLAIN_RING,
                                                 D.PLAIN_CHUNK) for t in ("plain", "mixed")},
        tall_width_wp=D.tall_width_limit(2, 1, D.THREADS["wp"] // 32, D.WP_RING, D.WP_CHUNK))
    assert {k: lim[k] for k in model} == model
    kind = {"plain": "plain", "mixed": "mixed"}.get(kernel, "wp")
    rows, most = lim[f"threads_{kind}"], lim[f"tall_width_{kind}"]
    p = PARAMS["default"]
    H = rows + 1

    def call(res, W):
        codes = torch.from_numpy(np.random.default_rng(W).integers(
            0, 13, size=(1, H, W)).astype(np.int32)).to(res.device)
        if kernel in ("plain", "mixed"):
            return WK.plain_wavefront(res, codes if kernel == "mixed" else None, H, W)
        if kernel == "tree":
            sidx = torch.zeros(1, dtype=torch.int32, device=res.device)
            return WK.tree_wavefront(res, TREES["e3"], 0, sidx, H, W, p)
        return WK.wp_wavefront(res, codes if kernel == "codes" else None, H, W, p)

    res, _ = _wf_case(1, H, most, 4)
    name = {"plain": "wavefront", "mixed": "wavefront_mixed", "wp": "wavefront_wp",
            "codes": "wavefront_wp_codes", "tree": "wavefront_tree"}[kernel]
    K.reset_launches()
    _same_wf(call(res.to(cuda), most), call(res, most), name)
    K.reset_launches()
    with pytest.raises(ValueError, match="deadlock-free"):
        call(torch.zeros((1, H, most + 1), dtype=torch.int32, device=cuda), most + 1)
    assert K.launches[name] == 0


def _decode_rgba(data, **kw):
    dec = Decoder(data, **kw)
    dec.decode_frame()
    return dec, dec.render_rgba8()


def test_token_kernel_rows_past_shared_memory(cuda):
    """A table row larger than a block's shared memory (two clusters of a
    15-bit prefix code: 2 x 2^15 entries, 256 KB) is read from global
    memory: the kernel still equals its plain version."""
    from j40_tpu_torch.encode.bitwriter import BitWriter
    from j40_tpu_torch.encode.entropy import EntropyEncoder
    from j40_tpu_torch.entropy.code import read_code_spec
    from j40_tpu_torch.io.bits import BitReader
    from j40_tpu_torch.ops import token_kernels as TKN
    from j40_tpu_torch.ops.hf_kernels import to_device

    fib = [1, 1]
    while len(fib) < 20:
        fib.append(fib[-1] + fib[-2])
    rng = np.random.default_rng(4)
    deep = np.concatenate([np.full(c, i) for i, c in enumerate(fib)])
    rng.shuffle(deep)  # a 15-bit-deep prefix code in cluster 0
    vals = np.concatenate([deep, rng.integers(0, 300, size=4000)])
    ctxs = np.concatenate([np.zeros(len(deep), np.int64), np.ones(4000, np.int64)])
    order = rng.permutation(len(vals))
    vals, ctxs = vals[order], ctxs[order]
    enc = EntropyEncoder(2, use_prefix=True, cluster_map=[0, 1])
    enc.add_arrays(ctxs, vals)
    w = BitWriter()
    enc.write(w)
    data = w.finish()
    r = BitReader(data)
    spec = read_code_spec(r, 2)
    assert max(cl.prefix.max_len for cl in spec.clusters) == 15
    packed = TKN.build_lane_inputs([(data, r.bits_consumed)], [len(vals)], [spec],
                                   cids=[np.asarray(spec.cluster_map)[ctxs]])
    assert packed["sym"].nbytes > 227 * 1024
    K.reset_launches()
    got = TKN.launch_tokens(to_device(packed, cuda))
    want = TKN.launch_tokens(to_device(packed, "cpu"))
    torch.cuda.synchronize()
    assert K.launches["tokens"] == 1
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    np.testing.assert_array_equal(got[0].cpu().numpy()[0], vals)


@pytest.mark.parametrize("name", ["never_in_step", "single_zero_bits", "single_extra_bits",
                                  "short", "ragged", "zero_runs"])
def test_token_kernel_sync_cases(cuda, name):
    """B6's self-synchronising design on the adversarial lanes of
    tests/test_torch_sync_decode.py (a code that never falls into step,
    single-symbol codes with and without extra bits, lanes shorter than a
    subsequence, lanes of very different lengths, runs of the all-zero
    codeword), uncapped and capped inside a subsequence, with the section
    lengths and without: equal to the plain version, with the chase
    statistics of the numpy model."""
    from test_torch_sync_decode import check_tokens, token_case

    from j40_tpu_torch.ops import token_kernels as TKN
    from j40_tpu_torch.ops.hf_kernels import to_device

    d = token_case(name)
    assert TKN.design(d["use_prefix"], d["cids"] is not None) == "sync"
    for packed in (d, dict(d, nbits=None)):
        stats: dict = {}
        for n_steps in (None, 1, 40, 257):
            K.reset_launches()
            got = TKN.launch_tokens(to_device(packed, cuda), n_steps,
                                    stats_out=stats if n_steps is None else None)
            want = TKN.launch_tokens(to_device(packed, "cpu"), n_steps)
            torch.cuda.synchronize()
            assert K.launches["tokens"] == 1
            for a, b in zip(got, want):
                assert torch.equal(a.cpu(), b)
        model = check_tokens(packed)  # uncapped
        assert stats["sync"].cpu().tolist() == [
            [m["rounds"], m["chase"], m["redecoded"], m["subs"]] for m in model]


@pytest.mark.parametrize("name", ["hf_blocks", "hf_count_above_63", "hf_overrun",
                                  "hf_ans_blocks", "hf_ans_count_above_63", "hf_ans_overrun"])
def test_hf_kernel_sync_cases(cuda, name):
    """B4's prefix design (the parallel decode, then the structure pass) and
    its rANS design (a decoding thread, a walking warp and the ring between
    them, which the first lane's values overrun) on synthetic sections:
    uncapped, capped inside a block, resumed from a mid-lane snapshot, a
    count above 63 and an overrun; planes and snapshots equal to the plain
    version's (`ii` where `err` is 0)."""
    from test_torch_sync_decode import hf_ans_case, hf_case, same_snapshot

    from j40_tpu_torch.ops import hf_kernels as HK

    d = (hf_ans_case if "ans" in name else hf_case)(name)
    assert HK.design(d["use_prefix"]) == ("serial" if "ans" in name else "sync")
    ncmax = max(d["ncells_all"])
    results = []
    for dev in (cuda, "cpu"):
        t = HK.to_device(d, dev)
        runs = [HK.launch_hf(t, ncmax)]
        for cap in (1, 37, 200):
            out, st = HK.launch_hf(t, ncmax, cap_steps=cap)
            runs += [(out.clone(), st), HK.launch_hf(t, ncmax, init=st, out=out)]
        torch.cuda.synchronize()
        results.append([x.cpu() for run in runs for x in run])
    for a, b in zip(*results):
        if a.shape == (HK.ST_ROWS, d["L"]):  # a snapshot: ii where err is 0
            assert all(same_snapshot(a[:, l], b[:, l]) for l in range(d["L"]))
        else:
            assert torch.equal(a, b)
    assert bool(results[0][1][6, 0]) == (not name.endswith("blocks"))


@pytest.mark.parametrize("h,w", [(8, 8), (16, 16), (8, 40), (24, 24), (40, 40), (72, 56),
                                 (200, 72), (128, 264)])
def test_epf_fused_tiles(cuda, h, w):
    """B8's regrouped step on planes of 8 and 16 rows and columns, one
    32-pixel tile +- 8, and planes that are not a multiple of the tile, for
    1-3 steps with skipped blocks (every fourth, and the corner ones); the
    same planes at XYB scale within 1e-5."""
    for scale, atol in ((50.0, 2e-3), (0.1, 1e-5)):
        rng = np.random.default_rng(h * w)
        ch = torch.from_numpy(rng.normal(size=(3, h, w)).astype(np.float32) * scale)
        rs8 = (np.abs(rng.normal(size=(h // 8, w // 8))) * 2.5 / scale
               + 0.02).astype(np.float32)
        rs8.flat[::4] = -1.0
        rs8[-1, -1] = -1.0
        rs8 = torch.from_numpy(rs8)
        for iters in (1, 2, 3):
            steps = FK.frame_steps(iters, 0.9, 6.5)
            K.reset_launches()
            got = FK.epf_fused(ch.to(cuda), rs8.to(cuda), steps, CS, 2.78)
            torch.cuda.synchronize()
            assert K.launches["epf_fused"] == 1
            ref = FK.epf_fused_ref(ch, rs8, steps, CS, 2.78)
            assert (got.cpu() - ref).abs().max().item() <= atol, (scale, iters)


@pytest.mark.parametrize("name", ["ctx_blocks", "ctx_count_above_63", "ctx_overrun",
                                  "ctx_clusters16"])
def test_hf_ctx_kernel_chain_cases(cuda, name):
    """B5's lookahead design on the synthetic sections of
    tests/test_torch_hf_ctx_chain.py (a lane longer than the value ring, a
    count above 63, an overrun, 16 clusters: more than one table per
    cluster and state slot would fit in shared memory): uncapped, capped
    right after a nonzero count, a coefficient, a block's end inside a cell
    and a cell's end on lane 0 and at the corrupt lane's fault, each resumed
    from its snapshot; planes and snapshots equal to the plain version's
    (`ii` where `err` is 0)."""
    from test_torch_hf_ctx_chain import ctx_case, model_walk, same_snapshot

    from j40_tpu_torch.ops import hf_kernels as HK

    d = ctx_case(name)
    _, values, events = model_walk(d, 0, 10**6, d["init"][:, 0])
    caps = [None, len(values) - 1, len(values), len(values) + 1]
    caps += [next(i + 1 for i, e in enumerate(events) if e == kind and i > 30)
             for kind in ("count", "coef", "channel", "cell")]
    results = []
    for dev in (cuda, "cpu"):
        t = HK.to_device(d, dev)
        runs = []
        for cap in caps:
            K.reset_launches()
            out, st = HK.launch_hf_ctx(t, d["ncmax"], d["nb"], cap_steps=cap)
            runs += [(out.clone(), st), HK.launch_hf_ctx(t, d["ncmax"], d["nb"], init=st,
                                                         out=out)]
            torch.cuda.synchronize()
            assert K.launches["hf_ctx"] == (2 if dev == cuda else 0)
        results.append([x.cpu() for run in runs for x in run])
    for a, b in zip(*results):
        if a.shape == (HK.CTX_ST_ROWS, d["L"]):
            assert all(same_snapshot(a[:, l], b[:, l]) for l in range(d["L"]))
        else:
            assert torch.equal(a, b)
    st = results[0][1]
    assert st[HK.CTX_DONE_ROW].all()
    assert bool(st[6, 0]) == (name in ("ctx_count_above_63", "ctx_overrun"))


def _serving(n, seed=5):
    rng = np.random.default_rng(seed)
    return [encode_vardct((np.cumsum(rng.integers(-2, 3, size=(64, 64, 3)), axis=1)
                           % 180 + 30).astype(np.uint8)) for _ in range(n)]


def test_decode_batch_device_on_card_vs_cpu(cuda):
    """decode_batch_device on 5 images in chunks of 2: one B1 launch a
    chunk, a CUDA (B, H, W, 4) uint8 tensor, each image equal to its own
    decode on the card and within 1 level of the device="cpu" batch."""
    from j40_tpu_torch.decode import decode_file
    from j40_tpu_torch.parallel.batch import decode_batch_device

    blobs = _serving(5)
    K.reset_launches()
    out = decode_batch_device(blobs, workers=2, chunk=2, device=cuda)
    torch.cuda.synchronize()
    assert K.launches["reconstruct_dct8_srgb"] == 3, K.launches
    assert out.is_cuda and out.shape == (5, 64, 64, 4) and out.dtype == torch.uint8
    ref = decode_batch_device(blobs, workers=2, chunk=2, fetch=True, device="cpu")
    got = out.cpu().numpy()
    assert np.abs(got.astype(np.int64) - ref).max() <= 1
    for blob, img in zip(blobs, got):
        np.testing.assert_array_equal(img, decode_file(blob, device=cuda)[1])


def test_decode_batch_device_hf_on_card_vs_cpu(cuda):
    """decode_batch_device_hf on three images, each with its own prefix
    code, in one multi-spec B4 call: equal to the pack path on the card,
    within 1 level of the device="cpu" result (the same coefficients; B1
    against its plain version)."""
    from j40_tpu_torch.native.bindings import serialize_spec
    from j40_tpu_torch.parallel.batch import decode_batch_device, decode_batch_device_hf

    blobs = [encode_vardct(_photo(24, 600, s)) for s in (3, 4, 5)]
    specs = set()
    for b in blobs:
        dec = Decoder(b, device="cpu", max_passes=0)
        dec.decode_frame(_defer_finish=True)
        specs.add(serialize_spec(dec._deferred[2].vardct.coeff_codespec[0]).tobytes())
    assert len(specs) == 3
    K.reset_launches()
    st: dict = {}
    out = decode_batch_device_hf(blobs, workers=2, chunk=2, stats_out=st, device=cuda)
    torch.cuda.synchronize()
    assert st["kernel_calls"] == 1 and K.launches["hf"] == 1, (st, K.launches)
    assert K.launches["reconstruct_dct8_srgb"] == 2
    pack = decode_batch_device(blobs, workers=2, chunk=2, device=cuda)
    assert torch.equal(out, pack)
    ref = decode_batch_device_hf(blobs, workers=2, chunk=2, fetch=True, device="cpu")
    assert np.abs(out.cpu().numpy().astype(np.int64) - ref).max() <= 1


@pytest.mark.parametrize("backend", ["torch", "device"])
def test_render_rgba8_device_on_card(cuda, backend):
    """keep_device_output=True: render_rgba8_device assembles the LF groups'
    u8 planes on the card, a CUDA tensor equal to render_rgba8() and within
    1 level of the device="cpu" decode."""
    data = _mixed()
    outs = []
    for dev in (cuda, "cpu"):
        dec = Decoder(data, backend=backend, device=dev, workers=4, keep_device_output=True)
        dec.decode_frame()
        got = dec.render_rgba8_device()
        assert dec.stats["device_output"] == "planes"
        assert got.device.type == torch.device(dev).type and got.dtype == torch.uint8
        np.testing.assert_array_equal(got.cpu().numpy(), dec.render_rgba8())
        outs.append(got.cpu().numpy().astype(np.int64))
    assert np.abs(outs[0] - outs[1]).max() <= 1


# ------------------------------------------- S1: the inverse Squeeze merge

#: (chains, wd, wr): wr = 0, wd == wr (next clamped) and wr + 1 (odd
#: width), one chain, a pair past a 32-pair chunk, and the widest merges of
#: chip_smoke's lossless_sq on a shard of 8 (128 chains of 512 pairs);
#: chains whose last segment is ragged at each segment length (8: 100
#: pairs, 16: 500 pairs with wd = wr + 1, and 1100 pairs: three windows)
SQ_SHAPES = [(1, 1, 0), (6, 1, 1), (6, 2, 1), (1, 9, 8), (7, 17, 16), (33, 33, 32),
             (33, 41, 40), (31, 64, 64), (128, 512, 512), (130, 257, 256), (5, 100, 100),
             (9, 501, 500), (3, 1101, 1100)]


def _merge_views(horizontal, chains, wd, wr, values, seed, device):
    """down and residu of a merge as views into planes 5 samples wider
    (along the merge when horizontal, across the chains when vertical): a
    column shard's layout, a row stride past the view's width."""
    rng = np.random.default_rng(seed)
    lo, hi = (-(1 << 13), 1 << 13) if values == "14bit" else (-(1 << 31), 1 << 31)
    views = []
    for n in (wd, wr):
        shape = (chains, n + 5) if horizontal else (n, chains + 5)
        full = torch.from_numpy(rng.integers(lo, hi, shape, dtype=np.int64).astype(np.int32))
        full = full.to(device)
        views.append(full[:, 2:2 + n] if horizontal else full[:, 2:2 + chains])
    return views


def _squeeze_model():
    """tools/squeeze_model.py: S1's schedule modelled on the CPU."""
    tools = str(Path(__file__).resolve().parents[1] / "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    import squeeze_model

    return squeeze_model


@pytest.mark.parametrize("values", ["14bit", "int32"])
@pytest.mark.parametrize("chains,wd,wr", SQ_SHAPES)
@pytest.mark.parametrize("horizontal", [True, False], ids=["h", "v"])
def test_unsqueeze_vs_plain(cuda, horizontal, chains, wd, wr, values):
    """S1 on non-contiguous views and on their contiguous copies equals its
    plain version bit for bit, one launch a merge."""
    from j40_tpu_torch.ops import squeeze_kernels as SQ

    args = (horizontal, chains, wd, wr, values, 10 * chains + wr)
    want = SQ.unsqueeze(*_merge_views(*args, "cpu"), horizontal)
    down, residu = _merge_views(*args, cuda)
    K.reset_launches()
    got = SQ.unsqueeze(down, residu, horizontal)
    dense = SQ.unsqueeze(down.contiguous(), residu.contiguous(), horizontal)
    torch.cuda.synchronize()
    assert K.launches["unsqueeze"] == 2 and got.is_contiguous()
    assert torch.equal(got.cpu(), want) and torch.equal(dense.cpu(), want)


@pytest.mark.parametrize("horizontal", [True, False], ids=["h", "v"])
def test_unsqueeze_ramp(cuda, horizontal):
    """The slope -1 ramp with zero residuals at lossless_sq's widest shard
    merge (128 chains of 512 pairs), on which no segment's two walks meet
    (tools/squeeze_model.py): S1 walks the segments in order and equals its
    plain version."""
    from j40_tpu_torch.ops import squeeze_kernels as SQ

    model_unsqueeze, ramp = _squeeze_model().model_unsqueeze, _squeeze_model().ramp

    down, residu = (torch.from_numpy(a) for a in ramp(horizontal, 128, 512, 512))
    want = SQ.unsqueeze_ref(down, residu, horizontal)
    counts = model_unsqueeze(down, residu, horizontal)[1]
    assert counts["unmet"] >= counts["segments"] - 2 * 128
    K.reset_launches()
    got = SQ.unsqueeze(down.to(cuda), residu.to(cuda), horizontal)
    torch.cuda.synchronize()
    assert K.launches["unsqueeze"] == 1 and torch.equal(got.cpu(), want)


@pytest.mark.parametrize("horizontal", [True, False], ids=["h", "v"])
def test_unsqueeze_mixed_margin(cuda, horizontal):
    """One launch of 14-bit chains of three windows (1100 pairs) in which a
    few hold a sample past the margin (2^26) in one window or both, and one
    holds samples at the margin: S1 walks those windows in full and the
    rest in segments, and equals its plain version; the model counts the
    same five windows outside the margin."""
    from j40_tpu_torch.ops import squeeze_kernels as SQ

    SM = _squeeze_model()
    MARGIN, merge_inputs, model_unsqueeze = SM.MARGIN, SM.merge_inputs, SM.model_unsqueeze

    down, residu = merge_inputs(True, 40, 1101, 1100, "14bit", 11)
    down[3, 100] = 1 << 30                 # window 0
    residu[7, 1050] = -(1 << 29)           # window 2
    down[12, 200], residu[12, 300] = MARGIN, -MARGIN  # at the margin: inside
    down[13, 1090] = MARGIN + 1            # window 2
    down[20, 1020:1025] = (1 << 31) - 1    # windows 1 and 2's staged samples
    if not horizontal:
        down, residu = down.T.copy(), residu.T.copy()
    down, residu = torch.from_numpy(down), torch.from_numpy(residu)
    want = SQ.unsqueeze_ref(down, residu, horizontal)
    counts = model_unsqueeze(down, residu, horizontal)[1]
    assert counts["margin_windows"] == 5 and counts["met"] > 0.9 * counts["segments"]
    K.reset_launches()
    got = SQ.unsqueeze(down.to(cuda), residu.to(cuda), horizontal)
    torch.cuda.synchronize()
    assert K.launches["unsqueeze"] == 1 and torch.equal(got.cpu(), want)


@pytest.mark.parametrize("chains,wd,wr", [(128, 512, 512), (64, 1101, 1100)])
@pytest.mark.parametrize("horizontal", [True, False], ids=["h", "v"])
def test_unsqueeze_on_every_card(cuda, horizontal, chains, wd, wr):
    """S1 on each card present, in turn, after a launch on the first: the
    widest merges of each segment length (one window of 16, and three)
    equal their plain version on every device, not only on the one that
    launched first."""
    from j40_tpu_torch.ops import squeeze_kernels as SQ

    down, residu = _merge_views(horizontal, chains, wd, wr, "14bit", 3, "cpu")
    want = SQ.unsqueeze_ref(down, residu, horizontal)
    for i in [0, *range(torch.cuda.device_count())]:
        dev = torch.device("cuda", i)
        K.reset_launches()
        got = SQ.unsqueeze(down.to(dev), residu.to(dev), horizontal)
        torch.cuda.synchronize(dev)
        assert K.launches["unsqueeze"] == 1 and got.device == dev
        assert torch.equal(got.cpu(), want), i


def test_unsqueeze_refuses(cuda):
    from j40_tpu_torch.ops import squeeze_kernels as SQ

    z = lambda *s, dt=torch.int32: torch.zeros(*s, dtype=dt, device=cuda)  # noqa: E731
    for down, residu, horizontal in [(z(4, 5), z(3, 4), True), (z(5, 4), z(4, 3), False),
                                     (z(4, 6), z(4, 4), True), (z(3, 4), z(5, 4), False),
                                     (z(4, 5, dt=torch.int64), z(4, 4), True),
                                     (z(4, 5, dt=torch.float32), z(4, 4), False)]:
        with pytest.raises(ValueError):
            SQ.unsqueeze(down, residu, horizontal)
    with pytest.raises(ValueError):  # on two devices
        SQ.unsqueeze(z(4, 5), torch.zeros(4, 4, dtype=torch.int32), True)
    K.reset_launches()
    assert SQ.unsqueeze(z(0, 5), z(0, 4), True).shape == (0, 9)
    assert K.launches["unsqueeze"] == 0


def test_sharded_lossless_on_card(cuda):
    """decode_sharded_lossless on Mesh([cuda:0] * 4): S1 once a (merge,
    shard), bit-exact with Mesh([cpu] * 4) (the plain merge, no launch) and
    the host plan."""
    from j40_tpu_torch.encode.advanced import AdvancedOptions, encode_modular_advanced
    from j40_tpu_torch.parallel import sharded_lossless as SL
    from j40_tpu_torch.parallel.mesh import Mesh

    data = encode_modular_advanced(_lossless(192, 320, seed=77),
                                   options=AdvancedOptions(squeeze=True, rct_type=6))
    merges = SL.squeeze_merges(data)
    assert sum(min(chains, 4) for _, chains, _ in merges) == 4 * len(merges)
    K.reset_launches()
    got = SL.decode_sharded_lossless(data, mesh=Mesh([cuda] * 4, ("rows",)))
    torch.cuda.synchronize()
    assert {k: v for k, v in K.launches.items() if v} == {"unsqueeze": 4 * len(merges)}
    K.reset_launches()
    cpu = SL.decode_sharded_lossless(data, mesh=Mesh(["cpu"] * 4, ("rows",)))
    assert not any(K.launches.values())
    host = Decoder(data, backend="numpy", workers=2)
    host.decode_frame()
    np.testing.assert_array_equal(got, cpu)
    np.testing.assert_array_equal(got, host.render_rgba8())


def test_sharded_lossless_across_cards(cuda):
    """decode_sharded_lossless on default_mesh(), a shard a card present: a
    576x576 Squeeze + YCgCo stream, whose widest merges (288 pairs, on row
    and on column shards) take S1's longer segments on every card; S1 once
    a (merge, shard), bit-exact with the host plan."""
    from j40_tpu_torch.encode.advanced import AdvancedOptions, encode_modular_advanced
    from j40_tpu_torch.parallel import sharded_lossless as SL
    from j40_tpu_torch.parallel.mesh import default_mesh

    data = encode_modular_advanced(_lossless(576, 576, seed=77),
                                   options=AdvancedOptions(squeeze=True, rct_type=6))
    merges = SL.squeeze_merges(data)
    assert {h for h, _, wr in merges if wr > 256} == {True, False}
    mesh = default_mesh()
    devices = list(mesh.devices.flat)
    K.reset_launches()
    got = SL.decode_sharded_lossless(data, mesh=mesh)
    for d in devices:
        torch.cuda.synchronize(d)
    assert {k: v for k, v in K.launches.items() if v} == {
        "unsqueeze": sum(min(chains, len(devices)) for _, chains, _ in merges)}
    host = Decoder(data, backend="numpy", workers=2)
    host.decode_frame()
    np.testing.assert_array_equal(got, host.render_rgba8())


@pytest.mark.parametrize("name", ["plain_ans_global", "static_ans", "e3_ans_global"])
def test_spans_hold_every_copy_on_the_trace_clock(cuda, name):
    """`decode_file(backend="device")` on the card under a profiler session:
    the copies' spans and the trace's HtoD/DtoH Memcpy records, both in
    program order (one thread, one stream), pair one to one by direction,
    so no blocking copy of the route escapes its span; each record lies in
    its span, and each token-kernel record starts in a `modular.batch` span,
    within `CLOCKS_NS`: the profiler's device timestamps and
    `time.time_ns()` disagreed by up to 2.4 ms within one session on the
    card's host, more than a copy lasts on an idle card (PERF.md §5)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from j40_tpu_torch.decode import decode_file
    from j40_tpu_torch.profile import SETTLE_KERNEL, settle

    CLOCKS_NS = 3_000_000
    data = _modular(name)
    decode_file(data, backend="device", device=cuda)  # builds, loads, caches the trees
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        settle()
        dec, _ = decode_file(data, backend="device", device=cuda)
        torch.cuda.synchronize()
    recs = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CUDA and SETTLE_KERNEL not in e.name())
    spans = dec.stats["spans"]
    copies = sorted((s[2], s[3], s[0][5:]) for s in spans if s[0].startswith("copy."))
    mem = [(a, b, n[7:11].lower()) for a, b, n in recs
           if n.startswith(("Memcpy HtoD", "Memcpy DtoH"))]
    assert [d for *_, d in mem] == [d for *_, d in copies] and copies, (mem, copies)
    for (a, b, _), (s, e, _) in zip(mem, copies):
        assert s - CLOCKS_NS <= a and b <= e + CLOCKS_NS, (a - s, e - b)
    batches = [(s[2], s[3]) for s in spans if s[0] == "modular.batch"]
    tokens = [a for a, _, n in recs if "tokens_" in n and "setup" not in n]
    assert tokens and all(any(s - CLOCKS_NS <= a <= e + CLOCKS_NS for s, e in batches)
                          for a in tokens)


def test_camera_photo_filtered_over_the_whole_frame_on_card(cuda):
    """A 4096x3072 frame of the benchmark's configuration photo_d05e7 (cjxl
    -d 0.5 -e 7's shape: mixed varblocks, gaborish, four LF groups) through
    decode_file on the card's route: within 1 level of the same decode on
    the CPU, and within the configuration's limits of the plain float64
    reference (tools/photo_reference.py) on the rows and columns within 8
    pixels of both LF-group borders, so no LF group was filtered apart."""
    import json

    from j40_tpu_torch.decode import decode_file
    from jxlbench import spec
    from jxlbench.frozen_vardct import vardct_enc as V
    from jxlbench.images import camera

    tools = str(Path(__file__).resolve().parents[1] / "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    import photo_reference as R

    cfg = json.loads((spec.PKG / "configs" / "photo_d05e7.json").read_text())
    codec = spec.load_module(spec.PKG / "configs" / "photo_d05e7.py")
    img = camera.make(3072, 4096, 2**31 + 2029, 0)
    ch = codec.choose(img, cfg)
    data = V.encode_choice(ch)
    dec, got = decode_file(data, backend="device", device=cuda, workers=4, apply_filters=True)
    assert dec.stats["num_lf_groups"] == 4
    _, cpu = decode_file(data, backend="torch", device="cpu", workers=4, apply_filters=True)
    assert int(np.abs(got.astype(np.int16) - cpu).max()) <= 1
    ref = R.reconstruct(codec.inputs(ch), cuda)
    got = torch.from_numpy(got).to(cuda)
    near = torch.zeros((3072, 4096), dtype=torch.bool, device=cuda)
    near[2040:2056, :] = True
    near[:, 2040:2056] = True
    nums = codec.compare(got[near][None], ref[near][None])
    assert all(nums[k] <= lim for k, lim in cfg["limits"].items()), nums
    whole = codec.compare(got, ref)
    assert all(whole[k] <= lim for k, lim in cfg["limits"].items()), whole
