"""The plain versions of the HF coefficient kernels (ops/hf_kernels.py:
`hf_walk_ref` for B4, `hf_ctx_walk_ref` for B5), bit-exact:

- against synthetic DCT8 structures whose tokens the port's own entropy
  encoder writes (generators copied from tests/test_pallas_hf.py:
  `_structure_tokens`, `_ctx_structure`, with a coefficient order added),
  for prefix and ANS codes, several lanes, nz > 63 flagged, and a capped
  walk resumed from its snapshot (the nonzero ring included for B5) equal
  to an uncapped one;
- against the JAX package's host decode (`j40_tpu` `backend="numpy"`) of
  real pass-group sections: the coefficient planes gathered by
  `vb_coeffoff` (as j40_tpu/ops/device_vardct.py:252-263 does), the final
  ANS state 0x130000 and the final bit position;
- and the host-side numpy halves (table packers, eligibility rules, word
  packing, block contexts, the resident route's auxiliary planes) against
  their j40_tpu originals on the same streams.

The JAX HF kernels themselves are not run: Pallas interpret mode takes
about 2 s per symbol step (tests/test_pallas_hf.py:10-24).  Streams stay
small (the longest lane under about 5,000 symbols): the plain versions
take about half a millisecond per lockstep step on the CPU.
"""

import numpy as np
import pytest
import torch

from j40_tpu.decode import Decoder as JDecoder
from j40_tpu.io.bits import BitReader as JBitReader
from j40_tpu.ops import combine_jax as JC
from j40_tpu.ops import device_entropy as JDE
from j40_tpu.ops import device_vardct as JDV
from j40_tpu.ops import pallas_entropy as JPE
from j40_tpu.ops import pallas_hf as JPH
from j40_tpu_torch.decode import Decoder as TDecoder
from j40_tpu_torch.encode.bitwriter import BitWriter
from j40_tpu_torch.encode.entropy import EntropyEncoder
from j40_tpu_torch.encode.vardct_enc import VarDCTOptions, encode_vardct, synthesize_vardct
from j40_tpu_torch.entropy.code import read_code_spec
from j40_tpu_torch.io.bits import BitReader, ceil_lg
from j40_tpu_torch.mathutil import pack_signed
from j40_tpu_torch.ops import combine as TC
from j40_tpu_torch.ops import device_entropy as DE
from j40_tpu_torch.ops import hf_kernels as HK
from j40_tpu_torch.ops.device_vardct import YXB2XYB, _lane_bctx3, _prepare_hf_lane
from j40_tpu_torch.vardct.order import natural_order

NATURAL = np.asarray(list(natural_order(3, 3)), np.int32)
IDENTITY = np.arange(64, dtype=np.int32)


def _permuted_order(seed):
    """A coefficient order with positions 1..63 shuffled (position 0, the
    LLF coefficient, stays first, as every signalled order keeps it)."""
    rng = np.random.default_rng(seed)
    return np.concatenate([NATURAL[:1], rng.permutation(NATURAL[1:])]).astype(np.int32)


def _structure_tokens(rng, ncells, max_nz=12, max_pos=63, orders=None):
    """Random DCT8 section structure: returns (tokens, dense oracle
    (3, ncells, 64) at natural positions); orders (3, 64) per XYB channel,
    natural by default."""
    orders = [NATURAL] * 3 if orders is None else orders
    toks = []
    dense = np.zeros((3, ncells, 64), np.int32)
    for k in range(ncells):
        for cyxb in range(3):
            c = YXB2XYB[cyxb]
            nz = int(rng.integers(0, max_nz + 1))
            toks.append(nz)
            if nz == 0:
                continue
            # choose nz nonzero positions among i = 1..max_pos
            pos = sorted(rng.choice(np.arange(1, max_pos + 1), size=nz,
                                    replace=False))
            last = pos[-1]
            for i in range(1, last + 1):
                if i in pos:
                    v = int(rng.integers(1, 40)) * (1 if rng.integers(2)
                                                    else -1)
                else:
                    v = 0
                toks.append(pack_signed(v))
                dense[c, k, orders[c][i]] += v
    return toks, dense


def _ctx_structure(rng, ncells, gw8, nb=15, max_nz=3, ctxoff=0):
    """Random DCT8 structure + the full context chain (j40.h:6929-6992):
    returns (ctx_token_pairs, dense (3, ncells, 64), bctx3 (ncells,)).  The
    block context of each (cell, channel) is drawn at random below nb."""
    from j40_tpu_torch.vardct.tables import TWICE_COEFF_FREQ_CTX, TWICE_COEFF_NNZ_CTX

    bctxs = rng.integers(0, nb, size=(ncells, 3))
    b3 = (bctxs[:, 0] | (bctxs[:, 1] << 10) | (bctxs[:, 2] << 20)).astype(np.int32)
    dense = np.zeros((3, ncells, 64))
    nonzeros = np.zeros((ncells, 3), np.int64)
    pairs = []
    for k in range(ncells):
        y8, x8 = divmod(k, gw8)
        for cyxb in range(3):
            c = YXB2XYB[cyxb]
            bctx = int(bctxs[k, cyxb])
            if x8 > 0 and y8 > 0:
                nzp = (nonzeros[k - 1][c] + nonzeros[k - gw8][c] + 1) >> 1
            elif x8 > 0:
                nzp = nonzeros[k - 1][c]
            elif y8 > 0:
                nzp = nonzeros[k - gw8][c]
            else:
                nzp = 32
            nz = int(rng.integers(0, max_nz + 1))
            nzctx = ctxoff + bctx + (nzp if nzp < 8 else 4 + nzp // 2) * nb
            pairs.append((nzctx, nz))
            nonzeros[k][c] = nz
            cctx = ctxoff + 458 * bctx + 37 * nb
            prev = 1 if nz <= 4 else 0
            rem, i = nz, 1
            pos = sorted(rng.choice(np.arange(1, 12), size=nz,
                                    replace=False)) if nz else []
            while rem > 0 and i < 64:
                v = int(rng.integers(1, 5)) if i in pos else 0
                ctx = (cctx + TWICE_COEFF_NNZ_CTX[rem]
                       + TWICE_COEFF_FREQ_CTX[i] + prev)
                pairs.append((ctx, pack_signed(v)))
                dense[c, k, i] = v
                prev = 1 if v != 0 else 0
                rem -= prev
                i += 1
    return pairs, dense, b3


def _streams(enc, nlanes, num_dist):
    """Each lane's stream: the spec, then its tokens; (streams, spec)."""
    streams, spec = [], None
    for lane in range(nlanes):
        w = BitWriter()
        enc.write_spec(w)
        enc.write_tokens(w, stream=lane)
        data = w.finish()
        r = BitReader(data)
        spec = read_code_spec(r, num_dist)
        streams.append((data, r.bits_consumed))
    return streams, spec


def _orders_yxb(orders_xyb):
    return np.stack([orders_xyb[YXB2XYB[cyxb]] for cyxb in range(3)])


@pytest.mark.parametrize("use_prefix", [True, False], ids=["prefix", "ans"])
def test_hf_walk_structure(use_prefix):
    """Several lanes with a permuted order, plus one nz > 63 lane: exact
    planes, done and err flags, the final ANS state."""
    rng = np.random.default_rng(21)
    ncells = [6, 3, 5]
    orders = [_permuted_order(s) for s in range(3)]
    enc = EntropyEncoder(1, use_prefix=use_prefix)
    denses = []
    for lane, nc in enumerate(ncells):
        toks, dense = _structure_tokens(rng, nc, orders=orders)
        enc.add_array(0, np.asarray(toks, np.int64), stream=lane)
        denses.append(dense)
    enc.add_array(0, np.asarray([70] + [0] * 20, np.int64), stream=3)
    streams, spec = _streams(enc, 4, 1)
    assert HK.hf_spec_is_device_simple(spec)
    coeffs, st = HK.decode_hf_dct8(streams, ncells + [2], spec, _orders_yxb(orders), 6,
                                   device="cpu")
    assert coeffs.shape == (4, 3, 6, 64) and coeffs.dtype == torch.float32
    assert (st["done"] == 1).all()
    assert st["err"].tolist() == [0, 0, 0, 1]
    if not use_prefix:
        assert (st["ans_state"][:3] == 0x130000).all()
    for lane, nc in enumerate(ncells):
        np.testing.assert_array_equal(coeffs[lane, :, :nc].numpy(), denses[lane],
                                      err_msg=f"lane {lane}")
        assert not coeffs[lane, :, nc:].any()


@pytest.mark.parametrize("use_prefix", [True, False], ids=["prefix", "ans"])
def test_hf_walk_resume(use_prefix):
    """A walk capped at a few symbols and resumed from its snapshot gives
    the planes and the final snapshot of one uncapped walk."""
    rng = np.random.default_rng(4)
    enc = EntropyEncoder(1, use_prefix=use_prefix)
    denses = []
    for lane, nc in enumerate((4, 2)):
        toks, dense = _structure_tokens(rng, nc, max_nz=20)
        enc.add_array(0, np.asarray(toks, np.int64), stream=lane)
        denses.append(dense)
    streams, spec = _streams(enc, 2, 1)
    orders = _orders_yxb([NATURAL] * 3)
    d = HK.to_device(HK.build_multi_inputs([(streams, [4, 2], spec, orders)]), "cpu")
    full, st_full = HK.launch_hf(d, 4)
    out, st = HK.launch_hf(d, 4, cap_steps=7)
    snapshots = [st]
    while not st[HK.DONE_ROW].all():
        out, st = HK.launch_hf(d, 4, cap_steps=7, init=st, out=out)
        snapshots.append(st)
    assert len(snapshots) > 5
    assert torch.equal(st, st_full) and torch.equal(out, full)
    np.testing.assert_array_equal(full[0].numpy(), denses[0])
    np.testing.assert_array_equal(full[1, :, :2].numpy(), denses[1])
    # the public entry point resumes the same way
    coeffs, state = HK.decode_hf_dct8(streams, [4, 2], spec, orders, 4, cap_steps=11,
                                      device="cpu")
    assert torch.equal(coeffs, full) and (state["done"] == 1).all()
    np.testing.assert_array_equal(state["bitpos"], st_full[1].numpy())


def _ctx_lanes(nb=15, ctxoffs=(0, 0)):
    """Two ctx lanes (3x2 and 2x3 cells) through a 4-cluster map: nz
    contexts split by the parity of their prediction bucket (so a wrong
    neighbour count picks the wrong cluster), coefficient contexts in two."""
    rng = np.random.default_rng(4)
    npresets = 1 + max(ctxoffs) // (495 * nb)
    cmap = []
    for ctx in range(495 * nb * npresets):
        base = ctx % (495 * nb)
        if base < 37 * nb:
            cmap.append((base // nb) % 2)
        else:
            cmap.append(2 if (base - 37 * nb) % 458 < 200 else 3)
    enc = EntropyEncoder(len(cmap), use_prefix=False, cluster_map=cmap)
    shapes = [(6, 3), (6, 2)]
    denses, b3s = [], []
    for lane, ((nc, gw8), off) in enumerate(zip(shapes, ctxoffs)):
        pairs, dense, b3 = _ctx_structure(rng, nc, gw8, nb=nb, max_nz=4, ctxoff=off)
        for ctx, tok in pairs:
            enc.add(ctx, tok, stream=lane)
        denses.append(dense)
        b3s.append(b3)
    streams, spec = _streams(enc, 2, len(cmap))
    assert spec.num_clusters == 4 and HK.spec_is_device_ctx(spec)
    assert not HK.hf_spec_is_device_simple(spec)
    return streams, spec, [s[0] for s in shapes], [s[1] for s in shapes], b3s, denses


@pytest.mark.parametrize("ctxoffs", [(0, 0), (0, 495 * 4)], ids=["preset0", "presets01"])
def test_hf_ctx_walk_structure(ctxoffs):
    nb = 4
    streams, spec, ncells, gw8s, b3s, denses = _ctx_lanes(nb, ctxoffs)
    orders = _orders_yxb([IDENTITY] * 3)  # the oracle's dense is in order space
    coeffs, st = HK.decode_hf_ctx(streams, ncells, spec, orders, b3s, gw8s, list(ctxoffs),
                                  nb, 6, device="cpu")
    assert (st["done"] == 1).all() and (st["err"] == 0).all()
    assert (st["ans_state"] == 0x130000).all()
    for lane in range(2):
        np.testing.assert_array_equal(coeffs[lane].numpy(), denses[lane])


def test_hf_ctx_walk_resume():
    """Capped and resumed from the snapshot, the nonzero ring included,
    the B5 walk equals one uncapped walk; a resume from a snapshot whose
    ring is zeroed does not (the ring is state, not scratch)."""
    nb = 4
    streams, spec, ncells, gw8s, b3s, denses = _ctx_lanes(nb)
    orders = _orders_yxb([IDENTITY] * 3)
    d = HK.to_device(HK.build_ctx_inputs(streams, ncells, spec, b3s, gw8s, [0, 0], orders),
                     "cpu")
    full, st_full = HK.launch_hf_ctx(d, 6, nb)
    out, st = HK.launch_hf_ctx(d, 6, nb, cap_steps=5)
    steps = 1
    while not st[HK.CTX_DONE_ROW].all():
        if steps == 3:
            broken = st.clone()
            broken[HK.RING_ROW:] = 0
            b_out, b_st = HK.launch_hf_ctx(d, 6, nb, init=broken, out=out.clone())
        out, st = HK.launch_hf_ctx(d, 6, nb, cap_steps=5, init=st, out=out)
        steps += 1
    assert steps > 4
    assert torch.equal(st, st_full) and torch.equal(out, full)
    assert not (torch.equal(b_out, full) and torch.equal(b_st, st_full))
    for lane in range(2):
        np.testing.assert_array_equal(full[lane].numpy(), denses[lane])


def test_hf_walk_flags_overlong_run():
    """Nonzeros left when position 63 has passed set err (j40.h 'coef')."""
    enc = EntropyEncoder(1, use_prefix=False)
    enc.add_array(0, np.asarray([2] + [0] * 62 + [3], np.int64))
    streams, spec = _streams(enc, 1, 1)
    coeffs, st = HK.decode_hf_dct8(streams, [1], spec, _orders_yxb([NATURAL] * 3), 1,
                                   device="cpu")
    assert st["err"][0] == 1 and st["done"][0] == 1
    assert coeffs[0, 1, 0, NATURAL[63]] == -2  # written before the overrun


def test_refuses_what_the_kernels_cannot_hold():
    """Planes with fewer rows than a lane has cells, and a B5 lane wider
    than the nonzero ring (a group of 512 or 1024 pixels, which the route
    leaves to the host), raise before anything launches."""
    nb = 4
    streams, spec, ncells, gw8s, b3s, _ = _ctx_lanes(nb)
    orders = _orders_yxb([IDENTITY] * 3)
    d = HK.to_device(HK.build_ctx_inputs(streams, ncells, spec, b3s, gw8s, [0, 0], orders),
                     "cpu")
    with pytest.raises(ValueError, match="planes of 5"):
        HK.launch_hf_ctx(d, 5, nb)
    with pytest.raises(ValueError, match="ring"):
        HK.build_ctx_inputs(streams, ncells, spec, b3s, [HK.RING_CELLS + 1, 2], [0, 0],
                            orders)


# ---------------------------------------------------------------- vs the host


def _smooth(h, w, seed=1, noise=0.5):
    """A smooth photo-like image (few HF coefficients: short lanes)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    return np.stack([
        96 + 60 * np.sin(xx / 29) * np.cos(yy / 23) + 10 * np.sin(xx / (9 + 2 * c))
        + rng.normal(0, noise, (h, w)) for c in range(3)], -1).clip(0, 255).astype(np.uint8)


def _block_ctx_presets():
    """Custom block contexts (qf and lf thresholds with per-block HfMul) and
    two HF presets: the sections start after a preset bit."""
    rng = np.random.default_rng(70)
    h8, w8 = 2, 40
    lf = rng.integers(-40, 40, size=(3, h8, w8))
    hf = []
    for _ in range(h8 * w8):
        q = rng.integers(-3, 4, size=(3, 64))
        q[rng.random((3, 64)) < 0.8] = 0
        q[:, 16:] = 0  # short runs: a short lane
        hf.append(q)
    size = 39 * 2 * 3 * 2 * 3
    opt = VarDCTOptions(use_prefix=False, num_hf_presets=2,
                        block_ctx=dict(lf_thr=[[0], [5, 20], [-10]], qf_thr=[8, 24],
                                       map=[i % 8 for i in range(size)]))
    return synthesize_vardct(8 * w8, 8 * h8, np.zeros((h8, w8), np.int32), lf, hf,
                             options=opt, hfmul_per_vb=rng.integers(4, 40, size=h8 * w8))


HOST_STREAMS = {
    "prefix": lambda: encode_vardct(_smooth(16, 264)),
    "ans": lambda: encode_vardct(_smooth(16, 264), VarDCTOptions(use_prefix=False)),
    "ans_5clusters": lambda: encode_vardct(
        _smooth(24, 272, seed=3), VarDCTOptions(use_prefix=False, coeff_clusters=5)),
    "ans_block_ctx_presets": _block_ctx_presets,
}


@pytest.mark.parametrize("name", list(HOST_STREAMS))
def test_against_jax_host_decode(name):
    data = HOST_STREAMS[name]()
    dec = TDecoder(data, device="cpu", max_passes=0)
    dec.decode_frame(_defer_finish=True)
    f, toc, state = dec._deferred
    vd = state.vardct
    spec = vd.coeff_codespec[0]
    sections = [s for s in toc.sections if s.pass_ == 0]
    lanes = [_prepare_hf_lane(dec, state, f, vd, s, ceil_lg(vd.num_hf_presets))
             for s in sections]
    assert len(lanes) >= 2 and all(lanes)
    streams = [(ln.data, ln.bitoff) for ln in lanes]
    ncells = [ln.gw8 * ln.gh8 for ln in lanes]
    orders = np.stack([np.asarray(vd.orders[0][0][YXB2XYB[c]], np.int32) for c in range(3)])
    ctx = not HK.hf_spec_is_device_simple(spec)
    assert ctx == (name == "ans_5clusters")
    if ctx:
        assert HK.spec_is_device_ctx(spec)
        presets = [BitReader(ln.data).u(ln.bitoff) if ln.bitoff else 0 for ln in lanes]
        coeffs, st = HK.decode_hf_ctx(
            streams, ncells, spec, orders, [_lane_bctx3(vd, ln) for ln in lanes],
            [ln.gw8 for ln in lanes], [495 * vd.nb_block_ctx * p for p in presets],
            vd.nb_block_ctx, max(ncells), device="cpu")
    else:
        if "presets" in name:
            assert {ln.bitoff for ln in lanes} == {1}
        coeffs, st = HK.decode_hf_dct8(streams, ncells, spec, orders, max(ncells),
                                       device="cpu")
    assert (st["done"] == 1).all() and (st["err"] == 0).all()
    if not spec.use_prefix_code:
        assert (st["ans_state"] == 0x130000).all()

    # the JAX package's host decode of the same sections
    jd = JDecoder(data, backend="numpy")
    jd.decode_frame(_defer_finish=True)
    jvd = jd._deferred[2].vardct
    for li, (s, ln) in enumerate(zip(sections, lanes)):
        gg = jvd.lf_groups[ln.ggidx]
        sub = gg.blocks[ln.gy8:ln.gy8 + ln.gh8, ln.gx8:ln.gx8 + ln.gw8].ravel()
        idx = gg.vb_coeffoff[sub & 0xFFFFF].astype(np.int64)[:, None] + np.arange(64)
        for c in range(3):
            np.testing.assert_array_equal(coeffs[li, c, :len(sub)].numpy(),
                                          gg.coeffs[c][idx], err_msg=f"{s.idx} {c}")
        # the host's final bit position: the same section read again into
        # scratch planes
        saved = gg.coeffs
        gg.coeffs = [np.zeros_like(p) for p in saved]
        r = JBitReader(ln.data)
        jvd.read_pass_group(r, 0, s.idx)
        gg.coeffs = saved
        base = (ln.bitoff // 8) & ~1
        assert base * 8 + int(st["bitpos"][li]) == r.bits_consumed, s.idx


@pytest.mark.parametrize("name", list(HOST_STREAMS))
def test_host_packers_match_jax(name):
    """The numpy halves copied from j40_tpu give its arrays on the same
    stream: the table packers of ops/device_entropy.py per cluster, the
    eligibility rules, the lanes' word packing and block contexts, and the
    resident route's auxiliary planes (`combine._plan_aux_dct8`)."""
    data = HOST_STREAMS[name]()
    decs = []
    for cls in (TDecoder, JDecoder):
        dec = (cls(data, device="cpu", max_passes=0) if cls is TDecoder
               else cls(data, backend="numpy", max_passes=0))
        dec.decode_frame(_defer_finish=True)
        decs.append(dec)
    (tdec, jdec) = decs
    (f, toc, ts), (jf, _, js) = tdec._deferred, jdec._deferred
    spec, jspec = ts.vardct.coeff_codespec[0], js.vardct.coeff_codespec[0]
    assert HK.hf_spec_is_device_simple(spec) == JPH.hf_spec_is_device_simple(jspec)
    assert HK.spec_is_device_ctx(spec) == JPH.spec_is_pallas_ctx(jspec)
    assert DE.spec_is_pallas_simple(spec) == JPE.spec_is_pallas_simple(jspec)
    assert DE.spec_is_device_simple(spec) == JDE.spec_is_device_simple(jspec)
    assert DE.spec_is_device_multi(spec) == JDE.spec_is_device_multi(jspec)
    for cl, jcl in zip(spec.clusters, jspec.clusters, strict=True):
        alpha = 1 << spec.log_alpha_size
        for a, b in zip(DE.hybrid_luts(cl.config, alpha), JDE.hybrid_luts(jcl.config, alpha)):
            np.testing.assert_array_equal(a, b)
        if spec.use_prefix_code:
            width = max(1, cl.prefix.max_len)
            np.testing.assert_array_equal(DE.pack_prefix_lut(cl.prefix, width),
                                          JPE.pack_prefix_lut(jcl.prefix, width))
            continue
        for a, b in zip(DE.ans_luts(cl), JDE.ans_luts(jcl)):
            np.testing.assert_array_equal(a, b)
        (t, lbs), (jt, jlbs) = DE.pack_alias_buckets(cl), JPE.pack_alias_buckets(jcl)
        np.testing.assert_array_equal(t, jt)
        assert lbs == jlbs
        alpha = int(max(i for i, q in enumerate(cl.D) if q > 0)) + 1
        try:
            jtok = JPE.pack_token_lut(jcl.config, alpha)
        except AssertionError:
            with pytest.raises(AssertionError):
                DE.pack_token_lut(cl.config, alpha)
        else:
            np.testing.assert_array_equal(DE.pack_token_lut(cl.config, alpha), jtok)

    sections = [s for s in toc.sections if s.pass_ == 0]
    bits = ceil_lg(ts.vardct.num_hf_presets)
    lanes = [_prepare_hf_lane(tdec, ts, f, ts.vardct, s, bits) for s in sections]
    jlanes = [JDV._prepare_hf_lane(jdec, js, jf, js.vardct, s, bits) for s in sections]
    streams = [(ln.data, ln.bitoff) for ln in lanes]
    for a, b in zip(DE.pack_streams(streams), JDE.pack_streams(streams)):
        np.testing.assert_array_equal(a, b)
    for ln, jln in zip(lanes, jlanes, strict=True):
        np.testing.assert_array_equal(_lane_bctx3(ts.vardct, ln),
                                      JDV._lane_bctx3(js.vardct, jln))
    for ggidx, gg in ts.vardct.lf_groups.items():
        jgg = js.vardct.lf_groups[ggidx]
        voffs = (np.asarray(gg.blocks) & 0xFFFFF).reshape(-1)
        offs = np.asarray(gg.vb_coeffoff)[voffs]
        got = TC._plan_aux_dct8(ts.vardct, gg, ts.im, f, voffs, offs)
        want = JC._plan_aux_dct8(js.vardct, jgg, js.im, jf, voffs, offs)
        for a, b in zip(got, want, strict=True):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
