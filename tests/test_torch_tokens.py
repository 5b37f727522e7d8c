"""The token decode of the modular device lanes: the port's plain lockstep
decoder (ops/device_entropy.py decode_tokens / decode_tokens_ctx, the plain
version of the CUDA kernel B6) and its packer and wrapper
(ops/token_kernels.py), against j40_tpu's XLA decoders and the host oracle
(tests/test_torch_tokens_b6.py holds it against j40_tpu's Pallas kernel B6
in interpret mode).

Streams come from the port's EntropyEncoder, read back by both packages'
code-spec readers.  Everything is integer: values, final rANS states
(0x130000 at a clean end, j40.h:2884-2891) and final bit positions must be
EQUAL.
"""

import numpy as np
import pytest
import torch

from j40_tpu.entropy.code import read_code_spec as jread_code_spec
from j40_tpu.io.bits import BitReader as JBitReader
from j40_tpu.ops import device_entropy as JDE
from j40_tpu.ops import pallas_entropy as JPE
from j40_tpu_torch.encode.bitwriter import BitWriter
from j40_tpu_torch.encode.entropy import EntropyEncoder
from j40_tpu_torch.entropy.code import CodeState, read_code_spec
from j40_tpu_torch.entropy.hybrid import HybridIntConfig
from j40_tpu_torch.io.bits import BitReader
from j40_tpu_torch.ops import device_entropy as DE
from j40_tpu_torch.ops import kernels as K
from j40_tpu_torch.ops import token_kernels as TKN
from j40_tpu_torch.ops.hf_kernels import to_device

SEED_PAD = 3  # misaligns the stream start


def _values(rng, n, kind):
    if kind == "const":
        return np.full(n, 7, np.int64)  # a single-symbol code
    if kind == "small":
        return rng.integers(0, 500, size=n).astype(np.int64)
    # heavy-tailed values exercise the hybrid extra-bit path
    return np.minimum((rng.pareto(0.8, size=n) * 3).astype(np.int64), 60000)


def _read(data, num_dist):
    """(port spec, j40_tpu spec, bit offset) after the seed pad + spec."""
    r, jr = BitReader(data), JBitReader(data)
    r.u(SEED_PAD)
    jr.u(SEED_PAD)
    spec, jspec = read_code_spec(r, num_dist), jread_code_spec(jr, num_dist)
    assert r.bits_consumed == jr.bits_consumed
    return spec, jspec, r


def _host(spec, r, ctxs):
    code = CodeState(spec)
    vals = [code.code(r, int(c)) for c in ctxs]
    code.finish(r)
    return vals


def make_lanes(lanes, use_prefix, shared, ctxs=None, num_dist=1, cluster_map=None,
               config=HybridIntConfig(4, 1, 0)):
    """Encode each lane's values as its own section stream: under one code
    spec (`shared`, the global-tree case) or one spec per lane (local
    trees).  `ctxs`: per lane the context of each token (None: context 0).
    Returns (streams, port specs, j40_tpu specs, host values, end bits)."""
    ctxs = ctxs or [np.zeros(len(v), np.int64) for v in lanes]
    mk = lambda: EntropyEncoder(num_dist, use_prefix=use_prefix,
                                cluster_map=cluster_map, config=config)
    shared_enc = mk() if shared else None
    encs = []
    for l, (v, c) in enumerate(zip(lanes, ctxs)):
        enc = shared_enc or mk()
        enc.add_arrays(np.asarray(c), np.asarray(v), stream=l)
        encs.append(enc)
    streams, specs, jspecs, host, ends = [], [], [], [], []
    for l, enc in enumerate(encs):
        w = BitWriter()
        w.u(SEED_PAD, (1 << SEED_PAD) - 1)
        enc.write_spec(w)
        enc.write_tokens(w, stream=l)
        data = w.finish()
        spec, jspec, r = _read(data, num_dist)
        streams.append((data, r.bits_consumed))
        # lanes that share a spec share its object, as device_modular's
        # lanes share the frame's global spec
        specs.append(specs[0] if shared and specs else spec)
        jspecs.append(jspecs[0] if shared and jspecs else jspec)
        host.append(_host(spec, r, ctxs[l]))
        ends.append(r.bits_consumed)
    return streams, specs, jspecs, host, ends


def _jax_luts(jspecs, use_prefix, ctx):
    """j40_tpu's per-lane scan tables, as its device_modular packs them."""
    sym_l, fb_l, hyb, lsb_l = [], [], [], []
    for sp in jspecs:
        cls = sp.clusters if ctx else sp.clusters[:1]
        alpha = (1 << 15) if use_prefix else (1 << sp.log_alpha_size)
        for cl in cls:
            if use_prefix:
                sym_l.append(JDE.prefix_lut(cl.prefix))
                fb_l.append(np.zeros(1, np.int32))
            else:
                fb, sym = JDE.ans_luts(cl)
                sym_l.append(sym)
                fb_l.append(fb)
            hyb.append(JDE.hybrid_luts(cl.config, alpha))
            lsb_l.append(cl.config.lsb_in_token)
    return sym_l, fb_l, hyb, lsb_l


def _check(vals, st, bp, host, ends, streams, use_prefix):
    vals, st, bp = (np.asarray(x) for x in (vals, st, bp))
    for l, hv in enumerate(host):
        np.testing.assert_array_equal(vals[l, : len(hv)], hv)
        assert not vals[l, len(hv):].any()
        base = (streams[l][1] // 8) & ~1
        assert base * 8 + int(bp[l]) == ends[l]
    if not use_prefix:
        assert (st.astype(np.int64) & 0xFFFFFFFF == 0x130000).all(), "final ANS state"


def _decode_lanes(streams, nsym, specs, cids=None):
    """Pack the lanes and decode them on the CPU (the plain version)."""
    d = to_device(TKN.build_lane_inputs(streams, nsym, specs, cids), "cpu")
    return TKN.launch_tokens(d)


def _same(a, b):
    for x, y in zip(a, b, strict=True):
        x, y = np.asarray(x).astype(np.int64), np.asarray(y).astype(np.int64)
        np.testing.assert_array_equal(x & 0xFFFFFFFF, y & 0xFFFFFFFF)


LANE_KINDS = {
    "ragged": [("tail", 700), ("small", 311), ("tail", 523), ("small", 64), ("tail", 1)],
    "single_symbol": [("const", 200), ("tail", 90), ("const", 33)],
}


@pytest.mark.parametrize("use_prefix", [True, False], ids=["prefix", "ans"])
@pytest.mark.parametrize("kinds", list(LANE_KINDS))
def test_plain_matches_jax_scan(use_prefix, kinds):
    """Per-lane specs (local trees): the port's decode_tokens on j40_tpu's
    own scan tables equals j40_tpu's decode_tokens, and the packer route
    (token_kernels on the CPU: the plain version) equals both."""
    rng = np.random.default_rng(7)
    lanes = [_values(rng, n, k) for k, n in LANE_KINDS[kinds]]
    streams, specs, jspecs, host, ends = make_lanes(lanes, use_prefix, shared=False)
    if kinds == "single_symbol" and use_prefix:
        assert specs[0].clusters[0].prefix.single_symbol is not None
    nsym = np.asarray([len(v) for v in lanes], np.int32)
    n = int(nsym.max())
    sym_l, fb_l, hyb, lsb_l = _jax_luts(jspecs, use_prefix, ctx=False)
    amax = max(h[0].shape[0] for h in hyb)
    pad = lambda k: np.stack([np.pad(h[k], (0, amax - h[k].shape[0])) for h in hyb])
    words, skips = JDE.pack_streams(streams)
    args = (words, skips, nsym, np.stack(sym_l), np.stack(fb_l), pad(0), pad(1), pad(2),
            np.asarray(lsb_l, np.int32))
    want = JDE.decode_tokens(*args, n_steps=n, use_prefix=use_prefix)
    _check(*want, host, ends, streams, use_prefix)
    _same(DE.decode_tokens(*args, n_steps=n, use_prefix=use_prefix), want)
    K.reset_launches()
    got = _decode_lanes(streams, nsym, specs)
    assert K.launches["tokens"] == 0  # CPU tensors take the plain version
    _same(got, want)


CTX = {
    "two_clusters": dict(num_dist=3, cluster_map=[0, 1, 1]),
    "three_clusters_lsb": dict(num_dist=4, cluster_map=[0, 1, 2, 1],
                               config=HybridIntConfig(4, 2, 1)),
}


@pytest.mark.parametrize("use_prefix", [True, False], ids=["prefix", "ans"])
@pytest.mark.parametrize("ctx", list(CTX))
def test_plain_ctx_matches_jax_scan(use_prefix, ctx):
    """Per-token clusters (static-property MA trees): the port's
    decode_tokens_ctx on j40_tpu's tables equals j40_tpu's, and the packer
    route equals both."""
    kw = CTX[ctx]
    rng = np.random.default_rng(11)
    counts = [400, 257, 90]
    lanes = [_values(rng, n, "tail") for n in counts]
    ctxs = [rng.integers(0, kw["num_dist"], size=n) for n in counts]
    streams, specs, jspecs, host, ends = make_lanes(lanes, use_prefix, False, ctxs, **kw)
    cmap = np.asarray(specs[0].cluster_map)
    C = max(s.num_clusters for s in specs)
    assert C > 1
    nsym = np.asarray(counts, np.int32)
    n = int(nsym.max())
    npad = -(-n // 4) * 4
    cids = np.zeros((len(lanes), npad), np.int32)
    for l, c in enumerate(ctxs):
        cids[l, : len(c)] = np.asarray(jspecs[l].cluster_map)[c]
    S = (1 << 15) if use_prefix else 4096
    sym = np.zeros((len(lanes), C, S), np.int32)
    fb = np.zeros((len(lanes), C, 1 if use_prefix else 4096), np.int32)
    amax = 1 << 15 if use_prefix else max(1 << s.log_alpha_size for s in jspecs)
    hyb = np.zeros((3, len(lanes), C, amax), np.int32)
    lsb = np.zeros((len(lanes), C), np.int32)
    for l, sp in enumerate(jspecs):
        alpha = (1 << 15) if use_prefix else (1 << sp.log_alpha_size)
        for c, cl in enumerate(sp.clusters):
            if use_prefix:
                sym[l, c] = JDE.prefix_lut(cl.prefix)
            else:
                fb[l, c], sym[l, c] = JDE.ans_luts(cl)
            for k, h in enumerate(JDE.hybrid_luts(cl.config, alpha)):
                hyb[k, l, c, : len(h)] = h
            lsb[l, c] = cl.config.lsb_in_token
    words, skips = JDE.pack_streams(streams)
    flat = lambda a: a.reshape(len(lanes), -1)
    args = (words, skips, nsym, cids, flat(sym), flat(fb), flat(hyb[0]), flat(hyb[1]),
            flat(hyb[2]), lsb)
    want = JDE.decode_tokens_ctx(*args, n_steps=n, use_prefix=use_prefix)
    _check(*want, host, ends, streams, use_prefix)
    _same(DE.decode_tokens_ctx(*args, n_steps=n, use_prefix=use_prefix), want)
    _same(_decode_lanes(streams, nsym, specs, cids=[cmap[c] for c in ctxs]), want)


def test_capped_steps():
    """n_steps below the lanes' counts: each lane stops there, and the
    finals are those after exactly n_steps symbols (the host's position
    after as many reads)."""
    rng = np.random.default_rng(3)
    lanes = [_values(rng, 300, "tail") for _ in range(2)]
    streams, specs, _, host, _ = make_lanes(lanes, False, shared=True)
    d = to_device(TKN.build_lane_inputs(streams, [300, 300], specs), "cpu")
    vals, st, bp = TKN.launch_tokens(d, n_steps=120)
    assert vals.shape == (2, 120)
    _same((vals, st, bp), TKN.launch_tokens(d, 120, decode=TKN.decode_tokens_ref))
    for l, (data, bitoff) in enumerate(streams):
        np.testing.assert_array_equal(vals[l].numpy(), host[l][:120])
        r = BitReader(data)
        r.u(bitoff)
        code = CodeState(specs[l])
        for _ in range(120):
            code.code(r, 0)
        assert ((bitoff // 8) & ~1) * 8 + int(bp[l]) == r.bits_consumed


def _deep_prefix_spec():
    """A stream whose prefix code is 15 bits deep (Fibonacci counts), which
    the lane rule takes and B6's rule (<= 13 bits) refuses."""
    fib = [1, 1]
    while len(fib) < 20:
        fib.append(fib[-1] + fib[-2])
    v = np.concatenate([np.full(c, i) for i, c in enumerate(fib)])
    np.random.default_rng(0).shuffle(v)
    return v


def _specs_for_rules():
    """(name, port spec, j40_tpu spec, streams, nsym) over specs that
    separate the rules: a 15-bit prefix code, msb+lsb > 8, multi-cluster,
    plain prefix and rANS."""
    out = []
    rng = np.random.default_rng(1)
    cases = {
        "deep_prefix": ([_deep_prefix_spec()], True, {}),
        "wide_config": ([_values(rng, 400, "tail")], True,
                        dict(config=HybridIntConfig(10, 5, 4))),
        "multi_cluster": ([_values(rng, 300, "tail")], False,
                          dict(num_dist=2, cluster_map=[0, 1])),
        "prefix": ([_values(rng, 300, "tail")], True, {}),
        "ans": ([_values(rng, 300, "small")], False, {}),
    }
    for name, (lanes, use_prefix, kw) in cases.items():
        ctxs = ([rng.integers(0, kw["num_dist"], size=len(v)) for v in lanes]
                if "num_dist" in kw else None)
        streams, specs, jspecs, host, ends = make_lanes(lanes, use_prefix, False, ctxs, **kw)
        out.append((name, specs[0], jspecs[0], streams, host, ends, ctxs))
    return out


RULE_CASES = {c[0]: c for c in _specs_for_rules()}


@pytest.mark.parametrize("name", list(RULE_CASES))
def test_packers_and_rules_match_jax(name):
    """The numpy halves copied from j40_tpu give its arrays, and the two
    eligibility rules (the lane rule and B6's) give its answers; the deep
    prefix code separates them."""
    _, spec, jspec, streams, host, ends, ctxs = RULE_CASES[name]
    assert DE.spec_is_device_simple(spec) == JDE.spec_is_device_simple(jspec)
    assert DE.spec_is_device_multi(spec) == JDE.spec_is_device_multi(jspec)
    assert DE.spec_is_pallas_simple(spec) == JPE.spec_is_pallas_simple(jspec)
    if name == "deep_prefix":
        assert spec.clusters[0].prefix.max_len == 15
        assert DE.spec_is_device_simple(spec) and not DE.spec_is_pallas_simple(spec)
    if name == "multi_cluster":
        assert DE.spec_is_device_multi(spec) and not DE.spec_is_device_simple(spec)
    for cl, jcl in zip(spec.clusters, jspec.clusters, strict=True):
        alpha = 1 << spec.log_alpha_size
        for a, b in zip(DE.hybrid_luts(cl.config, alpha), JDE.hybrid_luts(jcl.config, alpha)):
            np.testing.assert_array_equal(a, b)
        if spec.use_prefix_code:
            # j40_tpu's 15-bit scan LUT is the port's packer at width 15
            np.testing.assert_array_equal(DE.pack_prefix_lut(cl.prefix, 15),
                                          JDE.prefix_lut(jcl.prefix))
        else:
            for a, b in zip(DE.ans_luts(cl), JDE.ans_luts(jcl)):
                np.testing.assert_array_equal(a, b)
    for a, b in zip(DE.pack_streams(streams), JDE.pack_streams(streams)):
        np.testing.assert_array_equal(a, b)
    # and the lanes the lane rule takes decode right through the packer
    if DE.spec_is_device_multi(spec):
        cids = None if ctxs is None else [np.asarray(spec.cluster_map)[c] for c in ctxs]
        got = _decode_lanes(streams, [len(h) for h in host], [spec], cids=cids)
        _check(*got, host, ends, streams, spec.use_prefix_code)


def test_wrapper_refuses_bad_inputs():
    rng = np.random.default_rng(2)
    lanes = [_values(rng, 50, "tail")]
    streams, specs, _, _, _ = make_lanes(lanes, True, shared=False)
    d = to_device(TKN.build_lane_inputs(streams, [50], specs), "cpu")
    bad = dict(d, words=d["words"].to(torch.int32))
    with pytest.raises(ValueError):
        TKN.launch_tokens(bad)
    bad = dict(d, sym=d["sym"][:, :-1].contiguous())  # not a power of 2
    with pytest.raises(ValueError):
        TKN.launch_tokens(bad)
    bad = dict(d, cids=torch.zeros((1, 10), dtype=torch.int32))  # too short
    with pytest.raises(ValueError):
        TKN.launch_tokens(bad)
    bad = dict(d, cids=torch.ones((1, 50), dtype=torch.int32))  # one cluster only
    with pytest.raises(ValueError, match="cids"):
        TKN.launch_tokens(bad)
    bad = dict(d, rows=torch.ones(1, dtype=torch.int32))  # one row only
    with pytest.raises(ValueError, match="rows"):
        TKN.launch_tokens(bad)
