"""B5's lookahead design (csrc/hf.cu `hf_ctx_kernel`), modelled in numpy and
held exactly against the plain version `hf_kernels.hf_ctx_walk_ref`.

The kernel's decoding thread reads one fused 16-byte record per symbol (per
cluster and bucket: the alias records with both tokens' hybrid-int values
folded in) through a per-context table of record bases, and forms the next
symbol's context for both outcomes of a coefficient before the value is
known.  These tests model both halves with the kernel's own arithmetic:

- the tables: `fused_tables` against the decode through `build_ctx_inputs`'
  `ab`/`cfgw` (the plain version's `_ans_step` and `_hybrid`) at every
  state slot of every cluster, for 2-128 clusters and log_alpha 5-8, with
  random hybrid configs; a spec that `spec_is_device_ctx` admits fits the
  kernel's shared memory, and the wrapper refuses larger tables;
- the lookahead: `model_walk` (both candidate contexts, then the selection)
  over the lanes of synthetic multi-cluster sections (`ctx_case`), capped
  mid-block, at a block's end, at a channel switch and at a cell switch,
  resumed from the plain version's snapshot, and on corrupt lanes (a count
  above 63, an overrun): snapshots (the nonzero ring, prev, x8, y8
  included) and planes equal to the plain version's.

The same cases go through the kernel on the card in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from j40_tpu_torch.encode.bitwriter import BitWriter
from j40_tpu_torch.encode.entropy import EntropyEncoder
from j40_tpu_torch.entropy.ans import init_alias_map
from j40_tpu_torch.entropy.code import Cluster, CodeSpec, read_code_spec
from j40_tpu_torch.entropy.hybrid import HybridIntConfig
from j40_tpu_torch.io.bits import BitReader
from j40_tpu_torch.mathutil import pack_signed
from j40_tpu_torch.ops import hf_kernels as HK
from j40_tpu_torch.vardct.tables import TWICE_COEFF_FREQ_CTX, TWICE_COEFF_NNZ_CTX

YXB2XYB = HK.YXB2XYB
MAX_MID, MB_BIT = 17, 26  # csrc/hf.cu kMaxMid, kMbBit
#: shared memory of a block beside the tables (nat, nf, count ring, value
#: ring of 1,024, three counters) and the most a block may opt in to
SMEM_FIXED, SMEM_MAX = (192 + 64 + 96 + 1024 + 3) * 4, 232448


# ---------------------------------------------------------------- the tables


def fuse_token(tok: int, cw: int) -> int:
    """csrc/hf.cu fuse_token: the value base of `tok` with its extra-bit
    count at bit 26, under the config word lsb | msb << 4 | split_exp << 8."""
    lsb, msb, sexp = cw & 15, (cw >> 4) & 15, (cw >> 8) & 31
    if tok < (1 << sexp):
        return tok
    mb = sexp - (msb + lsb) + ((tok - (1 << sexp)) >> (msb + lsb))
    if not 0 <= mb <= MAX_MID:
        return 0
    lo = tok & ((1 << lsb) - 1)
    hi = (tok >> lsb) & ((1 << msb) - 1)
    a = ((1 << msb) | hi) << lsb
    return ((a << mb) | lo | (mb << MB_BIT)) & 0xFFFFFFFF


def fused_tables(ab, cfgw, cmap, log_alpha: int):
    """The kernel's staged tables (csrc/hf.cu ctx_record and the context
    table): records (n_ab / 2, 4) as uint32 words x, y, z, w, and per
    context the first record of its cluster | the cluster's lsb << 12."""
    ab = np.asarray(ab, np.int64) & 0xFFFFFFFF
    T, lbs = 1 << log_alpha, 12 - log_alpha
    nrec = len(ab) // 2
    rec = np.zeros((nrec, 4), np.int64)
    for i in range(nrec):
        e0, e1 = int(ab[2 * i]), int(ab[2 * i + 1])
        cw = int(cfgw[i >> log_alpha])
        cut = min(e0 & 0x1FFF, 1 << lbs)
        rec[i] = (cut << 24 | (((e0 >> 13) - 1) & 0xFFF) << 12,
                  (e1 & 0xFFF) | (((e1 >> 12) - 1) & 0xFFF) << 12,
                  fuse_token(i & (T - 1), cw), fuse_token(e1 >> 24, cw))
    cm = np.asarray(cmap, np.int64) & 0xFFFFFFFF
    cl = np.minimum((cm[:, None] >> (8 * np.arange(4))) & 0xFF, max(nrec // T - 1, 0)).ravel()
    csel = (cl << log_alpha) | (np.asarray(cfgw, np.int64)[cl] & 15) << 12
    return rec, csel


def fused_step(rec, sel, state, log_alpha: int):
    """The alias decode of symbols through their fused records, as the
    kernel's `decode` (numpy, elementwise over int64 arrays or ints):
    returns (new state before renormalization, fused value)."""
    lbs = 12 - log_alpha
    state = np.asarray(state, np.int64)
    pos = state & ((1 << lbs) - 1)
    x, y, z, w = rec[(np.asarray(sel) & 0xFFF) + ((state & 0xFFF) >> lbs)].T
    direct = ((pos << 24) | 0xFFFFFF) < x
    e, fz = np.where(direct, x, y), np.where(direct, z, w)
    s12 = state >> 12
    return (((e >> 12) & 0xFFF) * s12 + s12 + pos + (e & 0xFFF)) & 0xFFFFFFFF, fz


def _random_spec(rng, C: int, log_alpha: int) -> CodeSpec:
    """A multi-cluster rANS spec with random distributions (a single-symbol
    one among them) and a random hybrid config per cluster, valid as the
    reader builds them: split_exp <= log_alpha, msb + lsb <= split_exp."""
    T = 1 << log_alpha
    clusters = []
    for ci in range(C):
        while True:  # extra bits of every token within the rule's 17
            sexp = int(rng.integers(0, log_alpha + 1))
            msb = int(rng.integers(0, sexp + 1))
            lsb = int(rng.integers(0, sexp - msb + 1))
            nbits = msb + lsb
            if T - 1 < (1 << sexp) or sexp - nbits + ((T - 1 - (1 << sexp)) >> nbits) <= 17:
                break
        # symbols below 128: pack_alias_buckets keeps its words positive
        n = 1 if ci == 1 else int(rng.integers(2, min(T, 128) + 1))
        syms = rng.choice(min(T, 128), n, replace=False)
        w = rng.random(n) + 0.05
        D = np.zeros(T, np.int64)
        D[syms] = np.maximum(1, np.floor(w / w.sum() * 4096)).astype(np.int64)
        D[syms[0]] += 4096 - D.sum()
        D = [int(v) for v in D]
        clusters.append(Cluster(config=HybridIntConfig(sexp, msb, lsb), D=D,
                                aliases=init_alias_map(D, log_alpha)))
    cmap = [int(v) for v in rng.integers(0, C, max(64, C))]
    cmap[:C] = range(C)
    return CodeSpec(num_dist=len(cmap), lz77_enabled=False, use_prefix_code=False,
                    min_symbol=0, min_length=0, log_alpha_size=log_alpha, cluster_map=cmap,
                    lz_len_config=None, clusters=clusters)


@pytest.mark.parametrize("log_alpha,C", [(5, 2), (5, 128), (6, 37), (6, 64), (7, 3), (7, 32),
                                         (8, 5), (8, 16)])
def test_fused_tables_match_the_records(log_alpha, C):
    """At every state slot of every cluster, the fused record gives the
    plain version's new state, and its fused value the plain version's
    value for every extra-bit pattern's low bits."""
    rng = np.random.default_rng(1000 * log_alpha + C)
    spec = _random_spec(rng, C, log_alpha)
    assert HK.spec_is_device_ctx(spec) == (C * 2 * (1 << log_alpha) <= HK.MAX_CTX_AB)
    d = HK.build_ctx_inputs([(b"\0" * 8, 0)], [1], spec, [np.zeros(1, np.int32)], [1], [0],
                            np.zeros((3, 64), np.int32))
    rec, csel = fused_tables(d["ab"], d["cfgw"], d["cmap"], log_alpha)
    T, lbs = 1 << log_alpha, 12 - log_alpha
    # the kernel's shared memory for these tables fits the card's opt-in
    assert rec.shape[0] * 16 + len(csel) * 2 + SMEM_FIXED <= SMEM_MAX
    assert (rec < (1 << 32)).all() and (rec >= 0).all()
    ab = torch.from_numpy(d["ab"]).long()
    slots = torch.arange(4096, dtype=torch.int64)
    state = (slots + (torch.arange(4096) * 7919 % 50000 + 1) * 4096) & 0xFFFFFFFF
    ones = torch.ones(4096, dtype=torch.bool)
    sels = csel[:len(spec.cluster_map)]
    assert (sels & 0xFFF).tolist() == [c * T for c in spec.cluster_map]
    assert (sels >> 12).tolist() == [spec.clusters[c].config.lsb_in_token
                                     for c in spec.cluster_map]
    for cl in range(C):  # cluster cl is context cl's
        at = cl * 2 * T + 2 * (slots >> lbs)
        # the plain version's decode; renormalization bits all zero
        tok, ns, renorm = HK._ans_step(state, torch.zeros(4096, dtype=torch.int64), ones,
                                       ab[at], ab[at + 1], slots & ((1 << lbs) - 1), slots >> lbs)
        got_state, fz = fused_step(rec, int(sels[cl]), state.numpy(), log_alpha)
        want = np.where(renorm.numpy() > 0, ns.numpy() >> 16, ns.numpy())
        np.testing.assert_array_equal(got_state, want)
        np.testing.assert_array_equal(fz != 0, tok.numpy() != 0)
        cfg = spec.clusters[cl].config
        nbits = cfg.msb_in_token + cfg.lsb_in_token
        mb = fz >> MB_BIT
        for mid in (0, 0x1FFFF, 0x15555):
            win = torch.full((4096,), mid, dtype=torch.int64) << renorm
            value, used = HK._hybrid(win, renorm, tok, ones, cfg.lsb_in_token,
                                     1 << cfg.split_exp, nbits, cfg.split_exp - nbits,
                                     cfg.msb_in_token)
            got = (fz & ((1 << MB_BIT) - 1)) | ((mid & ((1 << mb) - 1)) << cfg.lsb_in_token)
            np.testing.assert_array_equal(got, value.numpy())
            np.testing.assert_array_equal(mb, (used - renorm).numpy())


def test_wrapper_refuses_tables_past_shared_memory():
    """255 clusters at log_alpha 5 (twice MAX_CTX_AB's records): the rule
    refuses the spec and the wrapper the tables."""
    spec = _random_spec(np.random.default_rng(3), 255, 5)
    assert not HK.spec_is_device_ctx(spec)
    d = HK.build_ctx_inputs([(b"\0" * 8, 0)], [1], spec, [np.zeros(1, np.int32)], [1], [0],
                            np.zeros((3, 64), np.int32))
    t = HK.to_device(d, "cpu")
    with pytest.raises(ValueError, match="ctx tables"):
        HK.launch_hf_ctx(t, 1, 4)


# ---------------------------------------------------------------- synthetic lanes


def _ctx_pairs(rng, ncells, gw8, nb, ctxoff, b3, bad=None, long_blocks=False):
    """The (context, token) pairs of one DCT8 section under the full context
    model (j40.h:6929-6992), with counts up to 20 at random positions up to
    16, or up to 63 in one block of ten (in every block with long_blocks);
    bad = (block, "count" | "overrun")
    ends the section with a count of 70 or a block whose nonzeros outlast
    position 63."""
    nonzeros = np.zeros((ncells, 3), np.int64)
    pairs = []
    for k in range(ncells):
        y8, x8 = divmod(k, gw8)
        for cyxb in range(3):
            c = YXB2XYB[cyxb]
            bctx = (int(b3[k]) >> (10 * cyxb)) & 0x3FF
            if x8 > 0 and y8 > 0:
                nzp = (nonzeros[k - 1][c] + nonzeros[k - gw8][c] + 1) >> 1
            elif x8 > 0:
                nzp = nonzeros[k - 1][c]
            elif y8 > 0:
                nzp = nonzeros[k - gw8][c]
            else:
                nzp = 32
            block = 3 * k + cyxb
            span = 63 if long_blocks or rng.random() < 0.1 else 16
            nz = min(int(rng.integers(0, 21)), span) if rng.random() < 0.75 else 0
            kind = bad[1] if bad and bad[0] == block else None
            count = 70 if kind == "count" else nz + 2 if kind == "overrun" else nz
            pairs.append((ctxoff + bctx + (nzp if nzp < 8 else 4 + nzp // 2) * nb, count))
            nonzeros[k][c] = count
            if kind == "count":
                return pairs
            if count == 0:
                continue
            pos = set(rng.choice(np.arange(1, span + 1), nz, replace=False).tolist())
            last = 63 if kind == "overrun" else max(pos)
            cctx = ctxoff + 458 * bctx + 37 * nb
            prev, rem = int(count <= 4), count
            for i in range(1, last + 1):
                v = int(rng.integers(1, 9)) * (1 if rng.integers(2) else -1) if i in pos else 0
                pairs.append((cctx + TWICE_COEFF_NNZ_CTX[rem] + TWICE_COEFF_FREQ_CTX[i] + prev,
                              pack_signed(v)))
                prev = int(v != 0)
                rem -= prev
            if kind == "overrun":
                return pairs
    return pairs


CASES = {
    # (ncells, gw8) per lane; clusters; bad block of lane 0
    "ctx_blocks": ([(20, 5), (9, 1), (40, 32)], 4, None),
    "ctx_count_above_63": ([(30, 4), (12, 3)], 4, (47, "count")),
    "ctx_overrun": ([(30, 4), (12, 3)], 4, (38, "overrun")),
    # more clusters than one 32 KB table per (cluster, state slot) would fit
    "ctx_clusters16": ([(24, 6), (16, 2)], 16, None),
}


def ctx_case(name: str) -> dict:
    """A packed B5 input (build_ctx_inputs' format, numpy) of synthetic
    sections written by the port's rANS encoder through a cluster map that
    scatters neighbouring contexts over the clusters, with two context
    presets; adds nb and ncmax.  ctx_blocks' third lane holds more values
    than the kernel's ring of 1,024."""
    rng = np.random.default_rng(sum(map(ord, name)))
    shapes, C, bad = CASES[name]
    nb = 4
    ncontexts = 2 * 495 * nb
    cmap = [int((ctx * 2654435761) >> 7) % C for ctx in range(ncontexts)]
    cmap[:C] = range(C)
    enc = EntropyEncoder(ncontexts, use_prefix=False, cluster_map=cmap,
                         complex_cluster_map=C > 4)
    b3s, ctxoffs = [], []
    for li, (nc, gw8) in enumerate(shapes):
        bctx = rng.integers(0, nb, size=(nc, 3))
        b3 = (bctx[:, 0] | (bctx[:, 1] << 10) | (bctx[:, 2] << 20)).astype(np.int32)
        off = 495 * nb * (li % 2)
        for ctx, tok in _ctx_pairs(rng, nc, gw8, nb, off, b3, bad if li == 0 else None,
                                   long_blocks=li == 0 and bad is not None):
            enc.add(ctx, tok, stream=li)
        b3s.append(b3)
        ctxoffs.append(off)
    streams = []
    for li in range(len(shapes)):
        w = BitWriter()
        enc.write_spec(w)
        enc.write_tokens(w, stream=li)
        data = w.finish()
        r = BitReader(data)
        spec = read_code_spec(r, ncontexts)
        streams.append((data, r.bits_consumed))
    assert spec.num_clusters == C and HK.spec_is_device_ctx(spec)
    orders = np.stack([np.roll(np.arange(64, dtype=np.int32), 3 * c) for c in range(3)])
    orders[:, 0] = 0
    d = HK.build_ctx_inputs(streams, [s[0] for s in shapes], spec, b3s,
                            [s[1] for s in shapes], ctxoffs, orders)
    d.update(nb=nb, ncmax=max(s[0] for s in shapes))
    return d


# ---------------------------------------------------------------- the model


def _bits(words, pos: int, n: int) -> int:
    """n bits LSB-first at bit `pos` of a lane's 16-bit words (zeros past
    the end, as the kernel's reader pads)."""
    v = 0
    for j in range(-(-(n + (pos & 15)) // 16)):
        i = (pos >> 4) + j
        v |= (int(words[i]) if i < len(words) else 0) << (16 * j)
    return (v >> (pos & 15)) & ((1 << n) - 1)


def model_walk(d: dict, lane: int, cap: int, init) -> tuple[np.ndarray, list, list]:
    """The decoding thread of hf_ctx_kernel on one lane, from the snapshot
    column `init` (112,): at most `cap` symbols.  Returns its snapshot
    column, the values it hands the walking warp and, per value, where the
    walk stood after it: "count" (a nonzero count: the block goes on),
    "coef" (inside a block), "channel" (a block ended inside the cell),
    "cell" (a cell ended).  The next symbol's record base is chosen between
    the two candidates formed before its predecessor's value is known."""
    la, nb = d["log_alpha"], d["nb"]
    rec, csel = fused_tables(d["ab"], d["cfgw"], d["cmap"], la)
    nf = [int(v) for v in d["nf"]]
    words, b3 = d["words"][lane], [int(v) for v in d["bctx3"][lane]]
    col = [int(v) for v in init]
    state, bitpos = col[0] & 0xFFFFFFFF, col[1]
    k, cyxb, nzrem, ii, err, prev, x8, y8, gw8, ctxoff = col[2:12]
    cring = col[HK.RING_ROW:]
    nc = int(d["nc"][lane])
    w = dict(k=k, cyxb=cyxb, x8=x8, y8=y8)

    def word(kk):
        return b3[kk] if kk < len(b3) else 0

    def sel_of(ctx):
        return int(csel[min(ctx, len(csel) - 1)])

    def count_sel(cy, xx, yy, wd):
        c = YXB2XYB[cy]
        nzl, nzt = cring[c * 32 + max(xx - 1, 0)], cring[c * 32 + xx]
        nzp = ((nzl + nzt + 1) >> 1 if xx > 0 and yy > 0 else nzl if xx > 0
               else nzt if yy > 0 else 32)
        bucket = nzp if nzp < 8 else 4 + (nzp >> 1)
        return sel_of(ctxoff + ((wd >> (10 * cy)) & 0x3FF) + bucket * nb)

    def next_count_sel():
        if w["cyxb"] < 2:
            return count_sel(w["cyxb"] + 1, w["x8"], w["y8"], word(w["k"]))
        wrap = w["x8"] + 1 >= gw8
        return count_sel(0, 0 if wrap else w["x8"] + 1, w["y8"] + wrap, word(w["k"] + 1))

    def coef_base():
        return ctxoff + 458 * ((word(w["k"]) >> (10 * w["cyxb"])) & 0x3FF) + 37 * nb

    def coef_sel(base, rem, i, pv):
        return sel_of(base + (nf[min(max(rem, 0), 63)] & 0xFFFF) + (nf[i & 63] >> 16) + pv)

    def next_block():
        w["cyxb"] += 1
        if w["cyxb"] == 3:
            w["cyxb"] = 0
            w["k"] += 1
            w["x8"] += 1
            if w["x8"] >= gw8:
                w["x8"], w["y8"] = 0, w["y8"] + 1
            return "cell"
        return "channel"

    def decode(sel):
        nonlocal state, bitpos
        ns, fz = fused_step(rec, sel, state, la)
        if ns < (1 << 16):
            ns = (ns << 16) | _bits(words, bitpos, 16)
            bitpos += 16
        state = ns
        mb = fz >> MB_BIT
        mid = _bits(words, bitpos, mb) if mb else 0
        bitpos += mb
        return (fz & ((1 << MB_BIT) - 1)) | (mid << (sel >> 12)), fz != 0

    values, events = [], []
    cur = nxt = cbase = 0
    if w["k"] < nc and err == 0:
        if nzrem == 0:
            cur = count_sel(w["cyxb"], w["x8"], w["y8"], word(w["k"]))
        else:
            cbase = coef_base()
            cur, nxt = coef_sel(cbase, nzrem, ii, prev), next_count_sel()
    while len(values) < cap and w["k"] < nc and err == 0:
        if nzrem == 0:
            nxt = next_count_sel()
            value, _ = decode(cur)
            cring[YXB2XYB[w["cyxb"]] * 32 + w["x8"]] = value
            prev = int(value <= 4)
            err |= int(value > 63)
            if value > 0:
                nzrem, ii = value, 1
                cbase = coef_base()
                cur = coef_sel(cbase, value, 1, prev)
                event = "count"
            else:
                event = next_block()
                cur = nxt
        else:
            ii1 = ii + 1
            sel_zero = coef_sel(cbase, nzrem, ii1, 0)
            sel_nonzero = nxt if nzrem == 1 else coef_sel(cbase, nzrem - 1, ii1, 1)
            value, nonzero = decode(cur)
            cur = sel_nonzero if nonzero else sel_zero
            nzrem -= nonzero
            ii, prev = ii1, int(nonzero)
            event = "coef"
            if nzrem == 0:
                event = next_block()
            elif ii1 >= 64:
                nzrem, err = 0, 1
                event = next_block()
        values.append(value)
        events.append(event)
    done = int(w["k"] >= nc or err != 0)
    st = [state - (1 << 32) if state >= (1 << 31) else state, bitpos, w["k"], w["cyxb"], nzrem,
          ii, err, prev, w["x8"], w["y8"], gw8, ctxoff, done, 0, 0, 0, *cring]
    return np.asarray(st, np.int64), values, events


def model_planes(d: dict, lane: int, init, values, out: np.ndarray) -> None:
    """What the walking warp writes: the values walked from the snapshot
    `init` (walk_block's structure walk), scattered at natural positions."""
    k, cyxb, nzrem, ii = (int(v) for v in init[2:6])
    nat = d["nat"]
    for value in values:
        if nzrem == 0:
            if value > 0:
                nzrem, ii = value, 1
                if value > 63:
                    return
                continue
        else:
            c = YXB2XYB[cyxb]
            if value:
                out[c, k, nat[c, ii & 63]] = (value >> 1) if not value & 1 else -(value >> 1) - 1
            nzrem -= value != 0
            ii += 1
            if nzrem and ii < 64:
                continue
            if nzrem:
                return
        cyxb += 1
        if cyxb == 3:
            cyxb, k = 0, k + 1


def same_snapshot(a, b) -> bool:
    """Two B5 snapshot columns agree: every row, and `ii` (row 5) only where
    `err` (row 6) is 0 (the plain walk goes on advancing a stopped lane's
    ii while other lanes walk; the kernel keeps it)."""
    a, b = [int(x) for x in a], [int(x) for x in b]
    if a[6]:
        a[5] = b[5]
    return a == b


def check_model(d: dict, cap: int, init=None, out=None):
    """The model on every lane against hf_ctx_walk_ref from `init` (default
    the packed start), planes and snapshots; returns (ref snapshot (112, L),
    ref planes, per-lane events)."""
    t = HK.to_device(d, "cpu")
    init = t["init"] if init is None else init
    out = torch.zeros((d["L"], 3, d["ncmax"], 64)) if out is None else out
    want_out, want_st = HK.launch_hf_ctx(t, d["ncmax"], d["nb"], cap_steps=cap, init=init,
                                         out=out.clone(), walk=HK.hf_ctx_walk_ref)
    got_out = out.clone().numpy()
    events = []
    for lane in range(d["L"]):
        st, values, ev = model_walk(d, lane, cap, init[:, lane].numpy())
        model_planes(d, lane, init[:, lane].numpy(), values, got_out[lane])
        assert same_snapshot(st, want_st[:, lane]), (lane, st[:13], want_st[:13, lane])
        events.append(ev)
    np.testing.assert_array_equal(got_out, want_out.numpy())
    return want_st, want_out, events


@pytest.mark.parametrize("name", list(CASES))
def test_lookahead_model_uncapped(name):
    st, _, events = check_model(ctx_case(name), 10**6)
    assert st[HK.CTX_DONE_ROW].all()
    assert bool(st[6, 0]) == (name in ("ctx_count_above_63", "ctx_overrun"))
    if name == "ctx_blocks":
        assert len(events[2]) > 1024  # past the kernel's value ring
        assert not st[6].any() and (st[0].numpy().view(np.uint32) == 0x130000).all()


@pytest.mark.parametrize("where", ["count", "coef", "channel", "cell"])
def test_lookahead_model_capped_and_resumed(where):
    """Capped right after a value of each kind on lane 0 (a nonzero count, a
    coefficient inside a block, a block's end inside the cell, a cell's
    end), then resumed from the plain version's snapshot to the end."""
    d = ctx_case("ctx_blocks")
    _, _, events = model_walk(d, 0, 10**6, d["init"][:, 0])
    hits = [i for i, e in enumerate(events) if e == where]
    st, out, _ = check_model(d, hits[len(hits) // 2] + 1)
    assert not st[HK.CTX_DONE_ROW, 0]
    st2, _, _ = check_model(d, 10**6, init=st, out=out)
    assert st2[HK.CTX_DONE_ROW].all()


@pytest.mark.parametrize("name", ["ctx_count_above_63", "ctx_overrun"])
def test_lookahead_model_corrupt_capped(name):
    """The corrupt lane capped just before, at and after its fault."""
    d = ctx_case(name)
    n = len(model_walk(d, 0, 10**6, d["init"][:, 0])[1])
    for cap in (n - 1, n, n + 1):
        st, out, _ = check_model(d, cap)
        check_model(d, 10**6, init=st, out=out)
