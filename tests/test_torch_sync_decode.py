"""The self-synchronising decode of prefix-coded entropy lanes (the sync
design of kernels B6 and B4, csrc/prefix_sync.cuh), modelled in numpy phase
by phase and held against the plain versions `decode_tokens_ref` and
`hf_walk_ref`: the values, the final bit positions, B4's coefficient planes
and snapshots must be EQUAL.

The model follows the kernels step for step: the lane's region (its start
to its section's end, `nbits`, or without it to its last nonzero word),
subsequences of SUB bits (multiples of m bits
for a single-symbol code with m extra bits; a constant lane when m = 0),
the skim with the fused first round of the chase, the chase to a fixed
point, the prefix sum, the write with its unbounded last subsequence, and
for B4 the structure pass, block by block as one warp takes it (a 64-bit
nonzero mask per block, the end at its nzrem-th set bit), with its serial
tail and the bit position after the last symbol walked.

The synthetic lanes here (a code that never falls into step, single-symbol
codes, short and ragged lanes, runs of the all-zero codeword inside and at
the end of a section, caps inside a subsequence, a resumed walk, a count
above 63, an overrun) also go through the kernels on the card in
tests/test_torch_cuda.py.  Where a lane stops on a count above 63, the plain
walk (as JAX's lockstep) goes on advancing its `ii` while other lanes walk,
and the kernels keep it: `ii` is compared where `err` is 0 (the decode
raises on an err lane before it reads anything else of it).  The real lanes give the sync distances that fix
SUB: the statistics are counts, not times.
"""

import heapq

import numpy as np
import pytest
import torch

from j40_tpu_torch.decode import Decoder
from j40_tpu_torch.encode.encoder import EncodeOptions, encode_modular
from j40_tpu_torch.encode.vardct_enc import encode_vardct
from j40_tpu_torch.ops import device_modular as DM
from j40_tpu_torch.ops import device_vardct as DV
from j40_tpu_torch.ops import hf_kernels as HK
from j40_tpu_torch.ops import token_kernels as TKN
from j40_tpu_torch.ops.hf_kernels import to_device

SUB = 256  # csrc/prefix_sync.cuh kSub
MAX_SYMBOL_BITS = 33

# ---------------------------------------------------------------- the model


class Lane:
    """One lane's stream and its fused table: per prefix slot the code
    length, the extra bits and the value's base (tokens.cu / hf.cu fuse)."""

    def __init__(self, words, s0, n, length, mb, base, lsb, bits=None):
        w = [int(x) for x in np.asarray(words).astype(np.int64) & 0xFFFF] + [0, 0, 0]
        self.win = [w[i] | (w[i + 1] << 16) | (w[i + 2] << 32) for i in range(len(w) - 2)]
        nz = np.flatnonzero(np.asarray(words))
        # the region's end: the section's, else the last nonzero word's
        self.end = (16 * (int(nz[-1]) + 1 if len(nz) else 0) if bits is None
                    else min(int(bits), 16 * len(words)))
        self.s0, self.n, self.lsb = int(s0), int(n), int(lsb)
        self.len, self.mb, self.base = list(length), list(mb), list(base)
        self.mask = len(self.len) - 1

    def peek(self, pos):
        return self.win[pos >> 4] >> (pos & 15) if (pos >> 4) < len(self.win) else 0

    def symbol(self, pos):
        """(bits, value) of the codeword at pos."""
        i = self.peek(pos) & self.mask
        ln, mb = self.len[i], self.mb[i]
        mid = (self.peek(pos + ln) & ((1 << mb) - 1)) if mb else 0
        return ln + mb, self.base[i] | (mid << self.lsb)

    def skim(self, a, lim):
        pos, c = a, 0
        while pos < lim:
            pos += self.len[self.peek(pos) & self.mask] + self.mb[self.peek(pos) & self.mask]
            c += 1
        return pos, c


def sync_model(ln: Lane, tokens: bool):
    """Phases 1-3 of one lane.  Returns dict(values, bitpos (B6: after symbol
    n-1), T and tail (B4), F, E, nsub, stats)."""
    s0, n = ln.s0, ln.n
    re = min(ln.end, s0 + MAX_SYMBOL_BITS * n)
    single = ln.len[0] == 0
    m = ln.mb[0]
    zero = single and m == 0
    sl = m * -(-SUB // m) if single and m > 0 else SUB
    nsub = 1 if zero or re <= s0 else -(-(re - s0) // sl)
    P, E, C = [0] * nsub, [0] * nsub, [0] * nsub
    for j in range(nsub - 1):
        P[j], c = ln.skim(s0 + j * sl, s0 + (j + 1) * sl)
        if j == 0:
            E[0], C[0] = P[0], c
        if j + 1 < nsub - 1:
            E[j + 1], C[j + 1] = ln.skim(P[j], s0 + (j + 2) * sl)
    X = [int(0 < j and E[j] != P[j]) for j in range(nsub - 1)]
    rnd, chase, redecoded = 1, int(any(X)), 0
    moved = any(X)
    while moved:
        rnd += 1
        pend = {j: ln.skim(E[j - 1], s0 + (j + 1) * sl)
                for j in range(1, nsub - 1) if X[j - 1] == rnd - 1}
        redecoded += len(pend)
        moved = False
        for j, (e, c) in pend.items():
            C[j] = c
            if e != E[j]:
                E[j], X[j], moved = e, rnd, True
        if moved:
            chase = rnd
    F = list(np.concatenate([[0], np.cumsum(C[: nsub - 1])]).astype(int)) if nsub > 1 else [0]
    out = dict(F=F, E=E, nsub=nsub, zero=zero,
               stats=dict(rounds=rnd, chase=chase, redecoded=redecoded, subs=nsub))
    if zero:
        out.update(values=[ln.base[0]] * n, bitpos=s0, T=n, tail=s0)
        return out
    values = [0] * n
    out.update(bitpos=s0, T=n, tail=s0)
    for j in range(nsub):
        f, last = F[j], j == nsub - 1
        if f >= n:
            continue
        pos = s0 if j == 0 else E[j - 1]
        cnt = n - f if last else C[j]
        i = 0
        while i < cnt and f + i < n:
            if not tokens and last and pos >= re:
                break
            bits, values[f + i] = ln.symbol(pos)
            pos += bits
            i += 1
        if tokens and f + i == n:
            out["bitpos"] = pos
        if not tokens and last:
            out.update(T=f + i, tail=pos)
    out["values"] = values
    return out


def pos_after(ln: Lane, res, idx):
    """The bit position after symbol idx, from the subsequence holding it."""
    if res["zero"]:
        return ln.s0
    F = res["F"]
    j = max(k for k in range(res["nsub"]) if F[k] <= idx)
    pos = ln.s0 if j == 0 else res["E"][j - 1]
    for _ in range(F[j], idx + 1):
        pos += ln.symbol(pos)[0]
    return pos


def structure_model(ln: Lane, res, snap, nc, nat, cap, planes):
    """B4's structure pass over the values of `res` from the snapshot
    (state, bitpos, k, cyxb, nzrem, ii, err): writes `planes` (3, ncmax, 64)
    and returns the new snapshot's first 8 rows."""
    state, bitpos0, k, cyxb, nzrem, ii, err = (int(x) for x in snap[:7])
    vals, T = res["values"], res["T"]
    p = 0

    def next_channel():
        nonlocal cyxb, k
        cyxb += 1
        if cyxb == 3:
            cyxb, k = 0, k + 1

    def coefficient(v):  # walk_step's second branch, one symbol
        nonlocal nzrem, ii, err
        c = (1, 0, 2)[cyxb]
        if v:
            planes[c, k, nat[c, ii & 63]] = -(v >> 1) - 1 if v & 1 else v >> 1
        nzrem -= v != 0
        ii += 1
        if ii >= 64 and nzrem > 0:
            nzrem, err = 0, 1
        if nzrem == 0:
            next_channel()

    while k < nc and err == 0 and p < cap and p < T:
        if nzrem == 0:
            v = vals[p]
            err |= v > 63
            if v > 0:
                nzrem, ii = v, 1
            else:
                next_channel()
            p += 1
            continue
        avail = min(64 - ii, T - p, cap - p)
        mask = sum(1 << d for d in range(avail) if vals[p + d])
        found = bin(mask).count("1")
        if found >= nzrem:  # the nzrem-th set bit ends the block
            run = [d for d in range(64) if mask >> d & 1][nzrem - 1] + 1
        else:
            run = avail
        for d in range(run):
            coefficient(vals[p + d])
        p += run
    if k < nc and err == 0 and p < cap:  # the serial tail
        pos = res["tail"]
        while p < cap and k < nc and err == 0:
            bits, v = ln.symbol(pos)
            pos += bits
            p += 1
            if nzrem == 0:
                err |= v > 63
                if v > 0:
                    nzrem, ii = v, 1
                else:
                    next_channel()
            else:
                coefficient(v)
        bitpos = pos
    else:
        bitpos = bitpos0 if p == 0 else pos_after(ln, res, p - 1)
    return [state, bitpos, k, cyxb, nzrem, ii, err, int(k >= nc or err != 0)]


# ---------------------------------------------------------------- lanes


def token_lanes(d: dict, n_steps=None) -> list[Lane]:
    """The model's lanes of a packed token input (build_lane_inputs)."""
    n_steps = d["n_steps"] if n_steps is None else n_steps
    C = d["lsb"].shape[1]
    S, amax = d["sym"].shape[1] // C, d["mb"].shape[1] // C
    out = []
    for l in range(d["words"].shape[0]):
        r = d["rows"][l]
        e = d["sym"][r, :S].astype(np.int64)
        tok = e & 0xFFFF
        mb = d["mb"][r, tok].astype(np.int64)
        base = (d["a"][r, tok].astype(np.int64) << mb) | d["lo"][r, tok]
        out.append(Lane(d["words"][l], d["skips"][l], min(int(d["nsym"][l]), n_steps),
                        e >> 16, mb, base, d["lsb"][r, 0], _bits(d, l)))
    return out


def hf_lanes(d: dict, init, cap) -> list[Lane]:
    """The model's lanes of a packed B4 prefix input (build_multi_inputs)
    from the snapshot `init`."""
    S = 1 << d["prefix_width"]
    out = []
    for l, cfg in enumerate(d["lane"].astype(np.int64)):
        lsb, split, bits, base_mid, msb = cfg[3:]
        e = d["lut"][cfg[0]: cfg[0] + S].astype(np.int64)
        tok = e & 0xFFFF
        lit = tok < split
        mb = np.where(lit, 0, base_mid + ((tok - split).clip(0) >> bits))
        a = ((1 << msb) | ((tok >> lsb) & ((1 << msb) - 1))) << lsb
        base = np.where(lit, tok, (a << mb) | (tok & ((1 << lsb) - 1)))
        k, nc = int(init[2, l]), int(d["nc"][l])
        n = min(cap, 192 * (nc - k)) if k < nc and init[6, l] == 0 else 0
        out.append(Lane(d["words"][l], init[1, l], n, e >> 16, mb, base, lsb, _bits(d, l)))
    return out


def _bits(d: dict, l: int):
    return None if d.get("nbits") is None else int(d["nbits"][l])


def _canonical(lengths: dict) -> dict:
    """LSB-first codeword bits of a canonical prefix code {symbol: length}."""
    code, prev, pat = 0, 0, {}
    for s in sorted(lengths, key=lambda s: (lengths[s], s)):
        code <<= lengths[s] - prev
        prev = lengths[s]
        pat[s] = int(format(code, f"0{prev}b")[::-1], 2) if prev else 0
        code += 1
    return pat


def _huffman(counts: dict) -> dict:
    if len(counts) == 1:
        return {s: 0 for s in counts}
    heap = [(c, i, [s]) for i, (s, c) in enumerate(sorted(counts.items()))]
    heapq.heapify(heap)
    depth = dict.fromkeys(counts, 0)
    while len(heap) > 1:
        c1, i1, a = heapq.heappop(heap)
        c2, _, b = heapq.heappop(heap)
        for s in a + b:
            depth[s] += 1
        heapq.heappush(heap, (c1 + c2, i1, a + b))
    return depth


def _bits_to_words(bits, pad_words=16):
    bits = np.concatenate([bits, np.zeros(-len(bits) % 16, np.uint8)]).astype(np.int64)
    w = (bits.reshape(-1, 16) << np.arange(16)).sum(1)
    return np.concatenate([w, np.zeros(pad_words, np.int64)]).astype(np.uint16)


def _encode(rng, toks, lengths, mbs, skip):
    pat = _canonical(lengths)
    out = list(rng.integers(0, 2, skip))
    for t in toks:
        out += [(pat[t] >> b) & 1 for b in range(lengths[t])]
        mid = int(rng.integers(0, 1 << mbs[t])) if mbs[t] else 0
        out += [(mid >> b) & 1 for b in range(mbs[t])]
    return np.asarray(out, np.uint8)


def _lut(lengths, width):
    lut = np.full(1 << width, -1, np.int64)
    for s, p in _canonical(lengths).items():
        lut[p:: 1 << lengths[s]] = (lengths[s] << 16) | s
    assert (lut >= 0).all()
    return lut.astype(np.int32)


#: synthetic token cases: per lane (code lengths, extra bits per token, symbols)
def _token_case(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    skewed = {s: len_ for s, len_ in _huffman({s: 2 ** (s % 7) + 1 for s in range(40)}).items()}
    mbs = {s: (s % 5) * 2 if s > 20 else 0 for s in range(40)}
    # fixed-length codes: a decode out of phase never falls into step (17-bit
    # codewords are in phase at subsequence j only for j = 0 mod 17)
    uni = {s: 3 for s in range(8)}
    # flat content: symbol 0 takes the all-zero codeword (1 or 2 bits), in
    # runs inside the section and at its end (the trailing words are zero)
    one, two = {0: 1, 1: 2, 2: 3, 3: 3}, {0: 2, 1: 2, 2: 2, 3: 3, 4: 3}
    runs = [300, 3000, 200, 4000]  # random symbols, zeros, random, zeros
    spec = {
        "never_in_step": [({0: 1, 1: 1}, {0: 16, 1: 16}, 3000),
                          (uni, dict.fromkeys(uni, 0), 900)],
        "single_zero_bits": [({5: 0}, {5: 0}, 1200), (skewed, mbs, 800)],
        "single_extra_bits": [({9: 0}, {9: 5}, 1500), ({9: 0}, {9: 7}, 17)],
        "short": [(skewed, mbs, 9), (skewed, mbs, 1), (skewed, mbs, 0)],
        "ragged": [(skewed, mbs, 4000), (skewed, mbs, 3), (skewed, mbs, 700)],
        "zero_runs": [(one, dict.fromkeys(one, 0), runs), (two, dict.fromkeys(two, 0), runs),
                      (two, dict.fromkeys(two, 0), runs)],
    }[name]
    lanes = []
    for li, (lengths, mb, count) in enumerate(spec):
        p = np.array([2.0 ** -lengths[s] if lengths[s] else 1.0 for s in lengths])
        if isinstance(count, int):
            toks = rng.choice(list(lengths), size=count, p=p / p.sum())
        else:
            toks = np.concatenate([rng.choice(list(lengths), size=c, p=p / p.sum()) if i % 2
                                   else np.zeros(c, np.int64) for i, c in enumerate(count, 1)])
        skip = int(rng.integers(0, 16)) if li else 5
        if name == "zero_runs" and li == 2:  # lane 1 three bits later: the runs' other phase
            toks, skip = np.concatenate([[3], lanes[1][2]]), lanes[1][3]
        lanes.append((lengths, mb, toks, skip))
    return lanes


def token_case(name) -> dict:
    """A packed token input (build_lane_inputs' format, one table row a lane)
    of the synthetic case `name`."""
    rng = np.random.default_rng(1)
    lanes = _token_case(name)
    width = max(1, max(max(ln[0].values()) for ln in lanes))
    amax = 64
    bits = [_encode(rng, toks, lengths, mb, skip) for lengths, mb, toks, skip in lanes]
    W = max(-(-len(b) // 16) for b in bits) + 16
    words = np.stack([np.concatenate([w := _bits_to_words(b, 0), np.zeros(W - len(w), np.uint16)])
                      for b in bits])
    R = len(lanes)
    mb_t = np.zeros((R, amax), np.int32)
    for r, (_, mb, _, _) in enumerate(lanes):
        for s, v in mb.items():
            mb_t[r, s] = v
    a = np.tile(np.arange(amax, dtype=np.int32) + 1, (R, 1))
    lo = np.tile(np.arange(amax, dtype=np.int32) & 3, (R, 1))
    nsym = np.array([len(ln[2]) for ln in lanes], np.int32)
    return dict(words=words, skips=np.array([ln[3] for ln in lanes], np.int32),
                nbits=np.array([8 * -(-len(b) // 8) for b in bits], np.int32), nsym=nsym,
                rows=np.arange(R, dtype=np.int32),
                sym=np.stack([_lut(ln[0], width) for ln in lanes]),
                fb=np.zeros((R, 1), np.int32), mb=mb_t, a=a, lo=lo,
                lsb=np.full((R, 1), 2, np.int32), cids=None, use_prefix=True,
                n_steps=int(nsym.max()))


def _blocks(rng, ncells, bad=None):
    """Values of a DCT8 section: per cell and channel a nonzero count, then
    the coefficients up to the last nonzero.  bad: (block, "count" |
    "overrun") corrupts one block."""
    vals = []
    for b in range(3 * ncells):
        nz = int(rng.integers(0, 12)) if rng.random() < 0.7 else 0
        if bad and bad[0] == b and bad[1] == "count":
            vals.append(70)
            break
        pos = np.sort(rng.choice(np.arange(1, 64), nz, replace=False))
        if bad and bad[0] == b and bad[1] == "overrun":
            vals += [nz + 2] + [1 if i in pos else 0 for i in range(1, 64)]
            break
        vals.append(nz)
        if nz:
            vals += [int(rng.integers(1, 30)) if i in pos else 0
                     for i in range(1, int(pos[-1]) + 1)]
    return vals


def hf_case(name) -> dict:
    """A packed B4 prefix input (build_multi_inputs' format) of synthetic
    DCT8 sections: tokens are the values (split above every token)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    ncells = {"hf_blocks": [40, 6, 90], "hf_count_above_63": [20, 30],
              "hf_overrun": [25, 12]}[name]
    bad = {"hf_count_above_63": (31, "count"), "hf_overrun": (17, "overrun")}.get(name)
    seqs = [_blocks(rng, nc, bad if li == 0 else None) for li, nc in enumerate(ncells)]
    counts: dict = {}
    for s in seqs:
        for v in s:
            counts[v] = counts.get(v, 0) + 1
    lengths = _huffman(counts)
    width = max(lengths.values())
    assert width <= HK.MAX_PREFIX_WIDTH
    bits = [_encode(rng, s, lengths, dict.fromkeys(lengths, 0), 3 + li)
            for li, s in enumerate(seqs)]
    W = max(-(-len(b) // 16) for b in bits) + 16
    words = np.stack([np.concatenate([w := _bits_to_words(b, 0), np.zeros(W - len(w), np.uint16)])
                      for b in bits])
    L = len(seqs)
    lut = _lut(lengths, width)
    init = np.zeros((HK.ST_ROWS, L), np.int32)
    init[1] = [3 + li for li in range(L)]
    nat = np.stack([np.stack([rng.permutation(64) for _ in range(3)]) for _ in range(L)])
    lane = np.tile(np.array([0, len(lut), 0, 0, 1 << 12, 0, 12, 0], np.int32), (L, 1))
    return dict(words=words, init=init, nc=np.array(ncells, np.int32), lut=lut,
                lane=lane, nat=nat.astype(np.int32),
                nbits=np.array([8 * -(-len(b) // 8) for b in bits], np.int32), use_prefix=True,
                prefix_width=width, L=L, ncells_all=ncells, max_bytes=2 * W)


def hf_ans_case(name) -> dict:
    """A packed B4 rANS input (build_multi_inputs' format) of the same kind of
    synthetic sections, from the port's rANS encoder: the first lane holds
    more values than the rANS design's ring (1,024)."""
    from j40_tpu_torch.encode.bitwriter import BitWriter
    from j40_tpu_torch.encode.entropy import EntropyEncoder
    from j40_tpu_torch.entropy.code import read_code_spec
    from j40_tpu_torch.io.bits import BitReader

    rng = np.random.default_rng(sum(map(ord, name)))
    ncells = [60, 9]
    bad = {"hf_ans_count_above_63": (150, "count"), "hf_ans_overrun": (140, "overrun")}.get(name)
    seqs = [_blocks(rng, nc, bad if li == 0 else None) for li, nc in enumerate(ncells)]
    enc = EntropyEncoder(1, use_prefix=False)
    for li, vals in enumerate(seqs):
        enc.add_array(0, np.asarray(vals, np.int64), stream=li)
    streams = []
    for li in range(len(seqs)):
        w = BitWriter()
        enc.write_spec(w)
        enc.write_tokens(w, stream=li)
        data = w.finish()
        r = BitReader(data)
        spec = read_code_spec(r, 1)
        streams.append((data, r.bits_consumed))
    assert not spec.use_prefix_code and HK.hf_spec_is_device_simple(spec)
    orders = np.stack([rng.permutation(64) for _ in range(3)]).astype(np.int32)
    return HK.build_multi_inputs([(streams, ncells, spec, orders)])


# ---------------------------------------------------------------- checks


def check_tokens(d: dict, n_steps=None):
    """The model against decode_tokens_ref; returns the lanes' statistics."""
    dt = to_device(d, "cpu")
    vals, _, bp = (t.numpy() for t in TKN.launch_tokens(dt, n_steps, decode=TKN.decode_tokens_ref))
    stats = []
    for l, ln in enumerate(token_lanes(d, n_steps)):
        res = sync_model(ln, tokens=True)
        np.testing.assert_array_equal(vals[l, : ln.n], res["values"])
        assert not vals[l, ln.n:].any()
        assert bp[l] == res["bitpos"], (l, bp[l], res["bitpos"])
        stats.append(res["stats"])
    return stats


def same_snapshot(a, b) -> bool:
    """Two B4 snapshots (8 rows of a lane) agree: every row, and `ii` (row
    5) only where `err` (row 6) is 0."""
    a, b = [int(x) for x in a], [int(x) for x in b]
    if a[6]:
        a[5] = b[5]
    return a == b


def check_hf(d: dict, cap: int, init=None):
    """The model against hf_walk_ref from `init`; returns (snapshot, stats)."""
    dt = to_device(d, "cpu")
    ncmax = max(d["ncells_all"])
    init = d["init"] if init is None else init
    out = torch.zeros((d["L"], 3, ncmax, 64))
    st = HK.hf_walk_ref(dt["words"], torch.from_numpy(init), dt["nc"], dt["lut"],
                        dt["lane"], dt["nat"], out, cap, True, d["prefix_width"]).numpy()
    stats = []
    for l, ln in enumerate(hf_lanes(d, init, cap)):
        res = sync_model(ln, tokens=False)
        planes = np.zeros((3, ncmax, 64), np.float32)
        snap = structure_model(ln, res, init[:, l], int(d["nc"][l]), d["nat"][l], cap, planes)
        np.testing.assert_array_equal(planes, out[l].numpy())
        assert same_snapshot(snap, st[:8, l]), (l, snap, st[:8, l])
        stats.append(res["stats"])
    return st, stats


TOKEN_CASES = ["never_in_step", "single_zero_bits", "single_extra_bits", "short", "ragged",
               "zero_runs"]


@pytest.mark.parametrize("name", TOKEN_CASES)
def test_token_cases(name):
    d = token_case(name)
    stats = check_tokens(d)
    for cap in (1, 40, 257):  # caps inside a subsequence
        check_tokens(d, cap)
    # without the section lengths the region ends at the last nonzero word
    nb_stats = check_tokens(dict(d, nbits=None))
    if name == "never_in_step":  # an exact serial chase through the lane
        assert stats[0]["chase"] >= stats[0]["subs"] - 3 > 180
    if name == "single_extra_bits":  # subsequences on codeword boundaries
        assert all(s["chase"] == 0 for s in stats)
    if name == "zero_runs":
        # the 1-bit zero codeword is in step everywhere; the 2-bit one puts
        # every start in a run in one phase, so one of the two lanes chases
        # through its runs one subsequence a round
        assert stats[0]["chase"] <= 3
        assert max(stats[1]["chase"], stats[2]["chase"]) >= 20
        # the trailing zeros are inside the region only with the lengths
        assert all(a["subs"] > b["subs"] for a, b in zip(stats, nb_stats))


@pytest.mark.parametrize("name", ["hf_blocks", "hf_count_above_63", "hf_overrun"])
def test_hf_cases(name):
    d = hf_case(name)
    st, _ = check_hf(d, 10**6)
    assert st[7].all()
    assert bool(st[6, 0]) == (name != "hf_blocks")
    for cap in (1, 37, 200):
        st, _ = check_hf(d, cap)
        if name == "hf_blocks":
            check_hf(d, 10**6, init=st)  # resumed from a mid-lane snapshot


@pytest.mark.parametrize("name", ["hf_ans_blocks", "hf_ans_count_above_63", "hf_ans_overrun"])
def test_hf_ans_cases(name):
    """The rANS sections the card tests hold B4's rANS design to: every lane
    ends, the corrupt one flagged, the first lane longer than the ring."""
    d = hf_ans_case(name)
    _, st = HK.launch_hf(to_device(d, "cpu"), max(d["ncells_all"]), walk=HK.hf_walk_ref)
    st = st.numpy()
    assert st[HK.DONE_ROW].all() and list(st[6]) == [int(not name.endswith("blocks")), 0]
    n0 = HK.launch_hf(to_device(d, "cpu"), max(d["ncells_all"]), cap_steps=1100,
                      walk=HK.hf_walk_ref)[1].numpy()
    assert not n0[HK.DONE_ROW, 0]  # more than 1,100 symbols in the first lane


def _modular_lanes():
    data = encode_modular(
        (np.cumsum(np.cumsum(np.random.default_rng(7).integers(-2, 3, (48, 256, 3)), 0), 1)
         % 256).astype(np.uint8), options=EncodeOptions(group_size_shift=7, global_tree=True))
    dec = Decoder(data, backend="numpy", max_passes=0)
    dec.decode_frame(_defer_finish=True)
    f, toc, state = dec._deferred
    lanes = DM.plan_lanes(dec, state, [s for s in toc.sections if s.pass_ == 0])
    assert lanes and all(ln.spec.use_prefix_code and ln.ctx is None for ln in lanes)
    return DM.pack_lanes(lanes)


def _vardct_lanes():
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:64, 0:600].astype(np.float32)
    img = np.stack([96 + 60 * np.sin(xx / 29) * np.cos(yy / 23) + 10 * np.sin(xx / (9 + 2 * c))
                    + rng.normal(0, 4, (64, 600)) for c in range(3)], -1)
    dec = Decoder(encode_vardct(img.clip(0, 255).astype(np.uint8)), device="cpu",
                  max_passes=0)
    dec.decode_frame(_defer_finish=True)
    f, toc, state = dec._deferred
    spec, ctx, lanes, orders = DV.hf_lanes(dec, state, f,
                                           [s for s in toc.sections if s.pass_ == 0])
    assert not ctx and spec.use_prefix_code
    return HK.build_multi_inputs([([(ln.data, ln.bitoff) for ln in lanes],
                                   [ln.gw8 * ln.gh8 for ln in lanes], spec, orders)])


def _sync_distances(ln: Lane, res):
    """Symbols from each subsequence's start to its first true boundary."""
    true, pos = set(), ln.s0
    for _ in range(ln.n):
        true.add(pos)
        pos += ln.symbol(pos)[0]
    out = []
    sl = SUB
    for j in range(1, res["nsub"] - 1):
        p, c = ln.s0 + j * sl, 0
        while p not in true and p < ln.s0 + (j + 1) * sl + 64:
            p += ln.symbol(p)[0]
            c += 1
        out.append(c if p in true else None)
    return out


def test_real_lanes_sync_distances():
    """Real lanes of the port's encoders (128-pixel groups): the model
    equals the plain versions, and a decode started at a subsequence's
    start falls into step within a few symbols, inside its own 256 bits."""
    d = _modular_lanes()
    stats = check_tokens(d)
    dists = []
    for ln in token_lanes(d):
        dists += _sync_distances(ln, sync_model(ln, tokens=True))
    hd = _vardct_lanes()
    _, hstats = check_hf(hd, 10**6)
    for ln in hf_lanes(hd, hd["init"], 10**6):
        dists += _sync_distances(ln, sync_model(ln, tokens=False))
    assert len(dists) > 100
    inside = [x for x in dists if x is not None]
    assert len(inside) >= 0.95 * len(dists)
    assert np.median(inside) <= 8 and max(inside) <= 60
    assert max(s["chase"] for s in stats + hstats) <= 3
