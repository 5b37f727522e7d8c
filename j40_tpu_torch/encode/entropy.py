"""Encoder-side entropy coding: the dual of j40_tpu.entropy.

Builds length-limited Huffman codes / ANS distributions from histograms and
emits spec-compliant code-spec headers plus token streams that the decoder
(and the reference dj40) accept.  Token collection is two-phase: callers
record (ctx, value) pairs in decode order, then `write` emits the whole
stream.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..entropy.ans import ANS_INIT_STATE, AnsEncoder, DIST_BITS, DIST_SUM
from ..entropy.hybrid import HybridIntConfig, encode_hybrid_int
from ..entropy.prefix import L0_LENGTHS, L1_ZIGZAG, PrefixCode
from .bitwriter import BitWriter


def huffman_lengths(freqs: list[int], limit: int) -> list[int]:
    """Length-limited Huffman code lengths via package-merge."""
    idx = [i for i, f in enumerate(freqs) if f > 0]
    lengths = [0] * len(freqs)
    if not idx:
        return lengths
    if len(idx) == 1:
        lengths[idx[0]] = 1
        return lengths
    if len(idx) > (1 << limit):
        raise ValueError("alphabet too large for length limit")
    # package-merge: items are (freq, {sym: count}) coins
    coins = sorted((freqs[i], (i,)) for i in idx)
    packages: list[tuple[int, tuple]] = coins
    for _ in range(limit - 1):
        merged = [
            (packages[k][0] + packages[k + 1][0], packages[k][1] + packages[k + 1][1])
            for k in range(0, len(packages) - 1, 2)
        ]
        packages = sorted(coins + merged)
    # take the first 2*(n-1) items of the final row
    need = 2 * (len(idx) - 1)
    for _, syms in packages[:need]:
        for s in syms:
            lengths[s] += 1
    return lengths


def _write_prefix_symbol(w: BitWriter, code: PrefixCode, sym: int, codes: dict) -> None:
    if code.single_symbol is not None:
        return
    length, pattern = codes[sym]
    w.u(length, pattern)


def prefix_codewords(code: PrefixCode) -> dict[int, tuple[int, int]]:
    """symbol -> (length, LSB-first pattern)."""
    out = {}
    for l in range(1, code.max_len + 1):
        for pattern, sym in code.by_len[l].items():
            out[sym] = (l, pattern)
    return out


def write_prefix_code_header(w: BitWriter, lengths: list[int], alphabet_size: int) -> None:
    """Emit an RFC7932-style prefix code header for the given code lengths."""
    assert len(lengths) == alphabet_size
    if alphabet_size == 1:
        return  # zero-bit code, no header at all
    nonzero = [(s, l) for s, l in enumerate(lengths) if l > 0]
    nsym = len(nonzero)
    if nsym == 1:
        # simple code with one symbol
        w.u(2, 1)  # hskip=1 → simple
        w.u(2, 0)  # nsym-1
        w.at_most(alphabet_size - 1, nonzero[0][0])
        return
    if nsym <= 4:
        simple = {
            2: (1, 1),
            3: (1, 2, 2),
            4: (2, 2, 2, 2),
        }
        tree_sel = (1, 2, 3, 3)
        lens = sorted(l for _, l in nonzero)
        if nsym == 4 and lens == sorted(tree_sel):
            w.u(2, 1)
            w.u(2, 3)
            # list symbols so that template positions line up: template lengths
            # (1,2,3,3) applied to listed syms, equal lengths sorted by value
            order = sorted(nonzero, key=lambda p: (p[1], p[0]))
            for s, _ in order:
                w.at_most(alphabet_size - 1, s)
            w.u(1, 1)  # tree-select
            return
        if tuple(lens) == simple.get(nsym, ()):
            w.u(2, 1)
            w.u(2, nsym - 1)
            order = sorted(nonzero, key=lambda p: (p[1], p[0]))
            for s, _ in order:
                w.at_most(alphabet_size - 1, s)
            if nsym == 4:
                w.u(1, 0)  # no tree-select
            return
        # fall through to the complex encoding for irregular small codes

    # complex code: emit layer-2 lengths with 16/17 RLE, then Huffman-code the
    # emitted symbol stream with a layer-1 code (limit 5), header via L0 code.
    l2_syms: list[tuple[int, int]] = []  # (code, extra_bits_value_or_-1)
    i = 0
    n = alphabet_size
    # trim trailing zeros: the reader stops once total reaches the Kraft sum
    while n > 0 and lengths[n - 1] == 0:
        n -= 1
    while i < n:
        l = lengths[i]
        run = 1
        while i + run < n and lengths[i + run] == l:
            run += 1
        if l == 0:
            # runs of zeros via code 17 (3+u(3) zeros); separate consecutive
            # 17s with a literal zero so the reader never chains (its chaining
            # formula compounds repeat counts, j40.h:2168-2172)
            rem = run
            while rem:
                if rem >= 3:
                    take = min(rem, 10)
                    l2_syms.append((17, take - 3))
                    rem -= take
                    if rem:
                        l2_syms.append((0, -1))
                        rem -= 1
                else:
                    l2_syms.append((0, -1))
                    rem -= 1
            i += run
        else:
            # literal, then runs of the same length via code 16 (3+u(2)),
            # likewise chain-broken with literals
            l2_syms.append((l, -1))
            rem = run - 1
            while rem:
                if rem >= 3:
                    take = min(rem, 6)
                    l2_syms.append((16, take - 3))
                    rem -= take
                    if rem:
                        l2_syms.append((l, -1))
                        rem -= 1
                else:
                    l2_syms.append((l, -1))
                    rem -= 1
            i += run

    # layer-1 histogram & code
    hist = [0] * 18
    for c, _ in l2_syms:
        hist[c] += 1
    l1_lengths = huffman_lengths(hist, 5)
    if sum(1 for x in l1_lengths if x) == 1:
        # a single layer-1 symbol cannot form a complete 5-bit code; add a
        # second dummy: give the symbol length 1 is invalid too (sum 16 != 32).
        # Use lengths {sym:1, other:1} by promoting an unused close symbol.
        only = next(s for s, x in enumerate(l1_lengths) if x)
        other = 17 if only != 17 else 16
        l1_lengths[only] = 1
        l1_lengths[other] = 1
        # ensure `other` decodes harmlessly: it never appears in l2_syms
    l1_code = PrefixCode.from_lengths(l1_lengths)
    l1_codewords = prefix_codewords(l1_code)

    w.u(2, 0)  # hskip=0 → complex
    # layer-1 lengths via fixed L0 code, zigzag order, stop at Kraft completion
    l0 = PrefixCode.from_lengths(list(L0_LENGTHS))
    l0_codewords = prefix_codewords(l0)
    total = 0
    for zz in L1_ZIGZAG:
        l = l1_lengths[zz]
        ln, pat = l0_codewords[l]
        w.u(ln, pat)
        if l:
            total += (1 << 5) >> l
        if total >= (1 << 5):
            break
    assert total == (1 << 5), "layer-1 code not complete"

    # layer-2 stream
    for c, extra in l2_syms:
        ln, pat = l1_codewords[c]
        w.u(ln, pat)
        if c == 16:
            w.u(2, extra)
        elif c == 17:
            w.u(3, extra)


def write_hybrid_config(w: BitWriter, cfg: HybridIntConfig, log_alpha_size: int) -> None:
    w.at_most(log_alpha_size, cfg.split_exp)
    if cfg.split_exp != log_alpha_size:
        w.at_most(cfg.split_exp, cfg.msb_in_token)
        w.at_most(cfg.split_exp - cfg.msb_in_token, cfg.lsb_in_token)


def normalize_distribution(freqs: list[int]) -> list[int]:
    """Scale a histogram to sum exactly DIST_SUM, keeping nonzeros nonzero."""
    total = sum(freqs)
    assert total > 0
    D = [0] * len(freqs)
    nonzero = [i for i, f in enumerate(freqs) if f > 0]
    if len(nonzero) == 1:
        D[nonzero[0]] = DIST_SUM
        return D
    remaining = DIST_SUM - len(nonzero)
    scaled = []
    for i in nonzero:
        share = freqs[i] * remaining // total
        D[i] = 1 + share
        scaled.append((freqs[i] * remaining % total, i))
    deficit = DIST_SUM - sum(D)
    for _, i in sorted(scaled, reverse=True)[:deficit]:
        D[i] += 1
    assert sum(D) == DIST_SUM
    return D


def _write_ans_u8(w: BitWriter, v: int) -> None:
    if v == 0:
        w.u(1, 0)
    else:
        n = v.bit_length() - 1
        w.u(1, 1)
        w.u(3, n)
        w.u(n, v - (1 << n))


def quantize_distribution_for_shift(D: list[int], shift: int) -> list[int]:
    """Make every non-omitted entry exactly representable at the given
    bit-counts shift (the reader reconstructs value = 2^cc + extra << (cc -
    bitcount)); the first max-exponent entry absorbs the rounding residue
    (it is the implicit/omitted one, j40.h:2669-2671)."""
    if shift >= 13:
        return D
    total_sum = sum(D)
    q = list(D)
    for i, v in enumerate(q):
        if v < 2:
            continue
        cc = v.bit_length() - 1
        bitcount = min(max(0, shift - ((12 - cc) >> 1)), cc)
        step = 1 << (cc - bitcount)
        q[i] = (1 << cc) + ((v - (1 << cc)) // step) * step
    # give the residue to the first max-exponent entry (the omitted one)
    def expcode(v: int) -> int:
        return 0 if v == 0 else (1 if v == 1 else v.bit_length())

    omit = max(range(len(q)), key=lambda i: (expcode(q[i]), -i))
    # max(key) returns the first max only with the -i tiebreak above
    q[omit] += total_sum - sum(q)
    assert q[omit] > 0 and sum(q) == total_sum
    # the boosted entry must still carry the maximum exponent code so the
    # reader omits the same position (boosting can only raise its exponent)
    assert expcode(q[omit]) == max(expcode(v) for v in q)
    return q


def write_ans_distribution(w: BitWriter, D: list[int], shift: int = 13) -> None:
    """Emit an ANS distribution header (matches read_ans_table)."""
    nonzero = [i for i, v in enumerate(D) if v]
    table_size = len(D)

    write_u8 = lambda v: _write_ans_u8(w, v)  # noqa: E731

    if len(nonzero) == 1:
        w.u(2, 1)  # mode: singleton
        write_u8(nonzero[0])
        return
    if len(nonzero) == 2:
        v1, v2 = nonzero
        w.u(2, 3)  # mode: two entries
        write_u8(v1)
        write_u8(v2)
        w.u(DIST_BITS, D[v1])
        return
    # general: bit-counts mode (shift=13 keeps all values exactly
    # representable; callers pass smaller shifts for the quantized branch
    # after quantize_distribution_for_shift)
    w.u(1, 0)
    w.u(1, 0)  # mode bits: false,false -> general; composed as two Bool()s
    shift_ = shift
    assert 0 <= shift_ <= 13
    # len selector: chained bits then u(len); shift = u(len) + 2^len - 1
    if shift_ == 0:
        w.u(1, 0)
    elif shift_ <= 2:
        w.u(1, 1); w.u(1, 0)
        w.u(1, shift_ - 1)
    elif shift_ <= 6:
        w.u(1, 1); w.u(1, 1); w.u(1, 0)
        w.u(2, shift_ - 3)
    else:
        w.u(1, 1); w.u(1, 1); w.u(1, 1)
        w.u(3, shift_ - 7)
    alpha_size = len(nonzero) and (max(nonzero) + 1)
    write_u8(alpha_size - 3)

    # choose the omitted entry: first occurrence of the largest exponent
    def exponent(v: int) -> int:
        return 0 if v == 0 else v.bit_length()  # 1 -> 1, 2..3 -> 2, ...

    # per the reader: code c means value 1<<(c-1) + extra; exponent code for
    # value v>=2 is bit_length(v); v==1 -> code 1; v==0 -> code 0
    exps = []
    for i in range(alpha_size):
        v = D[i]
        exps.append(0 if v == 0 else (1 if v == 1 else v.bit_length()))
    omit_log = max(exps)
    omit_pos = exps.index(omit_log)

    # logcount codewords (fixed code; see entropy.code.LOGCOUNT_CODE)
    from ..entropy.code import LOGCOUNT_CODE

    lc = prefix_codewords(LOGCOUNT_CODE)
    # phase 1: all log-count codes, RLE-compressing zero runs (code 13 +
    # u8(rep-4) repeats the previous D value, j40.h:2664-2667); phase 2:
    # all extra bits (the reader collects codes first, then value bits)
    i = 0
    while i < len(exps):
        c = exps[i]
        run = 1
        if c == 0 and i != omit_pos:
            while (i + run < len(exps) and exps[i + run] == 0
                   and i + run != omit_pos):
                run += 1
        if c == 0 and run >= 6 and run - 1 <= 255 + 4:
            # one literal zero, then a repeat covering the rest of the run
            ln, pat = lc[0]
            w.u(ln, pat)
            ln, pat = lc[13]
            w.u(ln, pat)
            _write_ans_u8(w, run - 1 - 4)  # reader: rep = u8() + 4
            i += run
        else:
            ln, pat = lc[c]
            w.u(ln, pat)
            i += 1
    for i, c in enumerate(exps):
        if i == omit_pos or c < 2:
            continue
        cc = c - 1
        bitcount = min(max(0, shift_ - ((DIST_BITS - cc) >> 1)), cc)
        v = D[i]
        extra = (v - (1 << cc)) >> (cc - bitcount)
        assert (1 << cc) + (extra << (cc - bitcount)) == v, "value not representable"
        w.u(bitcount, extra)


@dataclass
class _ClusterPlan:
    config: HybridIntConfig
    tokens: list[tuple[int, int, int]]  # (token, midbits, mid) — filled later


class EntropyEncoder:
    """Two-phase entropy stream encoder.

    Phase 1: `add(ctx, value)` in exact decode order.
    Phase 2: `write(w)` emits the code-spec header followed by the tokens.

    LZ77 is not emitted (valid streams need not use it).  A single hybrid-int
    config is used for all clusters.
    """

    def __init__(self, num_dist: int, use_prefix: bool = True,
                 cluster_map: list[int] | None = None,
                 config: HybridIntConfig = HybridIntConfig(4, 1, 0),
                 lz77: bool = False, dist_mult: int = 0,
                 lz_min_symbol: int = 224, lz_min_length: int = 3,
                 complex_cluster_map: bool = False,
                 flat_ans_dists: bool = False,
                 ans_shift: int = 13,
                 complex_map_mtf: bool = True,
                 complex_map_prefix: bool = True):
        #: emit the cluster map via the nested-entropy + MTF encoding
        #: (j40.h:2550-2599) instead of the simple form — coverage for the
        #: decoder's recursive path (cjxl uses it for wide context sets)
        self.complex_cluster_map = complex_cluster_map
        #: knobs for the nested-map encoding itself: MTF on/off and the
        #: nested stream's prefix-vs-ANS choice (decoder-coverage controls)
        self.complex_map_mtf = complex_map_mtf
        self.complex_map_prefix = complex_map_prefix
        #: emit every ANS distribution in the "evenly distributed" mode 2
        #: (j40.h:2640-2649) — decoder coverage for the flat branch; symbols
        #: then code against the flat distribution (valid, less dense)
        self.flat_ans_dists = flat_ans_dists
        #: bit-counts shift for ANS tables; < 13 quantizes values to the
        #: reader's truncated-extra-bits grid (decoder coverage for the
        #: shift branch, j40.h:2680-2686)
        self.ans_shift = ans_shift
        self.num_dist = num_dist
        self.use_prefix = use_prefix
        self.lz77 = lz77
        self.dist_mult = dist_mult
        self.lz_min_symbol = lz_min_symbol
        self.lz_min_length = lz_min_length
        total_dist = num_dist + (1 if lz77 else 0)
        self.cluster_map = cluster_map or [0] * total_dist
        assert len(self.cluster_map) == total_dist
        self.num_clusters = max(self.cluster_map) + 1
        self.config = config
        # multiple independent token streams may share one spec (e.g. the HF
        # coefficient tables in HfGlobal feed every pass-group section)
        self.streams: dict[int, list[tuple[int, int]]] = {0: []}
        self.events = self.streams[0]

    def add(self, ctx: int, value: int, stream: int = 0) -> None:
        assert 0 <= ctx < self.num_dist
        self.streams.setdefault(stream, []).append((ctx, value))

    def add_array(self, ctx: int, values, stream: int = 0) -> None:
        """Bulk add: one context, many values, vectorized through tokenize
        and prefix emission (LZ77 emission is scalar-only)."""
        assert 0 <= ctx < self.num_dist
        vals = np.asarray(values, dtype=np.int64).ravel()
        if self.lz77:
            # LZ77 run detection is sequential; fall back to scalars
            st = self.streams.setdefault(stream, [])
            st.extend((ctx, int(v)) for v in vals)
            return
        self.streams.setdefault(stream, []).append(("A", ctx, vals))

    def add_arrays(self, ctxs, values, stream: int = 0) -> None:
        """Bulk add with per-token contexts (both arrays, same length)."""
        assert not self.lz77, "array path excludes LZ77 emission"
        ctxs = np.asarray(ctxs, dtype=np.int64).ravel()
        vals = np.asarray(values, dtype=np.int64).ravel()
        assert ctxs.shape == vals.shape
        if len(ctxs) == 0:
            return
        assert 0 <= int(ctxs.min()) and int(ctxs.max()) < self.num_dist
        self.streams.setdefault(stream, []).append(("M", ctxs, vals))

    @staticmethod
    def _tokenize_array(vals: np.ndarray, cfg: HybridIntConfig):
        """Vectorized encode_hybrid_int over an int64 array."""
        split = 1 << cfg.split_exp
        token = vals.copy()
        midbits = np.zeros(vals.shape, np.int64)
        mid = np.zeros(vals.shape, np.int64)
        big_mask = vals >= split
        if big_mask.any():
            big = vals[big_mask]
            # exact floor(log2) for < 2^53
            n = (np.frexp(big.astype(np.float64))[1] - 1).astype(np.int64)
            lsbm = (1 << cfg.lsb_in_token) - 1
            msbm = (1 << cfg.msb_in_token) - 1
            lsb = big & lsbm
            msb = (big >> (n - cfg.msb_in_token)) & msbm
            bit = cfg.msb_in_token + cfg.lsb_in_token
            mb = n - bit
            token[big_mask] = split + (
                ((n - cfg.split_exp) << bit) | (msb << cfg.lsb_in_token) | lsb
            )
            midbits[big_mask] = mb
            mid[big_mask] = (big >> cfg.lsb_in_token) & ((np.int64(1) << mb) - 1)
        return token, midbits, mid

    def write(self, w: BitWriter) -> None:
        """Emit spec header followed immediately by the token stream."""
        self.write_spec(w)
        self.write_tokens(w)

    def _tokenize(self):
        if hasattr(self, "_tokenized_streams"):
            return
        cfg = self.config
        hists = [dict() for _ in range(self.num_clusters)]
        tokenized_streams = {}
        for sid, events in self.streams.items():
            tokenized = []  # (cluster, token, midbits, mid)
            if self.lz77:
                self._tokenize_lz77(events, tokenized, hists)
            else:
                cmap_arr = np.asarray(self.cluster_map, dtype=np.int64)
                for ev in events:
                    if ev[0] == "A":
                        _, ctx, vals = ev
                        cl = self.cluster_map[ctx]
                        t, mb, md = self._tokenize_array(vals, cfg)
                        h = hists[cl]
                        binc = np.bincount(t)
                        for tok in np.nonzero(binc)[0]:
                            h[int(tok)] = h.get(int(tok), 0) + int(binc[tok])
                        if self.use_prefix:
                            tokenized.append(("A", cl, t, mb, md))
                        else:
                            # ANS state threading is sequential; expand
                            tokenized.extend(
                                zip([cl] * len(t), t.tolist(), mb.tolist(),
                                    md.tolist())
                            )
                        continue
                    if ev[0] == "M":
                        _, ctxs, vals = ev
                        cls = cmap_arr[ctxs]
                        t, mb, md = self._tokenize_array(vals, cfg)
                        for c in np.unique(cls):
                            h = hists[int(c)]
                            binc = np.bincount(t[cls == c])
                            for tok in np.nonzero(binc)[0]:
                                h[int(tok)] = h.get(int(tok), 0) + int(binc[tok])
                        if self.use_prefix:
                            tokenized.append(("M", cls, t, mb, md))
                        else:
                            tokenized.extend(
                                zip(cls.tolist(), t.tolist(), mb.tolist(),
                                    md.tolist())
                            )
                        continue
                    ctx, value = ev
                    cl = self.cluster_map[ctx]
                    token, midbits, mid = encode_hybrid_int(value, cfg)
                    tokenized.append((cl, token, midbits, mid))
                    hists[cl][token] = hists[cl].get(token, 0) + 1
            tokenized_streams[sid] = tokenized
        self._tokenized_streams = tokenized_streams
        self._tokenized = tokenized_streams.get(0, [])
        self._hists = hists

    def _tokenize_lz77(self, events, tokenized, hists):
        """Greedy distance-1 run (RLE) LZ77 emission: a run of >=min_length
        equal values following one occurrence becomes a length+distance pair
        (decoder semantics j40.h:2804-2876)."""
        cfg = self.config
        lz_cfg = HybridIntConfig(4, 1, 0)  # written as lz_len_config
        self._lz_cfg = lz_cfg
        lz_cl = self.cluster_map[self.num_dist]  # appended LZ distance dist
        # the raw distance token decoding to effective distance 1:
        # dist_mult == 0: distance = raw + 1 -> raw token 0
        # dist_mult != 0: raw >= 120 -> distance = raw - 119 -> raw token 120
        dist_value = 120 if self.dist_mult else 0
        # special-distance vertical copy: SPECIAL_DISTANCES[0] = (0, 1) means
        # raw token 0 decodes to distance dist_mult when dist_mult != 0
        # (one image row for modular streams, j40.h:2834-2851)
        vdist = self.dist_mult
        # cap per-emission run length so the length token stays inside the
        # ANS alphabet (lz_min_symbol 224 + token < 256); longer runs simply
        # emit as consecutive copy pairs.  token<=31 covers lengths < 2^12.
        MAXRUN = (1 << 11) + self.lz_min_length - 1
        i = 0
        n = len(events)
        while i < n:
            ctx, value = events[i]
            run = 0
            if i > 0 and events[i - 1][1] == value:
                while i + run < n and run < MAXRUN and events[i + run][1] == value:
                    run += 1
            vrun = 0
            if vdist and i >= vdist:
                while (
                    i + vrun < n
                    and vrun < MAXRUN
                    and events[i + vrun][1] == events[i + vrun - vdist][1]
                ):
                    vrun += 1
            if vdist and vrun >= self.lz_min_length and vrun > run:
                cl = self.cluster_map[ctx]
                lt, lmb, lmid = encode_hybrid_int(vrun - self.lz_min_length, lz_cfg)
                token = self.lz_min_symbol + lt
                tokenized.append((cl, token, lmb, lmid))
                hists[cl][token] = hists[cl].get(token, 0) + 1
                dt, dmb, dmid = encode_hybrid_int(0, cfg)  # raw 0 -> special (0,1)
                tokenized.append((lz_cl, dt, dmb, dmid))
                hists[lz_cl][dt] = hists[lz_cl].get(dt, 0) + 1
                i += vrun
                continue
            if run >= self.lz_min_length:
                # length token coded in the CURRENT context's cluster
                cl = self.cluster_map[ctx]
                lt, lmb, lmid = encode_hybrid_int(run - self.lz_min_length, lz_cfg)
                token = self.lz_min_symbol + lt
                tokenized.append((cl, token, lmb, lmid))
                hists[cl][token] = hists[cl].get(token, 0) + 1
                dt, dmb, dmid = encode_hybrid_int(dist_value, cfg)
                tokenized.append((lz_cl, dt, dmb, dmid))
                hists[lz_cl][dt] = hists[lz_cl].get(dt, 0) + 1
                i += run
            else:
                cl = self.cluster_map[ctx]
                token, midbits, mid = encode_hybrid_int(value, cfg)
                assert token < self.lz_min_symbol, "value token collides with LZ range"
                tokenized.append((cl, token, midbits, mid))
                hists[cl][token] = hists[cl].get(token, 0) + 1
                i += 1

    def write_spec(self, w: BitWriter) -> None:
        """Emit the code-spec header only (tokens may live in a different
        section, e.g. the HF coefficient spec in HfGlobal)."""
        cfg = self.config
        self._tokenize()
        tokenized, hists = self._tokenized, self._hists

        if self.lz77:
            w.u(1, 1)  # lz77_enabled
            w.u32(((224, 0), (512, 0), (4096, 0), (8, 15)), self.lz_min_symbol)
            w.u32(((3, 0), (4, 0), (5, 2), (9, 8)), self.lz_min_length)
            write_hybrid_config(w, self._lz_cfg, 8)
        else:
            w.u(1, 0)  # lz77_enabled = false
        total_dist = self.num_dist + (1 if self.lz77 else 0)
        # cluster map (nothing to write when total_dist == 1)
        if total_dist > 1 and self.complex_cluster_map:
            w.u(1, 0)  # not simple
            w.u(1, 1 if self.complex_map_mtf else 0)  # use_mtf
            if self.complex_map_mtf:
                # forward MTF of the map values, then a nested 1-ctx stream
                mtf = list(range(256))
                idxs = []
                for v in self.cluster_map:
                    j = mtf.index(v)
                    idxs.append(j)
                    mtf.pop(j)
                    mtf.insert(0, v)
            else:
                idxs = list(self.cluster_map)
            nested = EntropyEncoder(1, use_prefix=self.complex_map_prefix)
            for j in idxs:
                nested.add(0, j)
            nested.write(w)
        elif total_dist > 1:
            w.u(1, 1)  # is_simple
            nbits = (self.num_clusters - 1).bit_length()
            w.u(2, nbits)
            for c in self.cluster_map:
                w.u(nbits, c)

        w.u(1, 1 if self.use_prefix else 0)
        if self.use_prefix:
            for _ in range(self.num_clusters):
                write_hybrid_config(w, cfg, 15)
            alpha_sizes = []
            for cl in range(self.num_clusters):
                count = max(hists[cl].keys(), default=0) + 1
                alpha_sizes.append(count)
                if count > 1:
                    # count = 1 + 2^n + u(n) with count-1 in [2^n, 2^(n+1)-1]
                    w.u(1, 1)
                    n = (count - 1).bit_length() - 1
                    w.u(4, n)
                    w.u(n, count - 1 - (1 << n))
                else:
                    w.u(1, 0)
            codes = []
            for cl in range(self.num_clusters):
                count = alpha_sizes[cl]
                freqs = [hists[cl].get(t, 0) for t in range(count)]
                lengths = huffman_lengths(freqs, 15)
                write_prefix_code_header(w, lengths, count)
                # derive the emission codewords by reading the header back —
                # guarantees the patterns match the decoder's table exactly
                # (simple flat-4 codes are NOT canonical, prefix.py:~115)
                if sum(1 for x in lengths if x) > 1:
                    from ..io.bits import BitReader
                    from ..entropy.prefix import read_prefix_code

                    hw = BitWriter()
                    write_prefix_code_header(hw, lengths, count)
                    pc = read_prefix_code(BitReader(hw.finish()), count)
                else:
                    pc = PrefixCode(
                        max_len=0, by_len=[],
                        single_symbol=next((s for s, x in enumerate(lengths) if x), 0))
                codes.append(prefix_codewords(pc) if pc.single_symbol is None else None)
            self._codes = codes
        else:
            log_alpha_size = 8
            w.u(2, log_alpha_size - 5)
            for _ in range(self.num_clusters):
                write_hybrid_config(w, cfg, log_alpha_size)
            table_size = 1 << log_alpha_size
            Ds = []
            encoders = []
            for cl in range(self.num_clusters):
                freqs = [hists[cl].get(t, 0) for t in range(table_size)]
                if sum(freqs) == 0:
                    freqs[0] = 1  # unused cluster still needs a distribution
                if self.flat_ans_dists:
                    alpha = max(
                        (t for t, f in enumerate(freqs) if f), default=0) + 1
                    d, bias = divmod(1 << DIST_BITS, alpha)
                    D = [(d + 1 if i < bias else d) if i < alpha else 0
                         for i in range(table_size)]
                    w.u(2, 2)  # mode: evenly distributed
                    _write_ans_u8(w, alpha - 1)
                else:
                    D = normalize_distribution(freqs)
                    if self.ans_shift < 13:
                        D = quantize_distribution_for_shift(D, self.ans_shift)
                    write_ans_distribution(w, D, self.ans_shift)
                Ds.append(D)
                encoders.append(AnsEncoder(D, log_alpha_size))
            self._Ds = Ds
            self._ans_encoders = encoders

    def write_tokens(self, w: BitWriter, stream: int = 0) -> None:
        tokenized = self._tokenized_streams[stream]
        if self.use_prefix:
            codes = self._codes
            lut_cache = {}

            def _luts(maxt):
                # (num_clusters, maxt+1) length/pattern LUTs; None cw = 0 bits
                if maxt in lut_cache:
                    return lut_cache[maxt]
                lens = np.zeros((self.num_clusters, maxt + 1), np.int64)
                pats = np.zeros((self.num_clusters, maxt + 1), np.int64)
                for ci, cw in enumerate(codes):
                    if cw is None:
                        continue
                    for sym, (ln, pat) in cw.items():
                        if sym <= maxt:
                            lens[ci, sym] = ln
                            pats[ci, sym] = pat
                lut_cache[maxt] = (lens, pats)
                return lens, pats

            for ev in tokenized:
                if ev[0] == "A":
                    _, cl, t, mb, md = ev
                    cw = codes[cl]
                    if cw is None:
                        w.u_array(mb, md)
                        continue
                    maxt = int(t.max()) if len(t) else 0
                    lens = np.zeros(maxt + 1, np.int64)
                    pats = np.zeros(maxt + 1, np.int64)
                    for sym, (ln, pat) in cw.items():
                        if sym <= maxt:
                            lens[sym] = ln
                            pats[sym] = pat
                    cl_ = lens[t]
                    allv = pats[t].astype(np.uint64) | (
                        md.astype(np.uint64) << cl_.astype(np.uint64)
                    )
                    w.u_array(cl_ + mb, allv)
                    continue
                if ev[0] == "M":
                    _, cls, t, mb, md = ev
                    lens, pats = _luts(int(t.max()) if len(t) else 0)
                    cl_ = lens[cls, t]
                    allv = pats[cls, t].astype(np.uint64) | (
                        md.astype(np.uint64) << cl_.astype(np.uint64)
                    )
                    w.u_array(cl_ + mb, allv)
                    continue
                cl, token, midbits, mid = ev
                cw = codes[cl]
                if cw is not None:
                    ln, pat = cw[token]
                    w.u(ln, pat)
                w.u(midbits, mid)
        else:
            log_alpha_size = 8
            Ds = self._Ds
            encoders = self._ans_encoders
            # ANS-encode the full symbol sequence in reverse using per-cluster
            # tables but one shared state
            words: list[int] = []
            state = ANS_INIT_STATE
            for cl, token, midbits, mid in reversed(tokenized):
                enc = encoders[cl]
                freq = Ds[cl][token]
                if state >= (freq << 20):
                    words.append(state & 0xFFFF)
                    state >>= 16
                state = ((state // freq) << 12) | enc.slots[token][state % freq]
            words.append(state >> 16)
            words.append(state & 0xFFFF)
            words.reverse()
            # forward pass: emit words exactly when the decoder would read them
            wi = 0
            sim_state = 0
            for cl, token, midbits, mid in tokenized:
                if sim_state == 0:
                    w.u(16, words[wi]); wi += 1
                    sim_state = words[wi - 1]
                    w.u(16, words[wi]); wi += 1
                    sim_state |= words[wi - 1] << 16
                # decode-step simulation
                D = Ds[cl]
                aliases = encoders[cl].aliases
                index = sim_state & 0xFFF
                lbs = DIST_BITS - log_alpha_size
                i_b = index >> lbs
                pos = index & ((1 << lbs) - 1)
                b = aliases[i_b]
                offset = 0 if pos < b.cutoff else b.offset
                sim_state = D[token] * (sim_state >> 12) + offset + pos
                if sim_state < (1 << 16):
                    w.u(16, words[wi]); wi += 1
                    sim_state = (sim_state << 16) | words[wi - 1]
                w.u(midbits, mid)
            if not tokenized:
                # state still read & checked at finish
                w.u(16, ANS_INIT_STATE & 0xFFFF)
                w.u(16, ANS_INIT_STATE >> 16)
            else:
                assert wi == len(words), (wi, len(words))
                assert sim_state == ANS_INIT_STATE
