"""Clustered entropy code with LZ77 (reference j40.h:2465-2917, spec §13).

`CodeSpec` is the parsed distribution bundle (cluster map + per-cluster prefix
or ANS tables); `CodeState` is the per-stream decode state (shared ANS state,
LZ77 window).  Every bitstream section owns an independent CodeState, which is
what makes group decode embarrassingly parallel for the TPU pipeline.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..errors import check
from ..io.bits import BitReader
from .ans import AliasBucket, AnsDecoder, DIST_BITS, DIST_SUM, init_alias_map
from .hybrid import HybridIntConfig, read_hybrid_int, read_hybrid_int_config
from .prefix import PrefixCode, read_prefix_code

MAX_DIST_MULT = 1 << 21
LZ_WINDOW_SIZE = 1 << 20
LZ_MASK = LZ_WINDOW_SIZE - 1

# special LZ77 distance table: entry encodes (a+7)*16 + b, distance = a + b*dist_mult
# (j40.h:2834-2845, spec Table J.1)
SPECIAL_DISTANCES = bytes(
    [
        0x71, 0x80, 0x81, 0x61, 0x72, 0x90, 0x82, 0x62, 0x91, 0x51, 0x92, 0x52,
        0x73, 0xA0, 0x83, 0x63, 0xA1, 0x41, 0x93, 0x53, 0xA2, 0x42, 0x74, 0xB0,
        0x84, 0x64, 0xB1, 0x31, 0xA3, 0x43, 0x94, 0x54, 0xB2, 0x32, 0x75, 0xA4,
        0x44, 0xB3, 0x33, 0xC0, 0x85, 0x65, 0xC1, 0x21, 0x95, 0x55, 0xC2, 0x22,
        0xB4, 0x34, 0xA5, 0x45, 0xC3, 0x23, 0x76, 0xD0, 0x86, 0x66, 0xD1, 0x11,
        0x96, 0x56, 0xD2, 0x12, 0xB5, 0x35, 0xC4, 0x24, 0xA6, 0x46, 0xD3, 0x13,
        0x77, 0xE0, 0x87, 0x67, 0xC5, 0x25, 0xE1, 0x01, 0xB6, 0x36, 0xD4, 0x14,
        0x97, 0x57, 0xE2, 0x02, 0xA7, 0x47, 0xE3, 0x03, 0xC6, 0x26, 0xD5, 0x15,
        0xF0, 0xB7, 0x37, 0xE4, 0x04, 0xF1, 0xF2, 0xD6, 0x16, 0xF3, 0xC7, 0x27,
        0xE5, 0x05, 0xF4, 0xD7, 0x17, 0xE6, 0x06, 0xF5, 0xE7, 0x07, 0xF6, 0xF7,
    ]
)


# fixed (non-canonical) log-count code for ANS bit-count headers, spec §13.2.3.3
# (libjxl kLogCountLut; reference LUT at j40.h:2650-2654).  Keys are LSB-first
# codeword patterns per length.
LOGCOUNT_CODE = PrefixCode(
    max_len=7,
    by_len=[
        {},  # length 0 unused
        {},
        {},
        {0b000: 10, 0b010: 7, 0b100: 6, 0b101: 8, 0b110: 9},
        {0b0011: 3, 0b0111: 5, 0b1001: 4, 0b1011: 1, 0b1111: 2},
        {0b10001: 0},
        {0b100001: 11},
        {0b0000001: 12, 0b1000001: 13},
    ],
)


@dataclass
class Cluster:
    config: HybridIntConfig
    # prefix path
    prefix: PrefixCode | None = None
    # ANS path
    D: list[int] | None = None
    aliases: list[AliasBucket] | None = None


@dataclass
class CodeSpec:
    num_dist: int
    lz77_enabled: bool
    use_prefix_code: bool
    min_symbol: int
    min_length: int
    log_alpha_size: int
    cluster_map: list[int]
    lz_len_config: HybridIntConfig | None
    clusters: list[Cluster]

    @property
    def num_clusters(self) -> int:
        return len(self.clusters)


def _read_simple_entries_vec(r: BitReader, nbits: int, num_dist: int,
                             max_allowed: int):
    """Vectorized simple cluster map: num_dist fixed-width LSB-first fields
    (the HfGlobal coefficient spec's map is 495*nb_block_ctx entries; a
    per-entry Python r.u() loop is a serial frame-level cost).  Returns None
    to fall back when the map is small or the span runs past the buffer."""
    if num_dist < 64:
        return None
    if nbits == 0:
        return [0] * num_dist
    import numpy as np

    r.ensure_all()
    pos0 = r.rel_bits
    total = num_dist * nbits
    if pos0 + total > len(r.data) * 8:
        return None  # let the scalar loop raise ShortInput at the right spot
    byte0, bit0 = divmod(pos0, 8)
    nbytes = (bit0 + total + 7) // 8
    raw = np.frombuffer(r.data[byte0 : byte0 + nbytes], dtype=np.uint8)
    bits = np.unpackbits(raw, bitorder="little")[bit0 : bit0 + total]
    vals = bits.reshape(num_dist, nbits) @ (1 << np.arange(nbits, dtype=np.int64))
    check(int(vals.max()) < max_allowed, "clst")
    r.seek_rel_bits(pos0 + total)
    return vals.tolist()


def _read_cluster_entries_native(r: BitReader, nested: "CodeSpec",
                                 num_dist: int, max_allowed: int):
    """Batch-decode a large nested cluster map through the native symbol
    decoder (the HfGlobal coefficient spec carries 495*nb_block_ctx entries
    — a serial frame-level cost the per-symbol Python loop dominates).
    Returns None when the native core is unavailable or the map is small
    enough that handoff overhead would exceed the win."""
    if num_dist < 64:
        return None
    from ..modular.decode import _native_enabled

    if not _native_enabled():
        return None
    import numpy as np

    from ..native.bindings import NativeStream

    r.ensure_all()
    ns = NativeStream(bytes(r.data), r.rel_bits, nested)
    vals = ns.decode_symbols(np.zeros(num_dist, dtype=np.int32))
    check(int(vals.max(initial=0)) < max_allowed
          and int(vals.min(initial=0)) >= 0, "clst")
    # stream-final ANS state check (CodeState.finish analog, j40.h:2884-2897)
    if not nested.use_prefix_code:
        from .ans import ANS_INIT_STATE

        check(ns.ans_state == ANS_INIT_STATE, "ans?")
    r.seek_rel_bits(ns.bitpos)
    return vals.tolist()


def read_cluster_map(r: BitReader, num_dist: int, max_allowed: int = 256) -> tuple[int, list[int]]:
    """Context -> cluster mapping, possibly recursively entropy-coded with MTF
    (j40.h:2526-2599)."""
    assert num_dist > 0 and 1 <= max_allowed <= 256
    max_allowed = min(max_allowed, num_dist)
    if num_dist == 1:
        # SPEC: impossible in Brotli but possible in JPEG XL (j40.h:2539)
        return 1, [0]

    if r.u(1):  # is_simple
        nbits = r.u(2)
        cmap = _read_simple_entries_vec(r, nbits, num_dist, max_allowed)
        if cmap is None:
            cmap = []
            for _ in range(num_dist):
                v = r.u(nbits)
                check(v < max_allowed, "clst")
                cmap.append(v)
    else:
        use_mtf = r.u(1)
        # nested spec; LZ77 disallowed when reading only <=2 entries (libjxl
        # behavior adopted by the reference, j40.h:2557-2561)
        nested = read_code_spec(r, -1 if num_dist <= 2 else 1)
        cmap = _read_cluster_entries_native(r, nested, num_dist, max_allowed)
        if cmap is None:
            code = CodeState(nested)
            cmap = []
            for _ in range(num_dist):
                index = code.code(r, 0, 0)
                check(index < max_allowed, "clst")
                cmap.append(index)
            code.finish(r)
        if use_mtf:
            mtf = list(range(256))
            for i in range(num_dist):
                j = cmap[i]
                v = mtf[j]
                cmap[i] = v
                mtf.pop(j)
                mtf.insert(0, v)

    seen = set(cmap)
    num_clusters = len(seen)
    check(seen == set(range(num_clusters)), "clst", "cluster map not contiguous")
    return num_clusters, cmap


def read_ans_table(r: BitReader, log_alpha_size: int) -> list[int]:
    """One ANS distribution summing to 2^12 (j40.h:2601-2708)."""
    table_size = 1 << log_alpha_size
    D = [0] * table_size
    mode = r.u(2)  # two Bool() reads combined; bit order swapped vs reading order
    if mode == 1:  # singleton
        v = r.u8()
        check(v < table_size, "ansd")
        D[v] = DIST_SUM
    elif mode == 3:  # two entries
        v1 = r.u8()
        v2 = r.u8()
        check(v1 != v2 and v1 < table_size and v2 < table_size, "ansd")
        D[v1] = r.u(DIST_BITS)
        D[v2] = DIST_SUM - D[v1]
    elif mode == 2:  # evenly distributed over first alpha_size entries
        alpha_size = r.u8() + 1
        check(alpha_size <= table_size, "ansd")
        d, bias = divmod(DIST_SUM, alpha_size)
        for i in range(alpha_size):
            D[i] = d + 1 if i < bias else d
    else:  # mode == 0: bit counts with RLE
        length = 0
        while length < 3 and r.u(1):
            length += 1
        shift = r.u(length) + (1 << length) - 1
        check(shift <= 13, "ansd")
        alpha_size = r.u8() + 3

        codes: list[int] = []  # exponents >= 0, negated repeat count < 0
        i = 0
        omit_log = -1
        while i < alpha_size:
            c = LOGCOUNT_CODE.decode(r)
            if c < 13:
                i += 1
                codes.append(c)
                if omit_log < c:
                    omit_log = c
            else:
                rep = r.u8() + 4
                i += rep
                codes.append(-rep)
        check(i == alpha_size and omit_log >= 0, "ansd")

        omit_pos = -1
        n = 0
        total = 0
        for c in codes:
            if n >= table_size:
                break
            if c < 0:  # repeat previous value
                prev = D[n - 1] if n > 0 else 0
                check(prev >= 0, "ansd")
                rep = min(-c, table_size - n)
                total += prev * rep
                for _ in range(rep):
                    D[n] = prev
                    n += 1
            elif c == omit_log:  # first longest is implicit
                omit_pos = n
                omit_log = -1
                D[n] = -1
                n += 1
            elif c < 2:
                total += c
                D[n] = c
                n += 1
            else:
                c -= 1
                bitcount = min(max(0, shift - ((DIST_BITS - c) >> 1)), c)
                val = (1 << c) + (r.u(bitcount) << (c - bitcount))
                total += val
                D[n] = val
                n += 1
        check(omit_pos >= 0, "ansd")
        check(total <= DIST_SUM, "ansd")
        D[omit_pos] = DIST_SUM - total
    return D


def read_code_spec(r: BitReader, num_dist: int) -> CodeSpec:
    """Read the distribution bundle; negative num_dist forbids LZ77
    (j40.h:2711-2782)."""
    assert num_dist != 0
    allow_lz77 = num_dist > 0
    num_dist = abs(num_dist)

    lz77_enabled = bool(r.u(1))
    lz_len_config = None
    if lz77_enabled:
        check(allow_lz77, "lz77")
        min_symbol = r.u32(224, 0, 512, 0, 4096, 0, 8, 15)
        min_length = r.u32(3, 0, 4, 0, 5, 2, 9, 8)
        lz_len_config = read_hybrid_int_config(r, 8)
        num_dist += 1  # distribution num_dist-1 codes LZ77 distances
    else:
        min_symbol = min_length = 0x7FFFFFFF

    num_clusters, cluster_map = read_cluster_map(r, num_dist, 256)

    use_prefix_code = bool(r.u(1))
    clusters: list[Cluster] = []
    if use_prefix_code:
        configs = [read_hybrid_int_config(r, 15) for _ in range(num_clusters)]
        counts = []
        for _ in range(num_clusters):
            if r.u(1):
                n = r.u(4)
                count = 1 + (1 << n) + r.u(n)
                check(count <= (1 << 15), "hufd")
            else:
                count = 1
            counts.append(count)
        for cfg, count in zip(configs, counts):
            clusters.append(Cluster(config=cfg, prefix=read_prefix_code(r, count)))
        log_alpha_size = 15
    else:
        log_alpha_size = 5 + r.u(2)
        configs = [read_hybrid_int_config(r, log_alpha_size) for _ in range(num_clusters)]
        for cfg in configs:
            D = read_ans_table(r, log_alpha_size)
            clusters.append(
                Cluster(config=cfg, D=D, aliases=init_alias_map(D, log_alpha_size))
            )

    return CodeSpec(
        num_dist=num_dist,
        lz77_enabled=lz77_enabled,
        use_prefix_code=use_prefix_code,
        min_symbol=min_symbol,
        min_length=min_length,
        log_alpha_size=log_alpha_size,
        cluster_map=cluster_map,
        lz_len_config=lz_len_config,
        clusters=clusters,
    )


class CodeState:
    """Per-stream decode state: ANS state + LZ77 window (j40.h:2497-2504)."""

    def __init__(self, spec: CodeSpec):
        self.spec = spec
        self.num_to_copy = 0
        self.copy_pos = 0
        self.num_decoded = 0
        self.window: list[int] | None = None
        self.ans = AnsDecoder()

    def _cluster_symbol(self, r: BitReader, cluster: Cluster) -> int:
        if self.spec.use_prefix_code:
            return cluster.prefix.decode(r)
        return self.ans.code(
            r, DIST_BITS - self.spec.log_alpha_size, cluster.D, cluster.aliases
        )

    def code(self, r: BitReader, ctx: int, dist_mult: int = 0) -> int:
        """DecodeHybridVarLenUint (j40.h:2804-2876)."""
        spec = self.spec
        if self.num_to_copy > 0:
            self.num_to_copy -= 1
            v = self.window[self.copy_pos & LZ_MASK]
            self.window[self.num_decoded & LZ_MASK] = v
            self.num_decoded += 1
            self.copy_pos += 1
            return v

        cluster = spec.clusters[spec.cluster_map[ctx]]
        token = self._cluster_symbol(r, cluster)
        if token >= spec.min_symbol:  # LZ77 copy (unreachable if disabled)
            lz_cluster = spec.clusters[spec.cluster_map[spec.num_dist - 1]]
            num_to_copy = (
                read_hybrid_int(r, token - spec.min_symbol, spec.lz_len_config)
                + spec.min_length
            )
            token = self._cluster_symbol(r, lz_cluster)
            distance = read_hybrid_int(r, token, lz_cluster.config)
            if not dist_mult:
                distance += 1
            elif distance >= 120:
                distance -= 119
            else:
                special = SPECIAL_DISTANCES[distance]
                # spec bug: can go nonpositive; clamp to 1 like libjxl (j40.h:2848)
                distance = max(1, ((special >> 4) - 7) + dist_mult * (special & 7))
            distance = min(distance, self.num_decoded, LZ_WINDOW_SIZE)
            self.copy_pos = self.num_decoded - distance
            if self.window is None:
                # distance==0 ⇒ num_decoded==0; libjxl reads zeros (j40.h:2854)
                self.window = [0] * LZ_WINDOW_SIZE
            self.num_to_copy = num_to_copy - 1
            v = self.window[self.copy_pos & LZ_MASK]
            self.window[self.num_decoded & LZ_MASK] = v
            self.num_decoded += 1
            self.copy_pos += 1
            return v

        value = read_hybrid_int(r, token, cluster.config)
        if spec.lz77_enabled:
            if self.window is None:
                self.window = [0] * LZ_WINDOW_SIZE
            self.window[self.num_decoded & LZ_MASK] = value
            self.num_decoded += 1
        return value

    def finish(self, r: BitReader) -> None:
        """Verify stream-final ANS state (j40.h:2884-2897)."""
        if not self.spec.use_prefix_code:
            self.ans.finish(r)
