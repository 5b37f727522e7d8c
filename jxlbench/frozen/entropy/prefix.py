"""Brotli-style canonical prefix codes (RFC 7932 §3; reference j40.h:2020-2275).

Representation differs from the reference's two-level LUT: symbols are kept in
per-length dictionaries keyed by their bit-reversed (LSB-first) codeword.  The
host Python path optimizes for clarity; the native C++ core carries the LUT
fast path for hot streams.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..errors import J40Error, check
from ..io.bits import BitReader

# zigzag order in which layer-1 code lengths are stored (RFC 7932 §3.5)
L1_ZIGZAG = (1, 2, 3, 4, 0, 5, 17, 6, 16, 7, 8, 9, 10, 11, 12, 13, 14, 15)

# the fixed layer-0 code over the code-length alphabet 0..5:
# lengths {0:2, 1:4, 2:3, 3:2, 4:2, 5:4}
L0_LENGTHS = (2, 4, 3, 2, 2, 4)

MAX_LEN = 15


def reverse_bits(code: int, length: int) -> int:
    out = 0
    for _ in range(length):
        out = (out << 1) | (code & 1)
        code >>= 1
    return out


@dataclass
class PrefixCode:
    """A decodable canonical prefix code."""

    max_len: int
    # by_len[L] maps LSB-first L-bit pattern -> symbol
    by_len: list[dict[int, int]]
    single_symbol: int | None = None  # zero-bit code

    @classmethod
    def from_lengths(cls, lengths: list[int]) -> "PrefixCode":
        """Build from per-symbol code lengths (0 = absent), canonical order.

        Codes are assigned per RFC 7932: within each length, in symbol order.
        """
        nonzero = [(l, s) for s, l in enumerate(lengths) if l > 0]
        if not nonzero:
            raise J40Error("hufd", "empty prefix code")
        if len(nonzero) == 1:
            return cls(max_len=0, by_len=[], single_symbol=nonzero[0][1])
        max_len = max(l for l, _ in nonzero)
        check(max_len <= MAX_LEN, "hufd")
        counts = [0] * (max_len + 1)
        for l, _ in nonzero:
            counts[l] += 1
        # kraft check: must be exactly complete
        total = sum(counts[l] << (max_len - l) for l in range(1, max_len + 1))
        check(total == 1 << max_len, "hufd", "incomplete/overfull prefix code")
        next_code = [0] * (max_len + 2)
        code = 0
        for l in range(1, max_len + 1):
            code = (code + counts[l - 1]) << 1
            next_code[l] = code
        by_len: list[dict[int, int]] = [dict() for _ in range(max_len + 1)]
        for l, s in sorted(nonzero):
            by_len[l][reverse_bits(next_code[l], l)] = s
            next_code[l] += 1
        return cls(max_len=max_len, by_len=by_len)

    def decode(self, r: BitReader) -> int:
        if self.single_symbol is not None:
            return self.single_symbol
        pattern = r.peek(self.max_len)
        for l in range(1, self.max_len + 1):
            sym = self.by_len[l].get(pattern & ((1 << l) - 1))
            if sym is not None:
                r.consume(l)
                return sym
        raise J40Error("hufd", "no matching prefix code")


L0_CODE = PrefixCode.from_lengths(list(L0_LENGTHS))

# templates for simple prefix codes (RFC 7932 §3.4): nsym -> per-listed-symbol
# code lengths; symbols of equal length must be sorted by value.
_SIMPLE_LENGTHS = {
    1: (0,),
    2: (1, 1),
    3: (1, 2, 2),
    4: (2, 2, 2, 2),
    0: (1, 2, 3, 3),  # nsym=4 with tree-select
}


def read_prefix_code(r: BitReader, alphabet_size: int) -> PrefixCode:
    """Read a prefix code header for `alphabet_size` symbols (j40.h:2049-2242)."""
    check(0 < alphabet_size <= 0x8000, "hufd")
    if alphabet_size == 1:
        return PrefixCode(max_len=0, by_len=[], single_symbol=0)

    hskip = r.u(2)
    if hskip == 1:  # simple code: 1-4 symbols listed explicitly
        nsym = r.u(2) + 1
        syms = []
        for i in range(nsym):
            s = r.at_most(alphabet_size - 1)
            check(s not in syms, "hufd", "duplicate symbol in simple code")
            syms.append(s)
        key = nsym
        if nsym == 4 and r.u(1):
            key = 0  # tree-select variant
        tmpl = _SIMPLE_LENGTHS[key]
        # group symbols of equal length, sorted by value within the group
        pairs = sorted(zip(tmpl, syms))
        lengths = [0] * alphabet_size
        for l, s in pairs:
            lengths[s] = l
        if nsym == 1:
            return PrefixCode(max_len=0, by_len=[], single_symbol=syms[0])
        if key == 4:
            # flat 4-symbol code: the reference assigns sorted symbol i the
            # LSB-first pattern i (j40.h:2091 NSYM=4 template), which is NOT
            # the canonical bit-reversed assignment
            ssyms = sorted(syms)
            return PrefixCode(max_len=2,
                              by_len=[{}, {}, {i: ssyms[i] for i in range(4)}])
        return PrefixCode.from_lengths(lengths)

    # complex code: layer-1 lengths via the fixed layer-0 code, zigzag order
    L1SIZE, L1CODESUM = 18, 1 << 5
    l1_lengths = [0] * L1SIZE
    total = 0
    num_read = hskip  # first hskip zigzag entries implicitly zero
    nonzero_syms = 0
    i = hskip
    while i < L1SIZE and total < L1CODESUM:
        code = L0_CODE.decode(r)
        l1_lengths[L1_ZIGZAG[i]] = code
        if code:
            total += L1CODESUM >> code
            nonzero_syms += 1
        i += 1
    check(total == L1CODESUM and nonzero_syms > 0, "hufd")

    if nonzero_syms == 1:
        only = next(s for s in range(L1SIZE) if l1_lengths[s])
        l1 = PrefixCode(max_len=0, by_len=[], single_symbol=only)
    else:
        # layer-1 codes are at most 5 bits
        check(max(l1_lengths) <= 5, "hufd")
        l1 = PrefixCode.from_lengths(l1_lengths)

    # layer-2 lengths via the layer-1 code, with 16/17 RLE (j40.h:2146-2177)
    L2CODESUM = 1 << MAX_LEN
    lengths = [0] * alphabet_size
    total = 0
    i = 0
    prev = 8
    prev_rep = 0  # running repeat count: >0 for code 16 chains, <0 for 17 chains
    while i < alphabet_size and total < L2CODESUM:
        code = l1.decode(r)
        if code < 16:
            lengths[i] = code
            i += 1
            if code:
                total += L2CODESUM >> code
                prev = code
            prev_rep = 0
        elif code == 16:  # repeat previous nonzero length
            if prev_rep < 0:
                prev_rep = 0
            rep = (4 * prev_rep - 5 if prev_rep > 0 else 3) + r.u(2)
            check(i + (rep - prev_rep) <= alphabet_size, "hufd")
            total += (L2CODESUM * (rep - prev_rep)) >> prev
            for _ in range(rep - prev_rep):
                lengths[i] = prev
                i += 1
            prev_rep = rep
        else:  # code 17: repeat zero
            if prev_rep > 0:
                prev_rep = 0
            rep = (8 * prev_rep + 13 if prev_rep < 0 else -3) - r.u(3)
            check(i + (prev_rep - rep) <= alphabet_size, "hufd")
            for _ in range(prev_rep - rep):
                lengths[i] = 0
                i += 1
            prev_rep = rep
    check(total == L2CODESUM, "hufd")
    return PrefixCode.from_lengths(lengths)
