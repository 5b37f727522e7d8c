"""rANS with alias tables (reference j40.h:2331-2463, spec §13.2.3, C.2).

The alias-table construction must match the spec exactly (underfull/overfull
pairing order) because the decoded symbol depends on the exact bucket layout.
Includes the encoder-side dual (reverse-order rANS emission) used by the
framework encoder and the differential test harness.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..errors import J40Error, check
from ..io.bits import BitReader

DIST_BITS = 12
DIST_SUM = 1 << DIST_BITS
ANS_INIT_STATE = 0x130000


@dataclass
class AliasBucket:
    cutoff: int
    offset: int
    symbol: int


def init_alias_map(D: list[int], log_alpha_size: int) -> list[AliasBucket]:
    """Build the alias table per spec C.2.3 (j40.h:2362-2439)."""
    log_bucket_size = DIST_BITS - log_alpha_size
    bucket_size = 1 << log_bucket_size
    table_size = 1 << log_alpha_size
    assert 5 <= log_alpha_size <= 8
    assert len(D) == table_size

    nonzero = [i for i in range(table_size) if D[i]]
    if len(nonzero) == 1:
        s = nonzero[0]
        return [
            AliasBucket(cutoff=0, offset=j << log_bucket_size, symbol=s)
            for j in range(table_size)
        ]

    buckets = [AliasBucket(cutoff=D[i], offset=0, symbol=i) for i in range(table_size)]
    # implicit stacks as lists; pairing order must match the reference's
    # linked-list push/pop order: indices pushed in increasing i, popped LIFO
    underfull: list[int] = []
    overfull: list[int] = []
    for i in range(table_size):
        c = buckets[i].cutoff
        if c > bucket_size:
            overfull.append(i)
        elif c < bucket_size:
            underfull.append(i)
        # c == bucket_size: settled with symbol=i, offset=0

    while overfull:
        o = overfull[-1]
        check(bool(underfull), "ansd", "alias construction imbalance")
        u = underfull.pop()
        by = bucket_size - buckets[u].cutoff
        buckets[o].cutoff -= by
        buckets[u].symbol = o
        buckets[u].offset = buckets[o].cutoff - buckets[u].cutoff
        if buckets[o].cutoff < bucket_size:
            overfull.pop()
            underfull.append(o)
        elif buckets[o].cutoff == bucket_size:
            overfull.pop()
            buckets[o].offset = 0
            buckets[o].symbol = o

    check(not underfull, "ansd", "alias construction imbalance")
    return buckets


class AnsDecoder:
    """Shared 32-bit rANS state over one entropy stream (j40.h:2441-2461)."""

    __slots__ = ("state",)

    def __init__(self):
        self.state = 0  # 0 = not yet initialized

    def code(
        self, r: BitReader, log_bucket_size: int, D: list[int], aliases: list[AliasBucket]
    ) -> int:
        state = self.state
        if state == 0:
            state = r.u(16) | (r.u(16) << 16)
        index = state & 0xFFF
        i = index >> log_bucket_size
        pos = index & ((1 << log_bucket_size) - 1)
        b = aliases[i]
        if pos < b.cutoff:
            symbol, offset = i, 0
        else:
            symbol, offset = b.symbol, b.offset
        state = D[symbol] * (state >> 12) + offset + pos
        if state < (1 << 16):
            state = (state << 16) | r.u(16)
        self.state = state
        return symbol

    def finish(self, r: BitReader) -> None:
        """Verify the final state (or read it, if no symbol was ever coded)."""
        if self.state:
            check(self.state == ANS_INIT_STATE, "ans?")
        else:
            check(r.u(16) == (ANS_INIT_STATE & 0xFFFF), "ans?")
            check(r.u(16) == (ANS_INIT_STATE >> 16), "ans?")


# -- encoder-side dual ------------------------------------------------------


def slot_map(D: list[int], aliases: list[AliasBucket], log_alpha_size: int):
    """For each symbol s, map slot j in [0, D[s]) -> 12-bit index, inverting
    the alias decode (index -> (symbol, offset+pos))."""
    log_bucket_size = DIST_BITS - log_alpha_size
    bucket_size = 1 << log_bucket_size
    slots = {s: [0] * D[s] for s in range(len(D)) if D[s]}
    for b_i, b in enumerate(aliases):
        for pos in range(bucket_size):
            idx = (b_i << log_bucket_size) | pos
            if pos < b.cutoff:
                s, slot = b_i, pos
            else:
                s, slot = b.symbol, b.offset + pos
            if s in slots and slot < len(slots[s]):
                slots[s][slot] = idx
    return slots


class AnsEncoder:
    """Reverse-order rANS encoder producing the 16-bit word stream the decoder
    expects (initial 32-bit state first, then renormalization words)."""

    def __init__(self, D: list[int], log_alpha_size: int):
        self.D = D
        self.log_alpha_size = log_alpha_size
        self.aliases = init_alias_map(D, log_alpha_size)
        self.slots = slot_map(D, self.aliases, log_alpha_size)

    def encode(self, symbols: list[int]) -> list[int]:
        """Returns the 16-bit words in decoder read order."""
        state = ANS_INIT_STATE
        words: list[int] = []  # collected in reverse
        for s in reversed(symbols):
            freq = self.D[s]
            if freq == 0:
                raise J40Error("ansd", f"symbol {s} has zero probability")
            # renormalize: decoder reads a word when its state dips below 2^16,
            # so the encoder emits when the pre-step state would overflow
            if state >= (freq << 20):
                words.append(state & 0xFFFF)
                state >>= 16
            state = ((state // freq) << 12) | self.slots[s][state % freq]
        # initial state read as two 16-bit halves, low first
        words.append(state >> 16)
        words.append(state & 0xFFFF)
        return words[::-1]
