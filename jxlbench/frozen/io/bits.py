"""LSB-first bitstream reader for JPEG XL codestreams.

Behavioral contract follows the reference bit layer (j40.h:1816-2017): bits are
consumed LSB-first within each byte; ``u32``/``u64``/``enum``/``f16``/``u8``/
``at_most`` follow ISO/IEC 18181-1 §4.  This host-side reader favors clarity;
the hot entropy loops use the native C++ core (j40_tpu/native) instead.
"""

from __future__ import annotations

import math

from ..errors import ShortInput, check


def ceil_lg(x: int) -> int:
    """ceil(log2(x)) for x >= 1."""
    return (x - 1).bit_length()


def floor_lg(x: int) -> int:
    """floor(log2(x)) for x >= 1."""
    return x.bit_length() - 1


class BitReader:
    """Reads bits LSB-first from a contiguous byte buffer.

    The full codestream is materialized by the container layer before decode
    (sections are sliced out of it), so no incremental refill is needed here;
    streaming/retry is layered above via checkpoints (see j40_tpu/api.py).
    """

    __slots__ = ("data", "pos", "bits", "nbits")

    def __init__(self, data: bytes | bytearray | memoryview, pos: int = 0):
        self.data = memoryview(data)
        self.pos = pos  # next byte index to load
        self.bits = 0  # bit accumulator, LSB = next bit
        self.nbits = 0  # valid bits in accumulator

    # -- position ---------------------------------------------------------

    def extend_data(self, data: bytes | bytearray | memoryview) -> None:
        """Swap in a longer buffer whose prefix equals the current one
        (streaming: more codestream bytes arrived). Position is preserved."""
        assert len(data) >= len(self.data)
        self.data = memoryview(data)

    @property
    def bits_consumed(self) -> int:
        """Total bits consumed from the start of the buffer."""
        return self.pos * 8 - self.nbits

    def _refill(self, n: int) -> None:
        data, end = self.data, len(self.data)
        while self.nbits < n:
            if self.pos >= end:
                raise ShortInput(f"need {n} bits, have {self.nbits}")
            self.bits |= data[self.pos] << self.nbits
            self.pos += 1
            self.nbits += 8

    # -- primitive reads --------------------------------------------------

    def u(self, n: int) -> int:
        """Read n bits as an unsigned integer (n <= 57 per call)."""
        if n == 0:
            return 0
        if self.nbits < n:
            self._refill(n)
        ret = self.bits & ((1 << n) - 1)
        self.bits >>= n
        self.nbits -= n
        return ret

    def peek(self, n: int) -> int:
        """Peek up to n bits without consuming, zero-padded past end of buffer.

        Matches the reference's best-effort refill in prefix decoding
        (j40.h:2256-2263): short codes at the very end of a section are
        readable because the tail is implicitly zero-padded.
        """
        try:
            self._refill(n)
        except ShortInput:
            pass
        return self.bits & ((1 << n) - 1)

    def consume(self, n: int) -> None:
        """Consume n previously peeked bits; 'shrt' if fewer are available."""
        if n > self.nbits:
            self.bits = 0
            self.nbits = 0
            raise ShortInput("code extends past end of input")
        self.bits >>= n
        self.nbits -= n

    def u32(self, o0, n0, o1, n1, o2, n2, o3, n3) -> int:
        """Four-way distribution: 2-bit selector, then offset + n bits."""
        offsets = (o0, o1, o2, o3)
        nbits = (n0, n1, n2, n3)
        sel = self.u(2)
        return self.u(nbits[sel]) + offsets[sel]

    def u64(self) -> int:
        """Variable-length u64 (j40.h:1966-1977 / spec §4.3)."""
        sel = self.u(2)
        ret = self.u(sel * 4)
        if sel < 3:
            # offsets: sel 0 -> 0, sel 1 -> 1, sel 2 -> 17
            return ret + (17 >> (8 - sel * 4))
        shift = 12
        while shift < 64 and self.u(1):
            ret |= self.u(8 if shift < 56 else 64 - shift) << shift
            shift += 8
        return ret

    def enum(self) -> int:
        ret = self.u32(0, 0, 1, 0, 2, 4, 18, 6)
        # reference caps at 31 (largest in-use enum is 18; j40.h:1981-1984)
        check(ret < 31, "enum", f"enum value {ret} out of range")
        return ret

    def f16(self) -> float:
        """binary16; rejects inf/nan (j40.h:1987-1992)."""
        bits = self.u(16)
        biased_exp = (bits >> 10) & 0x1F
        check(biased_exp != 31, "!fin", "non-finite f16")
        mant = (bits & 0x3FF) | (0x400 if biased_exp > 0 else 0)
        sign = -1.0 if bits >> 15 else 1.0
        return sign * math.ldexp(float(mant), biased_exp - 25)

    def u8(self) -> int:
        """Byte-ish varint used in ANS distribution decoding (j40.h:1994-2001)."""
        if self.u(1):
            n = self.u(3)
            return self.u(n) + (1 << n)
        return 0

    def at_most(self, maxval: int) -> int:
        """u(ceil_lg(max+1)) with range check (j40.h:2004-2008)."""
        v = self.u(ceil_lg(maxval + 1)) if maxval > 0 else 0
        check(v <= maxval, "rnge", f"{v} > {maxval}")
        return v

    def bool_(self) -> bool:
        return bool(self.u(1))

    # -- alignment & end --------------------------------------------------

    def zero_pad_to_byte(self) -> None:
        n = self.nbits & 7
        check((self.bits & ((1 << n) - 1)) == 0, "pad0", "nonzero padding bits")
        self.bits >>= n
        self.nbits -= n

    def skip(self, nbits: int) -> None:
        """Skip nbits, allowing long skips across bytes."""
        take = min(nbits, self.nbits)
        self.bits >>= take
        self.nbits -= take
        nbits -= take
        nbytes, rem = divmod(nbits, 8)
        if self.pos + nbytes > len(self.data):
            raise ShortInput("skip past end")
        self.pos += nbytes
        if rem:
            self.u(rem)

    @property
    def rel_bits(self) -> int:
        """Bit position relative to self.data (equals bits_consumed for a
        plain reader; windowed readers add a base offset in bits_consumed).
        Pair with self.data for native-core handoffs."""
        return self.pos * 8 - self.nbits

    def ensure_all(self) -> None:
        """Materialize everything reachable into self.data (no-op here;
        windowed readers pull their full source before a native handoff)."""

    def seek_rel_bits(self, bitpos: int) -> None:
        """Reposition to a bit offset relative to self.data."""
        self.pos = bitpos >> 3
        self.bits = 0
        self.nbits = 0
        rem = bitpos & 7
        if rem:
            self.u(rem)

    def seek_bits(self, bitpos: int) -> None:
        """Reposition to an absolute bit offset."""
        self.seek_rel_bits(bitpos)

    def no_more_bytes(self) -> None:
        """Assert properly padded end of buffer (j40.h:2011-2016)."""
        self.zero_pad_to_byte()
        check(
            self.nbits == 0 and self.pos == len(self.data),
            "excs",
            "trailing data in section",
        )
