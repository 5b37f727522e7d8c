"""LSB-first bit writer — the encoder-side dual of io.bits.BitReader.

The reference is decode-only; this writer exists so the framework can
synthesize valid JPEG XL bitstreams for tests, benchmarks, and as a user-facing
encoder for the supported subset.  Bit order matches ISO/IEC 18181-1 §4
(LSB-first within bytes), verified round-trip against io.bits.BitReader and
end-to-end against the reference ``dj40`` binary.
"""

from __future__ import annotations

from ..io.bits import ceil_lg


class BitWriter:
    __slots__ = ("out", "bits", "nbits")

    def __init__(self):
        self.out = bytearray()
        self.bits = 0
        self.nbits = 0

    def u(self, n: int, value: int) -> None:
        assert 0 <= value < (1 << n), (n, value)
        self.bits |= value << self.nbits
        self.nbits += n
        while self.nbits >= 8:
            self.out.append(self.bits & 0xFF)
            self.bits >>= 8
            self.nbits -= 8

    def u32(self, spec, value: int) -> None:
        """Write using a 4-way distribution spec ((o0,n0),...,(o3,n3)).

        Picks the cheapest selector that can represent ``value``.
        """
        best = None
        for sel, (off, n) in enumerate(spec):
            if off <= value < off + (1 << n):
                cost = 2 + n
                if best is None or cost < best[0]:
                    best = (cost, sel, off, n)
        assert best is not None, f"u32 cannot encode {value} with {spec}"
        _, sel, off, n = best
        self.u(2, sel)
        self.u(n, value - off)

    def u64(self, value: int) -> None:
        if value == 0:
            self.u(2, 0)
        elif value <= 16:
            self.u(2, 1)
            self.u(4, value - 1)
        elif value <= 272:
            self.u(2, 2)
            self.u(8, value - 17)
        else:
            self.u(2, 3)
            self.u(12, value & 0xFFF)
            value >>= 12
            shift = 12
            while value:
                self.u(1, 1)
                nb = 8 if shift < 56 else 64 - shift
                self.u(nb, value & ((1 << nb) - 1))
                value >>= nb
                shift += 8
            if shift < 64:
                self.u(1, 0)

    def enum(self, value: int) -> None:
        self.u32(((0, 0), (1, 0), (2, 4), (18, 6)), value)

    def bool_(self, value: bool) -> None:
        self.u(1, int(value))

    def at_most(self, maxval: int, value: int) -> None:
        assert 0 <= value <= maxval
        if maxval > 0:
            self.u(ceil_lg(maxval + 1), value)

    def f16(self, value: float) -> None:
        import struct

        (bits,) = struct.unpack("<H", struct.pack("<e", value))
        self.u(16, bits)

    def u_array(self, nbits, values) -> None:
        """Vectorized multi-field write, equivalent to sequential u() calls.

        Fields are packed LSB-first with numpy: bit offsets by cumsum, each
        shifted field scattered into bytes with np.add.at — carry-free since
        distinct fields occupy disjoint bits.  Each nbits[i] must be <= 56."""
        import numpy as np

        nbits = np.asarray(nbits, dtype=np.int64)
        vals = np.asarray(values, dtype=np.uint64)
        total = int(nbits.sum())
        if total == 0:
            return
        assert int(nbits.max()) <= 56
        end = np.cumsum(nbits)
        start = (end - nbits) + self.nbits
        endbit = self.nbits + total
        buf = np.zeros((endbit >> 3) + 9, dtype=np.uint8)
        buf[0] = self.bits  # pending partial byte (nbits < 8 here)
        byte0 = start >> 3
        shifted = vals << (start & 7).astype(np.uint64)
        for k in range(8):
            np.add.at(
                buf, byte0 + k,
                ((shifted >> np.uint64(8 * k)) & np.uint64(0xFF)).astype(np.uint8),
            )
        self.out.extend(buf[: endbit >> 3].tobytes())
        self.bits = int(buf[endbit >> 3]) if endbit & 7 else 0
        self.nbits = endbit & 7

    def zero_pad_to_byte(self) -> None:
        if self.nbits:
            self.u((-self.nbits) % 8, 0)

    @property
    def bit_length(self) -> int:
        return len(self.out) * 8 + self.nbits

    def finish(self) -> bytes:
        self.zero_pad_to_byte()
        return bytes(self.out)
