"""Pull-based byte sources and the incremental codestream map.

The reference decodes from a pluggable pull source (``read(buf, fileoff,
maxsize)`` + optional seek, j40.h:1190-1388) through an incremental
ISOBMFF walk that maps codestream offsets to file offsets as boxes are
discovered (j40.h:1618-1642), so a multi-gigabyte or still-arriving
container never fully materializes.  This module is that layer for the
TPU build:

- :class:`Source` — the pull protocol (``read_at`` + ``size``).
- :class:`MemorySource` — zero-copy over a caller buffer; ``extend()``
  grows it for push-style streaming.
- :class:`FileSource` — chunked ``seek``/``read`` over a file path or
  handle (the reference's stdio source, j40.h:1348-1388).
- :class:`CodestreamSource` — the incremental box walk.  Section reads
  (``read(codeoff, size)``) assemble straight from the source on demand:
  nothing is cached, so peak RSS while decoding from a file is bounded by
  the sections currently in flight plus the small header window.

Box ordering/cardinality rules match ``io.container.parse_container``
(jxll/jxli at most once, jxlc precludes jxlp, jxlp final-index bit,
brob-wrapped jxl payloads rejected; reference j40.h:1479-1604).
"""

from __future__ import annotations

import io
import struct
from pathlib import Path

from ..errors import ShortInput, check
from .container import FTYP_BOX, JXL_BOX


class Source:
    """Pull-based byte source (reference j40__source_st, j40.h:1197-1205)."""

    def read_at(self, fileoff: int, n: int) -> bytes:
        """Up to n bytes at fileoff; short only when the source has no more."""
        raise NotImplementedError

    def size(self) -> int:
        """Bytes currently retrievable (a MemorySource may still grow)."""
        raise NotImplementedError

    @property
    def final(self) -> bool:
        """True when size() can no longer grow."""
        return True


class MemorySource(Source):
    """Source over a caller buffer; extend() appends (push streaming).

    `trim(upto)` releases bytes before file offset `upto` so a streaming
    decode holds only the uncommitted suffix (the reference's
    checkpoint-trim, j40.h:1706-1715); reads below the trim point are a
    programming error."""

    def __init__(self, data, final: bool = True):
        self._buf = bytearray(data)
        self._final = final
        self._base = 0  # file offset of _buf[0]

    def read_at(self, fileoff: int, n: int) -> bytes:
        off = fileoff - self._base
        assert off >= 0, "read below the trimmed checkpoint"
        return bytes(self._buf[off : off + n])

    def view_at(self, fileoff: int, n: int) -> memoryview:
        off = fileoff - self._base
        assert off >= 0, "read below the trimmed checkpoint"
        return memoryview(self._buf)[off : off + n]

    def size(self) -> int:
        return self._base + len(self._buf)

    @property
    def final(self) -> bool:
        return self._final

    def extend(self, data) -> None:
        self._buf.extend(data)

    def trim(self, upto: int) -> None:
        """Release buffered bytes before file offset `upto`."""
        drop = min(max(0, upto - self._base), len(self._buf))
        if drop:
            del self._buf[:drop]
            self._base += drop

    @property
    def retained(self) -> int:
        return len(self._buf)


class FileSource(Source):
    """Chunked pread-style source over a file path or binary handle."""

    def __init__(self, f):
        if isinstance(f, (str, Path)):
            self._f = open(f, "rb")
            self._owns = True
        else:
            self._f = f
            self._owns = False
        self._f.seek(0, io.SEEK_END)
        self._size = self._f.tell()

    def read_at(self, fileoff: int, n: int) -> bytes:
        self._f.seek(fileoff)
        out = self._f.read(n)
        return out or b""

    def size(self) -> int:
        return self._size

    def close(self) -> None:
        if self._owns:
            self._f.close()


class CodestreamSource:
    """Incremental codestream-offset -> file-offset map over a Source.

    ``advance()`` walks box headers as far as the source allows (payloads
    are skipped by seek, never materialized); ``read()`` assembles section
    bytes across span boundaries straight from the source."""

    def __init__(self, source: Source, allow_partial: bool = False):
        self.src = source
        self.allow_partial = allow_partial
        #: [codeoff, fileoff, length] with length -1 = runs to source end
        self.spans: list[list[int]] = []
        self.level: int | None = None
        self.frame_index_span: tuple[int, int] | None = None  # fileoff, len
        #: non-codestream boxes as (type, fileoff, length) — payloads are
        #: fetched on demand via read_box()
        self.boxes: list[tuple[bytes, int, int]] = []
        self.is_bare = False
        self._pos = 0          # file offset of the next unparsed box header
        self._sig_checked = False
        self._seen: set[bytes] = set()
        self._no_more_cs = False
        self._walk_done = False
        self._cs_len = 0       # mapped codestream bytes with known length
        self.advance()

    # -- box walk ----------------------------------------------------------

    def advance(self) -> None:
        """Resume the box walk as far as the source currently allows."""
        if self._walk_done:
            return
        if not self._sig_checked and not self._signature():
            return
        end = self.src.size()
        while not self._walk_done:
            # a mapped codestream span whose payload hasn't fully arrived
            # blocks the walk (but not reads within the span)
            if self._pos > end:
                if self.src.final:
                    if not self.allow_partial:
                        raise ShortInput("truncated box payload")
                    self._walk_done = True
                break
            hdr = self.src.read_at(self._pos, 16)
            if len(hdr) == 0:
                if self.src.final:
                    self._walk_done = True
                break
            if len(hdr) < 8 or (hdr[0:4] == b"\x00\x00\x00\x01" and len(hdr) < 16):
                # partial box header
                if self.src.final:
                    if not self.allow_partial:
                        raise ShortInput("truncated box header")
                    self._walk_done = True
                break
            (size32,) = struct.unpack_from(">I", hdr, 0)
            type_ = bytes(hdr[4:8])
            if size32 == 0:
                start, bend = self._pos + 8, -1
            elif size32 == 1:
                (size64,) = struct.unpack_from(">Q", hdr, 8)
                check(size64 >= 16, "boxx")
                start, bend = self._pos + 16, self._pos + size64
            else:
                check(size32 >= 8, "boxx")
                start, bend = self._pos + 8, self._pos + size32
            length = -1 if bend == -1 else bend - start
            truncated = bend != -1 and bend > end

            if type_ in (b"jxlc", b"jxlp"):
                if type_ == b"jxlc":
                    check(not self._no_more_cs, "box?")
                    check(not ({b"jxlc", b"jxlp"} & self._seen), "box?")
                    self._seen.add(b"jxlc")
                    self._no_more_cs = True
                    self.spans.append([self._cs_len, start, length])
                else:
                    check(not self._no_more_cs, "box?")
                    check(b"jxlc" not in self._seen, "box?")
                    check(length == -1 or length >= 4, "jxlp")
                    idx = self.src.read_at(start, 4)
                    if len(idx) < 4:
                        if self.src.final:
                            if not self.allow_partial:
                                raise ShortInput("truncated jxlp index")
                            self._walk_done = True
                        break
                    self._seen.add(b"jxlp")
                    # clear top bit of the index = final partial codestream
                    # (j40.h:1557)
                    if not (idx[0] >> 7):
                        self._no_more_cs = True
                    self.spans.append(
                        [self._cs_len, start + 4,
                         -1 if length == -1 else length - 4]
                    )
                if self.spans[-1][2] >= 0:
                    self._cs_len += self.spans[-1][2]
                if bend == -1:
                    self._walk_done = True
                    break
                self._pos = bend  # resume past this box once bytes arrive
                continue

            # non-codestream boxes: skip when payload incomplete (the
            # container parser's partial mode drops them too)
            if truncated or (bend == -1 and not self.src.final):
                if self.src.final:
                    if not self.allow_partial:
                        raise ShortInput("truncated box payload")
                    self._walk_done = True
                break
            if type_ == b"jxll":
                check(b"jxll" not in self._seen, "box?")
                self._seen.add(b"jxll")
                if length != 0:
                    payload = self.src.read_at(start, 1)
                    self.level = payload[0] if payload else None
            elif type_ == b"jxli":
                check(b"jxli" not in self._seen, "box?")
                self._seen.add(b"jxli")
                self.frame_index_span = (start, length)
            elif type_ == b"brob":
                inner = self.src.read_at(start, 4)
                check(len(inner) > 3 and (length == -1 or length > 4), "brot")
                check(inner != b"brob" and inner[:3] != b"jxl", "brot")
                self.boxes.append((b"brob", start, length))
            else:
                self.boxes.append((type_, start, length))
            if bend == -1:
                self._walk_done = True
                break
            self._pos = bend

        if self._walk_done and not self.is_bare:
            check(
                bool({b"jxlc", b"jxlp"} & self._seen),
                "shrt" if not self.spans else "box?",
            )

    def _signature(self) -> bool:
        """Detect bare codestream vs container; False = need more bytes."""
        head = self.src.read_at(0, len(JXL_BOX) + len(FTYP_BOX))
        if len(head) < 2:
            if self.src.final:
                raise ShortInput("container signature needs 2 bytes")
            return False
        if head[0] == 0xFF and head[1] == 0x0A:
            self.is_bare = True
            self.spans.append([0, 0, -1])
            self._sig_checked = True
            self._walk_done = True
            return True
        check(head[:2] == JXL_BOX[:2], "!jxl")
        need = len(JXL_BOX) + len(FTYP_BOX)
        if len(head) < need:
            if not (JXL_BOX + FTYP_BOX).startswith(head) or self.src.final:
                check(head == JXL_BOX[: len(head)], "!jxl")
                raise ShortInput("truncated container signature")
            return False
        check(head[: len(JXL_BOX)] == JXL_BOX, "!jxl")
        check(head[len(JXL_BOX) : need] == FTYP_BOX, "ftyp")
        self._pos = need
        self._sig_checked = True
        return True

    # -- codestream access ---------------------------------------------------

    def available(self) -> int:
        """Contiguous codestream bytes readable from offset 0 right now."""
        end = self.src.size()
        total = 0
        for _co, fo, ln in self.spans:
            have = max(0, min(end, fo + ln if ln >= 0 else end) - fo)
            total += have
            if ln < 0 or have < ln:
                break
        return total

    @property
    def complete(self) -> bool:
        """No more codestream bytes can arrive."""
        if self.src.final and self._walk_done:
            return True
        if not self._no_more_cs or not self.spans:
            return False
        co, fo, ln = self.spans[-1]
        return ln >= 0 and self.src.size() >= fo + ln

    def read(self, codeoff: int, size: int) -> bytes:
        """Exactly `size` codestream bytes at `codeoff` (ShortInput if not
        yet available).  Straight from the source: nothing is retained."""
        if size == 0:
            return b""
        if codeoff + size > self.available():
            raise ShortInput(
                f"codestream [{codeoff}, {codeoff + size}) not yet available"
            )
        parts = []
        need = size
        end = self.src.size()
        for co, fo, ln in self.spans:
            have = min(end, fo + ln if ln >= 0 else end) - fo
            if codeoff >= co + have:
                continue
            off_in = codeoff - co
            take = min(need, have - off_in)
            parts.append(self.src.read_at(fo + off_in, take))
            need -= take
            codeoff += take
            if need == 0:
                break
        out = b"".join(parts) if len(parts) != 1 else parts[0]
        if len(out) != size:
            raise ShortInput("source returned fewer bytes than mapped")
        return out

    def read_prefix(self, codeoff: int, want: int):
        """Up to `want` contiguous bytes at `codeoff` (header window pulls);
        zero-copy for the single-span in-memory case."""
        avail = self.available() - codeoff
        if avail <= 0:
            return b""
        n = min(want, avail)
        if (
            len(self.spans) == 1
            and isinstance(self.src, MemorySource)
            and self.src.final  # a view would pin the buffer against extend()
            and self.spans[0][2] == -1
        ):
            co, fo, _ = self.spans[0]
            return self.src.view_at(fo + (codeoff - co), n)
        return self.read(codeoff, n)

    def read_box(self, i: int) -> tuple[bytes, bytes]:
        """(type, payload) of the i-th auxiliary box, fetched on demand."""
        type_, fo, ln = self.boxes[i]
        n = (self.src.size() - fo) if ln < 0 else ln
        return type_, self.src.read_at(fo, n)

    @property
    def frame_index_box(self) -> bytes | None:
        if self.frame_index_span is None:
            return None
        fo, ln = self.frame_index_span
        n = (self.src.size() - fo) if ln < 0 else ln
        return self.src.read_at(fo, n)

    def extend(self, data) -> None:
        """Streaming append (MemorySource only) + incremental walk resume."""
        assert isinstance(self.src, MemorySource), "extend() needs MemorySource"
        self.src.extend(data)
        self.advance()

    def trim_codestream(self, codeoff: int) -> None:
        """Release source bytes before codestream offset `codeoff` — the
        committed-prefix trim that keeps streaming memory bounded
        (reference j40.h:1706-1715).  Conservative: never trims past the
        box-walk cursor or any mapped non-codestream box payload (those
        stay addressable for read_box)."""
        if not isinstance(self.src, MemorySource):
            return
        fo = None
        for co, f, ln in self.spans:
            if ln >= 0 and codeoff >= co + ln:
                continue
            fo = f + max(0, codeoff - co)
            break
        if fo is None:
            return
        # the box-walk cursor only matters while the walk is still running
        # (bare codestreams never move it)
        keep = fo if self._walk_done else min(fo, self._pos)
        for _t, bfo, _ln in self.boxes:
            keep = min(keep, bfo)
        if self.frame_index_span is not None:
            keep = min(keep, self.frame_index_span[0])
        self.src.trim(keep)

    @property
    def retained_bytes(self) -> int:
        return (self.src.retained
                if isinstance(self.src, MemorySource) else self.src.size())


class PrefixReader:
    """BitReader over a lazily-pulled, rebasable window of the codestream.

    Used for the sequential header/TOC parse.  Bit positions are absolute
    codestream positions; ``rebase()`` drops the window at frame boundaries
    so header parsing of a huge multi-frame file stays bounded-memory.
    Constructed via :func:`make_prefix_reader` (it subclasses the package
    BitReader to inherit all primitive reads)."""


def make_prefix_reader(cs: CodestreamSource, base: int = 0):
    from .bits import BitReader

    class _PrefixReader(BitReader):
        __slots__ = ("cs", "base")

        def __init__(self, cs, base):
            self.cs = cs
            self.base = base
            super().__init__(cs.read_prefix(base, 1 << 16))

        def _grow(self) -> bool:
            want = max(2 * len(self.data), len(self.data) + (1 << 16))
            new = self.cs.read_prefix(self.base, want)
            if len(new) <= len(self.data):
                return False
            self.data = memoryview(new)
            return True

        def _refill(self, n: int) -> None:
            while True:
                try:
                    return super()._refill(n)
                except ShortInput:
                    if not self._grow():
                        raise

        def skip(self, nbits: int) -> None:
            while True:
                need = (self.pos * 8 - self.nbits) + nbits
                if need <= len(self.data) * 8 or not self._grow():
                    break
            super().skip(nbits)

        @property
        def bits_consumed(self) -> int:
            return self.base * 8 + self.pos * 8 - self.nbits

        def seek_bits(self, bitpos: int) -> None:
            rel = bitpos - self.base * 8
            assert rel >= 0, "seek before window base (rebase first)"
            while rel > len(self.data) * 8 and self._grow():
                pass
            self.pos = rel >> 3
            self.bits = 0
            self.nbits = 0
            if rel & 7:
                self.u(rel & 7)

        def ensure_all(self) -> None:
            while self._grow():
                pass

        def rebase(self, codeoff: int) -> None:
            """Drop the window; subsequent reads start at `codeoff`."""
            self.base = codeoff
            self.data = memoryview(self.cs.read_prefix(codeoff, 1 << 16))
            self.pos = 0
            self.bits = 0
            self.nbits = 0

        def extend_data(self, data) -> None:  # legacy push() path
            self._grow()

    return _PrefixReader(cs, base)
