"""Public API mirroring the reference's surface (j40.h:163-274, 8240-8477).

The reference exposes handle-based C calls (`j40_from_file`, `j40_next_frame`,
`j40_frame_pixels_u8x4`, ...); this is the Python-idiomatic equivalent with
the same semantics:

- open is lazy: no parsing happens until `next_frame()` (j40.h:8342-8360);
- only the RGBA/U8X4 output format is supported (j40.h:8369-8372);
- errors are sticky 4-char codes, first-error-wins; only "shrt" (premature
  end of input) is retryable: push more bytes and call `next_frame()` again
  (j40.h:530-534, 8146-8169);
- API misuse yields the 21x7 "error pixels" placeholder instead of raising
  (j40.h:8429-8441).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .errors import J40Error, ShortInput

# output formats — the reference's wire values (j40.h:175-205), so code
# ported from j40 can pass J40_RGBA / J40_U8X4 literals unchanged
RGBA = 0x1755
U8X4 = 0x0F33
U16X4 = 0x0F35  # reserved in the reference; we support it (16-bit output)
_LEGACY_U8X4 = 0x0F  # early alias kept for compatibility
_LEGACY_RGBA = 4  # early alias kept for compatibility

# "error pixels": 21x7 dark-red placeholder returned on API misuse
# (j40.h:8429-8441)
_ERROR_W, _ERROR_H = 21, 7


def _error_pixels() -> np.ndarray:
    out = np.zeros((_ERROR_H, _ERROR_W, 4), dtype=np.uint8)
    out[:, :, 0] = 0x80
    out[:, :, 3] = 0xFF
    return out


# error message table (reference parity: j40.h:8004-8028)
_ERROR_STRINGS = {
    "fmt?": "Bad `format` parameter",
    "!mem": "Out of memory",
    "!jxl": "The JPEG XL signature is not found",
    "open": "Failed to open file",
    "bigg": "Image dimensions are too large to handle",
    "flen": "File is too lengthy to handle",
    "shrt": "Premature end of file",
    "slim": "Image size limit reached",
    "elim": "Extra channel number limit reached",
    "xlim": "Modular transform limit reached",
    "tlim": "Meta-adaptive tree size or depth limit reached",
    "plim": "ICC profile length limit reached",
    "fbpp": "Given bits per pixel value is disallowed",
    "fblk": "Black extra channel is disallowed",
    "fm32": "32-bit buffers for modular encoding are disallowed",
    "TODO": "Unimplemented feature encountered",
    "TEST": "Testing-only error occurred",
}


class Frame:
    """Decoded frame handle (j40_frame analog)."""

    def __init__(self, rgba: np.ndarray, duration: int = 0):
        self._rgba = rgba
        #: display duration in animation ticks (0 for still images)
        self.duration = duration

    @property
    def width(self) -> int:
        return self._rgba.shape[1]

    @property
    def height(self) -> int:
        return self._rgba.shape[0]

    def pixels_u8x4(self) -> np.ndarray:
        """(h, w, 4) uint8 RGBA (j40_frame_pixels_u8x4)."""
        if self._rgba.dtype != np.uint8:
            raise J40Error("fmt?", "frame was decoded as U16X4")
        return self._rgba

    def pixels_u16x4(self) -> np.ndarray:
        """(h, w, 4) uint16 RGBA (J40_U16X4, reserved in the reference)."""
        if self._rgba.dtype != np.uint16:
            raise J40Error("fmt?", "frame was decoded as U8X4")
        return self._rgba

    def row_u8x4(self, y: int) -> np.ndarray:
        """One row of RGBA pixels (j40_row_u8x4)."""
        return self._rgba[y]

    def row_u16x4(self, y: int) -> np.ndarray:
        """One row of 16-bit RGBA pixels (j40_row_u16x4, reserved in the
        reference)."""
        if self._rgba.dtype != np.uint16:
            raise J40Error("fmt?", "frame was decoded as U8X4")
        return self._rgba[y]


class Image:
    """Decoder handle (j40_image analog).

    Usage::

        im = Image.from_file("x.jxl")      # or Image.from_memory(data)
        im.output_format(RGBA, U8X4)
        if im.next_frame():
            rgba = im.current_frame().pixels_u8x4()
        elif im.error == "shrt":
            im.push(more_bytes)            # streaming: feed and retry
    """

    def __init__(self, data=b"", backend: str = "torch", device=None):
        # bytes buffer OR a pull Source (from_file routes through a
        # FileSource so a large container never materializes; j40's own
        # from_file decodes from a FILE the same way, j40.h:8342)
        from .io.source import Source

        if isinstance(data, Source):
            self._buf = None
            self._source = data
        else:
            self._buf = bytearray(data)
            self._source = None
        self._backend = backend
        self._device = device  # port: torch device, None means CUDA
        self._err: str | None = None
        self._err_msg = ""
        self._err_origin: str | None = None  # which API call failed
        self._frame: Frame | None = None
        self._format_set = False
        self._dec = None  # persistent streaming Decoder (section resume)
        self._frames_emitted = 0
        self._bit_format = U8X4

    # -- constructors (j40_from_file / j40_from_memory) -------------------

    @classmethod
    def from_file(cls, path: str | Path, backend: str = "torch",
                  device=None) -> "Image":
        from .io.source import FileSource

        try:
            src = FileSource(path)
        except OSError as e:
            im = cls()
            im._err = "open"
            im._err_msg = str(e)  # carries the strerror text (j40.h:8305)
            im._err_origin = "from_file"
            return im
        return cls(src, backend=backend, device=device)

    @classmethod
    def from_memory(cls, data: bytes, backend: str = "torch",
                    device=None) -> "Image":
        return cls(data, backend=backend, device=device)

    # -- configuration -----------------------------------------------------

    def output_format(self, pixel_format: int = RGBA, bit_format: int = U8X4) -> bool:
        """RGBA with U8X4 (like the reference, j40.h:8369-8372) or U16X4
        (reserved there, supported here)."""
        if pixel_format not in (RGBA, _LEGACY_RGBA) or bit_format not in (
            U8X4, U16X4, _LEGACY_U8X4
        ):
            self._err = "fmt?"
            self._err_origin = "output_format"
            return False
        self._bit_format = U16X4 if bit_format == U16X4 else U8X4
        self._format_set = True
        return True

    # -- streaming ---------------------------------------------------------

    def push(self, data: bytes) -> None:
        """Append more input bytes; clears a retryable 'shrt' error.

        The live decoder (and any mid-frame section progress) is kept:
        re-entry resumes at the first incomplete section, so each section of
        a chunked stream is decoded exactly once (the reference's buffer
        checkpoint + coroutine analog, j40.h:1662, 8146-8169)."""
        if self._buf is None:
            self._err = "flmt"
            self._err_msg = "push() on a file/source-backed image"
            self._err_origin = "push"
            return
        self._buf.extend(data)
        if self._dec is not None:
            try:
                self._dec.push(data)
            except J40Error as e:
                self._err = e.code
                self._err_msg = e.message
                self._err_origin = "push"
                self._dec = None
                return
        if self._err == "shrt":
            self._err = None

    # -- decoding ----------------------------------------------------------

    def next_frame(self) -> bool:
        """Decode the next frame; False on error (check .error).

        A 'shrt' error means more input is needed: push() and retry, matching
        the reference's resumable coroutine semantics.  Re-entry resumes at
        the last completed frame boundary via a saved checkpoint (bit offset
        + reference-frame slots); only the interrupted frame is re-decoded.
        """
        if self._err is not None and self._err != "shrt":
            return False
        from .decode import Decoder

        try:
            if self._dec is None:
                # creation itself can fail with 'shrt' (headers not yet
                # pushed); we then retry creation on the next call
                if self._source is not None:
                    self._dec = Decoder(self._source, backend=self._backend,
                                        device=self._device)
                else:
                    self._dec = Decoder(bytes(self._buf),
                                        backend=self._backend, streaming=True,
                                        device=self._device)
            if self._dec.done:
                return False  # no more frames; error stays clear
            fr = self._dec.decode_frame()
            rgba = (self._dec.render_rgba16()
                    if self._bit_format == U16X4 else self._dec.render_rgba8())
        except ShortInput as e:
            self._err = "shrt"
            self._err_msg = e.message
            self._err_origin = "next_frame"
            return False
        except J40Error as e:
            self._err = e.code
            self._err_msg = e.message
            self._err_origin = "next_frame"
            return False
        self._err = None
        self._frames_emitted += 1
        self._frame = Frame(rgba, duration=fr.header.duration)
        return True

    def current_frame(self) -> Frame:
        """The last decoded frame, or the error-pixels placeholder on misuse
        (j40.h:8403-8441)."""
        if self._frame is None:
            return Frame(_error_pixels())
        return self._frame

    # -- metadata ----------------------------------------------------------

    @property
    def icc_profile(self) -> bytes | None:
        """Raw entropy-decoded ICC payload, available once a frame has been
        requested on a stream that carries one.  (The reference decodes the
        payload and then discards it, j40.h:3390-3392; we retain it.)"""
        if self._dec is not None:
            return getattr(self._dec.image, "icc", None)
        return None

    # -- errors (j40_error / j40_error_string) -----------------------------

    @property
    def error(self) -> str | None:
        return self._err

    def error_string(self) -> str:
        """Human-readable error with the originating API call, mirroring the
        reference's table + "during j40_<api>" format (j40.h:8004-8028,
        8251-8319); our extra diagnostic detail follows after a colon."""
        if self._err is None:
            return "successful"
        base = _ERROR_STRINGS.get(self._err)
        if base is None:
            base = f"Decoding failed ({self._err})"
        if self._err_origin:
            base = f"{base} during {self._err_origin}"
        return f"{base}{': ' + self._err_msg if self._err_msg else ''}"

    # -- lifecycle ---------------------------------------------------------

    def free(self) -> None:
        """j40_free analog (releases buffers; the handle stays usable for
        error queries only)."""
        self._buf = bytearray()
        self._frame = None
        self._dec = None

    def __enter__(self) -> "Image":
        return self

    def __exit__(self, *exc) -> None:
        self.free()
