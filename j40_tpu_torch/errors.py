"""Error model for the TPU-native JPEG XL decoder.

Mirrors the reference's 4-character error-code lattice (j40.h:464-585): every
failure carries a stable 4-char code so differential tests can compare failure
modes against ``dj40``.  Unlike the reference's first-error-wins C scheme we use
exceptions; only ``"shrt"`` (premature end of input) is retryable, which the
streaming API uses to implement resumable decoding (j40.h:530-534).
"""

from __future__ import annotations


class J40Error(Exception):
    """Base decode error with a 4-character code."""

    #: stable 4-char code, e.g. "shrt", "bstr", "tree"
    code: str = "????"

    def __init__(self, code: str | None = None, message: str = ""):
        if code is not None:
            self.code = code
        self.message = message
        super().__init__(f"{self.code}: {message}" if message else self.code)

    @property
    def retryable(self) -> bool:
        return self.code == "shrt"


class ShortInput(J40Error):
    """Premature end of input — the only retryable error (j40.h:531)."""

    code = "shrt"

    def __init__(self, message: str = "premature end of input"):
        super().__init__(None, message)


class Unsupported(J40Error):
    """Feature is valid per spec but not implemented yet."""

    code = "TODO"


def check(cond: bool, code: str, message: str = "") -> None:
    """Raise ``J40Error(code)`` unless ``cond`` holds (analog of J40__SHOULD)."""
    if not cond:
        raise J40Error(code, message)
