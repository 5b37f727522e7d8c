"""Self-correcting (weighted) predictor state (reference j40.h:3938-4125,
spec §10.2.3).

Keeps a two-row ring of per-pixel error vectors; the final prediction is an
error-weighted blend of four sub-predictors, clamped when neighborhood errors
agree in sign.  All arithmetic matches the reference's int32/int64 semantics
(Python ints are exact, and valid streams stay in range).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..io.bits import floor_lg

# [i] = floor(2^24 / (i+1)), used for the divisions (j40.h:3905-3914)
DIV24 = [0x1000000 // (i + 1) for i in range(64)]


@dataclass(frozen=True)
class WPParams:
    p1: int = 16
    p2: int = 10
    p3: tuple = (7, 7, 7, 0, 0)
    w: tuple = (13, 12, 12, 12)


class WPState:
    __slots__ = ("width", "params", "errors", "pred", "trueerrw", "trueerrn",
                 "trueerrnw", "trueerrne")

    def __init__(self, params: WPParams, width: int):
        self.width = width
        self.params = params
        # two rows of 5-vectors: [0..3] sub-predictor abs errors, [4] signed
        self.errors = [[0] * 5 for _ in range(width * 2)]
        self.pred = [0] * 5
        self.trueerrw = self.trueerrn = self.trueerrnw = self.trueerrne = 0

    def reset(self) -> None:
        for e in self.errors:
            for i in range(5):
                e[i] = 0
        self.pred = [0] * 5
        self.trueerrw = self.trueerrn = self.trueerrnw = self.trueerrne = 0

    def before_predict(self, x: int, y: int, pw: int, pn: int, pnw: int,
                       pne: int, pnn: int) -> None:
        width, params = self.width, self.params
        err_base = width if (y & 1) else 0
        nerr_base = 0 if (y & 1) else width
        ZERO = (0, 0, 0, 0, 0)
        errors = self.errors

        errw = errors[err_base + x - 1] if x > 0 else ZERO
        errn = errors[nerr_base + x] if y > 0 else ZERO
        errnw = errors[nerr_base + x - 1] if (x > 0 and y > 0) else errn
        errne = errors[nerr_base + x + 1] if (x + 1 < width and y > 0) else errn
        errww = errors[err_base + x - 2] if x > 1 else ZERO
        # edge case: at the right edge errw is double-counted (j40.h:4037)
        errw2 = ZERO if x + 1 < width else errw

        self.trueerrw = errors[err_base + x - 1][4] if x > 0 else 0
        self.trueerrn = errors[nerr_base + x][4] if y > 0 else 0
        self.trueerrnw = (
            errors[nerr_base + x - 1][4] if (x > 0 and y > 0) else self.trueerrn
        )
        self.trueerrne = (
            errors[nerr_base + x + 1][4] if (x + 1 < width and y > 0) else self.trueerrn
        )

        pred = self.pred
        pred[0] = (pw + pne - pn) * 8
        pred[1] = pn * 8 - (
            ((self.trueerrw + self.trueerrn + self.trueerrne) * params.p1) >> 5
        )
        pred[2] = pw * 8 - (
            ((self.trueerrw + self.trueerrn + self.trueerrnw) * params.p2) >> 5
        )
        pred[3] = pn * 8 - (
            (
                self.trueerrnw * params.p3[0]
                + self.trueerrn * params.p3[1]
                + self.trueerrne * params.p3[2]
                + (pnn - pn) * 8 * params.p3[3]
                + (pnw - pw) * 8 * params.p3[4]
            )
            >> 5
        )

        w = [0] * 4
        for i in range(4):
            errsum = errn[i] + errw[i] + errnw[i] + errww[i] + errne[i] + errw2[i]
            shift = max(floor_lg(errsum + 1) - 5, 0)
            w[i] = 4 + ((params.w[i] * DIV24[errsum >> shift]) >> shift)
        logw = floor_lg(w[0] + w[1] + w[2] + w[3]) - 4
        wsum = 0
        s = 0
        for i in range(4):
            w[i] >>= logw
            wsum += w[i]
            s += pred[i] * w[i]
        pred[4] = ((s + (wsum >> 1) - 1) * DIV24[wsum - 1]) >> 24
        if ((self.trueerrn ^ self.trueerrw) | (self.trueerrn ^ self.trueerrnw)) <= 0:
            lo = min(pw, pn, pne) * 8
            hi = max(pw, pn, pne) * 8
            pred[4] = min(max(lo, pred[4]), hi)

    def after_predict(self, x: int, y: int, val: int) -> None:
        err = self.errors[(self.width if (y & 1) else 0) + x]
        pred = self.pred
        v8 = val * 8
        for i in range(4):
            err[i] = (abs(pred[i] - v8) + 3) >> 3
        err[4] = pred[4] - v8  # signed (j40.h:4109)

    @property
    def max_error_property(self) -> int:
        """Property 15: the true error with the largest magnitude (j40.h:4197)."""
        val = self.trueerrw
        if abs(val) < abs(self.trueerrn):
            val = self.trueerrn
        if abs(val) < abs(self.trueerrnw):
            val = self.trueerrnw
        if abs(val) < abs(self.trueerrne):
            val = self.trueerrne
        return val
