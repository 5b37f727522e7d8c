"""A CPU model of kernel S1's schedule (j40_tpu_torch/csrc/squeeze.cu, the
inverse Squeeze merge) and the inputs its tests and measurements share.

The merge walks each chain (a row of a horizontal merge, a column of a
vertical one) over its column pairs, carrying `left`, the sample the pair
before wrote last.  The kernel cuts that chain of dependent steps:
- a warp walks a window of 32 segments of `seg_len(wr)` pairs (8 when
  one window holds the chain, else 16), a lane a segment; the window's
  first segment starts from the exact `left` (the chain's first sample,
  or the window before's last);
- a later segment starts from two ends: pair x - 1's second sample with
  SmoothTendency at each end of its range, [min(0, 2(a - n)), max(0, 2(a -
  n))].  One pair maps `left` monotonically (non-increasing), so the true
  walk stays between the two walks, and from the first pair `c` at which
  the two are equal every output is exact;
- the resolve: a segment whose walks met hands its exit to the next one; a
  segment whose walks never met walks again in full once its input is
  known, in rounds, in segment order;
- the re-walk: every segment walks its first min(c, pairs) pairs again
  from its true input;
- the margin: the argument needs every int32 sum exact, so a window of a
  chain with a sample beyond +-MARGIN (or entered with |left| beyond
  CARRY_MARGIN) has no segment that meets: its segments walk in full, in
  order, in int32 arithmetic with wrap, as the plain version does.
The module also holds the kernel's shared-memory layout (`slots`,
`region_words`).

It imports torch, numpy and the port only (no jax, no j40_tpu):
chip_smoke.py reads the model's counts on the card machine, and
tests/test_torch_squeeze_design.py holds the model against the plain
version and j40_tpu's scan."""

import numpy as np
import torch

from j40_tpu_torch.ops import squeeze_kernels as SQ

#: csrc/squeeze.cu's constants: segments a window (a warp's lanes), the
#: sample margin, the margin of `left` entering a window, the segment
#: lengths a launch picks from
LANES = 32
MARGIN = 1 << 26
CARRY_MARGIN = 4 * MARGIN
SEG_LENS = (8, 16)
#: the column kernel's CTA: neighbouring columns, a warp each; the words
#: between two warps' regions beyond their rows (the CTA's columns then
#: fall REGION_STAGGER banks apart)
COL_WARPS = 4
REGION_STAGGER = 32 // COL_WARPS


def seg_len(wr: int) -> int:
    """csrc/squeeze.cu's seg_len: 8 when one window holds the chain, else
    16."""
    return 8 if wr <= LANES * 8 else 16


def _pair(left, avg, nxt, res):
    """One column pair: its first sample and the new `left`."""
    diff = res + SQ._smooth_tendency(left, avg, nxt)
    first = avg + SQ._trunc_div(diff, 2)
    return first, first - diff


def _second(avg, diff):
    """The pair's second sample given its diff (residual + tendency)."""
    return avg + SQ._trunc_div(diff, 2) - diff


def _in_margin(t, m):
    return (t >= -m) & (t <= m)


def model_unsqueeze(down, residu, horizontal: bool, *, seg: int | None = None,
                    margin: int | None = MARGIN, rewalk_short: int = 0, one_end: bool = False):
    """The kernel's schedule on CPU tensors: (out, counts).  `seg` fixes
    the segment length (else seg_len(wr)); margin=None drops the margin
    check, rewalk_short shortens every re-walk and one_end starts both
    walks of a segment from the tendency 0 (negative cases).  counts:
    seg, windows, segments (that hold a pair), met (segments whose two
    walks met, outside margin windows), unmet (their walks full, in
    order), longest_rewalk (the largest c of a met segment),
    margin_windows ((chain, window)s walked in full), rounds (the most
    resolve rounds of a window)."""
    if not horizontal:
        out, counts = model_unsqueeze(down.T, residu.T, True, seg=seg, margin=margin,
                                      rewalk_short=rewalk_short, one_end=one_end)
        return out.T.contiguous(), counts
    down = down.to(torch.int32).contiguous()
    residu = residu.to(torch.int32).contiguous()
    chains, wd = down.shape
    wr = residu.shape[1]
    L = seg or seg_len(wr)
    counts = dict(seg=L, windows=0, segments=0, met=0, unmet=0, longest_rewalk=0,
                  margin_windows=0, rounds=0)
    out = torch.zeros((chains, wd + wr), dtype=torch.int32)
    if chains == 0:
        return out, counts
    lane = torch.arange(LANES)
    carry = down[:, 0].clone()
    for x0 in range(0, wr, LANES * L):
        n = min(LANES * L, wr - x0)
        # the staged window: down at x0 - 1 .. x0 + 32L (clamped to the
        # last sample, the next average of the last pair), residu at x0 - 1
        # .. x0 + 32L - 1 (zero past the chain); lane s's slots are
        # positions x0 + sL - 1 .. x0 + sL + L (down), .. + L - 1 (residu)
        pos = torch.arange(-1, LANES * L + 1) + x0
        dwin = torch.where(pos >= 0, down[:, pos.clamp(0, wd - 1)], 0)
        rpos = pos[:-1]
        rwin = torch.where((rpos >= 0) & (rpos < wr), residu[:, rpos.clamp(0, max(wr - 1, 0))],
                           0)
        d = dwin.unfold(1, L + 2, L)  # (chains, 32, L + 2): j = -1 .. L at [j + 1]
        r = rwin.unfold(1, L + 1, L)  # (chains, 32, L + 1): j = -1 .. L - 1
        cnt = (n - lane * L).clamp(0, L)  # pairs a lane holds
        if margin is None:
            bad = torch.zeros(chains, dtype=torch.bool)
        else:
            ok = _in_margin(d, margin).all(-1) & _in_margin(r, margin).all(-1)
            bad = ~ok.all(1) | ~_in_margin(carry, 4 * margin)
        # the two ends: pair x - 1 with its tendency at either end of its range
        a_p, n_p, r_p = d[..., 0], d[..., 1], r[..., 0]
        an2 = torch.zeros_like(a_p) if one_end else 2 * (a_p - n_p)
        a = _second(a_p, r_p + torch.clamp(an2, max=0))  # the high end
        b = _second(a_p, r_p + torch.clamp(an2, min=0))  # the low end
        a[:, 0] = carry
        b[:, 0] = carry
        c = torch.full((chains, LANES), L + 1, dtype=torch.int32)
        stage = torch.zeros((chains, LANES, 2 * L), dtype=torch.int32)
        for j in range(L):
            avg, nxt, res = d[..., j + 1], d[..., j + 2], r[..., j + 1]
            eq = a == b
            c = torch.where(eq & (c > L), j, c)
            fa, a = _pair(a, avg, nxt, res)
            _, b = _pair(b, avg, nxt, res)
            keep = eq & (j < cnt)
            stage[..., 2 * j] = torch.where(keep, fa, stage[..., 2 * j])
            stage[..., 2 * j + 1] = torch.where(keep, a, stage[..., 2 * j + 1])
        c = torch.where((a == b) & (c > L), L, c)
        c[bad] = L + 1
        exact = c <= L
        has = (cnt > 0).expand(chains, LANES)
        counts["windows"] += 1
        counts["segments"] += int(has.sum())
        counts["met"] += int((exact & has).sum())
        counts["unmet"] += int((~exact & has & ~bad[:, None]).sum())
        counts["margin_windows"] += int(bad.sum())
        if (exact & has).any():
            counts["longest_rewalk"] = max(counts["longest_rewalk"],
                                           int(torch.minimum(c, cnt)[exact & has].max()))
        # the resolve and the re-walk, in rounds: a lane walks once its
        # input is exact, then its exit is
        exitv = a.clone()
        inp = torch.cat([carry[:, None], exitv[:, :-1]], 1)
        have = torch.cat([torch.ones(chains, 1, dtype=torch.bool), exact[:, :-1]], 1)
        todo = has.clone()
        rounds = 0
        while todo.any():
            go = have & todo
            k = torch.minimum(c, cnt) - rewalk_short
            left = inp.clone()
            for j in range(L):
                m = go & (j < k)
                f, nl = _pair(left, d[..., j + 1], d[..., j + 2], r[..., j + 1])
                stage[..., 2 * j] = torch.where(m, f, stage[..., 2 * j])
                stage[..., 2 * j + 1] = torch.where(m, nl, stage[..., 2 * j + 1])
                left = torch.where(m, nl, left)
            exitv = torch.where(go & ~exact, left, exitv)
            exact |= go
            todo &= ~go
            newly = ~have[:, 1:] & exact[:, :-1]
            inp[:, 1:] = torch.where(newly, exitv[:, :-1], inp[:, 1:])
            have[:, 1:] |= exact[:, :-1]
            rounds += 1
        counts["rounds"] = max(counts["rounds"], rounds)
        out[:, 2 * x0:2 * x0 + 2 * n] = stage.reshape(chains, LANES * 2 * L)[:, :2 * n]
        carry = exitv[:, LANES - 1]
    if (wd + wr) & 1:
        out[:, -1] = down[:, -1]
    return out, counts


# ------------------------------------------------- the shared-memory layout

def slots(L: int) -> dict:
    """csrc/squeeze.cu's padded rows of one warp's window: (stride a lane,
    first slot, slots a lane, words) of down (j = -1 .. L), residu (j = -1 ..
    L - 1) and the outputs (2L a lane)."""
    return {"down": (L + 3, 0, L + 2, LANES * (L + 3)),
            "res": (L + 1, 0, L + 1, LANES * (L + 1)),
            "out": (2 * L + 1, 0, 2 * L, LANES * (2 * L + 1))}


def region_words(L: int) -> int:
    """Words of shared memory a warp (csrc/squeeze.cu's Window::kWords):
    the three rows and REGION_STAGGER, which puts the column kernel's
    COL_WARPS columns that many banks apart."""
    return sum(v[3] for v in slots(L).values()) + REGION_STAGGER


# ------------------------------------------------------------------ inputs

def plane(rng, shape, values):
    """Samples of a merge input: 14-bit, full-range int32, or within 1000
    of either end of int32 (test_torch_unsqueeze's cases)."""
    if values == "near_edge":
        v = rng.integers(0, 1000, shape, dtype=np.int64)
        v = np.where(rng.random(shape) < 0.5, (1 << 31) - 1 - v, -(1 << 31) + v)
    elif values == "int32":
        v = rng.integers(-(1 << 31), 1 << 31, shape, dtype=np.int64)
    else:
        v = rng.integers(-(1 << 13), 1 << 13, shape, dtype=np.int64)
    return v.astype(np.int32)


def merge_inputs(horizontal, chains, wd, wr, values, seed):
    rng = np.random.default_rng(seed)
    if horizontal:
        return plane(rng, (chains, wd), values), plane(rng, (chains, wr), values)
    return plane(rng, (wd, chains), values), plane(rng, (wr, chains), values)


def ramp(horizontal, chains, wd, wr):
    """The input no segment meets on: down[x] = -x along every chain, zero
    residuals; the two walks stay one apart."""
    down = np.tile(-np.arange(wd, dtype=np.int32), (chains, 1))
    residu = np.zeros((chains, wr), np.int32)
    return (down, residu) if horizontal else (down.T.copy(), residu.T.copy())
