"""A CPU model of the wavefront kernels' schedule (csrc/wavefront.cu: W1,
and W2 with its tree mode W3), held bit for bit against their plain
versions (j40_tpu_torch/ops/device_entropy.py) and j40_tpu's lax.scan
programs, as tests/test_torch_dct8_design.py models B1/B2.

The model runs the kernels' schedule:
- a CTA of `threads` threads in warps of 32 lanes; warp w owns the bands
  of 32 rows w, w + warps, ... and walks them one after the other; at its
  step s, lane i of band j computes row 32j + i at column s - k*i (k = 1
  for W1, 2 for W2);
- within a warp, what a lane reads of the row above at step s is what the
  lane above computed at step s - 1: a shuffle, here a shift along the
  lane axis; older neighbours are carried lane by lane;
- across warps, lane 0 reads the band above's last row from a ring of
  `ring` slots of (value, sequence number) words, and waits until its slot
  carries the number it wants; lane 31 writes a chunk's slots once the
  consumer's count `con`, stored once a chunk, is past their previous use;
- warps interleave one step at a time, in a random order or the most or
  least advanced band first, subject only to those two waits;
- residuals (and codes) are read a chunk of `chunk` steps ahead into a
  buffer, and outputs written a chunk at a time.
A hand-off one column early gives a wrong plane; a producer one slot past
the ring overwrites a value before it is read, and its consumer waits
forever; a plane taller than the CTA and wider than `tall_width_limit`
deadlocks.

Everything is integer, so everything must be EQUAL; against JAX, a lane
whose WP error state leaves the exactness envelope (the overflow flag) is
compared by its flag alone (tests/test_torch_modular_recon.py).

The shapes, parameters and trees here feed the card tests of the kernels
(tests/test_torch_cuda.py), which run where there is no jax: this file
imports j40_tpu inside its tests only."""

import numpy as np
import pytest
import torch

from j40_tpu_torch.modular.wp import DIV24, WPParams
from j40_tpu_torch.ops import device_entropy as DE
from j40_tpu_torch.ops import wavefront_kernels as WK

I32 = np.int32
DIV = np.asarray(DIV24, I32)
LANE = np.arange(32)[:, None]  # (32, 1): a lane's row in its band


#: csrc/wavefront.cu's constants, which j40tt_wavefront_limits reports
#: (tests/test_torch_cuda.py holds the library to these): rows a CTA (W1,
#: W1 with codes, W2), steps a residual chunk and ring slots a band
#: boundary (W1, W2)
THREADS = {"plain": 1024, "mixed": 512, "wp": 512}
PLAIN_CHUNK, PLAIN_RING, WP_CHUNK, WP_RING = 8, 64, 4, 32


def tall_width_limit(k: int, look: int, warps: int, ring: int, chunk: int) -> int:
    """csrc/wavefront.cu's tall_width_limit: the widest plane with more
    32-row bands than the CTA has warps whose hand-offs cannot deadlock
    (k = 1, look = 0 for W1; k = 2, look = 1 for W2).  The last band of a
    round cannot consume until its warp has finished its previous band, so
    the band above it stops at column `ring`; each band further up runs
    `ring` columns past the chunks the band below completed."""
    b = ring
    for _ in range(1, warps):
        b = chunk * ((b + 31 * k + look) // chunk) + ring
    return b


class Deadlock(Exception):
    """No warp can take its next step, and some have steps left."""


def _ilog2(n):
    """floor(log2(n)) for n >= 1, 0 for n <= 0 (the kernels' 31 - clz)."""
    v, r = n.copy(), np.zeros_like(n)
    for s in (16, 8, 4, 2, 1):
        big = v >= (1 << s)
        v = np.where(big, v >> s, v)
        r = r + np.where(big, s, 0).astype(n.dtype)
    return r


def _half(a, b):
    s = a + b
    return np.where(s >= 0, s >> 1, -((-s) >> 1))


def _shfl(a):
    """__shfl_up_sync(..., 1) along the lane axis (lane 0 keeps its own)."""
    return np.concatenate([a[:1], a[:-1]])


class Ring:
    """A CTA's rings: per ring `ring` slots of words (value, sequence
    number) and the consumer's count."""

    def __init__(self, warps: int, ring: int, words: int, L: int, W: int):
        self.ring = ring
        self.val = np.zeros((warps, ring, words, L), I32)
        self.seq = np.full((warps, ring), -1, np.int64)
        # ring 0 is first read in the second round (band 0 has none above)
        self.con = [W if r == 0 else 0 for r in range(warps)]
        self.pub = [0] * warps  # the sequence numbers written, a count


def _schedule(programs, order: str, rng) -> None:
    """Run the warps' generators, which yield (band, wait) before each step,
    one step at a time: a random ready warp, or the ready warp of the
    highest band ("late": consumers first) or the lowest ("early":
    producers first).  Raises Deadlock when none is ready."""
    pending = {}
    for w, g in enumerate(programs):
        nxt = next(g, None)
        if nxt is not None:
            pending[w] = (g, nxt)
    while pending:
        ready = [w for w, (_, (band, wait)) in pending.items() if wait()]
        if not ready:
            raise Deadlock(f"warps {sorted(pending)} wait")
        if order == "random":
            w = ready[rng.integers(len(ready))]
        else:
            pick = max if order == "late" else min
            w = pick(ready, key=lambda v: pending[v][1][0])
        g = pending[w][0]
        nxt = next(g, None)
        if nxt is None:
            del pending[w]
        else:
            pending[w] = (g, nxt)


def _cta(height: int, threads: int, most: int) -> tuple[int, int]:
    """(warps, bands) of a plane: one lane a row, at most `most` threads."""
    T = min(-(-height // 32) * 32, threads, most)
    return T // 32, -(-height // 32)


def _warp_programs(res, codes, height, width, k, look, threads, most, ring, chunk, words,
                   step, state, early=0, slack=0):
    """The warps of one CTA: each walks its bands, `step(st, s, x, y, active,
    rv, code, above)` computing a step of 32 lanes and returning (values,
    what lane 31 hands down).  `early`: the consumer reads a slot once
    column q - early is written; `slack`: the producer runs that many
    slots past the ring."""
    L = res.shape[0]
    H, W = height, width
    warps, bands = _cta(H, threads, most)
    rings = Ring(warps, ring, words, L, W)
    out = np.zeros_like(res)

    def rows_chunk(a, band, s0):
        """(32, chunk, L) of a's rows at the chunk's columns, 0 outside."""
        y = band * 32 + LANE
        x = s0 + np.arange(chunk)[None, :] - k * LANE
        ok = (y < H) & (x >= 0) & (x < W)
        return np.where(ok[..., None], a[:, np.clip(y, 0, H - 1), np.clip(x, 0, W - 1)]
                        .transpose(1, 2, 0), 0).astype(I32)

    def program(w):
        for band in range(w, bands, warps):
            rc, rp = band % warps, (band + 1) % warps
            base_c, base_p = band // warps * W, (band + 1) // warps * W
            up, down = band > 0, band + 1 < bands
            rows = min(32, H - band * 32)
            y = band * 32 + LANE
            st = state(L)
            s_begin, s_end = -look, k * (rows - 1) + W - 1
            s0 = s_begin
            nxt = rows_chunk(res, band, s0), (None if codes is None
                                             else rows_chunk(codes, band, s0))
            while True:
                buf = nxt
                # the next chunk's reads, a chunk ahead
                nxt = rows_chunk(res, band, s0 + chunk), (None if codes is None
                                                        else rows_chunk(codes, band, s0 + chunk))
                ob = np.zeros((32, chunk, L), I32)
                # the producer's wait, once a chunk: for the last column its
                # last row writes in the chunk
                c_last = min(s0 + chunk - 1 - 31 * k, W - 1)
                wait_out = down and c_last >= 0
                for j in range(chunk):
                    s = s0 + j
                    cin, cout = s + look, s - 31 * k
                    need_in, need_out = up and 0 <= cin < W, down and 0 <= cout < W
                    q_in, q_out = base_c + cin, base_p + cout

                    def wait(need_in=need_in, q_in=q_in, first=j == 0):
                        ok_in = (not need_in or (rings.pub[rc] > q_in - early if early else
                                                 rings.seq[rc, q_in % ring] == q_in))
                        ok_out = (not (first and wait_out)
                                  or base_p + c_last < rings.con[rp] + ring + slack)
                        return ok_in and ok_out

                    yield band, wait
                    above = (rings.val[rc, q_in % ring] if need_in
                             else np.zeros((words, L), I32))
                    x = s - k * LANE
                    active = (y < H) & (x >= 0) & (x < W)
                    code = None if buf[1] is None else buf[1][:, j]
                    ob[:, j], down_words = step(st, s, x, y, active, buf[0][:, j], code, above)
                    if need_out:
                        rings.val[rp, q_out % ring] = down_words
                        rings.seq[rp, q_out % ring] = q_out
                        rings.pub[rp] = q_out + 1
                if up:
                    rings.con[rc] = base_c + min(s0 + chunk + look, W)
                xs = s0 + np.arange(chunk)[None, :] - k * LANE
                ok = (y < H) & (xs >= 0) & (xs < W)
                yy, jj = np.nonzero(ok)
                out[:, band * 32 + yy, xs[yy, jj]] = ob[yy, jj].T
                if s0 + chunk > s_end:
                    break
                s0 += chunk

    return [program(w) for w in range(warps)], out


class PlainState:
    def __init__(self, L):
        self.v1 = np.zeros((32, L), I32)     # this row at s - 1: W
        self.nprev = np.zeros((32, L), I32)  # the row above at s - 1: NW


def _plain_step(st, s, x, y, active, rv, code, above):
    """W1's step (plain_wavefront_kernel): lane 0's row above from the ring."""
    up = _shfl(st.v1)
    up[0] = above[0]
    has_w, has_n = x > 0, y > 0
    n1 = np.where(has_n, up, 0)
    w_ = np.where(has_w, st.v1, n1)
    n_ = np.where(has_n, n1, w_)
    nw = np.where(has_w & has_n, st.nprev, w_)
    grad = np.minimum(np.maximum(w_ + n_ - nw, np.minimum(w_, n_)), np.maximum(w_, n_))
    if code is None:
        pred = grad
    else:
        pred = np.where(code == 0, 0, np.where(code == 1, w_, np.where(code == 2, n_, grad)))
    st.nprev = up
    st.v1 = np.where(active, pred + rv, 0).astype(I32)
    return st.v1, st.v1[31][None]


def model_plain(res, codes, height: int, width: int, threads: int = 1024,
                ring: int = PLAIN_RING, chunk: int = PLAIN_CHUNK, order: str = "random",
                seed: int = 0, early: int = 0, slack: int = 0):
    """W1 (plain_wavefront_kernel): (L, H, W) int32 values."""
    most = THREADS["plain" if codes is None else "mixed"]
    progs, out = _warp_programs(res, codes, height, width, 1, 0, threads, most, ring, chunk, 1,
                                _plain_step, PlainState, early, slack)
    _schedule(progs, order, np.random.default_rng(seed))
    return out


def _branches(pw, pn, pnw, pne, pww, wppred):
    """(13, ...) predictions of codes 0-12."""
    sel = np.where(np.abs(pn - pnw) < np.abs(pw - pnw), pw, pn)
    grad = np.minimum(np.maximum(pw + pn - pnw, np.minimum(pw, pn)), np.maximum(pw, pn))
    return np.stack([np.zeros_like(pw), pw, pn, _half(pw, pn), sel, grad, wppred, pne, pnw,
                     pww, _half(pw, pnw), _half(pn, pnw), _half(pn, pne)])


def _select(br, code):
    """br[code] along the first axis, 0 outside 0-12."""
    got = np.take_along_axis(br, np.clip(code, 0, 12)[None].astype(np.int64), 0)[0]
    return np.where((code >= 0) & (code < 13), got, 0).astype(I32)


class WpState:
    """One warp's lanes on the 2y + x wavefront (csrc's WpLane)."""

    def __init__(self, L):
        z, z4 = np.zeros((32, L), I32), np.zeros((32, 4, L), I32)
        self.v1 = self.v2 = self.te1 = z          # this row: W, WW, true error at s-1
        self.ea1 = self.ea2 = z4                  # its sub-errors at s-1, s-2
        self.un = [z] * 4                         # the row above at s-1..s-4
        self.ute = [z] * 3                        # its true errors at s-1..s-3
        self.uea = [z4] * 3                       # its sub-errors at s-1..s-3
        self.nn = self.nn_next = z                # two rows up: NN now, next step


def _wp_step(params, width, tree, depth, cidx, sidx):
    """W2's step (wp_wavefront_kernel), WP alone, per-pixel codes or the
    packed tree walk (wavefront_kernels._tree_meta's (nodes, 4))."""
    wpar = np.asarray(params.w, I32)[:, None]
    p3 = params.p3

    def step(st, s, x, y, active, rv, code, above):
        # the row above's step s-1 (lane i-1's; lane 0's from the ring):
        # value, true error, its own N (NN a step later), 4 sub-errors
        u_v, u_te, u_nn, u_e = _shfl(st.v1), _shfl(st.te1), _shfl(st.un[1]), _shfl(st.ea1)
        u_v[0], u_te[0], u_nn[0], u_e[0] = above[0], above[1], above[2], above[3:7]
        st.un = [u_v] + st.un[:3]
        st.ute = [u_te] + st.ute[:2]
        st.uea = [u_e] + st.uea[:2]
        st.nn, st.nn_next = st.nn_next, u_nn

        has_w, has_n, has_nn, x_gt1 = x > 0, y > 0, y > 1, x > 1
        has_ne, has_wn = has_n & (x + 1 < width), has_w & has_n
        un1, un2, un3, un4 = st.un
        n_val = np.where(has_n, un2, 0)
        pw = np.where(has_w, st.v1, n_val)
        pn = np.where(has_n, n_val, pw)
        pnw = np.where(has_wn, un3, pw)
        pne = np.where(has_ne, un1, pn)
        pnn = np.where(has_nn, st.nn, pn)
        pww = np.where(x_gt1, st.v2, pw)
        pnww = np.where(x_gt1 & has_n, un4, pww)
        tew = np.where(has_w, st.te1, 0)
        ten = np.where(has_n, st.ute[1], 0)
        tenw = np.where(has_wn, st.ute[2], ten)
        tene = np.where(has_ne, st.ute[0], ten)
        m = lambda c: c[:, None]  # noqa: E731  a lane mask over the 4 sub-errors
        ew = np.where(m(has_w), st.ea1, 0)
        en = np.where(m(has_n), st.uea[1], 0)
        enw = np.where(m(has_wn), st.uea[2], en)
        ene = np.where(m(has_ne), st.uea[0], en)
        eww = np.where(m(x_gt1), st.ea2, 0)
        ew2 = np.where(m(x + 1 < width), 0, ew)

        pr = np.stack([
            (pw + pne - pn) * 8,
            pn * 8 - (((tew + ten + tene) * params.p1) >> 5),
            pw * 8 - (((tew + ten + tenw) * params.p2) >> 5),
            pn * 8 - ((tenw * p3[0] + ten * p3[1] + tene * p3[2]
                       + (pnn - pn) * 8 * p3[3] + (pnw - pw) * 8 * p3[4]) >> 5)], 1)
        es = en + ew + enw + eww + ene + ew2
        shift = np.maximum(_ilog2(es + 1) - 5, 0)
        wk = 4 + ((wpar * DIV[np.clip(es >> shift, 0, 63)]) >> shift)
        wk = wk >> (_ilog2(wk.sum(1, dtype=I32)) - 4)[:, None]
        wsum = wk.sum(1, dtype=I32)
        sm = (pr * wk).sum(1, dtype=I32)
        pred4 = ((sm + (wsum >> 1) - 1).astype(np.int64)
                 * DIV[np.clip(wsum - 1, 0, 63)] >> 24).astype(I32)
        lo = np.minimum(np.minimum(pw, pn), pne) * 8
        hi = np.maximum(np.maximum(pw, pn), pne) * 8
        agree = ((ten ^ tew) | (ten ^ tenw)) <= 0
        pred4 = np.where(agree, np.minimum(np.maximum(pred4, lo), hi), pred4)
        wppred = (pred4 + 3) >> 3
        if tree is not None:
            br = _branches(pw, pn, pnw, pne, pww, wppred)
            v15 = tew
            for cand in (ten, tenw, tene):
                v15 = np.where(np.abs(v15) < np.abs(cand), cand, v15)
            L = rv.shape[1]
            props = np.stack(np.broadcast_arrays(
                np.full((32, L), cidx, I32), np.broadcast_to(sidx, (32, L)), y, x,
                np.abs(pn), np.abs(pw), pn, pw,
                np.where(has_w, pw - (pww + pnw - pnww), pw),
                pw + pn - pnw, pw - pnw, pnw - pn, pn - pne, pn - pnn, pw - pww, v15))
            node = np.zeros((32, L), np.int64)
            for _ in range(depth):
                nd = tree[node]
                pv = np.take_along_axis(props, np.clip(nd[..., 0], 0, 15)[None], 0)[0]
                node = np.where(nd[..., 0] < 0, node,
                                np.where(pv > nd[..., 1], nd[..., 2], nd[..., 3]))
            leaf = tree[node].astype(np.int64)
            v = (rv.astype(np.int64) * leaf[..., 3] + leaf[..., 2]
                 + _select(br, leaf[..., 1])).astype(I32)
        elif code is not None:
            v = rv + _select(_branches(pw, pn, pnw, pne, pww, wppred), code)
        else:
            v = rv + wppred
        v8 = v * 8
        e = (np.abs(pr - v8[:, None]) + 3) >> 3
        t = pred4 - v8
        v, t = np.where(active, v, 0).astype(I32), np.where(active, t, 0).astype(I32)
        e = np.where(m(active), e, 0).astype(I32)
        st.risky |= (active & ((np.abs(e) >= 1 << 24).any(1) | (np.abs(t) >= 1 << 24))).any(0)
        st.v2, st.v1, st.te1, st.ea2, st.ea1 = st.v1, v, t, st.ea1, e
        # lane 31 hands down: value, true error, its N, 4 sub-errors
        return v, np.concatenate([v[31][None], t[31][None], st.un[1][31][None], e[31]])

    return step


def model_wp(res, height: int, width: int, params, codes=None, tree=None, cidx=0,
             sidx=None, threads: int = 512, ring: int = WP_RING,
             chunk: int = WP_CHUNK, order: str = "random", seed: int = 0,
             early: int = 0, slack: int = 0):
    """W2 (wp_wavefront_kernel): WP alone, per-pixel codes, or the MA-tree
    walk of `tree` ((prop, value, left, right, pred, offset, mult) rows,
    packed as the wrapper packs them).  Returns (values (L, H, W), overflow
    flag (L,))."""
    L = res.shape[0]
    key = None if tree is None else tuple(map(tuple, tree))
    packed, depth = (None, 0) if key is None else (WK._tree_pack(key), WK._tree_meta(key)[1])
    sidx = np.zeros(L, I32) if sidx is None else np.asarray(sidx, I32)
    step = _wp_step(params, width, None if packed is None else packed.astype(np.int64), depth,
                    cidx, sidx[None, :])
    risky = np.zeros(L, bool)

    def state(L):
        st = WpState(L)
        st.risky = risky
        return st

    progs, out = _warp_programs(res, codes, height, width, 2, 1, threads, THREADS["wp"],
                                ring, chunk, 7, step, state, early, slack)
    _schedule(progs, order, np.random.default_rng(seed))
    return out, risky


def _res(seed, shape, lo=-30, hi=31):
    return np.random.default_rng(seed).integers(lo, hi, size=shape).astype(I32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# (L, H, W, threads): H != W, one row, one column, two columns, a plane of
# three bands on one warp (each walked after the other), and a plane of
# three bands on two warps with W past the ring (the second round)
SHAPES = [(3, 13, 17, 1024), (2, 1, 9, 1024), (2, 7, 1, 1024), (2, 9, 2, 1024),
          (2, 70, 6, 32), (2, 90, 40, 64)]
PARAMS = {
    "default": WPParams(),
    "custom": WPParams(p1=9, p2=14, p3=(2, 11, 5, 1, 3), w=(11, 13, 14, 12)),
}


def _jax(params):
    """j40_tpu's device_entropy and its WPParams of the same fields."""
    from j40_tpu.modular.wp import WPParams as JWPParams
    from j40_tpu.ops import device_entropy as JDE

    return JDE, JWPParams(p1=params.p1, p2=params.p2, p3=params.p3, w=params.w)


def _same_wp(model, plain, jax_out):
    """model == plain on planes and flags; == JAX on flags and kept lanes."""
    (mv, mf), (pv, pf) = model, plain
    np.testing.assert_array_equal(mv, pv.numpy())
    np.testing.assert_array_equal(mf, pf.numpy())
    jv, jf = (np.asarray(a) for a in jax_out)
    np.testing.assert_array_equal(mf, jf)
    np.testing.assert_array_equal(mv[~mf], jv[~jf])
    return mf


@pytest.mark.parametrize("mode", ["gradient", "mixed"])
@pytest.mark.parametrize("L,H,W,threads", SHAPES)
def test_plain_schedule(mode, L, H, W, threads):
    """W1's schedule: gradient, and per-pixel codes 0/1/2/5 with codes
    outside 0-2 (the gradient) mixed in."""
    res = _res(H * 31 + W, (L, H, W))
    codes = None
    if mode == "mixed":
        codes = np.random.default_rng(W).choice([0, 1, 2, 5, 7, -1], size=res.shape)
        codes = codes.astype(I32)
    got = model_plain(res, codes, H, W, threads=threads, seed=H)
    plain = DE._plain_wavefront(_t(res), None if codes is None else _t(codes), H, W)
    np.testing.assert_array_equal(got, plain.numpy())
    JDE, _ = _jax(PARAMS["default"])
    jax_out = (JDE.gradient_reconstruct(res, H, W) if codes is None
               else JDE.mixed_reconstruct(res, codes, H, W))
    np.testing.assert_array_equal(got, np.asarray(jax_out))


@pytest.mark.parametrize("params", list(PARAMS))
@pytest.mark.parametrize("codes", [False, True])
@pytest.mark.parametrize("L,H,W,threads", SHAPES)
def test_wp_schedule(params, codes, L, H, W, threads):
    """W2's schedule: WP alone, and per-pixel codes -2..14 (outside 0-12
    predicts 0)."""
    p = PARAMS[params]
    JDE, jp = _jax(p)
    res = _res(H * 17 + W, (L, H, W))
    pc = (np.random.default_rng(H + W).integers(-2, 15, size=res.shape).astype(I32)
          if codes else None)
    got = model_wp(res, H, W, p, codes=pc, threads=threads, seed=W)
    plain = DE._wp_reconstruct(_t(res), None if pc is None else _t(pc), H, W, p, codes)
    assert not _same_wp(got, plain, JDE.wp_reconstruct_ovf(res, pc, H, W, jp)).any()


def _leaf(pred, off=0, mult=1):
    return (-1, 0, 0, 0, pred, off, mult)


TREES = {
    # bench.py's e3 tree: WP's max-error property gates WP against gradient
    "e3": ((15, 0, 1, 2, 0, 0, 0), _leaf(6), _leaf(5)),
    # stream index and NE-difference splits, leaves with multipliers and
    # offsets, a leaf code outside 0-12
    "offsets": ((1, 40, 1, 2, 0, 0, 0), _leaf(6, 3, 2), (12, -2, 3, 4, 0, 0, 0),
                _leaf(14, -1, 1), _leaf(4, 0, 3)),
    # four levels over properties 0, 2-5, 8, 10, 11, 13-15; negative and
    # large multipliers
    "deep": ((8, 0, 1, 2, 0, 0, 0), (4, 5, 3, 4, 0, 0, 0), (14, -3, 5, 6, 0, 0, 0),
             _leaf(7, 1, 5), (13, 1, 9, 10, 0, 0, 0), (15, 2, 7, 8, 0, 0, 0),
             (0, 0, 11, 12, 0, 0, 0), _leaf(9, -7, 1), _leaf(11, 0, -3),
             (3, 4, 13, 14, 0, 0, 0), (2, 2, 15, 16, 0, 0, 0), _leaf(6, 5, 70000),
             (10, -1, 17, 18, 0, 0, 0), _leaf(10), _leaf(3, -2, 1), _leaf(8, 2, 2),
             (5, 3, 19, 20, 0, 0, 0), (11, 0, 21, 22, 0, 0, 0), _leaf(12, 0, 4),
             _leaf(1), _leaf(2, 9, 1), _leaf(0, -4, 1), _leaf(5, 0, -1)),
}


@pytest.mark.parametrize("tree", list(TREES))
@pytest.mark.parametrize("L,H,W,threads", [SHAPES[0], SHAPES[1], SHAPES[3], SHAPES[4]])
def test_tree_schedule(tree, L, H, W, threads):
    """W3's schedule: the MA-tree walk in the step, on raw residuals."""
    key = TREES[tree]
    p = PARAMS["custom" if tree == "offsets" else "default"]
    JDE, jp = _jax(p)
    res = _res(H + 5 * W, (L, H, W), -12, 13)
    sidx = np.arange(30, 30 + 11 * L, 11, dtype=I32)
    cidx = W % 3
    got = model_wp(res, H, W, p, tree=key, cidx=cidx, sidx=sidx, threads=threads, seed=H)
    plain = DE._tree_wp_reconstruct(_t(res), H, W, p, key, cidx, _t(sidx))
    jax_out = JDE.tree_wp_reconstruct(res, key, cidx, sidx, H, W, jp)
    assert not _same_wp(got, plain, jax_out).any()


@pytest.mark.parametrize("kernel", ["gradient", "mixed", "wp", "tree"])
def test_group_of_1024_rows(kernel):
    """A plane as tall as a Modular group can be (1024 rows): one round of
    32 warps in W1, two rounds of 16 warps (2 bands a warp) with codes and
    in W2, the consumers run first (`late`)."""
    H, W = 1024, 3
    res = _res(7, (1, H, W), -12, 13)
    p = PARAMS["custom"]
    JDE, jp = _jax(p)
    if kernel in ("gradient", "mixed"):
        codes = (None if kernel == "gradient" else
                 np.random.default_rng(1).choice([0, 1, 2, 5], size=res.shape).astype(I32))
        got = model_plain(res, codes, H, W, order="late")
        plain = DE._plain_wavefront(_t(res), None if codes is None else _t(codes), H, W)
        np.testing.assert_array_equal(got, plain.numpy())
        jax_out = (JDE.gradient_reconstruct(res, H, W) if codes is None
                   else JDE.mixed_reconstruct(res, codes, H, W))
        np.testing.assert_array_equal(got, np.asarray(jax_out))
        return
    if kernel == "wp":
        got = model_wp(res, H, W, p, order="late")
        plain = DE._wp_reconstruct(_t(res), None, H, W, p, False)
        jax_out = JDE.wp_reconstruct_ovf(res, None, H, W, jp)
    else:
        sidx = np.asarray([4], I32)
        got = model_wp(res, H, W, p, tree=TREES["e3"], cidx=2, sidx=sidx, order="late")
        plain = DE._tree_wp_reconstruct(_t(res), H, W, p, TREES["e3"], 2, _t(sidx))
        jax_out = JDE.tree_wp_reconstruct(res, TREES["e3"], 2, sidx, H, W, jp)
    assert not _same_wp(got, plain, jax_out).any()


@pytest.mark.parametrize("order", ["late", "early"])
@pytest.mark.parametrize("kernel", ["plain", "wp"])
def test_schedule_order_does_not_matter(kernel, order):
    """The consumers first or the producers first give the plain version's
    plane: a warp waits only on the hand-off's two counts."""
    L, H, W = 2, 100, 37
    res = _res(3, (L, H, W))
    if kernel == "plain":
        want = DE._plain_wavefront(_t(res), None, H, W).numpy()
        np.testing.assert_array_equal(model_plain(res, None, H, W, threads=64, ring=16,
                                                  order=order), want)
    else:
        p = PARAMS["custom"]
        want = DE._wp_reconstruct(_t(res), None, H, W, p, False)[0].numpy()
        np.testing.assert_array_equal(model_wp(res, H, W, p, threads=64, ring=8,
                                               order=order)[0], want)


@pytest.mark.parametrize("tree", [None, "deep"])
def test_overflow_flag_schedule(tree):
    """A lane that drives the error state past 2^24 is flagged on the
    model, the plain version and JAX; the other lane stays exact."""
    res = np.zeros((2, 8, 40), I32)
    res[0, :, ::2] = 2 ** 28
    res[0, :, 1::2] = -2 ** 28
    p = PARAMS["default"]
    JDE, jp = _jax(p)
    sidx = np.asarray([3, 4], I32)
    if tree is None:
        got = model_wp(res, 8, 40, p)
        plain = DE._wp_reconstruct(_t(res), None, 8, 40, p, False)
        jax_out = JDE.wp_reconstruct_ovf(res, None, 8, 40, jp)
    else:
        key = TREES[tree]
        got = model_wp(res, 8, 40, p, tree=key, cidx=1, sidx=sidx)
        plain = DE._tree_wp_reconstruct(_t(res), 8, 40, p, key, 1, _t(sidx))
        jax_out = JDE.tree_wp_reconstruct(res, key, 1, sidx, 8, 40, jp)
    assert _same_wp(got, plain, jax_out).tolist() == [True, False]


@pytest.mark.parametrize("kernel", ["plain", "wp"])
def test_ring_one_slot_short_fails(kernel):
    """The producer waits until the consumer is past a slot's previous use:
    one slot further (the ring one slot short) and the band above, run
    first (`early`), overwrites a value the band below has not read, whose
    wait for it then never ends."""
    L, H, W = 2, 64, 19
    res = _res(5, (L, H, W))
    kw = dict(threads=64, ring=16 if kernel == "plain" else 8, order="early")
    if kernel == "plain":
        want = DE._plain_wavefront(_t(res), None, H, W).numpy()
        np.testing.assert_array_equal(model_plain(res, None, H, W, **kw), want)
        with pytest.raises(Deadlock):
            model_plain(res, None, H, W, slack=1, **kw)
    else:
        p = PARAMS["custom"]
        want = DE._wp_reconstruct(_t(res), None, H, W, p, False)[0].numpy()
        np.testing.assert_array_equal(model_wp(res, H, W, p, **kw)[0], want)
        with pytest.raises(Deadlock):
            model_wp(res, H, W, p, slack=1, **kw)


@pytest.mark.parametrize("kernel", ["plain", "wp"])
def test_handoff_one_column_early_fails(kernel):
    """The consumer reads a slot once it carries the column it wants: a
    warp that reads as soon as the column before is written, run first
    (`late`), takes the slot's previous value and gives a wrong plane."""
    L, H, W = 2, 64, 19
    res = _res(6, (L, H, W))
    kw = dict(threads=64, order="late")
    if kernel == "plain":
        want = DE._plain_wavefront(_t(res), None, H, W).numpy()
        np.testing.assert_array_equal(model_plain(res, None, H, W, **kw), want)
        assert not np.array_equal(model_plain(res, None, H, W, early=1, **kw), want)
    else:
        p = PARAMS["custom"]  # p3[3] != 0: NN enters the prediction
        want = DE._wp_reconstruct(_t(res), None, H, W, p, False)[0].numpy()
        np.testing.assert_array_equal(model_wp(res, H, W, p, **kw)[0], want)
        assert not np.array_equal(model_wp(res, H, W, p, early=1, **kw)[0], want)


@pytest.mark.parametrize("kernel", ["plain", "wp"])
def test_tall_width_limit(kernel):
    """A plane of more bands than warps hands off deadlock-free up to
    tall_width_limit(...) columns, and deadlocks one column wider (any
    order: the last band of a round cannot consume until its warp has
    walked its band before); the kernels' limits are the same function
    (csrc/wavefront.cu), above a Modular group's 1024 columns."""
    threads, ring, chunk = 64, 8, 4
    k, look = (1, 0) if kernel == "plain" else (2, 1)
    limit = tall_width_limit(k, look, threads // 32, ring, chunk)
    H = 3 * 32  # three bands on two warps
    for W, ok in ((limit, True), (limit + 1, False)):
        res = _res(W, (1, H, W))
        run = ((lambda: model_plain(res, None, H, W, threads=threads, ring=ring, chunk=chunk))
               if kernel == "plain" else
               (lambda: model_wp(res, H, W, PARAMS["default"], threads=threads, ring=ring,
                                 chunk=chunk)[0]))
        if ok:
            want = (DE._plain_wavefront(_t(res), None, H, W) if kernel == "plain"
                    else DE._wp_reconstruct(_t(res), None, H, W, PARAMS["default"], False)[0])
            np.testing.assert_array_equal(run(), want.numpy())
        else:
            with pytest.raises(Deadlock):
                run()
    assert min(tall_width_limit(1, 0, THREADS[t] // 32, PLAIN_RING, PLAIN_CHUNK)
               for t in ("plain", "mixed")) > 1024
    assert tall_width_limit(2, 1, THREADS["wp"] // 32, WP_RING, WP_CHUNK) > 1024


def test_tree_depth_is_the_plain_versions():
    """W3 walks as many levels as the plain version does: the wrapper's
    depth is device_entropy._tree_depth, on every tree here; its nodes are
    packed one int4 each (a branch: property, value, left, right; a leaf:
    -1, predictor, offset, multiplier)."""
    for key in TREES.values():
        depth = WK._tree_meta(key)[1]
        arr = WK._tree_pack(key)
        assert arr.shape == (len(key), 4) and arr.dtype == I32
        assert depth == DE._tree_depth(key)
        for node, row in zip(key, arr):
            want = node[:4] if node[0] >= 0 else (-1, *node[4:])
            assert tuple(row) == want


@pytest.mark.parametrize("bad", ["property", "child", "root", "shared", "int32", "nodes"])
def test_tree_the_kernel_cannot_walk_is_refused(bad):
    """A tree with a property outside 0-15, a child out of range, a branch
    back to the root (a cycle) or a child shared by two branches raises
    ValueError before any walk, on the CPU as on the card.  A field outside
    int32 is refused by the packing the card's shared memory holds, and a
    tree larger than that memory on the card alone (test_torch_cuda.py):
    the plain version on the CPU takes any size."""
    branch = {"property": (16, 0, 1, 2, 0, 0, 0), "child": (3, 0, 1, 3, 0, 0, 0),
              "root": (3, 0, 1, 0, 0, 0, 0), "shared": (3, 0, 1, 1, 0, 0, 0),
              "int32": (3, 1 << 31, 1, 2, 0, 0, 0), "nodes": (3, 0, 1, 2, 0, 0, 0)}[bad]
    key = (branch, _leaf(5), _leaf(1))
    res = torch.from_numpy(_res(1, (2, 5, 7)))
    if bad == "int32":
        with pytest.raises(ValueError, match="int32"):
            WK._tree_pack(key)
    elif bad == "nodes":
        key += (_leaf(0),) * 20_000  # more than any card's shared memory holds
        out, ovf = WK.tree_wavefront(res, key, 0, [0, 1], 5, 7, PARAMS["default"])
        want = WK.tree_wavefront(res, key[:3], 0, [0, 1], 5, 7, PARAMS["default"])
        assert torch.equal(out, want[0]) and torch.equal(ovf, want[1])
    else:
        with pytest.raises(ValueError, match="tree"):
            WK.tree_wavefront(res, key, 0, [0, 1], 5, 7, PARAMS["default"])
