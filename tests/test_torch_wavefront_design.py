"""A CPU model of the wavefront kernels' schedule (csrc/wavefront.cu: W1,
and W2 with its tree mode W3), held bit for bit against their plain
versions (j40_tpu_torch/ops/device_entropy.py) and j40_tpu's lax.scan
programs, as tests/test_torch_dct8_design.py models B1/B2.

The model runs the kernels' schedule: a CTA of `threads` threads, thread t
owning rows t, t + threads, ...; one step per diagonal d = k*y + x (k = 1
for W1, 2 for W2), in which each row reads what rows published on earlier
diagonals from a ring of `depth` slots (slot d mod depth) and at once
publishes its own value (W2: and its 4 sub-errors and true error) to slot
d.  Within a step the threads run in a random order, as a CTA's threads do
between two barriers, each walking its rows in turn.  A ring one slot too
shallow then reads a value of the same step, which the model shows.

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

I32 = np.int32
DIV = np.asarray(DIV24, I32)


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


def _schedule(height: int, threads: int, rng):
    """The rows of one step in the order a CTA may run them."""
    T = min(-(-height // 32) * 32, threads)
    return [y for t in rng.permutation(T) for y in range(t, height, T)]


def model_plain(res, codes, height: int, width: int, depth: int = 3,
                threads: int = 1024, seed: int = 0):
    """W1 (plain_wavefront_kernel): (L, H, W) int32 values."""
    rng = np.random.default_rng(seed)
    L = res.shape[0]
    ring = np.zeros((depth, height, L), I32)
    out = np.zeros_like(res)
    zero = np.zeros(L, I32)
    for d in range(height + width - 1):
        d1, d2 = ring[(d - 1) % depth], ring[(d - 2) % depth]
        for y in _schedule(height, threads, rng):
            x = d - y
            v = zero
            if 0 <= x < width:
                has_w, has_n = x > 0, y > 0
                n1 = d1[y - 1] if has_n else zero
                w_ = d1[y] if has_w else n1
                n_ = n1 if has_n else w_
                nw = d2[y - 1] if has_w and has_n else w_
                grad = np.minimum(np.maximum(w_ + n_ - nw, np.minimum(w_, n_)),
                                  np.maximum(w_, n_))
                c = codes[:, y, x] if codes is not None else np.full(L, 5, I32)
                pred = np.where(c == 0, 0, np.where(c == 1, w_, np.where(c == 2, n_, grad)))
                v = (pred + res[:, y, x]).astype(I32)
                out[:, y, x] = v
            ring[d % depth, y] = v
    return out


def _branches(pw, pn, pnw, pne, pww, wppred):
    """(13, L) predictions of codes 0-12."""
    sel = np.where(np.abs(pn - pnw) < np.abs(pw - pnw), pw, pn)
    grad = np.minimum(np.maximum(pw + pn - pnw, np.minimum(pw, pn)), np.maximum(pw, pn))
    return np.stack([np.zeros_like(pw), pw, pn, _half(pw, pn), sel, grad, wppred, pne, pnw,
                     pww, _half(pw, pnw), _half(pn, pnw), _half(pn, pne)])


def _select(br, code):
    """br[code] per lane, 0 outside 0-12."""
    got = br[np.clip(code, 0, 12), np.arange(br.shape[1])]
    return np.where((code >= 0) & (code < 13), got, 0).astype(I32)


def model_wp(res, height: int, width: int, params, codes=None, tree=None, cidx=0,
             sidx=None, depth: int = 5, threads: int = 512, seed: int = 0):
    """W2 (wp_wavefront_kernel): WP alone, per-pixel codes, or the MA-tree
    walk of `tree` ((prop, value, left, right, pred, offset, mult) rows).
    Returns (values (L, H, W), overflow flag (L,))."""
    rng = np.random.default_rng(seed)
    L = res.shape[0]
    H, W = height, width
    val = np.zeros((depth, H, L), I32)
    te = np.zeros((depth, H, L), I32)
    ea = np.zeros((depth, H, 4, L), I32)
    out = np.zeros_like(res)
    ovf = np.zeros(L, bool)
    zero, z4 = np.zeros(L, I32), np.zeros((4, L), I32)
    wpar = np.asarray(params.w, I32)[:, None]
    p3 = params.p3
    lanes = np.arange(L)
    if tree is not None:
        tr = np.asarray(tree, np.int64)
        tdepth = DE._tree_depth(tree)
        sidx = np.asarray(sidx, I32)
    for d in range(2 * H + W - 2):
        s = [(d - k) % depth for k in range(5)]
        for y in _schedule(H, threads, rng):
            x = d - 2 * y
            if not 0 <= x < W:
                val[s[0], y] = te[s[0], y] = 0
                ea[s[0], y] = 0
                continue
            has_w, has_n, has_nn, x_gt1 = x > 0, y > 0, y > 1, x > 1
            has_ne, has_wn = has_n and x + 1 < W, has_w and has_n
            n_val = val[s[2], y - 1] if has_n else zero
            pw = val[s[1], y] if has_w else n_val
            pn = n_val if has_n else pw
            pnw = val[s[3], y - 1] if has_wn else pw
            pne = val[s[1], y - 1] if has_ne else pn
            pnn = val[s[4], y - 2] if has_nn else pn
            pww = val[s[2], y] if x_gt1 else pw
            pnww = val[s[4], y - 1] if x_gt1 and has_n else pww
            tew = te[s[1], y] if has_w else zero
            ten = te[s[2], y - 1] if has_n else zero
            tenw = te[s[3], y - 1] if has_wn else ten
            tene = te[s[1], y - 1] if has_ne else ten
            ew = ea[s[1], y] if has_w else z4
            en = ea[s[2], y - 1] if has_n else z4
            enw = ea[s[3], y - 1] if has_wn else en
            ene = ea[s[1], y - 1] if has_ne else en
            eww = ea[s[2], y] if x_gt1 else z4
            ew2 = z4 if x + 1 < W else ew

            pr = np.stack([
                (pw + pne - pn) * 8,
                pn * 8 - (((tew + ten + tene) * params.p1) >> 5),
                pw * 8 - (((tew + ten + tenw) * params.p2) >> 5),
                pn * 8 - ((tenw * p3[0] + ten * p3[1] + tene * p3[2]
                           + (pnn - pn) * 8 * p3[3] + (pnw - pw) * 8 * p3[4]) >> 5)])
            es = en + ew + enw + eww + ene + ew2
            shift = np.maximum(_ilog2(es + 1) - 5, 0)
            wk = 4 + ((wpar * DIV[np.clip(es >> shift, 0, 63)]) >> shift)
            wk = wk >> (_ilog2(wk.sum(0, dtype=I32)) - 4)
            wsum = wk.sum(0, dtype=I32)
            sm = (pr * wk).sum(0, dtype=I32)
            pred4 = ((sm + (wsum >> 1) - 1).astype(np.int64)
                     * DIV[np.clip(wsum - 1, 0, 63)] >> 24).astype(I32)
            lo = np.minimum(np.minimum(pw, pn), pne) * 8
            hi = np.maximum(np.maximum(pw, pn), pne) * 8
            agree = ((ten ^ tew) | (ten ^ tenw)) <= 0
            pred4 = np.where(agree, np.minimum(np.maximum(pred4, lo), hi), pred4)
            wppred = (pred4 + 3) >> 3
            br = _branches(pw, pn, pnw, pne, pww, wppred)
            rv = res[:, y, x]
            if tree is not None:
                v15 = tew
                for cand in (ten, tenw, tene):
                    v15 = np.where(np.abs(v15) < np.abs(cand), cand, v15)
                props = np.stack([
                    np.full(L, cidx, I32), sidx, np.full(L, y, I32), np.full(L, x, I32),
                    np.abs(pn), np.abs(pw), pn, pw,
                    pw - (pww + pnw - pnww) if has_w else pw,
                    pw + pn - pnw, pw - pnw, pnw - pn, pn - pne, pn - pnn, pw - pww, v15])
                node = np.zeros(L, np.int64)
                for _ in range(tdepth):
                    p = tr[node, 0]
                    v = props[np.clip(p, 0, 15), lanes].astype(np.int64)
                    nxt = np.where(v > tr[node, 1], tr[node, 2], tr[node, 3])
                    node = np.where(p < 0, node, nxt)
                v = (rv.astype(np.int64) * tr[node, 6] + tr[node, 5]
                     + _select(br, tr[node, 4])).astype(I32)
            elif codes is not None:
                v = rv + _select(br, codes[:, y, x])
            else:
                v = rv + wppred
            v8 = v * 8
            e = (np.abs(pr - v8) + 3) >> 3
            t = pred4 - v8
            ovf |= (np.abs(e) >= 1 << 24).any(0) | (np.abs(t) >= 1 << 24)
            val[s[0], y], te[s[0], y], ea[s[0], y] = v, t, e
            out[:, y, x] = v
    return out, ovf


def _res(seed, shape, lo=-30, hi=31):
    return np.random.default_rng(seed).integers(lo, hi, size=shape).astype(I32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# (L, H, W, threads): H != W, one row, one column, two columns, and rows
# above the CTA's threads (each thread walks several rows)
SHAPES = [(3, 13, 17, 1024), (2, 1, 9, 1024), (2, 7, 1, 1024), (2, 9, 2, 1024),
          (2, 70, 6, 32)]
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
    """The ring depths are the least that work: W1 with 2 slots (NW is read
    from d-2 while the row above writes d) and W2 with 4 (NN from d-4) read
    values of the same step and differ from the plain versions."""
    L, H, W = 2, 24, 19
    res = _res(5, (L, H, W))
    if kernel == "plain":
        want = DE._plain_wavefront(_t(res), None, H, W).numpy()
        np.testing.assert_array_equal(model_plain(res, None, H, W, depth=3), want)
        assert not np.array_equal(model_plain(res, None, H, W, depth=2), want)
    else:
        p = PARAMS["custom"]  # p3[3] != 0: NN enters the prediction
        want = DE._wp_reconstruct(_t(res), None, H, W, p, False)[0].numpy()
        np.testing.assert_array_equal(model_wp(res, H, W, p, depth=5)[0], want)
        assert not np.array_equal(model_wp(res, H, W, p, depth=4)[0], want)


def test_tree_depth_is_the_plain_versions():
    """W3 walks as many levels as the plain version does: the wrapper's
    depth is device_entropy._tree_depth, on every tree here."""
    from j40_tpu_torch.ops import wavefront_kernels as WK

    for key in TREES.values():
        arr, depth = WK._tree_meta(key)
        assert arr.shape == (len(key), 7) and depth == DE._tree_depth(key)


@pytest.mark.parametrize("bad", ["property", "child", "root", "shared"])
def test_tree_the_kernel_cannot_walk_is_refused(bad):
    """A tree with a property outside 0-15, a child out of range, a branch
    back to the root (a cycle) or a child shared by two branches raises
    ValueError before any walk, on the CPU as on the card."""
    from j40_tpu_torch.ops import wavefront_kernels as WK

    branch = {"property": (16, 0, 1, 2, 0, 0, 0), "child": (3, 0, 1, 3, 0, 0, 0),
              "root": (3, 0, 1, 0, 0, 0, 0), "shared": (3, 0, 1, 1, 0, 0, 0)}[bad]
    key = (branch, _leaf(5), _leaf(1))
    res = torch.from_numpy(_res(1, (2, 5, 7)))
    with pytest.raises(ValueError, match="tree"):
        WK.tree_wavefront(res, key, 0, [0, 1], 5, 7, PARAMS["default"])
