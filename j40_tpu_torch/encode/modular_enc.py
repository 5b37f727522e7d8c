"""Advanced modular encoding: MA trees with properties, WP, forward
transforms (RCT, Squeeze).

These exist both as user-facing encoder features and to exercise every decoder
path differentially against dj40 (trees/WP/RCT) or by self-roundtrip
(Squeeze, which dj40 rejects).
"""

from __future__ import annotations

import numpy as np

from ..mathutil import pack_signed
from ..modular.decode import _gradient, _predict, ModularImage
from ..modular.tree import TreeNode
from ..modular.wp import WPParams, WPState
from .bitwriter import BitWriter
from .entropy import EntropyEncoder


def branch(prop: int, value: int, left: int, right: int) -> TreeNode:
    return TreeNode(prop=prop, value=value, left=left, right=right)


def leaf(predictor: int, offset: int = 0, multiplier: int = 1) -> TreeNode:
    n = TreeNode(prop=-1, predictor=predictor, offset=offset, multiplier=multiplier)
    return n


def assign_leaf_contexts(nodes: list[TreeNode]) -> int:
    """Number leaves in wire order; returns the context count."""
    ctx = 0
    for n in nodes:
        if n.is_leaf:
            n.ctx = ctx
            ctx += 1
    return ctx


def write_tree(w: BitWriter, nodes: list[TreeNode], use_prefix: bool = True) -> None:
    """Emit a tree in wire (BFS) order; caller must order `nodes` so that a
    breadth-first reader reconstructs the same left/right indices."""
    enc = EntropyEncoder(6, use_prefix=use_prefix)
    for n in nodes:
        if n.is_leaf:
            enc.add(1, 0)
            enc.add(2, n.predictor)
            enc.add(3, pack_signed(n.offset))
            # multiplier = (val+1) << shift; we emit shift=0
            assert n.multiplier >= 1
            enc.add(4, 0)
            enc.add(5, n.multiplier - 1)
        else:
            enc.add(1, n.prop + 1)
            enc.add(0, pack_signed(n.value))
    enc.write(w)


def encode_channel_tokens(
    m: ModularImage,
    cidx: int,
    tree: list[TreeNode],
    wp_params: WPParams,
    sidx: int = 0,
) -> list[tuple[int, int]]:
    """(ctx, token) pairs for one channel — the exact mirror of
    modular.decode.decode_channel's per-pixel walk."""
    c = m.channels[cidx]
    data = c.data
    width, height = c.width, c.height
    use_wp = any(
        (n.is_leaf and n.predictor == 6) or (not n.is_leaf and n.prop == 15)
        for n in tree
    )
    wp = WPState(wp_params, width) if use_wp else None
    refcmap = [
        i
        for i in range(cidx - 1, -1, -1)
        if (m.channels[i].width, m.channels[i].height,
            m.channels[i].hshift, m.channels[i].vshift)
        == (width, height, c.hshift, c.vshift)
    ]
    out: list[tuple[int, int]] = []
    for y in range(height):
        row = data[y]
        prow = data[y - 1] if y > 0 else None
        for x in range(width):
            w_ = int(row[x - 1]) if x > 0 else (int(prow[x]) if y > 0 else 0)
            n_ = int(prow[x]) if y > 0 else w_
            nw = int(prow[x - 1]) if (x > 0 and y > 0) else w_
            ne = int(prow[x + 1]) if (x + 1 < width and y > 0) else n_
            nn = int(data[y - 2][x]) if y > 1 else n_
            nee = int(prow[x + 2]) if (x + 2 < width and y > 0) else ne
            ww = int(row[x - 2]) if x > 1 else w_
            nww = int(prow[x - 2]) if (x > 1 and y > 0) else ww
            if wp is not None:
                wp.before_predict(x, y, w_, n_, nw, ne, nn)
            node = tree[0]
            while not node.is_leaf:
                p = node.prop
                if p == 0:
                    val = cidx
                elif p == 1:
                    val = sidx
                elif p == 2:
                    val = y
                elif p == 3:
                    val = x
                elif p == 4:
                    val = abs(n_)
                elif p == 5:
                    val = abs(w_)
                elif p == 6:
                    val = n_
                elif p == 7:
                    val = w_
                elif p == 8:
                    val = w_ - (ww + nw - nww) if x > 0 else w_
                elif p == 9:
                    val = w_ + n_ - nw
                elif p == 10:
                    val = w_ - nw
                elif p == 11:
                    val = nw - n_
                elif p == 12:
                    val = n_ - ne
                elif p == 13:
                    val = n_ - nn
                elif p == 14:
                    val = w_ - ww
                elif p == 15:
                    val = wp.max_error_property if wp is not None else 0
                else:
                    refcidx = (p - 16) // 4
                    refc = m.channels[refcmap[refcidx]].data
                    val = int(refc[y][x])
                    if p & 2:
                        rw = int(refc[y][x - 1]) if x > 0 else 0
                        rn = int(refc[y - 1][x]) if y > 0 else rw
                        rnw = int(refc[y - 1][x - 1]) if (x > 0 and y > 0) else rw
                        val -= _gradient(rw, rn, rnw)
                    if p & 1:
                        val = abs(val)
                node = tree[node.left if val > node.value else node.right]
            pred = _predict(node.predictor, wp, w_, n_, nw, ne, nn, nee, ww)
            v = int(row[x])
            resid = v - node.offset - pred
            assert resid % node.multiplier == 0, "value not reachable with tree"
            out.append((node.ctx, pack_signed(resid // node.multiplier)))
            if wp is not None:
                wp.after_predict(x, y, v)
    return out


# -- forward transforms -----------------------------------------------------


def forward_rct(channels: list[np.ndarray], rct_type: int) -> list[np.ndarray]:
    """Forward RCT on 3 planes; inverse of modular.transforms.inverse_rct."""
    from ..modular.transforms import RCT_PERMUTATIONS

    perm = RCT_PERMUTATIONS[rct_type // 7]
    # inverse of output permutation: planes[i] ends up at perm[i]
    p = [None] * 3
    for i in range(3):
        p[i] = channels[perm[i]].astype(np.int64)
    t = rct_type % 7
    p0, p1, p2 = p
    if t == 1:
        p2 = p2 - p0
    elif t == 2:
        p2 = p2 - p1
    elif t == 3:
        p1 = p1 - p0
        p2 = p2 - p0
    elif t == 4:
        p1 = p1 - ((p0 + p2) >> 1)
    elif t == 5:
        p2 = p2 - p0
        p1 = p1 - p0 - (p2 >> 1)
    elif t == 6:  # YCgCo forward
        r, g, b = p0, p1, p2
        p1 = r - b  # Cg'?  derived as exact inverse of the decoder:
        tmp = b + (p1 >> 1)
        p2 = g - tmp
        p0 = tmp + (p2 >> 1)
    return [x.astype(np.int32) for x in (p0, p1, p2)]


def forward_squeeze_h(full: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Forward horizontal squeeze (spec H.6): returns (down, residual)."""
    from ..modular.transforms import _smooth_tendency, _trunc_div_vec

    h, w = full.shape
    a = full.astype(np.int64)
    wdown = (w + 1) // 2
    wres = w - wdown
    down = np.zeros((h, wdown), dtype=np.int64)
    res = np.zeros((h, wres), dtype=np.int64)
    A = a[:, 0 : 2 * wres : 2]
    B = a[:, 1 : 2 * wres : 2]
    # avg rounds toward A (the +(A>B) term makes the inverse exact for odd
    # positive diffs); diff = A - B; residual = diff - tendency
    avg = (A + B + (A > B)) >> 1
    down[:, :wres] = avg
    if w & 1:
        down[:, wdown - 1] = a[:, w - 1]
    diff_total = A - B
    # tendency needs left output (= B of previous pair) and next avg
    for x in range(wres):
        left = down[:, x] if x == 0 else B[:, x - 1]
        next_avg = down[:, x + 1] if x + 1 < wdown else down[:, x]
        tend = _smooth_tendency(left, down[:, x], next_avg)
        res[:, x] = diff_total[:, x] - tend
    return down.astype(np.int32), res.astype(np.int32)


def forward_squeeze_v(full: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    d, r = forward_squeeze_h(full.T)
    return d.T, r.T
