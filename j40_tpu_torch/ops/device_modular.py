"""Device-side lockstep decode of modular pass-group sections.

Counterpart of j40_tpu/ops/device_modular.py.  The TOC gives every group an
independent byte range with a fresh entropy stream (reference j40.h:5527-5537,
7749-7776; design note j40.h:447), so eligible sections decode on the card
one lane per section: the token kernel (ops/token_kernels.py, csrc/tokens.cu)
decodes every lane's hybrid-int values, then the wavefront kernels
(ops/wavefront_kernels.py, csrc/wavefront.cu) reconstruct the planes: lanes
of one leaf or tree and slot shapes form a class, and the slots of a class
that share a shape and a kernel go in one launch.  Host work is reduced to
the few header bits of each section, the checks and the write-back.

Eligibility is per section (anything else takes the host path with
identical results): the section's MA tree, local or global, is

- a single leaf with predictor 0/1/2/5, or 6 (WP) on an int16-range image;
- a multi-node tree over static properties (channel, stream, y, x) whose
  leaves the wavefronts order (a `ctx` lane: per-token clusters from the
  host's vectorized tree walk, per-pixel predictor/offset/multiplier);
- a tree over neighbour properties 4-15 with a single-cluster spec (an
  `ntree` lane: the tree walk runs inside the WP wavefront);

its code spec has no LZ77 and bounded extra bits (`spec_is_device_simple`,
`spec_is_device_multi`), and it carries no local transforms.  Lanes may have
different trees and code tables: the kernel takes one table row per spec.

Exactness: all integer; the planes are bit-identical to the host path.  The
stream-end and ANS-final-state checks (j40.h:2884-2897, 2011-2016) and the
int16 range are enforced per lane after the batch's one fetch.  A lane whose
WP error state leaves the exactness envelope is not written: its section
returns to the host, as in j40_tpu.  port: nothing else returns to the host
once a lane is taken; the Pallas path's `pallas_available()` gate has no
counterpart (the token kernel takes every spec the lane rules admit).
"""

from __future__ import annotations

import numpy as np
import torch

from ..entropy.ans import ANS_INIT_STATE
from ..errors import check
from ..io.bits import BitReader
from ..modular.decode import Channel, ModularImage, parse_modular_header
from ..profile import fetch, span, upload
from . import token_kernels as TKN
from . import wavefront_kernels as WK
from .device_entropy import (
    mixed_reconstruct,
    reconstruct_channel,
    spec_is_device_multi,
    spec_is_device_simple,
    tree_wp_reconstruct,
    unpack_signed_dev,
    wp_reconstruct_ovf,
)
from .hf_kernels import to_device

INT16_MIN, INT16_MAX = -0x8000, 0x7FFF

#: MA-tree properties computable before any sample decode (channel index,
#: stream index, y, x — decode.py:360-367 / j40.h:4046-4053); trees built
#: from ONLY these split the image into static regions, so the per-pixel
#: context walk vectorizes on the host and the lanes stay data-independent
STATIC_PROPS = (0, 1, 2, 3)


class _Lane:
    __slots__ = ("section", "data", "bitoff", "picks", "nsym", "leaf", "spec",
                 "ctx", "wp", "ntree")

    def __init__(self, section, data, bitoff, picks, leaf, spec, ctx=None,
                 wp=None, ntree=None):
        self.section = section
        self.data = data
        self.bitoff = bitoff
        self.picks = picks
        self.nsym = sum(w * h for (_, _, _, w, h) in picks)
        self.leaf = leaf
        self.spec = spec
        #: multi-node static-property lanes: per-slot dict of per-pixel
        #: (cluster, predictor, offset, multiplier) planes from the
        #: vectorized tree walk (None for the single-leaf fast path)
        self.ctx = ctx
        #: WPParams when any leaf uses the self-correcting predictor (the
        #: WP wavefront needs them); None otherwise
        self.wp = wp
        #: NEIGHBOR-property tree payload: hashable flattened tree for the
        #: in-wavefront walk (_tree_wp_reconstruct) + the lane's stream
        #: index; set only when the tree tests properties 4-15
        self.ntree = ntree


def _static_tree_walk(tree, cidx: int, sidx: int, h: int, w: int) -> np.ndarray:
    """Vectorized MA-tree walk over a (h, w) grid for STATIC_PROPS-only
    trees: every pixel descends the flattened node table simultaneously
    (property gathers, no per-pixel Python).  Returns per-pixel leaf node
    indices (host analog: decode.py:355-389, branch rule `val > node.value`
    -> left)."""
    prop = np.asarray([n.prop for n in tree], np.int32)
    value = np.asarray([n.value for n in tree], np.int32)
    left = np.asarray([n.left for n in tree], np.int32)
    right = np.asarray([n.right for n in tree], np.int32)
    yg, xg = np.mgrid[0:h, 0:w]
    yg = yg.astype(np.int32)
    xg = xg.astype(np.int32)
    node = np.zeros((h, w), np.int32)
    while True:
        p = prop[node]
        leafm = p < 0
        if leafm.all():
            return node
        v = np.select(
            [p == 0, p == 1, p == 2, p == 3],
            [np.full((h, w), cidx, np.int32),
             np.full((h, w), sidx, np.int32), yg, xg],
        )
        nxt = np.where(v > value[node], left[node], right[node])
        node = np.where(leafm, node, nxt)


def _prepare_lane(dec, state, s):
    """Host-parse one section's modular header; None when the section needs
    the host path (cross-channel tree properties, transforms, LZ77...) or
    decodes nothing."""
    data = dec.src.read(s.codeoff, s.size)
    region = state._group_region(s.idx)
    picks = state.modular_picks(region, 0, 3)
    if not picks:
        return None
    gm = state.gmodular
    sub = ModularImage(
        channels=[Channel(w, h) for (_, _, _, w, h) in picks], wide=gm.wide
    )
    r = BitReader(data)
    parse_modular_header(
        r, sub, state.global_tree, state.global_codespec, state.limits
    )
    if sub.transforms:
        return None
    leaf = sub.tree[0]
    if leaf.is_leaf:
        if leaf.predictor == 6 and not gm.wide:
            # self-correcting predictor: WP wavefront (int32-exact only for
            # int16-range samples — wide streams stay on the host)
            if not spec_is_device_simple(sub.codespec):
                return None
            return _Lane(s, data, r.bits_consumed, picks, leaf, sub.codespec,
                         wp=sub.wp_params)
        if leaf.predictor not in (0, 1, 2, 5):
            return None
        if not spec_is_device_simple(sub.codespec):
            return None
        return _Lane(s, data, r.bits_consumed, picks, leaf, sub.codespec)

    # multi-node tree: device-eligible when every branch tests a static
    # property and every leaf uses a wavefront predictor; trees with any
    # leaf outside the plain-wavefront set {0,1,2,5} route through the WP
    # wavefront, which orders every predictor but 13 (needs NEE) and is
    # int32-exact only for int16-range samples
    needs_wp = False
    neighbor_props = False
    for n in sub.tree:
        if n.is_leaf:
            if n.predictor not in (0, 1, 2, 5):
                if n.predictor == 13 or gm.wide:
                    return None
                needs_wp = True
        elif n.prop not in STATIC_PROPS:
            if 4 <= n.prop <= 15 and not gm.wide:
                neighbor_props = True
            else:
                return None  # cross-channel refs (>= 16) stay host-only
    # pass-group stream index (MA property 1), frame_state.py:146 rule
    sidx = (1 + 3 * state.f.num_lf_groups + 17
            + s.pass_ * state.f.num_groups + s.idx)
    if neighbor_props:
        # NEIGHBOR-property tree (cjxl -e3 shape, j40.h:4177-4218): with a
        # single-cluster spec the token sequence is context-free, so
        # tokens decode on the token kernel and the tree walk runs inside
        # the WP wavefront (device_entropy._tree_wp_reconstruct).
        # Multi-cluster neighbor trees would serialize entropy decode per
        # pixel -> host path.
        if not spec_is_device_simple(sub.codespec):
            return None
        on_card = dec.device is not None and dec.device.type == "cuda"
        if on_card and len(sub.tree) > WK.limits()["tree_nodes"]:
            return None  # kernel W3 holds its tree in shared memory
        tree_key = tuple(
            (-1, 0, 0, 0, n.predictor, n.offset, n.multiplier)
            if n.is_leaf else
            (n.prop, n.value, n.left, n.right, 0, 0, 0)
            for n in sub.tree)
        return _Lane(s, data, r.bits_consumed, picks, sub.tree[0],
                     sub.codespec, wp=sub.wp_params,
                     ntree=(tree_key, sidx))
    if not spec_is_device_multi(sub.codespec):
        return None
    cmap = np.asarray(sub.codespec.cluster_map, np.int32)
    ctxs = np.asarray([n.ctx for n in sub.tree], np.int32)
    preds = np.asarray([n.predictor for n in sub.tree], np.int32)
    offs = np.asarray([n.offset for n in sub.tree], np.int32)
    mults = np.asarray([n.multiplier for n in sub.tree], np.int32)
    slots = []
    for ci, (_, _, _, w, h) in enumerate(picks):
        nodes = _static_tree_walk(sub.tree, ci, sidx, h, w)
        slots.append({
            "cluster": cmap[ctxs[nodes]],
            "pred": preds[nodes],
            "offset": offs[nodes],
            "mult": mults[nodes],
        })
    return _Lane(s, data, r.bits_consumed, picks, leaf, sub.codespec,
                 ctx=slots, wp=sub.wp_params if needs_wp else None)


def _check_lane_end(lane, absbits: int, use_prefix: bool, fstate: int) -> None:
    """Per-lane stream-end validation (j40.h:2011-2016 + 2884-2897)."""
    if not use_prefix:
        check(fstate == ANS_INIT_STATE, "ans?")
    q, rbits = divmod(absbits, 8)
    nbytes = q + (1 if rbits else 0)
    check(nbytes <= len(lane.data), "shrt")
    if rbits:
        check(lane.data[q] >> rbits == 0, "pad0", "nonzero padding bits")
    check(nbytes == len(lane.data), "excs", "trailing data in section")


def pack_lanes(lanes) -> dict:
    """The token kernel's packed inputs (numpy) of a batch of lanes: one
    table row per distinct spec, per-token cluster ids for static-tree
    (`ctx`) lanes."""
    with span(None, "modular.pack"):
        cids = None
        if lanes[0].ctx is not None:
            cids = [np.concatenate([slot["cluster"].ravel() for slot in ln.ctx])
                    for ln in lanes]
        return TKN.build_lane_inputs([(ln.data, ln.bitoff) for ln in lanes],
                                     [ln.nsym for ln in lanes],
                                     [ln.spec for ln in lanes], cids)


def _decode_tokens(dec, lanes):
    """Every lane's token values on the card, in one call of the token
    kernel's wrapper: (values (L, n_steps) int32, final states, final bit
    positions), device tensors, and the `modular.setup` span of the packing,
    the uploads and the launch, whose end is that of `setup_s`."""
    with span(dec.stats, "modular.setup") as setup:
        out = TKN.launch_tokens(to_device(pack_lanes(lanes), dec.device))
    return (*out, setup)


def _range_check(gm, rec, n: int):
    """(plane, bad flag per lane): int16 planes and their range flags, or
    the int32 planes of a wide image (no range check)."""
    if gm.wide:
        return rec, torch.zeros(n, dtype=torch.bool, device=rec.device)
    bad = ((rec < INT16_MIN) | (rec > INT16_MAX)).flatten(1).any(dim=1)
    return rec.to(torch.int16), bad


def _finish_batch(dec, gm, lanes, pending, fstates, bitpos, use_prefix: bool,
                  route: str, count_key: str, batch: span, setup: span) -> list:
    """One batched fetch of the planes, flags and finals; the per-lane end
    checks and the write-back; the stats, whose clocks are the batch's
    spans: `setup_s` from the start of `modular.batch` to the end of
    `modular.setup`, `scan_fetch_s` from there to the start of
    `modular.write`, `write_s` that span.  Returns the lanes written (WP
    overflow lanes are left to the host)."""
    parts = ([p[2] for p in pending] + [p[3] for p in pending]
             + [p[4] for p in pending] + [fstates, bitpos])
    sizes = [t.numel() for t in parts]
    flat = fetch(torch.cat([t.reshape(-1).to(torch.int32) for t in parts])).numpy()
    fetched = np.split(flat, np.cumsum(sizes)[:-1])
    n = len(pending)
    planes = [f.reshape(p[2].shape) for f, p in zip(fetched[:n], pending)]
    bads, ovfs = fetched[n:2 * n], fetched[2 * n:3 * n]
    fstates_h, bitpos_h = fetched[-2], fetched[-1]

    with span(dec.stats, "modular.write") as write:
        # WP error-state overflow sentinel (ops/device_entropy.py): affected
        # lanes are NOT written or validated here — the caller leaves their
        # sections to the host path, which decodes them with full-width math
        failed = {li for (lis, _, _, _, _), ovf in zip(pending, ovfs)
                  for k, li in enumerate(lis) if ovf[k]}
        for li, ln in enumerate(lanes):
            if li in failed:
                continue
            base = (ln.bitoff // 8) & ~1
            _check_lane_end(ln, base * 8 + int(bitpos_h[li]), use_prefix,
                            int(fstates_h[li]) & 0xFFFFFFFF)
        for (lis, slot, _, _, _), plane, bad in zip(pending, planes, bads):
            for k, li in enumerate(lis):
                if li in failed:
                    continue
                check(not bad[k], "povf", "modular sample overflows int16 range")
                gi, x0, y0, w, h = lanes[li].picks[slot]
                gm.channels[gi].data[y0 : y0 + h, x0 : x0 + w] = plane[k]

    stats = dec.stats.setdefault("device_modular", {})
    stats["kernel"] = route
    stats[count_key] = stats.get(count_key, 0) + len(lanes)
    stats["tokens"] = stats.get("tokens", 0) + sum(ln.nsym for ln in lanes)
    # one plane batch per (class, slot); the wavefront launches are
    # counted where the route makes them (_launch_groups)
    stats["reconstructions"] = stats.get("reconstructions", 0) + len(pending)
    stats["setup_s"] = stats.get("setup_s", 0.0) + (setup.end_ns - batch.start_ns) * 1e-9
    stats["scan_fetch_s"] = (stats.get("scan_fetch_s", 0.0)
                             + (write.start_ns - setup.end_ns) * 1e-9)
    stats["write_s"] = stats.get("write_s", 0.0) + write.seconds
    return [ln for li, ln in enumerate(lanes) if li not in failed]


def _route(dec) -> str:
    """The token decode's route: the CUDA kernel, or its plain version on
    a CPU decode."""
    return "cuda" if dec.device.type == "cuda" else "plain"


def _stack(planes: list, group: list[int]):
    """The group's (L, H, W) slot planes as one (len(group) * L, H, W) batch."""
    return planes[group[0]] if len(group) == 1 else torch.cat([planes[s] for s in group])


def _launch_groups(dec, shapes, kinds, run, n: int) -> dict:
    """One wavefront launch (kernels W1-W3 on the card,
    ops/wavefront_kernels.py) for a class's slots of one shape that take
    one kernel (`kinds`, None: no wavefront): `run(group, kind, h, w)` ->
    (planes, overflow flags) of the group's slots as one batch of planes.
    Counts each launch in `wavefronts` (`reconstructions` counts the
    (class, slot) plane batches, those a cumsum or nothing reconstructs
    too) and returns each slot's (rec, ovf) of its n lanes."""
    groups: dict[tuple, list[int]] = {}
    for slot, key in enumerate(zip(shapes, kinds)):
        if key[1] is not None:
            groups.setdefault(key, []).append(slot)
    stats = dec.stats.setdefault("device_modular", {})
    out = {}
    for ((w, h), kind), group in groups.items():
        rec, ovf = run(group, kind, h, w)
        stats["wavefronts"] = stats.get("wavefronts", 0) + 1
        out.update(zip(group, zip(rec.split(n), ovf.split(n))))
    return out


def _decode_lane_batch(dec, gm, lanes, use_prefix: bool, batch: span):
    """Decode one same-coder batch of single-leaf lanes and write the
    planes."""
    dev = dec.device
    vals, fstates, bitpos, setup = _decode_tokens(dec, lanes)

    # --- per-shape-class wavefront reconstruction -------------------------
    classes: dict[tuple, list[int]] = {}
    for li, ln in enumerate(lanes):
        key = (
            ln.leaf.predictor, ln.leaf.multiplier, ln.leaf.offset,
            tuple((w, h) for (_, _, _, w, h) in ln.picks), ln.wp,
        )
        classes.setdefault(key, []).append(li)

    pending = []  # (lane indices, pick slot, plane batch, bad flag, ovf flag)
    for (predictor, mult, offset, shapes, wp_params), lis in classes.items():
        rows = upload(np.asarray(lis, np.int64), dev)
        n = len(lis)
        res, off = [], 0
        for w, h in shapes:
            r = unpack_signed_dev(vals[rows, off : off + w * h])
            if mult != 1:
                r = r * mult
            if offset != 0:
                r = r + offset
            res.append(r.reshape(n, h, w))
            off += w * h
        zero = torch.zeros(n, dtype=torch.bool, device=dev)
        if predictor in (5, 6):
            # the wavefront: one launch for the class's slots of a shape
            def run(group, _, h, w):
                if predictor == 6:
                    return wp_reconstruct_ovf(_stack(res, group), None, h, w, wp_params)
                return (reconstruct_channel(_stack(res, group), 5, h, w),
                        zero.repeat(len(group)))

            recs = _launch_groups(dec, shapes, [predictor] * len(shapes), run, n)
        else:
            recs = {slot: (reconstruct_channel(res[slot], predictor, h, w), zero)
                    for slot, (w, h) in enumerate(shapes)}
        for slot in range(len(shapes)):
            rec, bad = _range_check(gm, recs[slot][0], n)
            pending.append((lis, slot, rec, bad, recs[slot][1]))
    return _finish_batch(dec, gm, lanes, pending, fstates, bitpos, use_prefix,
                         _route(dec), "lanes", batch, setup)


def _decode_lane_batch_ctx(dec, gm, lanes, use_prefix: bool, batch: span):
    """Decode multi-context (static-property MA tree) lanes: per-token
    cluster ids select the table block inside the token kernel, and
    reconstruction uses the per-pixel predictor wavefront
    (`mixed_reconstruct`, or the WP one) with per-pixel offset and
    multiplier."""
    dev = dec.device
    vals, fstates, bitpos, setup = _decode_tokens(dec, lanes)

    classes: dict[tuple, list[int]] = {}
    for li, ln in enumerate(lanes):
        key = (tuple((w, h) for (_, _, _, w, h) in ln.picks), ln.wp)
        classes.setdefault(key, []).append(li)

    pending = []
    for (shapes, wp_params), lis in classes.items():
        rows = upload(np.asarray(lis, np.int64), dev)
        n = len(lis)
        zero = torch.zeros(n, dtype=torch.bool, device=dev)
        res, preds, kinds, off = [], [], [], 0
        for slot, (w, h) in enumerate(shapes):
            r = unpack_signed_dev(vals[rows, off : off + w * h])
            plane = lambda k: np.stack([lanes[li].ctx[slot][k] for li in lis])
            mult, offp, pred = plane("mult"), plane("offset"), plane("pred")
            r = r.reshape(n, h, w)
            if (mult != 1).any():
                r = r * upload(mult, dev)
            if offp.any():
                r = r + upload(offp, dev)
            res.append(r)
            preds.append(pred)
            # per-SLOT wavefront choice: a tree may gate WP behind (say) a
            # channel-index branch, so only slots whose pred plane holds a
            # code outside {0,1,2,5} pay the WP wavefront
            if wp_params is not None and not np.isin(pred, (0, 1, 2, 5)).all():
                kinds.append("wp")
            elif (pred != pred.flat[0]).any():
                kinds.append("mixed")
            else:  # one predictor: the gradient's wavefront, or a cumsum (None)
                kinds.append(5 if pred.flat[0] == 5 else None)
            off += w * h

        def run(group, kind, h, w):
            # one launch for the class's slots of a shape and a kernel
            batch = _stack(res, group)
            if kind == 5:
                return reconstruct_channel(batch, 5, h, w), zero.repeat(len(group))
            pcode = upload(np.concatenate([preds[s] for s in group]), dev)
            if kind == "wp":
                return wp_reconstruct_ovf(batch, pcode, h, w, wp_params)
            return mixed_reconstruct(batch, pcode, h, w), zero.repeat(len(group))

        recs = _launch_groups(dec, shapes, kinds, run, n)
        for slot, (w, h) in enumerate(shapes):
            if slot not in recs:  # predictor 0, 1 or 2 everywhere: no wavefront
                recs[slot] = (reconstruct_channel(res[slot], int(preds[slot].flat[0]), h, w),
                              zero)
            rec, bad = _range_check(gm, recs[slot][0], n)
            pending.append((lis, slot, rec, bad, recs[slot][1]))
    return _finish_batch(dec, gm, lanes, pending, fstates, bitpos, use_prefix,
                         f"{_route(dec)}-ctx", "ctx_lanes", batch, setup)


def _decode_lane_batch_ntree(dec, gm, lanes, use_prefix: bool, batch: span):
    """NEIGHBOR-property-tree lanes: tokens decode context-free (single
    cluster), then every pick slot reconstructs through the in-wavefront
    tree walk (device_entropy._tree_wp_reconstruct): per-pixel
    predictor/offset/multiplier from properties 0-15 evaluated on the
    d = 2y+x diagonals, bit-exact vs the host walk."""
    dev = dec.device
    vals, fstates, bitpos, setup = _decode_tokens(dec, lanes)

    # classes: one (tree, wp, shapes) program per slot; sidx per lane
    classes: dict[tuple, list[int]] = {}
    for li, ln in enumerate(lanes):
        key = (ln.ntree[0], ln.wp,
               tuple((w, h) for (_, _, _, w, h) in ln.picks))
        classes.setdefault(key, []).append(li)

    pending = []
    for (tree_key, wp_params, shapes), lis in classes.items():
        rows = upload(np.asarray(lis, np.int64), dev)
        n = len(lis)
        sidx = upload(np.asarray([lanes[li].ntree[1] for li in lis], np.int32), dev)
        res, off = [], 0
        for w, h in shapes:
            res.append(unpack_signed_dev(vals[rows, off : off + w * h]).reshape(n, h, w))
            off += w * h

        def run(group, _, h, w):
            # one launch for the class's slots of a shape; the channel index
            # of a plane is its pick slot (RGB channels 0..2)
            cidx = upload(np.asarray(group, np.int32), dev).repeat_interleave(n)
            return tree_wp_reconstruct(_stack(res, group), tree_key, cidx,
                                       sidx.repeat(len(group)), h, w, wp_params)

        recs = _launch_groups(dec, shapes, ["tree"] * len(shapes), run, n)
        for slot in range(len(shapes)):
            rec, bad = _range_check(gm, recs[slot][0], n)
            pending.append((lis, slot, rec, bad, recs[slot][1]))
    return _finish_batch(dec, gm, lanes, pending, fstates, bitpos, use_prefix,
                         f"{_route(dec)}+tree-wavefront", "ntree_lanes", batch, setup)


def plan_lanes(dec, state, sections) -> list:
    """The lanes of the eligible sections among `sections`, one each."""
    return [ln for s in sections if (ln := _prepare_lane(dec, state, s))]


def try_device_pass_groups(dec, state, f, sections) -> list:
    """Decode eligible modular pass-group sections on the device, write their
    planes into the gmodular image, and return the sections decoded.

    Ineligible sections are skipped and left for the host path."""
    if not sections or state.gmodular is None:
        return []
    with span(dec.stats, "modular.plan"):
        lanes = plan_lanes(dec, state, sections)
    if not lanes:
        return []
    gm = state.gmodular
    out = []
    for use_prefix in (True, False):
        for decode, kind in ((_decode_lane_batch, lambda ln: ln.ctx is None and ln.ntree is None),
                             (_decode_lane_batch_ctx, lambda ln: ln.ctx is not None),
                             (_decode_lane_batch_ntree, lambda ln: ln.ntree is not None)):
            batch = [ln for ln in lanes if ln.spec.use_prefix_code == use_prefix and kind(ln)]
            if not batch:
                continue
            # a batch is one launch of the token kernel B6, as long as its
            # longest lane
            with span(dec.stats, "modular.batch",
                      longest_lane=max(ln.nsym for ln in batch)) as sp:
                ok = decode(dec, gm, batch, use_prefix, sp)
            out.extend(ln.section for ln in ok)
    return out
