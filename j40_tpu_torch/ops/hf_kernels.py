"""On-chip VarDCT HF coefficient decode of DCT8 pass-group sections: the two
CUDA kernels, their plain PyTorch versions, their wrappers and their host
packers.

Counterpart of j40_tpu/ops/pallas_hf.py; the kernels are in csrc/hf.cu.
Each lane is one pass-group section (an isolated entropy stream, j40.h:447,
7749-7776) whose cells are all DCT8 varblocks: per cell, per channel in Y,
X, B order, one nonzero-count symbol, then coefficient symbols until that
many nonzeros have appeared (j40.h:6888-7005, log_size = 6).

| wrapper      | plain version    | TPU kernel replaced                      |
| hf_walk      | hf_walk_ref      | pallas_hf._make_hf_kernel (B4): single-cluster spec, prefix or rANS; the symbol sequence is context-free |
| hf_ctx_walk  | hf_ctx_walk_ref  | pallas_hf._make_hf_ctx_kernel (B5): multi-cluster rANS with the full HF context model |

The kernels' interface is the Pallas kernels' resumable machine snapshot
(`init` in, `st` out, one column per lane): B4 rows 0 ANS state bits, 1 bit
position (from the lane's even-byte base), 2 cell k, 3 channel cyxb, 4
nonzeros left, 5 coefficient index i, 6 err, 7 done; B5 adds 7 prev, 8 x8,
9 y8, 10 gw8, 11 ctxoff, 12 done and, in rows 16-111, the nonzero ring (3
channels x 32 cells of the row above).  A walk stops after `cap_steps`
symbols or when the lane is done.  The coefficients land in NATURAL
positions of dense (L, 3, ncells_max, 64) float32 planes (XYB channel
order), which the wrapper allocates zeroed: the Pallas path's order-space
scatter and its inverse-order gather (`_scatter_coeffs`,
`_unpermute_orders`) fold into the walk, since each lane writes only its
own positions.  A resumed walk writes into the same planes.

Each plain version is one loop iteration per symbol step over all lanes,
with masks, as the Pallas kernel's lockstep is; it computes the same
function from the same packed inputs.  It runs on the tensors' device, so
a card run can time it there; the wrappers take it only for CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from ..profile import upload
from ..vardct.tables import TWICE_COEFF_FREQ_CTX, TWICE_COEFF_NNZ_CTX
from . import kernels as K
from .device_entropy import (
    ans_luts,
    pack_alias_buckets,
    pack_prefix_lut,
    pack_streams,
    spec_is_pallas_simple,
    stream_bits,
)

YXB2XYB = (1, 0, 2)
#: sections per launch: the Pallas kernels' 128 lanes, which the LF-group
#: batching of ops/device_vardct.py keeps to (an LF group has <= 64)
MAX_LANES = 128
#: snapshot rows (see the module docstring)
ST_ROWS, CTX_ST_ROWS = 8, 112
DONE_ROW, CTX_DONE_ROW, RING_ROW = 7, 12, 16
#: widest single-cluster prefix LUT (spec_is_pallas_simple) and the largest
#: B5 tables (spec_is_device_ctx): what the kernels stage in shared memory
MAX_PREFIX_WIDTH = 13
MAX_CTX_AB, MAX_CTX_CMAP, CMAP_PAD = 8192, 8192, 16
#: cells per row of B5's nonzero ring (the Pallas kernel's 3 x 32): groups
#: of up to 256 pixels; wider groups (group_size_shift 2-3) take the host
RING_CELLS = 32


def hard_bound(ncells) -> int:
    """The format's bound on a DCT8 section's symbols: 3 channels x (one
    nonzero count + 63 coefficients) per cell (j40.h:6959-6992)."""
    return 192 * int(max(ncells))


def hf_spec_is_device_simple(spec) -> bool:
    """Single-cluster, LZ77-free coefficient spec (context-free symbols)."""
    return spec_is_pallas_simple(spec)


def spec_is_device_ctx(spec) -> bool:
    """Eligibility for the multi-cluster context-model kernel: ANS,
    LZ77-free, every per-cluster table in-kernel-addressable (port: the
    counterpart of pallas_hf.spec_is_pallas_ctx)."""
    if spec.lz77_enabled or spec.use_prefix_code:
        return False
    C = spec.num_clusters
    T = 1 << spec.log_alpha_size
    if C > 255 or C * 2 * T > MAX_CTX_AB:
        return False
    if len(spec.cluster_map) > MAX_CTX_CMAP:
        return False
    for cl in spec.clusters:
        cfg = cl.config
        if cfg.msb_in_token + cfg.lsb_in_token > 8:
            return False
        if cfg.msb_in_token > 15 or cfg.lsb_in_token > 15:
            return False
        if cfg.split_exp > 31:
            return False
        _, sym = ans_luts(cl)
        if sym.max() > 0xFF:
            return False
        alpha = int(max((t for t, fq in enumerate(cl.D) if fq > 0),
                        default=0)) + 1
        split = 1 << cfg.split_exp
        if alpha - 1 >= split:
            nbits = cfg.msb_in_token + cfg.lsb_in_token
            worst = cfg.split_exp - nbits + ((alpha - 1 - split) >> nbits)
            if worst > 17:
                return False
    return True


# ---------------------------------------------------------------- host packers


def _natural_slots(orders_yxb) -> np.ndarray:
    """(3, 64) int32: the natural position of order index i, per XYB
    channel slot (orders_yxb is per YXB channel; YXB2XYB is its own
    inverse)."""
    o = np.asarray(orders_yxb, np.int32)
    return np.stack([o[YXB2XYB[c]] for c in range(3)])


def _words_and_init(streams, rows: int, ans: bool):
    """The lanes' 16-bit words (L, W) uint16 and a zeroed (rows, L) snapshot
    with the start of each walk: for ANS the 32 state bits at the skip,
    then bitpos = skip + 32 (pallas_hf.py:521-527), else bitpos = skip."""
    words, skips = pack_streams(streams)
    init = np.zeros((rows, len(streams)), np.int32)
    if ans:
        cat = (words[:, 0].astype(np.uint64) | (words[:, 1].astype(np.uint64) << 16)
               | (words[:, 2].astype(np.uint64) << 32))
        st0 = ((cat >> skips.astype(np.uint64)) & 0xFFFFFFFF).astype(np.uint32)
        init[0] = st0.view(np.int32)
        init[1] = skips + 32
    else:
        init[1] = skips
    return words.astype(np.uint16), init


def build_multi_inputs(lane_groups) -> dict:
    """Pack lanes drawn from one or more single-cluster code specs into one
    B4 launch (port: the counterpart of pallas_hf.build_multi_inputs).

    lane_groups: list of (streams [(bytes, bit_offset)], ncells per lane,
    spec, orders_yxb (3, 64)).  All specs must agree on use_prefix; prefix
    LUTs are padded to the widest code.  Returns numpy arrays: words (L, W)
    uint16, init (8, L), nc (L,), lut (the specs' tables stacked, each
    once), lane (L, 8) = [table base, table length, log_bucket_size, lsb,
    split, msb + lsb, split_exp - msb - lsb, msb] per lane, nat (L, 3, 64),
    nbits (L,) (the section lengths in bits, `stream_bits`); and use_prefix,
    prefix_width, L, ncells_all, max_bytes."""
    all_streams = [s for g in lane_groups for s in g[0]]
    L = len(all_streams)
    assert 0 < L <= MAX_LANES
    use_prefix = lane_groups[0][2].use_prefix_code
    assert all(g[2].use_prefix_code == use_prefix for g in lane_groups)
    width = (max(max(1, g[2].clusters[0].prefix.max_len) for g in lane_groups)
             if use_prefix else 0)
    assert width <= MAX_PREFIX_WIDTH

    tables: list[np.ndarray] = []
    seen: dict[bytes, int] = {}
    lane = np.zeros((L, 8), np.int32)
    nat = np.empty((L, 3, 64), np.int32)
    nc = np.empty(L, np.int32)
    li = 0
    for _streams, ncl, spec, orders_yxb in lane_groups:
        cl = spec.clusters[0]
        if use_prefix:
            t, lbs = pack_prefix_lut(cl.prefix, width), 0
        else:
            t, lbs = pack_alias_buckets(cl)
        base = seen.get(t.tobytes())
        if base is None:
            base = seen[t.tobytes()] = sum(len(x) for x in tables)
            tables.append(t)
        c = cl.config
        bits = c.msb_in_token + c.lsb_in_token
        row = (base, len(t), lbs, c.lsb_in_token, 1 << c.split_exp, bits,
               c.split_exp - bits, c.msb_in_token)
        slots = _natural_slots(orders_yxb)
        for n in ncl:
            lane[li], nat[li], nc[li] = row, slots, n
            li += 1
    words, init = _words_and_init(all_streams, ST_ROWS, not use_prefix)
    return dict(words=words, init=init, nc=nc, lut=np.concatenate(tables),
                lane=lane, nat=nat, nbits=stream_bits(all_streams),
                use_prefix=use_prefix, prefix_width=width,
                L=L, ncells_all=[int(n) for n in nc],
                max_bytes=max(len(d) for d, _ in all_streams))


def build_ctx_inputs(streams, ncells, spec, bctx3_per_lane, gw8s, ctxoffs,
                     orders_yxb) -> dict:
    """Pack one multi-cluster spec's tables and the per-lane planes for one
    B5 launch (port: the counterpart of pallas_hf.build_ctx_inputs, with
    the coefficient order added).

    bctx3_per_lane: per lane an (ncells,) int32 array with the three YXB
    block contexts of each cell packed 10 bits apart; gw8s/ctxoffs: per-lane
    group width in cells / preset context offset.  Returns numpy arrays:
    words (L, W) uint16, init (112, L), nc (L,), ab (per-cluster bucket
    records, 2*T words each), cmap (the cluster map, 4 bytes per int32),
    cfgw (256,) per-cluster hybrid config lsb | msb << 4 | split_exp << 8,
    nf (64,) TWICE_COEFF_NNZ_CTX | TWICE_COEFF_FREQ_CTX << 16, bctx3 (L,
    ncells_max), nat (3, 64); and L, ncells_all, max_bytes, log_alpha."""
    L = len(streams)
    assert 0 < L <= MAX_LANES
    if max(gw8s) > RING_CELLS:
        raise ValueError(f"group {max(gw8s)} cells wide: the nonzero ring holds "
                         f"{RING_CELLS}")
    T = 1 << spec.log_alpha_size
    ab = np.zeros(spec.num_clusters * 2 * T, np.int32)
    cfgw = np.zeros(256, np.int32)
    for ci, cl in enumerate(spec.clusters):
        buckets, lbs = pack_alias_buckets(cl)
        assert lbs == 12 - spec.log_alpha_size
        ab[ci * 2 * T: ci * 2 * T + len(buckets)] = buckets
        c = cl.config
        cfgw[ci] = c.lsb_in_token | (c.msb_in_token << 4) | (c.split_exp << 8)

    cm = np.asarray(spec.cluster_map, np.int64)
    # 16 more contexts of cluster 0: on a corrupt stream a coefficient
    # context passes the map's end by up to 15 (TWICE_COEFF_NNZ_CTX +
    # TWICE_COEFF_FREQ_CTX + prev reach 473 of a block context's 458)
    cm4 = np.zeros(-(-(len(cm) + CMAP_PAD) // 4) * 4, np.int64)
    cm4[: len(cm)] = cm
    cmap = (cm4[0::4] | (cm4[1::4] << 8) | (cm4[2::4] << 16)
            | (cm4[3::4] << 24)).astype(np.uint32).view(np.int32)
    nf = (np.asarray(TWICE_COEFF_NNZ_CTX, np.int64)
          | (np.asarray(TWICE_COEFF_FREQ_CTX, np.int64) << 16)).astype(np.int32)

    words, init = _words_and_init(streams, CTX_ST_ROWS, True)
    init[10] = np.asarray(gw8s, np.int32)
    init[11] = np.asarray(ctxoffs, np.int32)
    nc = np.asarray(ncells, np.int32)
    bctx3 = np.zeros((L, int(nc.max())), np.int32)
    for li, b3 in enumerate(bctx3_per_lane):
        bctx3[li, : len(b3)] = b3
    return dict(words=words, init=init, nc=nc, ab=ab, cmap=cmap, cfgw=cfgw,
                nf=nf, bctx3=bctx3, nat=_natural_slots(orders_yxb), L=L,
                ncells_all=[int(n) for n in nc],
                max_bytes=max(len(d) for d, _ in streams),
                log_alpha=spec.log_alpha_size)


def to_device(inp: dict, device) -> dict:
    """Tensors on `device` for the arrays of a packed input (the words as
    int16, which the kernels read as uint16), one blocking upload each."""
    dev = torch.device(device)
    out = dict(inp)
    for k, v in inp.items():
        if isinstance(v, np.ndarray):
            a = v.view(np.int16) if v.dtype == np.uint16 else v
            out[k] = upload(a, dev)
    return out


# ---------------------------------------------------------------- plain versions


def _window(words, bitpos):
    """The next 33 or more bits of each lane at `bitpos`, LSB-first (int64):
    three 16-bit words shifted by the position in the first, zeros past the
    end of the words, as the host reader pads.  A symbol reads at most 33
    bits (16 renormalization bits, or a prefix code of <= 13, then <= 17
    hybrid-int bits: MAX_MIDBITS)."""
    W = words.shape[1]
    i = (bitpos >> 4)[:, None] + torch.arange(3, device=bitpos.device)
    w = torch.where(i < W, words.gather(1, i.clamp(max=W - 1)), 0)
    return (w[:, 0] | (w[:, 1] << 16) | (w[:, 2] << 32)) >> (bitpos & 15)


def _hybrid(win, consumed, tok, active, lsbr, split, bits, base_mid, msb):
    """Hybrid-int value of each active lane's token, its extra bits read
    from the window after the `consumed` symbol bits (j40.h:2313-2327,
    arithmetically as pallas_hf.py:197-217): returns (value, bits consumed
    in all)."""
    is_lit = tok < split
    midbits = base_mid + ((tok - split).clamp(min=0) >> bits)
    lo_v = tok & ((1 << lsbr) - 1)
    hi_v = (tok >> lsbr) & ((1 << msb) - 1)
    A = torch.where(is_lit, tok, ((1 << msb) | hi_v) << lsbr)
    mb = torch.where(active & ~is_lit, midbits, 0)
    mid = (win >> consumed) & ((1 << mb) - 1)
    value = (A << mb) | (mid << lsbr) | torch.where(is_lit, 0, lo_v)
    return torch.where(active, value, 0), consumed + mb


def _ans_step(state, win, active, e0, e1, pos, i_b):
    """rANS alias decode from a bucket's two records (pallas_hf.py:164-195):
    freq 0 means 4096; the renormalization reads 16 bits.  Returns (token,
    new state, bits consumed)."""
    direct = pos < (e0 & 0x1FFF)
    tok = torch.where(direct, i_b, (e1 >> 24) & 0xFF)
    base = torch.where(direct, pos, (e1 & 0xFFF) + pos)
    freq = torch.where(direct, (e0 >> 13) & 0xFFF, (e1 >> 12) & 0xFFF)
    freq = torch.where(freq == 0, 4096, freq)
    nstate = freq * (state >> 12) + base
    renorm = active & (nstate < (1 << 16))
    nstate = torch.where(renorm, (nstate << 16) | (win & 0xFFFF), nstate)
    return tok, torch.where(active, nstate, state), torch.where(renorm, 16, 0)


def _structure(value, active, k, cyxb, nzrem, ii, err):
    """One step of the DCT8 structure walk (pallas_hf.py:220-262): the
    nonzero count, then coefficients until `nzrem` reaches 0; nz > 63 and
    an overrun past position 63 set err.  Returns the advanced (k, cyxb,
    nzrem, ii, err) and, for the coefficient written this step, (emit mask,
    XYB slot, signed value, hit)."""
    is_nz = nzrem == 0
    nz_err = active & is_nz & (value > 63)
    start = is_nz & (value > 0)
    half = value >> 1
    sval = torch.where((value & 1) == 1, -half - 1, half)
    c_xyb = torch.where(cyxb == 0, 1, torch.where(cyxb == 1, 0, 2))
    hit = value != 0
    nzrem_c = nzrem - hit.long()
    ii_c = ii + 1
    coeff_err = active & ~is_nz & (ii_c >= 64) & (nzrem_c > 0)
    emit = active & ~is_nz
    nzrem2 = torch.where(is_nz, torch.where(start, value, 0),
                         torch.where(coeff_err, 0, nzrem_c))
    ii2 = torch.where(is_nz, torch.where(start, 1, ii), ii_c)
    adv = active & ((is_nz & (value == 0)) | (~is_nz & ((nzrem_c == 0) | coeff_err)))
    cyxb2 = torch.where(adv, cyxb + 1, cyxb)
    wrap = cyxb2 == 3
    cyxb2 = torch.where(wrap, 0, cyxb2)
    k2 = torch.where(wrap, k + 1, k)
    err2 = err | (nz_err | coeff_err).long()
    return (k2, cyxb2, nzrem2, ii2, err2), (emit, c_xyb, sval, wrap, is_nz, hit)


def _emit(out, nat, emit, c_xyb, k, ii, sval):
    """Write the emitted nonzero coefficients at their natural positions."""
    m = emit & (sval != 0)
    if m.any():
        lanes = torch.nonzero(m)[:, 0]
        c, kk, i = c_xyb[lanes], k[lanes], ii[lanes] & 63
        pos = nat[lanes, c, i] if nat.dim() == 3 else nat[c, i]
        out[lanes, c, kk, pos] = sval[lanes].to(out.dtype)


def _snapshot(rows, state, bitpos, k, cyxb, nzrem, ii, err, nc, done_row, extra=()):
    st = torch.zeros((rows, k.shape[0]), dtype=torch.int64, device=k.device)
    for r, v in enumerate((state, bitpos, k, cyxb, nzrem, ii, err, *extra)):
        st[r] = v
    st[done_row] = ((k >= nc) | (err != 0)).long()
    st[0] = torch.where(state >= (1 << 31), state - (1 << 32), state)
    return st.to(torch.int32)


def hf_walk_ref(words, init, ncells, lut, lane, nat, out, cap_steps: int,
                use_prefix: bool, prefix_width: int):
    """Plain version of `hf_walk` (B4)."""
    w = words.long() & 0xFFFF
    st = init.long()
    state, bitpos = st[0] & 0xFFFFFFFF, st[1]
    k, cyxb, nzrem, ii, err = (st[r] for r in range(2, 7))
    nc, lut, ln = ncells.long(), lut.long(), lane.long()
    base, lbs = ln[:, 0], ln[:, 2]
    hyb = [ln[:, j] for j in range(3, 8)]
    for _ in range(cap_steps):
        active = (k < nc) & (err == 0)
        if not active.any():
            break
        win = _window(w, bitpos)
        if use_prefix:
            e = lut[base + (win & ((1 << prefix_width) - 1))]
            tok = e & 0xFFFF
            consumed = torch.where(active, e >> 16, 0)
        else:
            idx12 = state & 0xFFF
            i_b = idx12 >> lbs
            pos = idx12 & ((1 << lbs) - 1)
            e0 = lut[base + 2 * i_b]
            e1 = lut[base + 2 * i_b + 1]
            tok, state, consumed = _ans_step(state, win, active, e0, e1, pos, i_b)
        tok = torch.where(active, tok, 0)
        value, consumed = _hybrid(win, consumed, tok, active, *hyb)
        bitpos = bitpos + torch.where(active, consumed, 0)
        (k2, cyxb, nzrem, ii2, err), (emit, c_xyb, sval, *_r) = _structure(
            value, active, k, cyxb, nzrem, ii, err)
        _emit(out, nat, emit, c_xyb, k, ii, sval)
        k, ii = k2, ii2
    return _snapshot(ST_ROWS, state, bitpos, k, cyxb, nzrem, ii, err, nc, DONE_ROW)


def hf_ctx_walk_ref(words, init, ncells, ab, cmap, cfgw, nf, bctx3, nat, out,
                    cap_steps: int, nb_bctx: int, log_alpha: int):
    """Plain version of `hf_ctx_walk` (B5)."""
    w = words.long() & 0xFFFF
    st = init.long()
    state, bitpos = st[0] & 0xFFFFFFFF, st[1]
    k, cyxb, nzrem, ii, err, prev, x8, y8 = (st[r] for r in range(2, 10))
    gw8, ctxoff = st[10], st[11]
    ring = st[RING_ROW:RING_ROW + 96].clone()
    nc, ab, nf, b3 = ncells.long(), ab.long(), nf.long(), bctx3.long()
    cmap = cmap.long() & 0xFFFFFFFF
    cfgw = cfgw.long()
    T, LBS = 1 << log_alpha, 12 - log_alpha
    lanes = torch.arange(k.shape[0], device=k.device)
    for _ in range(cap_steps):
        active = (k < nc) & (err == 0)
        if not active.any():
            break
        is_nz = nzrem == 0
        c_xyb = torch.where(cyxb == 0, 1, torch.where(cyxb == 1, 0, 2))
        # block context of (cell k, channel cyxb)
        bctx = (b3[lanes, k.clamp(0, b3.shape[1] - 1)] >> (10 * cyxb)) & 0x3FF
        # nonzero-count context: the prediction from the left/top ring
        rbase = c_xyb * 32
        nzl = ring[rbase + (x8 - 1).clamp(min=0), lanes]
        nzt = ring[rbase + x8, lanes]
        has_w, has_n = x8 > 0, y8 > 0
        nzp = torch.where(has_w & has_n, (nzl + nzt + 1) >> 1,
                          torch.where(has_w, nzl, torch.where(has_n, nzt, 32)))
        bucket = torch.where(nzp < 8, nzp, 4 + (nzp >> 1))
        ctx_nz = ctxoff + bctx + bucket * nb_bctx
        # coefficient context
        ctx_co = (ctxoff + 458 * bctx + 37 * nb_bctx + (nf[nzrem.clamp(0, 63)] & 0xFFFF)
                  + (nf[ii & 63] >> 16) + prev)
        # (clamped for the lanes that are done, whose contexts go unused)
        ctx = torch.where(is_nz, ctx_nz, ctx_co).clamp(0, 4 * cmap.shape[0] - 1)
        cluster = (cmap[ctx >> 2] >> ((ctx & 3) * 8)) & 0xFF
        cw = cfgw[cluster]
        lsbr, msb, sexp = cw & 15, (cw >> 4) & 15, (cw >> 8) & 31
        bits = msb + lsbr
        # rANS alias decode against the cluster's bucket records
        slot = state & 0xFFF
        i_b, pos = slot >> LBS, slot & ((1 << LBS) - 1)
        at = cluster * (2 * T) + 2 * i_b
        win = _window(w, bitpos)
        tok, state, consumed = _ans_step(state, win, active, ab[at], ab[at + 1], pos, i_b)
        tok = torch.where(active, tok, 0)
        value, consumed = _hybrid(win, consumed, tok, active, lsbr, 1 << sexp, bits,
                                  sexp - bits, msb)
        bitpos = bitpos + torch.where(active, consumed, 0)
        # the structure walk, the ring and the prev flag (pallas_hf.py:915-953)
        wr = active & is_nz
        ring[(rbase + x8)[wr], lanes[wr]] = value[wr]
        (k2, cyxb, nzrem, ii2, err), (emit, _c, sval, wrap, _n, hit) = _structure(
            value, active, k, cyxb, nzrem, ii, err)
        _emit(out, nat, emit, c_xyb, k, ii, sval)
        prev = torch.where(active, torch.where(is_nz, (value <= 4).long(), hit.long()), prev)
        x8n = x8 + 1
        xwrap = x8n >= gw8
        y8 = torch.where(wrap & xwrap, y8 + 1, y8)
        x8 = torch.where(wrap, torch.where(xwrap, 0, x8n), x8)
        k, ii = k2, ii2
    st = _snapshot(CTX_ST_ROWS, state, bitpos, k, cyxb, nzrem, ii, err, nc, CTX_DONE_ROW,
                   (prev, x8, y8, gw8, ctxoff))
    st[RING_ROW:] = ring.to(torch.int32)
    return st


# ---------------------------------------------------------------- wrappers


def _check_walk(words, init, ncells, nat, out, rows: int):
    L = ncells.shape[0]
    if not 0 < L <= MAX_LANES or words.dim() != 2 or words.shape[0] != L:
        raise ValueError(f"words: want (L<={MAX_LANES}, W), got {tuple(words.shape)}")
    K._check("words", words, tuple(words.shape), torch.int16)
    K._check("init", init, (rows, L), torch.int32)
    K._check("ncells", ncells, (L,), torch.int32)
    K._check("nat", nat, tuple(nat.shape), torch.int32)
    if out.dim() != 4 or tuple(out.shape[:2]) != (L, 3) or out.shape[3] != 64:
        raise ValueError(f"out: want (L, 3, ncells_max, 64), got {tuple(out.shape)}")
    K._check("out", out, tuple(out.shape))


def design(use_prefix: bool) -> str:
    """The design a B4 launch takes: "sync" (prefix lanes: the
    self-synchronising decode, then the structure pass) or "serial" (rANS
    lanes: one thread per lane)."""
    return "sync" if use_prefix else "serial"


#: the design of every B5 launch: one decoding thread per lane that forms
#: the next symbol's context for both outcomes of a coefficient while the
#: symbol decodes, and a walking warp (csrc/hf.cu hf_ctx_kernel)
CTX_DESIGN = "lookahead"


def hf_walk(words, init, ncells, lut, lane, nat, out, cap_steps: int,
            use_prefix: bool, prefix_width: int, nbits=None, stats_out=None):
    """Walk up to `cap_steps` symbols of each lane's single-cluster DCT8
    section from the snapshot `init` (8, L), writing the coefficients into
    `out` (L, 3, ncells_max, 64) float32 in place; returns the new (8, L)
    snapshot.  words (L, W) int16 holding uint16 stream words, ncells (L,),
    lut, lane (L, 8) and nat (L, 3, 64) int32 as build_multi_inputs packs
    them (port: one launch of the Pallas kernel's budget loop).  Optional,
    for the kernel: nbits (L,) int32, each lane's section length in bits
    (the sync design decodes in parallel up to there; None: up to the
    lane's last nonzero word), and stats_out, a dict that receives the sync
    design's statistics (kernels._sync_stats)."""
    L = ncells.shape[0]
    _check_walk(words, init, ncells, nat, out, ST_ROWS)
    K._check("lut", lut, tuple(lut.shape), torch.int32)
    K._check("lane", lane, (L, 8), torch.int32)
    if nat.shape != (L, 3, 64) or (use_prefix and not 0 < prefix_width <= MAX_PREFIX_WIDTH):
        raise ValueError(f"nat {tuple(nat.shape)}, prefix width {prefix_width}")
    if nbits is not None:
        K._check("nbits", nbits, (L,), torch.int32)
    if not K._on_cuda(words, init, ncells, lut, lane, nat, out,
                      *([] if nbits is None else [nbits])):
        return hf_walk_ref(words, init, ncells, lut, lane, nat, out, cap_steps,
                           use_prefix, prefix_width)
    st = torch.empty_like(init)
    W = words.shape[1]
    # the prefix design's values: at most min(cap, 192 a cell) per lane
    V = min(int(cap_steps), 192 * out.shape[2]) if use_prefix else 0
    scratch = K._entropy_scratch("j40tt_hf_walk_scratch", words.device, L, W,
                                 prefix_width, int(use_prefix), V)
    K._launch("hf", "j40tt_hf_walk", words.device, words.data_ptr(), W,
              init.data_ptr(), st.data_ptr(), ncells.data_ptr(), lut.data_ptr(),
              lut.numel(), lane.data_ptr(), nat.data_ptr(), out.data_ptr(), L,
              out.shape[2], int(cap_steps), int(use_prefix), prefix_width,
              scratch.data_ptr(), V, 0 if nbits is None else nbits.data_ptr())
    if design(use_prefix) == "sync":
        K._sync_stats(stats_out, scratch, L, W)
    return st


def hf_ctx_walk(words, init, ncells, ab, cmap, cfgw, nf, bctx3, nat, out,
                cap_steps: int, nb_bctx: int, log_alpha: int):
    """Walk up to `cap_steps` symbols of each lane's multi-cluster DCT8
    section with the HF context model, from the snapshot `init` (112, L)
    (ring included), writing the coefficients into `out` in place; returns
    the new (112, L) snapshot.  Tables as build_ctx_inputs packs them."""
    L = ncells.shape[0]
    _check_walk(words, init, ncells, nat, out, CTX_ST_ROWS)
    for name, t, shape in (("ab", ab, (ab.numel(),)), ("cmap", cmap, (cmap.numel(),)),
                           ("cfgw", cfgw, (256,)), ("nf", nf, (64,)),
                           ("bctx3", bctx3, (L, bctx3.shape[-1])), ("nat", nat, (3, 64))):
        K._check(name, t, shape, torch.int32)
    if (ab.numel() > MAX_CTX_AB or cmap.numel() * 4 > MAX_CTX_CMAP + CMAP_PAD + 3
            or not 5 <= log_alpha <= 8 or bctx3.shape[1] < out.shape[2]):
        raise ValueError(f"ctx tables: ab {ab.numel()}, cmap {cmap.numel()}, log_alpha "
                         f"{log_alpha}, bctx3 {tuple(bctx3.shape)}")
    if not K._on_cuda(words, init, ncells, ab, cmap, cfgw, nf, bctx3, nat, out):
        return hf_ctx_walk_ref(words, init, ncells, ab, cmap, cfgw, nf, bctx3, nat, out,
                               cap_steps, nb_bctx, log_alpha)
    st = torch.empty_like(init)
    K._launch("hf_ctx", "j40tt_hf_ctx_walk", words.device, words.data_ptr(),
              words.shape[1], init.data_ptr(), st.data_ptr(), ncells.data_ptr(),
              ab.data_ptr(), ab.numel(), cmap.data_ptr(), cmap.numel(), cfgw.data_ptr(),
              nf.data_ptr(), bctx3.data_ptr(), bctx3.shape[1], nat.data_ptr(),
              out.data_ptr(), L, out.shape[2], int(cap_steps), nb_bctx, log_alpha)
    return st


# ---------------------------------------------------------------- launches


def _planes(d: dict, ncells_max: int, out):
    """New zeroed (L, 3, ncells_max, 64) planes unless `out` is given; the
    kernels write cell k of a lane at row k, so every lane's cells must fit
    (checked here, on the host's copy of the counts)."""
    if max(d["ncells_all"]) > ncells_max:
        raise ValueError(f"lanes of {max(d['ncells_all'])} cells, planes of {ncells_max}")
    if out is None:
        out = torch.zeros((d["L"], 3, ncells_max, 64), dtype=torch.float32,
                          device=d["words"].device)
    return out


def launch_hf(d: dict, ncells_max: int, cap_steps: int | None = None, init=None,
              out=None, walk=None, stats_out=None):
    """One B4 walk over the tensors of a packed input (`to_device`), at most
    `cap_steps` symbols per lane (default the format's hard bound, so every
    lane ends in this launch), from `init` (default the packed start) into
    `out` (default new zeroed planes).  Returns (out, snapshot) without
    waiting for the device.  `walk` is `hf_walk` by default, which also
    takes the packed section lengths and `stats_out`; a card run passes
    `hf_walk_ref` to run the plain version on the same tensors."""
    out = _planes(d, ncells_max, out)
    cap = hard_bound(d["ncells_all"]) if cap_steps is None else cap_steps
    kw = {}
    if walk in (None, hf_walk):
        kw = dict(nbits=d.get("nbits"), stats_out=stats_out)
    st = (walk or hf_walk)(d["words"], d["init"] if init is None else init, d["nc"],
                           d["lut"], d["lane"], d["nat"], out, cap, d["use_prefix"],
                           d["prefix_width"], **kw)
    return out, st


def launch_hf_ctx(d: dict, ncells_max: int, nb_bctx: int, cap_steps: int | None = None,
                  init=None, out=None, walk=None):
    """One B5 walk, as `launch_hf` (`walk`: `hf_ctx_walk` or its plain
    version)."""
    out = _planes(d, ncells_max, out)
    cap = hard_bound(d["ncells_all"]) if cap_steps is None else cap_steps
    st = (walk or hf_ctx_walk)(d["words"], d["init"] if init is None else init, d["nc"],
                               d["ab"], d["cmap"], d["cfgw"], d["nf"], d["bctx3"],
                               d["nat"], out, cap, nb_bctx, d["log_alpha"])
    return out, st


def lane_state(st, L: int, done_row: int) -> dict:
    """The per-lane results of a snapshot, fetched to the host (one small
    copy): ans_state (uint32), bitpos, err and done."""
    s = st[:, :L].cpu().numpy()
    return {"ans_state": s[0].view(np.uint32).copy(), "bitpos": s[1].copy(),
            "err": s[6].copy(), "done": s[done_row].copy()}


def _resume(launch, d, ncells_max, cap_steps, done_row, **kw):
    """Launch, then resume from the snapshot until every lane is done or
    the hard bound is spent (one snapshot fetch per launch)."""
    hard = hard_bound(d["ncells_all"])
    cap = hard if cap_steps is None else int(cap_steps)
    out, st = launch(d, ncells_max, cap_steps=cap, **kw)
    spent = cap
    state = lane_state(st, d["L"], done_row)
    while not state["done"].all() and spent < hard:
        out, st = launch(d, ncells_max, cap_steps=cap, init=st, out=out, **kw)
        spent += cap
        state = lane_state(st, d["L"], done_row)
    return out, state


def decode_hf_dct8(streams, ncells, spec, orders_yxb, ncells_max: int,
                   cap_steps: int | None = None, device=None):
    """Decode <= 128 DCT8-only pass-group sections sharing one single-cluster
    coefficient spec on the device (B4).  streams: [(bytes, bit_offset)] per
    lane; ncells: 8x8 cells per lane; orders_yxb: (3, 64) coefficient order
    per YXB channel.  `cap_steps` caps each launch (default: the hard bound,
    one launch); capped launches resume from the snapshot.  Returns (coeffs
    (L, 3, ncells_max, 64) float32 tensor in natural positions, state dict
    {ans_state, bitpos, err, done})."""
    d = to_device(build_multi_inputs([(streams, list(ncells), spec, orders_yxb)]),
                  K.resolve_device(device))
    return _resume(launch_hf, d, ncells_max, cap_steps, DONE_ROW)


def decode_hf_ctx(streams, ncells, spec, orders_yxb, bctx3, gw8s, ctxoffs,
                  nb_bctx: int, ncells_max: int, cap_steps: int | None = None,
                  device=None):
    """Decode <= 128 DCT8 pass-group sections of one multi-cluster ANS spec on
    the device, context model included (B5); as `decode_hf_dct8`."""
    d = to_device(build_ctx_inputs(streams, ncells, spec, bctx3, gw8s, ctxoffs,
                                   orders_yxb), K.resolve_device(device))
    return _resume(launch_hf_ctx, d, ncells_max, cap_steps, CTX_DONE_ROW,
                   nb_bctx=nb_bctx)
