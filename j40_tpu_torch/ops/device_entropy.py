"""Device-side entropy decode and modular prediction: the host table
packers and the plain PyTorch lockstep decoders and wavefronts.

Counterpart of j40_tpu/ops/device_entropy.py, with the numpy helpers of
j40_tpu/ops/pallas_entropy.py beside it.

- **numpy half**: the dense ANS, prefix and hybrid-int tables, the per-lane
  16-bit word packing of section streams, the bucket-level alias records
  and the prefix/token LUTs, and the eligibility rules (the lane rule
  `spec_is_device_simple`/`spec_is_device_multi` of the modular lanes, the
  stricter `spec_is_pallas_simple` of the HF kernels).
- **torch half** (JAX's XLA code, not Pallas, so plain torch ops that run on
  the tensors' device): the lockstep token decoders `decode_tokens` and
  `decode_tokens_ctx` (the plain version of the token kernel,
  ops/token_kernels.py), the zig-zag unpack, and the wavefront
  reconstructions of the modular predictors — `gradient_reconstruct`,
  `mixed_reconstruct`, `reconstruct_channel`, the self-correcting (WP)
  wavefront `wp_reconstruct(_ovf)` and the in-wavefront MA-tree walk
  `tree_wp_reconstruct`.  The wavefronts dispatch through
  ops/wavefront_kernels.py: CUDA tensors go to the kernels W1-W3
  (csrc/wavefront.cu), CPU tensors to the torch-op loops here
  (`_plain_wavefront`, `_wp_reconstruct`, `_tree_wp_reconstruct`), their
  plain versions.

Bit-exactness: everything is integer and matches j40_tpu (and the host
oracle) bit for bit.  port: `_mul_shr24` is a plain int64 product; the
12-bit limbs were the TPU's spelling of it (the VPU has no 64-bit
multiply).  The WP overflow flag keeps JAX's threshold on the same state
values, so the same lanes return to the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..entropy.ans import DIST_BITS
from ..entropy.code import CodeSpec
from ..profile import upload

#: the most hybrid-int extra bits one symbol may read: the kernels refill
#: their bit buffer to at least 16 renormalization bits plus these
MAX_MIDBITS = 17


def ans_luts(cluster) -> tuple[np.ndarray, np.ndarray]:
    """Dense 4096-entry decode LUTs for one ANS cluster.

    Returns (freq_base, sym): for 12-bit index `i`,
    ``state' = (freq_base[i] >> 12) * (state >> 12) + (freq_base[i] & 0xFFF)``
    and the decoded symbol is ``sym[i]`` (j40.h:2441-2461 flattened)."""
    D, aliases = cluster.D, cluster.aliases
    table_size = len(D)
    log_bucket_size = DIST_BITS - (table_size.bit_length() - 1)
    bucket_mask = (1 << log_bucket_size) - 1
    idx = np.arange(1 << DIST_BITS)
    i = idx >> log_bucket_size
    pos = idx & bucket_mask
    cutoff = np.array([b.cutoff for b in aliases], np.int64)[i]
    bsym = np.array([b.symbol for b in aliases], np.int64)[i]
    boff = np.array([b.offset for b in aliases], np.int64)[i]
    direct = pos < cutoff
    s = np.where(direct, i, bsym)
    base = np.where(direct, pos, boff + pos)
    freq = np.asarray(D, np.int64)[s]
    assert (freq > 0).all(), "zero-frequency bucket reachable"
    # freq <= 4096 needs 13 bits; base < 4096 needs 12
    freq_base = (freq << 12) | base
    assert freq_base.max() < (1 << 31)
    return freq_base.astype(np.int32), s.astype(np.int32)


def hybrid_luts(cfg, alpha_size: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-token hybrid-int LUTs (j40.h:2313-2327 flattened).

    value = (A[tok] << mb[tok]) | (mid << lsb) | lo[tok], where `mid` is
    mb[tok] raw bits from the stream."""
    split = 1 << cfg.split_exp
    bits_in_token = cfg.msb_in_token + cfg.lsb_in_token
    mb = np.zeros(alpha_size, np.int32)
    A = np.zeros(alpha_size, np.int32)
    lo = np.zeros(alpha_size, np.int32)
    for tok in range(alpha_size):
        if tok < split:
            A[tok] = tok
            continue
        midbits = cfg.split_exp - bits_in_token + ((tok - split) >> bits_in_token)
        if midbits < 0 or midbits > MAX_MIDBITS:
            mb[tok] = 0  # unreachable token (host validates via
            A[tok] = 0   # spec_is_device_simple before dispatch)
            continue
        top = 1 << cfg.msb_in_token
        lo[tok] = tok & ((1 << cfg.lsb_in_token) - 1)
        hi = (tok >> cfg.lsb_in_token) & (top - 1)
        mb[tok] = midbits
        A[tok] = (top | hi) << cfg.lsb_in_token
    return mb, A, lo


def pack_streams(streams: list[tuple[bytes, int]]) -> tuple[np.ndarray, np.ndarray]:
    """Pack per-lane byte streams into a (L, W16) uint32 16-bit-word matrix.

    `streams` is (bytes, bit_offset) per lane; returns (words, skip_bits)
    where lane l's reader starts at word 0 with skip_bits[l] pre-consumed
    (the even-byte-aligned base keeps 16-bit word alignment)."""
    L = len(streams)
    skips = np.empty(L, np.int32)
    rows = []
    maxw = 0
    for l, (data, bitoff) in enumerate(streams):
        base = (bitoff // 8) & ~1
        skips[l] = bitoff - base * 8
        payload = data[base:]
        if len(payload) % 2:
            payload = payload + b"\0"
        w = np.frombuffer(payload, np.uint8).reshape(-1, 2)
        words = w[:, 0].astype(np.uint32) | (w[:, 1].astype(np.uint32) << 8)
        rows.append(words)
        maxw = max(maxw, len(words))
    # +16 pad: refills and the per-block hoisted window may read past the
    # stream end once a lane has finished (inactive lanes keep refilling)
    out = np.zeros((L, maxw + 16), np.uint32)
    for l, words in enumerate(rows):
        out[l, : len(words)] = words
    return out, skips


def stream_bits(streams: list[tuple[bytes, int]]) -> np.ndarray:
    """(L,) int32: each lane's section length in bits from the even-byte base
    `pack_streams` starts its words at (port: the sync design's region)."""
    return np.array([8 * (len(data) - ((bitoff // 8) & ~1)) for data, bitoff in streams],
                    np.int32)


def pack_alias_buckets(cluster) -> tuple[np.ndarray, int]:
    """Bucket-level alias records: (2*table_size,) int32 + log_bucket_size.

    Record i (bucket i of the alias map, j40.h:2441-2461):
      W0 = cutoff(13) | (freq_direct & 0xFFF) << 13
      W1 = offset(12) | (freq_alias & 0xFFF) << 12 | alias_symbol << 24
    freq fields use the 0 => 4096 convention.  Decode: slot = state & 0xFFF,
    i = slot >> log_bucket_size, pos = slot & (bucket_size - 1); direct when
    pos < cutoff (symbol = i, base = pos) else symbol = alias_symbol,
    base = offset + pos."""
    D, aliases = cluster.D, cluster.aliases
    table_size = len(D)
    lbs = 12 - (table_size.bit_length() - 1)
    out = np.zeros(2 * table_size, np.int64)
    for i, b in enumerate(aliases):
        assert b.symbol <= 0xFF and 0 <= b.offset < 4096
        assert 0 <= b.cutoff <= 4096
        out[2 * i] = (b.cutoff & 0x1FFF) | ((D[i] & 0xFFF) << 13)
        out[2 * i + 1] = (b.offset | ((D[b.symbol] & 0xFFF) << 12)
                          | (b.symbol << 24))
    assert out.max() < (1 << 31)
    return out.astype(np.int32), lbs


def pack_prefix_lut(code, width: int) -> np.ndarray:
    """(2^width,) int32: len(5) << 16 | sym, indexed by the next `width`
    bits (LSB-first); canonical-prefix LUT per j40.h:2049-2242."""
    lut = np.full(1 << width, -1, np.int64)
    if code.single_symbol is not None:
        lut[:] = code.single_symbol  # length 0
    else:
        assert code.max_len <= width
        for length in range(1, code.max_len + 1):
            step = 1 << length
            for pattern, s in code.by_len[length].items():
                lut[pattern::step] = (length << 16) | s
    assert (lut >= 0).all(), "incomplete prefix code"
    assert lut.max() < (1 << 31)
    return lut.astype(np.int32)


def pack_token_lut(cfg, alpha_size: int) -> np.ndarray:
    """(alpha,) int32: lo(8) << 19 | mb(5) << 14 | A(14); hybrid-int config
    flattened (j40.h:2313-2327)."""
    mb, A, lo = hybrid_luts(cfg, alpha_size)
    assert A.max() < (1 << 14) and lo.max() < (1 << 8) and mb.max() <= 31
    packed = (lo.astype(np.int64) << 19) | (mb.astype(np.int64) << 14) | A
    return packed.astype(np.int32)


def _cluster_is_device_simple(spec: CodeSpec, cl) -> bool:
    cfg = cl.config
    if spec.use_prefix_code:
        if cl.prefix.max_len > 15:
            return False
        if cl.prefix.single_symbol is not None:
            top_token = cl.prefix.single_symbol
        else:
            top_token = max(max(d.values()) for d in cl.prefix.by_len if d)
    else:
        # only tokens with nonzero frequency are decodable
        top_token = max(t for t, f in enumerate(cl.D) if f > 0)
    split = 1 << cfg.split_exp
    if top_token < split:
        return True
    bits_in_token = cfg.msb_in_token + cfg.lsb_in_token
    worst = cfg.split_exp - bits_in_token + ((top_token - split) >> bits_in_token)
    return worst <= MAX_MIDBITS


def spec_is_device_simple(spec: CodeSpec, max_value_bits: int = 17) -> bool:
    """True when the code spec fits the device fast path: one cluster, no
    LZ77, and every reachable token's extra-bit count within the refill
    discipline (MAX_MIDBITS).  The modular lanes' rule (prefix codes up to
    15 bits)."""
    if spec.lz77_enabled or spec.num_clusters != 1:
        return False
    return _cluster_is_device_simple(spec, spec.clusters[0])


def spec_is_device_multi(spec: CodeSpec) -> bool:
    """True when EVERY cluster of the spec fits the device fast path (the
    multi-context lane eligibility: no LZ77, each cluster's reachable
    extra-bit counts within the refill discipline)."""
    if spec.lz77_enabled:
        return False
    return all(_cluster_is_device_simple(spec, cl) for cl in spec.clusters)


def spec_is_pallas_simple(spec: CodeSpec) -> bool:
    """Kernel eligibility of the single-cluster HF walk (B4): single
    cluster, no LZ77, packable LUTs (prefix codes up to 13 bits, 8-bit
    alias symbols, a packable token LUT).  The rule of
    pallas_entropy.spec_is_pallas_simple, under its name."""
    if spec.lz77_enabled or spec.num_clusters != 1:
        return False
    cl = spec.clusters[0]
    cfg = cl.config
    if cfg.msb_in_token + cfg.lsb_in_token > 8:
        return False
    if spec.use_prefix_code:
        if cl.prefix.max_len > 13:
            return False
        if cl.prefix.single_symbol is not None:
            top = cl.prefix.single_symbol
        else:
            top = max(max(d.values()) for d in cl.prefix.by_len if d)
        alpha = top + 1
        if top > 0xFFFF:
            return False
    else:
        _, sym = ans_luts(cl)
        if sym.max() > 0xFF:
            return False
        alpha = int(max(t for t, f in enumerate(cl.D) if f > 0)) + 1
    split = 1 << cfg.split_exp
    if alpha - 1 >= split:
        bits = cfg.msb_in_token + cfg.lsb_in_token
        worst = cfg.split_exp - bits + ((alpha - 1 - split) >> bits)
        if worst > MAX_MIDBITS:
            return False
    try:
        pack_token_lut(cfg, alpha)
    except AssertionError:
        return False
    return True


# ---------------------------------------------------------------- symbol scan


def _long(x, device) -> torch.Tensor:
    """int64 tensor of `x` (a tensor or array-like; numpy uint32 included)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int64)
    return upload(np.asarray(x).astype(np.int64), device)


def decode_tokens(words, skip_bits, nsym, sym_lut, fb_lut, mb_lut, a_lut,
                  lo_lut, lsb, n_steps: int, use_prefix: bool, rows=None):
    """Decode `n_steps` hybrid-int values per lane in lockstep (one cluster
    per lane): `decode_tokens_ctx` with every token in cluster 0.

    words (L, W16) 16-bit stream words (uint32 numpy, or an int16/int32
    tensor), skip_bits (L,), nsym (L,); sym_lut ANS (R, 4096) symbols or
    prefix (R, 2^k) len<<16|sym; fb_lut ANS (R, 4096) freq<<12|base (prefix:
    (R, 1), unused); mb/a/lo_lut (R, alpha) hybrid-int tables; lsb (R,).
    Returns (values (L, n_steps) int32, final ANS state (L,) int32 bit
    pattern, final bit position (L,) int32 from the lane's even-byte base)."""
    lsb = _long(lsb, words.device if isinstance(words, torch.Tensor) else "cpu")
    return decode_tokens_ctx(words, skip_bits, nsym, None, sym_lut, fb_lut,
                             mb_lut, a_lut, lo_lut, lsb[:, None],
                             n_steps=n_steps, use_prefix=use_prefix, rows=rows)


def decode_tokens_ctx(words, skip_bits, nsym, cids, sym_lut, fb_lut, mb_lut,
                      a_lut, lo_lut, lsb, n_steps: int, use_prefix: bool,
                      rows=None):
    """Multi-context lockstep decode: each token's symbol and hybrid-int
    tables are selected by a per-token cluster id (the MA-tree context
    walk, precomputed on the host for static-property trees).  The
    per-cluster blocks are flattened along axis 1 (sym_lut (R, C*S), fb_lut
    (R, C*F), mb/a/lo_lut (R, C*amax), lsb (R, C)); cids (L, >= n_steps)
    int32, or None for cluster 0 throughout.

    Table row r of lane l is rows[l] (None: row l), so lanes that share a
    spec can share one copy.  One step per symbol over all lanes, with
    masks: lanes stop consuming once their `nsym` is reached.  This is the
    plain version of the token kernel (ops/token_kernels.py); it runs on
    the tensors' device.  port: it runs exactly `n_steps` steps (JAX's scan
    rounds up to its unroll of 4, which moves the finals only of lanes
    capped below their `nsym`)."""
    dev = words.device if isinstance(words, torch.Tensor) else torch.device("cpu")
    w = _long(words, dev) & 0xFFFF
    L = w.shape[0]
    tabs = [_long(t, dev) for t in (sym_lut, fb_lut, mb_lut, a_lut, lo_lut, lsb)]
    if rows is not None:
        r = _long(rows, dev)
        tabs = [t[r] for t in tabs]
    sym, fb, mb_t, a_t, lo_t, lsb_t = tabs
    C = lsb_t.shape[1]
    S, F, amax = sym.shape[1] // C, fb.shape[1] // C, mb_t.shape[1] // C
    ns = _long(nsym, dev)
    cid_t = None if cids is None else _long(cids, dev)
    lanes = torch.arange(L, device=dev)
    # every word's 48-bit window, once: a step then reads its bits with one
    # gather (zeros past the end of the words, as the host reader pads)
    wp = torch.nn.functional.pad(w, (0, 3))
    win48 = wp[:, :-2] | (wp[:, 1:-1] << 16) | (wp[:, 2:] << 32)
    last = win48.shape[1] - 1

    def window(bitpos):
        at = (bitpos >> 4).clamp(max=last)[:, None]
        return win48.gather(1, at)[:, 0] >> (bitpos & 15)

    bitpos = _long(skip_bits, dev)
    state = torch.zeros(L, dtype=torch.int64, device=dev)
    if not use_prefix:  # init: state = u(16) | u(16) << 16 (j40.h:2446)
        state = window(bitpos) & 0xFFFFFFFF
        bitpos = bitpos + 32
    vals = torch.zeros((L, n_steps), dtype=torch.int32, device=dev)
    steps = min(n_steps, int(ns.max()) if L else 0)  # later steps change nothing
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    for t in range(steps):
        active = t < ns
        cid = zero if cid_t is None else cid_t[:, t]
        win = window(bitpos)
        if use_prefix:
            e = sym[lanes, cid * S + (win & (S - 1))]
            tok = e & 0xFFFF
            consumed = torch.where(active, e >> 16, 0)
        else:
            idx = state & 0xFFF
            f = fb[lanes, cid * F + idx]
            tok = sym[lanes, cid * S + idx]
            nstate = (f >> 12) * (state >> 12) + (f & 0xFFF)
            renorm = active & (nstate < (1 << 16))
            nstate = torch.where(renorm, (nstate << 16) | (win & 0xFFFF), nstate)
            consumed = torch.where(renorm, 16, 0)
            state = torch.where(active, nstate, state)
        tok = torch.where(active, tok, 0)
        h = cid * amax + tok
        mb = torch.where(active, mb_t[lanes, h], 0)
        mid = (win >> consumed) & ((1 << mb) - 1)
        value = (a_t[lanes, h] << mb) | (mid << lsb_t[lanes, cid]) | lo_t[lanes, h]
        vals[:, t] = torch.where(active, value, 0).to(torch.int32)
        bitpos = bitpos + torch.where(active, consumed + mb, 0)
    st = torch.where(state >= (1 << 31), state - (1 << 32), state)
    return vals, st.to(torch.int32), bitpos.to(torch.int32)


def unpack_signed_dev(u):
    """Zig-zag decode (j40.h:610-615): 0,1,2,3 -> 0,-1,1,-2."""
    half = u >> 1
    return torch.where((u & 1) == 1, -half - 1, half)


# ------------------------------------------------------- wavefront prediction


def _skew(res, height: int, diags: int, k: int):
    """(L, H, D) with [:, y, d] = res[:, y, d - k*y], clamped into the row
    (junk outside, masked in the wavefront)."""
    L, H, W = res.shape
    y = torch.arange(H, device=res.device)[:, None]
    idx = (torch.arange(diags, device=res.device)[None, :] - k * y).clamp(0, W - 1)
    return res.gather(2, idx.expand(L, H, diags))


def _unskew(cols, width: int, k: int):
    """(L, H, W) planes from the (D, L, H) diagonals: val[:, y, x] =
    cols[k*y + x][:, y]."""
    D, L, H = cols.shape
    dev = cols.device
    idx = k * torch.arange(H, device=dev)[:, None] + torch.arange(width, device=dev)
    return cols.permute(1, 2, 0).gather(2, idx.expand(L, H, width))


def _up(c):
    """Row y reads row y-1 (a zero row in from the top); (L, H, ...)."""
    return torch.cat([torch.zeros_like(c[:, :1]), c[:, :-1]], dim=1)


def _diag_x(height: int, diags: int, k: int, device):
    """(D, H) x = d - k*y of every diagonal's slots, and the row index."""
    y = torch.arange(height, device=device)
    return torch.arange(diags, device=device)[:, None] - k * y[None, :], y


def _grad(w_, n_, nw):
    return torch.clamp(w_ + n_ - nw, torch.minimum(w_, n_), torch.maximum(w_, n_))


def _plain_wavefront(res, pcode, height: int, width: int):
    """The y+x anti-diagonal wavefront of predictors 0/1/2/5: diagonal d
    is a pure function of diagonals d-1 and d-2 (j40.h:4221-4227).  `pcode`
    (L, H, W) per-pixel predictor codes, or None for the gradient alone."""
    L = res.shape[0]
    H, W = height, width
    D = H + W - 1
    resk = _skew(res, H, D, 1)
    pck = None if pcode is None else _skew(pcode, H, D, 1)
    X, y = _diag_x(H, D, 1, res.device)
    valid_all, has_w_all = (X >= 0) & (X < W), X > 0
    has_n = y > 0
    col1 = col2 = res.new_zeros((L, H))
    cols = res.new_empty((D, L, H))
    for d in range(D):
        has_w = has_w_all[d]
        col1_up, col2_up = _up(col1), _up(col2)
        w_ = torch.where(has_w, col1, torch.where(has_n, col1_up, 0))
        n_ = torch.where(has_n, col1_up, w_)
        nw = torch.where(has_w & has_n, col2_up, w_)
        pred = _grad(w_, n_, nw)
        if pck is not None:
            pcd = pck[:, :, d]
            pred = torch.where(pcd == 0, 0, torch.where(
                pcd == 1, w_, torch.where(pcd == 2, n_, pred)))
        newcol = torch.where(valid_all[d], pred + resk[:, :, d], 0)
        cols[d] = newcol
        col1, col2 = newcol, col1
    return _unskew(cols, W, 1)


def gradient_reconstruct(res, height: int, width: int):
    """Reconstruct (L, H, W) planes for the gradient predictor (#5) via an
    anti-diagonal wavefront: kernel W1 on CUDA tensors, `_plain_wavefront`
    on CPU ones (ops/wavefront_kernels.py).

    Matches modular.decode's edge-substitution chain exactly: w_ falls back
    to N at x=0 (to 0 at the origin), n_ falls back to w_, nw to w_."""
    from .wavefront_kernels import plain_wavefront

    return plain_wavefront(res, None, height, width)


def mixed_reconstruct(res, pcode, height: int, width: int):
    """Reconstruct (L, H, W) planes with a PER-PIXEL predictor code
    (0=zero, 1=W, 2=N, 5=clamped gradient) via the same anti-diagonal
    wavefront as `gradient_reconstruct` (host analog decode.py::_predict).
    Predictor 1 reads w_ (which falls back to N at x=0, 0 at the origin)
    and predictor 2 reads n_ (fallback w_).  Kernel W1 on CUDA tensors."""
    from .wavefront_kernels import plain_wavefront

    return plain_wavefront(res, pcode, height, width)


def reconstruct_channel(res, predictor: int, height: int, width: int):
    """Per-predictor reconstruction of (L, H, W) residuals (device)."""
    if predictor == 0:
        return res
    if predictor == 5:
        return gradient_reconstruct(res, height, width)
    if predictor == 1:  # W chain; x=0 chains to the row above (edge chain)
        out = res.clone()
        out[:, :, 0] = torch.cumsum(res[:, :, 0], dim=1, dtype=res.dtype)
        return torch.cumsum(out, dim=2, dtype=res.dtype)
    if predictor == 2:  # N chain; y=0 chains to the left (edge chain)
        out = res.clone()
        out[:, 0, :] = torch.cumsum(res[:, 0, :], dim=1, dtype=res.dtype)
        return torch.cumsum(out, dim=1, dtype=res.dtype)
    raise ValueError(f"device path does not support predictor {predictor}")


# --------------------------------------------- self-correcting (WP) wavefront


def _ilog2(n):
    """floor(log2(n)) for int32 n >= 1, branchless binary search (the device
    analog of io.bits.floor_lg)."""
    v = n
    r = torch.zeros_like(n)
    for s in (16, 8, 4, 2, 1):
        big = v >= (1 << s)
        v = torch.where(big, v >> s, v)
        r = r + torch.where(big, s, 0)
    return r


def _mul_shr24(a, b):
    """floor((a * b) / 2^24) of int32 tensors, as int32: the reference's
    int64 blend (j40.h:4094-4096).  port: a plain int64 product, where JAX
    spells it in 12-bit limbs (exact for |a| < 2^30, the envelope the
    overflow flag keeps lanes inside)."""
    return ((a.long() * b.long()) >> 24).to(torch.int32)


def _trunc_half_sum_dev(a, b):
    """C-style (a+b)/2 truncating toward zero (decode.py::_trunc_half_sum)."""
    s = a + b
    return torch.where(s >= 0, s >> 1, -((-s) >> 1))


def _wp_wavefront(res, height: int, width: int, params, choose):
    """The d = 2y + x WP wavefront shared by `_wp_reconstruct` and
    `_tree_wp_reconstruct`.  Per diagonal it forms the neighbours, the
    error neighbourhoods, the four sub-predictions and their error-weighted
    blend (modular/wp.py), then asks `choose(nb, d)` for the sample values
    before masking (nb: the step's (L, H) neighbour and WP values).
    Returns (values (L, H, W), overflow flag (L,))."""
    from ..modular.wp import DIV24

    L = res.shape[0]
    H, W = height, width
    D = 2 * H + W - 2  # diagonals d = 2y + x
    dev = res.device
    i32 = torch.int32
    resk = _skew(res, H, D, 2)
    X, y = _diag_x(H, D, 2, dev)
    VALID, HAS_W = (X >= 0) & (X < W), X > 0
    HAS_NE, X_GT1 = (y > 0) & (X + 1 < W), X > 1
    NE_IN = X + 1 < W
    has_n, has_nn = y > 0, y > 1
    yrow = y.to(i32)
    div24 = torch.tensor(DIV24, dtype=i32, device=dev)
    wpar = torch.tensor(params.w, dtype=i32, device=dev)
    p1, p2, p3 = params.p1, params.p2, params.p3

    zc = res.new_zeros((L, H))
    ze = res.new_zeros((L, H, 4))
    v1 = v2 = v3 = v4 = t1 = t2 = t3 = zc
    ea1 = ea2 = ea3 = ze
    ovf = torch.zeros(L, dtype=torch.bool, device=dev)
    cols = res.new_empty((D, L, H))
    for d in range(D):
        valid, has_w, has_ne, x_gt1 = VALID[d], HAS_W[d], HAS_NE[d], X_GT1[d]
        has_wn = has_w & has_n
        # pixel neighbours with the decode.py:340-347 substitution chain
        v2u = _up(v2)
        pw = torch.where(has_w, v1, torch.where(has_n, v2u, 0))
        pn = torch.where(has_n, v2u, pw)
        pnw = torch.where(has_wn, _up(v3), pw)
        pne = torch.where(has_ne, _up(v1), pn)
        pnn = torch.where(has_nn, _up(_up(v4)), pn)
        pww = torch.where(x_gt1, v2, pw)

        # per-sub-predictor error neighbourhoods (wp.py:55-70)
        errw = torch.where(has_w[:, None], ea1, 0)
        errn = torch.where(has_n[:, None], _up(ea2), 0)
        errnw = torch.where(has_wn[:, None], _up(ea3), errn)
        errne = torch.where(has_ne[:, None], _up(ea1), errn)
        errww = torch.where(x_gt1[:, None], ea2, 0)
        errw2 = torch.where(NE_IN[d][:, None], 0, errw)  # j40.h:4037 edge
        tew = torch.where(has_w, t1, 0)
        ten = torch.where(has_n, _up(t2), 0)
        tenw = torch.where(has_wn, _up(t3), ten)
        tene = torch.where(has_ne, _up(t1), ten)

        # sub-predictions (wp.py:72-89), int32-exact for int16 samples
        preds = torch.stack([
            (pw + pne - pn) * 8,
            pn * 8 - (((tew + ten + tene) * p1) >> 5),
            pw * 8 - (((tew + ten + tenw) * p2) >> 5),
            pn * 8 - ((tenw * p3[0] + ten * p3[1] + tene * p3[2]
                       + (pnn - pn) * 8 * p3[3] + (pnw - pw) * 8 * p3[4]) >> 5),
        ], dim=-1)

        # error-weighted blend (wp.py:91-103); the table indices stay in
        # range on every lane the overflow flag keeps
        errsum = errn + errw + errnw + errww + errne + errw2
        shift = torch.clamp_min(_ilog2(errsum + 1) - 5, 0)
        wk = 4 + ((wpar * div24[(errsum >> shift).clamp(0, 63)]) >> shift)
        logw = _ilog2(wk.sum(-1, dtype=i32)) - 4
        wk = wk >> logw[..., None]
        wsum = wk.sum(-1, dtype=i32)
        s = (preds * wk).sum(-1, dtype=i32)
        pred4 = _mul_shr24(s + (wsum >> 1) - 1, div24[(wsum - 1).clamp(0, 63)])
        agree = ((ten ^ tew) | (ten ^ tenw)) <= 0  # clamp rule (wp.py:104-107)
        lo = torch.minimum(torch.minimum(pw, pn), pne) * 8
        hi = torch.maximum(torch.maximum(pw, pn), pne) * 8
        pred4 = torch.where(agree, torch.clamp(pred4, lo, hi), pred4)

        nb = dict(pw=pw, pn=pn, pnw=pnw, pne=pne, pnn=pnn, pww=pww,
                  tew=tew, ten=ten, tenw=tenw, tene=tene, x=X[d].to(i32),
                  yrow=yrow, has_w=has_w, x_gt1=x_gt1, v4=v4,
                  wppred=(pred4 + 3) >> 3, resd=resk[:, :, d])
        val = torch.where(valid, choose(nb, d), 0)

        # after_predict (wp.py:109-115); state kept zero at invalid slots
        v8 = val * 8
        ea_new = torch.where(valid[:, None], (torch.abs(preds - v8[..., None]) + 3) >> 3, 0)
        te_new = torch.where(valid, pred4 - v8, 0)
        # overflow sentinel (JAX's _mul_shr24 envelope): a lane whose error
        # state reaches 2^24 is flagged, and the caller re-decodes it on
        # the host path
        risky = valid[:, None] & ((torch.abs(ea_new) >= (1 << 24))
                                  | (torch.abs(te_new)[..., None] >= (1 << 24)))
        ovf = ovf | risky.any(dim=2).any(dim=1)
        cols[d] = val
        v4, v3, v2, v1 = v3, v2, v1, val
        ea3, ea2, ea1 = ea2, ea1, ea_new
        t3, t2, t1 = t2, t1, te_new
    return _unskew(cols, W, 2), ovf


def _branches(nb):
    """(13, L, H) the predictions of codes 0-12 (decode.py:426-457; 13 needs
    NEE, on the same diagonal, and never reaches the wavefront)."""
    pw, pn, pnw, pne, pww = nb["pw"], nb["pn"], nb["pnw"], nb["pne"], nb["pww"]
    sel = torch.where(torch.abs(pn - pnw) < torch.abs(pw - pnw), pw, pn)
    return torch.stack(torch.broadcast_tensors(
        torch.zeros_like(pw), pw, pn, _trunc_half_sum_dev(pw, pn), sel,
        _grad(pw, pn, pnw), nb["wppred"], pne, pnw, pww,
        _trunc_half_sum_dev(pw, pnw), _trunc_half_sum_dev(pn, pnw),
        _trunc_half_sum_dev(pn, pne)))


def _select(br, pcd):
    """br[pcd] per slot, 0 where the code is outside 0-12."""
    got = br.gather(0, pcd.clamp(0, 12).long()[None])[0]
    return torch.where((pcd >= 0) & (pcd < 13), got, 0)


def _wp_reconstruct(res, pcode, height: int, width: int, params,
                    has_pcode: bool):
    pck = _skew(pcode, height, 2 * height + width - 2, 2) if has_pcode else None

    def choose(nb, d):
        if pck is None:
            return nb["resd"] + nb["wppred"]
        return nb["resd"] + _select(_branches(nb), pck[:, :, d])

    return _wp_wavefront(res, height, width, params, choose)


def wp_reconstruct(res, pcode, height: int, width: int, params):
    """Reconstruct (L, H, W) planes whose MA tree uses the self-correcting
    (weighted) predictor, bit-exactly.

    The WP recurrence reads the NE neighbour's value AND error (wp.py:58,69),
    which sits on the same y+x anti-diagonal, so the gradient wavefront's
    skew does not order it; skewing by d = 2y + x does: every dependency
    (W, N, NW, NE, NN, WW) lands on diagonals d-1..d-4.  `pcode` is an (L,
    H, W) int32 per-pixel predictor plane (None = all WP): under this skew
    every predictor except 13 is orderable, so multi-leaf WP trees run with
    per-pixel selects.  `params` is the WPParams of the modular
    sub-header.  Kernel W2 on CUDA tensors (ops/wavefront_kernels.py)."""
    return wp_reconstruct_ovf(res, pcode, height, width, params)[0]


def wp_reconstruct_ovf(res, pcode, height: int, width: int, params):
    """Like wp_reconstruct but also returns the per-lane overflow-risk
    flag (True = this lane's error state left the exactness envelope;
    re-decode it on the host)."""
    from .wavefront_kernels import wp_wavefront

    return wp_wavefront(res, pcode, height, width, params)


def _tree_depth(tree_key) -> int:
    """Longest root -> leaf chain of a flattened tree (at least 1)."""
    def depth(i):
        if tree_key[i][0] < 0:
            return 0
        return 1 + max(depth(tree_key[i][2]), depth(tree_key[i][3]))

    return max(1, depth(0))


def _tree_wp_reconstruct(res, height: int, width: int, params, tree_key,
                         cidx: int, sidx):
    """WP wavefront with the MA-TREE WALK evaluated per pixel in-step.

    For NEIGHBOR-PROPERTY trees (j40.h:4177-4218, properties 4-15) whose
    code spec is single-cluster: the token sequence is context-free
    (decoded separately) and only the per-pixel (predictor, offset,
    multiplier) selection needs the neighbour state, which the d = 2y + x
    wavefront already carries.  Per diagonal, every pixel walks the
    flattened tree at once: property values are tensor math over the
    neighbour columns (property 15 = the magnitude-max true error), node
    transitions are small-table gathers.

    ``tree_key`` is a tuple of (prop, value, left, right, predictor, offset,
    multiplier) per node (leaves carry prop = -1); ``cidx`` the slot's
    channel index; ``sidx`` the per-lane stream index (L,).  ``res`` is the
    RAW unpack_signed token plane: multiplier/offset apply per leaf here.
    Returns (values (L, H, W), overflow flag (L,))."""
    dev = res.device
    prop_t, value_t, left_t, right_t, pred_t, off_t, mult_t = (
        torch.tensor(col, dtype=torch.int64, device=dev) for col in zip(*tree_key))
    depth = _tree_depth(tree_key)
    sidx_col = _long(sidx, dev).to(torch.int32)[:, None]  # (L, 1)
    L, H = res.shape[0], height

    def choose(nb, d):
        pw, pn, pnw, pne, pnn, pww = (nb[k] for k in ("pw", "pn", "pnw", "pne", "pnn", "pww"))
        x = nb["x"]
        # NWW = (y-1, x-2): diagonal d-4, one row up
        pnww = torch.where(nb["x_gt1"] & (nb["yrow"] > 0), _up(nb["v4"]), pww)
        # property 15: magnitude-max true error, W-first tie rule
        # (modular/wp.py max_error_property)
        v15 = nb["tew"]
        for cand in (nb["ten"], nb["tenw"], nb["tene"]):
            v15 = torch.where(torch.abs(v15) < torch.abs(cand), cand, v15)
        props = torch.stack(torch.broadcast_tensors(
            torch.full((L, H), cidx, dtype=torch.int32, device=dev), sidx_col,
            nb["yrow"], x, torch.abs(pn), torch.abs(pw), pn, pw,
            torch.where(nb["has_w"], pw - (pww + pnw - pnww), pw),
            pw + pn - pnw, pw - pnw, pnw - pn, pn - pne, pn - pnn, pw - pww, v15))
        # in-step MA tree walk (j40.h:4177-4218; host oracle
        # modular/decode.py:355-401): val > node.value -> left
        node = torch.zeros((L, H), dtype=torch.int64, device=dev)
        for _ in range(depth):
            p = prop_t[node]
            v = props.gather(0, p.clamp(min=0)[None])[0]
            nxt = torch.where(v > value_t[node], left_t[node], right_t[node])
            node = torch.where(p < 0, node, nxt)
        pred = _select(_branches(nb), pred_t[node])
        return (nb["resd"] * mult_t[node] + off_t[node] + pred).to(res.dtype)

    return _wp_wavefront(res, height, width, params, choose)


def tree_wp_reconstruct(res, tree_key, cidx, sidx, height: int,
                        width: int, params):
    """Public wrapper of _tree_wp_reconstruct (see its docstring): kernel W3
    on CUDA tensors, the plain version on CPU ones
    (ops/wavefront_kernels.py).  `cidx` is one channel index for every
    plane or one a plane (L,), so that a call takes several channels."""
    from .wavefront_kernels import tree_wavefront

    return tree_wavefront(res, tree_key, cidx, sidx, height, width, params)
