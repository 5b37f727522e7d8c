"""Host-side table packers of the on-chip entropy decoders (numpy only).

Copies of the numpy helpers that j40_tpu keeps in its JAX modules
(ops/device_entropy.py and ops/pallas_entropy.py): the dense ANS and
hybrid-int tables, the per-lane 16-bit word packing of section streams,
the bucket-level alias records and the prefix/token LUTs, and the
eligibility rule of a single-cluster spec.  The HF coefficient kernels
(ops/hf_kernels.py) use them now; the token lanes of the modular device
path (ROADMAP A.8) will add theirs here.
"""

from __future__ import annotations

import numpy as np

from ..entropy.ans import DIST_BITS
from ..entropy.code import CodeSpec

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


def spec_is_device_simple(spec: CodeSpec) -> bool:
    """Kernel eligibility: single cluster, no LZ77, packable LUTs.

    port: pallas_entropy.spec_is_pallas_simple under a name without the
    TPU's kernel language; the rule is the same."""
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
