"""On-chip token decode of the modular device lanes: the CUDA kernel's
wrapper, its plain PyTorch version and the lane packer.

Counterpart of j40_tpu/ops/pallas_entropy.py's wrapper half (as
ops/hf_kernels.py is of pallas_hf.py); the kernel is in csrc/tokens.cu.
Each lane is one pass-group section (an isolated entropy stream, j40.h:447,
7749-7776): `nsym` hybrid-int values, the final rANS state and the final
bit position, which the caller checks against the section's end.

| wrapper              | plain version     | TPU kernel replaced |
| decode_tokens_device | decode_tokens_ref | pallas_entropy._make_kernel (B6), and the lax.scan decoders device_entropy.decode_tokens / decode_tokens_ctx |

One kernel covers B6's shared spec (every lane on one table row), per-lane
specs (one row each: sections with local trees) and per-token clusters
(`cids`: static-property MA trees).  Its inputs are those of the plain
version, device_entropy.decode_tokens_ctx, j40_tpu's lockstep decoder
ported: the dense tables of `ans_luts`/`pack_prefix_lut`/`hybrid_luts`,
per table row.  port: a prefix row is as wide as the longest code of the batch
(JAX's is always 2^15) and the hybrid-int tables as long as the largest
reachable token, so that one lane's row fits in shared memory.
"""

from __future__ import annotations

import numpy as np
import torch

from ..profile import scalar
from . import kernels as K
from .device_entropy import (
    ans_luts,
    decode_tokens_ctx,
    hybrid_luts,
    pack_prefix_lut,
    pack_streams,
    stream_bits,
)

#: the plain version of `decode_tokens_device`: j40_tpu's lockstep decoder
decode_tokens_ref = decode_tokens_ctx


def _top_token(spec, cl) -> int:
    """The largest token the cluster can decode (eligibility made every
    such token's extra bits fit: device_entropy.spec_is_device_simple)."""
    if spec.use_prefix_code:
        if cl.prefix.single_symbol is not None:
            return cl.prefix.single_symbol
        return max(max(d.values()) for d in cl.prefix.by_len if d)
    return (1 << spec.log_alpha_size) - 1


def build_lane_inputs(streams, nsym, specs, cids=None) -> dict:
    """Pack lanes for one token launch (port: the counterpart of
    pallas_entropy.build_lane_inputs).

    streams: [(bytes, bit_offset)] per lane; nsym: symbols per lane; specs:
    each lane's CodeSpec (lanes whose spec is the same object share one
    table row); cids: per lane an int array of the cluster of each token
    (static-property trees), or None when every lane decodes from its
    spec's cluster 0.  All specs must agree on use_prefix.  Returns numpy
    arrays words (L, W) uint16, skips (L,), nbits (L,) (the section lengths
    in bits, `stream_bits`), nsym (L,), rows (L,), the
    tables sym (R, C*S), fb (R, C*F), mb/a/lo (R, C*amax), lsb (R, C),
    cids (L, n_steps) or None; and use_prefix, n_steps."""
    L = len(streams)
    use_prefix = specs[0].use_prefix_code
    assert all(s.use_prefix_code == use_prefix for s in specs)
    uniq: dict[int, int] = {}
    row_specs = []
    rows = np.empty(L, np.int32)
    for li, spec in enumerate(specs):
        if id(spec) not in uniq:
            uniq[id(spec)] = len(row_specs)
            row_specs.append(spec)
        rows[li] = uniq[id(spec)]
    used = [s.clusters if cids is not None else s.clusters[:1] for s in row_specs]
    C = max(len(u) for u in used)
    amax = max(_top_token(s, cl) for s, u in zip(row_specs, used) for cl in u) + 1
    if use_prefix:
        width = max(max(1, cl.prefix.max_len) for u in used for cl in u)
        S, F = 1 << width, 1
    else:
        S = F = 4096
    R = len(row_specs)
    sym = np.zeros((R, C, S), np.int32)
    fb = np.zeros((R, C, F), np.int32)
    hyb = np.zeros((3, R, C, amax), np.int32)
    lsb = np.zeros((R, C), np.int32)
    for r, u in enumerate(used):
        for c, cl in enumerate(u):
            if use_prefix:
                sym[r, c] = pack_prefix_lut(cl.prefix, width)
            else:
                fb[r, c], sym[r, c] = ans_luts(cl)
            hyb[:, r, c] = hybrid_luts(cl.config, amax)
            lsb[r, c] = cl.config.lsb_in_token
    words, skips = pack_streams(streams)
    nsym = np.asarray(nsym, np.int32)
    n_steps = int(nsym.max())
    cid = None
    if cids is not None:
        cid = np.zeros((L, n_steps), np.int32)
        for li, c in enumerate(cids):
            cid[li, : len(c)] = c
    flat = lambda a: a.reshape(R, -1)
    return dict(words=words.astype(np.uint16), skips=skips, nbits=stream_bits(streams),
                nsym=nsym, rows=rows,
                sym=flat(sym), fb=flat(fb), mb=flat(hyb[0]), a=flat(hyb[1]),
                lo=flat(hyb[2]), lsb=lsb, cids=cid, use_prefix=use_prefix,
                n_steps=n_steps)


def _check_inputs(words, skip_bits, nsym, cids, sym, fb, mb, a, lo, lsb, rows,
                  n_steps: int, use_prefix: bool) -> tuple[int, int, int, int]:
    """Raise on what the kernel does not take; returns (C, S, F, amax)."""
    if words.dim() != 2 or lsb.dim() != 2:
        raise ValueError(f"words {tuple(words.shape)}, lsb {tuple(lsb.shape)}: want 2-D")
    L, (R, C) = words.shape[0], lsb.shape
    K._check("words", words, tuple(words.shape), torch.int16)
    for name, t in (("skip_bits", skip_bits), ("nsym", nsym), ("rows", rows)):
        K._check(name, t, (L,), torch.int32)
    K._check("lsb", lsb, (R, C), torch.int32)
    for name, t in (("sym", sym), ("fb", fb), ("mb", mb), ("a", a), ("lo", lo)):
        K._check(name, t, (R, t.shape[-1]), torch.int32)
        if t.shape[1] % C:
            raise ValueError(f"{name}: {t.shape[1]} entries for {C} clusters")
    S, F, amax = sym.shape[1] // C, fb.shape[1] // C, mb.shape[1] // C
    if a.shape[1] != C * amax or lo.shape[1] != C * amax:
        raise ValueError("mb, a and lo differ in length")
    if use_prefix and (S & (S - 1) or S > 1 << 15):
        raise ValueError(f"prefix rows of {S} entries: want a power of 2 <= 2^15")
    if not use_prefix and (S, F) != (4096, 4096):
        raise ValueError(f"rANS rows of {S}/{F} entries: want 4096")
    if cids is not None:
        K._check("cids", cids, (L, cids.shape[-1]), torch.int32)
        if cids.shape[1] < n_steps:
            raise ValueError(f"cids of {cids.shape[1]} tokens for {n_steps} steps")
    if L == 0 or n_steps < 0:
        raise ValueError(f"{L} lanes, {n_steps} steps")
    # the kernel indexes the tables by these: out of range would read
    # outside them
    for name, t, hi in (("rows", rows, R), ("cids", cids, C)):
        if t is not None and t.numel():
            lo_v, hi_v = (scalar(v) for v in torch.aminmax(t))
            if lo_v < 0 or hi_v >= hi:
                raise ValueError(f"{name} in [{lo_v}, {hi_v}]: want [0, {hi})")
    return C, S, F, amax


def design(use_prefix: bool, has_cids: bool) -> str:
    """The kernel design a launch takes: "sync" (the self-synchronising
    decode, prefix lanes with one cluster each) or "serial" (one thread per
    lane: rANS lanes, per-token clusters)."""
    return "sync" if use_prefix and not has_cids else "serial"


def decode_tokens_device(words, skip_bits, nsym, cids, sym, fb, mb, a, lo, lsb,
                         n_steps: int, use_prefix: bool, rows=None, nbits=None,
                         stats_out=None):
    """Decode up to `n_steps` hybrid-int values per lane (each lane stops at
    its `nsym`): words (L, W) int16 holding uint16 stream words, skip_bits,
    nsym and rows (L,) int32 (None: lane l reads row l), cids (L, >=
    n_steps) int32 or None, the tables (R, ...) int32 as build_lane_inputs
    packs them; decode_tokens_ref's signature, and two optional arguments of
    the kernel: nbits (L,) int32, each lane's section length in bits from
    its even-byte base (the sync design decodes in parallel up to there;
    None: up to the lane's last nonzero word), and stats_out, a dict that
    receives the sync design's statistics (kernels._sync_stats).  Returns
    (values (L, n_steps) int32, final rANS state (L,) int32 bit pattern,
    final bit position (L,) int32 from the lane's even-byte base).  CUDA
    tensors go to the kernel (or raise), CPU tensors to the plain version."""
    if rows is None:
        rows = torch.arange(words.shape[0], dtype=torch.int32, device=words.device)
    C, S, F, amax = _check_inputs(words, skip_bits, nsym, cids, sym, fb, mb, a, lo,
                                  lsb, rows, n_steps, use_prefix)
    if nbits is not None:
        K._check("nbits", nbits, (words.shape[0],), torch.int32)
    ts = [words, skip_bits, nsym, sym, fb, mb, a, lo, lsb, rows]
    if not K._on_cuda(*ts, *(t for t in (cids, nbits) if t is not None)):
        return decode_tokens_ref(words, skip_bits, nsym, cids, sym, fb, mb, a, lo, lsb,
                                 n_steps=n_steps, use_prefix=use_prefix, rows=rows)
    (L, W), R = words.shape, sym.shape[0]
    out = torch.empty((L, n_steps), dtype=torch.int32, device=words.device)
    st = torch.empty((2, L), dtype=torch.int32, device=words.device)
    scratch = K._entropy_scratch("j40tt_tokens_scratch", words.device, L, W, R, C, S,
                                 int(use_prefix), int(cids is not None))
    K._launch("tokens", "j40tt_tokens", words.device, words.data_ptr(), W,
              skip_bits.data_ptr(), nsym.data_ptr(), rows.data_ptr(),
              0 if cids is None else cids.data_ptr(), 0 if cids is None else cids.shape[1],
              sym.data_ptr(), fb.data_ptr(), mb.data_ptr(), a.data_ptr(), lo.data_ptr(),
              lsb.data_ptr(), C, S, F, amax, int(use_prefix), out.data_ptr(), n_steps,
              st.data_ptr(), L, R, scratch.data_ptr(),
              0 if nbits is None else nbits.data_ptr())
    if design(use_prefix, cids is not None) == "sync":
        K._sync_stats(stats_out, scratch, L, W)
    return out, st[0], st[1]


def launch_tokens(d: dict, n_steps: int | None = None, decode=None, stats_out=None):
    """One token launch over the tensors of a packed input
    (`hf_kernels.to_device`),
    at most `n_steps` symbols per lane (default: every lane to its end).
    `decode` is `decode_tokens_device` by default, which also takes the
    packed section lengths and `stats_out`; a card run passes
    `decode_tokens_ref` to run the plain version on the same tensors."""
    kw = {}
    if decode in (None, decode_tokens_device):
        kw = dict(nbits=d.get("nbits"), stats_out=stats_out)
    return (decode or decode_tokens_device)(
        d["words"], d["skips"], d["nsym"], d["cids"], d["sym"], d["fb"], d["mb"],
        d["a"], d["lo"], d["lsb"],
        n_steps=d["n_steps"] if n_steps is None else int(n_steps),
        use_prefix=d["use_prefix"], rows=d["rows"], **kw)
