"""Per-shard on-device entropy decode of a multi-group Modular stream.

Counterpart of j40_tpu/parallel/sharded_entropy.py.  The TOC scatters each
section's raw BYTES to its owner shard (reference j40.h:5527-5537;
per-section stream isolation j40.h:447, 7749-7776), and each shard
entropy-decodes its own sections' token streams ON ITS DEVICE, one launch
of the token kernel B6 (ops/token_kernels.decode_tokens_device) per shard,
then reconstructs its share of the image planes there (the predictor's
wavefront as torch ops).  No host entropy stage: host work is headers and
the byte scatter.  port: j40_tpu chooses its body with `use_pallas` (the
Pallas kernel on a TPU, the lax.scan decoder on virtual CPU meshes); here
the shard's device chooses, as in every wrapper: the kernel on a CUDA
device, its plain version on the CPU.

Eligibility (ValueError outside it): modular frame, >= 2 groups,
single-leaf gradient/W/N/zero tree, LZ77-free single-cluster spec shared by
every section (a global tree), same-shape 3-channel picks per section —
the fjxl-style streams that are the lossless serving shape.
"""

from __future__ import annotations

import numpy as np

from ..ops import device_modular as DM
from ..ops import token_kernels as TKN
from ..ops.device_entropy import reconstruct_channel, unpack_signed_dev
from ..ops.hf_kernels import to_device


def plan_sections(blob: bytes):
    """Host side: full reference decode (the parity oracle) + per-section
    lane extraction.  Returns (dec, lanes, spec, (gh, gw))."""
    from ..decode import Decoder

    d = Decoder(blob, backend="numpy")
    d.decode_frame(_defer_finish=True)
    f, toc, state = d._deferred
    if not f.is_modular:
        raise ValueError("sharded entropy leg needs a modular frame")
    sections = [s for s in toc.sections if s.pass_ >= 0]
    if len(sections) < 2:
        raise ValueError("needs a multi-group stream")
    lanes = []
    for s in sections:
        ln = DM._prepare_lane(d, state, s)
        if ln is None or ln.ctx is not None or ln.wp is not None:
            raise ValueError("section not single-leaf device-simple")
        lanes.append(ln)
    shapes = {tuple(p[3:] for p in ln.picks) for ln in lanes}
    if len(shapes) != 1 or len(lanes[0].picks) != 3:
        raise ValueError("sections must share one 3-channel shape")
    (gw, gh), = {(p[3], p[4]) for ln in lanes for p in ln.picks}
    if any(ln.spec is not lanes[0].spec for ln in lanes[1:]):
        # per-section LOCAL trees quantize their own histograms: the
        # shared-table shard program needs the global-tree emission
        raise ValueError("sections must share the global code spec")
    return d, lanes, lanes[0].spec, (gh, gw)


def decode_modular_sections_sharded(blob: bytes, mesh, axis: str = "rows"):
    """Decode a multi-group modular stream with PER-SHARD on-device
    entropy decode; returns (planes (S, 3, gh, gw) int32, lanes, reference
    decoder).  Shard k of the mesh's `axis` takes sections [k*per,
    (k+1)*per), per = ceil(S / shards), as j40_tpu's P(axis) split does.
    Every lane must end where its section ends, with the final rANS state
    0x130000 where rANS (device_modular._check_lane_end).  Bit-exact vs
    the host decode (asserted by the caller against ``reference``'s
    gmodular planes)."""
    from .mesh import axis_devices

    dec, lanes, spec, (gh, gw) = plan_sections(blob)
    S = len(lanes)
    devices = axis_devices(mesh, axis)
    per = -(-S // len(devices))
    predictor = lanes[0].leaf.predictor
    mult, offset = lanes[0].leaf.multiplier, lanes[0].leaf.offset

    pending = []
    for k, dev in enumerate(devices):
        mine = lanes[k * per : (k + 1) * per]
        if not mine:
            continue
        d = to_device(DM.pack_lanes(mine), dev)
        vals, fstate, bitpos = TKN.launch_tokens(d)
        res = unpack_signed_dev(vals).reshape(len(mine) * 3, gh, gw)
        # port: the leaf's multiplier and offset, as device_modular applies
        # them (1 and 0 in the encoders' streams, which j40_tpu assumes)
        if mult != 1:
            res = res * mult
        if offset != 0:
            res = res + offset
        rec = reconstruct_channel(res, predictor, gh, gw)
        pending.append((mine, rec.reshape(len(mine), 3, gh, gw), fstate, bitpos))

    planes = np.zeros((S, 3, gh, gw), np.int32)
    use_prefix = spec.use_prefix_code
    at = 0
    for mine, rec, fstate, bitpos in pending:
        planes[at : at + len(mine)] = rec.cpu().numpy()
        fs, bp = fstate.cpu().numpy(), bitpos.cpu().numpy()
        for li, ln in enumerate(mine):
            DM._check_lane_end(ln, ((ln.bitoff // 8) & ~1) * 8 + int(bp[li]), use_prefix,
                               int(fs[li]) & 0xFFFFFFFF)
        at += len(mine)
    return planes, lanes, dec
