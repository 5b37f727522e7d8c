"""Device-side VarDCT HF coefficient decode of pass-group sections.

Counterpart of j40_tpu/ops/device_vardct.py: eligible pass-group sections
upload their raw section BYTES and entropy-decode on the card, one section
per lane (ops/hf_kernels.py: B4 for single-cluster specs, B5 with the full
HF context model for multi-cluster ANS specs; per-section stream isolation
per reference j40.h:7749-7776), replacing the host entropy decode and the
coefficient-plane upload.  Eligibility (anything else takes the host path
with identical results):

- single-pass frame, and a coefficient spec that one of the two kernels
  takes (hf_kernels.hf_spec_is_device_simple / spec_is_device_ctx; the
  context model's nonzero ring also bounds the group at 256 pixels)
- every cell of the section is a DCT8 varblock corner (j40.h:6915)

An LF group whose sections all decode here stays on the card: its plane is
gathered from the kernel's output and reconstructed by the same kernel the
torch combine uses (B1), so `backend="device"` gives the same pixels as
`backend="torch"`.  Other lanes write their coefficients back into the host
planes.

Correctness gates mirror the host: per-lane "coef" structure errors, the
final ANS state (j40.h:2884-2891), and section padding/end checks
(j40.h:2011-2016) are all enforced from the kernel's machine snapshot.
port: no fallback hides the card.  The Pallas path's `pallas_available()`
gate, its return to the host for streams too long for VMEM, and its return
to the host when a lane ran out of its step budget are TPU artifacts: here
every launch walks to the format's hard bound, and a lane that is not done
then is a kernel fault, which raises.
"""

from __future__ import annotations

import functools
import time

import numpy as np
import torch

from ..errors import check
from ..io.bits import BitReader, ceil_lg
from ..mathutil import ceil_div
from ..profile import span
from . import hf_kernels as HK
from . import kernels
from .device_modular import _check_lane_end
from .hf_kernels import YXB2XYB


class _HfLane:
    __slots__ = ("section", "data", "bitoff", "gg", "ggidx", "gx8", "gy8",
                 "gw8", "gh8")

    def __init__(self, section, data, bitoff, gg, ggidx, gx8, gy8, gw8, gh8):
        self.section = section
        self.data = data
        self.bitoff = bitoff
        self.gg = gg
        self.ggidx = ggidx
        self.gx8 = gx8
        self.gy8 = gy8
        self.gw8 = gw8
        self.gh8 = gh8


def _prepare_hf_lane(dec, state, f, vd, s, preset_bits):
    row, col = divmod(s.idx, f.gcolumns)
    ggidx = (row // 8) * f.ggcolumns + (col // 8)
    gg = vd.lf_groups.get(ggidx)
    if gg is None or gg.blocks is None:
        return None
    gx8 = ((col % 8) << f.group_size_shift) // 8
    gy8 = ((row % 8) << f.group_size_shift) // 8
    gw8 = ceil_div(min(f.width - (col << f.group_size_shift), f.group_size), 8)
    gh8 = ceil_div(min(f.height - (row << f.group_size_shift), f.group_size), 8)
    rect = gg.blocks[gy8:gy8 + gh8, gx8:gx8 + gw8]
    if rect.shape != (gh8, gw8) or not (rect >> 20 == 2).all():
        return None  # non-DCT8 varblocks -> host path
    data = dec.src.read(s.codeoff, s.size)
    return _HfLane(s, data, preset_bits, gg, ggidx, gx8, gy8, gw8, gh8)


def hf_lanes(dec, state, f, sections):
    """The eligible lanes of `sections`: (spec, ctx_mode, lanes, orders_yxb),
    or None when the frame or its coefficient spec is not eligible or no
    section is."""
    if not sections or f.num_passes != 1:
        return None
    vd = state.vardct
    if vd is None or not vd.coeff_codespec:
        return None
    spec = vd.coeff_codespec[0]
    simple = HK.hf_spec_is_device_simple(spec)
    ctx_mode = (not simple and HK.spec_is_device_ctx(spec)
                and f.group_size <= 8 * HK.RING_CELLS)
    if not (simple or ctx_mode):
        return None
    if vd.orders is None or vd.orders[0][0][0] is None:
        return None
    preset_bits = ceil_lg(vd.num_hf_presets)
    lanes = [
        ln for s in sections
        if (ln := _prepare_hf_lane(dec, state, f, vd, s, preset_bits))
    ]
    if not lanes:
        return None
    orders_yxb = np.stack([
        np.asarray(vd.orders[0][0][YXB2XYB[cyxb]], np.int32)
        for cyxb in range(3)
    ])
    return spec, ctx_mode, lanes, orders_yxb


def hf_batches(lanes) -> list[list]:
    """Lanes in LF-group-contiguous batches of <= MAX_LANES, so that one LF
    group never splits across launches (a group has <= 64 sections)."""
    by_gg: dict[int, list] = {}
    for ln in lanes:
        by_gg.setdefault(ln.ggidx, []).append(ln)
    batches: list[list] = []
    cur: list = []
    for glanes in by_gg.values():
        if cur and len(cur) + len(glanes) > HK.MAX_LANES:
            batches.append(cur)
            cur = []
        cur.extend(glanes)
    if cur:
        batches.append(cur)
    return batches


def try_device_hf_sections(dec, state, f, sections) -> list:
    """Decode eligible DCT8 pass-group sections on the device; write their
    coefficient planes into the owning LF groups, or reconstruct a fully
    covered LF group on the device; return the handled sections."""
    plan = hf_lanes(dec, state, f, sections)
    if plan is None:
        return []
    spec, ctx_mode, lanes, orders_yxb = plan
    vd = state.vardct

    # device-resident route: when a gg's DCT8 grid is FULLY covered by this
    # dispatch (single pass, so nothing else accumulates into it), the
    # coefficients never come back to the host — the per-gg plane assembles
    # on device and reconstructs with the same fused kernel the torch
    # combine would use, and combine() consumes the predispatched u8 planes.
    resident_ok = not getattr(state, "apply_filters", False)
    cells: dict[int, int] = {}
    for ln in lanes:
        cells[ln.ggidx] = cells.get(ln.ggidx, 0) + ln.gw8 * ln.gh8
    full_cover = {g: n == vd.lf_groups[g].width8 * vd.lf_groups[g].height8
                  for g, n in cells.items()}

    t0 = time.perf_counter()
    out = []
    resident = 0
    for batch in hf_batches(lanes):
        # a batch, from its packing to its last write-back
        with span(None, "vardct.hf", lanes=len(batch)):
            resident += _decode_hf_batch(dec, vd, spec, batch, orders_yxb,
                                         resident_ok, full_cover, ctx_mode)
        out.extend(ln.section for ln in batch)
    stats = dec.stats.setdefault("device_vardct", {})
    stats["lanes"] = stats.get("lanes", 0) + len(lanes)
    stats["kernel"] = "ctx" if ctx_mode else "simple"
    stats["resident_ggs"] = stats.get("resident_ggs", 0) + resident
    stats["hf_s"] = stats.get("hf_s", 0.0) + (time.perf_counter() - t0)
    return out


def _lane_bctx3(vd, ln) -> "np.ndarray":
    """Per-cell YXB block contexts of one DCT8 section, packed 10 bits
    apart (the host half of the device context model: j40.h:6923-6934 —
    qfidx/lfidx/block_ctx_map are LF products, known before HF decode)."""
    gg = ln.gg
    sub = np.asarray(gg.blocks[ln.gy8:ln.gy8 + ln.gh8,
                               ln.gx8:ln.gx8 + ln.gw8])
    voffs = sub & 0xFFFFF
    qf = np.asarray(gg.vb_qfidx)[voffs].astype(np.int64)
    lf = np.asarray(gg.lfindices[ln.gy8:ln.gy8 + ln.gh8,
                                 ln.gx8:ln.gx8 + ln.gw8]).astype(np.int64)
    lfidx_size = 1
    for t in vd.nb_lf_thr:
        lfidx_size *= t + 1
    bctx0 = qf * lfidx_size + lf  # order_idx == 0 for DCT8
    bctxc = 13 * (vd.nb_qf_thr + 1) * lfidx_size
    bmap = np.asarray(vd.block_ctx_map, np.int64)
    b3 = (bmap[bctx0] | (bmap[bctx0 + bctxc] << 10)
          | (bmap[bctx0 + 2 * bctxc] << 20))
    return b3.ravel().astype(np.int32)


def pack_hf_batch(vd, spec, lanes, orders_yxb, ctx_mode: bool, device):
    """One batch's packed kernel inputs on `device`, the launch over them
    (`launch(ncells_max, cap_steps=None, init=None, out=None) -> (coeffs,
    snapshot)`, hf_kernels.launch_hf or launch_hf_ctx) and the snapshot's
    done row."""
    streams = [(ln.data, ln.bitoff) for ln in lanes]
    ncells = [ln.gw8 * ln.gh8 for ln in lanes]
    if not ctx_mode:
        d = HK.to_device(HK.build_multi_inputs(
            [(streams, ncells, spec, orders_yxb)]), device)
        return d, functools.partial(HK.launch_hf, d), HK.DONE_ROW
    bctx3 = [_lane_bctx3(vd, ln) for ln in lanes]
    ctxoffs = []
    for ln in lanes:
        preset = BitReader(ln.data).u(ln.bitoff) if ln.bitoff else 0
        # port: the kernel's cluster map covers the signalled presets
        check(preset < vd.num_hf_presets, "coef", "HF preset out of range")
        ctxoffs.append(495 * vd.nb_block_ctx * preset)
    gw8s = [ln.gw8 for ln in lanes]
    d = HK.to_device(HK.build_ctx_inputs(streams, ncells, spec, bctx3, gw8s,
                                         ctxoffs, orders_yxb), device)
    launch = functools.partial(HK.launch_hf_ctx, d, nb_bctx=vd.nb_block_ctx)
    return d, launch, HK.CTX_DONE_ROW


def _decode_hf_batch(dec, vd, spec, lanes, orders_yxb, resident_ok,
                     full_cover, ctx_mode: bool) -> int:
    """Decode one <=128-lane batch in one kernel call at the format's hard bound;
    returns the number of LF groups kept device-resident.  port: one flow
    for both kernels — launch, dispatch the resident reconstructions, fetch
    the snapshot once, check (the Pallas path's optimistic peek and budget
    resume, `launch_hf_multi_async`/`peek_hf_multi`/`finish_hf_multi`,
    have nothing left to do)."""
    ncells_max = max(ln.gw8 * ln.gh8 for ln in lanes)
    lane_off = {id(ln): li for li, ln in enumerate(lanes)}
    by_gg: dict[int, list] = {}
    for ln in lanes:
        by_gg.setdefault(ln.ggidx, []).append(ln)
    res_ggs = [g for g in by_gg if resident_ok and full_cover.get(g)]

    _, launch, done_row = pack_hf_batch(vd, spec, lanes, orders_yxb, ctx_mode,
                                        dec.device)
    coeffs_dev, st = launch(ncells_max)
    # the reconstructions queue behind the walk, before the snapshot fetch
    for ggidx in res_ggs:
        _reconstruct_resident(vd, ggidx, by_gg[ggidx], lane_off, coeffs_dev)
    state = HK.lane_state(st, len(lanes), done_row)
    if not state["done"].all():
        raise RuntimeError(
            f"HF kernel fault: lanes {np.flatnonzero(state['done'] == 0).tolist()} "
            "not done at the format's hard bound")
    for li, ln in enumerate(lanes):
        check(int(state["err"][li]) == 0, "coef")
        absbits = ((ln.bitoff // 8) & ~1) * 8 + int(state["bitpos"][li])
        # port: the host reports a walk that ran past the section's end as
        # "shrt" before it checks the ANS state (the native core's overrun)
        check(ceil_div(absbits, 8) <= len(ln.data), "shrt")
        _check_lane_end(ln, absbits, spec.use_prefix_code,
                        int(state["ans_state"][li]))

    host_lanes = [ln for g, glanes in by_gg.items() if g not in res_ggs
                  for ln in glanes]
    if host_lanes:
        idx = torch.tensor([lane_off[id(ln)] for ln in host_lanes],
                           device=coeffs_dev.device)
        dense = coeffs_dev[idx].cpu().numpy()  # (n, 3, ncells_max, 64)
        pos64 = np.arange(64)
        for hi, ln in enumerate(host_lanes):
            gg = ln.gg
            sub = gg.blocks[ln.gy8:ln.gy8 + ln.gh8,
                            ln.gx8:ln.gx8 + ln.gw8].ravel()
            offs = gg.vb_coeffoff[sub & 0xFFFFF].astype(np.int64)
            idx = (offs[:, None] + pos64[None, :]).ravel()
            n = ln.gw8 * ln.gh8
            for c in range(3):
                gg.coeffs[c][idx] += dense[hi, c, :n].ravel()
    return len(res_ggs)


def _reconstruct_resident(vd, ggidx, glanes, lane_off, coeffs_dev) -> None:
    """Assemble one fully-device-decoded LF group's (3, n, 64) plane from
    the kernel's dense output and run the fused dequant+CfL+IDCT+XYB
    reconstruction (B1), all on the device; the result enters
    vardct._predispatched under the same contract combine_lf_group_torch_async
    fulfills (same kernel on the same values, so backend="device" output is
    bit-identical to backend="torch")."""
    from .combine import _cached_device, _plan_aux_dct8

    gg = glanes[0].gg
    f, im = vd.fs.f, vd.fs.im
    h8, w8 = gg.height8, gg.width8
    lane_b = np.empty(h8 * w8, np.int64)
    cell_b = np.empty(h8 * w8, np.int64)
    for ln in glanes:
        ys = np.arange(ln.gy8, ln.gy8 + ln.gh8)
        xs = np.arange(ln.gx8, ln.gx8 + ln.gw8)
        bb = (ys[:, None] * w8 + xs[None, :]).ravel()
        lane_b[bb] = lane_off[id(ln)]
        cell_b[bb] = np.arange(ln.gh8 * ln.gw8)
    voffs = (np.asarray(gg.blocks) & 0xFFFFF).reshape(-1)
    offs = np.asarray(gg.vb_coeffoff)[voffs]
    aux, weights, consts22 = _plan_aux_dct8(vd, gg, im, f, voffs, offs)

    dev = coeffs_dev.device
    img = coeffs_dev[torch.from_numpy(lane_b).to(dev), :,
                     torch.from_numpy(cell_b).to(dev), :]
    coeffs = img.permute(1, 0, 2).contiguous()  # (3, n, 64), device-resident
    out = kernels.reconstruct_dct8_srgb(
        coeffs, torch.from_numpy(aux).to(dev),
        _cached_device("w8", np.asarray(weights, np.float32), dev),
        _cached_device("pc22", consts22, dev), h8, w8, im.bpp == 8)
    with vd._dispatch_lock:
        vd._predispatched[ggidx] = (out, gg.height, gg.width)
