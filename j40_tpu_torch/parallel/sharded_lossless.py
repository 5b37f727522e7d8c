"""Mesh-sharded lossless Modular decode: inverse transforms as device compute.

Counterpart of j40_tpu/parallel/sharded_lossless.py.  The host side
scatters TOC sections to threads exactly as the single-device decoder does
(per-section isolation, j40.h:7752-7776) and stops *before* the
frame-level inverse transforms; the transform chain — Squeeze merges,
inverse RCT, clamp+pack render — then runs as int32 tensor ops over a
device mesh (BASELINE config-2 shape: cjxl -e3 lossless = MA tree + RCT +
Squeeze; the reference stubs Squeeze at j40.h:4518, so parity is gated on
the spec oracle `modular.transforms`).

Sharding: each unsqueeze step is sequential along its merge axis
(SmoothTendency reads the previously reconstructed neighbour, spec H.6.1)
but independent across the other axis.  A horizontal step therefore runs
on row shards, a vertical step on column shards, each merge of a shard one
launch of kernel S1 (ops/squeeze_kernels.unsqueeze, csrc/squeeze.cu; its
plain version, the loop over column pairs, on CPU tensors).  j40_tpu flips
the sharded axis between steps with `with_sharding_constraint` (an
all-to-all); here each step splits its two planes over the mesh's devices
along the independent axis and gathers the merged plane back (an explicit
gather and re-split).  The inverse RCT and the render are PyTorch ops, as
they are XLA elementwise code in j40_tpu; the render runs on row shards.

All arithmetic is int32, bit-identical to the numpy oracle for any stream
whose samples fit 16 bits (wide streams raise Unsupported, as in j40_tpu).
"""

from __future__ import annotations

import numpy as np
import torch

from ..errors import Unsupported, check
from ..modular.transforms import RCT_PERMUTATIONS, TR_RCT, TR_SQUEEZE
from ..ops.squeeze_kernels import unsqueeze


def _split(x: torch.Tensor, dim: int, devices: list) -> list:
    """`x` cut into len(devices) shards along `dim`, each on its device."""
    return [p.to(d, non_blocking=True)
            for p, d in zip(torch.tensor_split(x, len(devices), dim=dim), devices)]


def _gather(parts: list, dim: int, device) -> torch.Tensor:
    return torch.cat([p.to(device) for p in parts], dim=dim)


def _walk(transforms, chans: list, merge, rct) -> list:
    """The inverse-transform steps over the channel list `chans`, in order:
    a Squeeze step sets each of its channels to merge(channel, residual,
    horizontal) and drops the residuals, an RCT step calls rct(chans,
    begin_c, rct_type).  Returns `chans`."""
    for t in transforms:
        if t[0] == "sq":
            _, begin_c, num_c, offset, horizontal = t
            for k in range(num_c):
                chans[begin_c + k] = merge(chans[begin_c + k], chans[offset + k], horizontal)
            del chans[offset : offset + num_c]
        else:
            rct(chans, *t[1:])
    return chans


def _device_finish_fn(transforms, meta, devices, bpp):
    """The transform+render program for one stream geometry, over the
    shard devices `devices` (the mesh's sharded axis).

    `transforms` is a list of ("sq", begin_c, num_c, offset, horizontal) /
    ("rct", begin_c, rct_type) steps in inverse application order; `meta`
    is a render descriptor: ncolor, alpha channel index (or None),
    do_ycbcr, and the output depth (8 or 16).  The program takes the int32
    channel planes on devices[0] and returns (H, W, 4) int32 there."""
    ncolor = meta["ncolor"]
    alpha_idx = meta["alpha_idx"]
    ycbcr = meta["ycbcr"]
    depth = meta["depth"]
    home = devices[0]

    def merge(down, residu, horizontal):
        # horizontal merges on row shards, vertical on column shards
        ax = 0 if horizontal else 1
        return _gather([unsqueeze(a, b, horizontal) for a, b in
                        zip(_split(down, ax, devices), _split(residu, ax, devices))],
                       ax, home)

    def rct(chans, b, rct_type):
        p0, p1, p2 = chans[b], chans[b + 1], chans[b + 2]
        tt = rct_type % 7
        if tt == 1:
            p2 = p2 + p0
        elif tt == 2:
            p2 = p1 + p0
        elif tt == 3:
            p1 = p1 + p0
            p2 = p2 + p0
        elif tt == 4:
            p1 = p1 + ((p0 + p2) >> 1)
        elif tt == 5:
            p1 = p1 + p0 + (p2 >> 1)
            p2 = p2 + p0
        elif tt == 6:  # YCgCo
            tmp = p0 - (p2 >> 1)
            np1 = p2 + tmp
            np2 = tmp - (p1 >> 1)
            p0, p1, p2 = np2 + p1, np1, np2
        perm = RCT_PERMUTATIONS[rct_type // 7]
        out = [None] * 3
        for i, pl in enumerate((p0, p1, p2)):
            out[perm[i]] = pl
        chans[b], chans[b + 1], chans[b + 2] = out

    def run(*planes):
        chans = _walk(transforms, list(planes), merge, rct)
        # clamp + interleave render (j40.h:7910-7962), on row shards
        maxp = (1 << bpp) - 1
        omax = (1 << depth) - 1
        half = 1 << (bpp - 1)

        def to_depth(p):
            # host _render scale-to-depth semantics (decode.py::_render)
            if bpp == depth:
                return p.clamp(0, omax)
            return torch.div(p.clamp(0, maxp) * omax + half, maxp, rounding_mode="floor")

        h, w = chans[min(1, ncolor - 1)].shape

        def up(p):
            # chroma possibly 2x subsampled: upsample by replication
            if p.shape[0] != h:
                p = p.repeat_interleave(2, 0)[:h]
            if p.shape[1] != w:
                p = p.repeat_interleave(2, 1)[:, :w]
            return p

        def render(rows: list) -> torch.Tensor:
            if ycbcr:
                # full-range BT.601 with the libjxl +128/255 luma offset;
                # channels are (Cb, Y, Cr) centred.  Matches the host render
                # within 1 gray level (device f32 vs host f64 rounding).
                inv = 1.0 / maxp
                cb = rows[0].to(torch.float32) * inv
                y = rows[1].to(torch.float32) * inv + 128.0 / 255.0
                cr = rows[2].to(torch.float32) * inv
                rgbf = [(y + 1.402 * cr) * omax,
                        (y - 0.344136 * cb - 0.714136 * cr) * omax,
                        (y + 1.772 * cb) * omax]
                rgb = [torch.round(p).clamp(0, omax).to(torch.int32) for p in rgbf]
            else:
                rgb = [to_depth(rows[min(i, ncolor - 1)]) for i in range(3)]
            a = (torch.full_like(rgb[0], omax) if alpha_idx is None
                 else to_depth(rows[3]))
            return torch.stack(rgb + [a], dim=-1)

        planes = [up(chans[i]) for i in range(3)] if ycbcr else \
            [chans[min(i, ncolor - 1)] for i in range(3)]
        if alpha_idx is not None:
            planes.append(chans[alpha_idx])
        shards = zip(*(_split(p, 0, devices) for p in planes))
        return _gather([render(list(s)) for s in shards], 0, home)

    return run


def _host_sections(data: bytes, workers: int):
    """The host half of a sharded lossless decode: the TOC sections decoded
    by `workers` threads, the frame-level transforms left pending.  Returns
    (decoder, frame header, global modular image, the inverse-transform
    steps in application order); raises Unsupported on what the device
    chain does not take."""
    from ..decode import Decoder

    d = Decoder(data, backend="numpy", workers=workers)
    d.decode_frame(_defer_finish=True)  # sections done; transforms pending
    f, toc, state = d._deferred
    d._deferred = None
    gm = state.gmodular
    check(f.is_modular and state.vardct is None, "TODO",
          "sharded lossless: modular frames only")
    if d.image.bpp > 14 or gm.wide:
        raise Unsupported(message="sharded lossless: bpp > 14 (int32 margin)")
    # (gab/EPF flags are signaled but only apply to VarDCT sample frames)
    if f.log_upsampling:
        raise Unsupported(message="sharded lossless: upsampled frames")

    steps = []
    for tr in reversed(gm.transforms):
        if tr.id == TR_SQUEEZE:
            steps.append(("sq", tr.begin_c, tr.num_c, tr.offset,
                          bool(tr.horizontal)))
        elif tr.id == TR_RCT:
            steps.append(("rct", tr.begin_c, int(tr.rct_type)))
        else:
            raise Unsupported(
                message="sharded lossless: palette transform (host path)")
    for c in gm.channels:
        if c.empty:
            raise Unsupported(message="sharded lossless: empty channel")

    return d, f, gm, steps


def squeeze_merges(data: bytes) -> list[tuple[bool, int, int]]:
    """The Squeeze merges a sharded decode of `data` runs, in order, as
    (horizontal, chains, residual width) each: on n shards a merge launches
    kernel S1 once a shard that holds a chain, min(chains, n) times."""
    _, _, gm, steps = _host_sections(data, 1)
    merges = []

    def merge(shape, rshape, horizontal):
        (h, w), (hr, wr) = shape, rshape
        merges.append((horizontal, h, wr) if horizontal else (horizontal, w, hr))
        return (h, w + wr) if horizontal else (h + hr, w)

    _walk(steps, [(c.height, c.width) for c in gm.channels], merge, lambda *_: None)
    return merges


def decode_sharded_lossless(
    data: bytes,
    mesh=None,
    n_devices: int | None = None,
    owners: int | None = None,
    bit_depth: int = 8,
) -> np.ndarray:
    """Decode a lossless Modular .jxl across a device mesh; (H, W, 4) uint8
    (or uint16 with bit_depth=16, the U16X4 analog of api.output_format).

    Host threads entropy-decode the TOC sections (one owner chunk per mesh
    row); the Squeeze/RCT inverse-transform chain and the render run on the
    mesh's shards.  Bit-exact vs the single-device Decoder (YCbCr frames:
    within 1 gray level — device f32 vs host f64 BT.601).  Without `mesh`,
    the first `n_devices` CUDA devices (parallel/mesh.default_mesh)."""
    from .mesh import axis_devices, default_mesh

    check(bit_depth in (8, 16), "fmt?", "bit_depth must be 8 or 16")
    if mesh is None:
        mesh = default_mesh(n_devices)
    shard_axis = mesh.axis_names[-1]
    devices = axis_devices(mesh, shard_axis)
    n = len(devices)

    d, f, gm, steps = _host_sections(data, owners or n)
    im = d.image
    ncolor = d._ncolor(f)
    alpha_idx = None
    # post-transform channel layout: ncolor color planes then the declared
    # extra channels (gm.channels still holds the pre-transform list here)
    for i, ec in enumerate(im.ec_info):
        if ec.type == 0:  # alpha
            alpha_idx = ncolor + i
            break
    if f.do_ycbcr and ncolor != 3:
        raise Unsupported(message="sharded lossless: ycbcr needs 3 channels")
    meta = {"ncolor": ncolor, "alpha_idx": alpha_idx,
            "ycbcr": bool(f.do_ycbcr), "depth": bit_depth}
    run = _device_finish_fn(tuple(steps), meta, devices, im.bpp)
    planes = [torch.from_numpy(np.ascontiguousarray(c.data, dtype=np.int32)).to(devices[0])
              for c in gm.channels]
    out = run(*planes).cpu().numpy()
    H, W = im.height, im.width
    return out[:H, :W].astype(np.uint8 if bit_depth == 8 else np.uint16)
