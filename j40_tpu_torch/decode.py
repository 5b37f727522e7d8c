"""Top-level decode driver (reference call stack: j40.h:8146-8220).

Host-side orchestration: container → headers → TOC → per-section decode.
Each bitstream section is decoded from an independent byte slice
(`j40.h:7752-7776` isolation semantics), which is what the sharded TPU
pipeline exploits; the VarDCT sample reconstruction runs on device
(vardct/state.py → ops/combine.py, PyTorch with hand-written CUDA kernels).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .errors import ShortInput, Unsupported, check
from .headers.frame import FRAME_REGULAR, FrameHeader, read_frame_header, read_toc
from .headers.image import CSpace, read_image_metadata, read_signature
from .headers.icc import read_icc
from .io.bits import BitReader
from .limits import MAIN_LV5, Limits
from .modular.decode import ModularImage
from .native.loader import load_once
from .profile import carry as carry_spans
from .profile import clock, request_id, span
from .streams import carry, own_stream

_POOL = None


def _pool():
    """Shared decode thread pool (spawning one per frame costs ~1ms)."""
    global _POOL
    if _POOL is None:
        import os
        from concurrent.futures import ThreadPoolExecutor

        _POOL = ThreadPoolExecutor(max(4, os.cpu_count() or 4))
    return _POOL


class _FrameProgress:
    """Mid-frame resume state (the reference's coroutine + buffer-checkpoint
    analog, j40.h:8146-8169, at section granularity): parsed header/TOC,
    the live FrameState, and the set of completed sections survive a 'shrt'
    so a retry after push() decodes each section exactly once."""

    __slots__ = (
        "header_bits", "body_bits", "f", "toc", "state", "lf_global_done",
        "hf_global_done", "done_sections", "t0",
    )

    def __init__(self, header_bits: int, t0: tuple[int, int]):
        self.header_bits = header_bits
        self.body_bits = 0  # bit offset just past the TOC (single-size frames)
        self.t0 = t0  # profile.clock() (wall only) at the frame's first call
        self.f = None
        self.toc = None
        self.state = None
        self.lf_global_done = False
        self.hf_global_done = False
        self.done_sections: set[tuple[int, int]] = set()  # (pass_, idx)


@dataclass
class Frame:
    header: FrameHeader
    gmodular: ModularImage
    #: image-sized channel planes after blending onto the canvas (spec §5.3);
    #: for a plain single full frame these alias the gmodular channel data
    canvas: list[np.ndarray] | None = None
    # rendered outputs
    rgba: np.ndarray | None = None  # (h, w, 4) uint8


# port: no "auto" planner — it chose the host plan whenever the native
# library loaded, which hid the device.  "torch" reconstructs on the device
# (CUDA unless the caller names another); "device" also entropy-decodes the
# eligible VarDCT and Modular pass-group sections there
# (ops/device_vardct.py, ops/device_modular.py); "numpy" is the explicit
# host plan.
BACKENDS = ("torch", "device", "numpy")


def check_backend(backend: str) -> None:
    """Refuse a backend the port does not have (port: replaces
    resolve_backend)."""
    if backend not in BACKENDS:
        raise Unsupported(message=f"backend {backend!r}: use one of {BACKENDS}")


class Decoder:
    """Decodes a JPEG XL codestream (Modular and VarDCT frames)."""

    def __init__(self, data: bytes, limits: Limits = MAIN_LV5, backend: str = "torch",
                 apply_filters: bool = False, workers: int = 1,
                 max_passes: int | None = None, render_spot: bool = False,
                 streaming: bool = False, keep_device_output: bool = False,
                 device=None):
        check_backend(backend)
        load_once()  # port: before any thread of this decode asks for it
        self.backend = backend
        #: port: the torch device of the reconstruction; None means CUDA,
        #: and raises where there is none (never a silent CPU run)
        self.device = None
        if backend in ("torch", "device"):
            from .ops.kernels import resolve_device

            self.device = resolve_device(device)
        self.apply_filters = apply_filters
        self.workers = workers
        #: keep per-LF-group device tensors from the torch reconstruction so
        #: render_rgba8_device() can assemble RGBA on the card (serving
        #: pipelines: decoded pixels feed a PyTorch model without an upload
        #: of the host render; each plane is still fetched for the host
        #: canvas, as without this option)
        self.keep_device_output = keep_device_output
        self._device_planes = None  # [(top, left, h, w, dev_u8, ggh, ggw)]
        #: progressive decode: only the first `max_passes` passes of each
        #: frame are decoded (coarser but complete image; the TOC's per-pass
        #: sections make the rest skippable — spec §9.4)
        self.max_passes = max_passes
        #: opt-in spot-colour compositing at render (the reference ignores
        #: spot channels; keeping the default off preserves render parity)
        self.render_spot = render_spot
        #: per-stage wall times and stream facts, filled by decode_frame;
        #: "request" the decode's id, "spans" its span records (profile.py)
        self.stats: dict = {"request": request_id()}
        #: streaming mode: tolerate a truncated container and keep mid-frame
        #: progress across push() (section-granular resume)
        self.streaming = streaming
        # pull-based input: bytes stay the fast path (zero-copy memory
        # source); file paths / handles / custom Sources decode through the
        # incremental box map without materializing the container
        # (j40.h:1190-1388, 1618-1642 analog — see io/source.py)
        from .io.source import (
            CodestreamSource, FileSource, MemorySource, Source,
            make_prefix_reader,
        )

        if isinstance(data, (bytes, bytearray, memoryview)):
            source = MemorySource(data, final=not streaming)
        elif isinstance(data, Source):
            source = data
        else:  # file path or binary handle
            source = FileSource(data)
        self.src = CodestreamSource(source, allow_partial=streaming)
        self.limits = limits
        r = make_prefix_reader(self.src)
        read_signature(r)
        self.image = read_image_metadata(r, limits)
        if self.image.want_icc:
            self.image.icc = read_icc(r)
        self.r = r
        self._prog: _FrameProgress | None = None
        self._deferred: tuple | None = None
        self.frame: Frame | None = None
        #: reference-frame slots for animation blending (spec §5.3; the
        #: reference rejects non-final frames outright, j40.h:5201)
        self.ref_frames: list[list[np.ndarray] | None] = [None] * 4
        self.done = False

    # -- frame decoding ----------------------------------------------------

    def push(self, data: bytes) -> None:
        """Streaming: append file bytes; mid-frame progress is preserved and
        the next decode_frame() resumes at the first incomplete section
        (the reference's buffer checkpoint analog, j40.h:1662).  The box
        walk resumes incrementally — a push is O(new bytes), not a reparse,
        and committed input is released so retained memory stays O(pending
        sections), not O(stream) (j40.h:1706-1715)."""
        self.src.extend(data)
        if self.streaming:
            self._trim_committed()

    def _trim_committed(self) -> None:
        """Release source bytes every remaining decode step is past."""
        prog = self._prog
        if prog is None:
            return
        if prog.toc is None:
            # frame header/TOC not fully parsed: keep from the frame start
            self.src.trim_codestream(prog.header_bits // 8)
            return
        toc = prog.toc
        lw = toc.end_codeoff
        if not prog.lf_global_done:
            lw = min(lw, toc.lf_global_codeoff)
        if not prog.hf_global_done and toc.hf_global_size:
            lw = min(lw, toc.hf_global_codeoff)
        npasses = (prog.f.num_passes if self.max_passes is None
                   else min(self.max_passes, prog.f.num_passes))
        for s in toc.sections:
            if s.pass_ < npasses and (s.pass_, s.idx) not in prog.done_sections:
                lw = min(lw, s.codeoff)
        self.src.trim_codestream(lw)

    def decode_frame(self, _defer_finish: bool = False) -> Frame | None:
        """Decode the next frame.  With `_defer_finish` the entropy/section
        stage runs but reconstruction is deferred: call `finish_frame()` to
        complete (used by the batched device pipeline in parallel.batch,
        which fuses many images' reconstructions into one dispatch)."""
        check(not self.done, "excs", "no more frames in the codestream")
        im = self.image
        r = self.r
        if self._prog is None:
            self._prog = _FrameProgress(r.bits_consumed, clock())
        prog = self._prog
        if prog.f is None:
            # the frame's first call starts the span; a call resumed after a
            # short input ends it
            with span(self.stats, "headers", start=prog.t0) as sp:
                # a previously-interrupted header parse left r mid-way: rewind
                r.seek_bits(prog.header_bits)
                f = read_frame_header(r, im, self.limits)
                if f.type != FRAME_REGULAR:
                    raise Unsupported(message="only regular frames supported")
                toc = read_toc(r, f)
            prog.f, prog.toc = f, toc
            prog.body_bits = r.bits_consumed
            self.stats.update(
                headers_s=sp.seconds,
                frame=f"{f.width}x{f.height}",
                mode="modular" if f.is_modular else "vardct",
                num_groups=f.num_groups,
                num_lf_groups=f.num_lf_groups,
                num_passes=f.num_passes,
                sections=len(toc.sections),
            )
        f, toc = prog.f, prog.toc
        self.stats["codestream_bytes"] = self.src.available()

        with span(self.stats, "sections") as sp:
            state = self._decode_sections(f, toc, prog)
        self.stats["sections_s"] = sp.seconds
        if _defer_finish:
            self._deferred = (f, toc, state)
            return None
        return self._finish_tail(f, toc, state)

    def _decode_sections(self, f: FrameHeader, toc, prog: _FrameProgress):
        """Decode the frame's sections; returns its FrameState."""
        from .frame_state import FrameState

        im = self.image
        r = self.r

        npasses = (
            f.num_passes
            if self.max_passes is None
            else min(self.max_passes, f.num_passes)
        )
        if toc.single_size:
            # one section == the whole frame, decoded inline from the main
            # reader (j40.h:8194-8200). Availability is checked up front so a
            # retry never re-enters partially-decoded state; each attempt
            # gets a fresh FrameState.
            check(toc.end_codeoff <= self.src.available(), "shrt")
            r.seek_bits(prog.body_bits)
            state = FrameState(im, f, self.limits)
            state.backend = self.backend
            state.apply_filters = self.apply_filters
            state.keep_device_output = self.keep_device_output
            state.workers = self.workers
            state.device = self.device  # port
            state.lf_global(r)
            if not f.is_modular:
                state.hf_global(r)
            state.lf_group(r, 0)
            for pass_ in range(f.num_passes):
                state.pass_group(r, pass_, 0)
            r.zero_pad_to_byte()
            codeoff = r.bits_consumed // 8
            check(codeoff == toc.end_codeoff, "shrt" if codeoff < toc.end_codeoff else "excs")
        else:
            if prog.state is None:
                prog.state = FrameState(im, f, self.limits)
                prog.state.backend = self.backend
                prog.state.apply_filters = self.apply_filters
                prog.state.keep_device_output = self.keep_device_output
                prog.state.workers = self.workers
                prog.state.device = self.device  # port
            state = prog.state

            if not prog.lf_global_done:
                state.lf_global(
                    self._section_reader(toc.lf_global_codeoff, toc.lf_global_size)
                )
                prog.lf_global_done = True
            if not prog.hf_global_done:
                if f.is_modular:
                    check(toc.hf_global_size == 0, "excs")
                else:
                    state.hf_global(
                        self._section_reader(toc.hf_global_codeoff, toc.hf_global_size)
                    )
                prog.hf_global_done = True

            def _avail(s):
                return s.codeoff + s.size <= self.src.available()

            done = prog.done_sections
            lf_todo = [
                s for s in toc.sections
                if s.pass_ < 0 and (s.pass_, s.idx) not in done
            ]
            pg_todo = [
                s for s in toc.sections
                if 0 <= s.pass_ < npasses and (s.pass_, s.idx) not in done
            ]
            lf_run = [s for s in lf_todo if _avail(s)]

            def _one_lf_group(s):
                sr = self._section_reader(s.codeoff, s.size)
                state.lf_group(sr, s.idx)
                sr.no_more_bytes()
                done.add((s.pass_, s.idx))

            if self.workers > 1 and len(lf_run) > 1:
                # LF groups are mutually independent (each covers a disjoint
                # 2048x2048 region with its own entropy streams); the lazy
                # dq-matrix/order materialization they trigger is serialized
                # inside VarDCTState (j40.h:7694-7732 analog)
                list(_pool().map(carry(carry_spans(_one_lf_group), self.device), lf_run))
            else:
                for s in lf_run:
                    _one_lf_group(s)

            def _lf_ready(s):
                # a VarDCT pass group needs its LF group's varblock map first
                if f.is_modular:
                    return True
                row, col = divmod(s.idx, f.gcolumns)
                ggidx = (row // 8) * f.ggcolumns + (col // 8)
                return ggidx in state.vardct.lf_groups

            if self.backend == "device" and f.is_modular:
                # the modular device lanes: eligible pass-group sections
                # decode on the card, one lane per section (the token
                # kernel, then the wavefronts as torch ops;
                # ops/device_modular.py); the rest take the host chains
                from .ops.device_modular import try_device_pass_groups

                dev_run = [s for s in pg_todo if _avail(s)]
                for s in try_device_pass_groups(self, state, f, dev_run):
                    done.add((s.pass_, s.idx))
                pg_todo = [
                    s for s in pg_todo if (s.pass_, s.idx) not in done
                ]

            if self.backend == "device" and not f.is_modular:
                # eligible DCT8 pass-group sections upload their raw bytes
                # and entropy-decode on the card (ops/device_vardct.py);
                # the rest take the host chains
                from .ops.device_vardct import try_device_hf_sections

                dev_run = [s for s in pg_todo if _avail(s) and _lf_ready(s)]
                for s in try_device_hf_sections(self, state, f, dev_run):
                    done.add((s.pass_, s.idx))
                pg_todo = [
                    s for s in pg_todo if (s.pass_, s.idx) not in done
                ]

            # Group the runnable pass sections into per-group chains ordered
            # by pass: two passes of the SAME group accumulate (+=) into the
            # same coefficient planes, so they must run on one thread;
            # distinct groups touch disjoint planes/regions (j40.h:7752-7776)
            # and are embarrassingly parallel (the native core releases the
            # GIL). A chain stops at its first unavailable pass so later
            # passes never run before earlier ones.
            chains: dict[int, list] = {}
            for s in pg_todo:
                chains.setdefault(s.idx, []).append(s)
            run_chains = []
            for idx, chain in chains.items():
                chain.sort(key=lambda s: s.pass_)
                run = []
                for s in chain:
                    if not (_avail(s) and _lf_ready(s)):
                        break
                    run.append(s)
                if run:
                    run_chains.append(run)

            # entropy/device pipelining: once every pass section of an LF
            # group's 64 member groups is decoded, its reconstruction is
            # dispatched to the device immediately, overlapping with the
            # remaining host entropy work (consumed later by state.finish())
            pipeline_native = False
            if self.backend in ("numpy", "native") and not self.apply_filters:
                from .vardct.native_combine import native_combine_available

                pipeline_native = native_combine_available()
            pipeline_vardct = (
                not f.is_modular
                and (self.backend in ("torch", "device") or pipeline_native)  # port
                and (f.num_lf_groups > 1 or pipeline_native)
                and npasses == f.num_passes
            )

            def _lf_complete(ggidx: int) -> bool:
                if (-1, ggidx) not in done:  # LF section (varblock map) first
                    return False
                ggrow, ggcol = divmod(ggidx, f.ggcolumns)
                for row in range(ggrow * 8, min((ggrow + 1) * 8, f.grows)):
                    for col in range(ggcol * 8, min((ggcol + 1) * 8, f.gcolumns)):
                        gidx = row * f.gcolumns + col
                        for p in range(npasses):
                            if (p, gidx) not in done:
                                return False
                return True

            def _one_group_chain(chain):
                for s in chain:
                    sr = self._section_reader(s.codeoff, s.size)
                    state.pass_group(sr, s.pass_, s.idx)
                    sr.no_more_bytes()
                    done.add((s.pass_, s.idx))
                if pipeline_vardct:
                    if pipeline_native:
                        # group granularity: once every pass of this 256^2
                        # group is decoded, reconstruct it right here
                        gidx = chain[-1].idx
                        if all((p, gidx) in done for p in range(npasses)):
                            state.vardct.dispatch_pass_group_native(gidx)
                        return
                    row, col = divmod(chain[-1].idx, f.gcolumns)
                    ggidx = (row // 8) * f.ggcolumns + (col // 8)
                    if _lf_complete(ggidx):
                        state.vardct.dispatch_group_async(ggidx)

            if self.workers > 1 and len(run_chains) > 1:
                list(_pool().map(carry(carry_spans(_one_group_chain), self.device),
                                 run_chains))
            else:
                for chain in run_chains:
                    _one_group_chain(chain)

            missing = (len(lf_todo) - len(lf_run)) + sum(
                1 for s in pg_todo if (s.pass_, s.idx) not in done
            )
            if missing:
                raise ShortInput(
                    f"{missing} section(s) await more input "
                    f"({len(done)}/{len(toc.sections)} decoded)"
                )
            check(toc.end_codeoff <= self.src.available(), "shrt")

        return state

    def finish_frame(self) -> Frame:
        """Complete a decode_frame(_defer_finish=True) call."""
        f, toc, state = self._deferred
        self._deferred = None
        return self._finish_tail(f, toc, state)

    def _finish_tail(self, f: FrameHeader, toc, state) -> Frame:
        prog = self._prog
        with span(self.stats, "finish") as sp:
            state.finish()
            if self.keep_device_output:
                self._device_planes = getattr(state.vardct, "device_planes", None) \
                    if state.vardct is not None else None
            if f.log_upsampling or any(f.ec_log_upsampling):
                self._upsample_frame(f, state.gmodular)
        self.stats["reconstruct_s"] = sp.seconds
        self.stats["total_s"] = (sp.end_ns - prog.t0[0]) * 1e-9
        # position the main reader at the next frame's byte boundary and
        # drop its header window (bounded memory over large files)
        self.r.rebase(toc.end_codeoff)
        self._prog = None
        canvas = self._composite(f, state.gmodular)
        if f.is_last:
            self.done = True
        else:
            self.ref_frames[f.save_as_ref] = canvas
        self.frame = Frame(header=f, gmodular=state.gmodular, canvas=canvas)
        return self.frame

    def _upsample_frame(self, f: FrameHeader, gm: ModularImage) -> None:
        """Upsample every decoded channel to display resolution (spec §5.2;
        the reference rejects log_upsampling > 0 at j40.h:5245-5250).  Runs
        after inverse transforms / VarDCT combine and restoration filters,
        before blending — the libjxl pipeline position."""
        from .mathutil import ceil_div
        from .ops.upsample import upsample_channel_int

        ncolor = self._ncolor(f) if f.is_modular else 0
        for i, ch in enumerate(gm.channels):
            if i < ncolor or not f.ec_log_upsampling:
                k = 1 << f.log_upsampling
                up = upsample_channel_int(ch.data, k,
                                          self.image.up_weights.get(k))
                h = ceil_div(f.disp_height, 1 << ch.vshift)
                w = ceil_div(f.disp_width, 1 << ch.hshift)
            else:
                # extra channel: its own factor subsumes the shift
                k = 1 << f.ec_log_upsampling[i - ncolor]
                up = upsample_channel_int(ch.data, k,
                                          self.image.up_weights.get(k))
                h, w = f.disp_height, f.disp_width
                ch.hshift = ch.vshift = 0
            ch.data = up[:h, :w]
            ch.width, ch.height = w, h

    # -- blending (spec §5.3 subset: REPLACE and ADD) ----------------------

    def _ncolor(self, f: FrameHeader | None = None) -> int:
        im = self.image
        if f is None and self.frame is not None:
            f = self.frame.header
        do_ycbcr = bool(f.do_ycbcr) if f is not None else False
        # mirror the gmodular channel rule (j40.h:3630)
        return 1 if (im.cspace is CSpace.GREY and not im.xyb_encoded
                     and not do_ycbcr) else 3

    def _composite(self, f: FrameHeader, gm: ModularImage) -> list[np.ndarray]:
        """Blend the decoded frame onto its source reference canvas.

        The canvas is a list of image-sized planes, one per gmodular channel
        (color + extra channels).  Full-frame REPLACE (the only case the
        reference handles, implicitly) aliases the frame data; cropped or
        blended frames composite over `ref_frames[src_ref_frame]`."""
        from .headers.frame import (
            BLEND_ADD,
            BLEND_BLEND,
            BLEND_MUL,
            BLEND_MUL_ADD,
            BLEND_REPLACE,
        )

        im = self.image
        ncolor = self._ncolor(f)
        # blending operates at display resolution (channels are already
        # upsampled when log_upsampling > 0)
        fw, fh = f.disp_width, f.disp_height
        exact = f.x0 == 0 and f.y0 == 0 and fw == im.width and fh == im.height
        if f.do_ycbcr and f.jpeg_upsampling and not exact:
            raise Unsupported(message="blending of subsampled YCbCr frames")
        # clip the frame rect (origin may be negative) to the image rect
        sx0, sy0 = max(0, -f.x0), max(0, -f.y0)
        dx0, dy0 = max(0, f.x0), max(0, f.y0)
        w = min(fw - sx0, im.width - dx0)
        h = min(fh - sy0, im.height - dy0)

        maxval = float((1 << im.bpp) - 1)

        def _frame_alpha(bi):
            """Normalized frame alpha sub-rect for alpha-weighted modes."""
            aci = ncolor + bi.alpha_chan
            check(aci < gm.num_channels, "blnd",
                  "blend alpha channel out of range")
            a = gm.channels[aci].data[sy0 : sy0 + h, sx0 : sx0 + w]
            a = a.astype(np.float64) / maxval
            return np.clip(a, 0.0, 1.0) if bi.clamp else a

        canvas: list[np.ndarray] = []
        for ci in range(gm.num_channels):
            bi = f.blend_info if ci < ncolor else f.ec_blend_info[ci - ncolor]
            data = gm.channels[ci].data
            if exact and bi.mode == BLEND_REPLACE:
                canvas.append(data)
                continue
            ref = self.ref_frames[bi.src_ref_frame]
            base = (
                ref[ci].copy()
                if ref is not None
                else np.zeros((im.height, im.width), data.dtype)
            )
            if w > 0 and h > 0:
                sub = data[sy0 : sy0 + h, sx0 : sx0 + w]
                dst = base[dy0 : dy0 + h, dx0 : dx0 + w]
                if bi.mode == BLEND_REPLACE:
                    dst[:] = sub
                elif bi.mode == BLEND_ADD:
                    dst += sub
                elif bi.mode == BLEND_BLEND:
                    # non-premultiplied "over" (spec §5.3); float math, rounded
                    fa = _frame_alpha(bi)
                    is_alpha = (
                        ci >= ncolor
                        and im.ec_info[ci - ncolor].type == 0
                        and ci - ncolor == bi.alpha_chan
                    )
                    ca = _canvas_alpha(
                        ref, ncolor, bi.alpha_chan,
                        (dy0, dx0, h, w), maxval, im,
                    )
                    oa = fa + ca * (1.0 - fa)
                    if is_alpha:
                        out = oa * maxval
                    else:
                        with np.errstate(invalid="ignore", divide="ignore"):
                            out = np.where(
                                oa > 0,
                                (sub * fa + dst * ca * (1.0 - fa)) / np.where(oa > 0, oa, 1.0),
                                0.0,
                            )
                    dst[:] = np.round(out).astype(base.dtype)
                elif bi.mode == BLEND_MUL_ADD:
                    fa = _frame_alpha(bi)
                    dst[:] = np.round(sub * fa + dst).astype(base.dtype)
                elif bi.mode == BLEND_MUL:
                    sf = sub.astype(np.float64) / maxval
                    if bi.clamp:
                        sf = np.clip(sf, 0.0, 1.0)
                    dst[:] = np.round(dst * sf).astype(base.dtype)
                else:
                    raise Unsupported(message=f"blend mode {bi.mode}")
            canvas.append(base)
        return canvas

    def _section_reader(self, codeoff: int, size: int) -> BitReader:
        return BitReader(self.src.read(codeoff, size))

    # -- rendering ---------------------------------------------------------

    def render_rgba16(self) -> np.ndarray:
        """Render to (h, w, 4) uint16 RGBA (the reference reserves J40_U16X4
        at j40.h:203 but rejects it; useful with bpp > 8 content)."""
        return self._render(16)

    def render_rgba8(self) -> np.ndarray:
        """Render the decoded frame to (h, w, 4) uint8 RGBA, matching the
        reference's clamp+scale semantics (j40.h:7910-7962)."""
        return self._render(8)

    def render_rgba8_device(self):
        """(h, w, 4) uint8 RGBA as a tensor on the decoder's device.

        Serving fast path: when the frame reconstructed on the device
        (`backend="torch"` or `"device"`, VarDCT, 8bpp, orientation TL, no
        extra channels, full frame, `keep_device_output=True`), the
        per-LF-group u8 planes are assembled into the RGBA canvas on the
        card, so the RGBA is not uploaded from the host; decoded pixels feed
        a PyTorch model directly.  The decode still fetches each plane for
        the host canvas (`vardct/state.py`), so this route saves the upload,
        not the fetch.  Anything else uploads the host render (correct, one
        extra hop).  `stats["device_output"]` records the route taken:
        "planes" or "host_render"."""
        import torch

        from .ops.kernels import resolve_device
        from .vardct.state import _use_u8_planes

        f = self.frame
        assert f is not None, "decode a frame first"
        im = self.image
        planes = self._device_planes
        fh = f.header
        fast = (
            planes
            and _use_u8_planes(im, fh)  # full-frame REPLACE, no crop/blend
            and int(im.orientation) == 1  # TL
            and not im.ec_info
            and fh.width == im.width
            and fh.height == im.height
            and all(dev.dtype == torch.uint8 for *_x, dev, _h, _w in planes)
        )
        if not fast:
            self.stats["device_output"] = "host_render"
            rgba = np.ascontiguousarray(self.render_rgba8())
            return torch.from_numpy(rgba).to(resolve_device(self.device))
        self.stats["device_output"] = "planes"
        out = torch.full((4, im.height, im.width), 255, dtype=torch.uint8,
                         device=planes[0][4].device)
        for top, left, gh, gw, dev, _ggh, _ggw in planes:
            out[:3, top : top + gh, left : left + gw] = dev[:, :gh, :gw]
        return out.permute(1, 2, 0).contiguous()

    def _render(self, depth: int) -> np.ndarray:
        with span(self.stats, "render"):
            return self._render_canvas(depth)

    def _render_canvas(self, depth: int) -> np.ndarray:
        im = self.image
        f = self.frame
        assert f is not None and f.canvas is not None
        canvas = f.canvas
        # bpp < 8 renders with the same scale-to-depth math (the reference
        # rejects it, j40.h:7919 "bpp >= 8"); bilevel/paletted-depth images
        # are legal level-5 streams
        check(im.exp_bits == 0, "TODO", "float samples")
        h, w = canvas[0].shape
        maxpixel = (1 << im.bpp) - 1
        half = 1 << (im.bpp - 1)

        # grayscale modular frames have a single color channel (the reference
        # rejects these; we replicate it across RGB)
        ncolor = self._ncolor()
        planes = [canvas[min(i, ncolor - 1)] for i in range(3)]
        alpha = None
        spots = []  # (ec, plane)
        for i in range(ncolor, len(canvas)):
            ec = im.ec_info[i - ncolor]
            if ec.type == 0 and alpha is None:  # alpha
                alpha = canvas[i]
            elif ec.type == 2:  # spot colour
                spots.append((ec, canvas[i]))

        if spots and self.render_spot and not f.header.do_ycbcr:
            # render spot colours (the reference ignores them): mix the spot
            # RGB over the color planes weighted by solidity x channel value
            # (libjxl-style "over"); values here are integer samples
            planes = [p.astype(np.float64) for p in planes]
            for ec, sp in spots:
                r_, g_, b_, solidity = ec.spot
                mix = np.clip(sp.astype(np.float64) / maxpixel, 0.0, 1.0) * solidity
                for ci, comp in enumerate((r_, g_, b_)):
                    planes[ci] = (comp * maxpixel) * mix + planes[ci] * (1.0 - mix)
            planes = [np.round(p).astype(np.int64) for p in planes]

        if f.header.do_ycbcr:
            # YCbCr frames (the reference parses do_ycbcr but refuses to
            # render, j40.h:7867; and rejects subsampling at j40.h:6749).
            # Channel order is (Cb, Y, Cr) with luma in slot 1, all channels
            # centered; full-range BT.601 with the libjxl +128/255 luma
            # offset.  Subsampled chroma upsamples by sample replication.
            h, w = planes[1].shape  # Y is always full resolution

            def up(p):
                if p.shape[0] != h:
                    p = np.repeat(p, 2, 0)[:h]
                if p.shape[1] != w:
                    p = np.repeat(p, 2, 1)[:, :w]
                return p

            cb = up(planes[0]).astype(np.float64) / maxpixel
            y = planes[1].astype(np.float64) / maxpixel + 128.0 / 255.0
            cr = up(planes[2]).astype(np.float64) / maxpixel
            omax = (1 << depth) - 1
            odt = np.uint8 if depth == 8 else np.uint16
            planes = [
                (y + 1.402 * cr) * omax,
                (y - 0.344136 * cb - 0.714136 * cr) * omax,
                (y + 1.772 * cb) * omax,
            ]
            out = np.empty((h, w, 4), dtype=odt)
            for i in range(3):
                out[:, :, i] = np.clip(np.round(planes[i]), 0, omax).astype(odt)
            if alpha is None:
                out[:, :, 3] = omax
            elif im.bpp == depth:
                out[:, :, 3] = np.clip(alpha, 0, omax).astype(odt)
            else:
                p = np.clip(alpha, 0, maxpixel).astype(np.int64)
                out[:, :, 3] = ((p * omax + half) // maxpixel).astype(odt)
            return apply_orientation(out, int(im.orientation))

        omax = (1 << depth) - 1
        odt = np.uint8 if depth == 8 else np.uint16

        # zero-copy fast path: the native VarDCT reconstruct writes the three
        # color slots of one interleaved RGBA canvas (alpha pre-filled 255);
        # when the planes are exactly those views, the canvas IS the render
        if (
            depth == 8
            and im.bpp == 8
            and alpha is None
            and not spots
            and ncolor == 3
            and isinstance(planes[0].base, np.ndarray)
            and planes[0].base.ndim == 3
            and planes[0].base.shape == (h, w, 4)
            and planes[0].base.dtype == np.uint8
            and all(
                planes[i].base is planes[0].base
                and planes[i].__array_interface__["data"][0]
                == planes[0].base.__array_interface__["data"][0] + i
                for i in range(3)
            )
        ):
            return apply_orientation(planes[0].base, int(im.orientation))

        # calloc-backed: np.empty's malloc + first-touch is pathologically
        # slow on hosts with broken THP fault-in (see j40_tpu/__init__.py)
        out = np.zeros((h, w, 4), dtype=odt)

        # fused native clamp+interleave (one pass over the planes; numpy's
        # per-channel clip/astype/strided-store chain costs ~30 ms/MP)
        if (
            im.bpp <= depth
            and all(p.dtype == np.int32 and p.ndim == 2 for p in planes)
            and (alpha is None or alpha.dtype == np.int32)
        ):
            from .modular.decode import _native_enabled
            from .native.bindings import render_interleave

            if _native_enabled() and render_interleave(
                    planes, alpha, out, depth, im.bpp, self.workers):
                return apply_orientation(out, int(im.orientation))

        def _one(i):
            src = planes[i] if i < 3 else alpha
            if src is None:
                out[:, :, i] = omax
            elif im.bpp == depth:
                if src.dtype == odt:
                    out[:, :, i] = src  # u8 planes are pre-clamped
                else:
                    out[:, :, i] = np.clip(src, 0, omax).astype(odt)
            else:
                p = np.clip(src, 0, maxpixel).astype(np.int64)
                out[:, :, i] = ((p * omax + half) // maxpixel).astype(odt)

        if self.workers > 1:
            # numpy releases the GIL on large array ops; channels are
            # independent writes into disjoint slices
            list(_pool().map(_one, range(4)))
        else:
            for i in range(4):
                _one(i)
        # EXIF-style orientation (the reference parses but never applies it,
        # j40.h:3152; we honor it like libjxl's default un-orientation)
        return apply_orientation(out, int(im.orientation))


def _canvas_alpha(ref, ncolor, alpha_chan, rect, maxval, im):
    """Normalized canvas alpha for the blended rect (1.0 when no reference
    canvas exists is wrong — an empty canvas is transparent, so 0.0)."""
    dy0, dx0, h, w = rect
    if ref is None:
        return np.zeros((h, w), np.float64)
    a = ref[ncolor + alpha_chan][dy0 : dy0 + h, dx0 : dx0 + w]
    return np.clip(a.astype(np.float64) / maxval, 0.0, 1.0)


def apply_orientation(arr: np.ndarray, orientation: int) -> np.ndarray:
    """Transform a stored (h, w, c) image to display orientation (spec Table
    F.2 / EXIF codes 1-8; 5-8 swap the displayed width and height)."""
    if orientation == 2:
        return arr[:, ::-1].copy()
    if orientation == 3:
        return arr[::-1, ::-1].copy()
    if orientation == 4:
        return arr[::-1, :].copy()
    if orientation == 5:  # transpose
        return arr.transpose(1, 0, 2).copy()
    if orientation == 6:  # rotate 90 clockwise
        return arr.transpose(1, 0, 2)[:, ::-1].copy()
    if orientation == 7:  # anti-transpose
        return arr.transpose(1, 0, 2)[::-1, ::-1].copy()
    if orientation == 8:  # rotate 90 counter-clockwise
        return arr.transpose(1, 0, 2)[::-1, :].copy()
    return arr


def _read_input(path_or_bytes) -> bytes:
    if isinstance(path_or_bytes, (bytes, bytearray)):
        return bytes(path_or_bytes)
    return open(path_or_bytes, "rb").read()


def decode_file(path_or_bytes, backend: str = "torch",
                limits: Limits = MAIN_LV5, device=None,
                workers: int = 1, apply_filters: bool = False) -> tuple[Decoder, np.ndarray]:
    """Decode to the final displayed frame (all frames are processed so the
    blending chain is honored; single-frame files behave as before).

    port: `device` (default CUDA), `workers` and `apply_filters` (the
    frame's restoration filters, off by default as in Decoder) pass through
    to Decoder; on a CUDA device the decode runs on the calling thread's own
    stream (streams.own_stream), whose index the `request` span counts."""
    data = _read_input(path_or_bytes)
    start = clock(cpu=True)
    dec = Decoder(data, backend=backend, limits=limits, device=device, workers=workers,
                  apply_filters=apply_filters)
    with own_stream(dec.device) as stream, \
            span(dec.stats, "request", start=start, cpu=True, stream=stream):
        while not dec.done:
            dec.decode_frame()
        rgba = dec.render_rgba8()
    dec.frame.rgba = rgba
    return dec, rgba


def decode_animation(
    path_or_bytes, backend: str = "torch", device=None, apply_filters: bool = False
) -> tuple[Decoder, list[tuple[int, np.ndarray]]]:
    """Decode every displayed frame of an (animated) codestream.

    Returns (decoder, [(duration_ticks, rgba), ...]); frames with duration 0
    that are not last are compositing intermediates and are not emitted
    (spec §5.3).  Tick rate is `decoder.image.anim_tps_num / anim_tps_denom`.
    On a CUDA device the decode runs as decode_file's does; `apply_filters`
    as decode_file's."""
    data = _read_input(path_or_bytes)
    start = clock(cpu=True)
    dec = Decoder(data, backend=backend, device=device, apply_filters=apply_filters)
    frames: list[tuple[int, np.ndarray]] = []
    with own_stream(dec.device) as stream, \
            span(dec.stats, "request", start=start, cpu=True, stream=stream):
        while not dec.done:
            fr = dec.decode_frame()
            if fr.header.duration > 0 or fr.header.is_last:
                frames.append((fr.header.duration, dec.render_rgba8()))
    return dec, frames
