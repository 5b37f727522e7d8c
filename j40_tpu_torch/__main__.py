"""Command-line decoder, the `dj40` analog (reference dj40.c).

Usage:
  python -m j40_tpu_torch input.jxl [output.png] [--backend torch|device|numpy]
         [--device DEVICE] [--workers N] [--filters] [--all-frames]
         [--info] [--time] [--stats] [--profile DIR]

Decodes to PNG (or prints image info when no output is given); --info
prints header metadata without decoding pixels.  For animated
inputs the final composited frame is written; `--all-frames` writes every
displayed frame as `output-NNN.png` (or an animated PNG if the name ends in
`.apng`).  The decode runs on the CUDA device unless `--device cpu` asks
for the plain PyTorch versions; without a CUDA device it stops.
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    from .decode import BACKENDS

    ap = argparse.ArgumentParser(prog="j40_tpu_torch", description=__doc__)
    ap.add_argument("input")
    ap.add_argument("output", nargs="?")
    # port: the port's backends (decode.BACKENDS); no "auto" or "jax"
    ap.add_argument("--backend", default="torch", choices=list(BACKENDS))
    # port: the counterpart of JAX_PLATFORMS; unset means CUDA
    ap.add_argument("--device", help="torch device of the decode (default: CUDA; "
                    "`cpu` runs the plain PyTorch versions)")
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--filters", action="store_true",
                    help="apply gaborish/EPF restoration filters")
    ap.add_argument("--all-frames", action="store_true",
                    help="write every displayed animation frame")
    ap.add_argument("--info", action="store_true",
                    help="print header info without decoding pixels")
    ap.add_argument("--time", action="store_true", help="print decode time")
    ap.add_argument("--stats", action="store_true", help="print stage timings")
    # port: torch.profiler in place of jax.profiler.trace
    ap.add_argument("--profile", metavar="DIR",
                    help="write a torch.profiler trace (*.pt.trace.json) of the decode")
    args = ap.parse_args(argv)

    from .decode import Decoder
    from .errors import J40Error

    try:
        data = open(args.input, "rb").read()
    except OSError as e:
        print(f"Error: cannot open `{args.input}`: {e}", file=sys.stderr)
        return 1

    if args.info:
        try:
            dec = Decoder(data, backend="numpy")
        except J40Error as e:
            print(f"Error: cannot parse `{args.input}`: {e}", file=sys.stderr)
            return 1
        im = dec.image
        kind = "bare codestream" if dec.src.is_bare else "container"
        print(f"JPEG XL {kind}, {dec.src.available()} codestream bytes")
        depth = f"{im.bpp}-bit int" if not im.exp_bits else (
            f"{im.bpp}-bit float (exp {im.exp_bits})")
        print(f"  image: {im.width}x{im.height}, {depth}, "
              f"orientation {im.orientation.name}")
        print(f"  color: {'XYB' if im.xyb_encoded else im.cspace.name}, "
              f"intensity target {im.intensity_target:g} nits"
              + (", ICC profile "
                 + (f"({len(im.icc)} bytes)" if im.icc else "(present)")
                 if im.want_icc else ""))
        for i, ec in enumerate(im.ec_info):
            print(f"  extra channel {i}: {ec.type.name.lower()}, "
                  f"{ec.bpp}-bit" + (f", name '{ec.name}'" if ec.name else ""))
        if im.anim_tps_num:
            print(f"  animation: {im.anim_tps_num}/{im.anim_tps_denom} tps, "
                  + ("infinite loops" if im.anim_nloops == 0
                     else f"{im.anim_nloops} loops"))
        return 0

    # port: the device is resolved before the decode starts; without CUDA
    # (and without --device cpu) the CLI stops here and writes nothing
    device = None
    if args.backend != "numpy":
        from .ops.kernels import resolve_device

        try:
            device = resolve_device(args.device)
        except (RuntimeError, ValueError) as e:
            print(f"Error: cannot decode `{args.input}`: {e} "
                  f"(--device cpu runs the plain versions)", file=sys.stderr)
            return 1

    import contextlib

    prof: contextlib.AbstractContextManager = contextlib.nullcontext()
    if args.profile:
        from .profile import trace

        prof = trace(args.profile, device)

    from .profile import clock, span, span_lines

    t0 = time.perf_counter()
    try:
        with prof:
            start = clock(cpu=True)
            dec = Decoder(data, backend=args.backend, workers=args.workers,
                          apply_filters=args.filters, device=device)
            with span(dec.stats, "request", start=start, cpu=True, stream=0):
                frames = []  # (duration_ticks, rgba)
                while not dec.done:
                    fr = dec.decode_frame()
                    if args.all_frames and (fr.header.duration > 0 or fr.header.is_last):
                        frames.append((fr.header.duration, dec.render_rgba8()))
                rgba = frames[-1][1] if frames else dec.render_rgba8()
    except J40Error as e:
        print(f"Error: failed to decode `{args.input}`: {e}", file=sys.stderr)
        return 1
    dt = time.perf_counter() - t0

    h, w = rgba.shape[:2]
    nf = max(1, len(frames))
    print(f"{w}x{h} read ({nf} frame{'s'[:nf != 1]}).", file=sys.stderr)
    if args.time:
        print(f"decoded in {dt*1000:.1f} ms ({nf*w*h/dt/1e6:.2f} Mpix/s)",
              file=sys.stderr)
    if args.stats:
        for k, v in dec.stats.items():
            if k != "spans":
                print(f"  {k}: {v:.4f}" if isinstance(v, float) else f"  {k}: {v}",
                      file=sys.stderr)
        print("  spans (name, ms, self ms):", file=sys.stderr)
        for line in span_lines(dec.stats["spans"]):
            print(f"    {line}", file=sys.stderr)

    if args.output:
        # port: PNG through png.py (no Pillow), whatever the file's extension
        from .png import write_apng, write_png

        if args.all_frames and len(frames) > 1:
            im = dec.image
            ms_per_tick = 1000.0 * im.anim_tps_denom / max(im.anim_tps_num, 1)
            if args.output.endswith(".apng"):
                write_apng(args.output, [f for _, f in frames],
                           [max(1, int(d * ms_per_tick)) for d, _ in frames],
                           loops=dec.image.anim_nloops)
            else:
                stem, dot, ext = args.output.rpartition(".")
                for i, (_, f) in enumerate(frames):
                    write_png(f"{stem}-{i:03d}{dot}{ext}", f)
        else:
            write_png(args.output, rgba)
    return 0


if __name__ == "__main__":
    sys.exit(main())
