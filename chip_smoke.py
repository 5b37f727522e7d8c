#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Needs one CUDA card (Hopper: the kernels build for sm_90a), nvcc and a C++
compiler; imports only j40_tpu_torch, torch and numpy.  Phases, each of
which raises on failure (the script then exits non-zero):

1. card: name and power limit (nvidia-smi), torch/CUDA versions, TF32 flags;
2. build: the CUDA kernels (nvcc) and the native host core (make) from the
   sources in the checkout, in parallel;
3. kernels: each CUDA kernel against its plain PyTorch version on the card,
   on the inputs the main path gives it (the LF groups of the streams
   below), its device time beside its plain version's, a library
   yardstick's and its bound.  The HF entropy kernels (B4, B5) run on the
   full-size lanes of config 4 (prefix code) and of bench.py's two
   2048x2048 HF probe streams (single-cluster ANS; 5 clusters): capped
   against their plain versions, uncapped against the host plan's
   coefficient planes.  The token kernel (B6) runs on the full-size lanes
   of the modular streams below in each table mode (per-lane rows, one
   shared row, per-token clusters, and the e3 tree's prefix lanes): capped
   against its plain version, uncapped to every section's end.  The
   wavefront kernels (W1: gradient and per-pixel codes; W2: WP alone and
   per-pixel codes 0-12; W3: the MA-tree walk) run on the first plane
   batch of the modular streams'
   lanes (16 lanes of 256x256), each equal to its plain version, planes
   and overflow flags, with its diagonal count and time a diagonal.  Each
   entropy row names its design (sync: the self-synchronising decode of
   prefix lanes; serial: one thread per lane; lookahead: B5's decoding
   thread, which forms the next symbol's context for both outcomes of a
   coefficient, and its walking warp), the sync statistics and
   the symbols decoded per second over all lanes.  Then the flat-content
   probes: B6 and B4 on a screenshot-like page, B6 also through its serial
   design on the same lanes (in build/chip_smoke.json, not on the kernels
   line);
4. main path: the BASELINE VarDCT configs 3 (1024x1024, all DCT8) and 4
   (4096x3072 mixed varblocks, custom orders and dequant matrices), made
   from a seed by the port's encoder, decoded by `decode_file(data,
   workers=4)` on the card and held within 1 gray level of the port's host
   plan (`backend="numpy"`); then the restoration-filter path,
   `decode_file(data, workers=4, apply_filters=True)`, on config 12F
   (config 4's image, all DCT8, custom gaborish and 3-step EPF) and on
   config 4, each held against the host plan with the same filters at
   least FILTER_REACH pixels from an LF-group border (the card filters the
   whole frame, the host plan each LF group apart), with the host plan's
   gap at the borders more than 1 level, and against the sharded plan on
   one shard over the whole frame; then the
   whole-plane EPF of a plane whose sides are not multiples of 8
   (`filter_kernels.epf_device`, the single-step kernel); then
   `decode_file(data, backend="device", workers=4)` (the HF entropy of
   the eligible sections on the card) on configs 3 and 4 and the two
   probe streams, each equal to `backend="torch"` and within 1 level of
   the host plan, with every eligible section on the HF kernels; then the
   lossless Modular streams (BASELINE configs 1 and 2, their global-tree
   twins, a static-tree stream, a WP stream, a static tree with WP among
   its leaves; 1024x1024, made from bench.py's seeds) through
   `decode_file(data, backend="device", workers=4)`, each equal bit for
   bit to the host plan, with every section the port's own lane plan takes
   on the token kernel, each class's three slots in one launch of a
   wavefront kernel, and the stream's own wavefront kernel launched.  The kernel
   launch counters, zeroed just before each path and read just after, show
   which kernels each went through;
5. batch serving (j40_tpu_torch/parallel/batch.py) on two corpora of 64
   512x512 images, bench.py's batch64 (all DCT8, prefix codes) and
   photo64 (photo density, rANS): `decode_batch(batch64,
   backend="torch")` (its fused route), `decode_batch_device` on both and
   `decode_batch_device_hf(photo64)`, each equal to the per-image
   `backend="torch"` decodes and within 1 level of the host plan, the HF
   path equal to the pack path, B1 launched once a 16-image chunk and B4
   once a 128-lane call; aggregate Mpix/s beside the host-serve yardstick
   (host decode plus one upload of the RGBA); `render_rgba8_device` on
   configs 3 and 4; then B1 at the chunk shape and B4 on one multi-spec
   call of photo64 as kernel rows;
5b. multi-device (j40_tpu_torch/parallel/sharded_*.py, phase_sharded) on
   meshes that repeat the card, Mesh([cuda:0] * n): config 12F with the
   filters on 8 shards (B2, B9's and B7's rows entries after each halo
   exchange, B3, once a shard and step), equal within 1 level to 1 shard
   and to the single-device filtered decode beyond the filters' reach of
   an LF-group border; config 4 on 4 shards (group-aligned: the mixed
   classes in the shards) and 8 (the overlay) and config 3 on 8, within 1
   level of decode_file; decode_sharded_batch of 16 batch64 images on a
   (2, 4) mesh; a 1024x1024 Squeeze+RCT lossless stream (the Squeeze
   merge kernel S1 once a (merge, shard), the count derived from the
   stream's transforms) and bench.py's shent_1024 (per-shard entropy, B6
   and W1 once a shard), bit-exact with the host plan;
   dryrun_multichip(8) (its lossless leg through S1).  Mpix/s beside the
   single-device decode of the same stream; B9's rows entry and B7's for
   each step kind (12-tap, 4-tap cross, 4-tap plain: each kind's launches
   of the counted decode) on shard 1's stripes of config 12F, B6 on one
   shard's lanes, and S1 on shard 1's widest horizontal and widest
   vertical merge of the lossless stream (its time beside a lone chain's),
   as kernel rows;
6. profile: one warm decode of configs 3, 4 and 12F under torch.profiler
   (device busy time and idle share) and cProfile (host time by function),
   one each of config 4 and hf_ctx_2048 under `backend="device"`, and one
   each of the modular gradient stream and the e3 stream with a global tree
   under `backend="device"`;
7. cli: the command-line decoder, `python -m j40_tpu_torch`, one fresh
   process a run on the streams above, written into build/cli/: config 3
   with --time --stats --profile (the torch.profiler trace must hold
   B1's records) and with --time alone, config 4 with --backend device,
   config 12F with --filters, a small animation with --all-frames to
   APNG, each PNG read back (no Pillow here) and equal to the in-process
   decode, and --info on config 4; each run's wall time and the CLI's own
   "decoded in" line beside phase 4's warm decode of the same stream;
8. example: examples/serve_device_torch.py (a decode into a toy nn.Module
   on the card) as a fresh process, which must exit 0.

The streams are encoded first, in worker processes (one per core).

The last line is {"ok": true, "device": {...}}; the line before it holds
the card's name and power limit; before that one {"kernels": [...]} line.
Details go to build/chip_smoke.json.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

# every profiler session here starts with settle(); SETTLE_KERNEL is its
# sleep kernel, whose record no count takes
from j40_tpu_torch.profile import SETTLE_KERNEL, settle

# published H100 SXM peaks at its full 700 W (NVIDIA data sheet): HBM bytes
# per second and fp32 operations per second outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
REPS = 30  # timed calls per kernel, after warm-up; the median is reported


def _test_image(w: int, h: int, seed: int = 12345) -> np.ndarray:
    """bench.py's _test_image: a smooth random walk, values 20..219."""
    rng = np.random.default_rng(seed)
    img = np.cumsum(np.cumsum(rng.integers(-2, 3, size=(h, w, 3)), 0), 1)
    return (img % 200 + 20).astype(np.uint8)


def config3() -> bytes:
    """BASELINE config 3 (bench.py vd_1mp): 1024x1024, all DCT8."""
    from j40_tpu_torch.encode.vardct_enc import encode_vardct

    return encode_vardct(_test_image(1024, 1024))


def config4() -> bytes:
    """BASELINE config 4 (bench.py vd_12mp): 4096x3072 with flat bands that
    merge into DCT32X32 / DCT16X16 / DCT8X16 / DCT16X8, permuted orders and
    custom dequant matrices."""
    from j40_tpu_torch.encode.vardct_enc import VarDCTOptions, encode_vardct_mixed

    img = _test_image(4096, 3072, seed=777)
    flat = img[10, 10]
    img[:768, :1024] = flat
    img[800:816, 1024:2048] = flat
    img[824:832, 2048:3072] = flat
    for x8 in range(384, 512, 2):
        img[848:864, x8 * 8 : x8 * 8 + 8] = flat
    return encode_vardct_mixed(
        img, options=VarDCTOptions(custom_order=True, custom_dq=True))


def config12f() -> bytes:
    """Config 12F: config 4's 4096x3072 image, all DCT8, with custom
    gaborish weights and the 3-step EPF (12-tap, 4-tap cross, 4-tap plain)
    at sharpness 5, so that EPF filters every block: 4 LF groups."""
    from j40_tpu_torch.encode.vardct_enc import VarDCTOptions, encode_vardct

    return encode_vardct(_test_image(4096, 3072, seed=777), VarDCTOptions(
        sharpness=5, custom_restoration=True, epf_iters=3))


def hf_image(size: int = 2048) -> np.ndarray:
    """bench.py _bench_hf_ctx's photo-density image (seed 7)."""
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    return np.stack([
        (96 + 60 * np.sin(xx / 29) * np.cos(yy / 23)
         + 40 * np.sin((xx + yy) / 71) + 10 * np.sin(xx / (9 + 2 * c))
         + rng.normal(0, 0.7, (size, size)))
        for c in range(3)], -1).clip(0, 255).astype(np.uint8)


def hf_stream(clusters: int) -> bytes:
    """The HF kernels' own probe streams (bench.py _bench_hf_ctx, 2048x2048,
    one LF group, 64 sections): single-cluster ANS (B4's rANS path) or the
    5-cluster spec (B5)."""
    from j40_tpu_torch.encode.vardct_enc import VarDCTOptions, encode_vardct

    opts = dict(coeff_clusters=clusters) if clusters > 1 else {}
    return encode_vardct(hf_image(), VarDCTOptions(use_prefix=False, **opts))


def modular_stream(name: str) -> bytes:
    """The lossless streams of the modular device lanes, 1024x1024 from
    bench.py's image (seed 12345), 256x256 groups: 16 sections of 196,608
    symbols each.

    modular             BASELINE config 1 (bench.py:851-852): local trees,
                        prefix code, gradient predictor
    modular_global      the same with one global tree and code spec
    modular_e3          BASELINE config 2 (bench.py:854-859): local e3 trees
    modular_e3gt        bench.py:1011-1015 exactly: the e3 tree, global, rANS
    modular_static_ctx  the 9-node static tree, rANS, complex cluster map
    modular_wp          the weighted predictor alone (a single-leaf tree,
                        predictor 6): the WP-only mode of kernel W2
    modular_static_wp   the static tree of tests/test_device_modular.py:
                        316-324, WP among its leaves (6, 4, 7, 12): W2's
                        per-pixel codes"""
    from j40_tpu_torch.encode.advanced import AdvancedOptions, encode_modular_advanced
    from j40_tpu_torch.encode.encoder import EncodeOptions, encode_modular
    from j40_tpu_torch.encode.modular_enc import branch, leaf

    img = _test_image(1024, 1024)
    if name in ("modular", "modular_global"):
        return encode_modular(img, options=EncodeOptions(global_tree=name != "modular"))
    # bench.py:854-859's neighbour-property tree (cjxl -e3's shape): the WP
    # max-error property gates WP against the gradient
    e3 = [branch(15, 0, 1, 2), leaf(6), leaf(5)]
    # the 9-node static-property tree of tests/test_device_modular.py:133-143
    static = [branch(0, 0, 1, 2), branch(3, 60, 3, 4), branch(2, 40, 5, 6), leaf(5),
              leaf(1), leaf(2), branch(1, 25, 7, 8), leaf(0), leaf(5, offset=3)]
    tree, kw = {
        "modular_e3": (e3, {}),
        "modular_e3gt": (e3, dict(use_prefix=False, global_tree=True)),
        "modular_static_ctx": (static, dict(use_prefix=False, complex_cluster_map=True)),
        "modular_wp": ([leaf(6)], {}),
        "modular_static_wp": ([branch(0, 0, 1, 2), branch(3, 70, 3, 4), branch(2, 50, 5, 6),
                               leaf(6), leaf(4), leaf(7), leaf(12)], {}),
    }[name]
    return encode_modular_advanced(img, options=AdvancedOptions(tree=tree, **kw))


def lossless_sq_stream() -> bytes:
    """The sharded lossless path's stream: bench.py's 1024x1024 image
    (seed 12345) with Squeeze and the YCgCo RCT
    (AdvancedOptions(squeeze=True, rct_type=6))."""
    from j40_tpu_torch.encode.advanced import AdvancedOptions, encode_modular_advanced

    return encode_modular_advanced(_test_image(1024, 1024),
                                   options=AdvancedOptions(squeeze=True, rct_type=6))


def shent_stream() -> bytes:
    """bench.py's shent_1024 (bench.py:478-484): 1024x1024, global tree,
    rANS, 128-px groups (64 sections of 49,152 symbols)."""
    from j40_tpu_torch.encode.encoder import EncodeOptions, encode_modular

    rng = np.random.default_rng(11)
    img = (np.cumsum(rng.integers(-1, 2, size=(1024, 1024, 3)), axis=1)
           % 180 + 30).astype(np.uint8)
    return encode_modular(img, options=EncodeOptions(global_tree=True, use_prefix=False,
                                                     group_size_shift=7))


def flat_image(size: int = 1024, seed: int = 5) -> np.ndarray:
    """A screenshot-like page: a light background with solid panels, rows of
    text-like dark strokes, and bench.py's image as a photo in one quarter."""
    rng = np.random.default_rng(seed)
    img = np.full((size, size, 3), 245, np.uint8)
    for _ in range(12):
        y, x = rng.integers(0, size - 64, 2)
        h, w = rng.integers(32, 256, 2)
        img[y:y + h, x:x + w] = rng.integers(0, 256, 3)
    for y in range(size // 2 + 8, size - 24, 12):
        for x in rng.integers(16, size - 16, size // 24):
            img[y:y + 8, x:x + rng.integers(2, 6)] = 30
    img[:size // 2, :size // 2] = _test_image(size // 2, size // 2)
    return img


def flat_stream(name: str) -> bytes:
    """The flat-content probes (phase_flat_probes): the screenshot-like page
    as BASELINE config 1 (modular_flat) and as config 3 (vardct_flat)."""
    from j40_tpu_torch.encode.encoder import encode_modular
    from j40_tpu_torch.encode.vardct_enc import encode_vardct

    return (encode_modular if name == "modular_flat" else encode_vardct)(flat_image())


#: every stream of the run, by name; the slowest to encode first
STREAMS = {
    "modular_e3": lambda: modular_stream("modular_e3"),
    "modular_e3gt": lambda: modular_stream("modular_e3gt"),
    "lossless_sq": lossless_sq_stream,
    "config4": config4, "config12f": config12f,
    "modular_static_ctx": lambda: modular_stream("modular_static_ctx"),
    "modular_wp": lambda: modular_stream("modular_wp"),
    "modular_static_wp": lambda: modular_stream("modular_static_wp"),
    "hf_ans_2048": lambda: hf_stream(1), "hf_ctx_2048": lambda: hf_stream(5),
    "config3": config3,
    "modular": lambda: modular_stream("modular"),
    "modular_global": lambda: modular_stream("modular_global"),
    "modular_flat": lambda: flat_stream("modular_flat"),
    "vardct_flat": lambda: flat_stream("vardct_flat"),
    "shent_1024": shent_stream,
}
MODULAR = ("modular", "modular_global", "modular_e3", "modular_e3gt", "modular_static_ctx",
           "modular_wp", "modular_static_wp")
#: the wavefront kernels' launch counters (ops/wavefront_kernels.py), one
#: a kernel instance
WAVEFRONT_COUNTERS = ("wavefront", "wavefront_mixed", "wavefront_wp", "wavefront_wp_codes",
                      "wavefront_tree")


def make_stream(name: str) -> bytes:
    return STREAMS[name]()


#: the batch-serving corpora (phase_batch): images a corpus, their side
BATCH_N, BATCH_PX = 64, 512


def batch_stream(i: int) -> bytes:
    """Image i of `batch64`, bench.py _bench_batch64's corpus
    (bench.py:135-149): _test_image(512, 512, seed=1000 + i), all DCT8."""
    from j40_tpu_torch.encode.vardct_enc import encode_vardct

    return encode_vardct(_test_image(BATCH_PX, BATCH_PX, seed=1000 + i))


def photo_images() -> list[np.ndarray]:
    """`photo64`'s images, bench.py _bench_serving_photo's (bench.py:511-534):
    photo-density 512x512 content whose grain comes from one generator
    (seed 7) drawn image after image, so they are made here, in order."""
    size = BATCH_PX
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    out = []
    for i in range(BATCH_N):
        base = (96 + 60 * np.sin(xx / (31.0 + i % 7)) * np.cos(yy / (23.0 + i % 5))
                + 40 * np.sin((xx + yy) / (71.0 + i % 11)))
        out.append(np.stack([
            base + 10 * np.sin(xx / (9.0 + 2 * c)) + rng.normal(0, 0.7, size=(size, size))
            for c in range(3)], axis=-1).clip(0, 255).astype(np.uint8))
    return out


def photo_stream(img: np.ndarray) -> bytes:
    """One `photo64` image encoded as bench.py does: single-cluster rANS
    (VarDCTOptions(use_prefix=False)), all DCT8."""
    from j40_tpu_torch.encode.vardct_enc import VarDCTOptions, encode_vardct

    return encode_vardct(img, VarDCTOptions(use_prefix=False))


def encode_all() -> dict:
    """Every stream, made by the port's encoders in worker processes (spawned,
    so that they share nothing with this process's CUDA context), one per
    core at most; the batch corpora as lists of BATCH_N streams."""
    import multiprocessing as mp
    import os
    from concurrent.futures import ProcessPoolExecutor

    names = list(STREAMS)
    photos = photo_images()
    with ProcessPoolExecutor(max_workers=min(len(names), os.cpu_count() or 4),
                             mp_context=mp.get_context("spawn")) as ex:
        single = ex.map(make_stream, names)
        batch = ex.map(batch_stream, range(BATCH_N))
        photo = ex.map(photo_stream, photos)
        out = dict(zip(names, single))
        out["batch64"], out["photo64"] = list(batch), list(photo)
    return out


# bench.py _bench_device_filters' EPF parameters, for the ragged-plane path
RAGGED_EPF = dict(iters=3, channel_scale=(40.0, 5.0, 3.5), p0_scale=0.9,
                  p2_scale=6.5, border_sad_mul=2.78)
# filter kernels against their plain versions on XYB planes (phase 3)
XYB_ATOL = 1e-5
# symbols per lane of the capped HF kernel-vs-plain comparison (the plain
# version is one lockstep step of some 80 small launches per symbol)
HF_CAP = 2000
# least 32-bit integer operations per HF symbol: the table index and alias
# select (6), the state update and renormalization (6), the hybrid-int
# shifts and masks (8), the structure counters, the output index and the
# store (10)
HF_OPS_PER_SYMBOL = 30


def device_ms(fn) -> float | None:
    """Median device time per call of `fn` over REPS calls after warm-up:
    the summed durations of the CUDA kernels it launches, as CUPTI records
    them (torch.profiler); None where CUPTI lost records in three sessions.
    CUDA events or a host clock around a call would also time the Python
    launch path, which for these kernels takes longer than the kernel.
    Inputs stay in the 50 MB L2 where they fit, as on the decode path,
    where each kernel reads what the step before it wrote."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    # each session settles first, makes 2 more calls than it times, takes
    # the kernels per call as the records over the calls rounded up, and
    # times the last REPS calls' records.  A session with no device records
    # (seen once, on cuBLAS's matmul) or more than one lost is profiled
    # again, up to three times in all
    calls_made = REPS + 2
    seen = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            settle()
            for _ in range(calls_made):
                fn()
            torch.cuda.synchronize()
        spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                       if e.device_type == DeviceType.CUDA and SETTLE_KERNEL not in e.name)
        seen.append(len(spans))
        per = -(-len(spans) // calls_made)
        if spans and len(spans) >= per * calls_made - 1:
            spans = spans[len(spans) - per * REPS:]
            calls = [sum(b - a for a, b in spans[k * per:(k + 1) * per])
                     for k in range(REPS)]
            return statistics.median(calls) / 1e3
    TIMER_NOTES.append(f"device_ms: {seen} kernel records in {calls_made} calls")
    print(TIMER_NOTES[-1])
    return None


def row_times(ms, plain_ms, library_ms=None) -> dict:
    """`ms`, `plain_ms` and `library_ms` of one kernel row (the kernel, its
    plain version, the library call or None) on ONE timer, named in
    `timer`: CUPTI (device_ms) where it recorded all three, else CUDA
    events queued behind a sleep kernel for all three (queued_ms, ~4 us
    above CUPTI), so that a row never sets one timer against another."""
    fns = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms)
    got = {k: device_ms(f) for k, f in fns.items() if f is not None}
    if all(v is not None for v in got.values()):
        return {"library_ms": None, **got, "timer": "CUPTI"}
    out = {k: (queued_ms(f, REPS) if f is not None else None) for k, f in fns.items()}
    TIMER_NOTES.append(f"row_times: CUPTI lost records of {[k for k, v in got.items() if v is None]}"
                       f"; the row timed by queued CUDA events: {out}")
    print(TIMER_NOTES[-1])
    return dict(out, timer="queued CUDA events")


#: device_ms calls that CUPTI did not time (into build/chip_smoke.json)
TIMER_NOTES: list[str] = []

def queued_ms(fn, reps: int) -> float:
    """Device time per call of `fn`: CUDA events right around each of `reps`
    calls, queued behind a ~5 ms sleep kernel so that the card runs them
    back to back and the events time the kernels, not the launch path
    (tools/torch_kernel_ab.py's timer; ~4 us above CUPTI's records)."""
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(reps)]
    torch.cuda.synchronize()
    torch.cuda._sleep(10_000_000)
    for a, b in pairs:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def bound(nbytes: float, nops: float) -> tuple[float, str]:
    """Least time (ms) for moving `nbytes` and doing `nops` fp32 operations
    at the published peaks, and which of the two sets it."""
    tb, to = nbytes / PEAK_BYTES_S * 1e3, nops / PEAK_FP32_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def dct8_ops(n: int, colour: bool) -> float:
    """Least operations of dequant + CfL + 8x8 IDCT (+ colour) over n blocks:
    2 per multiply-add of the separable IDCT (two 8x8 passes, 2*8^3 per
    block and channel), 10 per coefficient for dequant and CfL, 50 per pixel
    for the colour stage (a cbrt or pow counted as one)."""
    return 2 * 2 * 8**3 * 3 * n + 10 * 3 * 64 * n + (50 * 64 * n if colour else 0)


def epf_ops(npix: int, kinds) -> float:
    """Least operations of the EPF steps `kinds` (filter_kernels step kinds:
    0 = 12-tap cross, 1 = 4-tap cross, 2 = 4-tap plain) over `npix` pixels
    that are not skipped (a skipped pixel is copied: no operations).

    Per distinct tap and pixel: the channel-weighted distance to the tap's
    partner, sum_c scale_c * |a_c - b_c| (3 subtractions, 3 absolutes, 3
    multiplies, 2 adds = 11), computed once per position and shared by the
    5-point crosses of the neighbours; for the cross kinds the sum over the
    cross (4 adds); the weight max(0, 1 + dist * inv_sigma) (3); its sum (1);
    the weighted samples of the 3 channels (3 multiplies, 3 adds).  So 25
    per cross tap and 21 per plain tap.  A tap that the table repeats
    (KERNELS12 holds 7 distinct taps: (0,-2), (-1,0) and (0,2) twice,
    (-1,1) three times) has the same distance, weight and sample each
    time, so its multiplicity costs one multiply of the weight, not another
    tap.  Per step and pixel: inv_sigma (1 multiply) and the 3 divisions by
    the weight sum (4).  A 3-step frame is (7*25 + 4 + 4) + (4*25 + 4) +
    (4*21 + 4) = 375 per pixel.  (Summing each channel's cross before
    weighting it and visiting every table entry, as the reference and the
    plain version do, takes 34 per cross tap and 22 per plain tap, 644 per
    pixel; the kernel also recomputes the shared distances at every
    pixel.)"""
    from collections import Counter

    from j40_tpu_torch.ops.filter_kernels import STEP_KERNELS

    total = 0
    for k in kinds:
        table, cross = STEP_KERNELS[k]
        mult = Counter(table).values()
        total += len(mult) * (25 if cross else 21) + sum(m > 1 for m in mult) + 4
    return float(npix) * total


def active_pixels(rs8: torch.Tensor, h: int, w: int) -> int:
    """Pixels of an (h, w) plane whose 8x8 block EPF does not skip."""
    from j40_tpu_torch.ops.filters import rs_per_pixel

    return int((rs_per_pixel(rs8, h, w) >= 0).sum().item())


def phase_card() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    from j40_tpu_torch.ops.kernels import resolve_device

    dev = resolve_device(None)  # sets TF32 off
    info = dict(
        nvidia_smi=smi, kind=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda, python=sys.version.split()[0],
        allow_tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
        allow_tf32_cudnn=torch.backends.cudnn.allow_tf32,
        sms=torch.cuda.get_device_properties(dev).multi_processor_count,
    )
    print(smi)
    print(f"card: {info}")
    assert not info["allow_tf32_matmul"] and not info["allow_tf32_cudnn"]
    return info


def phase_build() -> dict:
    from j40_tpu_torch.native import bindings
    from j40_tpu_torch.ops import _build
    from j40_tpu_torch.vardct.native_combine import native_combine_available

    native: dict = {}

    def build_native():
        t0 = time.perf_counter()
        native["loaded"] = bindings.get_lib() is not None
        native["seconds"] = time.perf_counter() - t0

    th = threading.Thread(target=build_native)
    th.start()
    _build.load_kernels()
    th.join()
    info = dict(nvcc_seconds=_build.build_info["seconds"],
                native_seconds=native["seconds"], library=_build.build_info["path"])
    print(f"build: nvcc {info['nvcc_seconds']:.1f} s, native host core "
          f"{info['native_seconds']:.1f} s")
    for line in _build.build_info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())
    # without the native core the host plan drops to the pure-Python
    # entropy oracle and the 12 MP decode crawls
    assert native["loaded"] and native_combine_available(), "native core not loaded"
    return info


def group_inputs(data: bytes, apply_filters: bool = False) -> list[dict]:
    """The main path's per-LF-group reconstruction inputs (numpy)."""
    from j40_tpu_torch.decode import Decoder
    from j40_tpu_torch.ops.combine import lf_group_inputs

    dec = Decoder(data, backend="numpy", apply_filters=apply_filters)
    dec.decode_frame(_defer_finish=True)
    st = dec._deferred[2]
    return [lf_group_inputs(st.vardct, st.vardct.lf_groups[k], st.im)
            for k in sorted(st.vardct.lf_groups)]


def phase_kernels(inp3: dict, inp4: dict, dev) -> list[dict]:
    """Each kernel vs its plain version at the main path's shapes: B1 on
    config 3's LF group (n = 16,384), B2 and B3 on config 4's first mixed
    2048x2048 LF group (n = 65,536)."""
    from j40_tpu_torch.ops import kernels as K
    from j40_tpu_torch.ops.combine import to_device

    rows = []
    d3 = to_device(inp3, dev)
    dense3 = K.unpack_i8(d3["i8"], d3["exc_idx"], d3["exc_val"])
    a3 = (dense3, d3["aux"], d3["weights"], d3["consts22"], d3["h8"], d3["w8"])
    n3 = d3["h8"] * d3["w8"]
    got = K.reconstruct_dct8_srgb(*a3, True)
    ref = K.reconstruct_dct8_srgb_ref(*a3, True)
    err = (got.int() - ref.int()).abs().max().item()
    assert err <= 1, f"reconstruct_dct8_srgb disagrees: {err}"
    # the int32 (deeper than 8 bits) variant on the same blocks
    c12 = d3["consts22"].clone()
    c12[21] = 4095.0
    g12 = K.reconstruct_dct8_srgb(*a3[:3], c12, *a3[4:], False).long()
    r12 = K.reconstruct_dct8_srgb_ref(*a3[:3], c12, *a3[4:], False).long()
    assert ((g12 - r12).abs() <= torch.clamp_min(1e-5 * r12.abs(), 1)).all()
    # the yardstick's dense 64x64 IDCT operator (the kernels take the 8x8
    # basis G, 64 floats, by value)
    kt = torch.from_numpy(K.idct8_matrix()).to(dev).T.contiguous()
    flat3 = dense3.reshape(-1, 64)
    b = bound(dense3.numel() * 4 + d3["aux"].numel() * 4 + 64 * 3 * 4
              + 64 * 4 + 22 * 4 + got.numel(), dct8_ops(n3, True))
    rows.append(dict(
        name="reconstruct_dct8_srgb", route="cuda",
        source="j40_tpu_torch/csrc/reconstruct.cu",
        replaces="j40_tpu/ops/pallas_kernels.py:171",
        shape=f"n={n3} blocks -> {tuple(got.shape)} u8", max_abs_err=float(err),
        **row_times(lambda: K.reconstruct_dct8_srgb(*a3, True),
                    lambda: K.reconstruct_dct8_srgb_ref(*a3, True),
                    lambda: torch.matmul(flat3, kt)),
        ms_events=event_ms(lambda: K.reconstruct_dct8_srgb(*a3, True), 20),
        bound_ms=b[0], bound_by=b[1],
        library="torch.matmul (3n,64)x(64,64): the IDCT step alone",
    ))

    d4 = to_device(inp4, dev)
    dense4 = K.unpack_i8(d4["i8"], d4["exc_idx"], d4["exc_val"])
    c8 = d4["consts22"][:8]
    a4 = (dense4, d4["aux"], d4["weights"], c8, d4["h8"], d4["w8"])
    n4 = d4["h8"] * d4["w8"]
    got = K.reconstruct_dct8(*a4)
    ref = K.reconstruct_dct8_ref(*a4)
    err = (got - ref).abs().max().item()
    assert err <= 1e-4, f"reconstruct_dct8 disagrees: {err}"
    flat4 = dense4.reshape(-1, 64)
    b = bound(dense4.numel() * 4 + d4["aux"].numel() * 4 + 64 * 3 * 4
              + 64 * 4 + 8 * 4 + got.numel() * 4, dct8_ops(n4, False))
    rows.append(dict(
        name="reconstruct_dct8", route="cuda",
        source="j40_tpu_torch/csrc/reconstruct.cu",
        replaces="j40_tpu/ops/pallas_kernels.py:39",
        shape=f"n={n4} blocks -> {tuple(got.shape)} f32", max_abs_err=err,
        **row_times(lambda: K.reconstruct_dct8(*a4), lambda: K.reconstruct_dct8_ref(*a4),
                    lambda: torch.matmul(flat4, kt)),
        ms_events=event_ms(lambda: K.reconstruct_dct8(*a4), 20),
        bound_ms=b[0], bound_by=b[1],
        library="torch.matmul (3n,64)x(64,64): the IDCT step alone",
    ))

    plane = got  # the dense grid's XYB samples: B3's input shape and range
    c22 = d4["consts22"]
    got = K.xyb_to_srgb(plane, c22, True)
    ref = K.xyb_to_srgb_ref(plane, c22, True)
    err = (got.int() - ref.int()).abs().max().item()
    assert err <= 1, f"xyb_to_srgb disagrees: {err}"
    gi, ri = K.xyb_to_srgb(plane, c22, False), K.xyb_to_srgb_ref(plane, c22, False)
    assert ((gi.long() - ri.long()).abs() <= torch.clamp_min(1e-5 * ri.long().abs(), 1)).all()
    npix = plane.shape[1] * plane.shape[2]
    b = bound(plane.numel() * 4 + 22 * 4 + got.numel(), 50 * npix)
    rows.append(dict(
        name="xyb_to_srgb", route="cuda",
        source="j40_tpu_torch/csrc/reconstruct.cu",
        replaces="j40_tpu/ops/pallas_kernels.py:274",
        shape=f"{tuple(plane.shape)} f32 -> u8", max_abs_err=float(err),
        **row_times(lambda: K.xyb_to_srgb(plane, c22, True),
                    lambda: K.xyb_to_srgb_ref(plane, c22, True)),
        bound_ms=b[0], bound_by=b[1], library=None,
    ))
    _print_rows(rows)
    return rows


def _print_rows(rows: list[dict]) -> None:
    for r in rows:
        print(f"kernel {r['name']} [{r['shape']}]: {r['ms']:.4f} ms on the "
              f"device ({r['timer']}), plain {r['plain_ms']:.4f} ms, library {r['library_ms']}, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), max|err| {r['max_abs_err']}")


def ragged_plane(dev) -> tuple[torch.Tensor, torch.Tensor]:
    """A (3, 1023, 1021) plane of samples of scale 50 and its per-block
    reciprocal sigmas, seeded as bench.py's _bench_device_filters."""
    rng = np.random.default_rng(2)
    ch = rng.normal(size=(3, 1023, 1021)).astype(np.float32) * 50
    rs8 = (np.abs(rng.normal(size=(128, 128))) + 0.5).astype(np.float32)
    return torch.from_numpy(ch).to(dev), torch.from_numpy(rs8).to(dev)


def ragged_ref(ch, rs8):
    """The plain version of the ragged-plane EPF: one plain step per step."""
    from j40_tpu_torch.ops import filter_kernels as FK

    e = RAGGED_EPF
    for ss, kind in FK.frame_steps(e["iters"], e["p0_scale"], e["p2_scale"]):
        ch = FK.epf_step_ref(ch, rs8, ss, kind, e["channel_scale"], e["border_sad_mul"])
    return ch


def phase_filter_kernels(inp: dict, dev) -> list[dict]:
    """The filter kernels vs their plain versions at the main path's shapes:
    B9 on config 12F's first 2048x2048 LF group's XYB plane, B8 (its 3
    steps, the group's own sigmas) on B9's output, B7 through epf_device on
    the ragged plane (three launches, one per step; each launch also timed
    alone on its own input, with its own bound).  Tolerances: 1e-5
    absolute on the XYB planes, whose samples are of order 1 or less (X
    about 0.03: a wrong X channel must not pass), fp32 sums in another
    order giving about 3e-7; 2e-3 absolute on the ragged plane's samples of
    scale 50 (tests/test_torch_cuda.py)."""
    import torch.nn.functional as Fn

    from j40_tpu_torch.ops import filter_kernels as FK
    from j40_tpu_torch.ops.combine import _mixed_xyb, to_device

    d = to_device(inp, dev)
    filt, epf = d["filters"], d["filters"]["epf"]
    xyb = _mixed_xyb(d["i8"], d["exc_idx"], d["exc_val"], d["aux"], d["weights"],
                     d["consts22"], (), (), d["h8"], d["w8"])
    _, H, W = xyb.shape
    rows = []

    gab = filt["gab"]
    got = FK.gaborish(xyb, gab)
    err = (got - FK.gaborish_ref(xyb, gab)).abs().max().item()
    assert err <= XYB_ATOL, f"gaborish disagrees: {err}"
    taps = []
    for w1, w2 in gab:
        s = 1.0 + 4 * w1 + 4 * w2
        taps.append([[w2 / s, w1 / s, w2 / s], [w1 / s, 1.0 / s, w1 / s],
                     [w2 / s, w1 / s, w2 / s]])
    wt = torch.tensor(taps, dtype=torch.float32, device=dev)[:, None]

    def conv():
        return Fn.conv2d(Fn.pad(xyb[None], (1, 1, 1, 1), mode="replicate"), wt,
                         groups=3)[0]

    assert not torch.backends.cudnn.allow_tf32
    assert (conv() - got).abs().max().item() <= XYB_ATOL
    b = bound(2 * xyb.numel() * 4 + 9 * 4, 17 * xyb.numel())
    rows.append(dict(
        name="gaborish", route="cuda", source="j40_tpu_torch/csrc/filters.cu",
        replaces="j40_tpu/ops/pallas_filters.py:161",
        shape=f"{tuple(xyb.shape)} f32", max_abs_err=err,
        **row_times(lambda: FK.gaborish(xyb, gab), lambda: FK.gaborish_ref(xyb, gab), conv),
        bound_ms=b[0], bound_by=b[1],
        library="F.conv2d depthwise 3x3 on a replicate pad (TF32 off)",
    ))

    plane, rs8 = got, filt["rs8"]
    steps = FK.frame_steps(epf["iters"], epf["p0_scale"], epf["p2_scale"])
    args = (plane, rs8, steps, epf["channel_scale"], epf["border_sad_mul"])
    got = FK.epf_fused(*args)
    err = (got - FK.epf_fused_ref(*args)).abs().max().item()
    assert err <= XYB_ATOL, f"epf_fused disagrees: {err}"
    act = active_pixels(rs8, H, W)
    b = bound(2 * plane.numel() * 4 + rs8.numel() * 4,
              epf_ops(act, [k for _, k in steps]))
    rows.append(dict(
        name="epf_fused", route="cuda", source="j40_tpu_torch/csrc/filters.cu",
        replaces="j40_tpu/ops/pallas_filters.py:413",
        shape=f"{tuple(plane.shape)} f32, steps {[k for _, k in steps]}, "
              f"{act} of {H * W} pixels filtered", max_abs_err=err,
        **row_times(lambda: FK.epf_fused(*args), lambda: FK.epf_fused_ref(*args)),
        ms_events=event_ms(lambda: FK.epf_fused(*args), REPS),
        bound_ms=b[0], bound_by=b[1], library=None,
    ))

    ch, rs8 = ragged_plane(dev)
    got = FK.epf_device(ch, rs8, **RAGGED_EPF)
    err = (got - ragged_ref(ch, rs8)).abs().max().item()
    assert err <= 2e-3, f"epf_step disagrees: {err}"
    _, H, W = ch.shape
    act = active_pixels(rs8, H, W)
    steps = FK.frame_steps(RAGGED_EPF["iters"], RAGGED_EPF["p0_scale"],
                           RAGGED_EPF["p2_scale"])
    kinds = [k for _, k in steps]
    b = bound(2 * ch.numel() * 4 + rs8.numel() * 4, epf_ops(act, kinds))
    # each launch of the chain on its own input, with a bound of its own
    # (one pass over the plane, its step's operations)
    per_launch, x = [], ch
    for ss, kind in steps:
        args = (x, rs8, ss, kind, RAGGED_EPF["channel_scale"], RAGGED_EPF["border_sad_mul"])
        y = FK.epf_step(*args)
        e1 = (y - FK.epf_step_ref(*args)).abs().max().item()
        assert e1 <= 2e-3, f"epf_step kind {kind} disagrees: {e1}"
        t = row_times(lambda a=args: FK.epf_step(*a), lambda a=args: FK.epf_step_ref(*a))
        b1 = bound(2 * x.numel() * 4 + rs8.numel() * 4, epf_ops(act, [kind]))
        per_launch.append(dict(kind=kind, ms=t["ms"], plain_ms=t["plain_ms"],
                               timer=t["timer"], ns_per_pixel=t["ms"] * 1e6 / (H * W),
                               bound_ms=b1[0], bound_by=b1[1], max_abs_err=e1))
        x = y
    rows.append(dict(
        name="epf_step", route="cuda", source="j40_tpu_torch/csrc/filters.cu",
        replaces="j40_tpu/ops/pallas_filters.py:82",
        shape=f"{tuple(ch.shape)} f32, steps {kinds}, one launch each",
        max_abs_err=err,
        **row_times(lambda: FK.epf_device(ch, rs8, **RAGGED_EPF),
                    lambda: ragged_ref(ch, rs8)),
        bound_ms=b[0], bound_by=b[1], library=None, per_launch=per_launch,
    ))
    _print_rows(rows)
    for p in per_launch:
        print(f"  epf_step kind {p['kind']}: {p['ms']:.4f} ms ({p['timer']}), "
              f"{p['ns_per_pixel']:.5f} ns a pixel, bound {p['bound_ms']:.4f} ms, "
              f"max|err| {p['max_abs_err']}")
    return rows


def phase_ragged_epf(dev) -> dict:
    """The whole-plane EPF path on a plane whose sides are not multiples of
    8: epf_device takes the single-step kernel, once per step.  The launch
    counters are zeroed just before and read just after."""
    from j40_tpu_torch.ops import filter_kernels as FK
    from j40_tpu_torch.ops import kernels as K

    ch, rs8 = ragged_plane(dev)
    K.reset_launches()
    out = FK.epf_device(ch, rs8, **RAGGED_EPF)
    torch.cuda.synchronize()
    launches = dict(K.launches)
    assert launches["epf_step"] == 3 and launches["epf_fused"] == 0, launches
    assert out.shape == ch.shape and torch.isfinite(out).all()
    err = (out - ragged_ref(ch, rs8)).abs().max().item()
    assert err <= 2e-3, f"ragged EPF disagrees: {err}"
    print(f"path ragged_epf {tuple(ch.shape)}: launches {launches}, max|err| {err}")
    return dict(config="ragged_epf", launches=launches, max_abs_err=err)


def hf_plan(data: bytes) -> dict:
    """The device route's lanes of a stream, as ops/device_vardct.py plans
    them, on an LF-only host decode: {vd, spec, ctx, lanes, orders}."""
    from j40_tpu_torch.decode import Decoder
    from j40_tpu_torch.ops import device_vardct as DV

    dec = Decoder(data, backend="numpy", max_passes=0)
    dec.decode_frame(_defer_finish=True)
    f, toc, state = dec._deferred
    plan = DV.hf_lanes(dec, state, f, [s for s in toc.sections if s.pass_ == 0])
    assert plan is not None, "no section is eligible for the device route"
    return dict(zip(("spec", "ctx", "lanes", "orders"), plan), vd=state.vardct)


def hf_mode(plan: dict) -> str:
    """Which kernel path a plan's lanes take: B4 "prefix" or "ans", or B5
    "ctx"."""
    if plan["ctx"]:
        return "ctx"
    return "prefix" if plan["spec"].use_prefix_code else "ans"


def host_coeffs(vd, lanes, ncmax: int) -> np.ndarray:
    """(L, 3, ncmax, 64) float32: each lane's coefficients in natural
    positions from the host plan's entropy decode of its section (the
    native core), gathered by vb_coeffoff."""
    from j40_tpu_torch.io.bits import BitReader

    out = np.zeros((len(lanes), 3, ncmax, 64), np.float32)
    for li, ln in enumerate(lanes):
        vd.read_pass_group(BitReader(ln.data), 0, ln.section.idx)
        gg = ln.gg
        sub = gg.blocks[ln.gy8:ln.gy8 + ln.gh8, ln.gx8:ln.gx8 + ln.gw8].ravel()
        idx = gg.vb_coeffoff[sub & 0xFFFFF].astype(np.int64)[:, None] + np.arange(64)
        for c in range(3):
            out[li, c, :len(sub)] = gg.coeffs[c][idx]
    return out


def lane_symbols(out: torch.Tensor, nat: torch.Tensor, nc: torch.Tensor) -> torch.Tensor:
    """Symbols each lane's walk decoded, from its coefficient planes: per
    cell and channel the nonzero count, then the coefficients up to the
    last nonzero in coefficient order (j40.h:6959-6992)."""
    L, _, ncmax, _ = out.shape
    natl = (nat if nat.dim() == 3 else nat.expand(L, 3, 64)).long()
    ordered = out.gather(3, natl[:, :, None, :].expand(-1, -1, ncmax, -1))
    i = torch.arange(1, 64, device=out.device)
    last = torch.where(ordered[..., 1:] != 0, i, 0).amax(-1)  # (L, 3, ncmax)
    valid = torch.arange(ncmax, device=out.device)[None, :] < nc.long()[:, None]
    return ((1 + last) * valid[:, None, :]).sum((1, 2))


def event_ms(fn, reps: int = 1) -> float:
    """Time per call of `reps` calls on the card between two CUDA events.
    For the HF walks: one launch of tens of milliseconds, where the launch
    path is noise (a CUPTI session lost 2 of 32 records of such launches
    in two runs of three), and the plain versions, whose ~10^5 small
    launches per call would swamp the profiler."""
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


#: name fragments of the entropy kernels (csrc/hf.cu, tokens.cu, prefix_sync.cuh)
ENTROPY_KERNELS = ("sync_", "tokens_", "hf_")


def kernel_split(fn, strict: bool) -> dict[str, float] | None:
    """Device ms per call of each entropy kernel `fn` launches: the median of
    that kernel's CUPTI records over REPS calls after warm-up.  Each kernel
    runs once a call, so a record that the profiler loses (as CUPTI
    sometimes does) does not shift the others.  `strict`: a session where a
    kernel lost more than two records is profiled again, up to three in
    all; None when all three lost some."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            settle()
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
        recs: dict[str, list[float]] = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and any(k in e.name for k in ENTROPY_KERNELS):
                short = e.name.replace("(anonymous namespace)::", "").split("(")[0].split()[-1]
                recs.setdefault(short, []).append((e.time_range.end - e.time_range.start) / 1e3)
        if not strict or recs and all(len(v) >= REPS - 2 for v in recs.values()):
            return {k: statistics.median(v) for k, v in recs.items()}
    TIMER_NOTES.append(f"kernel_split: records {({k: len(v) for k, v in recs.items()})} "
                       f"of {REPS} calls in the third session")
    print(f"kernel_split: {TIMER_NOTES[-1]}")
    return None


def entropy_ms(fn, design: str) -> tuple[float, str, float, dict]:
    """Device time of one uncapped entropy call, its timer, the time between
    CUDA events around 10 calls, and the device time by kernel.  The sync
    design's call is four or five short launches: CUPTI times them (between
    events the host's launch path would count, and the wrapper's input
    checks), or, where CUPTI loses their records, CUDA events around each
    call queued behind a sleep kernel; a serial call is one launch of
    milliseconds, timed between events (CUPTI has lost records of such
    launches)."""
    ev = event_ms(fn, 10)
    split = kernel_split(fn, strict=design == "sync")
    if design == "sync":
        if split is None:
            return queued_ms(fn, REPS), "queued CUDA events", ev, {}
        return sum(split.values()), "CUPTI", ev, split
    return ev, "CUDA events", ev, split or {}


def sync_summary(stats: dict) -> dict | None:
    """The self-synchronising design's statistics over the lanes, from an
    entropy wrapper's `stats_out` (None for the serial design): chase rounds
    (the fused first included) and the longest chase in subsequences (the
    worst lane), subsequences re-decoded after the first round and
    subsequences (all lanes)."""
    if "sync" not in stats:
        return None
    s = stats["sync"].cpu()
    return dict(rounds=int(s[:, 0].max()), longest_chase=int(s[:, 1].max()),
                redecoded=int(s[:, 2].sum()), subsequences=int(s[:, 3].sum()))


def phase_hf_kernels(plans: dict, dev) -> list[dict]:
    """B4 (prefix on config 4's first launch, rANS on hf_ans_2048) and B5
    (hf_ctx_2048) on the main path's full-size lanes: kernel and plain
    version on the card from the same packed inputs, capped at HF_CAP
    symbols, must give the same planes and snapshots; the uncapped kernel
    must give the host plan's coefficient planes exactly, end every lane
    (the final ANS state 0x130000 where rANS) and flag no error."""
    return [hf_row(name, cfg, plans[cfg], replaces, dev) for name, cfg, replaces in (
        ("hf_prefix", "config4", "j40_tpu/ops/pallas_hf.py:71"),
        ("hf_ans", "hf_ans_2048", "j40_tpu/ops/pallas_hf.py:71"),
        ("hf_ctx", "hf_ctx_2048", "j40_tpu/ops/pallas_hf.py:725"))]


def hf_row(name: str, cfg: str, p: dict, replaces: str, dev) -> dict:
    """One HF kernel row (phase_hf_kernels) on the first batch of the plan
    `p` of stream `cfg`."""
    from j40_tpu_torch.ops import device_vardct as DV

    batch = DV.hf_batches(p["lanes"])[0]
    ncmax = max(ln.gw8 * ln.gh8 for ln in batch)
    d, launch, done_row = DV.pack_hf_batch(p["vd"], p["spec"], batch, p["orders"],
                                           p["ctx"], dev)
    assert name == f"hf_{hf_mode(p)}", (name, hf_mode(p))
    return hf_measure(
        dict(name=name, replaces=replaces, counter="hf_ctx" if p["ctx"] else "hf",
             mode=hf_mode(p)),
        f"{len(batch)} lanes of {cfg}", d, launch, done_row, ncmax,
        [(p["vd"], batch)], p["spec"].use_prefix_code, p["ctx"], dev)


def hf_measure(row: dict, what: str, d: dict, launch, done_row: int, ncmax: int,
               parts: list, use_prefix: bool, ctx: bool, dev) -> dict:
    """Check and time one HF kernel call over the packed lanes `d` (`launch`,
    as ops/device_vardct.pack_hf_batch returns it): kernel and plain version
    on the card, capped at HF_CAP symbols, give the same planes and
    snapshots; uncapped, the kernel gives the host plan's coefficient planes
    of `parts` ([(vardct state, lanes)], in lane order) exactly, ends every
    lane (the final ANS state 0x130000 where rANS) and flags no error.
    Returns `row` with the measurements."""
    from j40_tpu_torch.ops import hf_kernels as HK

    lanes = [ln for _, lns in parts for ln in lns]
    plain = HK.hf_ctx_walk_ref if ctx else HK.hf_walk_ref
    name = row["name"]
    out_k, st_k = launch(ncmax, cap_steps=HF_CAP)
    out_p, st_p = launch(ncmax, cap_steps=HF_CAP, walk=plain)
    torch.cuda.synchronize()
    assert torch.equal(st_k, st_p), f"{name}: snapshot differs from the plain version"
    assert torch.equal(out_k, out_p), f"{name}: planes differ from the plain version"

    stats: dict = {}
    out, st = launch(ncmax, **({} if ctx else {"stats_out": stats}))
    design = HK.CTX_DESIGN if ctx else HK.design(d["use_prefix"])
    sync = sync_summary(stats)
    s = HK.lane_state(st, len(lanes), done_row)
    host = torch.from_numpy(np.concatenate(
        [host_coeffs(vd, lns, ncmax) for vd, lns in parts])).to(dev)
    err = (out - host).abs().max().item()
    assert err == 0, f"{name}: planes differ from the host plan by {err}"
    assert s["done"].all() and not s["err"].any(), s
    assert use_prefix or (s["ans_state"] == 0x130000).all()
    sym = lane_symbols(out, d["nat"], d["nc"])
    nsym, longest = int(sym.sum()), int(sym.max())

    scratch = torch.empty_like(out)
    ms, timer, ms_events, split = entropy_ms(lambda: launch(ncmax, out=scratch), design)
    ms_cap = event_ms(lambda: launch(ncmax, cap_steps=HF_CAP, out=scratch), 20)
    plain_ms = event_ms(lambda: launch(ncmax, cap_steps=HF_CAP, out=scratch,
                                       walk=plain))
    tables = sum(d[k].numel() * 4 for k in ("lut", "lane", "nat", "ab", "cmap",
                                            "cfgw", "nf", "bctx3") if k in d)
    b = bound(sum(len(ln.data) for ln in lanes) + tables + out.numel() * 4,
              HF_OPS_PER_SYMBOL * nsym)
    row.update(
        route="cuda", source="j40_tpu_torch/csrc/hf.cu",
        shape=f"{what}, up to {max(len(ln.data) for ln in lanes)} B "
              f"and {ncmax} cells -> {tuple(out.shape)} f32",
        max_abs_err=err, ms=ms, ms_at_cap=ms_cap, timer=timer, ms_events=ms_events,
        plain_ms=plain_ms, plain_cap=HF_CAP, plain_timer="CUDA events",
        bound_ms=b[0], bound_by=b[1], library_ms=None, library=None,
        symbols=nsym, symbols_longest_lane=longest,
        ns_per_symbol=ms * 1e6 / longest, symbols_per_s=nsym / (ms * 1e-3),
        design=design, sync=sync, kernels_ms=split,
    )
    print(f"kernel {name} [{row['shape']}]: {design} design, {ms:.3f} ms uncapped "
          f"({timer}; events {ms_events:.3f} ms; {nsym} symbols, "
          f"{row['symbols_per_s']:.4g} a second, longest lane "
          f"{longest}, {row['ns_per_symbol']:.1f} ns per symbol), sync {sync}, by kernel "
          f"{ {k: round(v, 4) for k, v in split.items()} }, "
          f"{ms_cap:.4f} ms at "
          f"{HF_CAP} steps, plain {plain_ms:.1f} ms at {HF_CAP} steps, bound "
          f"{b[0]:.4f} ms ({b[1]}); equal to the plain version (capped) and "
          f"to the host plan (uncapped)")
    return row


def modular_plan(data: bytes) -> dict:
    """The modular device route's lanes of a stream, as
    ops/device_modular.py plans them (`_prepare_lane` on every pass-group
    section), grouped into the batches `try_device_pass_groups` launches:
    {lanes, batches, sections}."""
    from j40_tpu_torch.decode import Decoder
    from j40_tpu_torch.ops import device_modular as DM

    dec = Decoder(data, backend="numpy", max_passes=0)
    dec.decode_frame(_defer_finish=True)
    f, toc, state = dec._deferred
    sections = [s for s in toc.sections if s.pass_ == 0]
    lanes = DM.plan_lanes(dec, state, sections)
    batches: dict = {}
    for ln in lanes:
        kind = "ctx" if ln.ctx is not None else "ntree" if ln.ntree is not None else "plain"
        batches.setdefault((ln.spec.use_prefix_code, kind), []).append(ln)
    return dict(lanes=lanes, batches=list(batches.values()), sections=len(sections))


# the token kernel's rows: (row name, stream) for each table mode — per-lane
# rows (local trees, prefix), one shared row (B6's own case; prefix and
# rANS), per-token clusters (static tree, rANS), and the e3 tree's prefix
# lanes (local neighbour-property trees, per-lane rows)
TOKEN_ROWS = (("tokens_lane", "modular"), ("tokens_shared", "modular_global"),
              ("tokens_shared_ans", "modular_e3gt"), ("tokens_ctx", "modular_static_ctx"),
              ("tokens_e3", "modular_e3"))
# symbols per lane of the capped token kernel-vs-plain comparison
TOKEN_CAP = 2000
# least 32-bit integer operations per token: the table index (2), the rANS
# step or prefix lookup and the bit drops (8), the hybrid-int lookups,
# shifts and masks (8), the store (2)
TOKEN_OPS_PER_SYMBOL = 20


def phase_token_kernels(plans: dict, dev) -> list[dict]:
    """The token kernel (B6) in each table mode on the main path's full-size
    lanes: kernel and plain version on the card from the same packed inputs,
    capped at TOKEN_CAP symbols, must give the same values, states and bit
    positions (and the CPU's plain version too); uncapped, every lane must
    end where its section ends, with the final rANS state 0x130000 where
    rANS (device_modular._check_lane_end)."""
    rows = []
    for name, cfg in TOKEN_ROWS:
        (batch,) = plans[cfg]["batches"]
        rows.append(token_row(name, cfg, batch, dev))
    return rows


def token_row(name: str, cfg: str, batch: list, dev) -> dict:
    """One token kernel row (phase_token_kernels) on a batch of lanes of the
    stream `cfg`."""
    from j40_tpu_torch.ops import device_modular as DM
    from j40_tpu_torch.ops import token_kernels as TKN
    from j40_tpu_torch.ops.hf_kernels import to_device

    packed = DM.pack_lanes(batch)
    d = to_device(packed, dev)
    mode = ("ctx" if packed["cids"] is not None
            else "shared" if packed["sym"].shape[0] == 1 else "lane")
    got = TKN.launch_tokens(d, TOKEN_CAP)
    plain = TKN.launch_tokens(d, TOKEN_CAP, decode=TKN.decode_tokens_ref)
    torch.cuda.synchronize()
    for a, b in zip(got, plain):
        assert torch.equal(a, b), f"{name}: the kernel differs from the plain version"
    stats: dict = {}
    vals, st, bp = TKN.launch_tokens(d, stats_out=stats)
    design = TKN.design(packed["use_prefix"], packed["cids"] is not None)
    sync = sync_summary(stats)
    st_h, bp_h = st.cpu().numpy(), bp.cpu().numpy()
    for li, ln in enumerate(batch):
        DM._check_lane_end(ln, ((ln.bitoff // 8) & ~1) * 8 + int(bp_h[li]),
                           packed["use_prefix"], int(st_h[li]) & 0xFFFFFFFF)
    nsym = sum(ln.nsym for ln in batch)
    longest = max(ln.nsym for ln in batch)
    ms, timer, ms_events, split = entropy_ms(lambda: TKN.launch_tokens(d), design)
    ms_cap = event_ms(lambda: TKN.launch_tokens(d, TOKEN_CAP), 20)
    plain_ms = event_ms(lambda: TKN.launch_tokens(d, TOKEN_CAP,
                                                  decode=TKN.decode_tokens_ref))
    tables = sum(d[k].numel() * 4 for k in ("sym", "fb", "mb", "a", "lo", "lsb"))
    b = bound(sum(len(ln.data) for ln in batch) + tables
              + (d["cids"].numel() * 4 if d["cids"] is not None else 0)
              + vals.numel() * 4 + st.numel() * 4 + bp.numel() * 4,
              TOKEN_OPS_PER_SYMBOL * nsym)
    row = dict(
        name=name, route="cuda", source="j40_tpu_torch/csrc/tokens.cu",
        replaces="j40_tpu/ops/pallas_entropy.py:312", counter="tokens",
        paths=[f"{cfg}/device"], mode=mode,
        shape=f"{len(batch)} lanes of {cfg} ({mode} tables, "
              f"{'prefix' if packed['use_prefix'] else 'rANS'}), up to "
              f"{max(len(ln.data) for ln in batch)} B -> {tuple(vals.shape)} int32",
        max_abs_err=0, ms=ms, ms_at_cap=ms_cap, timer=timer, ms_events=ms_events,
        plain_ms=plain_ms, plain_cap=TOKEN_CAP, plain_timer="CUDA events",
        bound_ms=b[0], bound_by=b[1],
        library_ms=None, library=None, symbols=nsym, symbols_longest_lane=longest,
        ns_per_symbol=ms * 1e6 / longest, symbols_per_s=nsym / (ms * 1e-3),
        design=design, sync=sync, kernels_ms=split,
    )
    print(f"kernel {name} [{row['shape']}]: {design} design, {ms:.3f} ms uncapped "
          f"({timer}; events {ms_events:.3f} ms; {nsym} symbols, "
          f"{row['symbols_per_s']:.4g} a second, longest lane "
          f"{longest}, {row['ns_per_symbol']:.1f} ns per symbol), sync {sync}, by kernel "
          f"{ {k: round(v, 4) for k, v in split.items()} }, "
          f"{ms_cap:.4f} ms at {TOKEN_CAP} steps, plain {plain_ms:.1f} ms at "
          f"{TOKEN_CAP} steps, bound {b[0]:.4f} ms ({b[1]}); equal to the plain "
          f"version (capped), every lane at its section's end (uncapped)")
    return row


#: the wavefront kernels' rows: (row name, stream, counter, the JAX program
#: it replaces (a lax.scan inside jax.jit: no pl.pallas_call), the paths
#: whose launches it counts); each on the route's one launch for the
#: stream's class, its three slots of 16 lanes as 48 planes
WAVEFRONT_ROWS = (
    ("wavefront_grad", "modular", "wavefront", "j40_tpu/ops/device_entropy.py:491",
     ("modular/device", "modular_global/device", "shent_1024/sharded8")),
    ("wavefront_mixed", "modular_static_ctx", "wavefront_mixed",
     "j40_tpu/ops/device_entropy.py:548", ("modular_static_ctx/device",)),
    ("wavefront_wp", "modular_wp", "wavefront_wp", "j40_tpu/ops/device_entropy.py:738",
     ("modular_wp/device",)),
    ("wavefront_wp_codes", "modular_static_wp", "wavefront_wp_codes",
     "j40_tpu/ops/device_entropy.py:738", ("modular_static_wp/device",)),
    ("wavefront_tree", "modular_e3gt", "wavefront_tree",
     "j40_tpu/ops/device_entropy.py:956", ("modular_e3/device", "modular_e3gt/device")),
)
# least 32-bit integer operations a pixel: W1 the edge chain and the
# clamped gradient or the code select (12); W2 the four sub-predictions
# (30), the error sums and weights (60), the blend and its clamp (25), the
# error update (25); W3 adds 8 a level of the tree walk and its leaf (10)
W1_OPS, W2_OPS, TREE_LEVEL_OPS, TREE_LEAF_OPS = 12, 140, 8, 10


def wavefront_inputs(plan: dict, dev, slots: int = 3) -> dict:
    """A class's `slots` (class, slot) plane batches of a stream's lanes as
    ops/device_modular.py hands them to a wavefront in one launch: the
    token kernel's values of every lane's slots (the lanes share one class
    here: 256x256 groups, one leaf or one tree, three channels of one
    shape), unpacked, slot after slot, with the leaf's or the static
    tree's per-pixel multiplier and offset applied; a static tree's
    per-pixel codes, a neighbour-property tree, the planes' channel and
    stream indices."""
    from j40_tpu_torch.ops import device_modular as DM
    from j40_tpu_torch.ops import token_kernels as TKN
    from j40_tpu_torch.ops.device_entropy import unpack_signed_dev
    from j40_tpu_torch.ops.hf_kernels import to_device

    (batch,) = plan["batches"]
    vals = TKN.launch_tokens(to_device(DM.pack_lanes(batch), dev))[0]
    first = batch[0]
    w, h = first.picks[0][3:]
    assert all(p[3:] == (w, h) for ln in batch for p in ln.picks[:slots])
    L = len(batch)
    res = torch.cat([unpack_signed_dev(vals[:, k * w * h : (k + 1) * w * h])
                     for k in range(slots)]).reshape(slots * L, h, w)
    out = dict(h=h, w=w, lanes=slots * L, slots=slots, wp=first.wp)
    if first.ntree is not None:
        assert all(ln.ntree[0] == first.ntree[0] for ln in batch)
        out.update(tree=first.ntree[0], sidx=torch.tensor(
            [ln.ntree[1] for ln in batch] * slots, dtype=torch.int32, device=dev),
            cidx=torch.arange(slots, dtype=torch.int32, device=dev).repeat_interleave(L))
    elif first.ctx is not None:
        def plane(k):
            return torch.from_numpy(np.concatenate([np.stack([ln.ctx[c][k] for ln in batch])
                                                    for c in range(slots)])).to(dev)

        res = res * plane("mult") + plane("offset")
        out["codes"] = plane("pred")
    else:
        res = res * first.leaf.multiplier + first.leaf.offset
        out["predictor"] = first.leaf.predictor
    out["res"] = res.contiguous()
    return out


def phase_wavefront_kernels(plans: dict, dev) -> list[dict]:
    """The wavefront kernels W1-W3 (csrc/wavefront.cu) on the main path's
    planes, each against its plain version (the torch-op loop of
    ops/device_entropy.py) on the card from the same inputs: planes and
    overflow flags equal.  `ms` is the kernel's device time; the plain
    version, ~10^4-10^5 small launches a call, is timed once between CUDA
    events.  The diagonal count D and the time a diagonal, which is what
    bounds a serial chain, beside the byte bound."""
    from j40_tpu_torch.modular.wp import WPParams
    from j40_tpu_torch.ops import device_entropy as DE
    from j40_tpu_torch.ops import wavefront_kernels as WK

    rows = []
    for name, cfg, counter, replaces, paths in WAVEFRONT_ROWS:
        inp = wavefront_inputs(plans[cfg], dev)
        res, h, w, L, slots = inp["res"], inp["h"], inp["w"], inp["lanes"], inp["slots"]
        wp = inp["wp"] or WPParams()
        codes, tree, sidx, cidx = (inp.get(k) for k in ("codes", "tree", "sidx", "cidx"))
        nbytes = res.numel() * 4 * 2 + (codes.numel() * 4 if codes is not None else 0)
        if counter in ("wavefront", "wavefront_mixed"):
            assert (codes is None) == (counter == "wavefront")
            assert inp.get("predictor", 5) == 5

            def run():
                return WK.plain_wavefront(res, codes, h, w)

            def plain():
                return DE._plain_wavefront(res, codes, h, w)

            D, ops = h + w - 1, W1_OPS * res.numel()
            mode = "mixed codes" if codes is not None else "gradient"
        elif counter in ("wavefront_wp", "wavefront_wp_codes"):
            assert (codes is None) == (counter == "wavefront_wp")
            assert inp.get("predictor", 6) == 6

            def run():
                return WK.wp_wavefront(res, codes, h, w, wp)

            def plain():
                return DE._wp_reconstruct(res, codes, h, w, wp, codes is not None)

            D, ops = 2 * h + w - 2, W2_OPS * res.numel()
            nbytes += L
            mode = "WP" if codes is None else "per-pixel codes"
        else:
            depth = WK._tree_meta(tuple(tree))[1]

            def run():
                return WK.tree_wavefront(res, tree, cidx, sidx, h, w, wp)

            def plain():
                # the plain version takes one channel: a call a slot
                n = L // slots
                outs = [DE._tree_wp_reconstruct(res[c * n:(c + 1) * n], h, w, wp, tree, c,
                                                sidx[c * n:(c + 1) * n]) for c in range(slots)]
                return tuple(torch.cat(t) for t in zip(*outs))

            D = 2 * h + w - 2
            ops = (W2_OPS + TREE_LEVEL_OPS * depth + TREE_LEAF_OPS) * res.numel()
            nbytes += L + len(tree) * 16 + L * 8
            mode = f"tree of {len(tree)} nodes, depth {depth}"
        # the plain version's one call both checks the kernel and is timed
        got, wanted = run(), []
        plain_ms = event_ms(lambda: wanted.append(plain()))
        want = wanted[0]
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for a, b in zip(got, want):
            assert torch.equal(a, b), f"{name}: the kernel differs from the plain version"
        flagged = int(got[1].sum()) if len(got) > 1 else 0
        ms = device_ms(run)
        timer = "CUPTI"
        if ms is None:
            ms, timer = queued_ms(run, REPS), "queued CUDA events"
        b = bound(nbytes, ops)
        row = dict(
            name=name, route="cuda", source="j40_tpu_torch/csrc/wavefront.cu",
            replaces=replaces, counter=counter, paths=list(paths), mode=mode,
            shape=f"{L} planes of {h}x{w} int32 ({cfg}, slots 0-{slots - 1}, one launch, {mode})",
            max_abs_err=0, flagged_lanes=flagged, ms=ms, timer=timer,
            ms_events=event_ms(run, 20), plain_ms=plain_ms,
            plain_timer="CUDA events", library_ms=None, library=None,
            bound_ms=b[0], bound_by=b[1], diagonals=D, ns_per_diagonal=ms * 1e6 / D)
        rows.append(row)
        print(f"kernel {name} [{row['shape']}]: {ms:.4f} ms ({timer}; events "
              f"{row['ms_events']:.4f} ms), {D} diagonals, "
              f"{row['ns_per_diagonal']:.1f} ns a diagonal, plain {row['plain_ms']:.1f} ms "
              f"(one call, CUDA events), bound {b[0]:.4f} ms ({b[1]}), flagged lanes "
              f"{flagged}; planes and flags equal to the plain version")
    return rows


def phase_flat_probes(streams: dict, dev) -> list[dict]:
    """The sync design on flat, screenshot-like content (FLAT_STREAMS), whose
    long runs of the all-zero codeword may fall into step only at the run's
    end: B6 on the modular stream's largest batch of lanes, also through
    the serial design (the same lanes with per-token cluster ids, all 0:
    equal values, timed between events), and B4 on the VarDCT stream's
    prefix lanes; each checked as its kernel row is.  Not on the kernels
    line: these are the same kernels on other content."""
    from j40_tpu_torch.ops import device_modular as DM
    from j40_tpu_torch.ops import token_kernels as TKN
    from j40_tpu_torch.ops.hf_kernels import to_device

    hf = hf_row("hf_prefix", "vardct_flat", hf_plan(streams["vardct_flat"]),
                "j40_tpu/ops/pallas_hf.py:71", dev)
    batch = max(modular_plan(streams["modular_flat"])["batches"], key=len)
    tok = token_row("tokens_lane", "modular_flat", batch, dev)
    d = to_device(DM.pack_lanes(batch), dev)
    assert tok["design"] == "sync" and TKN.design(True, True) == "serial"
    serial = dict(d, cids=torch.zeros((d["words"].shape[0], d["n_steps"]),
                                      dtype=torch.int32, device=dev))
    for a, b in zip(TKN.launch_tokens(serial), TKN.launch_tokens(d)):
        assert torch.equal(a, b), "flat lanes: the serial design differs from the sync one"
    tok["serial_ms_events"] = event_ms(lambda: TKN.launch_tokens(serial), 10)
    print(f"flat probe: B6 sync {tok['ms_events']:.3f} ms (events) against the serial "
          f"design's {tok['serial_ms_events']:.3f} ms on the same lanes")
    for r, name in ((hf, "hf_prefix_flat"), (tok, "tokens_flat")):
        r["name"] = name
    return [hf, tok]


def phase_modular_path(name: str, data: bytes, plan: dict) -> dict:
    """A modular stream through `decode_file(data, backend="device",
    workers=4)`: RGBA equal bit for bit to the host plan, every eligible
    section of the port's own plan on the device lanes, the token kernel
    launched once a lane batch and the wavefront kernels once a (class,
    kernel), for three (class, slot) plane batches (counters zeroed just
    before the decode, read just after); Mpix/s beside the host plan's."""
    from j40_tpu_torch.ops import kernels as K

    _, ref = _decode(data, "numpy")
    K.reset_launches()
    t0 = time.perf_counter()
    dec, rgba = _decode(data, "device")
    first_s = time.perf_counter() - t0
    launches = dict(K.launches)
    assert np.array_equal(rgba, ref), f"{name}: device route != host plan"
    dm = dict(dec.stats["device_modular"])
    taken = sum(dm.get(k, 0) for k in ("lanes", "ctx_lanes", "ntree_lanes"))
    assert taken == len(plan["lanes"]) > 0, f"{name}: {dm} against {len(plan['lanes'])}"
    assert launches["tokens"] == len(plan["batches"]), f"{name}: launches {launches}"
    # one wavefront launch a (class, kernel) (`wavefronts`, counted where
    # ops/device_modular.py chooses it) against one reconstruction a
    # (class, slot): here a class's three slots share their shape and
    # kernel (5, 6, per-pixel codes or a tree), so one launch takes them;
    # and the stream's own wavefront kernel launched
    waves = sum(launches[k] for k in WAVEFRONT_COUNTERS)
    assert waves == dm["wavefronts"] > 0 and 3 * waves == dm["reconstructions"], \
        f"{name}: launches {launches}, route {dm}"
    for row, _, counter, _, paths in WAVEFRONT_ROWS:
        if f"{name}/device" in paths:
            assert launches[counter] > 0, f"{name}: {row} not launched: {launches}"

    def mpix(backend, reps):
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            _decode(data, backend)
            ts.append(time.perf_counter() - t0)
        return rgba.shape[0] * rgba.shape[1] / 1e6 / statistics.median(ts)

    # a decode slower than 5 s is timed once
    reps = 3 if first_s < 5 else 1
    out = dict(config=name, backend="device", path=f"{name}/device",
               size=f"{rgba.shape[1]}x{rgba.shape[0]}", stream_bytes=len(data),
               sections=plan["sections"], launches=launches, device_modular=dm,
               first_decode_s=first_s, timed_decodes=reps, mpix_s=mpix("device", reps),
               host_plan_mpix_s=mpix("numpy", 3), max_abs_diff=0)
    out["target_met"] = out["mpix_s"] >= out["host_plan_mpix_s"]
    print(f"main path {name}, backend=device ({out['size']}, {len(data)} B, "
          f"{taken} of {plan['sections']} sections on the card): {out['mpix_s']:.3f} "
          f"Mpix/s on the card (median of {reps}), host plan {out['host_plan_mpix_s']:.2f} "
          f"Mpix/s, target_met {out['target_met']}, launches "
          f"{ {k: v for k, v in launches.items() if v} }, route {dm}, equal to the "
          f"host plan")
    return out


#: the batch paths of phase_batch: (path, corpus, function name); the
#: decode_batch path is the fused route, which a uniform corpus takes
BATCH_PATHS = (("batch64/decode_batch", "batch64", "decode_batch"),
               ("batch64/decode_batch_device", "batch64", "decode_batch_device"),
               ("photo64/decode_batch_device", "photo64", "decode_batch_device"),
               ("photo64/decode_batch_device_hf", "photo64", "decode_batch_device_hf"))
BATCH_WORKERS = 8  # the phase-1 thread pool: the card machine's cores


def batch_call(fn: str, blobs: list, dev, stats: dict):
    """One call of the batch API function `fn` as a server makes it; the
    device paths' output stays on the card (synchronized before return)."""
    from j40_tpu_torch.parallel import batch as PB

    if fn == "decode_batch":
        return PB.decode_batch(blobs, workers=BATCH_WORKERS, backend="torch", device=dev)
    out = getattr(PB, fn)(blobs, workers=BATCH_WORKERS, chunk=16, stats_out=stats,
                          device=dev)
    torch.cuda.synchronize()
    return out


def busy(fn, match: str = "") -> tuple[float, float, int, float]:
    """One call of `fn` under torch.profiler (device activity only): (wall
    ms, device busy ms, device records, busy ms of the records whose name
    holds `match`, 0 without it)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        settle()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans = [(e.time_range.end - e.time_range.start) for e in prof.events()
             if e.device_type == DeviceType.CUDA and SETTLE_KERNEL not in e.name]
    mine = [(e.time_range.end - e.time_range.start) for e in prof.events()
            if match and e.device_type == DeviceType.CUDA and match in e.name]
    return wall, sum(spans) / 1e3, len(spans), sum(mine) / 1e3


def host_profile(fn, lines: int = 14) -> list[str]:
    """The calling thread's functions by cumulative time over one call of
    `fn` (cProfile: it sees no worker thread, so time a worker takes shows
    as the wait for its result)."""
    import cProfile
    import io
    import pstats

    pr = cProfile.Profile()
    pr.enable()
    fn()
    pr.disable()
    s = io.StringIO()
    pstats.Stats(pr, stream=s).sort_stats("cumulative").print_stats(lines)
    return [ln for ln in s.getvalue().splitlines() if "(" in ln and "/" in ln]


def phase_batch(streams: dict, dev) -> tuple[list[dict], dict]:
    """The batch-serving paths (j40_tpu_torch/parallel/batch.py) on the
    64-image corpora batch64 and photo64: decode_batch(backend="torch")
    (its fused route), decode_batch_device (both corpora) and
    decode_batch_device_hf (photo64).  Each output must equal the per-image
    backend="torch" decodes exactly and the host plan within 1 level; the
    HF path must equal decode_batch_device exactly; the launch counters,
    zeroed just before each checked call and read just after, must show B1
    once a 16-image chunk and B4 once a kernel call.  Then the times:
    aggregate Mpix/s, the median of 3 warm calls after a 16-image warm-up,
    beside the host-serve yardstick (decode_batch(backend="numpy") and one
    upload of the stacked RGBA to the card, as bench.py:206-216), and one
    profiled call of each device path.  Last, render_rgba8_device on
    configs 3 and 4.  Returns (path records, serving summary)."""
    from j40_tpu_torch.decode import Decoder
    from j40_tpu_torch.ops import kernels as K
    from j40_tpu_torch.parallel import batch as PB

    refs = {}
    for corpus in ("batch64", "photo64"):
        blobs = streams[corpus]
        per_image = np.stack([_decode(b, "torch")[1] for b in blobs])
        host = np.stack(PB.decode_batch(blobs, workers=BATCH_WORKERS, backend="numpy"))
        refs[corpus] = (per_image, host)
    mpix = BATCH_N * BATCH_PX * BATCH_PX / 1e6

    def host_serve(blobs):
        rgba = np.stack(PB.decode_batch(blobs, workers=BATCH_WORKERS, backend="numpy"))
        torch.from_numpy(rgba).to(dev)
        torch.cuda.synchronize()

    records, outs, serving = [], {}, {}
    for path, corpus, fn in BATCH_PATHS:
        blobs = streams[corpus]
        per_image, host = refs[corpus]
        K.reset_launches()
        st: dict = {}
        t0 = time.perf_counter()
        out = batch_call(fn, blobs, dev, st)
        first_s = time.perf_counter() - t0
        launches = dict(K.launches)
        if fn == "decode_batch":
            got = np.stack(out)
        else:
            assert out.device == dev and out.dtype == torch.uint8 and out.is_contiguous()
            got = out.cpu().numpy()
        assert got.shape == per_image.shape, (path, got.shape)
        assert np.array_equal(got, per_image), f"{path}: != the per-image torch decodes"
        diff = int(np.abs(got[..., :3].astype(np.int16) - host[..., :3]).max())
        assert diff <= 1, f"{path}: max|diff| {diff} vs the host plan"
        outs[path] = got
        chunks = -(-BATCH_N // 16)
        want = {"reconstruct_dct8_srgb": chunks}
        if fn == "decode_batch_device_hf":
            # one lane a 256x256 pass group, MAX_LANES (128) lanes a call
            want["hf"] = st["kernel_calls"]
            assert st["kernel_calls"] == -(-BATCH_N * (-(-BATCH_PX // 256)) ** 2 // 128), st
        ran = {k: v for k, v in launches.items() if v}
        assert ran == want, f"{path}: launches {ran}, want {want}"

        # timing: a 16-image warm-up, then the median of 3 warm calls
        batch_call(fn, blobs[:16], dev, {})
        stats_runs = []

        def timed():
            stats_runs.append({})
            batch_call(fn, blobs, dev, stats_runs[-1])

        secs = median_s(timed)
        rec = dict(config=corpus, path=path, backend="torch", images=BATCH_N,
                   size=f"{BATCH_PX}x{BATCH_PX}", launches=launches,
                   first_call_s=first_s, median_s=secs, mpix_s=mpix / secs,
                   max_abs_diff=diff)
        if st:
            mid = sorted(stats_runs, key=lambda x: x["total_s"])[1]
            rec["stats"] = {k: mid[k] for k in ("total_s", "entropy_s", "pack_s",
                                                "upload_bytes", "pack_kind", "lf_s",
                                                "launch_s", "kernel_calls", "ready_s")
                            if k in mid}
            wall, dev_ms, nrec, _ = busy(lambda: batch_call(fn, blobs, dev, {}))
            rec["profile"] = dict(wall_ms=wall, device_busy_ms=dev_ms, records=nrec,
                                  device_idle_share=1 - dev_ms / wall)
            rec["host_cumulative"] = host_profile(lambda: batch_call(fn, blobs, dev, {}))
        records.append(rec)
        print(f"batch path {path} ({BATCH_N} x {BATCH_PX}x{BATCH_PX}, "
              f"{sum(map(len, blobs))} B): {rec['mpix_s']:.2f} Mpix/s (median of 3), "
              f"first call {first_s:.2f} s, launches {ran}, stats {rec.get('stats')}, "
              f"profile {rec.get('profile')}, equal to the per-image torch decodes, "
              f"max|diff| {diff} vs the host plan")
        for ln in rec.get("host_cumulative", []):
            print("  host", ln.strip()[:150])
    assert np.array_equal(outs["photo64/decode_batch_device_hf"],
                          outs["photo64/decode_batch_device"]), "HF path != pack path"

    for corpus in ("batch64", "photo64"):
        blobs = streams[corpus]
        host_serve(blobs[:16])
        hs = median_s(lambda: host_serve(blobs))
        best = max((r for r in records if r["config"] == corpus and "stats" in r),
                   key=lambda r: r["mpix_s"])
        serving[corpus] = dict(host_serve_s=hs, host_serve_mpix_s=mpix / hs,
                               best_device_path=best["path"],
                               serve_speedup_vs_host=hs / best["median_s"])
        print(f"host serve {corpus}: decode_batch(numpy) + one upload "
              f"{mpix / hs:.2f} Mpix/s; serve_speedup_vs_host "
              f"{serving[corpus]['serve_speedup_vs_host']:.3f} ({best['path']})")

    for name in ("config3", "config4"):
        dec = Decoder(streams[name], workers=4, keep_device_output=True)
        dec.decode_frame()
        got = dec.render_rgba8_device()
        assert got.device == dev and got.dtype == torch.uint8
        assert dec.stats["device_output"] == "planes", dec.stats["device_output"]
        assert np.array_equal(got.cpu().numpy(), dec.render_rgba8()), name
        serving[f"render_rgba8_device_{name}"] = dict(
            route="planes", shape=list(got.shape), lf_groups=len(dec._device_planes))
        print(f"render_rgba8_device {name}: {tuple(got.shape)} uint8 on {got.device} from "
              f"{len(dec._device_planes)} LF groups' planes, equal to render_rgba8()")
    return records, serving


def median_s(fn, reps: int = 3) -> float:
    """Median wall seconds of `reps` calls of `fn`."""
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


#: shards of the multi-device paths (phase_sharded): a mesh that repeats
#: the one card, as j40_tpu's tests repeat virtual CPU devices
SHARDS = 8
#: how far a difference at an LF-group border can reach into config 12F's
#: filtered output: gaborish 1 pixel, then the EPF steps 3 + 2 + 1
FILTER_REACH = 7


def mesh_of(dev, n: int, shape=None, axes=("rows",)):
    """A mesh of `n` entries of the one device `dev`."""
    from j40_tpu_torch.parallel.mesh import Mesh

    devs = np.array([dev] * n, dtype=object)
    return Mesh(devs.reshape(shape) if shape else devs, axes)


def lf_border_distance(h: int, w: int, group: int = 2048) -> np.ndarray:
    """(h, w): each pixel's distance to the nearest LF-group border inside
    the image (0 for the pixels on either side of it)."""
    def dist(n):
        i = np.arange(n)
        d = np.full(n, n)
        for b in range(group, n, group):
            d = np.minimum(d, np.where(i < b, b - 1 - i, i - b))
        return d
    return np.minimum(dist(h)[:, None], dist(w)[None, :])


@contextlib.contextmanager
def keep_rows_calls():
    """For the time of the block, FK.gaborish_rows and FK.epf_step_rows keep
    each call's arguments: yields {"gab": [...], "epf": [...]}, in call
    order (a sharded decode runs the EPF steps one after another, each on
    shard 0, 1, ...; so on 8 shards call 8 k + 1 is step k of shard 1)."""
    from j40_tpu_torch.ops import filter_kernels as FK

    captured: dict[str, list] = {"gab": [], "epf": []}

    def keep(fn, name):
        def wrapper(*args):
            captured[name].append(args)
            return fn(*args)
        return wrapper

    orig = FK.gaborish_rows, FK.epf_step_rows
    FK.gaborish_rows, FK.epf_step_rows = keep(orig[0], "gab"), keep(orig[1], "epf")
    try:
        yield captured
    finally:
        FK.gaborish_rows, FK.epf_step_rows = orig


@contextlib.contextmanager
def keep_merge_calls():
    """For the time of the block, the sharded lossless decode's calls of
    S1's wrapper keep their arguments and the launches the call added to
    S1's counter: yields [(down, residu, horizontal, launches), ...] in call
    order (merge after merge, each on shard 0, 1, ...; a shard with no
    chain is called too and launches nothing)."""
    from j40_tpu_torch.ops import kernels as K
    from j40_tpu_torch.parallel import sharded_lossless as SL

    calls: list = []
    orig = SL.unsqueeze

    def keep(down, residu, horizontal):
        before = K.launches["unsqueeze"]
        out = orig(down, residu, horizontal)
        calls.append((down, residu, horizontal, K.launches["unsqueeze"] - before))
        return out

    SL.unsqueeze = keep
    try:
        yield calls
    finally:
        SL.unsqueeze = orig


#: least 32-bit integer operations an S1 pair: SmoothTendency's compares,
#: products and two clamped quotients (~34), the halving and the sums (6)
S1_OPS = 40


def squeeze_model():
    """tools/squeeze_model.py: the CPU model of S1's schedule, whose counts
    the S1 rows report, and the slope -1 ramp."""
    tools = str(Path(__file__).resolve().parent / "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    import squeeze_model

    return squeeze_model


def unsqueeze_row(name: str, down, residu, horizontal: bool, kind_calls: int | None,
                  what: str = "shard 1 of lossless_sq") -> dict:
    """Kernel S1 (csrc/squeeze.cu) against its plain version (the loop over
    column pairs of ops/squeeze_kernels.py, ~44 launches a pair, timed once
    between CUDA events) on one merge (a shard's, as the sharded decode
    hands it over: a column shard is a view), equal bit for bit.  Beside
    the byte bound, a lone chain: the same merge's first chain alone
    (`ns_per_step`: its time over its wr pairs).  `seg` and `convergence`:
    the segment length and the CPU model's counts on the same inputs (the
    share of segments whose two walks met, the longest re-walk, the
    segments walked in full in order, the windows outside the margin, the
    resolve rounds).  `kind_calls`: the path's launches of this axis, or
    None for a probe, which names no path."""
    from j40_tpu_torch.ops import squeeze_kernels as SQ

    got, wanted = SQ.unsqueeze(down, residu, horizontal), []
    plain_ms = event_ms(lambda: wanted.append(SQ.unsqueeze_ref(down, residu, horizontal)))
    assert torch.equal(got, wanted[0]), f"{name}: S1 differs from its plain version"
    ax = 0 if horizontal else 1
    chains, wr = down.shape[ax], residu.shape[1 - ax]
    one = (down[:1], residu[:1]) if horizontal else (down[:, :1], residu[:, :1])
    times = {}
    for key, args in (("ms", (down, residu)), ("chain", one)):
        def run(a=args):
            return SQ.unsqueeze(*a, horizontal)
        t = device_ms(run)
        times[key] = (t, "CUPTI") if t is not None else (queued_ms(run, REPS),
                                                         "queued CUDA events")
    (ms, timer), (chain_ms, chain_timer) = times["ms"], times["chain"]
    model_out, counts = squeeze_model().model_unsqueeze(down.cpu(), residu.cpu(), horizontal)
    assert torch.equal(model_out, got.cpu()), f"{name}: the CPU model differs from S1"
    conv = dict(segments=counts["segments"], met_share=counts["met"] / counts["segments"],
                longest_rewalk=counts["longest_rewalk"], unmet=counts["unmet"],
                margin_windows=counts["margin_windows"], rounds=counts["rounds"])
    b = bound((down.numel() + residu.numel() + got.numel()) * 4, S1_OPS * chains * wr)
    row = dict(
        name=name, counter="unsqueeze", route="cuda", source="j40_tpu_torch/csrc/squeeze.cu",
        replaces="j40_tpu/parallel/sharded_lossless.py:61 (its lax.scan at :91)",
        shape=f"down {tuple(down.shape)} + residu {tuple(residu.shape)} int32 of {what} "
              f"({'' if down.is_contiguous() else 'non-'}contiguous) -> "
              f"{tuple(got.shape)}, {'horizontal' if horizontal else 'vertical'}",
        max_abs_err=0, ms=ms, timer=timer, plain_ms=plain_ms, plain_timer="CUDA events",
        library_ms=None, library=None, bound_ms=b[0], bound_by=b[1], steps=wr,
        chain_ms=chain_ms, chain_timer=chain_timer, ns_per_step=chain_ms * 1e6 / wr,
        seg=counts["seg"], convergence=conv)
    if kind_calls is not None:
        row.update(paths=["lossless_sq/sharded8"], kind_calls=kind_calls)
    print(f"{'kernel' if kind_calls is not None else 'probe'} {name} [{row['shape']}]: {ms:.4f} ms ({timer}), a lone chain of {wr} "
          f"pairs {chain_ms:.4f} ms ({chain_timer}; {row['ns_per_step']:.1f} ns a pair), "
          f"plain {plain_ms:.1f} ms (one call, CUDA events), bound {b[0]:.4f} ms ({b[1]}); "
          f"segments of {counts['seg']}: {conv}; equal to the plain version and the model")
    return row


def sharded_record(path: str, run, want: dict, reps: int, single) -> tuple[dict, object]:
    """One multi-device path: the launch counters zeroed just before a
    first (checked) call of `run` and read just after, which must equal
    `want`; then Mpix/s over `reps` more calls (the first call's time when
    reps is 0) beside `single`'s, the single-device decode of the same
    stream(s) (median of 3).  Returns (record, the first call's output)."""
    from j40_tpu_torch.ops import kernels as K

    K.reset_launches()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(K.launches)
    ran = {k: v for k, v in launches.items() if v}
    assert ran == want, f"{path}: launches {ran}, want {want}"
    secs = median_s(run, reps) if reps else first_s
    return dict(path=path, launches=launches, first_call_s=first_s,
                seconds=secs, timed_calls=reps or 1, single_s=median_s(single)), out


def phase_sharded(streams: dict, dev) -> tuple[list[dict], list[dict], dict, list[dict]]:
    """The multi-device paths (j40_tpu_torch/parallel/{sharded_decode,
    sharded_lossless,sharded_entropy}.py) on meshes that repeat the card
    (mesh_of), each checked: config 12F with the filters on 8 shards (equal
    within 1 level to the same call on 1 shard, and to the single-device
    filtered decode except near an LF-group border, where the single-device
    plan filters each group apart), config 4 on 4 shards (group-aligned:
    the mixed classes computed in the shards) and on 8 (the overlay),
    config 3 on 8, decode_sharded_batch of 16 batch64 images on a (2, 4)
    mesh, each within 1 level of the single-device decode; the Squeeze+RCT
    lossless stream on 8 shards and shent_1024's per-shard entropy decode
    (B6 and W1 once a shard), bit-exact with the host plan;
    dryrun_multichip(8).
    The launch counters are zeroed just before each path's checked call and
    read just after.  Kernel rows: B7's and B9's rows entries on an
    interior shard of config 12F (the stripes captured from its checked
    call), B6 on one shard's lanes of shent_1024, S1 on shard 1's widest
    merges of lossless_sq; S1 on the slope -1 ramp as a probe.  Returns
    (path records, kernel rows, the dry run's result, the probes)."""
    import torch.nn.functional as Fn

    from j40_tpu_torch import decode_file
    from j40_tpu_torch.graft_entry import dryrun_multichip
    from j40_tpu_torch.ops import filter_kernels as FK
    from j40_tpu_torch.parallel import sharded_decode as SD
    from j40_tpu_torch.parallel import sharded_entropy as SE
    from j40_tpu_torch.parallel.sharded_lossless import decode_sharded_lossless, squeeze_merges

    mesh8 = mesh_of(dev, SHARDS)
    records, rows = [], []

    def report(rec, cfg, size, mpix, diff, **extra):
        rec.update(config=cfg, size=size, mpix_s=mpix / rec["seconds"],
                   single_device_mpix_s=mpix / rec["single_s"], max_abs_diff=diff, **extra)
        records.append(rec)
        ran = {k: v for k, v in rec["launches"].items() if v}
        print(f"sharded path {rec['path']} ({size}): {rec['mpix_s']:.2f} Mpix/s (median of "
              f"{rec['timed_calls']}), single device {rec['single_device_mpix_s']:.2f} "
              f"Mpix/s, first call {rec['first_call_s']:.2f} s, launches {ran}, max|diff| "
              f"{diff}{''.join(f', {k} {v}' for k, v in extra.items())}")

    # config 12F with the filters: B2, B9 rows, B7 rows (3 steps) and B3
    # once a shard; the stripes of shard 1 are kept for the kernel rows
    data = streams["config12f"]
    _, single = _decode(data, "torch", filters=True)
    with keep_rows_calls() as captured:
        rec, out = sharded_record(
            "config12f/sharded8+filters",
            lambda: SD.decode_sharded(data, mesh=mesh8, apply_filters=True),
            {"reconstruct_dct8": 8, "gaborish_rows": 8, "epf_step_rows": 24,
             "xyb_to_srgb": 8}, 3, lambda: _decode(data, "torch", filters=True))
    gab_args = captured["gab"][1]
    # the first (counted) call's 24 EPF launches: each step kind's count,
    # and its launch on shard 1
    first = captured["epf"][:rec["launches"]["epf_step_rows"]]
    kind_calls = {k: sum(a[3] == k for a in first) for k in range(3)}
    epf_by_kind = [first[SHARDS * k + 1] for k in range(3)]
    assert [a[3] for a in epf_by_kind] == [0, 1, 2], [a[3] for a in epf_by_kind]
    one = SD.decode_sharded(data, mesh=mesh_of(dev, 1), apply_filters=True)
    one_diff = int(np.abs(out.astype(np.int16) - one).max())
    assert one_diff <= 1, f"config12f: 8 shards against 1 shard: {one_diff}"
    d = np.abs(out.astype(np.int16) - single[:, :, :3]).max(-1)
    dist = lf_border_distance(*d.shape)
    far = int(d[dist >= FILTER_REACH].max())
    assert far <= 1, f"config12f: {far} levels from the single-device decode"
    band = dict(within_3px=int((dist < 3).sum()), max_diff_within_3px=int(d[dist < 3].max()),
                over_1_beyond_3px=int((d[dist >= 3] > 1).sum()),
                max_diff_3_to_7px=int(d[(dist >= 3) & (dist < FILTER_REACH)].max()),
                max_diff_beyond_7px=far)
    wall, busy_ms, nrec, _ = busy(lambda: SD.decode_sharded(data, mesh=mesh8, apply_filters=True))
    rec["profile"] = dict(wall_ms=wall, device_busy_ms=busy_ms, records=nrec,
                          device_idle_share=1 - busy_ms / wall)
    rec["host_cumulative"] = host_profile(
        lambda: SD.decode_sharded(data, mesh=mesh8, apply_filters=True))
    report(rec, "config12f", "4096x3072", 4096 * 3072 / 1e6, one_diff,
           one_shard_diff=one_diff, lf_border=band, profile=rec["profile"])
    for ln in rec["host_cumulative"]:
        print("  host", ln.strip()[:150])

    # config 4 (filters off): 4 shards group-aligned, 8 shards the overlay;
    # config 3 on 8 shards
    for cfg, n, mode in (("config4", 4, "mixed_compute"), ("config4", SHARDS, "overlay"),
                         ("config3", SHARDS, None)):
        data = streams[cfg]
        _, ref = _decode(data, "torch")
        mesh = mesh_of(dev, n)
        plan = SD.plan_frame(data, owners=n)
        rec, out = sharded_record(
            f"{cfg}/sharded{n}", lambda: SD._run_sharded([plan], mesh, ("rows",), False)[0],
            {"reconstruct_dct8": n, "xyb_to_srgb": n}, 0, lambda: _decode(data, "torch"))
        got_mode = None if not plan.classes else "overlay" if plan.overlay is not None             else "mixed_compute"
        assert got_mode == mode, f"{cfg}/sharded{n}: {got_mode}, want {mode}"
        diff = int(np.abs(out.astype(np.int16) - ref[:, :, :3]).max())
        assert diff <= 1, f"{cfg}/sharded{n}: max|diff| {diff}"
        rec["seconds"] = median_s(lambda: SD.decode_sharded(data, mesh=mesh,
                                                             apply_filters=False))
        rec["timed_calls"] = 3
        w, h = (4096, 3072) if cfg == "config4" else (1024, 1024)
        report(rec, cfg, f"{w}x{h}", w * h / 1e6, diff, mode=mode)

    # decode_sharded_batch: 16 batch64 images on a (2, 4) ("img", "rows") mesh
    blobs = streams["batch64"][:16]
    refs = [decode_file(b, workers=4)[1] for b in blobs]
    rec, outs = sharded_record(
        "batch64/sharded_batch(2x4)",
        lambda: SD.decode_sharded_batch(blobs, mesh_of(dev, 8, (2, 4), ("img", "rows")),
                                        apply_filters=False),
        {"reconstruct_dct8": 64, "xyb_to_srgb": 64}, 3,
        lambda: [decode_file(b, workers=4) for b in blobs])
    diff = max(int(np.abs(o.astype(np.int16) - r[:, :, :3]).max()) for o, r in zip(outs, refs))
    assert diff <= 1, f"sharded batch: max|diff| {diff}"
    report(rec, "batch64", f"16 x {BATCH_PX}x{BATCH_PX}", 16 * BATCH_PX ** 2 / 1e6, diff)

    # lossless Squeeze + RCT on 8 shards: bit-exact with the host plan, S1
    # once a (merge, shard) that holds a chain, as the stream's transforms
    # give it; each merge axis's launches read off the counter call by call
    # in the counted decode, and shard 1's inputs of each merge kept for
    # the kernel rows
    data = streams["lossless_sq"]
    _, ref = _decode(data, "numpy")
    merges = squeeze_merges(data)
    want = {h: sum(min(c, SHARDS) for x, c, _ in merges if x == h) for h in (True, False)}
    with keep_merge_calls() as merge_calls:
        rec, out = sharded_record("lossless_sq/sharded8",
                                  lambda: decode_sharded_lossless(data, mesh=mesh8),
                                  {"unsqueeze": sum(want.values())}, 3,
                                  lambda: _decode(data, "torch"))
    assert np.array_equal(out, ref), "sharded lossless != host plan"
    counted = merge_calls[:SHARDS * len(merges)]  # the counted decode's calls
    assert sum(c[3] for c in counted) == rec["launches"]["unsqueeze"]
    axis_launches = {h: sum(c[3] for c in counted if c[2] == h) for h in (True, False)}
    assert axis_launches == want, f"lossless_sq: S1 launches {axis_launches}, want {want}"
    wall, busy_ms, nrec, s1_ms = busy(lambda: decode_sharded_lossless(data, mesh=mesh8),
                                      "unsqueeze_")
    rec["profile"] = dict(wall_ms=wall, device_busy_ms=busy_ms, records=nrec,
                          device_idle_share=1 - busy_ms / wall, s1_busy_ms=s1_ms)
    report(rec, "lossless_sq", "1024x1024", 1024 * 1024 / 1e6, 0, merges=len(merges),
           profile=rec["profile"])

    # per-shard entropy decode of shent_1024: B6 and W1 once a shard
    data = streams["shent_1024"]
    rec, (planes, lanes, dec) = sharded_record(
        "shent_1024/sharded8", lambda: SE.decode_modular_sections_sharded(data, mesh8),
        {"tokens": SHARDS, "wavefront": SHARDS}, 0, lambda: _decode(data, "device"))
    gm = dec._deferred[2].gmodular
    for k, ln in enumerate(lanes):
        for c, (gi, x0, y0, w, h) in enumerate(ln.picks):
            assert np.array_equal(planes[k, c], gm.channels[gi].data[y0:y0 + h, x0:x0 + w]), \
                f"shent_1024: section {k} channel {c} differs from the host"
    report(rec, "shent_1024", "1024x1024", 1024 * 1024 / 1e6, 0, sections=len(lanes))

    # the dry run: every leg of graft_entry.dryrun_multichip on 8 shards
    from j40_tpu_torch.ops import kernels as K

    K.reset_launches()
    t0 = time.perf_counter()
    dry = dryrun_multichip(SHARDS)
    dry.update(seconds=time.perf_counter() - t0,
               launches={k: v for k, v in K.launches.items() if v})
    print(f"dryrun_multichip({SHARDS}): {dry}")
    assert dry["launches"].get("unsqueeze"), "dryrun_multichip's lossless leg launched no S1"

    # kernel rows: B9's and B7's rows entries at config 12F's shard shape
    # (B9 first: the plain EPF step's ~340 records a call make CUPTI lose
    # records in the next sessions)
    stripe, gab = gab_args
    got = FK.gaborish_rows(*gab_args)
    err = (got - FK.gaborish_rows_ref(*gab_args)).abs().max().item()
    assert err <= XYB_ATOL, f"gaborish_rows disagrees: {err}"
    taps = []
    for w1, w2 in gab:
        s_ = 1.0 + 4 * w1 + 4 * w2
        taps.append([[w2 / s_, w1 / s_, w2 / s_], [w1 / s_, 1.0 / s_, w1 / s_],
                     [w2 / s_, w1 / s_, w2 / s_]])
    wt = torch.tensor(taps, dtype=torch.float32, device=dev)[:, None]

    def conv():
        return Fn.conv2d(Fn.pad(stripe[None], (1, 1, 0, 0), mode="replicate"), wt,
                         groups=3)[0]

    assert (conv() - got).abs().max().item() <= XYB_ATOL
    b = bound((stripe.numel() + got.numel()) * 4 + 9 * 4, 17 * got.numel())
    rows.append(dict(
        name="gaborish_rows", counter="gaborish_rows", route="cuda",
        source="j40_tpu_torch/csrc/filters.cu",
        replaces="j40_tpu/ops/pallas_filters.py:161 (for sharded_filters._gaborish_rows)",
        shape=f"{tuple(stripe.shape)} f32 stripe of shard 1 of config 12F -> "
              f"{tuple(got.shape)}", max_abs_err=err,
        **row_times(lambda: FK.gaborish_rows(*gab_args), lambda: FK.gaborish_rows_ref(*gab_args),
                    conv),
        bound_ms=b[0], bound_by=b[1],
        library="F.conv2d depthwise 3x3 on a column-replicate pad (TF32 off)",
    ))
    for epf_args in epf_by_kind:
        stripe, rs8, _, kind = epf_args[:4]
        got = FK.epf_step_rows(*epf_args)
        err = (got - FK.epf_step_rows_ref(*epf_args)).abs().max().item()
        assert err <= XYB_ATOL, f"epf_step_rows kind {kind} disagrees: {err}"
        _, H, W = got.shape
        b = bound((stripe.numel() + got.numel() + rs8.numel()) * 4,
                  epf_ops(active_pixels(rs8, H, W), [kind]))
        t = row_times(lambda a=epf_args: FK.epf_step_rows(*a),
                      lambda a=epf_args: FK.epf_step_rows_ref(*a))
        rows.append(dict(
            name=f"epf_step_rows_k{kind}", counter="epf_step_rows", route="cuda",
            source="j40_tpu_torch/csrc/filters.cu",
            replaces="j40_tpu/ops/pallas_filters.py:82 (via epf_step_pallas_rows, :274)",
            shape=f"{tuple(stripe.shape)} f32 stripe of shard 1 of config 12F -> "
                  f"{tuple(got.shape)}, step kind {kind}", max_abs_err=err,
            **t, ns_per_pixel=t["ms"] * 1e6 / (H * W), kind_calls=kind_calls[kind],
            bound_ms=b[0], bound_by=b[1], library=None,
        ))
    _print_rows(rows)
    # B6 on one shard's lanes of shent_1024 (8 sections of 49,152 symbols)
    per = -(-len(lanes) // SHARDS)
    tok = token_row("tokens_shard", "shent_1024", lanes[:per], dev)
    tok["paths"] = ["shent_1024/sharded8"]
    rows.append(tok)
    # S1 on shard 1's widest horizontal and widest vertical merge of
    # lossless_sq (the first, counted call's arguments: a call a shard)
    for kind, horizontal in (("h", True), ("v", False)):
        m = max((i for i, x in enumerate(merges) if x[0] == horizontal),
                key=lambda i: merges[i][2])
        down, residu = counted[SHARDS * m + 1][:2]
        rows.append(unsqueeze_row(f"unsqueeze_{kind}", down, residu, horizontal,
                                  axis_launches[horizontal]))
        if horizontal:
            ramp_shape = (down.shape[0], down.shape[1], residu.shape[1])
    # off the kernels line (the same kernel on content the path never
    # gives it): the input no segment meets on, at the widest horizontal
    # merge's shape, the slope -1 ramp with zero residuals
    down, residu = (torch.from_numpy(a).to(dev) for a in
                    squeeze_model().ramp(True, *ramp_shape))
    probes = [unsqueeze_row("unsqueeze_ramp", down, residu, True, None,
                            "the slope -1 ramp, zero residuals")]
    paths = [r["path"] for r in records]
    for r in rows[:4]:
        r["paths"] = paths
    return records, rows, dry, probes


def batch_kernel_rows(streams: dict, dev) -> list[dict]:
    """B1 at the batch paths' chunk shape (16 batch64 images stacked: n =
    65,536 blocks -> (3, 8192, 512) u8) and B4 on one 128-lane multi-spec
    call of photo64 (32 images' sections, each image's own rANS spec), each
    checked and timed as the main path's rows are."""
    from j40_tpu_torch.decode import Decoder
    from j40_tpu_torch.native.bindings import serialize_spec
    from j40_tpu_torch.ops import hf_kernels as HK
    from j40_tpu_torch.ops import kernels as K
    from j40_tpu_torch.parallel import batch as PB

    paths = [p for p, _, _ in BATCH_PATHS]
    decs = []
    for b in streams["batch64"][:16]:
        d = Decoder(b, device=dev)
        d.decode_frame(_defer_finish=True)
        decs.append(d)
    plans = [PB._plan_uniform_packed(d) for d in decs]
    h8, w8 = PB._plans_match(plans, decs)
    kind, cup, exc_idx, exc_val, aux, kgrids = PB._assemble_chunk(plans, 16, h8 * w8, h8, w8)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    cup_d = K.unpack_i4(t(cup), (3, 16 * h8 * w8, 64)) if kind == "i4" else t(cup)
    dense = K.unpack_i8(cup_d, t(exc_idx), t(exc_val))
    a = (dense, PB._expand_aux(t(aux), t(kgrids), h8, w8),
         t(np.asarray(plans[0][2], np.float32)), t(plans[0][3]), 16 * h8, w8)
    got = K.reconstruct_dct8_srgb(*a, True)
    err = (got.int() - K.reconstruct_dct8_srgb_ref(*a, True).int()).abs().max().item()
    assert err <= 1, f"reconstruct_dct8_srgb at the chunk shape disagrees: {err}"
    n = 16 * h8 * w8
    kt = torch.from_numpy(K.idct8_matrix()).to(dev).T.contiguous()
    flat = dense.reshape(-1, 64)
    b = bound(dense.numel() * 4 + a[1].numel() * 4 + 64 * 3 * 4 + 64 * 4 + 22 * 4
              + got.numel(), dct8_ops(n, True))
    rows = [dict(
        name="reconstruct_dct8_srgb_chunk", counter="reconstruct_dct8_srgb", paths=paths,
        route="cuda", source="j40_tpu_torch/csrc/reconstruct.cu",
        replaces="j40_tpu/ops/pallas_kernels.py:171",
        shape=f"n={n} blocks (16 images of batch64, {kind} upload) -> "
              f"{tuple(got.shape)} u8", max_abs_err=float(err),
        **row_times(lambda: K.reconstruct_dct8_srgb(*a, True),
                    lambda: K.reconstruct_dct8_srgb_ref(*a, True),
                    lambda: torch.matmul(flat, kt)),
        ms_events=event_ms(lambda: K.reconstruct_dct8_srgb(*a, True), 20),
        bound_ms=b[0], bound_by=b[1],
        library="torch.matmul (3n,64)x(64,64): the IDCT step alone",
    )]
    _print_rows(rows)

    pes = []
    for blob in streams["photo64"]:
        d = Decoder(blob, backend="numpy", max_passes=0)
        d.decode_frame(_defer_finish=True)
        pe = PB._hf_plan(d)
        if sum(len(x["lanes"]) for x in pes) + len(pe["lanes"]) > HK.MAX_LANES:
            break
        pes.append(pe)
    nlanes = sum(len(pe["lanes"]) for pe in pes)
    assert nlanes == HK.MAX_LANES or len(pes) == len(streams["photo64"]), nlanes
    assert not any(pe["spec"].use_prefix_code for pe in pes)
    ncmax = max(max(pe["ncells"]) for pe in pes)
    d = HK.to_device(HK.build_multi_inputs(
        [(pe["streams"], pe["ncells"], pe["spec"], pe["orders"]) for pe in pes]), dev)
    nspecs = len({serialize_spec(pe["spec"]).tobytes() for pe in pes})

    def launch(ncells_max, **kw):
        return HK.launch_hf(d, ncells_max, **kw)

    rows.append(hf_measure(
        dict(name="hf_ans_multispec", counter="hf", paths=["photo64/decode_batch_device_hf"],
             replaces="j40_tpu/ops/pallas_hf.py:71", specs=nspecs, images=len(pes)),
        f"{nlanes} lanes of {len(pes)} photo64 images ({nspecs} distinct specs)", d,
        launch, HK.DONE_ROW, ncmax, [(pe["vd"], pe["lanes"]) for pe in pes], False,
        False, dev))
    return rows


def _decode(data: bytes, backend: str = "torch", filters: bool = False):
    """decode_file with 4 workers, the restoration filters on or off:
    (decoder, RGBA8)."""
    import j40_tpu_torch

    return j40_tpu_torch.decode_file(data, backend=backend, workers=4, apply_filters=filters)


def phase_main_path(name: str, data: bytes, want: set[str], filters: bool = False,
                    backend: str = "torch", lanes: int | None = None) -> dict:
    """One config decoded on the card, held against the host plan; the
    launch counters are zeroed just before the decode and read just after.
    Under backend="device" the decode must also equal backend="torch"
    exactly and take `lanes` sections on the HF kernels.

    With the filters on a frame of several LF groups, the card filters the
    whole frame and the host plan each LF group apart, mirrored at its
    borders (ROADMAP C.3): the two are held within 1 level only at least
    FILTER_REACH pixels from an LF-group border, the gap nearer the border
    must be that of the host plan's mirroring (more than 1 level), and the
    whole frame is held within 1 level of the sharded plan on one shard,
    which filters the whole frame as the format does."""
    from j40_tpu_torch.ops import kernels as K
    from j40_tpu_torch.parallel import sharded_decode as SD

    _, ref = _decode(data, "numpy", filters)
    if backend == "device":
        _, torch_rgba = _decode(data, "torch", filters)
    K.reset_launches()
    dec, rgba = _decode(data, backend, filters)
    launches = dict(K.launches)
    assert rgba.shape == ref.shape and rgba.dtype == np.uint8
    d = np.abs(rgba[:, :, :3].astype(np.int16) - ref[:, :, :3]).max(-1)
    seam = {}
    if filters and dec.stats["num_lf_groups"] > 1:
        dist = lf_border_distance(*d.shape)
        diff = int(d[dist >= FILTER_REACH].max())
        one = SD.decode_sharded(data, mesh=mesh_of(dec.device, 1), apply_filters=True)
        seam = dict(host_plan_max_diff_near_borders=int(d[dist < FILTER_REACH].max()),
                    one_shard_max_diff=int(np.abs(rgba[:, :, :3].astype(np.int16) - one).max()))
        assert seam["host_plan_max_diff_near_borders"] > 1, \
            f"{name}: the host plan's LF-group seam is gone: {seam}"
        assert seam["one_shard_max_diff"] <= 1, f"{name}: against the sharded plan: {seam}"
    else:
        diff = int(d.max())
    assert diff <= 1, f"{name}: max|diff| {diff} vs the host plan"
    assert (rgba[:, :, 3] == 255).all()
    ran = {k for k, v in launches.items() if v}
    assert want <= ran, f"{name}: launches {launches}, want {sorted(want)}"
    if backend == "device":
        assert np.array_equal(rgba, torch_rgba), f"{name}: device route != torch"
        hf = dec.stats["device_vardct"]
        assert hf["lanes"] == lanes, f"{name}: {hf} against {lanes} eligible sections"

    def mpix(backend):
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            _decode(data, backend, filters)
            ts.append(time.perf_counter() - t0)
        return rgba.shape[0] * rgba.shape[1] / 1e6 / statistics.median(ts)

    out = dict(
        config=name, backend=backend, path=f"{name}/{backend}" + ("+filters" * filters),
        filters=filters, size=f"{rgba.shape[1]}x{rgba.shape[0]}",
        stream_bytes=len(data), lf_groups=dec.stats["num_lf_groups"],
        launches=launches, max_abs_diff=diff, **seam, mpix_s=mpix(backend),
        host_plan_mpix_s=mpix("numpy"),
        stages_s={k: dec.stats[k] for k in
                  ("headers_s", "sections_s", "reconstruct_s", "total_s")},
    )
    if backend == "device":
        out["device_vardct"] = dict(dec.stats["device_vardct"])
        out["torch_mpix_s"] = mpix("torch")
    # PERF.md's target, not yet met and not a gate: the card path at least
    # as fast as the host plan on the same machine
    out["target_met"] = out["mpix_s"] >= out["host_plan_mpix_s"]
    torch_rate = (f", torch path {out['torch_mpix_s']:.2f} Mpix/s, HF route "
                  f"{out['device_vardct']}" if backend == "device" else "")
    print(f"main path {name}{' with filters' if filters else ''}, backend={backend} "
          f"({out['size']}, {out['lf_groups']} LF groups, "
          f"{len(data)} B): {out['mpix_s']:.2f} Mpix/s on the card (median of "
          f"3){torch_rate}, host plan {out['host_plan_mpix_s']:.2f} Mpix/s, target_met "
          f"{out['target_met']}, launches "
          f"{launches}, max|diff| {diff}{''.join(f', {k} {v}' for k, v in seam.items())}, "
          f"first decode stages {out['stages_s']}")
    return out


def gather_ab(name: str, data: bytes) -> dict:
    """The host gather of each all-DCT8 LF group of a stream, as
    `lf_group_inputs` makes it (one native pass, combine.gather_pack_dct8_i8)
    and as it made it before (the numpy gather, combine.gather_full_dct8,
    then combine._pack_i8; byte-equal, tests/test_torch_combine.py): the
    median of 5 host calls of each, in turns, on this machine's CPU."""
    from j40_tpu_torch.decode import Decoder
    from j40_tpu_torch.ops import combine as C

    dec = Decoder(data, backend="numpy")
    dec.decode_frame(_defer_finish=True)
    f, _toc, st = dec._deferred
    vs = st.vardct
    groups = [gg for gg in vs.lf_groups.values()
              if ((np.asarray(gg.blocks) >> 20) == 2).all()]
    native, numpy_ = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        for gg in groups:
            C.lf_group_inputs(vs, gg, st.im)
        native.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        for gg in groups:
            C._pack_i8(C.gather_full_dct8(vs, gg, st.im, f)[0])
        numpy_.append(time.perf_counter() - t0)
    out = dict(config=name, dct8_groups=len(groups), native_s=statistics.median(native),
               numpy_s=statistics.median(numpy_))
    print(f"host gather {name} ({len(groups)} all-DCT8 LF groups): lf_group_inputs "
          f"(native) {out['native_s'] * 1e3:.1f} ms, numpy gather + _pack_i8 "
          f"{out['numpy_s'] * 1e3:.1f} ms (median of 5)")
    return out


def phase_profile(name: str, data: bytes, filters: bool = False,
                  backend: str = "torch", cpu_events: bool = True,
                  warm: bool = True) -> dict:
    """Where one warm decode's time goes: device time by kernel and copy
    (torch.profiler, CUPTI) against the wall time, and the host functions
    by cumulative time (cProfile, a separate decode: it slows Python).
    `cpu_events=False` records the device activity alone; `warm=False`
    skips the warm-up decode (for a stream the main path decoded)."""
    import cProfile
    import io
    import pstats

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from j40_tpu_torch.ops import kernels as K

    if warm:
        _decode(data, backend, filters)
    acts = [ProfilerActivity.CPU] * cpu_events + [ProfilerActivity.CUDA]
    # a session with fewer records of the port's kernels than the decode's
    # counted launches lost some (config 3's torch path recorded none in one
    # run): it is profiled again, up to three times in all, as device_ms
    # does, and where all three lose some (hf_ctx_2048's device route lost
    # its B5 launch in every session of two runs) the device busy time is
    # not measured
    for sessions in range(1, 4):
        with profile(activities=acts) as prof:
            # a session may lose its first device records (one of config
            # 4's two HF launches, in three runs)
            settle()
            K.reset_launches()
            t0 = time.perf_counter()
            _decode(data, backend, filters)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        launched = sum(K.launches.values())
        by_name: dict = {}  # name -> [device us, records]
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and SETTLE_KERNEL not in e.name:
                rec = by_name.setdefault(e.name, [0.0, 0])
                rec[0] += e.time_range.end - e.time_range.start
                rec[1] += 1
        # the port's kernels all sit at the top of an unnamed namespace of
        # csrc/ (PyTorch's own sit in at::, some in unnamed namespaces there)
        own = sum(n for k, (_, n) in by_name.items()
                  if k.startswith(("(anonymous namespace)::", "void (anonymous namespace)::")))
        complete = bool(by_name) and own >= launched
        if complete:
            break
    device_us = sum(us for us, _ in by_name.values())
    top_device = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]

    pr = cProfile.Profile()
    pr.enable()
    _decode(data, backend, filters)
    pr.disable()
    s = io.StringIO()
    ps = pstats.Stats(pr, stream=s)
    ps.sort_stats("cumulative").print_stats(18)
    host = [ln for ln in s.getvalue().splitlines() if "(" in ln and "/" in ln]
    # the host gather of the reconstruction inputs (PERF.md bottleneck 2)
    gather_s = sum(v[3] for k, v in ps.stats.items() if k[2] == "lf_group_inputs")
    out = dict(config=name, backend=backend, wall_ms=wall_us / 1e3, sessions=sessions,
               counted_launches=launched, kernel_records=own, lf_group_inputs_s=gather_s,
               device_records=sum(n for _, n in by_name.values()),
               device_busy_ms=device_us / 1e3 if complete else None,
               device_idle_share=1 - device_us / wall_us if complete else None,
               top_device_ms=[(k[:80], us / 1e3, n) for k, (us, n) in top_device],
               host_cumulative=host)
    busy = (f"device busy {device_us / 1e3:.3f} ms in {out['device_records']} records, "
            f"idle share {out['device_idle_share']:.4f}" if complete
            else f"device busy not measured (the profiler lost records: "
                 f"{out['device_records']} kept)")
    print(f"profile {name}, backend={backend}: wall {wall_us / 1e3:.1f} ms, {busy} "
          f"(profiler sessions {sessions}; records of the port's kernels {own} for "
          f"{launched} counted launches); lf_group_inputs {gather_s * 1e3:.1f} ms "
          f"cumulative under cProfile")
    for k, v, n in out["top_device_ms"]:
        print(f"  device {v:9.3f} ms in {n:3d} records  {k}")
    for ln in host:
        print("  host", ln.strip()[:150])
    return out


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int = 4) -> np.ndarray:
    """PNG scanlines (h rows of a filter byte and `stride` bytes) to the
    (h, stride) uint8 samples, filter types 0-4 (PNG spec §9)."""
    rows = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ft, cur = int(rows[y, 0]), rows[y, 1:]
        if ft == 0:
            line = cur
        elif ft == 1:  # Sub: a running sum along each channel
            line = np.cumsum(cur.reshape(-1, bpp), axis=0, dtype=np.uint8).ravel()
        elif ft == 2:  # Up
            line = cur + prev
        elif ft in (3, 4):  # Average, Paeth: a byte at a time
            c, b = cur.tolist(), prev.tolist()
            line_l = [0] * stride
            for x in range(stride):
                a = line_l[x - bpp] if x >= bpp else 0
                if ft == 3:
                    pred = (a + b[x]) >> 1
                else:
                    ul = b[x - bpp] if x >= bpp else 0
                    p = a + b[x] - ul
                    pa, pb, pc = abs(p - a), abs(p - b[x]), abs(p - ul)
                    pred = a if pa <= pb and pa <= pc else (b[x] if pb <= pc else ul)
                line_l[x] = (c[x] + pred) & 255
            line = np.array(line_l, np.uint8)
        else:
            raise ValueError(f"PNG row {y}: filter type {ft}")
        out[y] = prev = line
    return out


def read_png(path) -> tuple[list[np.ndarray], list[float], int | None]:
    """An 8-bit RGBA PNG or APNG, non-interlaced, each APNG frame the whole
    canvas (the CLI's own output; no Pillow on the card machine): (frames
    as (h, w, 4) uint8, delays in ms, loop count), the delays and loops
    empty and None for a still PNG."""
    import struct
    import zlib

    buf = Path(path).read_bytes()
    assert buf[:8] == b"\x89PNG\r\n\x1a\n", f"{path}: not a PNG"
    pos, frames, delays, loops, z = 8, [], [], None, []
    w = h = 0

    def flush():
        if z:
            raw = np.frombuffer(zlib.decompress(b"".join(z)), np.uint8)
            frames.append(_unfilter(raw, h, w * 4).reshape(h, w, 4))
            z.clear()

    while pos < len(buf):
        n, kind = struct.unpack(">I4s", buf[pos:pos + 8])
        body = buf[pos + 8:pos + 8 + n]
        crc = struct.unpack(">I", buf[pos + 8 + n:pos + 12 + n])[0]
        assert zlib.crc32(kind + body) == crc, f"{path}: bad CRC in {kind}"
        pos += 12 + n
        if kind == b"IHDR":
            w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", body)
            assert (depth, ctype, interlace) == (8, 6, 0), f"{path}: not 8-bit RGBA"
        elif kind == b"acTL":
            loops = struct.unpack(">II", body)[1]
        elif kind == b"fcTL":
            flush()
            _, fw, fh, x0, y0, num, den = struct.unpack(">IIIIIHH", body[:24])
            assert (fw, fh, x0, y0) == (w, h, 0, 0), f"{path}: a partial frame"
            delays.append(num * 1000.0 / (den or 100))
        elif kind == b"IDAT":
            z.append(body)
        elif kind == b"fdAT":
            z.append(body[4:])
        elif kind == b"IEND":
            flush()
    return frames, delays, loops


#: the animation of phase_cli: frames of a random walk, (durations in
#: ticks), tps and loop count
CLI_ANIM = dict(durations=(2, 3, 1), tps=(10, 1), num_loops=2, side=64)


def cli_animation() -> tuple[bytes, list[int], int]:
    """A small animation from the port's encode_animation: (stream, the
    delays in ms the CLI writes, loops)."""
    from j40_tpu_torch.encode.encoder import encode_animation

    a = CLI_ANIM
    frames = [(_test_image(a["side"], a["side"], seed=40 + i), d)
              for i, d in enumerate(a["durations"])]
    data = encode_animation(frames, tps=a["tps"], num_loops=a["num_loops"])
    ms = 1000.0 * a["tps"][1] / a["tps"][0]
    return data, [max(1, int(d * ms)) for d in a["durations"]], a["num_loops"]


def cli_trace_records(trace_dir: Path) -> tuple[int, int]:
    """The newest trace of `trace_dir`: (records of the port's kernels,
    records of B1, dct8_kernel).  The port's kernels sit at the top of an
    unnamed namespace of csrc/, as phase_profile counts them."""
    newest = max(trace_dir.glob("*.pt.trace.json"), key=lambda p: p.stat().st_mtime)
    events = json.loads(newest.read_text())["traceEvents"]
    own = [e["name"] for e in events if e.get("cat") == "kernel"
           and e.get("name", "").startswith(("(anonymous namespace)::",
                                             "void (anonymous namespace)::"))]
    return len(own), sum("dct8_kernel" in n for n in own)


def phase_cli(streams: dict, mains: list[dict]) -> list[dict]:
    """The command-line decoder, `python -m j40_tpu_torch`, each run a fresh
    process on the card (CUDA context, library load and first launches
    included), on the streams the earlier phases encoded, written into
    build/cli/: config 3 on the default backend under --profile (the
    trace must hold B1's records; a session that lost them is run again,
    up to three in all) and again without it, config 4 with --backend
    device, config 12F with --filters, an animation with --all-frames to
    APNG, and --info.  Each
    PNG must equal the in-process decode of the same stream on the card;
    each run's time stands beside phase 4's warm decode of its stream."""
    import re
    import shutil

    from j40_tpu_torch.decode import Decoder, decode_animation

    root = Path(__file__).resolve().parent
    out_dir = root / "build" / "cli"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    anim, anim_delays, anim_loops = cli_animation()
    blobs = dict(streams, animation=anim)
    warm = {m["path"]: m["mpix_s"] for m in mains if "path" in m}
    torch.cuda.empty_cache()  # the CLI's process has its own context

    def run(name, args, out):
        src = out_dir / f"{name}.jxl"
        src.write_bytes(blobs[name])
        cmd = [sys.executable, "-m", "j40_tpu_torch", str(src), *([str(out)] if out else []),
               *args]
        t0 = time.perf_counter()
        r = subprocess.run(cmd, cwd=root, capture_output=True, text=True, timeout=300)
        wall = time.perf_counter() - t0
        assert r.returncode == 0, f"{' '.join(cmd)}: rc {r.returncode}\n{r.stderr[-3000:]}"
        m = re.search(r"^decoded in .*$", r.stderr, re.M)
        return r, wall, m.group(0) if m else None

    cases = [
        ("config3", "torch", ["--time", "--stats"], "config3/torch"),
        # the same run without the profiler: the cold time of the plain CLI
        ("config3", "torch", ["--time"], "config3/torch"),
        ("config4", "device", ["--backend", "device", "--time", "--stats"], "config4/device"),
        ("config12f", "torch", ["--filters", "--time"], "config12f/torch+filters"),
        ("animation", "torch", ["--all-frames", "--time"], None),
        ("config4", "info", ["--info"], None),
    ]
    rows = []
    for name, backend, args, warm_path in cases:
        rec = dict(stream=name, backend=backend, args=args,
                   warm_mpix_s=warm.get(warm_path), warm_path=warm_path)
        if backend == "info":
            r, wall, _ = run(name, args, None)
            im = Decoder(blobs[name], backend="numpy").image
            assert r.stdout.startswith("JPEG XL bare codestream") and \
                f"image: {im.width}x{im.height}," in r.stdout, r.stdout
            rec.update(wall_s=wall, decoded=None, kernel_records=None)
        elif "--stats" in args and name == "config3":
            trace_dir = out_dir / "trace3"
            for sessions in range(1, 4):
                out = out_dir / f"{name}.png"
                r, wall, line = run(name, args + ["--profile", str(trace_dir)], out)
                own, b1 = cli_trace_records(trace_dir)
                if b1:
                    break
            assert b1, f"config3: no B1 record in {sessions} profiled CLI sessions"
            rec.update(wall_s=wall, decoded=line, kernel_records=own, b1_records=b1,
                       sessions=sessions)
        else:
            out = out_dir / (f"{name}.apng" if name == "animation" else f"{name}.png")
            r, wall, line = run(name, args, out)
            rec.update(wall_s=wall, decoded=line, kernel_records=None)
        if name == "animation":
            _, want = decode_animation(anim)
            got, delays, loops = read_png(out)
            assert len(got) == len(want) == len(CLI_ANIM["durations"]), (len(got), len(want))
            for g, (_, wf) in zip(got, want):
                assert np.array_equal(g, wf), "animation: an APNG frame != decode_animation"
            assert delays == anim_delays and loops == anim_loops, (delays, loops)
        elif backend != "info":
            _, want = _decode(blobs[name], backend, "--filters" in args)
            (got,), _, _ = read_png(out)
            assert np.array_equal(got, want), f"{name}: the CLI's PNG != the in-process decode"
        if rec["decoded"]:
            rec["cli_mpix_s"] = float(re.search(r"\(([0-9.]+) Mpix/s\)", rec["decoded"])[1])
        rows.append(rec)
        warm_s = (f", phase 4 warm decode {rec['warm_mpix_s']:.2f} Mpix/s"
                  if rec["warm_mpix_s"] else "")
        print(f"cli {name} backend={backend} {' '.join(args)}: process wall "
              f"{wall:.2f} s, CLI: {rec['decoded'] or 'no decode'}{warm_s}, "
              f"trace kernel records {rec['kernel_records']}")
    return rows


def phase_example() -> dict:
    """examples/serve_device_torch.py, the serving example, as a fresh
    process on the card: it must exit 0 with the decoded image a CUDA
    tensor assembled from the reconstruction's planes."""
    root = Path(__file__).resolve().parent
    cmd = [sys.executable, str(root / "examples" / "serve_device_torch.py")]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=root, capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    assert r.returncode == 0, f"{' '.join(cmd)}: rc {r.returncode}\n{r.stderr[-3000:]}"
    assert " on cuda" in r.stdout and "(route planes)" in r.stdout, r.stdout
    print(f"example serve_device_torch.py: process wall {wall:.2f} s; {r.stdout.strip()}")
    return dict(wall_s=wall, stdout=r.stdout.strip().splitlines())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    t_start = time.perf_counter()

    def lap(label: str) -> None:
        print(f"[{time.perf_counter() - t_start:.1f} s] {label} done")

    card = phase_card()
    build = phase_build()
    lap("build")
    dev = torch.device("cuda", torch.cuda.current_device())

    t0 = time.perf_counter()
    streams = encode_all()
    print(f"encode: {time.perf_counter() - t0:.1f} s, "
          f"{ {k: len(v) if isinstance(v, bytes) else sum(map(len, v)) for k, v in streams.items()} } bytes")
    inp3 = group_inputs(streams["config3"])
    # with the filters' inputs too: the same arrays plus sigmas and weights
    inp4 = group_inputs(streams["config4"], apply_filters=True)
    inp12 = group_inputs(streams["config12f"], apply_filters=True)
    kinds4 = [g["kind"] for g in inp4]
    print(f"LF groups: config3 {[g['kind'] for g in inp3]}, config4 {kinds4}, "
          f"config12f {[g['kind'] for g in inp12]}")
    assert [g["kind"] for g in inp3] == ["dct8"] and "mixed" in kinds4
    assert [g["kind"] for g in inp12] == ["dct8"] * 4
    skipped = {k: (sum(int((g["filters"]["rs8"] < 0).sum()) for g in inp),
                   sum(g["h8"] * g["w8"] for g in inp))
               for k, inp in (("config4", inp4), ("config12f", inp12))}
    print(f"EPF skips (blocks, of all blocks): {skipped}")
    big4 = next(g for g in inp4 if g["kind"] == "mixed" and g["h8"] * g["w8"] == 65536)
    big12 = next(g for g in inp12 if g["h8"] * g["w8"] == 65536)
    # the device route's lanes (backend="device"): the eligible sections
    hf_cfgs = ("config3", "config4", "hf_ans_2048", "hf_ctx_2048")
    plans = {k: hf_plan(streams[k]) for k in hf_cfgs}
    print(f"device-route lanes: { {k: len(p['lanes']) for k, p in plans.items()} }")
    # the modular device route's lanes: every eligible section, by batch
    mplans = {k: modular_plan(streams[k]) for k in MODULAR}
    print("modular lanes (of sections): "
          f"{ {k: (len(p['lanes']), p['sections']) for k, p in mplans.items()} }")
    lap("encode and plans")
    kernels = (phase_kernels(inp3[0], big4, dev) + phase_filter_kernels(big12, dev)
               + phase_hf_kernels(plans, dev) + phase_token_kernels(mplans, dev)
               + phase_wavefront_kernels(mplans, dev) + batch_kernel_rows(streams, dev))
    flat = phase_flat_probes(streams, dev)
    lap("kernels")

    filtered = {"reconstruct_dct8", "gaborish", "epf_fused", "xyb_to_srgb"}
    mains = [
        phase_main_path("config3", streams["config3"], {"reconstruct_dct8_srgb"}),
        phase_main_path("config4", streams["config4"],
                        {"reconstruct_dct8", "xyb_to_srgb"}),
        phase_main_path("config12f", streams["config12f"], filtered, filters=True),
        phase_main_path("config4", streams["config4"], filtered, filters=True),
        phase_ragged_epf(dev),
    ]
    # the device route: B4/B5, then B1 on the LF groups it keeps on the card
    # (and the write-back to B2/B3 on config 4's mixed groups)
    device_want = {"config3": {"hf", "reconstruct_dct8_srgb"},
                   "config4": {"hf", "reconstruct_dct8_srgb", "reconstruct_dct8",
                               "xyb_to_srgb"},
                   "hf_ans_2048": {"hf", "reconstruct_dct8_srgb"},
                   "hf_ctx_2048": {"hf_ctx", "reconstruct_dct8_srgb"}}
    mains += [phase_main_path(k, streams[k], device_want[k], backend="device",
                              lanes=len(plans[k]["lanes"])) for k in hf_cfgs]
    # the modular device lanes: the token kernel, then the wavefront kernels
    lap("VarDCT main paths")
    mains += [phase_modular_path(k, streams[k], mplans[k]) for k in MODULAR]
    lap("modular main paths")
    # batch serving (parallel/batch.py): B1 a chunk, B4 in multi-spec calls
    batch_paths, serving = phase_batch(streams, dev)
    mains += batch_paths
    lap("batch paths")
    # the multi-device paths on meshes that repeat the card
    sharded, sharded_rows, dry, squeeze_probes = phase_sharded(streams, dev)
    kernels += sharded_rows
    lap("multi-device paths")
    for r in kernels:
        # an HF row counts the launches of the device-route paths of its
        # mode, a token, batch or sharded row those of its own paths, any
        # other row those of the single-stream paths (the batch and sharded
        # rows count their paths' launches of the same kernel at their
        # shape)
        paths = r.get("paths")
        if paths is None and "mode" in r:
            paths = [f"{k}/device" for k in hf_cfgs if hf_mode(plans[k]) == r["mode"]]
        other = {p for p, _, _ in BATCH_PATHS} | {m["path"] for m in sharded}
        r["launches"] = sum(m["launches"][r.get("counter", r["name"])] for m in mains + sharded
                            if (m.get("path") in paths if paths is not None
                                else m.get("path") not in other))
        if "kind_calls" in r:  # B7 and S1 rows: the calls of its kind among them
            assert 0 < r["kind_calls"] <= r["launches"], (r["name"], r["launches"])
            r["launches"] = r.pop("kind_calls")
        assert r["launches"] > 0, f"{r['name']} never launched on the main path"
        assert r.get("timer"), f"{r['name']} names no timer"
        if "diagonals" in r:  # a wavefront row: its launches stream by stream
            r["launches_per_stream"] = {m["path"]: m["launches"][r["counter"]]
                                        for m in mains + sharded if m.get("path") in paths}
    gathers = [gather_ab(k, streams[k]) for k in ("config3", "config4")]
    profiles = [phase_profile(k, streams[k]) for k in ("config3", "config4")]
    profiles.append(phase_profile("config12f", streams["config12f"], filters=True))
    profiles += [phase_profile(k, streams[k], backend="device")
                 for k in ("config4", "hf_ctx_2048")]
    # the modular device lanes: a token launch, then a wavefront launch a
    # (class, kernel)
    profiles += [phase_profile(k, streams[k], backend="device", warm=False)
                 for k in ("modular", "modular_e3gt")]

    lap("profiles")
    # the command-line decoder, one process a run
    cli = phase_cli(streams, mains)
    lap("cli")
    example = phase_example()
    lap("example")
    out_dir = Path(__file__).resolve().parent / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(dict(
        card=card, build=build, kernels=kernels, flat_probes=flat,
        squeeze_probes=squeeze_probes, main_path=mains,
        serving=serving, sharded=sharded, dryrun_multichip=dry, host_gather=gathers, timer_notes=TIMER_NOTES,
        epf_skipped_blocks=skipped, profiles=profiles, cli=cli, example=example,
        seconds=time.perf_counter() - t_start), indent=1))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # every row names its timer (of `ms`, and of `plain_ms` and
    # `library_ms` unless `plain_timer` says otherwise: the entropy rows'
    # plain versions, capped, are timed between CUDA events as their
    # `ms_at_cap` is); the entropy rows add their design, its sync
    # statistics, their rates and the time between CUDA events around the
    # call; the batch rows the paths whose launches they count
    extra = ("timer", "plain_timer", "ns_per_symbol", "symbols_per_s", "design", "sync",
             "ms_events", "paths", "diagonals", "ns_per_diagonal", "launches_per_stream",
             "ns_per_pixel", "per_launch", "steps", "chain_ms", "ns_per_step", "seg",
             "convergence")
    print(json.dumps({"kernels": [{k: r[k] for k in keys + extra if k in r}
                                  for r in kernels]}))
    print(card["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card["kind"], "count": card["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
