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
   on the inputs the main path gives it (the LF groups of the two streams
   below), its device time beside its plain version's, a library
   yardstick's and its bound;
4. main path: the BASELINE VarDCT configs 3 (1024x1024, all DCT8) and 4
   (4096x3072 mixed varblocks, custom orders and dequant matrices), made
   from a seed by the port's encoder, decoded by `decode_file(data,
   workers=4)` on the card and held within 1 gray level of the port's host
   plan (`backend="numpy"`); the kernel launch counters show which kernels
   the decode went through;
5. profile: one warm decode of each config under torch.profiler (device
   busy time and idle share) and cProfile (host time by function).

The last line is {"ok": true, "device": {...}}; the line before it holds
the card's name and power limit; before that one {"kernels": [...]} line.
Details go to build/chip_smoke.json.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

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


def device_ms(fn) -> float:
    """Median device time per call of `fn` over REPS calls after warm-up:
    the summed durations of the CUDA kernels it launches, as CUPTI records
    them (torch.profiler).  CUDA events or a host clock around a call would
    also time the Python launch path, which for these kernels takes longer
    than the kernel.  Inputs stay in the 50 MB L2 where they fit, as on the
    decode path, where each kernel reads what the step before it wrote."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    # a profiling session now and then receives no device records at all
    # (seen once in four runs, on cuBLAS's matmul); such a session is
    # profiled again, up to three times in all
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
        spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                       if e.device_type == DeviceType.CUDA)
        if spans:
            break
    assert spans and len(spans) % REPS == 0, f"{len(spans)} kernels in {REPS} calls"
    per = len(spans) // REPS
    calls = [sum(b - a for a, b in spans[k * per:(k + 1) * per]) for k in range(REPS)]
    return statistics.median(calls) / 1e3


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


def group_inputs(data: bytes) -> list[dict]:
    """The main path's per-LF-group reconstruction inputs (numpy)."""
    from j40_tpu_torch.decode import Decoder
    from j40_tpu_torch.ops.combine import lf_group_inputs

    dec = Decoder(data, backend="numpy")
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
    kt = K._idct8_on(dev).T.contiguous()
    flat3 = dense3.reshape(-1, 64)
    b = bound(dense3.numel() * 4 + d3["aux"].numel() * 4 + 64 * 3 * 4
              + 64 * 64 * 4 + 22 * 4 + got.numel(), dct8_ops(n3, True))
    rows.append(dict(
        name="reconstruct_dct8_srgb", route="cuda",
        source="j40_tpu_torch/csrc/reconstruct.cu",
        replaces="j40_tpu/ops/pallas_kernels.py:171",
        shape=f"n={n3} blocks -> {tuple(got.shape)} u8", max_abs_err=float(err),
        ms=device_ms(lambda: K.reconstruct_dct8_srgb(*a3, True)),
        plain_ms=device_ms(lambda: K.reconstruct_dct8_srgb_ref(*a3, True)),
        bound_ms=b[0], bound_by=b[1],
        library_ms=device_ms(lambda: torch.matmul(flat3, kt)),
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
              + 64 * 64 * 4 + 8 * 4 + got.numel() * 4, dct8_ops(n4, False))
    rows.append(dict(
        name="reconstruct_dct8", route="cuda",
        source="j40_tpu_torch/csrc/reconstruct.cu",
        replaces="j40_tpu/ops/pallas_kernels.py:39",
        shape=f"n={n4} blocks -> {tuple(got.shape)} f32", max_abs_err=err,
        ms=device_ms(lambda: K.reconstruct_dct8(*a4)),
        plain_ms=device_ms(lambda: K.reconstruct_dct8_ref(*a4)),
        bound_ms=b[0], bound_by=b[1],
        library_ms=device_ms(lambda: torch.matmul(flat4, kt)),
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
        ms=device_ms(lambda: K.xyb_to_srgb(plane, c22, True)),
        plain_ms=device_ms(lambda: K.xyb_to_srgb_ref(plane, c22, True)),
        bound_ms=b[0], bound_by=b[1], library_ms=None, library=None,
    ))
    for r in rows:
        print(f"kernel {r['name']} [{r['shape']}]: {r['ms']:.4f} ms on the "
              f"device, plain {r['plain_ms']:.4f} ms, library {r['library_ms']}, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), max|err| {r['max_abs_err']}")
    return rows


def phase_main_path(name: str, data: bytes, want: set[str]) -> dict:
    """One config through decode_file on the card, held against the host
    plan; the launch counters are zeroed just before the decode and read
    just after."""
    import j40_tpu_torch
    from j40_tpu_torch.ops import kernels as K

    _, ref = j40_tpu_torch.decode_file(data, backend="numpy", workers=4)
    K.reset_launches()
    dec, rgba = j40_tpu_torch.decode_file(data, workers=4)
    launches = dict(K.launches)
    assert rgba.shape == ref.shape and rgba.dtype == np.uint8
    diff = int(np.abs(rgba[:, :, :3].astype(np.int16) - ref[:, :, :3]).max())
    assert diff <= 1, f"{name}: max|diff| {diff} vs the host plan"
    assert (rgba[:, :, 3] == 255).all()
    ran = {k for k, v in launches.items() if v}
    assert want <= ran, f"{name}: launches {launches}, want {sorted(want)}"

    def mpix(backend):
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            j40_tpu_torch.decode_file(data, backend=backend, workers=4)
            ts.append(time.perf_counter() - t0)
        return rgba.shape[0] * rgba.shape[1] / 1e6 / statistics.median(ts)

    out = dict(
        config=name, size=f"{rgba.shape[1]}x{rgba.shape[0]}",
        stream_bytes=len(data), lf_groups=dec.stats["num_lf_groups"],
        launches=launches, max_abs_diff=diff, mpix_s=mpix("torch"),
        host_plan_mpix_s=mpix("numpy"),
        stages_s={k: dec.stats[k] for k in
                  ("headers_s", "sections_s", "reconstruct_s", "total_s")},
    )
    # PERF.md's target, not yet met and not a gate: the card path at least
    # as fast as the host plan on the same machine
    out["target_met"] = out["mpix_s"] >= out["host_plan_mpix_s"]
    print(f"main path {name} ({out['size']}, {out['lf_groups']} LF groups, "
          f"{len(data)} B): {out['mpix_s']:.2f} Mpix/s on the card (median of "
          f"3), host plan {out['host_plan_mpix_s']:.2f} Mpix/s, target_met "
          f"{out['target_met']}, launches "
          f"{launches}, max|diff| {diff}, first decode stages {out['stages_s']}")
    return out


def phase_profile(name: str, data: bytes) -> dict:
    """Where one warm decode's time goes: device time by kernel and copy
    (torch.profiler, CUPTI) against the wall time, and the host functions
    by cumulative time (cProfile, a separate decode: it slows Python)."""
    import cProfile
    import io
    import pstats

    import j40_tpu_torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    j40_tpu_torch.decode_file(data, workers=4)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        j40_tpu_torch.decode_file(data, workers=4)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us = e.time_range.end - e.time_range.start
            by_name[e.name] = by_name.get(e.name, 0.0) + us
    device_us = sum(by_name.values())
    top_device = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]

    pr = cProfile.Profile()
    pr.enable()
    j40_tpu_torch.decode_file(data, workers=4)
    pr.disable()
    s = io.StringIO()
    pstats.Stats(pr, stream=s).sort_stats("cumulative").print_stats(18)
    host = [ln for ln in s.getvalue().splitlines() if "(" in ln and "/" in ln]
    out = dict(config=name, wall_ms=wall_us / 1e3,
               device_busy_ms=device_us / 1e3 if by_name else None,
               device_idle_share=1 - device_us / wall_us if by_name else None,
               top_device_ms=[(k[:80], v / 1e3) for k, v in top_device],
               host_cumulative=host)
    busy = ("not measured (the profiler saw no device events)" if not by_name
            else f"device busy {device_us / 1e3:.3f} ms, idle share "
                 f"{out['device_idle_share']:.4f}")
    print(f"profile {name}: wall {wall_us / 1e3:.1f} ms, {busy}")
    for k, v in out["top_device_ms"]:
        print(f"  device {v:9.3f} ms  {k}")
    for ln in host:
        print("  host", ln.strip()[:150])
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import j40_tpu_torch  # noqa: F401  (fails outside the checkout)

    t_start = time.perf_counter()
    card = phase_card()
    build = phase_build()
    dev = torch.device("cuda", torch.cuda.current_device())

    t0 = time.perf_counter()
    streams = {"config3": config3(), "config4": config4()}
    print(f"encode: {time.perf_counter() - t0:.1f} s, "
          f"{ {k: len(v) for k, v in streams.items()} } bytes")
    inp3 = group_inputs(streams["config3"])
    inp4 = group_inputs(streams["config4"])
    kinds4 = [g["kind"] for g in inp4]
    print(f"LF groups: config3 {[g['kind'] for g in inp3]}, config4 {kinds4}")
    assert [g["kind"] for g in inp3] == ["dct8"] and "mixed" in kinds4
    big4 = next(g for g in inp4 if g["kind"] == "mixed" and g["h8"] * g["w8"] == 65536)
    kernels = phase_kernels(inp3[0], big4, dev)

    mains = [
        phase_main_path("config3", streams["config3"], {"reconstruct_dct8_srgb"}),
        phase_main_path("config4", streams["config4"],
                        {"reconstruct_dct8", "xyb_to_srgb"}),
    ]
    for r in kernels:
        r["launches"] = sum(m["launches"][r["name"]] for m in mains)
        assert r["launches"] > 0, f"{r['name']} never launched on the main path"
    profiles = [phase_profile(k, v) for k, v in streams.items()]

    out_dir = Path(__file__).resolve().parent / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(dict(
        card=card, build=build, kernels=kernels, main_path=mains,
        profiles=profiles, seconds=time.perf_counter() - t_start), indent=1))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in kernels]}))
    print(card["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card["kind"], "count": card["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
