"""Interleaved A/B timing, on one CUDA card, of a kernel from this
checkout's library and from one built out of another copy of
`j40_tpu_torch/csrc/`.

    python3 tools/torch_kernel_ab.py OTHER_CSRC_DIR[,OTHER2,...]|- [PAIRS] [CASE[,CASE...]] [--sass]

OTHER_CSRC_DIR "-" times this checkout's library alone.  Several cases,
comma-separated, run one after another in the one process (one JSON line
each).  CASE is one of
chip_smoke.py's inputs, or a wavefront kernel (below): hf_ans_2048 (the default; B4's
rANS walk of the single-cluster stream's lanes), hf_ctx_2048 (B5, the
5-cluster stream), epf_fused_12f (B8's 3 steps on config 12F's first
2048x2048 LF group), epf_step_rows_12f_k0, _k1 and _k2 (B7's rows entry
on the (3, 390, 4096) stripe, block sigmas and parameters of step 0, 1 or
2 of shard 1 in config 12F's filtered decode on 8 shards, as
chip_smoke.py captures them; within XYB_ATOL of the plain version),
epf_step_ragged (B7's three launches on chip_smoke.py's (3, 1023, 1021)
ragged plane through epf_device; within 2e-3 of the chain of plain
steps; both with ns a pixel of the call and a yardstick timed in the same
rounds: a torch copy of the same bytes, no arithmetic), dct8_srgb_c3 (B1 on config 3's LF group, u8),
dct8_xyb_c4 (B2 on config 4's first mixed 2048x2048 LF group),
dct8_xyb_c4_cold (the same with the L2 cold: a 128 MB scratch buffer is
written before every call) or xyb_srgb_c4 (B3 to u8 on B2's output
plane of that group, as chip_smoke.py's row).  Both libraries load into
one process (as tools/ab_native.py does for the host core) and take turns
on the same inputs, the order reversed every round (with several other
copies, each is a library B1, B2, ... in the same rounds): an HF walk is
one uncapped call between CUDA events a turn, B8 20 calls between CUDA
events, B7, B1, B2 and B3 20 calls queued behind a sleep kernel, each
between its own CUDA events (the median of a turn): these kernels take
less time than the wrapper's launch path, so events around calls that
the host has not queued ahead would time the host.  Each library must first pass the case's check: an HF
walk gives the host plan's coefficient planes, ends every lane and leaves
the final rANS state 0x130000; B8 stays within chip_smoke.XYB_ATOL of its
plain version, B1 and B3 within 1 level and B2 within 1e-4 of theirs
(chip_smoke's bars).  A copy whose DCT8 entry points take the dense 64x64
operator (`kmat`, the sources before the separable kernel) is called
through that interface.  The wavefront cases wavefront_grad,
wavefront_mixed, wavefront_wp, wavefront_wp_codes and wavefront_tree (W1
gradient and codes, W2 WP and codes, W3 the e3 tree) run the kernel on
random residuals made from a seed: 48 planes of 256x256, the Modular
route's one launch for a class's three slots, or with the suffix `_band`
16 planes of 32x256, one warp a plane, so that the time is the chain of
one warp's steps with no hand-off between warps; 20 calls queued as for
B1; each library equal to the plain version (the torch-op loop on the
card) in planes and flags; per library ns a step (a diagonal of the
plane, or a step of the band's warp).  A copy must take this checkout's
wavefront interface (the W1 and W2 entries have not changed since PR 11;
W3's tree layout has).  The S1 cases unsqueeze_h and unsqueeze_v run the
merge kernel on shard 1's widest horizontal and vertical merge of
chip_smoke.py's lossless_sq stream decoded on 8 shards of the card (it
encodes the stream first), unsqueeze_ramp on the slope -1 ramp at
unsqueeze_h's shape (20 calls queued as for B1, per library ns a pair of
a chain), unsqueeze_shard1 on all 44 of shard 1's merges launched back to
back (the main path's mix of merge sizes; 5 calls a turn, so that the
host queues them all behind the sleep kernel), each library equal to the
plain version; unsqueeze_decode is the whole decode of lossless_sq on 8
shards of the card (host-bound: 3 decodes between CUDA events a turn,
each library's output equal to the first decode's).  S1's C entry has
not changed since it was added.  `--sass` adds the instructions of one step of
each wavefront kernel instance, read from this checkout's SASS (`nvcc
-cubin`, `cuobjdump -sass`: the distance between a step's shuffle groups,
the median over the unrolled steps).  Prints one JSON line: per library
the median ms (and for an HF walk ns per symbol of the longest lane),
and for each other library the median of the per-round ratios to A.
"""

import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def other_library(csrc: Path, ref, subdir: str = "ab_other"):
    """Build the sources of `csrc` (the file names of _build.SOURCES and
    HEADERS) into their own build directory and bind them as `ref` is."""
    from j40_tpu_torch.ops import _build

    saved = _build.SOURCES, _build.HEADERS, _build.BUILD_DIR
    _build.SOURCES = [csrc / s.name for s in saved[0]]
    _build.HEADERS = [csrc / s.name for s in saved[1]]
    _build.BUILD_DIR = REPO / "build" / subdir
    try:
        path = _build.build()
    finally:
        _build.SOURCES, _build.HEADERS, _build.BUILD_DIR = saved
    lib = ctypes.CDLL(str(path))
    for name, fn in ref.__dict__.items():
        if hasattr(fn, "argtypes") and hasattr(lib, name):
            g = getattr(lib, name)
            g.argtypes, g.restype = fn.argtypes, fn.restype
    # DCT8 entry points of the dense 64x64 operator: a device pointer to
    # it, and a grid of j40tt_tile_blocks()-block tiles from the caller
    lib.dct8_kmat = "const float* kmat" in (csrc / "reconstruct.cu").read_text()
    if lib.dct8_kmat:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.j40tt_reconstruct_dct8.argtypes = [p, p, p, p, p, p, i, i, i, i, p]
        lib.j40tt_reconstruct_dct8_srgb.argtypes = [p, p, p, p, p, p, i, i, i, i, i, p]
        lib.j40tt_tile_blocks.argtypes, lib.j40tt_tile_blocks.restype = [], i
    return lib


def hf_case(name: str, dev):
    """The lanes of chip_smoke.py's hf stream `name`: a call (uncapped, into
    one scratch plane), its check against the host plan's planes, and the
    longest lane's symbols (the per-symbol unit)."""
    import torch

    import chip_smoke as CS
    from j40_tpu_torch.ops import device_vardct as DV
    from j40_tpu_torch.ops import hf_kernels as HK

    clusters = {"hf_ans_2048": 1, "hf_ctx_2048": 5}[name]
    p = CS.hf_plan(CS.hf_stream(clusters))
    batch = DV.hf_batches(p["lanes"])[0]
    ncmax = max(ln.gw8 * ln.gh8 for ln in batch)
    d, launch, done_row = DV.pack_hf_batch(p["vd"], p["spec"], batch, p["orders"],
                                           p["ctx"], dev)
    assert not d.get("use_prefix") and p["ctx"] == (clusters > 1), name
    host = torch.from_numpy(CS.host_coeffs(p["vd"], batch, ncmax)).to(dev)

    def check() -> None:
        out, st = launch(ncmax)
        s = HK.lane_state(st, len(batch), done_row)
        assert torch.equal(out, host) and s["done"].all() and not s["err"].any()
        assert (s["ans_state"] == 0x130000).all()

    scratch = torch.empty_like(host)
    longest = int(CS.lane_symbols(host, d["nat"], d["nc"]).max())
    return (lambda: launch(ncmax, out=scratch)), check, dict(
        lanes=len(batch), longest_lane_symbols=longest, unit=longest, reps=1)


def epf_case(dev):
    """B8 on config 12F's first 2048x2048 LF group, as chip_smoke.py's
    epf_fused row: its 3 steps on the gaborish output of the group's XYB
    plane, checked within XYB_ATOL of the plain version."""
    import chip_smoke as CS
    from j40_tpu_torch.ops import filter_kernels as FK
    from j40_tpu_torch.ops.combine import _mixed_xyb, to_device

    g = next(g for g in CS.group_inputs(config12f(), apply_filters=True)
             if g["h8"] * g["w8"] == 65536)
    t = to_device(g, dev)
    filt, epf = t["filters"], t["filters"]["epf"]
    xyb = _mixed_xyb(t["i8"], t["exc_idx"], t["exc_val"], t["aux"], t["weights"],
                     t["consts22"], (), (), t["h8"], t["w8"])
    plane = FK.gaborish(xyb, filt["gab"])
    steps = FK.frame_steps(epf["iters"], epf["p0_scale"], epf["p2_scale"])
    args = (plane, filt["rs8"], steps, epf["channel_scale"], epf["border_sad_mul"])
    ref = FK.epf_fused_ref(*args)

    def check() -> None:
        assert (FK.epf_fused(*args) - ref).abs().max().item() <= CS.XYB_ATOL

    return (lambda: FK.epf_fused(*args)), check, dict(shape=list(plane.shape), reps=20)


_STREAMS: dict = {}


def config12f() -> bytes:
    """chip_smoke.config12f(), encoded once a process."""
    import chip_smoke as CS

    if "config12f" not in _STREAMS:
        _STREAMS["config12f"] = CS.config12f()
    return _STREAMS["config12f"]


def epf_rows_case(name: str, dev):
    """B7's rows entry on the stripe of shard 1 for the step kind the name
    ends in (_k0 12-tap, _k1 4-tap cross, _k2 4-tap plain), captured from
    config 12F's filtered decode on 8 shards of this card; within
    XYB_ATOL of the plain version."""
    import torch

    import chip_smoke as CS
    from j40_tpu_torch.ops import filter_kernels as FK
    from j40_tpu_torch.parallel import sharded_decode as SD

    kind = int(name.rsplit("_k", 1)[1])
    with CS.keep_rows_calls() as captured:
        SD.decode_sharded(config12f(), mesh=CS.mesh_of(dev, CS.SHARDS), apply_filters=True)
    args = captured["epf"][CS.SHARDS * kind + 1]
    assert args[3] == kind, (name, args[3])
    ref = FK.epf_step_rows_ref(*args)

    def check() -> None:
        assert (FK.epf_step_rows(*args) - ref).abs().max().item() <= CS.XYB_ATOL

    _, hs, w = args[0].shape
    out = torch.empty((3, hs - 6, w), device=dev)
    return (lambda: FK.epf_step_rows(*args)), check, dict(
        shape=list(args[0].shape), kind=kind, reps=20, queued=True, unit=(hs - 6) * w,
        unit_key="ns_per_pixel",
        yardstick=("torch copy of the stripe's own rows: the step's bytes, no arithmetic",
                   lambda: out.copy_(args[0][:, 3:-3])))


def epf_ragged_case(dev):
    """B7's three launches (12-tap, 4-tap cross, 4-tap plain) on
    chip_smoke.py's (3, 1023, 1021) ragged plane through epf_device;
    within 2e-3 of the chain of plain steps."""
    import chip_smoke as CS
    from j40_tpu_torch.ops import filter_kernels as FK

    ch, rs8 = CS.ragged_plane(dev)
    ref = CS.ragged_ref(ch, rs8)

    def call():
        return FK.epf_device(ch, rs8, **CS.RAGGED_EPF)

    def check() -> None:
        assert (call() - ref).abs().max().item() <= 2e-3

    return call, check, dict(
        shape=list(ch.shape), reps=20, queued=True, unit=ch.shape[1] * ch.shape[2],
        unit_key="ns_per_pixel",
        yardstick=("three torch clones of the plane: the three steps' bytes, no arithmetic",
                   lambda: [ch.clone() for _ in range(3)]))


def dct8_case(name: str, dev):
    """B1 (u8) on config 3's LF group or B2 on config 4's first mixed
    2048x2048 LF group, as chip_smoke.py's rows take them, through the
    wrapper, or through the dense-operator interface for a library that
    has it; checked within 1 level (B1) or 1e-4 (B2) of the plain version."""
    import torch

    import chip_smoke as CS
    from j40_tpu_torch.ops import _build
    from j40_tpu_torch.ops import kernels as K
    from j40_tpu_torch.ops.combine import to_device

    srgb = name == "dct8_srgb_c3"
    if srgb:
        g = CS.group_inputs(CS.config3())[0]
    else:
        g = next(g for g in CS.group_inputs(CS.config4())
                 if g["kind"] == "mixed" and g["h8"] * g["w8"] == 65536)
    t = to_device(g, dev)
    dense = K.unpack_i8(t["i8"], t["exc_idx"], t["exc_val"])
    h8, w8 = t["h8"], t["w8"]
    consts = t["consts22"] if srgb else t["consts22"][:8].contiguous()
    args = (dense, t["aux"], t["weights"], consts, h8, w8)
    kmat = torch.from_numpy(K.idct8_matrix()).to(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def dense_operator_call(lib):
        n = h8 * w8
        out = torch.empty((3, 8 * h8, 8 * w8), device=dev,
                          dtype=torch.uint8 if srgb else torch.float32)
        grid = max(1, min(-(-n // lib.j40tt_tile_blocks()), 4 * sms))
        ptrs = (dense.data_ptr(), t["aux"].data_ptr(), t["weights"].data_ptr(),
                kmat.data_ptr(), consts.data_ptr(), out.data_ptr(), n, h8, w8)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = (lib.j40tt_reconstruct_dct8_srgb(*ptrs, 1, grid, stream) if srgb
              else lib.j40tt_reconstruct_dct8(*ptrs, grid, stream))
        if rc:
            raise RuntimeError(f"{name}: {lib.j40tt_error_string(rc).decode()} ({rc})")
        return out

    def call():
        lib = _build.load_kernels()
        if getattr(lib, "dct8_kmat", False):
            return dense_operator_call(lib)
        return K.reconstruct_dct8_srgb(*args, True) if srgb else K.reconstruct_dct8(*args)

    ref = K.reconstruct_dct8_srgb_ref(*args, True) if srgb else K.reconstruct_dct8_ref(*args)

    def check() -> None:
        got = call()
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= (1 if srgb else 1e-4), (name, err)

    return call, check, dict(shape=[3, 8 * h8, 8 * w8], reps=20, queued=True,
                             cold=name.endswith("_cold"))


def xyb_case(dev):
    """B3 (to u8) on B2's output plane of config 4's first mixed 2048x2048 LF
    group, made by this checkout's library; within 1 level of its plain
    version."""
    import chip_smoke as CS
    from j40_tpu_torch.ops import kernels as K
    from j40_tpu_torch.ops.combine import to_device

    g = next(g for g in CS.group_inputs(CS.config4())
             if g["kind"] == "mixed" and g["h8"] * g["w8"] == 65536)
    t = to_device(g, dev)
    dense = K.unpack_i8(t["i8"], t["exc_idx"], t["exc_val"])
    plane = K.reconstruct_dct8(dense, t["aux"], t["weights"],
                               t["consts22"][:8].contiguous(), t["h8"], t["w8"])
    c22 = t["consts22"]
    ref = K.xyb_to_srgb_ref(plane, c22, True)

    def call():
        return K.xyb_to_srgb(plane, c22, True)

    def check() -> None:
        assert (call().int() - ref.int()).abs().max().item() <= 1

    return call, check, dict(shape=list(plane.shape), reps=20, queued=True)


#: the wavefront cases: (wrapper, codes) a kernel instance
WAVEFRONTS = {"wavefront_grad": ("plain", False), "wavefront_mixed": ("plain", True),
              "wavefront_wp": ("wp", False), "wavefront_wp_codes": ("wp", True),
              "wavefront_tree": ("tree", False)}
#: the e3 encoder's tree (chip_smoke.py's modular_e3 streams)
E3_TREE = ((15, 0, 1, 2, 0, 0, 0), (-1, 0, 0, 0, 6, 0, 1), (-1, 0, 0, 0, 5, 0, 1))


def wavefront_case(name: str, dev):
    """A wavefront kernel on random residuals: 48 planes of 256x256, or 16
    of one 32-row band (`_band`), through its wrapper; checked equal to
    the plain version on the card."""
    import numpy as np
    import torch

    from j40_tpu_torch.modular.wp import WPParams
    from j40_tpu_torch.ops import device_entropy as DE
    from j40_tpu_torch.ops import wavefront_kernels as WK

    band = name.endswith("_band")
    kind, with_codes = WAVEFRONTS[name.removesuffix("_band")]
    L, h, w = (16, 32, 256) if band else (48, 256, 256)
    rng = np.random.default_rng(h)
    res = torch.from_numpy(rng.integers(-30, 31, size=(L, h, w)).astype(np.int32)).to(dev)
    codes = (torch.from_numpy(rng.choice([0, 1, 2, 5, 6, 7, 12], size=(L, h, w))
                              .astype(np.int32)).to(dev) if with_codes else None)
    sidx = torch.arange(30, 30 + L, dtype=torch.int32, device=dev)
    cidx = (torch.arange(L, dtype=torch.int32, device=dev) * 3) // L
    p = WPParams()
    WK.limits()  # read from this checkout's library, before any other is bound
    k = 1 if kind == "plain" else 2
    # a plane's diagonals, or the steps of the band's one warp
    steps = 31 * k + w + k - 1 if band else k * h + w - k
    if kind == "plain":
        def call():
            return (WK.plain_wavefront(res, codes, h, w),)
        ref = (DE._plain_wavefront(res, codes, h, w),)
    elif kind == "wp":
        def call():
            return WK.wp_wavefront(res, codes, h, w, p)
        ref = DE._wp_reconstruct(res, codes, h, w, p, codes is not None)
    else:
        def call():
            return WK.tree_wavefront(res, E3_TREE, cidx, sidx, h, w, p)
        ref = tuple(torch.cat(t) for t in zip(*(
            DE._tree_wp_reconstruct(res[cidx == c], h, w, p, E3_TREE, c, sidx[cidx == c])
            for c in range(3))))

    def check() -> None:
        assert all(torch.equal(a, b) for a, b in zip(call(), ref)), name

    return call, check, dict(shape=[L, h, w], reps=20, queued=True, unit=steps,
                             unit_key="ns_per_step")


#: the S1 cases
SQUEEZE = ("unsqueeze_h", "unsqueeze_v", "unsqueeze_ramp", "unsqueeze_shard1",
           "unsqueeze_decode")
_SQ: dict = {}


def squeeze_case(name: str, dev):
    """S1 on chip_smoke.py's rows' inputs: shard 1's widest horizontal
    (unsqueeze_h) or vertical (unsqueeze_v, a column view) merge of
    lossless_sq's decode on 8 shards of the card, captured by
    chip_smoke.keep_merge_calls, or the slope -1 ramp with zero residuals
    at unsqueeze_h's shape (unsqueeze_ramp), each checked equal to the
    plain version (per library ns a pair of the merge's chains); all of
    shard 1's merges (unsqueeze_shard1); the whole decode
    (unsqueeze_decode)."""
    import torch

    import chip_smoke as CS
    from j40_tpu_torch.ops import squeeze_kernels as SQ
    from j40_tpu_torch.parallel.sharded_lossless import decode_sharded_lossless, squeeze_merges

    mesh = CS.mesh_of(dev, CS.SHARDS)
    if not _SQ:  # encoded and decoded once a process
        _SQ["data"] = CS.lossless_sq_stream()
        with CS.keep_merge_calls() as calls:
            _SQ["first"] = decode_sharded_lossless(_SQ["data"], mesh=mesh)
        _SQ.update(merges=squeeze_merges(_SQ["data"]), calls=calls)
    merges, calls = _SQ["merges"], _SQ["calls"]
    if name == "unsqueeze_decode":  # host-bound: 3 decodes between CUDA events
        def decode():
            return decode_sharded_lossless(_SQ["data"], mesh=mesh)

        def check_decode() -> None:
            assert (decode() == _SQ["first"]).all(), name

        return decode, check_decode, dict(reps=3)
    if name == "unsqueeze_shard1":  # shard 1's 44 merges back to back
        mine = [c[:3] for c in calls[1:CS.SHARDS * len(merges):CS.SHARDS]]
        wants = [SQ.unsqueeze_ref(*c) for c in mine]

        def call_all():
            return [SQ.unsqueeze(*c) for c in mine]

        def check_all() -> None:
            assert all(torch.equal(a, b) for a, b in zip(call_all(), wants)), name

        return call_all, check_all, dict(merges=len(mine), reps=5, queued=True)
    horizontal = name != "unsqueeze_v"
    m = max((i for i, x in enumerate(merges) if x[0] == horizontal), key=lambda i: merges[i][2])
    down, residu = calls[CS.SHARDS * m + 1][:2]
    if name == "unsqueeze_ramp":
        down, residu = (torch.from_numpy(a).to(dev) for a in CS.squeeze_model().ramp(
            True, down.shape[0], down.shape[1], residu.shape[1]))
    want = SQ.unsqueeze_ref(down, residu, horizontal)
    wr = residu.shape[1 if horizontal else 0]

    def call():
        return SQ.unsqueeze(down, residu, horizontal)

    def check() -> None:
        assert torch.equal(call(), want), name

    return call, check, dict(shape=[list(down.shape), list(residu.shape)], reps=20, queued=True,
                             unit=wr, unit_key="ns_per_pair")


def wavefront_step_instructions() -> dict:
    """Instructions between consecutive shuffle groups of this checkout's
    wavefront.cu, per kernel instance (the median over its unrolled
    steps)."""
    from j40_tpu_torch.ops import _build

    out_dir = REPO / "build" / "ab_sass"
    out_dir.mkdir(parents=True, exist_ok=True)
    cubin = out_dir / "wavefront.cubin"
    subprocess.run([_build.nvcc_path(), *_build.ARCH, "-std=c++17", "-O3", "-cubin", "-o",
                    str(cubin), str(REPO / "j40_tpu_torch" / "csrc" / "wavefront.cu")],
                   check=True)
    sass = subprocess.run(["cuobjdump", "-sass", str(cubin)], capture_output=True, text=True,
                          check=True).stdout
    out = {}
    for fn, body in re.findall(r"Function : (\S+)\n(.*?)(?=\n\s*Function : |\Z)", sass, re.S):
        ins = [ln for ln in body.splitlines() if re.match(r"\s+/\*[0-9a-f]{4}\*/", ln)]
        shfl = [k for k, ln in enumerate(ins) if "SHFL.UP PT" in ln]
        # a step's shuffles are adjacent; the first of each group marks it
        starts = [k for j, k in enumerate(shfl) if j == 0 or k - shfl[j - 1] > 8]
        gaps = [b - a for a, b in zip(starts, starts[1:])]
        kind = ("W2 " + {"0": "wp", "1": "wp_codes", "2": "tree"}[m.group(1)]
                if (m := re.search(r"wp_wavefront_kernelILi(\d)", fn)) else
                "W1 " + ("mixed" if "ILb1" in fn else "gradient"))
        out[kind] = statistics.median(gaps) if gaps else None
    return out


def queued_ms(fn, reps: int, before=None) -> float:
    """Device time per call of `fn`: CUDA events right around each of `reps`
    calls (each after `before()` if given, which stays outside the pair),
    queued behind a ~5 ms sleep kernel, so that the card runs the calls
    back to back and the events time the kernel, not the wrapper's launch
    path.  On an H100 this reads ~4 us above CUPTI's kernel records; CUPTI
    sessions around these short kernels have lost all their records."""
    import torch

    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(reps)]
    torch.cuda.synchronize()
    torch.cuda._sleep(10_000_000)
    for a, b in pairs:
        if before is not None:
            before()
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def main() -> int:
    import torch

    import chip_smoke as CS
    from j40_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    sass = "--sass" in sys.argv
    argv = [a for a in sys.argv if a != "--sass"]
    pairs = int(argv[2]) if len(argv) > 2 else 20
    cases = (argv[3] if len(argv) > 3 else "hf_ans_2048").split(",")
    dev = torch.device("cuda", torch.cuda.current_device())
    libs = {"A": _build.load_kernels()}
    others = [] if argv[1] == "-" else argv[1].split(",")
    for j, other in enumerate(others):
        name = "B" if len(others) == 1 else f"B{j + 1}"
        libs[name] = other_library(Path(other).resolve(), libs["A"], f"ab_other{j}")
    for case in cases:
        run_case(case, libs, others, pairs, sass, dev)
    return 0


def run_case(case: str, libs: dict, others: list, pairs: int, sass: bool, dev) -> None:
    """Check every library on `case`, time them in turns, print one line."""
    import torch

    import chip_smoke as CS
    from j40_tpu_torch.ops import _build

    if case.removesuffix("_band") in WAVEFRONTS:
        call, check, info = wavefront_case(case, dev)
    elif case in SQUEEZE:
        call, check, info = squeeze_case(case, dev)
    elif case == "epf_fused_12f":
        call, check, info = epf_case(dev)
    elif case.startswith("epf_step_rows_12f_k"):
        call, check, info = epf_rows_case(case, dev)
    elif case == "epf_step_ragged":
        call, check, info = epf_ragged_case(dev)
    elif case == "xyb_srgb_c4":
        call, check, info = xyb_case(dev)
    elif case.startswith("dct8_"):
        call, check, info = dct8_case(case, dev)
    else:
        call, check, info = hf_case(case, dev)
    for lib in libs.values():
        _build._lib = lib
        check()

    queued = info.pop("queued", False)
    yard_name, yard = info.pop("yardstick", (None, None))
    flush = None
    if info.pop("cold", False):
        scratch = torch.empty(32 << 20, device=dev)  # 128 MB, over the 50 MB L2
        flush = lambda: scratch.fill_(1.0)  # noqa: E731
    keys = list(libs)
    times: dict[str, list[float]] = {k: [] for k in keys}
    yard_ms = []
    for i in range(pairs + 2):  # the first two rounds warm up
        if yard is not None:
            ms = queued_ms(yard, info["reps"])
            if i >= 2:
                yard_ms.append(ms)
        for k in (keys if i % 2 == 0 else keys[::-1]):
            _build._lib = libs[k]
            ms = (queued_ms(call, info["reps"], flush) if queued
                  else CS.event_ms(call, info["reps"]))
            if i >= 2:
                times[k].append(ms)
    _build._lib = libs["A"]
    unit = info.pop("unit", None)
    unit_key = info.pop("unit_key", "ns_per_symbol")
    if sass:
        info["step_instructions"] = wavefront_step_instructions()
    if yard is not None:
        info["yardstick"] = {"what": yard_name, "ms": statistics.median(yard_ms)}
    print(json.dumps({
        "case": case, **info, "timer": "queued CUDA events, median" if queued else "CUDA events",
        "pairs": pairs, "card": torch.cuda.get_device_name(dev),
        "others": dict(zip(keys[1:], others)),
        **{k: {"ms": statistics.median(v), "ms_min": min(v), "ms_max": max(v),
               **({unit_key: statistics.median(v) * 1e6 / unit} if unit else {})}
           for k, v in times.items()},
        **{f"ratio_{k.lower()}_over_a": statistics.median(
            b / a for a, b in zip(times["A"], times[k])) for k in keys[1:]}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
