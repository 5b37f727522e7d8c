"""Entry points of the port for a compile check and a multi-device dry run
(counterpart of the repository's __graft_entry__.py).

- entry(): the single-device reconstruction step of the flagship pipeline
  (dequant + CfL + LLF + IDCT + XYB→sRGB of an all-DCT8x8 plane) and its
  example inputs;
- dryrun_multichip(n): real JPEG XL bitstreams decoded across an n-device
  mesh (parallel/mesh.py) by every sharded path of the port, each held
  against the single-device host decode.
"""

from __future__ import annotations

import numpy as np
import torch


def _example_inputs(h8=8, w8=8, device=None):
    """The example inputs of __graft_entry__._example_inputs, as tensors on
    `device` (CUDA unless the caller names another)."""
    from .headers.image import OPSIN_BIAS, OPSIN_INV_MAT, QUANT_BIAS, QUANT_BIAS_NUM
    from .ops.kernels import resolve_device
    from .vardct.dequant import DqMatrix, load_dq_matrix

    dev = resolve_device(device)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)

    n = h8 * w8
    rng = np.random.default_rng(0)
    return (
        t(rng.integers(-3, 4, size=(3, n, 64))),
        t(rng.normal(size=(3, n))),
        t(np.full((n,), 1.0 / 8.0)),
        t(np.zeros((n,))),
        t(np.ones((n,))),
        t(load_dq_matrix(0, DqMatrix())),
        t(65536.0 / 32768.0),
        t([0.8, 1.0, 1.0]),
        t(QUANT_BIAS),
        t(QUANT_BIAS_NUM),
        t(OPSIN_INV_MAT),
        t([OPSIN_BIAS] * 3),
        t(1.0),
        t(255.0),
    )


def entry(device=None):
    """Returns (fn, example_args): fn is ops/reconstruct._reconstruct_dct8_jit
    on an 8x8-block plane, which returns (3, 64, 64) int32 pre-clamp sRGB."""
    import functools

    from .ops.reconstruct import _reconstruct_dct8_jit

    h8 = w8 = 8
    fn = functools.partial(_reconstruct_dct8_jit, h8=h8, w8=w8)
    return fn, _example_inputs(h8, w8, device)


def _mesh_devices(n_devices: int, device) -> list:
    """n devices: the CPU n times for device="cpu"; otherwise the CUDA
    devices, cuda:0 repeated when the card is alone (the devices cycle)."""
    from .ops.kernels import resolve_device

    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev] * n_devices
    count = torch.cuda.device_count()
    return [torch.device("cuda", i % count) for i in range(n_devices)]


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Decode REAL JPEG XL bitstreams across an n-device mesh and assert
    pixel parity against the single-device host decoder (the port's
    `backend="numpy"`), leg for leg as __graft_entry__.dryrun_multichip:

    1. multi-LF-group mixed-DctSelect images (2 x 2048 px LF groups, a flat
       band of non-8x8 varblocks) on a 2-D ("img", "rows") mesh
       (decode_sharded_batch), each within 1 gray level;
    2. a ragged-height image decoded WITH restoration filters: gaborish
       (1-row halos) and the 3-step EPF (3-row halos) exchanged over the
       mesh, within 1 level of `Decoder(apply_filters=True)`;
       2b. group-aligned mixed classes computed inside the shards (no
       overlay), within 1 level;
    3. lossless Modular (Squeeze + RCT), bit-exact;
    4. a 12-bit VarDCT frame rendered at 16 bits (within 17 units, one
       12-bit level), and a YCbCr 4:2:0 Modular frame through
       decode_sharded (within 1 level);
    5. per-shard on-device entropy decode (B6 once a shard), every plane
       bit-exact with the host.  On the CPU the token kernel's plain
       version takes ~0.25 ms a symbol step, so that leg's image is 8 rows
       high there (128 on the card, as j40_tpu's).

    `device`: "cpu" runs Mesh([cpu] * n); otherwise the CUDA devices.
    Returns the legs' largest differences and counts; prints a summary."""
    from .decode import Decoder
    from .encode.advanced import AdvancedOptions, encode_modular_advanced
    from .encode.encoder import EncodeOptions, encode_modular
    from .encode.vardct_enc import VarDCTOptions, encode_vardct, encode_vardct_mixed
    from .parallel.mesh import Mesh
    from .parallel.sharded_decode import (
        _run_sharded, decode_sharded, decode_sharded_batch, plan_frame)
    from .parallel.sharded_entropy import decode_modular_sections_sharded
    from .parallel.sharded_lossless import decode_sharded_lossless

    devices = _mesh_devices(n_devices, device)
    on_cpu = devices[0].type == "cpu"

    def host(blob, depth=8, **kw):
        d = Decoder(blob, backend="numpy", **kw)
        d.decode_frame()
        return d, (d.render_rgba8() if depth == 8 else d.render_rgba16())

    def diff(a, b):
        return int(np.abs(a.astype(np.int64) - b[:, :, :3].astype(np.int64)).max())

    # factor n_devices into a 2-D (img, rows) mesh
    img, rows = 1, n_devices
    for d in (2, 4):
        if n_devices % d == 0 and d <= n_devices // d:
            img, rows = d, n_devices // d
    mesh2d = Mesh(np.asarray(devices, dtype=object).reshape(img, rows), ("img", "rows"))
    mesh1d = Mesh(devices, ("rows",))

    # --- 1. multi-LF-group batch decode, (img x rows) mesh
    rng = np.random.default_rng(5)
    height = 8 * max(8, rows)  # the rows axis always divides the block grid
    imgs = []
    for _ in range(max(2, img)):
        im_ = (np.cumsum(rng.integers(-2, 3, size=(height, 2560, 3)), axis=1)
               % 180 + 30).astype(np.uint8)
        im_[:32, :256] = im_[3, 3]  # flat band -> non-8x8 varblocks
        imgs.append(im_)
    stats: dict = {}
    blobs = [encode_vardct_mixed(im, stats_out=stats) for im in imgs]
    assert any(k != 0 for k in stats.get("dctsel_counts", {})), \
        "expected a mixed-DctSelect layout"
    outs = decode_sharded_batch(blobs, mesh2d, apply_filters=False)
    diff1 = 0
    for blob, out in zip(blobs, outs):
        dec, ref = host(blob)
        nlf = dec.stats["num_lf_groups"]
        assert nlf >= 2, "expected a multi-LF-group bitstream"
        diff1 = max(diff1, diff(out, ref))
    assert diff1 <= 1, f"sharded decode mismatch: max |diff| = {diff1}"

    # --- 2. filtered ragged-height decode, halo exchange
    height = 32 * n_devices - 3  # ragged: the pad rows exercise the mirror
    img2 = (np.cumsum(np.cumsum(rng.integers(-2, 3, size=(height, 192, 3)), axis=0),
                      axis=1) % 200 + 20).astype(np.uint8)
    blob2 = encode_vardct(img2, VarDCTOptions(sharpness=7))
    _, ref2 = host(blob2, apply_filters=True)
    diff2 = diff(decode_sharded(blob2, mesh=mesh1d, apply_filters=True), ref2)
    assert diff2 <= 1, f"filtered sharded decode mismatch: max |diff| = {diff2}"

    # --- 2b. group-aligned mixed-DctSelect decode: shard boundaries on
    # 256-px group multiples, so the non-8x8 classes run inside the shards
    img2b = (np.cumsum(rng.integers(-2, 3, size=(256 * n_devices, 256, 3)), axis=1)
             % 180 + 30).astype(np.uint8)
    img2b[:64, :96] = img2b[3, 3]  # flat band -> non-8x8 varblocks
    blob2b = encode_vardct_mixed(img2b)
    plan2b = plan_frame(blob2b, owners=n_devices)
    assert plan2b.classes, "expected non-8x8 classes in the 2b stream"
    out2b = _run_sharded([plan2b], mesh1d, ("rows",), False)[0]
    assert plan2b.overlay is None, \
        "group-aligned stream must run mixed classes as shard compute"
    diff2b = diff(out2b, host(blob2b)[1])
    assert diff2b <= 1, f"mixed-compute sharded mismatch: {diff2b}"

    # --- 3. lossless Modular (MA tree + RCT + Squeeze), integer: EXACT
    img3 = (np.cumsum(rng.integers(-3, 4, size=(320, 512, 3)), axis=1)
            % 200 + 20).astype(np.uint8)
    blob3 = encode_modular_advanced(img3, options=AdvancedOptions(squeeze=True, rct_type=6))
    d3, ref3 = host(blob3, workers=2)
    assert d3.stats["num_groups"] >= 2, "expected a multi-group stream"
    assert np.array_equal(decode_sharded_lossless(blob3, mesh=mesh1d), ref3), \
        "sharded lossless decode not bit-exact"

    # --- 4a. bpp=12 VarDCT rendered at 16 bits (1 bpp-domain gray level =
    # ceil(65535/4095) = 17 output units)
    img4 = (np.cumsum(np.cumsum(rng.integers(-20, 21, (24 * n_devices, 112, 3)), 0), 1)
            % 3800 + 100).astype(np.uint16)
    blob4 = encode_vardct(img4, VarDCTOptions(bpp=12))
    _, ref4 = host(blob4, depth=16, apply_filters=True)
    out4 = decode_sharded(blob4, mesh=mesh1d, apply_filters=True, bit_depth=16)
    assert out4.dtype == np.uint16
    diff4 = diff(out4, ref4)
    assert diff4 <= 17, f"sharded 16-bit mismatch: {diff4}"

    # --- 4b. YCbCr modular frame (subsampled chroma) through the unified
    # decode_sharded entry
    img5 = (np.cumsum(rng.integers(-3, 4, (96, 128, 3)), 1) % 200).astype(np.uint8)
    blob5 = encode_modular(img5, options=EncodeOptions(ycbcr=True, ycbcr_subsample=(1, 0, 1)))
    diff5 = diff(decode_sharded(blob5, mesh=mesh1d), host(blob5)[1])
    assert diff5 <= 1, f"sharded ycbcr mismatch: {diff5}"

    # --- 5. per-shard on-device entropy decode of the sections' raw bytes
    rows6 = 8 if on_cpu else 128
    img6 = (np.cumsum(rng.integers(-3, 4, size=(rows6, 128 * n_devices, 3)), axis=1)
            % 200 + 20).astype(np.uint8)
    blob6 = encode_modular(img6, options=EncodeOptions(
        global_tree=True, use_prefix=False, group_size_shift=7))
    planes6, lanes6, dec6 = decode_modular_sections_sharded(blob6, mesh1d, axis="rows")
    gm6 = dec6._deferred[2].gmodular
    n_ok = 0
    for k, ln in enumerate(lanes6):
        for c, (gi, x0, y0, w, h) in enumerate(ln.picks):
            ref = np.asarray(gm6.channels[gi].data[y0:y0 + h, x0:x0 + w])
            assert np.array_equal(planes6[k, c], ref), \
                f"sharded-entropy mismatch at section {k} ch {c}"
            n_ok += 1
    assert len(lanes6) >= n_devices

    out = dict(mesh=(img, rows), devices=[str(d) for d in devices], lf_groups=nlf,
               batch_max_diff=diff1, filtered_max_diff=diff2, mixed_compute_max_diff=diff2b,
               lossless_bit_exact=True, bit16_max_diff=diff4, ycbcr_max_diff=diff5,
               entropy_sections=len(lanes6), entropy_planes_exact=n_ok)
    print(
        f"dryrun_multichip: mesh=({img}x{rows}) on {sorted(set(out['devices']))} "
        f"decoded {len(blobs)} real bitstreams ({imgs[0].shape[1]}x{imgs[0].shape[0]}, "
        f"{nlf} LF groups, max|diff|={diff1}) + filtered ragged "
        f"{img2.shape[1]}x{img2.shape[0]} over {n_devices}-way halo exchange "
        f"(max|diff|={diff2}) + group-aligned mixed classes as shard compute "
        f"(max|diff|={diff2b}) + lossless Squeeze+RCT {img3.shape[1]}x{img3.shape[0]} "
        f"bit-exact on the mesh + 16-bit VarDCT render (max|diff|={diff4}/17) + YCbCr "
        f"420 modular via the unified entry (max|diff|={diff5}) + per-shard on-device "
        f"entropy decode of {len(lanes6)} sections' raw bytes ({n_ok} planes "
        f"bit-exact) ok")
    return out
