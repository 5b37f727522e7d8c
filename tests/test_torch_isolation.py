"""The PyTorch port stands alone: it imports neither jax nor j40_tpu, its
host layers are byte-for-byte copies of j40_tpu's, and it never runs on the
CPU unless asked to."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "j40_tpu_torch"

# files the port keeps verbatim (relative to each package root)
VERBATIM = sorted(
    [
        "errors.py", "limits.py", "mathutil.py", "frame_state.py",
        "vardct/__init__.py", "vardct/tables.py", "vardct/order.py",
        "vardct/special.py", "vardct/dct.py", "vardct/dequant.py",
        "vardct/native_combine.py",
        "native/__init__.py", "native/bindings.py", "native/core.cpp",
        "native/reconstruct.cpp", "native/Makefile",
        "ops/__init__.py", "ops/upsample.py",
    ]
    + [
        str(p.relative_to(ROOT / "j40_tpu"))
        for d in ("io", "headers", "entropy", "modular", "encode")
        for p in (ROOT / "j40_tpu" / d).glob("*.py")
    ]
)

_SCRIPT = r"""
import sys, importlib.abc

BLOCKED = ("jax", "jaxlib", "j40_tpu")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} blocked (the port must not need it)")

sys.meta_path.insert(0, Block())
for m in [m for m in sys.modules if m.split(".")[0] in BLOCKED]:
    del sys.modules[m]
import numpy as np
import j40_tpu_torch
from j40_tpu_torch.api import Image, RGBA, U8X4
from j40_tpu_torch.encode.vardct_enc import encode_vardct_mixed
from j40_tpu_torch.encode.encoder import encode_modular

rng = np.random.default_rng(9)
img = (np.cumsum(np.cumsum(rng.integers(-2, 3, size=(150, 260, 3)), 0), 1)
       % 200 + 20).astype(np.uint8)
img[:64, :128] = img[3, 3]
for enc in (encode_modular, encode_vardct_mixed):
    data = enc(img)
    im = Image.from_memory(data, device="cpu")
    assert im.output_format(RGBA, U8X4)
    assert im.next_frame(), im.error_string()
    assert im.current_frame().pixels_u8x4().shape == (150, 260, 4)
    _, rgba = j40_tpu_torch.decode_file(data, device="cpu")
    assert rgba.shape == (150, 260, 4)
# the restoration filters (ops/filters.py, ops/filter_kernels.py)
from j40_tpu_torch.decode import Decoder
dec = Decoder(data, device="cpu", apply_filters=True)
dec.decode_frame()
assert dec.render_rgba8().shape == (150, 260, 4)
# the on-chip HF entropy route (ops/device_vardct.py, ops/hf_kernels.py)
dec = Decoder(data, backend="device", device="cpu")
dec.decode_frame()
assert dec.stats["device_vardct"]["lanes"] > 0
assert dec.render_rgba8().shape == (150, 260, 4)
# the modular device lanes (ops/device_modular.py, ops/token_kernels.py)
from j40_tpu_torch.encode.encoder import EncodeOptions
data = encode_modular(img[:16, :136], options=EncodeOptions(group_size_shift=7))
dec = Decoder(data, backend="device", device="cpu")
dec.decode_frame()
assert dec.stats["device_modular"]["lanes"] == 2
assert dec.render_rgba8().shape == (16, 136, 4)
# the wavefronts' wrappers (ops/wavefront_kernels.py), CPU tensors to
# their plain versions
import torch
from j40_tpu_torch.modular.wp import WPParams
from j40_tpu_torch.ops import wavefront_kernels as WK
res = torch.from_numpy(rng.integers(-9, 10, size=(2, 5, 7)).astype(np.int32))
assert WK.plain_wavefront(res, None, 5, 7).shape == (2, 5, 7)
assert WK.wp_wavefront(res, None, 5, 7, WPParams())[1].tolist() == [False, False]
tree = ((15, 0, 1, 2, 0, 0, 0), (-1, 0, 0, 0, 6, 0, 1), (-1, 0, 0, 0, 5, 0, 1))
assert WK.tree_wavefront(res, tree, 0, [0, 1], 5, 7, WPParams())[0].shape == (2, 5, 7)
# multi-device decode (parallel/mesh.py, parallel/sharded_*.py,
# ops/sharded_filters.py, graft_entry.py) on a CPU mesh
import j40_tpu_torch.graft_entry
import j40_tpu_torch.ops.sharded_filters
import j40_tpu_torch.parallel.sharded_entropy
import j40_tpu_torch.parallel.sharded_lossless
from j40_tpu_torch.parallel.mesh import Mesh
from j40_tpu_torch.parallel.sharded_decode import decode_sharded
mesh = Mesh(["cpu"] * 2, ("rows",))
assert decode_sharded(encode_vardct_mixed(img), mesh=mesh).shape == (150, 260, 3)
assert decode_sharded(data, mesh=mesh).shape == (16, 136, 3)
fn, args = j40_tpu_torch.graft_entry.entry(device="cpu")
assert fn(*args).shape == (3, 64, 64)
assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
print("OK")
"""


def test_decode_without_jax_or_j40_tpu():
    r = subprocess.run(
        [sys.executable, "-c", _SCRIPT],
        capture_output=True, text=True, cwd=str(ROOT), timeout=600,
    )
    assert r.returncode == 0 and "OK" in r.stdout, r.stdout + r.stderr


def _imports(path: Path):
    """Every module name an import statement in `path` names (absolute
    names, plus relative ones resolved against the package)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                yield node.module or ""
            else:
                pkg = list(path.relative_to(ROOT).parent.parts)
                base = pkg[: len(pkg) - (node.level - 1)]
                yield ".".join(base + ([node.module] if node.module else []))


@pytest.mark.parametrize(
    "path",
    sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                  ROOT / "examples" / "serve_device_torch.py",
                                  ROOT / "tools" / "squeeze_model.py",
                                  ROOT / "tools" / "photo_reference.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_no_forbidden_imports(path):
    bad = [
        m for m in _imports(path)
        if m.split(".")[0] in ("jax", "jaxlib", "j40_tpu")
    ]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_every_kernel_source_is_built():
    """The one kernel library is built from every CUDA source of csrc/
    (reconstruct.cu, filters.cu, hf.cu, tokens.cu, wavefront.cu and
    squeeze.cu, hashed with the headers they include), and its wrappers are
    in the scan above."""
    from j40_tpu_torch.ops import _build

    assert sorted(_build.SOURCES) == sorted((PORT / "csrc").glob("*.cu"))
    assert {p.name for p in _build.SOURCES} == {"reconstruct.cu", "filters.cu", "hf.cu",
                                                "tokens.cu", "wavefront.cu", "squeeze.cu"}
    assert sorted(_build.HEADERS) == sorted((PORT / "csrc").glob("*.cuh"))
    for wrappers in ("filter_kernels.py", "hf_kernels.py", "token_kernels.py",
                     "device_modular.py", "wavefront_kernels.py", "squeeze_kernels.py"):
        assert (PORT / "ops" / wrappers) in set(PORT.rglob("*.py"))


def test_package_data_ships_every_kernel_source():
    """An installed package builds its kernels from the package data, so the
    globs for csrc/ match every source and every header the build reads."""
    import fnmatch
    import tomllib

    from j40_tpu_torch.ops import _build

    conf = tomllib.loads((ROOT / "pyproject.toml").read_text())
    globs = conf["tool"]["setuptools"]["package-data"]["j40_tpu_torch.csrc"]
    missing = [p.name for p in _build.SOURCES + _build.HEADERS
               if not any(fnmatch.fnmatch(p.name, g) for g in globs)]
    assert not missing, f"pyproject.toml does not ship {missing}"


@pytest.mark.parametrize("rel", VERBATIM)
def test_copies_unchanged(rel):
    assert (PORT / rel).read_bytes() == (ROOT / "j40_tpu" / rel).read_bytes()


def test_no_silent_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from j40_tpu_torch import decode_file
    from j40_tpu_torch.encode.vardct_enc import encode_vardct

    data = encode_vardct(np.full((16, 16, 3), 90, np.uint8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        decode_file(data)


@pytest.mark.parametrize("kw", [
    dict(backend="device"), dict(backend="jax"), dict(backend="auto"),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_unported_options_raise(kw):
    """What the port does not run yet raises; nothing falls back.  The
    device backend, which once refused modular frames, now decodes them:
    its case checks that a modular frame's sections go through the device
    lanes (ROADMAP A.8) and give the host plan's pixels."""
    from j40_tpu_torch.decode import Decoder
    from j40_tpu_torch.encode.encoder import EncodeOptions, encode_modular
    from j40_tpu_torch.encode.vardct_enc import encode_vardct
    from j40_tpu_torch.errors import Unsupported

    if kw.get("backend") == "device":
        data = encode_modular(np.full((16, 136, 3), 90, np.uint8),
                              options=EncodeOptions(group_size_shift=7))
        dec = Decoder(data, device="cpu", **kw)
        dec.decode_frame()
        assert dec.stats["device_modular"]["lanes"] == 2
        host = Decoder(data, backend="numpy")
        host.decode_frame()
        np.testing.assert_array_equal(dec.render_rgba8(), host.render_rgba8())
        return
    data = encode_vardct(np.full((16, 16, 3), 90, np.uint8))
    with pytest.raises(Unsupported, match="ROADMAP|use one of"):
        Decoder(data, device="cpu", **kw).decode_frame()


def test_apply_filters_decodes():
    """The restoration filters run on the torch backend, here through their
    plain versions."""
    from j40_tpu_torch.decode import Decoder
    from j40_tpu_torch.encode.vardct_enc import encode_vardct

    data = encode_vardct(np.full((16, 16, 3), 90, np.uint8))
    dec = Decoder(data, device="cpu", apply_filters=True)
    dec.decode_frame()
    assert dec.render_rgba8().shape == (16, 16, 4)


def test_keep_device_output_planes_route():
    """keep_device_output keeps the LF groups' u8 planes on the device, and
    render_rgba8_device assembles them into the host render's pixels."""
    from j40_tpu_torch.decode import Decoder
    from j40_tpu_torch.encode.vardct_enc import encode_vardct

    dec = Decoder(encode_vardct(np.full((16, 16, 3), 90, np.uint8)), device="cpu",
                  keep_device_output=True)
    dec.decode_frame()
    got = dec.render_rgba8_device()
    assert dec.stats["device_output"] == "planes"
    np.testing.assert_array_equal(got.numpy(), dec.render_rgba8())


def test_render_rgba8_device_raises():
    """render_rgba8_device raises before a frame is decoded."""
    from j40_tpu_torch.decode import Decoder
    from j40_tpu_torch.encode.vardct_enc import encode_vardct

    dec = Decoder(encode_vardct(np.full((16, 16, 3), 90, np.uint8)), device="cpu")
    with pytest.raises(AssertionError, match="decode a frame first"):
        dec.render_rgba8_device()


def test_render_rgba8_device_host_render_route():
    """A frame decoded without keep_device_output kept no device planes:
    render_rgba8_device uploads the host render and says so."""
    from j40_tpu_torch.decode import Decoder
    from j40_tpu_torch.encode.vardct_enc import encode_vardct

    dec = Decoder(encode_vardct(np.full((16, 16, 3), 90, np.uint8)), device="cpu")
    dec.decode_frame()
    got = dec.render_rgba8_device()
    assert dec.stats["device_output"] == "host_render"
    assert got.device.type == "cpu" and got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), dec.render_rgba8())
