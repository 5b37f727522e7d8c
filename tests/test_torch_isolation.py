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
    sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_no_forbidden_imports(path):
    bad = [
        m for m in _imports(path)
        if m.split(".")[0] in ("jax", "jaxlib", "j40_tpu")
    ]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


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
    dict(keep_device_output=True), dict(apply_filters=True),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_unported_options_raise(kw):
    """What the port does not run yet raises; nothing falls back."""
    from j40_tpu_torch.decode import Decoder
    from j40_tpu_torch.encode.vardct_enc import encode_vardct
    from j40_tpu_torch.errors import Unsupported

    data = encode_vardct(np.full((16, 16, 3), 90, np.uint8))
    with pytest.raises(Unsupported, match="ROADMAP|use one of"):
        Decoder(data, device="cpu", **kw)


def test_render_rgba8_device_raises():
    from j40_tpu_torch.decode import Decoder
    from j40_tpu_torch.encode.vardct_enc import encode_vardct
    from j40_tpu_torch.errors import Unsupported

    dec = Decoder(encode_vardct(np.full((16, 16, 3), 90, np.uint8)), device="cpu")
    dec.decode_frame()
    with pytest.raises(Unsupported, match="ROADMAP A.5"):
        dec.render_rgba8_device()
