"""Build and load the CUDA kernels of csrc/ (nvcc → shared library → ctypes).

The library has a plain C interface, so one nvcc call of a few seconds
builds it, at first use, from the sources in the checkout into
`build/j40_tpu_torch/` beside the package.  The file name carries a hash of
the source and the flags, so an edited source never loads a stale build.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "reconstruct.cu"
BUILD_DIR = _PKG.parent / "build" / "j40_tpu_torch"
# sm_90a: Hopper; no --use_fast_math (the kernels keep IEEE fp32 division)
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_lib = None
#: what the last build did: {"seconds": float, "log": str, "path": str}
build_info: dict = {}


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, $PATH or /usr/local/cuda, in that order."""
    home = os.environ.get("CUDA_HOME")
    candidates = [str(Path(home) / "bin" / "nvcc")] if home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and Path(c).is_file():
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels build from source "
                       "at first use and need the CUDA toolkit")


def build() -> Path:
    """Compile csrc/reconstruct.cu unless this exact build exists."""
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"libj40tt_{tag}.so"
    if out.exists():
        build_info.update(seconds=0.0, log="cached", path=str(out))
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    r = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{r.stdout}{r.stderr}")
    os.replace(tmp, out)
    build_info.update(seconds=time.perf_counter() - t0,
                      log=r.stdout + r.stderr, path=str(out))
    return out


def load_kernels():
    """The kernel library, built and bound once per process (thread-safe)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.j40tt_reconstruct_dct8.argtypes = [p, p, p, p, p, p, i, i, i, i, p]
        lib.j40tt_reconstruct_dct8.restype = i
        lib.j40tt_reconstruct_dct8_srgb.argtypes = [
            p, p, p, p, p, p, i, i, i, i, i, p]
        lib.j40tt_reconstruct_dct8_srgb.restype = i
        lib.j40tt_xyb_to_srgb.argtypes = [p, p, p, ll, i, i, p]
        lib.j40tt_xyb_to_srgb.restype = i
        lib.j40tt_error_string.argtypes = [i]
        lib.j40tt_error_string.restype = ctypes.c_char_p
        lib.j40tt_tile_blocks.argtypes = []
        lib.j40tt_tile_blocks.restype = i
        _lib = lib
        return lib
