"""Build and load the CUDA kernels of csrc/ (nvcc → shared library → ctypes).

The library has a plain C interface, so it builds in seconds, at first use,
from the sources in the checkout into `build/j40_tpu_torch/` beside the
package: one nvcc process per source, all started together, then one link.
The file name carries a hash of the sources and the flags, so an edited
source never loads a stale build.  Nothing here runs at import time.
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
SOURCES = [_PKG / "csrc" / n
           for n in ("reconstruct.cu", "filters.cu", "hf.cu", "tokens.cu", "wavefront.cu",
                     "squeeze.cu")]
#: headers the sources include (hashed with them)
HEADERS = [_PKG / "csrc" / n for n in ("entropy.cuh", "prefix_sync.cuh")]
BUILD_DIR = _PKG.parent / "build" / "j40_tpu_torch"
# sm_90a: Hopper; no --use_fast_math (the kernels keep IEEE fp32 division)
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

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
    """Compile csrc/*.cu into one library unless this exact build exists."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in SOURCES + HEADERS:
        h.update(s.name.encode() + b"\0" + s.read_bytes())
    tag = h.hexdigest()[:12]
    out = BUILD_DIR / f"libj40tt_{tag}.so"
    if out.exists():
        build_info.update(seconds=0.0, log="cached", path=str(out))
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    objs = [tmp.with_name(f"{tmp.name}.{s.stem}.o") for s in SOURCES]
    t0 = time.perf_counter()
    nvcc = nvcc_path()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for s, o in zip(SOURCES, objs)]
    logs, failed = [], []
    for s, p in zip(SOURCES, procs):
        log = p.communicate()[0]
        logs.append(f"== {s.name}\n{log}")
        if p.returncode != 0:
            failed.append(s.name)
    if not failed:
        r = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)],
                           capture_output=True, text=True)
        logs.append(f"== link\n{r.stdout}{r.stderr}")
        if r.returncode != 0:
            failed.append("link")
    for o in objs:
        o.unlink(missing_ok=True)
    if failed:
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n" + "".join(logs))
    os.replace(tmp, out)
    build_info.update(seconds=time.perf_counter() - t0, log="".join(logs),
                      path=str(out))
    return out


def load_kernels():
    """The kernel library, built and bound once per process (thread-safe)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.j40tt_reconstruct_dct8.argtypes = [p, p, p, p, p, p, i, i, i, p]
        lib.j40tt_reconstruct_dct8.restype = i
        lib.j40tt_reconstruct_dct8_srgb.argtypes = [p, p, p, p, p, p, i, i, i, i, p]
        lib.j40tt_reconstruct_dct8_srgb.restype = i
        lib.j40tt_xyb_to_srgb.argtypes = [p, p, p, ll, i, i, p]
        lib.j40tt_xyb_to_srgb.restype = i
        # csrc/filters.cu; the EpfParams struct and the weights by pointer
        for fn in ("j40tt_epf_step", "j40tt_epf_step_rows", "j40tt_epf_fused"):
            getattr(lib, fn).argtypes = [p, p, p, i, i, p, p]
            getattr(lib, fn).restype = i
        for fn in ("j40tt_gaborish", "j40tt_gaborish_rows"):
            getattr(lib, fn).argtypes = [p, p, i, i, p, p]
            getattr(lib, fn).restype = i
        # csrc/hf.cu
        lib.j40tt_hf_walk.argtypes = [p, i, p, p, p, p, i, p, p, p, i, i, i, i, i, p, i, p, p]
        lib.j40tt_hf_walk.restype = i
        lib.j40tt_hf_walk_scratch.argtypes = [i] * 5
        lib.j40tt_hf_walk_scratch.restype = ll
        lib.j40tt_hf_ctx_walk.argtypes = [
            p, i, p, p, p, p, i, p, i, p, p, p, i, p, p, i, i, i, i, i, p]
        lib.j40tt_hf_ctx_walk.restype = i
        # csrc/tokens.cu
        lib.j40tt_tokens.argtypes = [p, i, p, p, p, p, i, p, p, p, p, p, p,
                                     i, i, i, i, i, p, i, p, i, i, p, p, p]
        lib.j40tt_tokens.restype = i
        lib.j40tt_tokens_scratch.argtypes = [i] * 7
        lib.j40tt_tokens_scratch.restype = ll
        lib.j40tt_sync_stats_at.argtypes = [i, i]
        lib.j40tt_sync_stats_at.restype = ll
        # csrc/wavefront.cu
        lib.j40tt_wavefront.argtypes = [p, p, p, i, i, i, p]
        lib.j40tt_wavefront.restype = i
        lib.j40tt_wavefront_wp.argtypes = [p, p, p, i, i, p, p, p, p, p, i, i, i, p]
        lib.j40tt_wavefront_wp.restype = i
        lib.j40tt_wavefront_limits.argtypes = [p]
        lib.j40tt_wavefront_limits.restype = i
        # csrc/squeeze.cu; the inputs' strides in elements
        lib.j40tt_unsqueeze.argtypes = [p, ll, ll, p, ll, ll, p, i, i, i, i, p]
        lib.j40tt_unsqueeze.restype = i
        lib.j40tt_error_string.argtypes = [i]
        lib.j40tt_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib
