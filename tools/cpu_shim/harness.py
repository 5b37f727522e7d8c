"""Run a shim-built kernel library (build.sh) in place of the CUDA one: the
wrappers then take their CUDA branch on CPU tensors and call the kernels'
C entry points, which run one std::thread per CUDA thread.

    import harness as H
    H.use("build/libshim.so")
    H.enable(True)    # wrappers launch the shim's kernels on CPU tensors
    ...               # e.g. hf_kernels.launch_hf_ctx(d_on_cpu, ...)
    H.enable(False)   # back to the plain versions

For debugging without a card only; the tests never use it.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from j40_tpu_torch.ops import _build  # noqa: E402
from j40_tpu_torch.ops import kernels as K  # noqa: E402

_ON_CUDA = K._on_cuda


def use(lib_path) -> None:
    """Bind the wrappers to the library at lib_path."""
    _build._lib = None
    _build.build = lambda: Path(lib_path)
    _build.load_kernels()


def enable(on: bool = True) -> None:
    K._on_cuda = (lambda *ts: True) if on else _ON_CUDA


def _launch(name, fn, device, *args):
    rc = getattr(_build.load_kernels(), fn)(*args, None)
    if rc:
        raise RuntimeError(f"{fn}: {rc}")
    K._count(name)


K._launch = _launch
