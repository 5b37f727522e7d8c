"""j40_tpu_torch — the PyTorch/CUDA port of the j40_tpu JPEG XL decoder.

Host layers (bitstream, headers, entropy, Modular, VarDCT bookkeeping, the
native C++ core and the encoders) are kept as copies of j40_tpu's; the
VarDCT reconstruction (dequant, chroma-from-luma, IDCT, XYB→sRGB) runs in
PyTorch with hand-written CUDA kernels for Hopper (csrc/reconstruct.cu).
Entry points run on the CUDA device unless the caller passes `device=`::

    from j40_tpu_torch import decode_file
    dec, rgba = decode_file(data)                  # CUDA
    dec, rgba = decode_file(data, device="cpu")    # plain PyTorch on the CPU
"""

__version__ = "0.1.0"

import os as _os

# On VMs whose kernels fault transparent hugepages in slowly (measured
# ~0.3 s per 2 MiB fault on Firecracker guests), numpy's MADV_HUGEPAGE on
# large mallocs turns every fresh canvas/plane allocation into seconds of
# first-touch stalls (an 8 s np.full for a 50 MB canvas).  Default it off;
# export NUMPY_MADVISE_HUGEPAGE=1 before importing to keep hugepages on
# hosts with a healthy THP path.  Effective only if numpy is not imported
# yet; the hot paths also prefer calloc-backed np.zeros for large buffers.
_os.environ.setdefault("NUMPY_MADVISE_HUGEPAGE", "0")

from .errors import J40Error, ShortInput, Unsupported  # noqa: F401,E402
from .decode import decode_file  # noqa: F401,E402
