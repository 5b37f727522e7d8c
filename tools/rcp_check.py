"""Check, on a CUDA card, that csrc/filters.cu's branch-free reciprocal
(rcp_rn_normal, B7's one reciprocal a pixel) equals the correctly rounded
reciprocal (__frcp_rn, PTX rcp.rn.f32) for every float in [1, 2^126): B7's
weight sums are 1 plus weights that are not negative.

    python3 tools/rcp_check.py

Builds a test kernel that includes filters.cu (nvcc, sm_90a) into
build/rcp_check/ and prints one JSON line with the count of floats
checked and of those that differ.
"""

import ctypes
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

SOURCE = r'''
#include "%s"
namespace {
__global__ void rcp_check_kernel(unsigned lo, unsigned n, unsigned long long* bad) {
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    const float x = __uint_as_float(lo + i);
    if (__float_as_uint(rcp_rn_normal(x)) != __float_as_uint(__frcp_rn(x))) atomicAdd(bad, 1ull);
  }
}
}  // namespace
extern "C" int rcp_check(unsigned lo, unsigned n, unsigned long long* bad_host) {
  unsigned long long* bad;
  cudaMalloc(&bad, sizeof(*bad));
  cudaMemset(bad, 0, sizeof(*bad));
  rcp_check_kernel<<<1024, 256>>>(lo, n, bad);
  cudaMemcpy(bad_host, bad, sizeof(*bad), cudaMemcpyDeviceToHost);
  cudaFree(bad);
  return (int)cudaGetLastError();
}
'''


def main() -> int:
    import numpy as np

    from j40_tpu_torch.ops import _build

    out = REPO / "build" / "rcp_check"
    out.mkdir(parents=True, exist_ok=True)
    src = out / "rcp_check.cu"
    src.write_text(SOURCE % (REPO / "j40_tpu_torch" / "csrc" / "filters.cu"))
    lib = out / "librcp_check.so"
    subprocess.run([_build.nvcc_path(), *_build.ARCH, "-std=c++17", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", str(lib), str(src)], check=True)
    f = ctypes.CDLL(str(lib)).rcp_check
    f.argtypes = [ctypes.c_uint, ctypes.c_uint, ctypes.POINTER(ctypes.c_ulonglong)]
    lo = int(np.float32(1.0).view(np.uint32))
    n = int(np.float32(2.0 ** 126).view(np.uint32)) - lo
    bad = ctypes.c_ulonglong(0)
    rc = f(lo, n, ctypes.byref(bad))
    if rc:
        raise RuntimeError(f"rcp_check: CUDA error {rc}")
    print(json.dumps({"range": [1.0, 2.0 ** 126], "floats": n, "differ": bad.value}))
    return 0 if bad.value == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
