// What the entropy-decode kernels of csrc/ share: the per-lane bit reader
// and the opt-in to dynamic shared memory above 48 KB.  Included by hf.cu
// (B4, B5) and tokens.cu (B6).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSmemDefault = 48 * 1024;

// LSB-first bit buffer over one lane's 16-bit words; zeros past the end, as
// the host reader pads a section that runs short.  After refill() at least
// 49 bits are buffered: a symbol reads at most 33 (16 renormalization bits
// or a prefix code of <= 15, then <= 17 hybrid-int bits).
struct Bits {
  const uint16_t* w;
  int nw;
  int pos;  // next word to load
  int n;    // valid bits in buf
  uint64_t buf;

  __device__ __forceinline__ void refill() {
    while (n <= 48) {
      const uint64_t v = pos < nw ? w[pos] : 0;
      buf |= v << n;
      ++pos;
      n += 16;
    }
  }
  __device__ __forceinline__ void seek(int bitpos) {
    pos = bitpos >> 4;
    n = 0;
    buf = 0;
    refill();
    drop(bitpos & 15);
  }
  __device__ __forceinline__ uint32_t peek() const { return (uint32_t)buf; }
  __device__ __forceinline__ void drop(int k) {
    buf >>= k;
    n -= k;
  }
  __device__ __forceinline__ int bitpos() const { return pos * 16 - n; }
};

// Dynamic shared memory above 48 KB needs the kernel's opt-in.
template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= kSmemDefault) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace
