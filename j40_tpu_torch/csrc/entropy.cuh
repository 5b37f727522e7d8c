// What the entropy-decode kernels of csrc/ share: the bit readers, the
// fused table entry of the B4/B6 serial chains and the opt-in to dynamic
// shared memory above 48 KB.  Included by hf.cu (B4, B5), tokens.cu (B6)
// and prefix_sync.cuh.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSmemDefault = 48 * 1024;

// LSB-first bit buffer over one lane's 16-bit words; zeros past the end, as
// the host reader pads a section that runs short.  After refill() at least
// 49 bits are buffered: a symbol reads at most 33 (16 renormalization bits
// or a prefix code of <= 15, then <= 17 hybrid-int bits).  The short
// decodes of the self-synchronising phases and their serial tails use it.
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

// The bit reader of the serial rANS chains: the same 64-bit LSB-first
// buffer, refilled 32 bits at a time from two registers whose loads were
// issued one and two refills earlier, so that no global load waits on the
// chain.  A symbol reads at most 33 bits, so refill() is called twice before
// each symbol: the second refill happens only when the first left the buffer
// at exactly 32 bits (it was empty), and neither loops.
struct Reader {
  const uint16_t* w;
  int nw;
  int next;  // next 16-bit word to load into q1
  int n;     // valid bits in buf
  uint64_t buf;
  uint32_t q0, q1;  // the next 64 bits of the stream, not yet in buf

  __device__ __forceinline__ uint32_t load32(int i) const {
    const uint32_t a = i < nw ? w[i] : 0, b = i + 1 < nw ? w[i + 1] : 0;
    return a | (b << 16);
  }
  __device__ __forceinline__ void seek(int bitpos) {
    const int i = bitpos >> 4;
    buf = (uint64_t)load32(i) | ((uint64_t)load32(i + 2) << 32);
    n = 64;
    q0 = load32(i + 4);
    q1 = load32(i + 6);
    next = i + 8;
    drop(bitpos & 15);
  }
  __device__ __forceinline__ void refill() {
    if (n < 33) {
      buf |= (uint64_t)q0 << n;
      n += 32;
      q0 = q1;
      q1 = load32(next);
      next += 2;
    }
  }
  __device__ __forceinline__ uint32_t peek() const { return (uint32_t)buf; }
  __device__ __forceinline__ void drop(int k) {
    buf >>= k;
    n -= k;
  }
  __device__ __forceinline__ int bitpos() const { return (next - 4) * 16 - n; }
};

// One fused table entry per (table, slot) of the redesigned chains, so that
// a symbol costs one 8-byte load: y is the hybrid-int value's base, (a <<
// mb) | lo (j40.h:2313-2327), to which the symbol's mb extra bits are ORed at
// lsb; x holds mb at kMbShift and below it, for rANS, freq (13 bits, 4096
// whole) | base << 13, for a prefix code the code length.
constexpr int kMbShift = 25;

__device__ __forceinline__ int fused_mb(uint2 e) { return (int)(e.x >> kMbShift); }

// The value of a symbol whose table entry is e, reading its extra bits from
// the buffer b (prefix code bits or renormalization bits already dropped).
template <typename Buf>
__device__ __forceinline__ int fused_value(Buf& b, uint2 e, int lsb) {
  const int mb = fused_mb(e);
  const uint32_t mid = b.peek() & ((1u << mb) - 1);
  b.drop(mb);
  return (int)(e.y | (mid << lsb));
}

// Dynamic shared memory above 48 KB needs the kernel's opt-in.
template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= kSmemDefault) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace
