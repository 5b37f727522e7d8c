// Hand-written Hopper (sm_90a) kernel of the modular device lanes' token
// decode: per lane, `nsym` hybrid-int values from one pass-group section's
// entropy stream (an isolated stream, j40.h:447, 7749-7776), the final rANS
// state and the final bit position.
//
// It replaces the Pallas TPU kernel j40_tpu/ops/pallas_entropy.py
// _make_kernel (B6: the 128-lane rANS/prefix token loop for one shared
// single-cluster spec) and the two lax.scan decoders beside it
// (ops/device_entropy.py decode_tokens, decode_tokens_ctx), whose torch
// ports would cost one launch per operation per symbol step.  One kernel,
// three table modes, set by the inputs alone:
//
//   shared spec   every lane's `rows` entry names one table row (B6's case)
//   per lane      each lane its own row (sections with local trees)
//   per token     `cids` selects the cluster of every token (static MA trees)
//
// The tables are those of the plain version, device_entropy.decode_tokens_ctx
// (j40_tpu's decode_tokens_ctx inputs), so kernel and plain version compute
// one function from one set of inputs: per row and cluster c, sym (S
// entries: rANS symbol, or prefix len << 16 | sym over S = 2^k bits), fb
// (rANS freq << 12 | base, 4096 entries; unused for prefix), the hybrid-int
// tables mb, a, lo (amax entries) and lsb.  The rANS initial state is read
// from the stream after the lane's skip bits (j40.h:2446); a freq of 4096
// (a one-symbol distribution) is stored whole, and a prefix code with a
// single symbol has length 0 in every entry; tokens whose extra bits would
// exceed the refill discipline have mb = a = lo = 0 (hybrid_luts), and the
// packer keeps such tokens out of reach (spec_is_device_simple).
//
// Bound: bytes — the section streams read once and the values written once
// (4 bytes per symbol); at 3.35 TB/s some microseconds.  The real limit is
// the serial chain of the longest lane: each symbol's table index and bit
// position depend on the one before.  As B4 (csrc/hf.cu), this design
// accepts that: one lane per thread block, whose threads stage the lane's
// table row in shared memory when it fits (else the walk reads it from
// global memory through L1) and zero the values past the lane's count; then
// one thread walks the stream through the 64-bit bit buffer of entropy.cuh,
// refilled to >= 49 bits before each symbol (renormalization bits before
// the hybrid-int bits).  A lane ends in one launch.  Not carried over: B6's
// words -> L2 -> G -> 48-bit funnel window hierarchy, its chunked select-chain
// lookups, the KernelCfg cadences, the VMEM gate and the segmented long-stream
// mode.
//
// Built with nvcc into the library of ops/_build.py (plain C interface,
// ctypes); the wrapper, packer and plain version are in ops/token_kernels.py.
// The entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "entropy.cuh"

namespace {

constexpr int kThreads = 128;  // stage the tables; thread 0 then walks

struct Tables {
  const int *sym, *fb, *mb, *a, *lo, *lsb;
};

__device__ __forceinline__ const int* stage(int*& dst, const int* src, int n) {
  for (int i = threadIdx.x; i < n; i += kThreads) dst[i] = src[i];
  const int* out = dst;
  dst += n;
  return out;
}

template <bool kPrefix>
__global__ void __launch_bounds__(kThreads)
    tokens_kernel(const uint16_t* __restrict__ words, int W,
                  const int* __restrict__ skip, const int* __restrict__ nsym,
                  const int* __restrict__ rows, const int* __restrict__ cids,
                  int cid_stride, Tables g, int C, int S, int F, int amax,
                  int staged, int* __restrict__ out, int n_out,
                  int* __restrict__ st, int L) {
  extern __shared__ int smem[];
  const int l = blockIdx.x;
  const size_t r = (size_t)rows[l];
  Tables t{g.sym + r * C * S, g.fb + r * C * F, g.mb + r * C * amax,
           g.a + r * C * amax, g.lo + r * C * amax, g.lsb + r * C};
  if (staged) {
    int* p = smem;
    t.sym = stage(p, t.sym, C * S);
    if (!kPrefix) t.fb = stage(p, t.fb, C * F);
    t.mb = stage(p, t.mb, C * amax);
    t.a = stage(p, t.a, C * amax);
    t.lo = stage(p, t.lo, C * amax);
    t.lsb = stage(p, t.lsb, C);
  }
  const int n = min(nsym[l], n_out);
  int* o = out + (size_t)l * n_out;
  for (int i = n + threadIdx.x; i < n_out; i += kThreads) o[i] = 0;
  __syncthreads();
  if (threadIdx.x != 0) return;

  const int* cl = cids ? cids + (size_t)l * cid_stride : nullptr;
  Bits b{words + (size_t)l * W, W, 0, 0, 0};
  b.seek(skip[l]);
  uint32_t state = 0;
  if (!kPrefix) {  // init: state = u(16) | u(16) << 16
    state = b.peek();
    b.drop(32);
  }
  for (int i = 0; i < n; ++i) {
    b.refill();
    const int c = cl ? cl[i] : 0;
    int tok;
    if (kPrefix) {
      const int e = t.sym[c * S + (int)(b.peek() & (uint32_t)(S - 1))];
      tok = e & 0xFFFF;
      b.drop(e >> 16);
    } else {
      const int idx = (int)(state & 0xFFF);
      const uint32_t f = (uint32_t)t.fb[c * F + idx];
      tok = t.sym[c * S + idx];
      uint32_t ns = (f >> 12) * (state >> 12) + (f & 0xFFF);
      if (ns < (1u << 16)) {  // renormalization bits come first
        ns = (ns << 16) | (b.peek() & 0xFFFF);
        b.drop(16);
      }
      state = ns;
    }
    const int h = c * amax + tok;
    const int mb = t.mb[h];
    const uint32_t mid = b.peek() & ((1u << mb) - 1);
    b.drop(mb);
    o[i] = (int)(((uint32_t)t.a[h] << mb) | (mid << t.lsb[c]) | (uint32_t)t.lo[h]);
  }
  st[l] = (int)state;
  st[L + l] = b.bitpos();
}

}  // namespace

extern "C" {

// A table row larger than the card's shared-memory opt-in limit (227 KB on
// Hopper) is read from global memory.
int j40tt_tokens(const uint16_t* words, int W, const int* skip,
                 const int* nsym, const int* rows, const int* cids,
                 int cid_stride, const int* sym, const int* fb, const int* mb,
                 const int* a, const int* lo, const int* lsb, int C, int S,
                 int F, int amax, int use_prefix, int* out, int n_out, int* st,
                 int L, cudaStream_t stream) {
  int dev = 0, cap = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&cap, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  const size_t ints = (size_t)C * S + (use_prefix ? 0 : (size_t)C * F) +
                      3 * (size_t)C * amax + C;
  const int staged = ints * sizeof(int) <= (size_t)cap;
  const size_t smem = staged ? ints * sizeof(int) : 0;
  const Tables g{sym, fb, mb, a, lo, lsb};
  if (use_prefix) {
    const int rc = allow_smem(tokens_kernel<true>, smem);
    if (rc) return rc;
    tokens_kernel<true><<<L, kThreads, smem, stream>>>(
        words, W, skip, nsym, rows, cids, cid_stride, g, C, S, F, amax,
        staged, out, n_out, st, L);
  } else {
    const int rc = allow_smem(tokens_kernel<false>, smem);
    if (rc) return rc;
    tokens_kernel<false><<<L, kThreads, smem, stream>>>(
        words, W, skip, nsym, rows, cids, cid_stride, g, C, S, F, amax,
        staged, out, n_out, st, L);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
