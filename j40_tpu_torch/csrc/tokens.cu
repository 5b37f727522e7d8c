// Hand-written Hopper (sm_90a) kernels of the modular device lanes' token
// decode: per lane, `nsym` hybrid-int values from one pass-group section's
// entropy stream (an isolated stream, j40.h:447, 7749-7776), the final rANS
// state and the final bit position.
//
// They replace the Pallas TPU kernel j40_tpu/ops/pallas_entropy.py
// _make_kernel (B6: the 128-lane rANS/prefix token loop for one shared
// single-cluster spec) and the two lax.scan decoders beside it
// (ops/device_entropy.py decode_tokens, decode_tokens_ctx), whose torch
// ports would cost one launch per operation per symbol step.  Three table
// modes, set by the inputs alone:
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
// exceed MAX_MIDBITS have mb = a = lo = 0 (hybrid_luts), and the packer
// keeps such tokens out of reach (spec_is_device_simple).
//
// Bound: bytes — the section streams read once and the values written once
// (4 bytes per symbol); at 3.35 TB/s some microseconds.  What stands in the
// way is the serial chain of a lane: each symbol's table index and bit
// position depend on the one before.  Two designs, by the lane's code:
//
//   sync    prefix lanes without per-token clusters (one cluster, no LZ77):
//           the self-synchronising parallel decode of prefix_sync.cuh, one
//           thread per 256-bit subsequence, thousands of threads a batch.
//           The setup kernel builds each row's fused table (one 8-byte entry
//           per prefix slot: the value's base, the code length, the extra
//           bits) and codeword-length bytes, and each lane's region.
//   serial  rANS lanes (one 32-bit state runs through the whole section, so
//           it cannot be split) and prefix lanes with per-token clusters
//           (whose cluster depends on the symbol's index): one thread per
//           lane, its chain shortened to one shared-memory load per symbol
//           (the fused entry of (cluster, state slot or prefix slot)), a
//           refill without a loop from registers loaded ahead
//           (entropy.cuh Reader) and the cluster ids loaded a chunk of
//           eight symbols ahead.  A row too large for shared memory (227
//           KB) is read from global memory through L1.
//
// Not carried over from B6: its words -> L2 -> G -> 48-bit funnel window
// hierarchy, its chunked select-chain lookups, the KernelCfg cadences, the
// VMEM gate and the segmented long-stream mode.
//
// Built with nvcc into the library of ops/_build.py (plain C interface,
// ctypes); the wrapper, packer and plain version are in ops/token_kernels.py,
// which allocates the scratch (j40tt_tokens_scratch ints).  nbits, when not
// null, holds each lane's section length in bits (the sync design's region
// ends there; else at the lane's last nonzero word).  The entry point
// launches on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "entropy.cuh"
#include "prefix_sync.cuh"

namespace {

constexpr int kThreads = 128;  // the serial kernel stages with all, walks with one
constexpr int kAhead = 8;  // symbols a chunk of the serial chain's cluster ids

struct Tables {
  const int *sym, *fb, *mb, *a, *lo, *lsb;
  int C, S, F, amax;
};

// The fused entry of slot i of (row r, cluster c).
template <bool kPrefix>
__device__ __forceinline__ uint2 fuse(const Tables& g, int rc, int i) {
  uint32_t aux;
  int tok;
  if (kPrefix) {
    const int e = g.sym[(size_t)rc * g.S + i];
    tok = e & 0xFFFF;
    aux = (uint32_t)e >> 16;
  } else {
    const uint32_t f = (uint32_t)g.fb[(size_t)rc * g.F + i];
    tok = g.sym[(size_t)rc * g.S + i];
    aux = (f >> 12) | ((f & 0xFFF) << 13);
  }
  const size_t h = (size_t)rc * g.amax + tok;
  const int mb = g.mb[h];
  return make_uint2(aux | ((uint32_t)mb << kMbShift),
                    ((uint32_t)g.a[h] << mb) | (uint32_t)g.lo[h]);
}

// Setup of the sync design: blocks [0, L) set up lane l; the rest build the
// R rows' fused tables and length bytes (cluster 0).
__global__ void __launch_bounds__(kSetupThreads)
    tokens_sync_setup(const uint16_t* __restrict__ words, int W,
                      const int* __restrict__ skip, const int* __restrict__ nsym,
                      const int* __restrict__ nbits, const int* __restrict__ rows,
                      Tables g, int R, int n_out, int L, SyncScratch sc) {
  if ((int)blockIdx.x < L) {
    const int l = blockIdx.x, r = rows[l];
    const int e0 = g.sym[(size_t)r * g.C * g.S];
    const int m = g.mb[(size_t)r * g.C * g.amax + (e0 & 0xFFFF)];
    lane_setup(words + (size_t)l * W, W, l, nbits ? nbits[l] : -1, skip[l],
               min(nsym[l], n_out), (e0 >> 16) == 0, m, r, g.lsb[(size_t)r * g.C], sc);
    return;
  }
  const size_t i = (size_t)(blockIdx.x - L) * blockDim.x + threadIdx.x;
  if (i >= (size_t)R * g.S) return;
  const int r = (int)(i / g.S), k = (int)(i % g.S);
  const uint2 e = fuse<true>(g, r * g.C, k);
  sc.fz[i] = e;
  sc.tl[i] = (uint8_t)((e.x & 31) + fused_mb(e));
}

// Setup of the serial design: every (row, cluster, slot) entry.
template <bool kPrefix>
__global__ void __launch_bounds__(kSetupThreads)
    tokens_serial_setup(Tables g, int R, uint2* __restrict__ fused) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)R * g.C * g.S) return;
  fused[i] = fuse<kPrefix>(g, (int)(i / g.S), (int)(i % g.S));
}

template <bool kPrefix>
__global__ void __launch_bounds__(kThreads)
    tokens_serial_kernel(const uint16_t* __restrict__ words, int W,
                         const int* __restrict__ skip, const int* __restrict__ nsym,
                         const int* __restrict__ rows, const int* __restrict__ cids,
                         int cid_stride, const uint2* __restrict__ fused,
                         const int* __restrict__ lsb_g, int C, int S, int staged,
                         int* __restrict__ out, int n_out, int* __restrict__ st,
                         int L) {
  extern __shared__ uint2 sm[];
  const int l = blockIdx.x;
  const size_t r = (size_t)rows[l];
  const uint2* tab = fused + r * C * S;
  const int* lsb = lsb_g + r * C;
  if (staged) {
    for (int i = threadIdx.x; i < C * S; i += kThreads) sm[i] = tab[i];
    int* ls = (int*)(sm + (size_t)C * S);
    for (int i = threadIdx.x; i < C; i += kThreads) ls[i] = lsb[i];
    tab = sm;
    lsb = ls;
  }
  const int n = min(nsym[l], n_out);
  int* o = out + (size_t)l * n_out;
  for (int i = n + threadIdx.x; i < n_out; i += kThreads) o[i] = 0;
  __syncthreads();
  if (threadIdx.x != 0) return;

  Reader rd{words + (size_t)l * W, W, 0, 0, 0, 0, 0};
  rd.seek(skip[l]);
  uint32_t state = 0;
  if (!kPrefix) {  // init: state = u(16) | u(16) << 16
    state = rd.peek();
    rd.drop(32);
  }
  const int* cl = cids ? cids + (size_t)l * cid_stride : nullptr;
  // cluster ids in chunks of kAhead symbols, each chunk loaded one chunk
  // before its use
  int cc[kAhead], cn[kAhead];
#pragma unroll
  for (int u = 0; u < kAhead; ++u) {
    cc[u] = cl && u < n ? cl[u] : 0;
    cn[u] = cl && kAhead + u < n ? cl[kAhead + u] : 0;
  }
  const int lsb0 = lsb[0];
  for (int i0 = 0; i0 < n; i0 += kAhead) {
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int i = i0 + u;
      if (i >= n) break;
      rd.refill();
      rd.refill();
      const int c = cc[u];
      const int lsb_c = cl ? lsb[c] : lsb0;
      if (kPrefix) {
        o[i] = prefix_symbol(rd, tab + (size_t)c * S, (uint32_t)S - 1, lsb_c);
        continue;
      }
      const uint2 e = tab[(size_t)c * S + (state & 0xFFF)];
      uint32_t ns = (e.x & 0x1FFF) * (state >> 12) + ((e.x >> 13) & 0xFFF);
      if (ns < (1u << 16)) {  // renormalization bits come first
        ns = (ns << 16) | (rd.peek() & 0xFFFF);
        rd.drop(16);
      }
      state = ns;
      o[i] = fused_value(rd, e, lsb_c);
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      cc[u] = cn[u];
      const int i = i0 + 2 * kAhead + u;
      cn[u] = cl && i < n ? cl[i] : 0;
    }
  }
  st[l] = (int)state;
  st[L + l] = rd.bitpos();
}

bool use_sync(int use_prefix, const int* cids) { return use_prefix && !cids; }

int blocks(size_t n, int threads) { return (int)((n + threads - 1) / threads); }

}  // namespace

extern "C" {

// int32 words of scratch j40tt_tokens needs (R table rows).
long long j40tt_tokens_scratch(int L, int W, int R, int C, int S, int use_prefix,
                               int has_cids) {
  if (use_prefix && !has_cids) return sync_scratch_ints(L, W, R, S);
  return 2LL * R * C * S;
}

// Offset (int32 words) of the sync design's (L, 4) statistics in the scratch:
// rounds, longest chase, subsequences re-decoded after the first round,
// subsequences.
long long j40tt_sync_stats_at(int L, int W) { return sync_stats_offset(L, W); }

int j40tt_tokens(const uint16_t* words, int W, const int* skip,
                 const int* nsym, const int* rows, const int* cids,
                 int cid_stride, const int* sym, const int* fb, const int* mb,
                 const int* a, const int* lo, const int* lsb, int C, int S,
                 int F, int amax, int use_prefix, int* out, int n_out, int* st,
                 int L, int R, int* scratch, const int* nbits,
                 cudaStream_t stream) {
  const Tables g{sym, fb, mb, a, lo, lsb, C, S, F, amax};
  if (use_sync(use_prefix, cids)) {
    const SyncScratch sc = carve_scratch(scratch, L, W, R, S);
    tokens_sync_setup<<<L + blocks((size_t)R * S, kSetupThreads), kSetupThreads, 0,
                        stream>>>(words, W, skip, nsym, nbits, rows, g, R, n_out, L,
                                  sc);
    return launch_sync<true>(words, W, sc, out, n_out, st, nullptr, L, stream);
  }
  int dev = 0, cap = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&cap, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  uint2* fused = (uint2*)scratch;
  const size_t bytes = (size_t)C * S * sizeof(uint2) + (size_t)C * sizeof(int);
  const int staged = bytes <= (size_t)cap;
  const size_t smem = staged ? bytes : 0;
  const int grid = blocks((size_t)R * C * S, kSetupThreads);
  if (use_prefix) {
    tokens_serial_setup<true><<<grid, kSetupThreads, 0, stream>>>(g, R, fused);
    const int rc = allow_smem(tokens_serial_kernel<true>, smem);
    if (rc) return rc;
    tokens_serial_kernel<true><<<L, kThreads, smem, stream>>>(
        words, W, skip, nsym, rows, cids, cid_stride, fused, lsb, C, S, staged,
        out, n_out, st, L);
  } else {
    tokens_serial_setup<false><<<grid, kSetupThreads, 0, stream>>>(g, R, fused);
    const int rc = allow_smem(tokens_serial_kernel<false>, smem);
    if (rc) return rc;
    tokens_serial_kernel<false><<<L, kThreads, smem, stream>>>(
        words, W, skip, nsym, rows, cids, cid_stride, fused, lsb, C, S, staged,
        out, n_out, st, L);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
