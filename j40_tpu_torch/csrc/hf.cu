// Hand-written Hopper (sm_90a) kernels of the on-chip VarDCT HF coefficient
// decode of DCT8 pass-group sections.
//
// They replace the two Pallas TPU kernels of j40_tpu/ops/pallas_hf.py:
//
//   j40tt_hf_walk      <- _make_hf_kernel     (B4: single-cluster spec, the
//                         symbols through a prefix LUT or rANS alias records)
//   j40tt_hf_ctx_walk  <- _make_hf_ctx_kernel (B5: multi-cluster rANS with the
//                         full HF context model)
//
// Built with nvcc into the library of ops/_build.py (plain C interface,
// ctypes); the wrappers, plain versions and packers are in ops/hf_kernels.py.
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().
//
// What each computes: per lane, one pass-group section (an isolated entropy
// stream, j40.h:7749-7776) whose cells are all DCT8 varblocks.  Per cell, per
// channel in Y, X, B order (XYB slot YXB2XYB = {1, 0, 2}): one nonzero-count
// symbol, then coefficient symbols until that many nonzeros have appeared
// (j40.h:6888-7005, log_size = 6); nz > 63 or a run past position 63 sets
// the lane's err.  Each signed coefficient lands at its natural position of
// the dense (L, 3, ncells_max, 64) float32 planes, which the wrapper zeroes.
// The interface is the Pallas kernels' resumable machine snapshot (init in,
// st out, one column per lane); a walk stops after `cap` symbols or when its
// lane is done.
//
// Bound: the bytes are the section streams, read once, and the dense planes,
// written once; at 3.35 TB/s they take microseconds.  The real limit is the
// serial chain of symbols of the longest lane: each symbol's table index and
// bit position depend on the one before (the rANS state, the bit reader, and
// for B5 the context), some tens of dependent instructions and two or three
// shared-memory loads per symbol.  This design accepts that: one section per
// thread block, whose threads first stage the lane's tables in shared memory,
// then one thread walks the section through a 64-bit bit buffer over the
// lane's 16-bit words (global memory, L1-cached as it streams).  A symbol
// reads at most 33 bits (16 renormalization bits or a prefix code of <= 13,
// then <= 17 hybrid-int bits), so the buffer is refilled to at least 49 bits
// before each symbol.  A later PR could split a lane at cell rows (the
// context model only needs the nonzero ring of the row above, which a first
// pass over the nz symbols could provide) or interleave several lanes per
// warp to hide the chain's latency.
//
// None of the Pallas kernels' TPU machinery carries over: the words -> L2 ->
// G -> 48-bit funnel window hierarchy, the column-layout tables and select
// chains, the (steps, 128) value/index output with its XLA scatter and
// inverse-order gather (folded into the walk: a lane writes only its own
// positions, so no atomics), the VMEM gates and the windowed long-stream
// mode, and the bytes-based step budget (the decode path passes the format's
// hard bound, 192 symbols per cell, and every lane ends in one launch).

#include <cuda_runtime.h>
#include <stdint.h>

#include "entropy.cuh"

namespace {

constexpr int kThreads = 128;  // stage the tables; thread 0 then walks
constexpr int kNat = 3 * 64;   // natural position per (XYB slot, order index)
constexpr int kAnsTab = 512;   // 2 records x 256 buckets at most
constexpr int kRing = 3 * 32;  // nonzero counts of the row above, per channel
constexpr int kRingRow = 16;   // first ring row of the B5 snapshot

enum Mode { kPrefix = 0, kAns = 1 };

struct Hybrid {
  int lsb, split, bits, base_mid, msb;
};

// Hybrid-int value of a token, its extra bits read after the symbol's
// (j40.h:2313-2327, arithmetically as pallas_hf.py:197-217).
__device__ __forceinline__ int hybrid(Bits& b, int tok, const Hybrid& h) {
  if (tok < h.split) return tok;
  const int mb = h.base_mid + (int)((uint32_t)(tok - h.split) >> h.bits);
  const uint32_t lo = (uint32_t)tok & ((1u << h.lsb) - 1);
  const uint32_t hi = ((uint32_t)tok >> h.lsb) & ((1u << h.msb) - 1);
  const uint32_t a = ((1u << h.msb) | hi) << h.lsb;
  const uint32_t mid = b.peek() & ((1u << mb) - 1);
  b.drop(mb);
  return (int)((a << mb) | (mid << h.lsb) | lo);
}

// rANS alias decode from a bucket's two packed records (pallas_hf.py:164-195,
// device_entropy.pack_alias_buckets): freq 0 means 4096; when the state
// falls below 2^16 it takes 16 more bits, before the hybrid-int bits.
__device__ __forceinline__ int ans_symbol(uint32_t& state, Bits& b, int lbs,
                                          const int* rec) {
  const int slot = (int)(state & 0xFFF);
  const int i = slot >> lbs;
  const int pos = slot & ((1 << lbs) - 1);
  const uint32_t e0 = (uint32_t)rec[2 * i], e1 = (uint32_t)rec[2 * i + 1];
  const bool direct = pos < (int)(e0 & 0x1FFF);
  const int tok = direct ? i : (int)((e1 >> 24) & 0xFF);
  const uint32_t base = direct ? (uint32_t)pos : (e1 & 0xFFF) + pos;
  uint32_t freq = direct ? (e0 >> 13) & 0xFFF : (e1 >> 12) & 0xFFF;
  if (freq == 0) freq = 4096;
  uint32_t ns = freq * (state >> 12) + base;
  if (ns < (1u << 16)) {
    ns = (ns << 16) | (b.peek() & 0xFFFF);
    b.drop(16);
  }
  state = ns;
  return tok;
}

// The structure walk's state and one step of it (pallas_hf.py:220-262).
struct Walk {
  int k, cyxb, nzrem, ii, err;
};

__device__ __forceinline__ int xyb_slot(int cyxb) {
  return cyxb == 0 ? 1 : (cyxb == 1 ? 0 : 2);
}

// Returns true when the walk moved to the next cell.
__device__ __forceinline__ bool walk_step(Walk& w, int value, const int* nat,
                                          float* out, int ncmax) {
  bool adv;
  if (w.nzrem == 0) {  // the nonzero count
    if (value > 63) w.err = 1;
    if (value > 0) {
      w.nzrem = value;
      w.ii = 1;
    }
    adv = value == 0;
  } else {  // a coefficient at order index ii
    const int c = xyb_slot(w.cyxb);
    const int sval = (value & 1) ? -(value >> 1) - 1 : (value >> 1);
    if (sval != 0)
      out[((size_t)c * ncmax + w.k) * 64 + nat[c * 64 + (w.ii & 63)]] =
          (float)sval;
    const int nzrem = w.nzrem - (value != 0);
    const int ii = w.ii + 1;
    const bool overrun = ii >= 64 && nzrem > 0;
    w.nzrem = overrun ? 0 : nzrem;
    w.ii = ii;
    if (overrun) w.err = 1;
    adv = nzrem == 0 || overrun;
  }
  if (adv && ++w.cyxb == 3) {
    w.cyxb = 0;
    ++w.k;
    return true;
  }
  return false;
}

__device__ __forceinline__ void load_walk(const int* init, int L, int l,
                                          uint32_t& state, int& bitpos,
                                          Walk& w) {
  state = (uint32_t)init[l];
  bitpos = init[L + l];
  w = Walk{init[2 * L + l], init[3 * L + l], init[4 * L + l], init[5 * L + l],
           init[6 * L + l]};
}

__device__ __forceinline__ void store_walk(int* st, int L, int l,
                                           uint32_t state, int bitpos,
                                           const Walk& w) {
  st[l] = (int)state;
  st[L + l] = bitpos;
  st[2 * L + l] = w.k;
  st[3 * L + l] = w.cyxb;
  st[4 * L + l] = w.nzrem;
  st[5 * L + l] = w.ii;
  st[6 * L + l] = w.err;
}

// B4.  lane (L, 8): table base, table length, log_bucket_size, lsb, split,
// msb + lsb, split_exp - msb - lsb, msb.  Shared memory: nat (192) then the
// lane's table (prefix LUT of 2^width entries, or its 2*T alias records).
template <int kMode>
__global__ void __launch_bounds__(kThreads)
    hf_walk_kernel(const uint16_t* __restrict__ words, int W,
                   const int* __restrict__ init, int* __restrict__ st,
                   const int* __restrict__ ncells, const int* __restrict__ lut,
                   int lut_len, int tab_cap, const int* __restrict__ lane,
                   const int* __restrict__ nat, float* __restrict__ out, int L,
                   int ncmax, int cap, int width) {
  extern __shared__ int smem[];
  int* nat_s = smem;
  int* tab = smem + kNat;
  const int l = blockIdx.x;
  const int* cfg = lane + 8 * l;
  const int tab_base = cfg[0];
  const int tab_len = min(cfg[1], tab_cap);
  for (int i = threadIdx.x; i < kNat; i += kThreads) nat_s[i] = nat[kNat * l + i];
  for (int i = threadIdx.x; i < tab_len; i += kThreads)
    tab[i] = tab_base + i < lut_len ? lut[tab_base + i] : 0;
  __syncthreads();
  if (threadIdx.x != 0) return;

  uint32_t state;
  int bitpos;
  Walk w;
  load_walk(init, L, l, state, bitpos, w);
  const int nc = ncells[l];
  const int lbs = cfg[2];
  const Hybrid h{cfg[3], cfg[4], cfg[5], cfg[6], cfg[7]};
  const uint32_t wmask = (1u << width) - 1;
  float* o = out + (size_t)l * 3 * ncmax * 64;
  Bits b{words + (size_t)l * W, W, 0, 0, 0};
  b.seek(bitpos);
  for (int s = 0; s < cap && w.k < nc && w.err == 0; ++s) {
    b.refill();
    int tok;
    if constexpr (kMode == kPrefix) {
      const int e = tab[b.peek() & wmask];
      tok = e & 0xFFFF;
      b.drop(e >> 16);
    } else {
      tok = ans_symbol(state, b, lbs, tab);
    }
    walk_step(w, hybrid(b, tok, h), nat_s, o, ncmax);
  }
  store_walk(st, L, l, state, b.bitpos(), w);
  st[7 * L + l] = (w.k >= nc || w.err != 0) ? 1 : 0;
}

// B5.  Snapshot rows 7-11: prev, x8, y8, gw8, ctxoff; 12 done; 16-111 the
// ring.  Shared memory: nat (192), nf (64), per-cluster hybrid configs (256),
// the ring (96: 32 cells a channel, so gw8 <= 32, which the packer and the
// route enforce), the alias records (n_ab) and the packed cluster map
// (n_cmap words, 4 contexts each).
__global__ void __launch_bounds__(kThreads)
    hf_ctx_kernel(const uint16_t* __restrict__ words, int W,
                  const int* __restrict__ init, int* __restrict__ st,
                  const int* __restrict__ ncells, const int* __restrict__ ab,
                  int n_ab, const int* __restrict__ cmap, int n_cmap,
                  const int* __restrict__ cfgw, const int* __restrict__ nf,
                  const int* __restrict__ bctx3, int bstride,
                  const int* __restrict__ nat, float* __restrict__ out, int L,
                  int ncmax, int cap, int nb, int log_alpha) {
  extern __shared__ int smem[];
  int* nat_s = smem;
  int* nf_s = nat_s + kNat;
  int* cfg_s = nf_s + 64;
  int* ring = cfg_s + 256;
  int* ab_s = ring + kRing;
  int* cmap_s = ab_s + n_ab;
  const int l = blockIdx.x;
  for (int i = threadIdx.x; i < kNat; i += kThreads) nat_s[i] = nat[i];
  for (int i = threadIdx.x; i < 64; i += kThreads) nf_s[i] = nf[i];
  for (int i = threadIdx.x; i < 256; i += kThreads) cfg_s[i] = cfgw[i];
  for (int i = threadIdx.x; i < kRing; i += kThreads)
    ring[i] = init[(kRingRow + i) * L + l];
  for (int i = threadIdx.x; i < n_ab; i += kThreads) ab_s[i] = ab[i];
  for (int i = threadIdx.x; i < n_cmap; i += kThreads) cmap_s[i] = cmap[i];
  __syncthreads();
  if (threadIdx.x != 0) return;

  uint32_t state;
  int bitpos;
  Walk w;
  load_walk(init, L, l, state, bitpos, w);
  int prev = init[7 * L + l], x8 = init[8 * L + l], y8 = init[9 * L + l];
  const int gw8 = init[10 * L + l], ctxoff = init[11 * L + l];
  const int nc = ncells[l];
  const int lbs = 12 - log_alpha;
  const int rec_stride = 2 << log_alpha;  // 2 records per bucket, T buckets
  const int* b3 = bctx3 + (size_t)l * bstride;
  float* o = out + (size_t)l * 3 * ncmax * 64;
  Bits b{words + (size_t)l * W, W, 0, 0, 0};
  b.seek(bitpos);
  for (int s = 0; s < cap && w.k < nc && w.err == 0; ++s) {
    b.refill();
    const int c = xyb_slot(w.cyxb);
    const int bctx = (b3[w.k] >> (10 * w.cyxb)) & 0x3FF;
    const bool is_nz = w.nzrem == 0;
    int ctx;
    if (is_nz) {  // prediction from the left and top counts (pallas_hf.py:842-852)
      const int nzl = ring[c * 32 + max(x8 - 1, 0)], nzt = ring[c * 32 + x8];
      const int nzp = (x8 > 0 && y8 > 0) ? (nzl + nzt + 1) >> 1
                      : x8 > 0           ? nzl
                      : y8 > 0           ? nzt
                                         : 32;
      const int bucket = nzp < 8 ? nzp : 4 + (nzp >> 1);
      ctx = ctxoff + bctx + bucket * nb;
    } else {  // TWICE_COEFF_NNZ_CTX[nzrem] + TWICE_COEFF_FREQ_CTX[ii] + prev
      ctx = ctxoff + 458 * bctx + 37 * nb +
            (nf_s[min(max(w.nzrem, 0), 63)] & 0xFFFF) + (nf_s[w.ii & 63] >> 16) +
            prev;
    }
    ctx = min(ctx, 4 * n_cmap - 1);
    const int cluster = (cmap_s[ctx >> 2] >> ((ctx & 3) * 8)) & 0xFF;
    const int cw = cfg_s[cluster];
    const int lsb = cw & 15, msb = (cw >> 4) & 15, sexp = (cw >> 8) & 31;
    const Hybrid h{lsb, 1 << sexp, msb + lsb, sexp - msb - lsb, msb};
    const int tok = ans_symbol(state, b, lbs, ab_s + cluster * rec_stride);
    const int value = hybrid(b, tok, h);
    if (is_nz) ring[c * 32 + x8] = value;
    const bool next_cell = walk_step(w, value, nat_s, o, ncmax);
    prev = is_nz ? (value <= 4) : (value != 0);
    if (next_cell && ++x8 >= gw8) {
      x8 = 0;
      ++y8;
    }
  }
  store_walk(st, L, l, state, b.bitpos(), w);
  st[7 * L + l] = prev;
  st[8 * L + l] = x8;
  st[9 * L + l] = y8;
  st[10 * L + l] = gw8;
  st[11 * L + l] = ctxoff;
  st[12 * L + l] = (w.k >= nc || w.err != 0) ? 1 : 0;
  for (int r = 13; r < kRingRow; ++r) st[r * L + l] = 0;
  for (int i = 0; i < kRing; ++i) st[(kRingRow + i) * L + l] = ring[i];
}

}  // namespace

extern "C" {

int j40tt_hf_walk(const uint16_t* words, int W, const int* init, int* st,
                  const int* ncells, const int* lut, int lut_len,
                  const int* lane, const int* nat, float* out, int L,
                  int ncmax, int cap, int use_prefix, int width,
                  cudaStream_t stream) {
  const int tab_cap = use_prefix ? (1 << width) : kAnsTab;
  const size_t smem = (size_t)(kNat + tab_cap) * sizeof(int);
  if (use_prefix) {
    const int rc = allow_smem(hf_walk_kernel<kPrefix>, smem);
    if (rc) return rc;
    hf_walk_kernel<kPrefix><<<L, kThreads, smem, stream>>>(
        words, W, init, st, ncells, lut, lut_len, tab_cap, lane, nat, out, L,
        ncmax, cap, width);
  } else {
    const int rc = allow_smem(hf_walk_kernel<kAns>, smem);
    if (rc) return rc;
    hf_walk_kernel<kAns><<<L, kThreads, smem, stream>>>(
        words, W, init, st, ncells, lut, lut_len, tab_cap, lane, nat, out, L,
        ncmax, cap, width);
  }
  return (int)cudaGetLastError();
}

int j40tt_hf_ctx_walk(const uint16_t* words, int W, const int* init, int* st,
                      const int* ncells, const int* ab, int n_ab,
                      const int* cmap, int n_cmap, const int* cfgw,
                      const int* nf, const int* bctx3, int bstride,
                      const int* nat, float* out, int L, int ncmax, int cap,
                      int nb, int log_alpha, cudaStream_t stream) {
  const size_t smem =
      (size_t)(kNat + 64 + 256 + kRing + n_ab + n_cmap) * sizeof(int);
  const int rc = allow_smem(hf_ctx_kernel, smem);
  if (rc) return rc;
  hf_ctx_kernel<<<L, kThreads, smem, stream>>>(
      words, W, init, st, ncells, ab, n_ab, cmap, n_cmap, cfgw, nf, bctx3,
      bstride, nat, out, L, ncmax, cap, nb, log_alpha);
  return (int)cudaGetLastError();
}

}  // extern "C"
