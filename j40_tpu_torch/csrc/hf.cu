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
// ctypes); the wrappers, plain versions and packers are in ops/hf_kernels.py,
// which allocates B4's scratch (j40tt_hf_walk_scratch ints) and passes each
// lane's section length in bits (nbits; null: the prefix design's region
// ends at the lane's last nonzero word).  Every entry point launches on the
// caller's stream, allocates nothing and returns cudaGetLastError().
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
// written once; at 3.35 TB/s they take microseconds.  What stands in the way
// is the serial chain of symbols of a lane: each symbol's table index and
// bit position depend on the one before (the rANS state, the bit reader,
// and for B5 the context).  The designs:
//
//   B4, prefix   a prefix lane's symbols are context-free and its codewords
//                form a prefix code over bit strings, so the section splits:
//                the self-synchronising decode of prefix_sync.cuh (one
//                thread per 256-bit subsequence) writes every hybrid-int
//                value of the lane to scratch, then a structure pass walks
//                them, one warp per lane: per block (one nonzero count, then
//                coefficients until that many nonzeros or order index 63)
//                one ballot over up to 64 values from a ring of values in
//                shared memory finds the block's end, and the warp scatters
//                the nonzeros at their natural positions.  Symbols decoded past
//                the lane's end are never read; a section read past its end
//                (past the skimmed bits) ends on a serial tail.
//   B4, rANS     one 32-bit state runs through the section, so it cannot be
//                split: one thread per lane decodes, its chain shortened to
//                one shared-memory load per symbol (a fused entry per state
//                slot: freq, base, the token's extra bits and value base,
//                built from the alias records and the hybrid-int config) and
//                a refill without a loop from registers loaded ahead; a
//                second warp walks the values it leaves in a shared-memory
//                ring, as the prefix design's structure pass does (with the
//                walk inline in the decoding thread the chain ran 1.39x
//                slower on an H100: tools/torch_kernel_ab.py).
//   B5           the lookahead design (hf_ctx_kernel): one 32-bit state, so
//                one decoding thread per lane, as B4 rANS, and a walking
//                warp over a ring of values.  Its chain is one 16-byte
//                shared-memory load per symbol, a record per (cluster,
//                bucket) with both tokens' hybrid-int values fused in, and
//                the loop-free refill; the context model is off the chain:
//                the next symbol's context is formed for both outcomes of
//                a coefficient while it decodes, and selected by its value.
//
// None of the Pallas kernels' TPU machinery carries over: the words -> L2 ->
// G -> 48-bit funnel window hierarchy, the column-layout tables and select
// chains, the (steps, 128) value/index output with its XLA scatter and
// inverse-order gather (folded into the walk: a lane writes only its own
// positions, so no atomics), the VMEM gates and the windowed long-stream
// mode, and the bytes-based step budget (the decode path passes the format's
// hard bound, 192 symbols per cell, and every lane ends in one call).

#include <cuda_runtime.h>
#include <stdint.h>

#include "entropy.cuh"
#include "prefix_sync.cuh"

namespace {

constexpr int kNat = 3 * 64;   // natural position per (XYB slot, order index)
constexpr int kAnsTab = 512;   // 2 records x 256 buckets at most
constexpr int kRing = 3 * 32;  // nonzero counts of the row above, per channel
constexpr int kRingRow = 16;   // first ring row of the B5 snapshot

struct Hybrid {
  int lsb, split, bits, base_mid, msb;
};

// The structure walk's state and one step of it (pallas_hf.py:220-262).
struct Walk {
  int k, cyxb, nzrem, ii, err;
};

__device__ __forceinline__ int xyb_slot(int cyxb) {
  return cyxb == 0 ? 1 : (cyxb == 1 ? 0 : 2);
}

// The signed coefficient of a token value (j40.h:610-615).
__device__ __forceinline__ int signed_value(int v) {
  return (v & 1) ? -(v >> 1) - 1 : (v >> 1);
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
    const int sval = signed_value(value);
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

// ---------------------------------------------------------------- B4
// lane (L, 8): table base, table length, log_bucket_size, lsb, split,
// msb + lsb, split_exp - msb - lsb, msb.

constexpr int kWalkWarps = 4;  // structure pass: one warp per lane

__device__ __forceinline__ Hybrid lane_hybrid(const int* cfg) {
  return Hybrid{cfg[3], cfg[4], cfg[5], cfg[6], cfg[7]};
}

// The fused entry of a token under hybrid config h (the arithmetic of
// hybrid()): aux in x below the extra-bit count.
__device__ __forceinline__ uint2 fuse_hybrid(uint32_t aux, int tok, const Hybrid& h) {
  if (tok < h.split) return make_uint2(aux, (uint32_t)tok);
  const int mb = h.base_mid + (int)((uint32_t)(tok - h.split) >> h.bits);
  const uint32_t lo = (uint32_t)tok & ((1u << h.lsb) - 1);
  const uint32_t hi = ((uint32_t)tok >> h.lsb) & ((1u << h.msb) - 1);
  const uint32_t a = ((1u << h.msb) | hi) << h.lsb;
  return make_uint2(aux | ((uint32_t)mb << kMbShift), (a << mb) | lo);
}

// Entry i of the lane's table (0 past its length, at most cap entries).
__device__ __forceinline__ int lane_lut(const int* lut, int lut_len, const int* cfg,
                                        int cap, int i) {
  return i < min(cfg[1], cap) && cfg[0] + i < lut_len ? lut[cfg[0] + i] : 0;
}

__device__ __forceinline__ void next_channel(Walk& w) {
  if (++w.cyxb == 3) {
    w.cyxb = 0;
    ++w.k;
  }
}

// Setup of the prefix design: blocks [0, L) set up lane l (its region
// starts at the snapshot's bit position; a lane that is done decodes
// nothing); the rest build each lane's fused table and length bytes from
// its LUT of S = 2^width entries.
__global__ void __launch_bounds__(kSetupThreads)
    hf_sync_setup(const uint16_t* __restrict__ words, int W,
                  const int* __restrict__ init, const int* __restrict__ ncells,
                  const int* __restrict__ lut, int lut_len,
                  const int* __restrict__ lane, const int* __restrict__ nbits, int L,
                  int cap, SyncScratch sc) {
  const int S = sc.S;
  if ((int)blockIdx.x < L) {
    const int l = blockIdx.x;
    const int* cfg = lane + 8 * l;
    const int k = init[2 * L + l], nc = ncells[l];
    const int n = k < nc && init[6 * L + l] == 0
                      ? (int)min((long long)cap, 192LL * (nc - k)) : 0;
    const int e0 = lane_lut(lut, lut_len, cfg, S, 0);
    const uint2 f0 = fuse_hybrid(0, e0 & 0xFFFF, lane_hybrid(cfg));
    lane_setup(words + (size_t)l * W, W, l, nbits ? nbits[l] : -1, init[L + l], n,
               (e0 >> 16) == 0, fused_mb(f0), l, cfg[3], sc);
    return;
  }
  const size_t i = (size_t)(blockIdx.x - L) * blockDim.x + threadIdx.x;
  if (i >= (size_t)L * S) return;
  const int* cfg = lane + 8 * (i / S);
  const int e = lane_lut(lut, lut_len, cfg, S, (int)(i % S));
  const uint2 f = fuse_hybrid((uint32_t)e >> 16, e & 0xFFFF, lane_hybrid(cfg));
  sc.fz[i] = f;
  sc.tl[i] = (uint8_t)(((uint32_t)e >> 16) + fused_mb(f));
}

// Index of the n-th (1-based) set bit of m, which has at least n.
__device__ __forceinline__ int nth_bit(uint64_t m, int n) {
  int pos = 0;
  for (int w = 32; w >= 1; w >>= 1) {
    const int c = __popcll(m & ((1ull << w) - 1));
    if (c < n) {
      n -= c;
      m >>= w;
      pos += w;
    }
  }
  return pos;
}

// One block of the walk by one warp (every lane holds the same walk state):
// the nonzero count (walk_step's first branch), or the coefficients at
// order indices ii..63, which end at the block's nzrem-th nonzero or
// overrun at 63; found by one ballot over up to 64 values, whose nonzeros
// the lanes scatter.  get(d) is the value d places after the block's first
// (every lane calls it with the same control flow); at most `limit` values
// may be consumed.  Returns the symbols consumed.
template <typename Get>
__device__ __forceinline__ int walk_block(Walk& w, Get get, int limit,
                                          const int* nt, float* o, int ncmax) {
  const int t = threadIdx.x & 31;
  if (w.nzrem == 0) {
    const int value = get(0);
    if (value > 63) w.err = 1;
    if (value > 0) {
      w.nzrem = value;
      w.ii = 1;
    } else {
      next_channel(w);
    }
    return 1;
  }
  const int ii0 = w.ii;
  const int avail = min(64 - ii0, limit);
  const int x0 = get(t), x1 = get(32 + t);
  const uint32_t b0 = __ballot_sync(0xFFFFFFFFu, t < avail && x0 != 0);
  const uint32_t b1 = __ballot_sync(0xFFFFFFFFu, t + 32 < avail && x1 != 0);
  const uint64_t m = b0 | ((uint64_t)b1 << 32);
  const int found = __popcll(m);
  const bool finished = found >= w.nzrem;
  const int run = finished ? nth_bit(m, w.nzrem) + 1 : avail;
  const int c = xyb_slot(w.cyxb);
  float* oc = o + ((size_t)c * ncmax + w.k) * 64;
  const int* ntc = nt + c * 64;
  if (t < run && x0 != 0) oc[ntc[(ii0 + t) & 63]] = (float)signed_value(x0);
  if (t + 32 < run && x1 != 0) oc[ntc[(ii0 + t + 32) & 63]] = (float)signed_value(x1);
  w.ii = ii0 + run;
  if (finished) {
    w.nzrem = 0;
    next_channel(w);
  } else {
    w.nzrem -= found;
    if (w.ii >= 64) {  // overrun
      w.nzrem = 0;
      w.err = 1;
      next_channel(w);
    }
  }
  return run;
}

// The structure pass of the prefix design: one warp per lane walks the
// lane's values (vals, tail[2l] of them) from the snapshot, at most `cap`
// symbols, and writes the new snapshot.  Every lane of the warp holds the
// same walk state.
constexpr int kWin = 256;  // the structure pass's ring of values, per warp

__global__ void __launch_bounds__(32 * kWalkWarps)
    hf_structure_kernel(const uint16_t* __restrict__ words, int W,
                        const int* __restrict__ init, int* __restrict__ st,
                        const int* __restrict__ ncells, const int* __restrict__ nat,
                        float* __restrict__ out, int L, int ncmax, int cap,
                        const int* __restrict__ vals, int V,
                        const int* __restrict__ tail, SyncScratch sc) {
  extern __shared__ int walk_s[];
  const int warp = threadIdx.x >> 5, t = threadIdx.x & 31;
  const int l = blockIdx.x * kWalkWarps + warp;
  if (l >= L) return;
  int* ring = walk_s + warp * (kWin + kNat);
  int* nt = ring + kWin;
  for (int i = t; i < kNat; i += 32) nt[i] = nat[kNat * l + i];
  uint32_t state;
  int bitpos0;
  Walk w;
  load_walk(init, L, l, state, bitpos0, w);
  const int nc = ncells[l];
  const int T = tail[2 * l];
  const int* v = vals + (size_t)l * V;
  float* o = out + (size_t)l * 3 * ncmax * 64;
  // the ring holds values [wb, wb + kWin); the next half, [wb + kWin, wb +
  // 3 kWin / 2), waits in registers, loaded one shift ahead of its store
  int p = 0, wb = 0;  // symbols walked; the ring's first value
#define J40TT_VAL(i) ((i) < T ? v[(i)] : 0)
  for (int i = t; i < kWin; i += 32) ring[i] = J40TT_VAL(i);
  int q0 = J40TT_VAL(kWin + t), q1 = J40TT_VAL(kWin + 32 + t),
      q2 = J40TT_VAL(kWin + 64 + t), q3 = J40TT_VAL(kWin + 96 + t);
  __syncwarp();
  while (w.k < nc && w.err == 0 && p < cap && p < T) {
    if (p - wb > kWin - 64) {  // a block needs at most 64 values from p
      const int at = wb + kWin;  // over the ring's oldest half
      ring[(at + t) & (kWin - 1)] = q0;
      ring[(at + 32 + t) & (kWin - 1)] = q1;
      ring[(at + 64 + t) & (kWin - 1)] = q2;
      ring[(at + 96 + t) & (kWin - 1)] = q3;
      wb += kWin / 2;
      q0 = J40TT_VAL(wb + kWin + t);
      q1 = J40TT_VAL(wb + kWin + 32 + t);
      q2 = J40TT_VAL(wb + kWin + 64 + t);
      q3 = J40TT_VAL(wb + kWin + 96 + t);
      __syncwarp();
    }
    p += walk_block(w, [&](int d) { return ring[(p + d) & (kWin - 1)]; },
                    min(T - p, cap - p), nt, o, ncmax);
  }
#undef J40TT_VAL
  if (t != 0) return;
  int bitpos;
  if (w.k < nc && w.err == 0 && p < cap) {
    // past the skimmed bits: the serial tail, from where the values end
    const int* li = sc.li + (size_t)l * kLaneInfo;
    const uint2* fz = sc.fz + (size_t)l * sc.S;
    const int lsb = li[kLsb];
    Bits b{words + (size_t)l * W, W, 0, 0, 0};
    b.seek(tail[2 * l + 1]);
    for (; p < cap && w.k < nc && w.err == 0; ++p) {
      b.refill();
      walk_step(w, prefix_symbol(b, fz, (uint32_t)sc.S - 1, lsb), nt, o, ncmax);
    }
    bitpos = b.bitpos();
  } else {
    bitpos = p == 0 ? bitpos0 : sync_pos_after(words + (size_t)l * W, W, sc, l, p - 1);
  }
  store_walk(st, L, l, state, bitpos, w);
  st[7 * L + l] = (w.k >= nc || w.err != 0) ? 1 : 0;
}

// The rANS design: one block of two warps per lane.  All threads build the
// lane's fused table (4096 state slots) and stage nat in shared memory;
// then thread 0 decodes the chain into a ring of values (with the state and
// bit position after each), and warp 1 walks them as the prefix design's
// structure pass does, so that the chain carries no structure work.  The
// decoder stops where the walk ends (warp 1 raises `stop`) or at the most
// symbols the walk could take; the snapshot's state and bit position are
// the ring's after the last symbol walked.  The two warps meet through
// three volatile shared counters: values decoded, the walk's position (a
// ring entry is rewritten only once the walk has passed it, the last one
// walked included) and stop.
constexpr int kAnsThreads = 64;
constexpr int kAnsRing = 1024;  // ring entries (a power of 2)
constexpr int kAnsChunk = 32;   // values decoded between two counter updates

__global__ void __launch_bounds__(kAnsThreads)
    hf_ans_kernel(const uint16_t* __restrict__ words, int W,
                  const int* __restrict__ init, int* __restrict__ st,
                  const int* __restrict__ ncells, const int* __restrict__ lut,
                  int lut_len, const int* __restrict__ lane,
                  const int* __restrict__ nat, float* __restrict__ out, int L,
                  int ncmax, int cap) {
  extern __shared__ uint2 fused_s[];
  int* nat_s = (int*)(fused_s + 4096);
  int* ring_v = nat_s + kNat;
  uint32_t* ring_s = (uint32_t*)(ring_v + kAnsRing);
  int* ring_b = (int*)(ring_s + kAnsRing);
  volatile int* ctl = ring_b + kAnsRing;  // values decoded, walk position, stop
  const int l = blockIdx.x;
  const int* cfg = lane + 8 * l;
  const int lbs = cfg[2];
  const Hybrid h = lane_hybrid(cfg);
  for (int i = threadIdx.x; i < 4096; i += kAnsThreads) {
    // the alias decode of ans_symbol for state slot i
    const int bucket = i >> lbs, pos = i & ((1 << lbs) - 1);
    const uint32_t e0 = (uint32_t)lane_lut(lut, lut_len, cfg, kAnsTab, 2 * bucket);
    const uint32_t e1 = (uint32_t)lane_lut(lut, lut_len, cfg, kAnsTab, 2 * bucket + 1);
    const bool direct = pos < (int)(e0 & 0x1FFF);
    const int tok = direct ? bucket : (int)((e1 >> 24) & 0xFF);
    const uint32_t base = direct ? (uint32_t)pos : (e1 & 0xFFF) + pos;
    uint32_t freq = direct ? (e0 >> 13) & 0xFFF : (e1 >> 12) & 0xFFF;
    if (freq == 0) freq = 4096;
    fused_s[i] = fuse_hybrid(freq | (base << 13), tok, h);
  }
  for (int i = threadIdx.x; i < kNat; i += kAnsThreads) nat_s[i] = nat[kNat * l + i];
  if (threadIdx.x < 3) ctl[threadIdx.x] = 0;
  __syncthreads();

  uint32_t state;
  int bitpos;
  Walk w;
  load_walk(init, L, l, state, bitpos, w);
  const int nc = ncells[l];
  // the most symbols the walk can take: 192 a cell
  const int n = w.k < nc && w.err == 0 ? (int)min((long long)cap, 192LL * (nc - w.k)) : 0;
  constexpr int mask = kAnsRing - 1;
  if (threadIdx.x < 32) {
    if (threadIdx.x != 0) return;
    Reader rd{words + (size_t)l * W, W, 0, 0, 0, 0, 0};
    rd.seek(bitpos);
    for (int i0 = 0; i0 < n; i0 += kAnsChunk) {
      while (!ctl[2] && i0 + kAnsChunk > ctl[1] + kAnsRing - 1) {
      }
      if (ctl[2]) break;
      const int end = min(i0 + kAnsChunk, n);
      for (int i = i0; i < end; ++i) {
        rd.refill();
        rd.refill();
        const uint2 e = fused_s[state & 0xFFF];
        uint32_t ns = (e.x & 0x1FFF) * (state >> 12) + ((e.x >> 13) & 0xFFF);
        if (ns < (1u << 16)) {  // renormalization bits come first
          ns = (ns << 16) | (rd.peek() & 0xFFFF);
          rd.drop(16);
        }
        state = ns;
        ring_v[i & mask] = fused_value(rd, e, h.lsb);
        ring_s[i & mask] = state;
        ring_b[i & mask] = rd.bitpos();
      }
      __threadfence_block();
      ctl[0] = end;
    }
    return;
  }
  const volatile int* rv = ring_v;
  float* o = out + (size_t)l * 3 * ncmax * 64;
  int p = 0;
  while (w.k < nc && w.err == 0 && p < cap) {
    const int need = min(p + 64, n);
    while (ctl[0] < need) {
    }
    __threadfence_block();
    __syncwarp();
    p += walk_block(w, [&](int d) { return rv[(p + d) & mask]; }, min(n - p, cap - p),
                    nat_s, o, ncmax);
    if (threadIdx.x == 32) ctl[1] = p;
  }
  if (threadIdx.x != 32) return;
  ctl[2] = 1;
  if (p > 0) {
    state = ((const volatile uint32_t*)ring_s)[(p - 1) & mask];
    bitpos = ((const volatile int*)ring_b)[(p - 1) & mask];
  }
  store_walk(st, L, l, state, bitpos, w);
  st[7 * L + l] = (w.k >= nc || w.err != 0) ? 1 : 0;
}

// B5, the lookahead design: one block of four warps per lane.  All threads
// stage the tables; then thread 0 decodes and warp 1 walks, as in
// hf_ans_kernel, and the other two warps leave.
//
// The decoding thread keeps the structure state that the contexts need
// (cell k, channel cyxb, nonzeros left, order index ii, prev, x8, y8 and the
// ring of nonzero counts) and writes each value to a ring of values in
// shared memory; the walking warp scatters the coefficients from there
// (walk_block) and writes nothing else.  The decoder stops at the cap or
// where the lane ends, so it writes the snapshot itself.  Per symbol the
// chain is: the state's bucket -> one 16-byte shared load of the fused
// record (ctx_record) -> ALU -> the new state and value.  The context of
// the next symbol is off that chain: while a coefficient decodes, the
// thread forms the next symbol's context for both outcomes (zero: prev 0,
// nzrem unchanged; nonzero: prev 1, nzrem - 1, or the next block's count
// symbol when that was the last nonzero) and looks up each one's record
// base, then selects by the value.  The count symbol of the block after
// the current one has its context formed while the current count symbol
// decodes: it reads the other channels' counts only.  After a nonzero
// count the first coefficient's context is formed on the chain, once a
// block.  A block's coefficients run in a loop of one basic block: the
// two candidates' context indices are formed first, so that both table
// lookups are unconditional, and the counters are published and checked
// once a block.  (A GPU thread issues in order, so a branch in the loop
// kept the candidates' loads from overlapping the decode: 227 ns a symbol
// on an H100 with a branch per symbol, 150 with the candidates' branch
// alone, 103 without; a second symbol of lookahead, four candidates,
// took 174: tools/torch_kernel_ab.py.)
//
// Shared memory: the fused records (16 bytes per cluster and bucket; the
// spec rule keeps clusters x buckets <= 4096, so 64 KB at most), the
// context table (2 bytes a context: the cluster's first record | its lsb
// << 12), nat (192), nf (64), the count ring (96: 32 cells a channel, so
// gw8 <= 32, which the packer and the route enforce), the value ring and
// three counters.
constexpr int kCtxThreads = 128;
constexpr int kCtxRing = 1024;  // value ring entries (a power of 2)
constexpr int kCtxChunk = 32;   // values decoded between two counter updates
constexpr int kMaxMid = 17;     // the most extra bits of an admitted token
constexpr int kMbBit = 26;      // fused value: base | extra-bit count << 26

// The fused value of token tok under the cluster config word cw (lsb | msb
// << 4 | split_exp << 8): its value base (a << mb) | lo with the extra-bit
// count mb at kMbBit (j40.h:2313-2327).  0 for a token whose count falls
// outside [0, kMaxMid]: no admitted spec reaches one (its decoded tokens
// have nonzero frequency, which spec_is_device_ctx bounds).
__device__ __forceinline__ uint32_t fuse_token(uint32_t tok, uint32_t cw) {
  const uint32_t lsb = cw & 15, msb = (cw >> 4) & 15, sexp = (cw >> 8) & 31;
  if (tok < (1u << sexp)) return tok;
  const int mb = (int)sexp - (int)(msb + lsb) + (int)((tok - (1u << sexp)) >> (msb + lsb));
  if (mb < 0 || mb > kMaxMid) return 0;
  const uint32_t lo = tok & ((1u << lsb) - 1);
  const uint32_t hi = (tok >> lsb) & ((1u << msb) - 1);
  const uint32_t a = ((1u << msb) | hi) << lsb;
  return (a << mb) | lo | ((uint32_t)mb << kMbBit);
}

// The fused record of one (cluster, bucket) from its two alias records
// (device_entropy.pack_alias_buckets) and the cluster's config word:
//   x = min(cutoff, bucket size) << 24 | (freq_direct - 1) << 12
//   y = offset | (freq_alias - 1) << 12
//   z, w = the fused values of the direct token (the bucket) and the alias
// with the frequencies' 0 => 4096 convention folded into the - 1.  The
// direct case has offset 0, so x and y share one layout.
__device__ __forceinline__ uint4 ctx_record(uint32_t e0, uint32_t e1, int bucket,
                                            int lbs, uint32_t cw) {
  const uint32_t cut = min(e0 & 0x1FFF, 1u << lbs);
  return make_uint4(cut << 24 | (((e0 >> 13) - 1) & 0xFFF) << 12,
                    (e1 & 0xFFF) | (((e1 >> 12) - 1) & 0xFFF) << 12,
                    fuse_token((uint32_t)bucket, cw), fuse_token(e1 >> 24, cw));
}

__global__ void __launch_bounds__(kCtxThreads)
    hf_ctx_kernel(const uint16_t* __restrict__ words, int W,
                  const int* __restrict__ init, int* __restrict__ st,
                  const int* __restrict__ ncells, const int* __restrict__ ab,
                  int n_ab, const int* __restrict__ cmap, int n_cmap,
                  const int* __restrict__ cfgw, const int* __restrict__ nf,
                  const int* __restrict__ bctx3, int bstride,
                  const int* __restrict__ nat, float* __restrict__ out, int L,
                  int ncmax, int cap, int nb, int log_alpha) {
  extern __shared__ uint4 rec_s[];
  const int nrec = n_ab / 2, nctx = 4 * n_cmap;
  uint16_t* csel_s = (uint16_t*)(rec_s + nrec);
  int* nat_s = (int*)(csel_s + nctx);  // nctx is a multiple of 4
  int* nf_s = nat_s + kNat;
  int* cring = nf_s + 64;
  int* vring = cring + kRing;
  volatile int* ctl = vring + kCtxRing;  // values decoded, walk position, end
  const int l = blockIdx.x;
  const int lbs = 12 - log_alpha, T = 1 << log_alpha;
  for (int i = threadIdx.x; i < nrec; i += kCtxThreads)
    rec_s[i] = ctx_record((uint32_t)ab[2 * i], (uint32_t)ab[2 * i + 1], i & (T - 1), lbs,
                          (uint32_t)cfgw[i >> log_alpha]);
  const int last_cluster = max(nrec / T - 1, 0);
  for (int i = threadIdx.x; i < nctx; i += kCtxThreads) {
    const int cl = min((int)(((uint32_t)cmap[i >> 2] >> ((i & 3) * 8)) & 0xFF), last_cluster);
    csel_s[i] = (uint16_t)((cl << log_alpha) | (cfgw[cl] & 15) << 12);
  }
  for (int i = threadIdx.x; i < kNat; i += kCtxThreads) nat_s[i] = nat[i];
  for (int i = threadIdx.x; i < 64; i += kCtxThreads) nf_s[i] = nf[i];
  for (int i = threadIdx.x; i < kRing; i += kCtxThreads)
    cring[i] = init[(kRingRow + i) * L + l];
  if (threadIdx.x < 3) ctl[threadIdx.x] = 0;
  __syncthreads();
  if (threadIdx.x >= 64) return;

  constexpr int mask = kCtxRing - 1;
  Walk w;
  uint32_t state;
  int bitpos;
  load_walk(init, L, l, state, bitpos, w);
  const int nc = ncells[l];
  if (threadIdx.x >= 32) {  // the walking warp
    const int t = threadIdx.x & 31;
    const volatile int* rv = vring;
    float* o = out + (size_t)l * 3 * ncmax * 64;
    int p = 0;
    for (;;) {
      int have = 0;
      if (t == 0) {
        for (;;) {
          const int fin = ctl[2];
          __threadfence_block();
          have = ctl[0];
          if (fin || have >= p + 64) break;
          __nanosleep(32);
        }
      }
      have = __shfl_sync(0xFFFFFFFFu, have, 0);
      __threadfence_block();
      if (p >= have) return;
      p += walk_block(w, [&](int d) { return rv[(p + d) & mask]; }, have - p, nat_s, o,
                      ncmax);
      if (t == 0) ctl[1] = p;
    }
  }
  if (threadIdx.x != 0) return;

  int prev = init[7 * L + l], x8 = init[8 * L + l], y8 = init[9 * L + l];
  const int gw8 = init[10 * L + l], ctxoff = init[11 * L + l];
  const int pmask = (1 << lbs) - 1;
  const int* b3 = bctx3 + (size_t)l * bstride;
  // the block-context words of cells k, k + 1 and k + 2, loaded ahead
  auto b3_at = [&](int k) { return k < bstride ? __ldg(b3 + k) : 0; };
  int bc0 = b3_at(w.k), bc1 = b3_at(w.k + 1), bc2 = b3_at(w.k + 2);
  auto sel_of = [&](int ctx) { return (int)csel_s[min(ctx, nctx - 1)]; };
  // a count symbol's context: the prediction from the left and top counts
  // of its channel (pallas_hf.py:842-852)
  auto count_ctx = [&](int cy, int xx, int yy, int word) {
    const int c = xyb_slot(cy);
    const int nzl = cring[c * 32 + max(xx - 1, 0)], nzt = cring[c * 32 + xx];
    const int nzp = (xx > 0 && yy > 0) ? (nzl + nzt + 1) >> 1
                    : xx > 0           ? nzl
                    : yy > 0           ? nzt
                                       : 32;
    const int bucket = nzp < 8 ? nzp : 4 + (nzp >> 1);
    return min(ctxoff + ((word >> (10 * cy)) & 0x3FF) + bucket * nb, nctx - 1);
  };
  // the count symbol of the block after the current one
  auto next_count_ctx = [&]() {
    if (w.cyxb < 2) return count_ctx(w.cyxb + 1, x8, y8, bc0);
    const bool wrap = x8 + 1 >= gw8;
    return count_ctx(0, wrap ? 0 : x8 + 1, wrap ? y8 + 1 : y8, bc1);
  };
  // a coefficient's context: TWICE_COEFF_NNZ_CTX[nzrem] +
  // TWICE_COEFF_FREQ_CTX[ii] + prev over the block's base
  auto coef_base = [&]() {
    return ctxoff + 458 * ((bc0 >> (10 * w.cyxb)) & 0x3FF) + 37 * nb;
  };
  auto coef_sel = [&](int base, int nzrem, int ii, int pv) {
    return sel_of(base + (nf_s[min(max(nzrem, 0), 63)] & 0xFFFF) + (nf_s[ii & 63] >> 16) +
                  pv);
  };
  auto next_block = [&]() {
    if (++w.cyxb == 3) {
      w.cyxb = 0;
      ++w.k;
      if (++x8 >= gw8) {
        x8 = 0;
        ++y8;
      }
      bc0 = bc1;
      bc1 = bc2;
      bc2 = b3_at(w.k + 2);
    }
  };

  Reader rd{words + (size_t)l * W, W, 0, 0, 0, 0, 0};
  rd.seek(bitpos);
  // one symbol under the record base and lsb `sel`: returns its value and
  // whether its token is nonzero (every nonzero token has a nonzero value)
  auto decode = [&](int sel, bool& nonzero) {
    rd.refill();
    rd.refill();
    const uint32_t pos = state & pmask;
    const uint4 r = rec_s[(sel & 0xFFF) + (int)((state & 0xFFF) >> lbs)];
    const bool direct = ((pos << 24) | 0xFFFFFFu) < r.x;
    const uint32_t e = direct ? r.x : r.y;
    const uint32_t fz = direct ? r.z : r.w;
    const uint32_t s12 = state >> 12;
    uint32_t ns = ((e >> 12) & 0xFFF) * s12 + s12 + pos + (e & 0xFFF);
    if (ns < (1u << 16)) {  // renormalization bits come first
      ns = (ns << 16) | (rd.peek() & 0xFFFF);
      rd.drop(16);
    }
    state = ns;
    const int mb = (int)(fz >> kMbBit);
    const uint32_t mid = rd.peek() & ((1u << mb) - 1);
    rd.drop(mb);
    nonzero = fz != 0;
    return (int)((fz & ((1u << kMbBit) - 1)) | (mid << (sel >> 12)));
  };

  int s = 0, pub = 0, walked = 0, cur = 0, nxt = 0, cbase = 0;
  bool in_block = false;  // resumed inside a block
  if (w.k < nc && w.err == 0) {
    if (w.nzrem == 0) {
      cur = csel_s[count_ctx(w.cyxb, x8, y8, bc0)];
    } else {
      cbase = coef_base();
      cur = coef_sel(cbase, w.nzrem, w.ii, prev);
      nxt = next_count_ctx();
      in_block = true;
    }
  }
  while (s < cap && w.k < nc && w.err == 0) {
    // once a block (it takes at most 64 values): publish, and keep off
    // the values the walk has not passed
    if (s - pub >= kCtxChunk || s + 64 > walked + kCtxRing - 1) {
      __threadfence_block();
      ctl[0] = pub = s;
      while (s + 64 > (walked = ctl[1]) + kCtxRing - 1) {
      }
    }
    if (!in_block) {  // the block's count symbol
      nxt = next_count_ctx();
      bool nonzero;
      const int value = decode(cur, nonzero);
      vring[s & mask] = value;
      ++s;
      cring[xyb_slot(w.cyxb) * 32 + x8] = value;
      prev = value <= 4;
      if (value == 0) {
        next_block();
        cur = csel_s[nxt];
        continue;
      }
      w.nzrem = value;
      w.ii = 1;
      if (value > 63) {
        w.err = 1;
        break;
      }
      cbase = coef_base();
      cur = coef_sel(cbase, value, 1, prev);
      if (s >= cap) break;
    }
    in_block = false;
    // the coefficients at order indices ii.., each with the next symbol's
    // two candidates formed while it decodes
    int nzrem = w.nzrem, ii = w.ii;
    bool more;
    do {
      const int ii1 = ii + 1;
      // context indices first, so that both lookups are unconditional
      const int fbase = cbase + (nf_s[ii1 & 63] >> 16);
      const int cz = min(fbase + (nf_s[min(max(nzrem, 0), 63)] & 0xFFFF), nctx - 1);
      const int cn = nzrem == 1 ? nxt
                                : min(fbase + (nf_s[min(max(nzrem - 1, 0), 63)] & 0xFFFF) + 1,
                                      nctx - 1);
      const int sel_zero = csel_s[cz], sel_nonzero = csel_s[cn];
      bool nonzero;
      vring[s & mask] = decode(cur, nonzero);
      ++s;
      cur = nonzero ? sel_nonzero : sel_zero;
      nzrem -= nonzero;
      ii = ii1;
      prev = nonzero;
      more = nzrem != 0 && ii1 < 64 && s < cap;
    } while (more);
    w.nzrem = nzrem;
    w.ii = ii;
    if (nzrem == 0) {
      next_block();  // cur is the next block's count symbol already
    } else if (ii >= 64) {  // nonzeros left past position 63
      w.nzrem = 0;
      w.err = 1;
      next_block();
    }
  }
  __threadfence_block();
  ctl[0] = s;
  __threadfence_block();
  ctl[2] = 1;
  store_walk(st, L, l, state, rd.bitpos(), w);
  st[7 * L + l] = prev;
  st[8 * L + l] = x8;
  st[9 * L + l] = y8;
  st[10 * L + l] = gw8;
  st[11 * L + l] = ctxoff;
  st[12 * L + l] = (w.k >= nc || w.err != 0) ? 1 : 0;
  for (int r = 13; r < kRingRow; ++r) st[r * L + l] = 0;
  for (int i = 0; i < kRing; ++i) st[(kRingRow + i) * L + l] = cring[i];
}

}  // namespace

extern "C" {

// int32 words of scratch j40tt_hf_walk needs: the prefix design's phases
// (L lanes of W words, a table of 2^width entries a lane), then the values
// (L, V) and per lane their count and end; none for rANS.
long long j40tt_hf_walk_scratch(int L, int W, int width, int use_prefix, int V) {
  if (!use_prefix) return 0;
  return sync_scratch_ints(L, W, L, 1 << width) + (long long)L * V + 2LL * L;
}

int j40tt_hf_walk(const uint16_t* words, int W, const int* init, int* st,
                  const int* ncells, const int* lut, int lut_len,
                  const int* lane, const int* nat, float* out, int L,
                  int ncmax, int cap, int use_prefix, int width, int* scratch,
                  int V, const int* nbits, cudaStream_t stream) {
  if (use_prefix) {
    const int S = 1 << width;
    const SyncScratch sc = carve_scratch(scratch, L, W, L, S);
    int* vals = scratch + sync_scratch_ints(L, W, L, S);
    int* tail = vals + (size_t)L * V;
    const int setup = L + (int)(((size_t)L * S + kSetupThreads - 1) / kSetupThreads);
    hf_sync_setup<<<setup, kSetupThreads, 0, stream>>>(words, W, init, ncells, lut,
                                                      lut_len, lane, nbits, L, cap, sc);
    const int rc = launch_sync<false>(words, W, sc, vals, V, nullptr, tail, L, stream);
    if (rc) return rc;
    hf_structure_kernel<<<(L + kWalkWarps - 1) / kWalkWarps, 32 * kWalkWarps,
                          kWalkWarps * (kWin + kNat) * sizeof(int), stream>>>(words, W, init, st, ncells, nat, out, L, ncmax,
                                    cap, vals, V, tail, sc);
    return (int)cudaGetLastError();
  }
  const size_t smem = 4096 * sizeof(uint2) + (kNat + 3 * kAnsRing + 3) * sizeof(int);
  const int rc = allow_smem(hf_ans_kernel, smem);
  if (rc) return rc;
  hf_ans_kernel<<<L, kAnsThreads, smem, stream>>>(words, W, init, st, ncells, lut,
                                               lut_len, lane, nat, out, L, ncmax, cap);
  return (int)cudaGetLastError();
}

int j40tt_hf_ctx_walk(const uint16_t* words, int W, const int* init, int* st,
                      const int* ncells, const int* ab, int n_ab,
                      const int* cmap, int n_cmap, const int* cfgw,
                      const int* nf, const int* bctx3, int bstride,
                      const int* nat, float* out, int L, int ncmax, int cap,
                      int nb, int log_alpha, cudaStream_t stream) {
  const size_t smem = (size_t)(n_ab / 2) * sizeof(uint4) + (size_t)n_cmap * 4 * sizeof(uint16_t) +
                      (kNat + 64 + kRing + kCtxRing + 3) * sizeof(int);
  const int rc = allow_smem(hf_ctx_kernel, smem);
  if (rc) return rc;
  hf_ctx_kernel<<<L, kCtxThreads, smem, stream>>>(
      words, W, init, st, ncells, ab, n_ab, cmap, n_cmap, cfgw, nf, bctx3,
      bstride, nat, out, L, ncmax, cap, nb, log_alpha);
  return (int)cudaGetLastError();
}

}  // extern "C"
