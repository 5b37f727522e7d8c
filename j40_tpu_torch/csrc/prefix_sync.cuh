// Self-synchronising parallel decode of prefix-coded lanes, shared by the
// token kernel B6 (tokens.cu) and the HF walk B4 (hf.cu): each lane is one
// section's stream of codewords, a canonical prefix code followed by the
// token's mb extra bits, from one table (one cluster, no LZ77).  That is a
// prefix code over bit strings, so a decode started at any bit offset soon
// lands on the true symbol boundaries (Weissenberger and Schmidt, "Massively
// Parallel Huffman Decoding on GPUs", ICPP 2018).  The phases, each one
// kernel on the caller's stream, one thread per subsequence:
//
//   1. skim   the lane's own bits, from its start to the section's end
//             (never the zero padding up to W), cut into subsequences of
//             kSub bits; thread j decodes lengths only (one byte-table load
//             per symbol) from its subsequence's start to the first boundary
//             at or past the next one's start: P[j], and then on from P[j]
//             through subsequence j+1: E[j+1], C[j+1] (the first round of
//             the chase, fused).  Subsequence 0 starts at the true start.
//   2. chase  one block per lane: while some end changed in the last round,
//             re-decode every subsequence whose predecessor's end changed,
//             from that end, always taking the new count; an end that stays
//             the same stops the chase there.  Correctness never depends on
//             convergence: a code that never falls into step (a
//             fixed-length code) becomes an exact serial chase.  Then the
//             exclusive prefix sum of the counts: F[j], the index of
//             subsequence j's first symbol.
//   3. write  thread j decodes its subsequence again from its true start
//             and writes each value at its index (one fused-table load per
//             symbol).  The last subsequence has no bounded end: it decodes
//             on past the skimmed bits (a serial tail, for sections that run
//             short).
//
// A single-symbol code has length 0 everywhere: with no extra bits the lane
// is constant and is filled directly; with m > 0 extra bits every codeword
// is m bits, and the subsequences start on multiples of m.  Per-lane values
// are in `li` (kLaneInfo ints a lane), set by the caller's setup kernel
// through lane_setup().

#pragma once

#include "entropy.cuh"

namespace {

constexpr int kSub = 256;           // bits per subsequence
constexpr int kSyncThreads = 128;   // skim and write kernels
constexpr int kChaseThreads = 512;  // the chase: one block per lane
constexpr int kSetupThreads = 256;  // the callers' setup kernels
constexpr int kMaxSymbolBits = 33;  // the most bits one symbol reads

// li[l * kLaneInfo + ...]
enum LaneInfo { kS0, kRe, kSl, kNsub, kN, kZero, kTix, kLsb, kLaneInfo };
// stats[l * kStats + ...]: rounds of the chase (the fused first included),
// the last round in which an end changed (the longest chase, in
// subsequences), subsequences re-decoded after the first round, subsequences
enum SyncStat { kRounds, kChase, kRedecoded, kSubs, kStats };

struct SyncScratch {
  int *P, *E, *C, *F, *X;  // (L, NS) each
  int* li;                 // (L, kLaneInfo)
  int* stats;              // (L, kStats)
  uint2* fz;               // (T, S) fused entries
  uint8_t* tl;             // (T, S) codeword lengths, extra bits included
  int NS, S;
};

// Subsequences a lane of W words may hold, and one more (even, so that the
// fused entries after the int32 arrays stay 8-byte aligned).
inline int sync_ns(int W) { return (16 * W / kSub + 3) & ~1; }

// Offset (int32 words) of the (L, kStats) statistics in the scratch.
inline long long sync_stats_offset(int L, int W) {
  return 5LL * L * sync_ns(W) + (long long)L * kLaneInfo;
}

// int32 words of scratch for L lanes of W words and T tables of S entries.
inline long long sync_scratch_ints(int L, int W, int T, int S) {
  return sync_stats_offset(L, W) + (long long)L * kStats + 2LL * T * S +
         ((long long)T * S + 3) / 4;
}

inline SyncScratch carve_scratch(int* base, int L, int W, int T, int S) {
  SyncScratch sc;
  sc.NS = sync_ns(W);
  sc.S = S;
  const size_t ls = (size_t)L * sc.NS;
  sc.P = base;
  sc.E = sc.P + ls;
  sc.C = sc.E + ls;
  sc.F = sc.C + ls;
  sc.X = sc.F + ls;
  sc.li = sc.X + ls;
  sc.stats = sc.li + (size_t)L * kLaneInfo;
  sc.fz = (uint2*)(sc.stats + (size_t)L * kStats);  // 8-byte aligned: even offset
  sc.tl = (uint8_t*)(sc.fz + (size_t)T * S);
  return sc;
}

// Lane l's per-lane values, computed by one block of the setup kernel
// (kSetupThreads threads): the region [s0, re) to skim ends at the end of
// the lane's section, `bits` (< 0: unknown, then at its last nonzero word),
// and at s0 + 33 n bits (n symbols never need more).  single: the code has
// one symbol (length 0), m its extra bits.
__device__ void lane_setup(const uint16_t* w, int W, int l, int bits, int s0, int n,
                           bool single, int m, int tix, int lsb,
                           const SyncScratch& sc) {
  int* li = sc.li + (size_t)l * kLaneInfo;
  if (bits < 0) {
    if (threadIdx.x == 0) li[kRe] = 0;
    __syncthreads();
    for (int top = W; top > 0; top -= blockDim.x) {
      const int i = top - 1 - (int)threadIdx.x;
      const bool nz = i >= 0 && w[i] != 0;
      if (nz) atomicMax(&li[kRe], i + 1);
      if (__syncthreads_or(nz)) break;
    }
    __syncthreads();
  }
  if (threadIdx.x != 0) return;
  const long long end = bits < 0 ? 16LL * li[kRe] : min(bits, 16 * W);
  const long long re = min(end, (long long)s0 + (long long)kMaxSymbolBits * n);
  const bool zero = single && m == 0;
  const int sl = single && m > 0 ? m * ((kSub + m - 1) / m) : kSub;
  int nsub = 1;
  if (!zero && re > s0) nsub = (int)((re - s0 + sl - 1) / sl);
  li[kS0] = s0;
  li[kRe] = (int)re;
  li[kSl] = sl;
  li[kNsub] = min(nsub, sc.NS);
  li[kN] = n;
  li[kZero] = zero;
  li[kTix] = tix;
  li[kLsb] = lsb;
  int* stats = sc.stats + (size_t)l * kStats;
  stats[kRounds] = stats[kChase] = stats[kRedecoded] = 0;
  stats[kSubs] = li[kNsub];
}

// One prefix-coded symbol through the fused table fz of 2^k slots: its
// code, then its extra bits; the buffer holds enough bits (refilled).
template <typename Buf>
__device__ __forceinline__ int prefix_symbol(Buf& b, const uint2* fz, uint32_t mask,
                                             int lsb) {
  const uint2 e = fz[b.peek() & mask];
  b.drop((int)(e.x & 31));
  return fused_value(b, e, lsb);
}

struct Skim {
  int end, count;
};

// Lengths only, from bit a to the first boundary at or past lim.
__device__ __forceinline__ Skim skim(const uint16_t* w, int W, int a, int lim,
                                     const uint8_t* tl, uint32_t mask) {
  Bits b{w, W, 0, 0, 0};
  b.seek(a);
  int pos = a, c = 0;
  while (pos < lim) {
    b.refill();
    const int k = tl[b.peek() & mask];
    b.drop(k);
    pos += k;
    ++c;
  }
  return Skim{pos, c};
}

// Phase 1 and the first round of the chase.  Grid (ceil(NS / threads), L).
__global__ void __launch_bounds__(kSyncThreads)
    sync_skim_kernel(const uint16_t* __restrict__ words, int W, SyncScratch sc) {
  const int l = blockIdx.y;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int* li = sc.li + (size_t)l * kLaneInfo;
  const int nsub = li[kNsub];
  if (j >= nsub - 1) return;  // the last subsequence has no bounded end
  const int s0 = li[kS0], sl = li[kSl];
  const uint8_t* tl = sc.tl + (size_t)li[kTix] * sc.S;
  const uint32_t mask = (uint32_t)sc.S - 1;
  const uint16_t* w = words + (size_t)l * W;
  const size_t row = (size_t)l * sc.NS;
  const int lim = s0 + j * sl + sl;
  const Skim own = skim(w, W, s0 + j * sl, lim, tl, mask);
  sc.P[row + j] = own.end;
  if (j == 0) {
    sc.E[row] = own.end;
    sc.C[row] = own.count;
  }
  if (j + 1 < nsub - 1) {
    const Skim next = skim(w, W, own.end, lim + sl, tl, mask);
    sc.E[row + j + 1] = next.end;
    sc.C[row + j + 1] = next.count;
  }
}

// Phase 2: the chase to a fixed point, then the prefix sum.  One block of
// kChaseThreads per lane; dynamic shared memory (blockDim + 1) ints.  The
// arrays are read and written by other threads of the block between
// barriers (plain loads, not the read-only path).
__global__ void __launch_bounds__(kChaseThreads)
    sync_chase_kernel(const uint16_t* __restrict__ words, int W, SyncScratch sc) {
  extern __shared__ int sh[];
  const int l = blockIdx.x;
  const int t = threadIdx.x, T = blockDim.x;
  const int* li = sc.li + (size_t)l * kLaneInfo;
  const int nsub = li[kNsub], s0 = li[kS0], sl = li[kSl];
  const uint8_t* tl = sc.tl + (size_t)li[kTix] * sc.S;
  const uint32_t mask = (uint32_t)sc.S - 1;
  const uint16_t* w = words + (size_t)l * W;
  const size_t row = (size_t)l * sc.NS;
  int *P = sc.P + row, *E = sc.E + row, *C = sc.C + row, *F = sc.F + row,
      *X = sc.X + row;
  if (t == 0) sh[T] = 0;

  // X[j]: the round in which E[j] last changed (round 1: the skim kernel)
  bool changed = false;
  for (int j = t; j < nsub - 1; j += T) {
    const bool c = j > 0 && E[j] != P[j];
    X[j] = c;
    changed |= c;
  }
  int round = 1, chase = 0, redecoded = 0;
  bool any = __syncthreads_or(changed);
  if (any) chase = 1;
  while (any) {
    ++round;
    for (int j = 1 + t; j < nsub - 1; j += T) {  // pending ends into P, counts into F
      if (X[j - 1] == round - 1) {
        const Skim s = skim(w, W, E[j - 1], s0 + (j + 1) * sl, tl, mask);
        P[j] = s.end;
        F[j] = s.count;
        ++redecoded;
      } else {
        P[j] = -1;
      }
    }
    __syncthreads();
    changed = false;
    for (int j = 1 + t; j < nsub - 1; j += T) {
      if (P[j] < 0) continue;
      C[j] = F[j];
      if (P[j] != E[j]) {
        E[j] = P[j];
        X[j] = round;
        changed = true;
      }
    }
    any = __syncthreads_or(changed);
    if (any) chase = round;
  }
  if (redecoded) atomicAdd(&sh[T], redecoded);

  // exclusive prefix sum of the bounded subsequences' counts; F[nsub-1] is
  // their total (the last subsequence's first symbol)
  const int per = (nsub + T - 1) / T;
  const int lo = min(t * per, nsub), hi = min(lo + per, nsub);
  int sum = 0;
  for (int j = lo; j < hi && j < nsub - 1; ++j) sum += C[j];
  sh[t] = sum;
  __syncthreads();
  for (int d = 1; d < T; d <<= 1) {  // inclusive scan of the thread sums
    const int v = t >= d ? sh[t - d] : 0;
    __syncthreads();
    sh[t] += v;
    __syncthreads();
  }
  int run = sh[t] - sum;
  for (int j = lo; j < hi; ++j) {
    F[j] = run;
    if (j < nsub - 1) run += C[j];
  }
  if (t == 0) {
    int* stats = sc.stats + (size_t)l * kStats;
    stats[kRounds] = round;
    stats[kChase] = chase;
    stats[kRedecoded] = sh[T];
  }
}

// The start of subsequence j (its predecessor's true end).
__device__ __forceinline__ int sub_start(const SyncScratch& sc, size_t row, int j,
                                         int s0) {
  return j == 0 ? s0 : sc.E[row + j - 1];
}

// Phase 3.  kTokens (B6): values into out (L, n_out), zeros past n, and the
// bit position after symbol n-1 into st[L + l] (st[l], the rANS state, 0).
// Otherwise (B4): values into out (L, n_out) scratch, and tail[2l], tail[2l+1]
// = the values written and the bit position after the last of them; the
// last subsequence stops at the end of the skimmed bits.
template <bool kTokens>
__global__ void __launch_bounds__(kSyncThreads)
    sync_write_kernel(const uint16_t* __restrict__ words, int W, SyncScratch sc,
                      int* __restrict__ out, int n_out, int* __restrict__ st,
                      int* __restrict__ tail, int L) {
  const int l = blockIdx.y;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  const int* li = sc.li + (size_t)l * kLaneInfo;
  const int n = li[kN], nsub = li[kNsub], s0 = li[kS0];
  const uint2* fz = sc.fz + (size_t)li[kTix] * sc.S;
  int* o = out + (size_t)l * n_out;
  if (kTokens)
    for (int i = n + j; i < n_out; i += stride) o[i] = 0;
  if (j == 0) {
    if (kTokens) {
      st[l] = 0;
      if (n == 0 || li[kZero]) st[L + l] = s0;
    } else if (n == 0 || li[kZero]) {
      tail[2 * l] = n;
      tail[2 * l + 1] = s0;
    }
  }
  if (li[kZero]) {  // zero-bit codewords: a constant lane
    const int v = (int)fz[0].y;
    for (int i = j; i < n; i += stride) o[i] = v;
    return;
  }
  if (j >= nsub) return;
  const size_t row = (size_t)l * sc.NS;
  const int f = sc.F[row + j];
  const bool last = j == nsub - 1;
  if (f >= n) {
    if (!kTokens && last && n > 0) {  // the skimmed bits hold every value the walk takes
      tail[2 * l] = n;
      tail[2 * l + 1] = -1;
    }
    return;
  }
  const int cnt = last ? n - f : sc.C[row + j];
  const int re = li[kRe], lsb = li[kLsb];
  const uint32_t mask = (uint32_t)sc.S - 1;
  Bits b{words + (size_t)l * W, W, 0, 0, 0};
  b.seek(sub_start(sc, row, j, s0));
  int i = 0;
  for (; i < cnt && f + i < n; ++i) {
    if (!kTokens && last && b.bitpos() >= re) break;
    b.refill();
    o[f + i] = prefix_symbol(b, fz, mask, lsb);
  }
  if (kTokens) {
    if (f + i == n) st[L + l] = b.bitpos();
  } else if (last) {
    tail[2 * l] = f + i;
    tail[2 * l + 1] = b.bitpos();
  }
}

// The bit position after symbol idx (>= 0) of a lane the phases decoded:
// the subsequence that holds it, by binary search over F, then lengths
// from its start.  One thread.
__device__ int sync_pos_after(const uint16_t* w, int W, const SyncScratch& sc,
                              int l, int idx) {
  const int* li = sc.li + (size_t)l * kLaneInfo;
  const int s0 = li[kS0];
  if (li[kZero]) return s0;
  const size_t row = (size_t)l * sc.NS;
  int lo = 0, hi = li[kNsub] - 1;  // largest j with F[j] <= idx
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (sc.F[row + mid] <= idx) lo = mid;
    else hi = mid - 1;
  }
  const uint8_t* tl = sc.tl + (size_t)li[kTix] * sc.S;
  Bits b{w, W, 0, 0, 0};
  const int a = sub_start(sc, row, lo, s0);
  b.seek(a);
  int pos = a;
  for (int k = sc.F[row + lo]; k <= idx; ++k) {
    b.refill();
    const int len = tl[b.peek() & ((uint32_t)sc.S - 1)];
    b.drop(len);
    pos += len;
  }
  return pos;
}

// Launch phases 1-3 after the caller's setup kernel.
template <bool kTokens>
int launch_sync(const uint16_t* words, int W, const SyncScratch& sc, int* out,
                int n_out, int* st, int* tail, int L, cudaStream_t stream) {
  const dim3 grid((sc.NS + kSyncThreads - 1) / kSyncThreads, L);
  sync_skim_kernel<<<grid, kSyncThreads, 0, stream>>>(words, W, sc);
  sync_chase_kernel<<<L, kChaseThreads, (kChaseThreads + 1) * sizeof(int), stream>>>(
      words, W, sc);
  sync_write_kernel<kTokens><<<grid, kSyncThreads, 0, stream>>>(
      words, W, sc, out, n_out, st, tail, L);
  return (int)cudaGetLastError();
}

}  // namespace
