// Hand-written Hopper (sm_90a) kernels of the Modular wavefronts.
//
// They replace the four device programs of j40_tpu/ops/device_entropy.py
// that reconstruct lossless Modular planes, each a jax.lax.scan over the
// diagonals of a plane inside jax.jit (no pl.pallas_call):
//
//   j40tt_wavefront       <- gradient_reconstruct (scan at :491) and
//                            mixed_reconstruct (scan at :548)          (W1)
//   j40tt_wavefront_wp    <- _wp_reconstruct (scan at :738), WP alone or
//                            per-pixel codes 0-12                      (W2)
//                         <- _tree_wp_reconstruct (scan at :956), the
//                            MA-tree walk inside the step              (W3)
//
// Same conventions as reconstruct.cu, and built into the same library
// (j40_tpu_torch/ops/_build.py): a plain C interface bound with ctypes
// (ops/wavefront_kernels.py); every entry point launches on the caller's
// stream, allocates nothing and returns cudaGetLastError().
//
// Semantics: bit for bit those of the plain versions in
// ops/device_entropy.py (_plain_wavefront, _wp_wavefront), which are
// j40.h's predictors (j40.h:4021-4227) with PyTorch's int32 arithmetic:
// every sum or product that can wrap is done in uint32 and cast back, as
// signed overflow is undefined in C++.  The WP overflow flag is the plain
// version's: a lane whose error state reaches 2^24 is flagged, runs to
// its end (the table indices stay clamped), and the host decodes it again.
//
// What bounds it: a chain.  Pixel (y, x) lies on diagonal d = k*y + x (k = 1
// for W1, 2 for W2) and reads only pixels of diagonals d-1..d-2k, so a
// plane takes D = k*H + W - k dependent steps (511 for a 256x256 plane in
// W1, 766 in W2); the bytes (a plane in, a plane out) would take a few
// microseconds.  The time is D times the latency of one step, so the design
// takes everything but the step's own arithmetic off that chain:
// - A warp owns a band of 32 consecutive rows, one lane a row, and walks
//   the band's diagonals with no CTA barrier: lane i of band j computes
//   (32j + i, s - k*i) at its step s.  What lane i reads of the row above
//   at step s is what lane i-1 computed at step s-1 (W1: N; W2: NE, its
//   true error and 4 sub-errors, and the row above's own N there, this
//   row's NN a step later), one __shfl_up_sync each; older neighbours (NW,
//   N, NWW; W, WW) are carried in registers.
// - Lane 0 reads the row above from a ring in shared memory that lane 31
//   of the band above fills, indexed by the producer row's column.  Each
//   32-bit value travels with its sequence number in one 64-bit word,
//   stored and loaded as a relaxed atomic: the consumer spins until the
//   words of its slot carry the number it waits for, so no fence sits on
//   the chain (a fence would wait for the chunk's loads and stores in
//   flight); W1 loads its word a step ahead.  Back-pressure: the consumer
//   stores how far it has read (`con`) once a chunk, after the values it
//   read have been used, and the producer, once a chunk, waits until `con`
//   is past the previous use of the slots its chunk writes.  Warps run
//   skewed: a warp waits only when it catches up with the band above, and
//   nothing depends on the order warps are scheduled.  The step is
//   branch-free but for those waits (a code or a tree property is picked
//   by a select tree, not a switch).
// - A plane taller than the CTA's warps (H > 1024 in W1, 512 in W1 with
//   codes and in W2: they keep 128 registers a thread) gives each warp
//   bands w, w + warps, ..., walked one after the other; band j feeds
//   band j + 1 through ring (j + 1) mod warps, whose sequence numbers run
//   on across the rounds.
//   That cannot deadlock as long as W is at most tall_width_limit(): the
//   last band of a round cannot consume until its warp's previous band is
//   done, so the rings above it must absorb the skew (2,792 columns in W1,
//   1,384 with codes, 1,412 in W2; a Modular group is at most 1,024 wide;
//   the entry points refuse a wider tall plane, the wrappers raise first).
// - Residuals (and codes) come a chunk of steps ahead (8 in W1, 4 in W2,
//   whose step is slower), by 4-byte cp.async copies into the warp's
//   staging in shared memory: the copies of chunk c + 1 are in flight
//   while chunk c is walked, and no step waits on global memory.  A lane
//   takes its own row's chunk from there into registers; outputs go back
//   the same way, a chunk at a time.  Each copy or store instruction covers
//   32 / chunk rows of `chunk` consecutive columns, where a lane's own row
//   would touch 32 rows, 32 sectors, an instruction.  (Row starts are not
//   16-byte aligned for odd widths, so these are 4-byte copies.)
// - W3's MA-tree nodes are one int4 each in shared memory (a branch:
//   property, value, left, right; a leaf: -1, predictor, offset,
//   multiplier), one 16-byte load a level; trees over kMaxTreeNodes are
//   refused (the route sends their sections to the host).

#include <cuda_runtime.h>
#include <stdint.h>

// The WP parameters of a Modular sub-header (modular/wp.py WPParams);
// layout shared with ops/wavefront_kernels.py (11 int32 in host memory).
struct J40ttWpParams {
  int p1, p2, p3[5], w[4];
};

namespace {

constexpr unsigned kFull = 0xffffffffu;
// W1's CTA: one lane a row up to 1024 rows (64 registers a thread); with
// codes up to 512 (their chunks need 128 registers).  W2's CTA: up to 512
// rows, for the same reason (the blend and the tree walk).  A taller plane
// gives each warp 2 or more bands.
constexpr int kMaxThreads = 1024, kMaxThreadsCodes = 512, kWpMaxThreads = 512;
// steps a residual chunk (and between `con` stores), and ring slots a band
// boundary (a power of 2)
constexpr int kPlainChunk = 8, kPlainRing = 64;
constexpr int kWpChunk = 4, kWpRing = 32;
constexpr int kWpWords = 8;  // 64-bit words a W2 slot: value, true error, NN, 4 sub-errors
// a producer waits once a chunk for the slots of its whole chunk, which
// straddle two of its consumer's chunks: a ring of fewer slots deadlocks
static_assert(kPlainRing >= 2 * kPlainChunk - 1 && kWpRing >= 2 * kWpChunk, "ring too short");
// the dynamic shared memory a CTA may take: sm_90's 227 KB a block, less
// 1 KB for W2's static div24 table
constexpr int kSmemCap = 227 * 1024 - 1024;
// a CTA's rings and `con` counts, and a warp's staging: two chunks of
// residuals (and of codes) and one of outputs, 32 rows each
__host__ __device__ constexpr int ring_bytes(int warps, int slots, int words) {
  return warps * slots * words * 8 + (warps * 4 + 15) / 16 * 16;
}
__host__ __device__ constexpr int stage_bytes(int warps, int chunk, bool codes) {
  return warps * 32 * chunk * 4 * (codes ? 5 : 3);
}
// W3's tree beside W2's rings and staging, 16 B a node
constexpr int kMaxTreeNodes = (kSmemCap - ring_bytes(kWpMaxThreads / 32, kWpRing, kWpWords) -
                               stage_bytes(kWpMaxThreads / 32, kWpChunk, false)) / 16;

enum Mode { kWpOnly = 0, kCodes = 1, kTree = 2 };

using WpParams = J40ttWpParams;

// The widest plane taller than a CTA (more bands than warps) that cannot
// deadlock.  k: 1 (W1) or 2 (W2); look: the columns a consumer reads ahead
// (W1 0: N; W2 1: NE).  In the worst case the last band of a round has not
// started consuming (its warp is still on its previous band), so the band
// above it blocks at column `ring`; each band further up can run `ring`
// columns past what the band below has released, which is the chunks that
// band completed before it blocked.  The first band of the round must get
// through all W columns.  tests/test_torch_wavefront_design.py models it.
constexpr int tall_width_limit(int k, int look, int warps, int ring, int chunk) {
  int b = ring;
  for (int p = 1; p < warps; ++p) b = chunk * ((b + 31 * k + look) / chunk) + ring;
  return b;
}

// PyTorch's int32 arithmetic: two's-complement wrap
__device__ __forceinline__ int add(int a, int b) { return (int)((unsigned)a + (unsigned)b); }
__device__ __forceinline__ int sub(int a, int b) { return (int)((unsigned)a - (unsigned)b); }
__device__ __forceinline__ int mul(int a, int b) { return (int)((unsigned)a * (unsigned)b); }
__device__ __forceinline__ int neg(int a) { return (int)(0u - (unsigned)a); }
// torch.abs: |INT_MIN| stays INT_MIN
__device__ __forceinline__ int iabs(int a) { return a < 0 ? neg(a) : a; }
__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }
// torch.clamp(v, lo, hi) = min(max(v, lo), hi)
__device__ __forceinline__ int clampi(int v, int lo, int hi) { return imin(imax(v, lo), hi); }
// device_entropy._ilog2: floor(log2(n)) for n >= 1, 0 for n <= 0
__device__ __forceinline__ int ilog2(int n) { return n > 0 ? 31 - __clz(n) : 0; }

// the clamped gradient (predictor 5)
__device__ __forceinline__ int grad(int w, int n, int nw) {
  return clampi(sub(add(w, n), nw), imin(w, n), imax(w, n));
}

// C-style (a + b) / 2, truncating toward zero (_trunc_half_sum_dev)
__device__ __forceinline__ int half_sum(int a, int b) {
  const int s = add(a, b);
  return s >= 0 ? s >> 1 : neg(neg(s) >> 1);
}

// The hand-off between bands: one 32-bit value and its sequence number in
// a 64-bit word, single-copy atomic in shared memory (volatile: a relaxed
// access), so that a slot's words need no fence to be read whole.
using Word = unsigned long long;
__device__ __forceinline__ Word load_word(const Word* p) { return *(const volatile Word*)p; }
__device__ __forceinline__ void store_word(Word* p, int v, int seq) {
  *(volatile Word*)p = (Word)(unsigned)v | (Word)(unsigned)seq << 32;
}
__device__ __forceinline__ int seq_of(Word w) { return (int)(w >> 32); }
__device__ __forceinline__ int value_of(Word w) { return (int)(unsigned)w; }
__device__ __forceinline__ int load_count(const int* p) { return *(const volatile int*)p; }
__device__ __forceinline__ void store_count(int* p, int v) { *(volatile int*)p = v; }
// a spin-wait's pause: none on the card; the CPU thread shim
// (tools/cpu_shim) lets the other threads run
__device__ __forceinline__ void pause() {
#ifndef __CUDA_ARCH__
  __nanosleep(0);
#endif
}

// A ring's `con` before any band has read it: ring 0 is first read in the
// second round (band 0 has no band above), from sequence number W on.
__device__ __forceinline__ int first_con(int ring, int W) { return ring == 0 ? W : 0; }

// One band's two boundaries: it reads ring `rc` (sequence numbers from
// base_c) and writes ring `rp` (from base_p).  Band j reads ring j mod
// warps and writes ring (j + 1) mod warps; a ring's sequence numbers run
// on from round to round, W a round.
struct Link {
  int rc, rp, base_c, base_p;
  int con_seen;    // the consumer's count last read (it only grows)
  bool up, down;   // a band above / below to hand off with

  __device__ __forceinline__ Link(int band, int bands, int warps, int W)
      : rc(band % warps), rp((band + 1) % warps), base_c(band / warps * W),
        base_p((band + 1) / warps * W), con_seen(0), up(band > 0), down(band + 1 < bands) {}

  // the slot of column c of the row above, for the consumer
  template <int kRing>
  __device__ __forceinline__ int in_slot(int c) const {
    return rc * kRing + ((base_c + c) & (kRing - 1));
  }
  // the slot of column c of this band's last row, for the producer
  template <int kRing>
  __device__ __forceinline__ int out_slot(int c) const {
    return rp * kRing + ((base_p + c) & (kRing - 1));
  }
  // before a chunk whose last row writes columns up to c: wait until the
  // consumer is done with the slots they reuse (once a chunk, off the
  // steps; the deadlock bound is the same as column by column, as the
  // consumer's count moves once a chunk too)
  template <int kRing>
  __device__ __forceinline__ void wait_out(int c, const int* con) {
    if (!down || c < 0) return;
    const int q = base_p + c;
    while (q >= con_seen + kRing) {
      con_seen = load_count(con + rp);
      pause();
    }
  }
};

// A 4-byte copy from device to shared memory that does not wait for the
// load, zero-filled when `ok` is false (cp.async; the wait below waits for
// all but the last chunk's copies)
__device__ __forceinline__ void copy4(int* dst, const int* src, bool ok) {
#ifdef __CUDA_ARCH__
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 4 : 0));
#else
  *dst = ok ? *src : 0;
#endif
}
__device__ __forceinline__ void commit_copies() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}
__device__ __forceinline__ void wait_copies_but_last() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group 1;\n" ::);
#endif
}
__device__ __forceinline__ void wait_all_copies() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::);
#endif
}

// A warp's chunks of K steps through its staging in shared memory.  At the
// chunk's step s0 row r of the band (lane r) computes column s0 - k*r; an
// instruction of the warp covers rows it * 32 / K .. + 32 / K - 1, lane l
// column l % K of row l / K of them, so that its addresses are 32 / K runs
// of K consecutive ints.
template <int K, int k>
struct Stage {
  static constexpr int kRows = 32 / K;
  int* buf;  // [32][K] each: residuals x 2, codes x 2 (if any), outputs
  const int* band_res;
  const int* band_codes;
  int* band_out;
  int rows, W, lane;

  // start the copies of chunk s0 into buffer b
  __device__ __forceinline__ void fetch(int s0, int b, bool codes) const {
#pragma unroll
    for (int it = 0; it < K; ++it) {
      const int r = it * kRows + lane / K, x = s0 - k * r + lane % K;
      const bool ok = r < rows && x >= 0 && x < W;
      const size_t at = ok ? (size_t)r * W + x : 0;
      copy4(buf + (b * 32 + r) * K + lane % K, band_res + at, ok);
      if (codes) copy4(buf + ((2 + b) * 32 + r) * K + lane % K, band_codes + at, ok);
    }
    commit_copies();
  }
  // this lane's row of buffer b (after the copies are waited for)
  __device__ __forceinline__ void row(int (&v)[K], int b) const {
#pragma unroll
    for (int j = 0; j < K; ++j) v[j] = buf[(b * 32 + lane) * K + j];
  }
  // the chunk's outputs from s0: each lane's row into the staging, then the
  // warp's coalesced stores
  __device__ __forceinline__ void store(const int (&v)[K], int s0, int slot) const {
    int* o = buf + slot * 32 * K;
    __syncwarp();
#pragma unroll
    for (int j = 0; j < K; ++j) o[lane * K + j] = v[j];
    __syncwarp();
#pragma unroll
    for (int it = 0; it < K; ++it) {
      const int r = it * kRows + lane / K, x = s0 - k * r + lane % K;
      if (r < rows && x >= 0 && x < W) band_out[(size_t)r * W + x] = o[r * K + lane % K];
    }
  }
};

// Walk a band's chunks from step s_begin past s_end: `chunk(s0, rb, cb)`
// walks K steps on the lane's residuals rb and codes cb and returns its
// outputs in rb.  The next chunk's copies are in flight meanwhile.
template <int K, int k, bool kCodes, typename F>
__device__ __forceinline__ void walk_band(const Stage<K, k>& io, int s_begin, int s_end,
                                          F&& chunk) {
  io.fetch(s_begin, 0, kCodes);
  for (int s0 = s_begin, b = 0;; s0 += K, b ^= 1) {
    __syncwarp();  // every lane is done with buffer b ^ 1 (the chunk before)
    io.fetch(s0 + K, b ^ 1, kCodes);
    wait_copies_but_last();
    __syncwarp();  // every lane's copies of chunk s0 have landed
    int rb[K], cb[K];
    io.row(rb, b);
    if (kCodes) io.row(cb, 2 + b);
    chunk(s0, rb, cb);
    io.store(rb, s0, kCodes ? 4 : 2);
    if (s0 + K > s_end) break;
  }
  wait_all_copies();
}

// ------------------------------------------------------------------- W1

// Predictors 0/1/2/5 on the y + x wavefront (_plain_wavefront): kCodes
// reads a per-pixel code (0: zero, 1: W, 2: N, anything else: gradient),
// else every pixel takes the gradient.
struct PlainLane {
  int v1 = 0;     // this row's value at step s - 1: W
  int nprev = 0;  // the row above at step s - 1: NW now

  // step s: `above` is the row above at column x = s - lane
  __device__ __forceinline__ int step(int above, int rv, int code, bool has_w, bool has_n) {
    // the edge chain: W falls back to N at x = 0 (0 at the origin), N to W,
    // NW to W
    const int n1 = has_n ? above : 0;
    const int w_ = has_w ? v1 : n1;
    const int n_ = has_n ? n1 : w_;
    const int nw = has_w && has_n ? nprev : w_;
    const int pred = code == 0 ? 0 : code == 1 ? w_ : code == 2 ? n_ : grad(w_, n_, nw);
    nprev = above;
    // outside the plane the value is never read (the edge chain reads only
    // pixels inside) nor stored
    v1 = add(pred, rv);
    return v1;
  }
};

template <bool kCodes>
__global__ void __launch_bounds__(kCodes ? kMaxThreadsCodes : kMaxThreads, 1)
plain_wavefront_kernel(const int* __restrict__ res, const int* __restrict__ codes,
                       int* __restrict__ out, int H, int W) {
  constexpr int kChunk = kPlainChunk, kRing = kPlainRing;
  extern __shared__ int4 smem4[];
  const int warps = blockDim.x / 32;
  Word* ring = (Word*)smem4;  // [warps][kRing] the row above's values
  int* con = (int*)(ring + warps * kRing);
  int* stage = (int*)((char*)smem4 + ring_bytes(warps, kRing, 1));
  for (int i = threadIdx.x; i < warps * kRing; i += blockDim.x) ring[i] = ~0ull;
  for (int i = threadIdx.x; i < warps; i += blockDim.x) con[i] = first_con(i, W);
  __syncthreads();

  const size_t plane = (size_t)H * W;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bands = (H + 31) / 32;
  for (int band = warp; band < bands; band += warps) {
    Link link(band, bands, warps, W);
    const int y = band * 32 + lane;
    const size_t at = blockIdx.x * plane + (size_t)band * 32 * W;
    const int rows = imin(32, H - band * 32);
    const Stage<kChunk, 1> io{stage + warp * 32 * kChunk * (kCodes ? 5 : 3), res + at,
                              kCodes ? codes + at : nullptr, out + at, rows, W, lane};
    PlainLane st;
    Word ahead = load_word(ring + link.in_slot<kRing>(0));
    walk_band<kChunk, 1, kCodes>(io, 0, rows - 1 + W - 1, [&](int s0, int (&rb)[kChunk],
                                                              const int (&cb)[kChunk]) {
      link.wait_out<kRing>(imin(s0 + kChunk - 1 - 31, W - 1), con);
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const int s = s0 + j, x = s - lane;
        // lane 0's row above: column s of the band above's last row, its
        // word loaded a step ahead (every lane reads the same word, so a
        // wait is the warp's)
        Word w = ahead;
        ahead = load_word(ring + link.in_slot<kRing>(s + 1));
        if (link.up && s < W && seq_of(w) != link.base_c + s) {
          do {
            pause();
            w = load_word(ring + link.in_slot<kRing>(s));
          } while (seq_of(w) != link.base_c + s);
        }
        const int shfl = __shfl_up_sync(kFull, st.v1, 1);
        rb[j] = st.step(lane == 0 ? value_of(w) : shfl, rb[j], kCodes ? cb[j] : 5, x > 0,
                        y > 0);
        // lane 31 hands column s - 31 of its row to the band below
        const int c = s - 31;
        if (link.down && lane == 31 && c >= 0 && c < W)
          store_word(ring + link.out_slot<kRing>(c), st.v1, link.base_p + c);
      }
      // the columns s0..s0+kChunk-1 of the row above are read and used
      if (link.up && lane == 0) store_count(con + link.rc, link.base_c + imin(s0 + kChunk, W));
    });
  }
}

// ------------------------------------------------------------------- W2

// The neighbourhood of one pixel on the d = 2y + x wavefront, with the
// substitution chain of decode.py:340-347 (_wp_wavefront)
struct Nb {
  int pw, pn, pnw, pne, pnn, pww, pnww;
  int tew, ten, tenw, tene;
  int wppred;
};

// v[i] for i in 0-15, without a branch (the lanes of a warp pick
// different entries): a 4-level select on the bits of i
__device__ __forceinline__ int pick16(const int (&v)[16], int i) {
  int a[8], b[4];
#pragma unroll
  for (int k = 0; k < 8; ++k) a[k] = i & 1 ? v[2 * k + 1] : v[2 * k];
#pragma unroll
  for (int k = 0; k < 4; ++k) b[k] = i & 2 ? a[2 * k + 1] : a[2 * k];
  const int c0 = i & 4 ? b[1] : b[0], c1 = i & 4 ? b[3] : b[2];
  return i & 8 ? c1 : c0;
}

// the prediction of code c (0-12; anything else gives 0): _branches/_select
__device__ __forceinline__ int branch(int c, const Nb& b) {
  const int v[16] = {0,
                     b.pw,
                     b.pn,
                     half_sum(b.pw, b.pn),
                     iabs(sub(b.pn, b.pnw)) < iabs(sub(b.pw, b.pnw)) ? b.pw : b.pn,
                     grad(b.pw, b.pn, b.pnw),
                     b.wppred,
                     b.pne,
                     b.pnw,
                     b.pww,
                     half_sum(b.pw, b.pnw),
                     half_sum(b.pn, b.pnw),
                     half_sum(b.pn, b.pne),
                     0,
                     0,
                     0};
  return pick16(v, (unsigned)c <= 12u ? c : 0);
}

// The MA-tree properties 0-15 of the pixel (_tree_wp_reconstruct's props)
struct Props {
  int v[16];
  __device__ __forceinline__ Props(const Nb& b, int cidx, int sidx, int y, int x) {
    v[0] = cidx;
    v[1] = sidx;
    v[2] = y;
    v[3] = x;
    v[4] = iabs(b.pn);
    v[5] = iabs(b.pw);
    v[6] = b.pn;
    v[7] = b.pw;
    v[8] = x > 0 ? sub(b.pw, sub(add(b.pww, b.pnw), b.pnww)) : b.pw;
    v[9] = sub(add(b.pw, b.pn), b.pnw);
    v[10] = sub(b.pw, b.pnw);
    v[11] = sub(b.pnw, b.pn);
    v[12] = sub(b.pn, b.pne);
    v[13] = sub(b.pn, b.pnn);
    v[14] = sub(b.pw, b.pww);
    // 15: the magnitude-max true error, W first on ties
    int m = b.tew;
    m = iabs(m) < iabs(b.ten) ? b.ten : m;
    m = iabs(m) < iabs(b.tenw) ? b.tenw : m;
    v[15] = iabs(m) < iabs(b.tene) ? b.tene : m;
  }
};

// What one row hands the row below for a step: its value, true error and
// 4 sub-errors, and its own N (the row below's NN a step later).  Lane to
// lane by shuffle; band to band as one 32-byte ring slot.
struct Up {
  int v, te, nn;
  int4 e;
};

// One lane's row on the 2y + x wavefront: at step s it computes column
// x = s - 2 * lane.  Its own values of steps s-1 and s-2 (W, WW), and the
// row above's of steps s-1..s-4 (NE, N, NW, NWW), are carried here.
struct WpLane {
  int v1 = 0, v2 = 0, te1 = 0;  // this row at s-1 (W), s-2 (WW), true error at s-1
  int4 ea1 = {0, 0, 0, 0}, ea2 = {0, 0, 0, 0};  // sub-errors at s-1 (W), s-2 (WW)
  int un1 = 0, un2 = 0, un3 = 0, un4 = 0;       // the row above at s-1..s-4
  int ute1 = 0, ute2 = 0, ute3 = 0;             // its true errors at s-1..s-3
  int4 uea1 = {0, 0, 0, 0}, uea2 = {0, 0, 0, 0}, uea3 = {0, 0, 0, 0};  // sub-errors
  int nn = 0, nn_next = 0;                      // two rows up: NN of this step, the next

  // take the row above's step s-1
  __device__ __forceinline__ void push_above(const Up& u) {
    un4 = un3;
    un3 = un2;
    un2 = un1;
    un1 = u.v;
    ute3 = ute2;
    ute2 = ute1;
    ute1 = u.te;
    uea3 = uea2;
    uea2 = uea1;
    uea1 = u.e;
    nn = nn_next;
    nn_next = u.nn;
  }
  // what the row below takes at its next step
  __device__ __forceinline__ Up mine() const { return Up{v1, te1, un2, ea1}; }
};

template <int kMode>
__global__ void __launch_bounds__(kWpMaxThreads, 1)
wp_wavefront_kernel(const int* __restrict__ res, const int* __restrict__ codes,
                    const int4* __restrict__ tree_global, int nodes, int depth,
                    const int* __restrict__ cidx, const int* __restrict__ sidx, WpParams P,
                    int* __restrict__ out, uint8_t* __restrict__ ovf, int H, int W) {
  constexpr int kChunk = kWpChunk, kRing = kWpRing;
  extern __shared__ int4 smem4[];
  __shared__ int div24[64];
  const int warps = blockDim.x / 32;
  int4* tree = smem4;  // [nodes] (kTree)
  // [warps][kRing][kWpWords]: value, true error, NN, 4 sub-errors, unused
  Word* ring = (Word*)(smem4 + (kMode == kTree ? nodes : 0));
  int* con = (int*)(ring + warps * kRing * kWpWords);
  int* stage = (int*)((char*)ring + ring_bytes(warps, kRing, kWpWords));
  if (kMode == kTree)
    for (int i = threadIdx.x; i < nodes; i += blockDim.x) tree[i] = tree_global[i];
  for (int i = threadIdx.x; i < warps * kRing * kWpWords; i += blockDim.x) ring[i] = ~0ull;
  for (int i = threadIdx.x; i < warps; i += blockDim.x) con[i] = first_con(i, W);
  for (int i = threadIdx.x; i < 64; i += blockDim.x) div24[i] = 0x1000000 / (i + 1);
  const int plane_cidx = kMode == kTree ? cidx[blockIdx.x] : 0;
  const int4 root = kMode == kTree ? tree_global[0] : make_int4(0, 0, 0, 0);
  const int plane_sidx = kMode == kTree ? sidx[blockIdx.x] : 0;
  unsigned risky = 0;  // the OR of every |error|: 2^24 or more flags the plane
  __syncthreads();

  const size_t plane = (size_t)H * W;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bands = (H + 31) / 32;
  for (int band = warp; band < bands; band += warps) {
    Link link(band, bands, warps, W);
    const int y = band * 32 + lane;
    const bool row_ok = y < H;
    const size_t at = blockIdx.x * plane + (size_t)band * 32 * W;
    const int rows = imin(32, H - band * 32);
    const Stage<kChunk, 2> io{stage + warp * 32 * kChunk * (kMode == kCodes ? 5 : 3), res + at,
                              kMode == kCodes ? codes + at : nullptr, out + at, rows, W, lane};
    const bool has_n = y > 0, has_nn = y > 1;
    WpLane st;

    // steps -1 .. 2 * (rows - 1) + W - 1: at step -1 lane 0 takes column 0
    // of the band above, the NE it reads ahead of its first pixel
    walk_band<kChunk, 2, kMode == kCodes>(io, -1, 2 * (rows - 1) + W - 1, [&](int s0,
                                          int (&rb)[kChunk], const int (&cb)[kChunk]) {
      link.wait_out<kRing>(imin(s0 + kChunk - 1 - 62, W - 1), con);
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const int s = s0 + j, x = s - 2 * lane;
        // the row above's step s-1: lane i-1's, and for lane 0 the band
        // above's last row at column s + 1 (0 where there is none); every
        // lane reads the same words, so a wait is the warp's
        const Up mine = st.mine();
        Up u;
        u.v = __shfl_up_sync(kFull, mine.v, 1);
        u.te = __shfl_up_sync(kFull, mine.te, 1);
        u.nn = __shfl_up_sync(kFull, mine.nn, 1);
        u.e.x = __shfl_up_sync(kFull, mine.e.x, 1);
        u.e.y = __shfl_up_sync(kFull, mine.e.y, 1);
        u.e.z = __shfl_up_sync(kFull, mine.e.z, 1);
        u.e.w = __shfl_up_sync(kFull, mine.e.w, 1);
        const bool need = link.up && s + 1 < W;
        const Word* slot = ring + link.in_slot<kRing>(s + 1) * kWpWords;
        const int q = link.base_c + s + 1;
        Word w[7];
        auto stale = [&] {
          int diff = 0;
#pragma unroll
          for (int i = 0; i < 7; ++i) diff |= seq_of(w[i]) ^ q;
          return diff != 0;
        };
#pragma unroll
        for (int i = 0; i < 7; ++i) w[i] = load_word(slot + i);
        if (need && stale()) {
          do {
            pause();
#pragma unroll
            for (int i = 0; i < 7; ++i) w[i] = load_word(slot + i);
          } while (stale());
        }
        if (lane == 0)
          u = need ? Up{value_of(w[0]), value_of(w[1]), value_of(w[2]),
                        make_int4(value_of(w[3]), value_of(w[4]), value_of(w[5]),
                                  value_of(w[6]))}
                   : Up{0, 0, 0, make_int4(0, 0, 0, 0)};
        st.push_above(u);

        const bool active = row_ok && x >= 0 && x < W;
        int v, t;
        int4 e;
        {
          const bool has_w = x > 0, x_gt1 = x > 1;
          const bool has_ne = has_n && x + 1 < W, has_wn = has_w && has_n;
          Nb b;
          const int n_val = has_n ? st.un2 : 0;
          b.pw = has_w ? st.v1 : n_val;
          b.pn = has_n ? n_val : b.pw;
          b.pnw = has_wn ? st.un3 : b.pw;
          b.pne = has_ne ? st.un1 : b.pn;
          b.pnn = has_nn ? st.nn : b.pn;
          b.pww = x_gt1 ? st.v2 : b.pw;
          b.pnww = x_gt1 && has_n ? st.un4 : b.pww;
          b.tew = has_w ? st.te1 : 0;
          b.ten = has_n ? st.ute2 : 0;
          b.tenw = has_wn ? st.ute3 : b.ten;
          b.tene = has_ne ? st.ute1 : b.ten;
          const int4 z = make_int4(0, 0, 0, 0);
          const int4 ew = has_w ? st.ea1 : z;
          const int4 en = has_n ? st.uea2 : z;
          const int4 enw = has_wn ? st.uea3 : en;
          const int4 ene = has_ne ? st.uea1 : en;
          const int4 eww = x_gt1 ? st.ea2 : z;
          const int4 ew2 = x + 1 < W ? z : ew;  // j40.h:4037's right edge

          // the sub-predictions (wp.py:72-89)
          int pr[4];
          pr[0] = mul(sub(add(b.pw, b.pne), b.pn), 8);
          pr[1] = sub(mul(b.pn, 8), mul(add(add(b.tew, b.ten), b.tene), P.p1) >> 5);
          pr[2] = sub(mul(b.pw, 8), mul(add(add(b.tew, b.ten), b.tenw), P.p2) >> 5);
          const int s3sum = add(add(add(add(mul(b.tenw, P.p3[0]), mul(b.ten, P.p3[1])),
                                        mul(b.tene, P.p3[2])),
                                    mul(mul(sub(b.pnn, b.pn), 8), P.p3[3])),
                                mul(mul(sub(b.pnw, b.pw), 8), P.p3[4]));
          pr[3] = sub(mul(b.pn, 8), s3sum >> 5);

          // the error-weighted blend (wp.py:91-103); the table indices are
          // clamped as the plain version's are, for flagged lanes
          // the errors of step s-1 (W's, NE's) enter last: the chain
          // runs through them, the other three are summed off it
          const int es[4] = {
              add(add(add(add(add(en.x, enw.x), eww.x), ew2.x), ew.x), ene.x),
              add(add(add(add(add(en.y, enw.y), eww.y), ew2.y), ew.y), ene.y),
              add(add(add(add(add(en.z, enw.z), eww.z), ew2.z), ew.z), ene.z),
              add(add(add(add(add(en.w, enw.w), eww.w), ew2.w), ew.w), ene.w)};
          int wk[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int shift = imax(ilog2(add(es[k], 1)) - 5, 0);
            wk[k] = add(4, mul(P.w[k], div24[clampi(es[k] >> shift, 0, 63)]) >> shift);
          }
          const int logw = ilog2(add(add(wk[0], wk[1]), add(wk[2], wk[3]))) - 4;
#pragma unroll
          for (int k = 0; k < 4; ++k) wk[k] >>= logw;
          // sums as trees, two levels deep
          const int wsum = add(add(wk[0], wk[1]), add(wk[2], wk[3]));
          const int sum = add(add(mul(pr[0], wk[0]), mul(pr[1], wk[1])),
                              add(mul(pr[2], wk[2]), mul(pr[3], wk[3])));
          int pred4 = (int)(((long long)sub(add(sum, wsum >> 1), 1) *
                             (long long)div24[clampi(sub(wsum, 1), 0, 63)]) >> 24);
          if (((b.ten ^ b.tew) | (b.ten ^ b.tenw)) <= 0)  // the clamp rule
            pred4 = clampi(pred4, mul(imin(imin(b.pw, b.pn), b.pne), 8),
                           mul(imax(imax(b.pw, b.pn), b.pne), 8));
          b.wppred = add(pred4, 3) >> 3;

          if (kMode == kTree) {
            // the in-step MA tree walk (j40.h:4177-4218): value > node.value
            // goes left; the leaf's multiplier and offset apply to the raw
            // residual, in int64, truncated to int32
            const Props props(b, plane_cidx, plane_sidx, y, x);
            int4 nd = root;
            for (int i = 0; i < depth && nd.x >= 0; ++i)
              nd = tree[pick16(props.v, nd.x) > nd.y ? nd.z : nd.w];
            v = (int)(unsigned long long)((unsigned long long)(long long)rb[j] *
                                              (unsigned long long)(long long)nd.w +
                                          (unsigned long long)(long long)nd.z +
                                          (unsigned long long)(long long)branch(nd.y, b));
          } else {
            v = add(rb[j], kMode == kCodes ? branch(cb[j], b) : b.wppred);
          }

          // after_predict (wp.py:109-115) and the overflow sentinel
          const int v8 = mul(v, 8);
          e = make_int4(add(iabs(sub(pr[0], v8)), 3) >> 3, add(iabs(sub(pr[1], v8)), 3) >> 3,
                        add(iabs(sub(pr[2], v8)), 3) >> 3, add(iabs(sub(pr[3], v8)), 3) >> 3);
          t = sub(pred4, v8);
        }
        // the state stays 0 outside the plane, as the plain version's
        if (!active) v = t = 0, e = make_int4(0, 0, 0, 0);
        risky |= (unsigned)iabs(e.x) | (unsigned)iabs(e.y) | (unsigned)iabs(e.z) |
                 (unsigned)iabs(e.w) | (unsigned)iabs(t);
        st.v2 = st.v1;
        st.v1 = v;
        st.te1 = t;
        st.ea2 = st.ea1;
        st.ea1 = e;
        rb[j] = v;

        // lane 31 hands column s - 62 of its row to the band below
        const int c = s - 62;
        if (link.down && lane == 31 && c >= 0 && c < W) {
          Word* slot = ring + link.out_slot<kRing>(c) * kWpWords;
          const Up m = st.mine();
          const int q = link.base_p + c;
          store_word(slot, m.v, q);
          store_word(slot + 1, m.te, q);
          store_word(slot + 2, m.nn, q);
          store_word(slot + 3, m.e.x, q);
          store_word(slot + 4, m.e.y, q);
          store_word(slot + 5, m.e.z, q);
          store_word(slot + 6, m.e.w, q);
        }
      }
      // the columns up to s0 + kChunk of the row above are read and used
      if (link.up && lane == 0) store_count(con + link.rc, link.base_c + imin(s0 + kChunk + 1, W));
    });
  }
  const int any = __syncthreads_or(risky >= (1u << 24));
  if (threadIdx.x == 0) ovf[blockIdx.x] = any ? 1 : 0;
}

int threads_for(int H, int most) {
  const int t = (H + 31) / 32 * 32;
  return t < most ? t : most;
}

// a plane the kernel takes: more bands than warps only up to the width
// that cannot deadlock
bool fits(int H, int W, int threads, int k, int look, int ring, int chunk) {
  if (H < 1 || W < 1 || (long long)H * W >= (1LL << 31)) return false;
  const int warps = threads / 32;
  return (H + 31) / 32 <= warps || W <= tall_width_limit(k, look, warps, ring, chunk);
}

template <typename K>
int allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

}  // namespace

extern "C" {

// W1: (L, H, W) int32 residuals to values, with per-pixel codes (L, H, W)
// int32 when `codes` is not null.
int j40tt_wavefront(const int* res, const int* codes, int* out, int L, int H, int W,
                    cudaStream_t stream) {
  const int threads = threads_for(H, codes ? kMaxThreadsCodes : kMaxThreads);
  if (!fits(H, W, threads, 1, 0, kPlainRing, kPlainChunk)) return (int)cudaErrorInvalidValue;
  const size_t smem = ring_bytes(threads / 32, kPlainRing, 1) +
                      stage_bytes(threads / 32, kPlainChunk, codes != nullptr);
  int rc;
  if (codes) {
    if ((rc = allow_smem(plain_wavefront_kernel<true>, smem))) return rc;
    plain_wavefront_kernel<true><<<L, threads, smem, stream>>>(res, codes, out, H, W);
  } else {
    if ((rc = allow_smem(plain_wavefront_kernel<false>, smem))) return rc;
    plain_wavefront_kernel<false><<<L, threads, smem, stream>>>(res, codes, out, H, W);
  }
  return (int)cudaGetLastError();
}

// W2/W3: the WP wavefront; `params` 11 int32 in host memory (p1, p2,
// p3[5], w[4]).  With `tree` (nodes x 4 int32: branches (property, value,
// left, right), leaves (-1, predictor, offset, multiplier)) the tree walk
// picks each pixel's predictor, offset and multiplier (`cidx` and `sidx`
// (L,) int32 the planes' channel and stream indices); else `codes` (L, H,
// W) int32 picks the predictor, or every pixel takes WP when it is null.
// ovf: (L,) uint8, 1 where a plane's error state left the exactness
// envelope.
int j40tt_wavefront_wp(const int* res, const int* codes, const int* tree, int nodes,
                       int depth, const int* cidx, const int* sidx, const int* params,
                       int* out, uint8_t* ovf, int L, int H, int W, cudaStream_t stream) {
  const int threads = threads_for(H, kWpMaxThreads);
  if (!fits(H, W, threads, 2, 1, kWpRing, kWpChunk) ||
      (tree && (nodes < 1 || nodes > kMaxTreeNodes)))
    return (int)cudaErrorInvalidValue;
  WpParams P;
  P.p1 = params[0];
  P.p2 = params[1];
  for (int k = 0; k < 5; ++k) P.p3[k] = params[2 + k];
  for (int k = 0; k < 4; ++k) P.w[k] = params[7 + k];
  const size_t smem = ring_bytes(threads / 32, kWpRing, kWpWords) +
                      stage_bytes(threads / 32, kWpChunk, codes != nullptr && !tree) +
                      (tree ? (size_t)nodes * 16 : 0);
  const int4* t = (const int4*)tree;
  int rc;
  if (tree) {
    if ((rc = allow_smem(wp_wavefront_kernel<kTree>, smem))) return rc;
    wp_wavefront_kernel<kTree><<<L, threads, smem, stream>>>(
        res, codes, t, nodes, depth, cidx, sidx, P, out, ovf, H, W);
  } else if (codes) {
    if ((rc = allow_smem(wp_wavefront_kernel<kCodes>, smem))) return rc;
    wp_wavefront_kernel<kCodes><<<L, threads, smem, stream>>>(
        res, codes, t, 0, 0, cidx, sidx, P, out, ovf, H, W);
  } else {
    if ((rc = allow_smem(wp_wavefront_kernel<kWpOnly>, smem))) return rc;
    wp_wavefront_kernel<kWpOnly><<<L, threads, smem, stream>>>(
        res, codes, t, 0, 0, cidx, sidx, P, out, ovf, H, W);
  }
  return (int)cudaGetLastError();
}

// The limits the wrappers check before a launch, read once by
// ops/wavefront_kernels.py: out[11] = rows a CTA (W1, W1 with codes, W2),
// the widest plane taller than a CTA of each (tall_width_limit), W1's
// chunk and ring, W2's chunk and ring, and W3's most tree nodes.
int j40tt_wavefront_limits(int* out) {
  const int v[11] = {kMaxThreads,
                     kMaxThreadsCodes,
                     kWpMaxThreads,
                     tall_width_limit(1, 0, kMaxThreads / 32, kPlainRing, kPlainChunk),
                     tall_width_limit(1, 0, kMaxThreadsCodes / 32, kPlainRing, kPlainChunk),
                     tall_width_limit(2, 1, kWpMaxThreads / 32, kWpRing, kWpChunk),
                     kPlainChunk,
                     kPlainRing,
                     kWpChunk,
                     kWpRing,
                     kMaxTreeNodes};
  for (int k = 0; k < 11; ++k) out[k] = v[k];
  return 0;
}

}  // extern "C"
