// Hand-written Hopper (sm_90a) kernel of the inverse Squeeze merge (S1).
//
// It replaces the device program of j40_tpu/parallel/sharded_lossless.py
// that merges one (down, residual) channel pair: _inv_squeeze_h_scan (def
// at :61), a jax.lax.scan over the output column pairs (:91) inside the
// jax.jit program of _device_finish_fn (the steps at :124-144), which runs
// the vertical merges as the scan of the transposes (no pl.pallas_call):
//
//   j40tt_unsqueeze  <- _inv_squeeze_h_scan, horizontal merges on row
//                       shards and vertical ones on column shards   (S1)
//
// Same conventions as reconstruct.cu, and built into the same library
// (j40_tpu_torch/ops/_build.py): a plain C interface bound with ctypes
// (ops/squeeze_kernels.py); the entry point launches on the caller's
// stream, allocates nothing and returns cudaGetLastError().
//
// Semantics: bit for bit those of the plain version in
// ops/squeeze_kernels.py (_inv_squeeze_h_scan), which is spec H.6.2 with
// SmoothTendency (H.6.1) in PyTorch's int32 arithmetic: every sum or
// product that can wrap is done in uint32 and cast back, as signed
// overflow is undefined in C++ (as in wavefront.cu), and `/` truncates
// toward zero as torch.div(rounding_mode="trunc") does.
//
// The merge: a chain (a row of a horizontal merge, a column of a vertical
// one) of wd `down` and wr residual samples, wd = wr or wr + 1, becomes
// wd + wr samples.  Pair x reads down[x] (avg), down[x + 1] (next, clamped
// to the last sample when x + 1 == wd) and residu[x], and the sample the
// pair before it wrote last (`left`, which starts at down[0]); it writes
// 2x and 2x + 1.  An odd chain ends with down's last sample.
//
// What bounds it: the chain of wr dependent steps on `left` (~120 ns each
// on an H100 when walked one after another), not the bytes ((2 wd + 2 wr)
// * 4 a chain, microseconds in all) nor the arithmetic.  So the design
// cuts the chain.  A warp walks a window of 32 segments of L pairs (L = 8
// when the window holds the chain, else 16 and a window after another), a
// lane a segment:
// - Why a segment can start before its input is known: one pair maps
//   `left` monotonically.  SmoothTendency T(B, a, n) is non-decreasing in
//   B (each clamp is a min or a max) and lies in [min(0, 2(a - n)),
//   max(0, 2(a - n))]; the new left, avg + diff / 2 - diff with diff =
//   residu + T, is non-increasing in diff.  (tests/test_torch_squeeze_
//   design.py checks both exhaustively on a small range.)
// - So a lane starts two walks, pair x - 1's second sample with T at each
//   end of its range; the true walk stays between them (the two swap
//   sides each pair), and from the first pair c at which they are equal
//   every output is exact and is kept.  The window's first lane starts
//   from the exact `left`.
// - Resolve and re-walk: a lane whose walks met hands its exit to the
//   next lane; each lane walks its first c pairs again from its true
//   input.  A lane whose walks never met (a slope -1 ramp) walks in full
//   once its input is known, in rounds, in lane order: about as slow as
//   one chain walked pair after pair.
// - The wrap margin: the argument holds where no int32 sum wraps.  With
//   every down and residu sample within M = 2^26 and the `left` entering
//   the window within 4M: |T| <= 2|a - n| <= 4M, |diff| <= 5M, so every
//   left either walk carries is within M + 5M/2 < 4M (by induction), and
//   SmoothTendency's largest term, 4B - 3n - a +- 6, stays within 20M + 6
//   < 2^31; so do the two ends.  The lanes check their samples as they
//   read them; a window of a chain outside the margin has no lane that
//   meets, so all its lanes walk in full, in order, with wrap, exactly as
//   the plain version does.
// On lossless_sq's merges the two walks meet after ~2 pairs (8 at most),
// so a merge costs about L paired steps, the longest re-walk, the loads
// and stores of the window and a launch.
// Layout: a warp's window is staged through padded shared memory by
// cp.async (lane s's down slots at stride L + 3, its residu at L + 1, its
// outputs at 2L + 1: odd strides, so the 32 lanes' reads of one step fall
// in distinct banks), then stored back.
// - Vertical merges (unsqueeze_cols_kernel): a CTA of 4 neighbouring
//   columns, a warp a column; the window is staged and stored 8 rows of
//   the 4 columns (eight 16-byte runs) an instruction.  Both kernels' CTAs
//   stay under 48 KB of shared memory, so no launch needs the opt-in (an
//   attribute of the device that is current when it is set).  On an H100 a
//   CTA of 8 columns (70,784 B at L = 16) was 4.6-4.9% slower on the
//   widest vertical merge and on a shard's 44 merges (PERF.md, S1).
// - Horizontal merges (unsqueeze_rows_kernel): a warp a row, 4 a CTA;
//   32 consecutive samples of the row an instruction.
// Both take any strides (the column shards of a sharded merge are views
// of the whole plane: nothing is copied); the output is contiguous.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// segments a window (a warp's lanes); the sample margin and the margin of
// the `left` that enters a window (header); the warps a CTA of the row
// kernel (a row each) and of the column kernel (a column each)
constexpr int kLanes = 32;
constexpr int kMargin = 1 << 26, kCarryMargin = 4 * kMargin;
constexpr int kRowWarps = 4, kColWarps = 4;

// One warp's window in shared memory: lane s's down slots (positions sL - 1
// .. sL + L), residu slots (sL - 1 .. sL + L - 1) and outputs (2L), each
// at an odd stride; warps' regions 32 / kColWarps words apart modulo 32
// banks, so that the column kernel's kColWarps columns x 32 / kColWarps
// slots a staging instruction do not collide
template <int L>
struct Window {
  static constexpr int kD = L + 3, kR = L + 1, kO = 2 * L + 1;
  static constexpr int kDown = 0, kRes = kLanes * kD, kOut = kRes + kLanes * kR;
  static constexpr int kWords = kOut + kLanes * kO + 32 / kColWarps;  // + the warps' stagger
  static constexpr int kPairs = kLanes * L;
  static_assert(kWords * 4 * (kRowWarps > kColWarps ? kRowWarps : kColWarps) <= 48 * 1024,
                "a CTA's shared memory must not need the opt-in above 48 KB");
};

// the segment length of a merge of wr pairs: 8 when one window holds the
// chain, else 16 (tools/squeeze_model.seg_len).  On an H100
// this beats 16 alone by 1.30x on all of a shard's merges of lossless_sq
// and 8 alone by 1.08-1.13x on its widest (tools/torch_kernel_ab.py's
// unsqueeze_shard1, unsqueeze_h and unsqueeze_v)
inline int seg_len(int wr) { return wr <= kLanes * 8 ? 8 : 16; }

// PyTorch's int32 arithmetic: two's-complement wrap
__device__ __forceinline__ int add(int a, int b) { return (int)((unsigned)a + (unsigned)b); }
__device__ __forceinline__ int sub(int a, int b) { return (int)((unsigned)a - (unsigned)b); }
__device__ __forceinline__ int mul(int a, int b) { return (int)((unsigned)a * (unsigned)b); }

__device__ __forceinline__ bool in_margin(int v, int m) { return v >= -m && v <= m; }

// SmoothTendency (spec H.6.1) of the left neighbour B, this pair's average
// a and the next average n: squeeze_kernels._smooth_tendency, branch-free
__device__ __forceinline__ int smooth_tendency(int B, int a, int n) {
  const bool inc = B >= a && a >= n;
  const bool dec = B <= a && a <= n && !inc;
  const int t = sub(mul(4, B), add(mul(3, n), a));
  const int ba2 = mul(2, sub(B, a));
  const int an2 = mul(2, sub(a, n));
  int di = add(t, 6) / 12;
  di = sub(di, di & 1) > ba2 ? add(ba2, 1) : di;
  di = add(di, di & 1) > an2 ? an2 : di;
  int dd = sub(t, 6) / 12;
  dd = add(dd, dd & 1) < ba2 ? sub(ba2, 1) : dd;
  dd = sub(dd, dd & 1) < an2 ? an2 : dd;
  return inc ? di : dec ? dd : 0;
}

// A pair's second sample given its diff (residual + tendency)
__device__ __forceinline__ int second(int avg, int diff) { return sub(add(avg, diff / 2), diff); }

// One pair: returns the first sample, leaves the second in `left`
__device__ __forceinline__ int merge_pair(int& left, int avg, int next, int res) {
  const int diff = add(res, smooth_tendency(left, avg, next));
  const int first = add(avg, diff / 2);
  left = sub(first, diff);
  return first;
}

// A 4-byte copy from device to shared memory that does not wait for the
// load, zero-filled when `ok` is false (cp.async, as in wavefront.cu)
__device__ __forceinline__ void copy4(int* dst, const int* src, bool ok) {
#ifdef __CUDA_ARCH__
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 4 : 0));
#else
  *dst = ok ? *src : 0;
#endif
}
__device__ __forceinline__ void wait_all_copies() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_all;\n" ::);
#endif
}

// Where a merge's samples lie: `cs` between chains, `ps` between positions
// along a chain (in elements)
struct Strides {
  long long cs, ps;
};

// The copies of one chain's window at pair x0 into its region, slots t0,
// t0 + step, ... (a warp: t0 = lane, step 32): down at x0 - 1 .. x0 + 32L
// (clamped to the last sample; zero before the chain), residu at x0 - 1 ..
// x0 + 32L - 1 (zero outside the chain).  `d` and `r` are the chain's
// first samples; a column past the merge (live false) stages zeros.
template <int L>
__device__ __forceinline__ void stage_window(int* region, int t0, int step, bool live,
                                             const int* d, long long dps, const int* r,
                                             long long rps, int x0, int wd, int wr) {
  using W = Window<L>;
  for (int t = t0; t < kLanes * (L + 2); t += step) {
    const int s = t / (L + 2), k = t - s * (L + 2);
    const int x = x0 + s * L + k - 1;
    const bool ok = live && x >= 0;
    copy4(&region[W::kDown + s * W::kD + k], ok ? d + (long long)min(x, wd - 1) * dps : d, ok);
  }
  for (int t = t0; t < kLanes * (L + 1); t += step) {  // slot t is lane t / (L + 1)'s
    const int s = t / (L + 1), k = t - s * (L + 1);
    const int x = x0 + s * L + k - 1;
    const bool ok = live && x >= 0 && x < wr;
    copy4(&region[W::kRes + t], ok ? r + (long long)x * rps : r, ok);
  }
}

// The output slot of window sample q (0 <= q < 2 * 32L)
template <int L>
__device__ __forceinline__ int out_slot(int q) {
  return Window<L>::kOut + q / (2 * L) * Window<L>::kO + q % (2 * L);
}

// One warp walks one chain's staged window of n pairs (1 <= n <= 32L),
// entered with the exact `carry`; writes the window's 2n outputs into the
// region and returns the exact `left` after its last pair (meaningful
// when n == 32L).  All 32 lanes call it.
template <int L>
__device__ int walk_window(int* region, int lane, int n, int carry) {
  using W = Window<L>;
  const unsigned all = 0xffffffffu;
  const int* d = region + W::kDown + lane * W::kD + 1;  // d[j], j = -1 .. L
  const int* r = region + W::kRes + lane * W::kR + 1;   // r[j], j = -1 .. L - 1
  int* o = region + W::kOut + lane * W::kO;
  const int cnt = min(max(n - lane * L, 0), L);  // this lane's pairs

  // the two ends: pair x - 1's second sample with T = min(0, 2(a - n))
  // (the high end) and T = max(0, 2(a - n)) (the low end)
  int a, b;
  bool ok;
  {
    const int avg = d[-1], nx = d[0], res = r[-1];
    ok = in_margin(avg, kMargin) & in_margin(nx, kMargin) & in_margin(res, kMargin);
    const int an2 = mul(2, sub(avg, nx));
    a = second(avg, add(res, min(0, an2)));
    b = second(avg, add(res, max(0, an2)));
  }
  if (lane == 0) a = b = carry;
  // both walks at once; c: the first pair whose two inputs are equal
  int c = L + 1;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const int avg = d[j], nx = d[j + 1], res = r[j];
    ok &= in_margin(nx, kMargin) & in_margin(res, kMargin);
    const bool eq = a == b;
    c = eq && c > L ? j : c;
    const int first = merge_pair(a, avg, nx, res);
    merge_pair(b, avg, nx, res);
    if (eq && j < cnt) {
      o[2 * j] = first;
      o[2 * j + 1] = a;
    }
  }
  c = a == b && c > L ? L : c;
  // a window outside the margin: no lane has met
  if (__any_sync(all, !ok) || !in_margin(carry, kCarryMargin)) c = L + 1;

  // resolve and re-walk, in rounds: a lane walks its first min(c, cnt)
  // pairs once its input is exact; a lane that had not met (c > L) walks
  // them all, and then its exit is exact too
  const bool met = c <= L;
  const int k = min(c, cnt);
  int exitv = a;
  unsigned exact = __ballot_sync(all, met);
  unsigned todo = __ballot_sync(all, cnt > 0);
  int up = __shfl_up_sync(all, exitv, 1);
  int in = lane == 0 ? carry : up;
  bool have = lane == 0 || ((exact >> (lane - 1)) & 1);
  while (todo) {
    const unsigned go = __ballot_sync(all, have) & todo;
    if ((go >> lane) & 1) {
      int left = in;
      for (int j = 0; j < k; ++j) {
        const int first = merge_pair(left, d[j], d[j + 1], r[j]);
        o[2 * j] = first;
        o[2 * j + 1] = left;
      }
      if (!met) exitv = left;
    }
    exact |= go;
    todo &= ~go;
    up = __shfl_up_sync(all, exitv, 1);
    if (!have && ((exact >> (lane - 1)) & 1)) {
      in = up;
      have = true;
    }
  }
  return __shfl_sync(all, exitv, kLanes - 1);
}

// ------------------------------------------------------------ vertical

// A CTA of kColWarps neighbouring columns, warp w walks column c0 + w.
// The staging and the stores go 32 / kColWarps rows of the kColWarps
// columns an instruction (thread i: slot row i / kColWarps, column i %
// kColWarps).  out is (wd + wr, chains), contiguous.
template <int L>
__global__ void __launch_bounds__(kColWarps * 32)
unsqueeze_cols_kernel(const int* __restrict__ down, Strides ds, const int* __restrict__ res,
                      Strides rs, int* __restrict__ out, int chains, int wd, int wr) {
  using W = Window<L>;
  extern __shared__ int smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c0 = blockIdx.x * kColWarps, col = c0 + warp;
  const int u = threadIdx.x / kColWarps, cw = threadIdx.x % kColWarps;
  const bool mine = c0 + cw < chains;  // the column this thread stages and stores
  const int* dcol = down + (mine ? (long long)(c0 + cw) * ds.cs : 0);
  const int* rcol = res + (mine ? (long long)(c0 + cw) * rs.cs : 0);
  int* creg = smem + cw * W::kWords;
  const long long os = chains;
  int carry = col < chains ? down[(long long)col * ds.cs] : 0;
  for (int x0 = 0; x0 < wr; x0 += W::kPairs) {
    const int n = min(W::kPairs, wr - x0);
    __syncthreads();  // the window before is stored
    stage_window<L>(creg, u, 32, mine, dcol, ds.ps, rcol, rs.ps, x0, wd, wr);
    wait_all_copies();
    __syncthreads();
    if (col < chains) carry = walk_window<L>(smem + warp * W::kWords, lane, n, carry);
    __syncthreads();
    if (mine)
      for (int q = u; q < 2 * n; q += 32)
        out[(long long)(2 * x0 + q) * os + c0 + cw] = creg[out_slot<L>(q)];
  }
  if (((wd + wr) & 1) && col < chains && lane == 0)
    out[(long long)(wd + wr - 1) * os + col] =
        down[(long long)col * ds.cs + (long long)(wd - 1) * ds.ps];
}

// ---------------------------------------------------------- horizontal

// A warp a row, kRowWarps rows a CTA; the warp stages and stores its row's
// window 32 consecutive samples an instruction.  out is (chains, wd + wr),
// contiguous.
template <int L>
__global__ void __launch_bounds__(kRowWarps * 32)
unsqueeze_rows_kernel(const int* __restrict__ down, Strides ds, const int* __restrict__ res,
                      Strides rs, int* __restrict__ out, int chains, int wd, int wr) {
  using W = Window<L>;
  extern __shared__ int smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowWarps + warp;
  if (row >= chains) return;  // the whole warp
  int* region = smem + warp * W::kWords;
  const int* d = down + (long long)row * ds.cs;
  const int* r = res + (long long)row * rs.cs;
  const int w = wd + wr;
  int* o = out + (long long)row * w;
  int carry = d[0];
  for (int x0 = 0; x0 < wr; x0 += W::kPairs) {
    const int n = min(W::kPairs, wr - x0);
    __syncwarp();  // the window before is stored
    stage_window<L>(region, lane, 32, true, d, ds.ps, r, rs.ps, x0, wd, wr);
    wait_all_copies();
    __syncwarp();
    carry = walk_window<L>(region, lane, n, carry);
    __syncwarp();
    for (int q = lane; q < 2 * n; q += 32) o[2 * x0 + q] = region[out_slot<L>(q)];
  }
  if ((w & 1) && lane == 0) o[w - 1] = d[(long long)(wd - 1) * ds.ps];
}

// One merge at segment length L
template <int L>
int launch(const int* down, Strides ds, const int* res, Strides rs, int* out, int chains,
           int wd, int wr, bool horizontal, cudaStream_t stream) {
  constexpr int row_smem = kRowWarps * Window<L>::kWords * 4;
  constexpr int col_smem = kColWarps * Window<L>::kWords * 4;
  if (horizontal)
    unsqueeze_rows_kernel<L><<<(chains + kRowWarps - 1) / kRowWarps, kRowWarps * 32, row_smem,
                               stream>>>(down, ds, res, rs, out, chains, wd, wr);
  else
    unsqueeze_cols_kernel<L><<<(chains + kColWarps - 1) / kColWarps, kColWarps * 32, col_smem,
                               stream>>>(down, ds, res, rs, out, chains, wd, wr);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// S1: one inverse Squeeze merge of int32 planes.  Horizontal: down (chains,
// wd), residu (chains, wr) -> out (chains, wd + wr); vertical: down (wd,
// chains), residu (wr, chains) -> out (wd + wr, chains).  d0, d1 and r0, r1
// are the inputs' strides along their dims 0 and 1 (elements, any values);
// out is contiguous.  Requires chains >= 1, wr >= 0 and wd = wr or wr + 1,
// wd >= 1.
int j40tt_unsqueeze(const int* down, long long d0, long long d1, const int* residu,
                    long long r0, long long r1, int* out, int chains, int wd, int wr,
                    int horizontal, cudaStream_t stream) {
  if (chains < 1 || wr < 0 || wd < 1 || (wd != wr && wd != wr + 1))
    return (int)cudaErrorInvalidValue;
  const Strides ds = horizontal ? Strides{d0, d1} : Strides{d1, d0};
  const Strides rs = horizontal ? Strides{r0, r1} : Strides{r1, r0};
  const bool h = horizontal != 0;
  return seg_len(wr) == 8 ? launch<8>(down, ds, residu, rs, out, chains, wd, wr, h, stream)
                          : launch<16>(down, ds, residu, rs, out, chains, wd, wr, h, stream);
}

}  // extern "C"
