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
// What bounds it: a chain of wr dependent steps (about 30 integer
// operations on `left` each); the bytes, (2 wd + 2 wr) * 4 a chain, would
// take a few microseconds.  A launch carries few chains (a 1024x1024
// image on 8 shards: 128 a shard), so the card is nearly idle and the
// time is wr times one step's latency plus what the loads add.  The design
// keeps the loads off the chain: one thread a chain, its inputs fetched a
// chunk ahead of its steps.
// - Vertical merges (unsqueeze_cols_kernel): a thread a column; the
//   threads of a warp are neighbouring columns, so a load or store of one
//   position is one coalesced 128-byte access.  Inputs come 8 steps ahead
//   into registers.
// - Horizontal merges (unsqueeze_rows_kernel): a warp a band of 32 rows.
//   A lane's own row would touch 32 rows, 32 sectors, an instruction, so
//   chunks of 32 column pairs are staged through the warp's shared memory:
//   cp.async copies of a row's 32 consecutive samples an instruction (the
//   next chunk's in flight while this one is walked), rows padded to 33
//   and 65 words so that the lanes' column reads and writes fall in
//   distinct banks, and the outputs stored back 32 consecutive samples an
//   instruction.
// Both take any strides (the column shards of a sharded merge are views
// of the whole plane: nothing is copied); the output is contiguous.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// pairs a register chunk of a column chain, threads a CTA of the column
// kernel; pairs a shared-memory chunk of a row band (one warp a CTA)
constexpr int kColChunk = 8, kColThreads = 128;
constexpr int kRowChunk = 32;
// the row band's padded strides in shared memory (words)
constexpr int kInStride = kRowChunk + 1, kOutStride = 2 * kRowChunk + 1;

// PyTorch's int32 arithmetic: two's-complement wrap
__device__ __forceinline__ int add(int a, int b) { return (int)((unsigned)a + (unsigned)b); }
__device__ __forceinline__ int sub(int a, int b) { return (int)((unsigned)a - (unsigned)b); }
__device__ __forceinline__ int mul(int a, int b) { return (int)((unsigned)a * (unsigned)b); }

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

// Where a merge's samples lie: `cs` between chains, `ps` between positions
// along a chain (in elements)
struct Strides {
  long long cs, ps;
};

// ------------------------------------------------------------ vertical

// A thread a chain (a column): the chain's pairs in register chunks of
// kColChunk, the next chunk's loads issued before this one is walked.  out
// is (wd + wr, chains), contiguous.
__global__ void __launch_bounds__(kColThreads)
unsqueeze_cols_kernel(const int* __restrict__ down, Strides ds, const int* __restrict__ res,
                      Strides rs, int* __restrict__ out, int chains, int wd, int wr) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= chains) return;
  const int* d = down + c * ds.cs;
  const int* r = res + c * rs.cs;
  int* o = out + c;
  const long long os = chains;
  constexpr int K = kColChunk;
  // chunk x0: down[x0 .. x0 + K] (the last one the next average of pair
  // x0 + K - 1; clamped to down's last sample) and residu[x0 .. x0 + K - 1]
  int av[K + 1], rv[K];
  auto fetch = [&](int x0, int (&a)[K + 1], int (&v)[K]) {
#pragma unroll
    for (int j = 0; j <= K; ++j) a[j] = d[(long long)min(x0 + j, wd - 1) * ds.ps];
#pragma unroll
    for (int j = 0; j < K; ++j) v[j] = x0 + j < wr ? r[(long long)(x0 + j) * rs.ps] : 0;
  };
  if (wr > 0) fetch(0, av, rv);
  int left = d[0];
  for (int x0 = 0; x0 < wr; x0 += K) {
    int na[K + 1], nv[K];
    fetch(x0 + K, na, nv);  // clamped, and zero past the chain's end
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int x = x0 + j;
      if (x < wr) {
        const int first = merge_pair(left, av[j], av[j + 1], rv[j]);
        o[2 * x * os] = first;
        o[(2 * x + 1) * os] = left;
      }
    }
#pragma unroll
    for (int j = 0; j <= K; ++j) av[j] = na[j];
#pragma unroll
    for (int j = 0; j < K; ++j) rv[j] = nv[j];
  }
  if ((wd + wr) & 1) o[(long long)(wd + wr - 1) * os] = d[(long long)(wd - 1) * ds.ps];
}

// ---------------------------------------------------------- horizontal

// A warp a band of 32 chains (rows), one lane a row, one warp a CTA.  Each
// chunk of kRowChunk pairs is staged in shared memory: buffer b holds the
// band's down[x0 .. x0 + 32] (33 words a row) and residu[x0 .. x0 + 31];
// the outputs of the chunk, 64 a row, go out through `stage`.  out is
// (chains, wd + wr), contiguous.
__global__ void __launch_bounds__(32)
unsqueeze_rows_kernel(const int* __restrict__ down, Strides ds, const int* __restrict__ res,
                      Strides rs, int* __restrict__ out, int chains, int wd, int wr) {
  __shared__ int dbuf[2][32 * kInStride];
  __shared__ int rbuf[2][32 * kInStride];
  __shared__ int stage[32 * kOutStride];
  const int lane = threadIdx.x;
  const int row0 = blockIdx.x * 32;
  const int rows = min(32, chains - row0);
  const int w = wd + wr;
  const int* d = down + row0 * ds.cs;
  const int* r = res + row0 * rs.cs;
  int* o = out + (long long)row0 * w;

  // the copies of chunk x0 into buffer b: row i's 32 samples by
  // instruction i (lane = column), then each lane's row's 33rd down sample
  auto fetch = [&](int x0, int b) {
#pragma unroll 8
    for (int i = 0; i < 32; ++i) {
      const int x = x0 + lane;
      const bool okd = i < rows && x < wd, okr = i < rows && x < wr;
      copy4(&dbuf[b][i * kInStride + lane], d + (okd ? i * ds.cs + x * ds.ps : 0), okd);
      copy4(&rbuf[b][i * kInStride + lane], r + (okr ? i * rs.cs + x * rs.ps : 0), okr);
    }
    const int x = x0 + kRowChunk;
    const bool ok = lane < rows && x < wd;
    copy4(&dbuf[b][lane * kInStride + kRowChunk], d + (ok ? lane * ds.cs + x * ds.ps : 0), ok);
    commit_copies();
  };

  int left = 0;
  if (wr > 0) fetch(0, 0);
  for (int x0 = 0, b = 0; x0 < wr; x0 += kRowChunk, b ^= 1) {
    __syncwarp();  // every lane is done with buffer b ^ 1 and with `stage`
    fetch(x0 + kRowChunk, b ^ 1);  // zero-filled past the chain's end
    wait_copies_but_last();
    __syncwarp();  // every lane's copies of chunk x0 have landed
    const int* dv = &dbuf[b][lane * kInStride];
    const int* rv = &rbuf[b][lane * kInStride];
    if (x0 == 0) left = dv[0];
    const int n = min(kRowChunk, wr - x0);
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const int avg = dv[j];
      const int next = x0 + j + 1 < wd ? dv[j + 1] : avg;
      stage[lane * kOutStride + 2 * j] = merge_pair(left, avg, next, rv[j]);
      stage[lane * kOutStride + 2 * j + 1] = left;
    }
    __syncwarp();
    // row i's 2n outputs, 32 consecutive samples an instruction
#pragma unroll 4
    for (int i = 0; i < 64; ++i) {
      const int row = i >> 1, col = (i & 1) * 32 + lane;
      if (row < rows && col < 2 * n)
        o[(long long)row * w + 2 * x0 + col] = stage[row * kOutStride + col];
    }
  }
  wait_all_copies();
  if ((w & 1) && lane < rows)
    o[(long long)lane * w + w - 1] = d[lane * ds.cs + (long long)(wd - 1) * ds.ps];
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
  if (horizontal) {
    const Strides ds{d0, d1}, rs{r0, r1};
    unsqueeze_rows_kernel<<<(chains + 31) / 32, 32, 0, stream>>>(down, ds, residu, rs, out,
                                                                 chains, wd, wr);
  } else {
    const Strides ds{d1, d0}, rs{r1, r0};
    unsqueeze_cols_kernel<<<(chains + kColThreads - 1) / kColThreads, kColThreads, 0,
                            stream>>>(down, ds, residu, rs, out, chains, wd, wr);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
