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
// Design: one CTA per lane plane, one thread per row (rows t, t + blockDim,
// ... when H > 1024 in W1, H > 512 in W2).  Pixel (y, x) lies on diagonal
// d = k*y + x (k = 1 for W1, 2 for W2), and every pixel it reads lies on an
// earlier diagonal, so a CTA walks the D diagonals in order with one
// __syncthreads each, and the rows of a diagonal run in parallel.  Each row publishes its value
// (and for W2 its 4 sub-predictor errors and its true error) at diagonal d
// to slot d mod depth of a ring in shared memory, where the rows below
// read it:
// - W1 reads diagonals d-1 (W, N) and d-2 (NW): a 3-deep ring;
// - W2 reads d-1 (W, NE), d-2 (N, WW), d-3 (NW) and d-4 (NN, and NWW for
//   the tree): a 5-deep ring, so the slot written at d is never one that
//   is read at d and one barrier a diagonal suffices.
// A row's own W and WW come from the ring too, so that any number of rows
// a thread runs the same code.  Slots of pixels outside the plane hold 0.
// Residuals (and codes) are read straight from (L, H, W) at (y, d - k*y)
// and the values written straight there: no skew or unskew gather.
//
// What bounds it: the chain of D diagonals, each a barrier, a few loads
// from shared memory and the step's dependent arithmetic (~40 operations
// for W1, ~200 for W2, more for a deep tree walk).  The bytes (a plane in,
// a plane out) would take microseconds; the kernel takes D times the
// latency of one step.  A 256x256 plane has 511 diagonals in W1 and 766 in
// W2.  The ring takes 12 B a row (W1) or 120 B a row (W2) of shared memory,
// so a CTA holds planes up to kMaxRowsPlain (19,285) or kMaxRowsWp (1,928)
// rows; a Modular group is at most 1024 rows, and the entry points refuse
// a taller plane (the wrappers raise first).  A tree too large for the
// shared memory the ring leaves is read from global memory, so that no
// tree leaves the kernel.

#include <cuda_runtime.h>
#include <stdint.h>

// The WP parameters of a Modular sub-header (modular/wp.py WPParams);
// layout shared with ops/wavefront_kernels.py (11 int32 in host memory).
struct J40ttWpParams {
  int p1, p2, p3[5], w[4];
};

namespace {

constexpr int kMaxThreads = 1024;  // W1's CTA: one thread a row up to 1024 rows
// W2's CTA: up to 512 rows a CTA, so that the step keeps 128 registers a
// thread (at 1024 threads it would have 64, and the blend and the tree
// walk would spill); a taller plane gives each thread 2 or more rows
constexpr int kWpMaxThreads = 512;
constexpr int kPlainDepth = 3;  // W1's ring: diagonals d-2..d
constexpr int kWpDepth = 5;     // W2's ring: diagonals d-4..d
constexpr int kPlainRowBytes = kPlainDepth * 4;
constexpr int kWpRowBytes = kWpDepth * (16 + 4 + 4);  // errors, value, true error
// the dynamic shared memory a CTA may take: sm_90's 227 KB a block, less
// 1 KB for W2's static div24 table (ops/wavefront_kernels.py: SMEM_CAP)
constexpr int kSmemCap = 227 * 1024 - 1024;
constexpr int kMaxRowsPlain = kSmemCap / kPlainRowBytes;
constexpr int kMaxRowsWp = kSmemCap / kWpRowBytes;

enum Mode { kWpOnly = 0, kCodes = 1, kTree = 2 };

// One node of a flattened MA tree, as device_modular flattens it: a
// branch (prop, value, left, right) or a leaf (prop < 0) with its
// predictor, offset and multiplier; 7 int64 (ops/wavefront_kernels.py).
struct Node {
  long long prop, value, left, right, pred, off, mult;
};

using WpParams = J40ttWpParams;

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

// ------------------------------------------------------------------- W1

// Predictors 0/1/2/5 on the y + x wavefront (_plain_wavefront): kCodes
// reads a per-pixel code (0: zero, 1: W, 2: N, anything else: gradient),
// else every pixel takes the gradient.
template <bool kCodes>
__global__ void __launch_bounds__(kMaxThreads)
plain_wavefront_kernel(const int* __restrict__ res, const int* __restrict__ codes,
                       int* __restrict__ out, int H, int W) {
  extern __shared__ int4 smem4[];
  const size_t plane = (size_t)H * W;
  const int* r = res + blockIdx.x * plane;
  const int* pc = kCodes ? codes + blockIdx.x * plane : nullptr;
  int* o = out + blockIdx.x * plane;
  int* ring = (int*)smem4;
  for (int i = threadIdx.x; i < kPlainDepth * H; i += blockDim.x) ring[i] = 0;
  __syncthreads();
  const int D = H + W - 1;
  for (int d = 0; d < D; ++d) {
    int* cur = ring + (d % 3) * H;
    const int* d1 = ring + ((d + 2) % 3) * H;  // diagonal d-1
    const int* d2 = ring + ((d + 1) % 3) * H;  // diagonal d-2
    for (int y = threadIdx.x; y < H; y += blockDim.x) {
      const int x = d - y;
      int v = 0;
      if (x >= 0 && x < W) {
        const size_t at = (size_t)y * W + x;
        const int rv = r[at];
        const int code = kCodes ? pc[at] : 5;
        const bool has_w = x > 0, has_n = y > 0;
        // the edge chain: W falls back to N at x = 0 (0 at the origin),
        // N to W, NW to W
        const int n1 = has_n ? d1[y - 1] : 0;
        const int w_ = has_w ? d1[y] : n1;
        const int n_ = has_n ? n1 : w_;
        const int nw = has_w && has_n ? d2[y - 1] : w_;
        const int pred = code == 0 ? 0 : code == 1 ? w_ : code == 2 ? n_ : grad(w_, n_, nw);
        v = add(pred, rv);
        o[at] = v;
      }
      cur[y] = v;
    }
    __syncthreads();
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

// the prediction of code c (0-12; anything else gives 0): _branches/_select
__device__ __forceinline__ int branch(long long c, const Nb& b) {
  switch (c) {
    case 0: return 0;
    case 1: return b.pw;
    case 2: return b.pn;
    case 3: return half_sum(b.pw, b.pn);
    case 4: return iabs(sub(b.pn, b.pnw)) < iabs(sub(b.pw, b.pnw)) ? b.pw : b.pn;
    case 5: return grad(b.pw, b.pn, b.pnw);
    case 6: return b.wppred;
    case 7: return b.pne;
    case 8: return b.pnw;
    case 9: return b.pww;
    case 10: return half_sum(b.pw, b.pnw);
    case 11: return half_sum(b.pn, b.pnw);
    case 12: return half_sum(b.pn, b.pne);
    default: return 0;
  }
}

// MA-tree property p (0-15) of the pixel (_tree_wp_reconstruct's props)
__device__ __forceinline__ int property(int p, const Nb& b, int cidx, int sidx, int y,
                                        int x) {
  switch (p) {
    case 0: return cidx;
    case 1: return sidx;
    case 2: return y;
    case 3: return x;
    case 4: return iabs(b.pn);
    case 5: return iabs(b.pw);
    case 6: return b.pn;
    case 7: return b.pw;
    case 8: return x > 0 ? sub(b.pw, sub(add(b.pww, b.pnw), b.pnww)) : b.pw;
    case 9: return sub(add(b.pw, b.pn), b.pnw);
    case 10: return sub(b.pw, b.pnw);
    case 11: return sub(b.pnw, b.pn);
    case 12: return sub(b.pn, b.pne);
    case 13: return sub(b.pn, b.pnn);
    case 14: return sub(b.pw, b.pww);
    default: {  // 15: the magnitude-max true error, W first on ties
      int v = b.tew;
      v = iabs(v) < iabs(b.ten) ? b.ten : v;
      v = iabs(v) < iabs(b.tenw) ? b.tenw : v;
      return iabs(v) < iabs(b.tene) ? b.tene : v;
    }
  }
}

template <int kMode>
__global__ void __launch_bounds__(kWpMaxThreads)
wp_wavefront_kernel(const int* __restrict__ res, const int* __restrict__ codes,
                    const Node* tree_global, int nodes, int depth, int tree_shared,
                    int cidx, const int* __restrict__ sidx, WpParams P,
                    int* __restrict__ out, uint8_t* __restrict__ ovf, int H, int W) {
  extern __shared__ int4 smem4[];
  __shared__ int div24[64];
  char* smem = (char*)smem4;
  const size_t plane = (size_t)H * W;
  const int* r = res + blockIdx.x * plane;
  const int* pc = kMode == kCodes ? codes + blockIdx.x * plane : nullptr;
  int* o = out + blockIdx.x * plane;
  const Node* tree = tree_global;
  size_t tree_bytes = 0;
  if (kMode == kTree && tree_shared) {
    Node* t = (Node*)smem;
    for (int i = threadIdx.x; i < nodes; i += blockDim.x) t[i] = tree_global[i];
    tree = t;
    tree_bytes = ((size_t)nodes * sizeof(Node) + 15) & ~(size_t)15;
  }
  char* base = smem + tree_bytes;
  int4* ea = (int4*)base;                         // [kWpDepth][H] sub-errors
  int* val = (int*)(base + (size_t)16 * kWpDepth * H);  // [kWpDepth][H]
  int* te = val + kWpDepth * H;                   // [kWpDepth][H] true errors
  for (int i = threadIdx.x; i < kWpDepth * H; i += blockDim.x) {
    ea[i] = make_int4(0, 0, 0, 0);
    val[i] = te[i] = 0;
  }
  for (int i = threadIdx.x; i < 64; i += blockDim.x) div24[i] = 0x1000000 / (i + 1);
  const int lane_sidx = kMode == kTree ? sidx[blockIdx.x] : 0;
  bool risky = false;
  __syncthreads();

  const int D = 2 * H + W - 2;
  for (int d = 0; d < D; ++d) {
    // ring slots of diagonals d, d-1, ..., d-4
    const int s0 = d % kWpDepth, s1 = (d + 4) % kWpDepth, s2 = (d + 3) % kWpDepth,
              s3 = (d + 2) % kWpDepth, s4 = (d + 1) % kWpDepth;
    for (int y = threadIdx.x; y < H; y += blockDim.x) {
      const int x = d - 2 * y;
      const int now = s0 * H + y;
      if (x < 0 || x >= W) {
        ea[now] = make_int4(0, 0, 0, 0);
        val[now] = te[now] = 0;
        continue;
      }
      const size_t at = (size_t)y * W + x;
      const int rv = r[at];
      const long long code = kMode == kCodes ? pc[at] : 6;
      const bool has_w = x > 0, has_n = y > 0, has_nn = y > 1, x_gt1 = x > 1;
      const bool has_ne = has_n && x + 1 < W, has_wn = has_w && has_n;
      const int up = y - 1;

      Nb b;
      const int n_val = has_n ? val[s2 * H + up] : 0;
      b.pw = has_w ? val[s1 * H + y] : n_val;
      b.pn = has_n ? n_val : b.pw;
      b.pnw = has_wn ? val[s3 * H + up] : b.pw;
      b.pne = has_ne ? val[s1 * H + up] : b.pn;
      b.pnn = has_nn ? val[s4 * H + y - 2] : b.pn;
      b.pww = x_gt1 ? val[s2 * H + y] : b.pw;
      b.pnww = x_gt1 && has_n ? val[s4 * H + up] : b.pww;
      b.tew = has_w ? te[s1 * H + y] : 0;
      b.ten = has_n ? te[s2 * H + up] : 0;
      b.tenw = has_wn ? te[s3 * H + up] : b.ten;
      b.tene = has_ne ? te[s1 * H + up] : b.ten;
      const int4 z = make_int4(0, 0, 0, 0);
      const int4 ew = has_w ? ea[s1 * H + y] : z;
      const int4 en = has_n ? ea[s2 * H + up] : z;
      const int4 enw = has_wn ? ea[s3 * H + up] : en;
      const int4 ene = has_ne ? ea[s1 * H + up] : en;
      const int4 eww = x_gt1 ? ea[s2 * H + y] : z;
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
      const int es[4] = {
          add(add(add(add(add(en.x, ew.x), enw.x), eww.x), ene.x), ew2.x),
          add(add(add(add(add(en.y, ew.y), enw.y), eww.y), ene.y), ew2.y),
          add(add(add(add(add(en.z, ew.z), enw.z), eww.z), ene.z), ew2.z),
          add(add(add(add(add(en.w, ew.w), enw.w), eww.w), ene.w), ew2.w)};
      int wk[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int shift = imax(ilog2(add(es[k], 1)) - 5, 0);
        wk[k] = add(4, mul(P.w[k], div24[clampi(es[k] >> shift, 0, 63)]) >> shift);
      }
      const int logw = ilog2(add(add(add(wk[0], wk[1]), wk[2]), wk[3])) - 4;
      int wsum = 0, s = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        wk[k] >>= logw;
        wsum = add(wsum, wk[k]);
        s = add(s, mul(pr[k], wk[k]));
      }
      int pred4 = (int)(((long long)sub(add(s, wsum >> 1), 1) *
                         (long long)div24[clampi(sub(wsum, 1), 0, 63)]) >> 24);
      if (((b.ten ^ b.tew) | (b.ten ^ b.tenw)) <= 0)  // the clamp rule
        pred4 = clampi(pred4, mul(imin(imin(b.pw, b.pn), b.pne), 8),
                       mul(imax(imax(b.pw, b.pn), b.pne), 8));
      b.wppred = add(pred4, 3) >> 3;

      int v;
      if (kMode == kTree) {
        // the in-step MA tree walk (j40.h:4177-4218): value > node.value
        // goes left; the leaf's multiplier and offset apply to the raw
        // residual, in int64, truncated to int32
        int node = 0;
        for (int i = 0; i < depth; ++i) {
          const Node& nd = tree[node];
          if (nd.prop < 0) break;
          const long long pv = property((int)nd.prop, b, cidx, lane_sidx, y, x);
          node = (int)(pv > nd.value ? nd.left : nd.right);
        }
        const Node& leaf = tree[node];
        v = (int)(unsigned long long)((unsigned long long)(long long)rv *
                                          (unsigned long long)leaf.mult +
                                      (unsigned long long)leaf.off +
                                      (unsigned long long)(long long)branch(leaf.pred, b));
      } else {
        v = add(rv, kMode == kCodes ? branch(code, b) : b.wppred);
      }

      // after_predict (wp.py:109-115) and the overflow sentinel
      const int v8 = mul(v, 8);
      const int4 e = make_int4(add(iabs(sub(pr[0], v8)), 3) >> 3,
                               add(iabs(sub(pr[1], v8)), 3) >> 3,
                               add(iabs(sub(pr[2], v8)), 3) >> 3,
                               add(iabs(sub(pr[3], v8)), 3) >> 3);
      const int t = sub(pred4, v8);
      risky |= iabs(e.x) >= (1 << 24) || iabs(e.y) >= (1 << 24) ||
               iabs(e.z) >= (1 << 24) || iabs(e.w) >= (1 << 24) ||
               iabs(t) >= (1 << 24);
      ea[now] = e;
      val[now] = v;
      te[now] = t;
      o[at] = v;
    }
    __syncthreads();
  }
  const int any = __syncthreads_or(risky);
  if (threadIdx.x == 0) ovf[blockIdx.x] = any ? 1 : 0;
}

int threads_for(int H, int most) {
  const int t = (H + 31) / 32 * 32;
  return t < most ? t : most;
}

// the bytes of a tree in shared memory: all of it when it fits beside the
// ring, else none (the kernel reads it from global memory)
size_t tree_smem(int nodes, size_t ring_bytes) {
  const size_t tree = ((size_t)nodes * sizeof(Node) + 15) & ~(size_t)15;
  return tree <= kSmemCap - ring_bytes ? tree : 0;
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
// int32 when `codes` is not null.  H at most kMaxRowsPlain.
int j40tt_wavefront(const int* res, const int* codes, int* out, int L, int H, int W,
                    cudaStream_t stream) {
  if (H > kMaxRowsPlain) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kPlainRowBytes * H;
  const int threads = threads_for(H, kMaxThreads);
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
// p3[5], w[4]).  With `tree` (nodes x 7 int64) the tree walk picks each
// pixel's predictor, offset and multiplier (cidx the channel index, sidx
// (L,) int32 the lanes' stream indices); else `codes` (L, H, W) int32
// picks the predictor, or every pixel takes WP when it is null.  ovf: (L,)
// uint8, 1 where a lane's error state left the exactness envelope.  H at
// most kMaxRowsWp.
int j40tt_wavefront_wp(const int* res, const int* codes, const long long* tree,
                       int nodes, int depth, int cidx, const int* sidx,
                       const int* params, int* out, uint8_t* ovf, int L, int H, int W,
                       cudaStream_t stream) {
  if (H > kMaxRowsWp) return (int)cudaErrorInvalidValue;
  WpParams P;
  P.p1 = params[0];
  P.p2 = params[1];
  for (int k = 0; k < 5; ++k) P.p3[k] = params[2 + k];
  for (int k = 0; k < 4; ++k) P.w[k] = params[7 + k];
  const size_t ring = (size_t)kWpRowBytes * H;
  const size_t tree_bytes = tree ? tree_smem(nodes, ring) : 0;
  const size_t smem = ring + tree_bytes;
  const Node* t = (const Node*)tree;
  const int shared_tree = tree_bytes > 0;
  const int threads = threads_for(H, kWpMaxThreads);
  int rc;
  if (tree) {
    if ((rc = allow_smem(wp_wavefront_kernel<kTree>, smem))) return rc;
    wp_wavefront_kernel<kTree><<<L, threads, smem, stream>>>(
        res, codes, t, nodes, depth, shared_tree, cidx, sidx, P, out, ovf, H, W);
  } else if (codes) {
    if ((rc = allow_smem(wp_wavefront_kernel<kCodes>, smem))) return rc;
    wp_wavefront_kernel<kCodes><<<L, threads, smem, stream>>>(
        res, codes, t, 0, 0, 0, cidx, sidx, P, out, ovf, H, W);
  } else {
    if ((rc = allow_smem(wp_wavefront_kernel<kWpOnly>, smem))) return rc;
    wp_wavefront_kernel<kWpOnly><<<L, threads, smem, stream>>>(
        res, codes, t, 0, 0, 0, cidx, sidx, P, out, ovf, H, W);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
