// Hand-written Hopper (sm_90a) kernels of the VarDCT reconstruction.
//
// They replace the three Pallas TPU kernels of j40_tpu/ops/pallas_kernels.py
// that carry the single-stream decode path:
//
//   j40tt_reconstruct_dct8_srgb  <- _srgb_kernel (reconstruct_dct8_srgb_pallas)
//   j40tt_reconstruct_dct8       <- _kernel      (reconstruct_dct8_pallas)
//   j40tt_xyb_to_srgb            <- _xyb_kernel  (xyb_to_srgb_pallas)
//
// Built with nvcc into a library with a plain C interface and bound with
// ctypes (j40_tpu_torch/ops/_build.py, ops/kernels.py).  Every entry point
// launches on the caller's stream, allocates nothing and returns
// cudaGetLastError(), which the Python wrapper turns into an exception.
//
// Numerics: everything is fp32 on the CUDA cores.  No TF32, bf16 or wgmma:
// at ~6 operations a byte the tensor cores would buy nothing, and a 10-bit
// mantissa in the IDCT sums costs more than 16 gray levels (the JAX package
// pins Precision.HIGHEST for that reason).  No --use_fast_math: divisions
// stay IEEE.  Where the kernels round differently from the plain versions
// (each moves a value by an ulp or a few, well inside the bars of one gray
// level and 1e-4):
// - dequant multiplies by the weight table's reciprocals (IEEE, once a
//   CTA) where the plain version divides by the weights;
// - the colour stage's gamma is ex2(lg2(v) / 2.4) on the SFU (~1e-6
//   relative, at most 0.005 of a level at 12 bits): powf took ~60
//   instructions a channel and set the pace of B1 and B3;
// - 255/intensity_target is folded into the opsin matrix, and maxval into
//   the gamma's and the linear segment's constants.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // threads a CTA of the pointwise kernel

// consts22 layout (j40_tpu_torch/ops/combine.py::_pack_consts22):
// [0] 65536/global_scale, [1] qm_x, [2] qm_b, [3..5] quant_bias,
// [6] quant_bias_num, [7] pad, [8..16] opsin_inv (row-major 3x3),
// [17..19] opsin_bias, [20] 255/intensity_target, [21] (1<<bpp)-1
struct Colour {
  float inv[9];        // opsin_inv times 255/intensity_target
  float bias[3];
  float cbrt_bias[3];
  float lin;           // maxval * 12.92
  float gam_a, gam_b;  // maxval * 1.055, 0.5 - maxval * 0.055
};

__device__ __forceinline__ Colour load_colour(const float* __restrict__ c22) {
  Colour c;
#pragma unroll
  for (int k = 0; k < 9; ++k) c.inv[k] = c22[8 + k] * c22[20];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    c.bias[d] = c22[17 + d];
    c.cbrt_bias[d] = cbrtf(c.bias[d]);
  }
  const float maxval = c22[21];
  c.lin = maxval * 12.92f;
  c.gam_a = maxval * 1.055f;
  c.gam_b = 0.5f - maxval * 0.055f;
  return c;
}

// v^(1/2.4) on the SFU, ex2(lg2(v) / 2.4), as __powf computes it but
// without its subnormal handling: the colour stage takes it only for
// v > 0.0031308, whose power lies above 2^-9 (for v <= 0 it gives NaN,
// which the stage's select drops)
__device__ __forceinline__ float gamma_pow(float v) {
#ifdef __CUDA_ARCH__
  float l, r;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(l) : "f"(v));
  l *= (float)(1.0 / 2.4);
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(l));
  return r;
#else
  return powf(v, (float)(1.0 / 2.4));
#endif
}

// XYB -> linear sRGB -> gamma -> maxval * srgb + 0.5, the value whose
// int cast the reference takes (j40.h:7208-7241); the one colour stage
// shared by the fused DCT8 kernel and the pointwise kernel, as
// _xyb_to_srgb_block is shared by the two Pallas kernels.
__device__ __forceinline__ void xyb_to_srgb(float X, float Y, float B,
                                            const Colour& c, float out[3]) {
  const float p[3] = {Y + X, Y - X, B};
  float mixed[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float pp = p[d] - c.cbrt_bias[d];
    mixed[d] = pp * pp * pp + c.bias[d];
  }
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float v = mixed[0] * c.inv[ch * 3] + mixed[1] * c.inv[ch * 3 + 1] +
                    mixed[2] * c.inv[ch * 3 + 2];
    out[ch] = v <= 0.0031308f
                  ? fmaf(c.lin, v, 0.5f)
                  : fmaf(c.gam_a, gamma_pow(v), c.gam_b);
  }
}

// clamp((int)t, 0, 255) without the conversion unit: the clamped value
// rounded down onto 1.5 * 2^23, whose low mantissa bits are then floor(t)
__device__ __forceinline__ uint32_t to_u8(float t) {
  return __float_as_uint(__fadd_rd(fminf(fmaxf(t, 0.0f), 255.0f), 12582912.0f)) & 0xFFu;
}

enum Mode { kXyb = 0, kSrgbU8 = 1, kSrgbI32 = 2 };

// ---- B1/B2: fused dequant + CfL + LLF + separable 8x8 IDCT (+ colour) ----
//
// Replaces _srgb_kernel (B1, modes kSrgbU8/kSrgbI32) and _kernel (B2, mode
// kXyb) of j40_tpu/ops/pallas_kernels.py.
//
// Bound: per block and channel 64 coefficients of 4 bytes in, 64 samples
// out (1 byte for u8, 4 otherwise), against the separable IDCT's 2*8^3
// multiply-adds, ~10 operations a coefficient for dequant and CfL and (B1)
// ~50 a pixel for the colour stage: about 6 fp32 operations a byte for B2,
// below the H100's fp32 ridge (67 TFLOP/s over 3.35 TB/s = 20 op/B), so
// memory bytes bound B2.  B1 moves 4x fewer output bytes, and on the card
// instruction issue bounds it, not bytes: dequant (an IEEE division a
// coefficient), the colour stage (three lg2/ex2 pairs a pixel on the SFU),
// the IDCT passes, the copies and the barriers share its time (PERF.md
// §6, "How B1 and B2 got there").
//
// Design.  A CTA tile is a strip of up to kStrip blocks of one block row
// (the right edge masked for ragged w8), so that the strip's 8 raster rows
// are contiguous in each plane.  A persistent grid (as many CTAs as the
// card holds at once, at most one a strip) walks the strips; each CTA has
// two stages of shared memory, and while it works on one strip, 16-byte
// cp.async copies bring the next into the other.  Thread (bl, r) of the 8
// per block:
//   pass 1  loads canonical row r (coefficients 8r..8r+7, the column
//           frequency r; ops/reconstruct.py::idct2d_batch transposes
//           square blocks) of each channel, dequantizes it (times the
//           weight table's reciprocals, computed once a CTA into shared
//           memory), applies CfL and the LLF, and runs the 8-point IDCT
//           over the row frequency: u[r][y] = sum_i G[y][i] C[r][i],
//           written back in place;
//   pass 2  reads column y of u and runs the second 8-point IDCT,
//           out[y][x] = sum_j G[x][j] u[j][y] (the plain version's
//           association, Gr @ c @ Gc^T), a pixel's 3 channels at a
//           time, then (B1) the colour stage; the 8 samples of each
//           channel go to a staging row.
// Then the strip's 24 raster rows (3 planes x 8) leave as whole rows,
// 16 bytes a thread.  The basis G is a kernel parameter: it lives in the
// constant bank and every multiply-add takes it as an operand.  The
// chunk swizzle below keeps both passes' shared loads free of bank
// conflicts.  2*8^3 multiply-adds a block and channel (the dense 64x64
// product of the design before took 4x that, and each of its threads read
// its own row of the operator from device memory).
constexpr int kStrip = 16;             // blocks per CTA tile (one block row)
constexpr int kDctThreads = 8 * kStrip;
constexpr int kStageFloats = 3 * kStrip * 64 + 6 * kStrip;  // coeffs + aux
constexpr int kRecipFloats = 3 * 64;    // the weight table's reciprocals
constexpr int kRowF = 8 * kStrip + 4;   // staging row, 4-byte samples
constexpr int kRowB = 8 * kStrip + 16;  // staging row, u8 samples

struct Basis {
  float g[64];  // inverse_matrix(8), row-major: G[y][i]
};

// Physical 16-byte chunk, within a block's 64 floats, of half h of
// canonical row j.  Pass 1 (a quarter warp: one block, rows 0..7, one
// half) and pass 2 (a warp: 4 blocks x 8 columns, one row) both touch 8
// distinct chunks modulo 8, so neither has bank conflicts.
__device__ __forceinline__ int swz(int bl, int j, int h) {
  return 2 * (j ^ (bl & 3)) + (h ^ (j >> 2));
}

__device__ __forceinline__ void copy16_async(float* dst, const float* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
#else
  for (int k = 0; k < 4; ++k) dst[k] = src[k];
#endif
}

__device__ __forceinline__ void copy4_async(float* dst, const float* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
#else
  *dst = *src;
#endif
}

__device__ __forceinline__ void commit_copies() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}

__device__ __forceinline__ void wait_all_copies() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::);
#endif
}

struct Strip {
  int by, bx0, nb;  // block row, first block column, blocks (<= kStrip)
};

__device__ __forceinline__ Strip strip_of(int tile, int spr, int w8) {
  Strip s;
  s.by = tile / spr;
  s.bx0 = (tile - s.by * spr) * kStrip;
  s.nb = min(kStrip, w8 - s.bx0);
  return s;
}

// Start the copies of strip `tile` (if there is one) into `stage`.
__device__ __forceinline__ void load_strip(float* stage, int tile, int ntiles, int spr,
                                           const float* __restrict__ coeffs,
                                           const float* __restrict__ aux, int n,
                                           int w8) {
  if (tile < ntiles) {
    const Strip s = strip_of(tile, spr, w8);
    const int b0 = s.by * w8 + s.bx0;
    const int t = threadIdx.x;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float* src = coeffs + ((size_t)c * n + b0) * 64;
      float* dst = stage + c * kStrip * 64;
      for (int e = t; e < s.nb * 16; e += kDctThreads) {
        const int bl = e >> 4, k = e & 15;
        copy16_async(dst + bl * 64 + 4 * swz(bl, k >> 1, k & 1), src + 4 * e);
      }
    }
    if (t < 6 * kStrip) {
      const int r = t / kStrip, bl = t % kStrip;
      if (bl < s.nb)
        copy4_async(stage + 3 * kStrip * 64 + t, aux + (size_t)r * n + b0 + bl);
    }
    commit_copies();
  }
}

template <int kMode>
__global__ void __launch_bounds__(kDctThreads, 512 / kDctThreads)
    dct8_kernel(const float* __restrict__ coeffs,   // (3, n, 64)
                const float* __restrict__ aux,      // (6, n)
                const float* __restrict__ weights,  // (64, 3)
                const Basis G,                      // the 8-point basis
                const float* __restrict__ consts,   // (8,) or (22,)
                void* __restrict__ out,             // (3, 8*h8, 8*w8)
                int n, int h8, int w8) {
  extern __shared__ float4 smem_v[];  // 16-byte aligned
  float* smem = reinterpret_cast<float*>(smem_v);
  float* staging = smem + 2 * kStageFloats;
  float* recip = staging + (kMode == kSrgbU8 ? 24 * kRowB / 4 : 24 * kRowF);

  const int t = threadIdx.x;
  const int bl = t >> 3, r = t & 7;
  const int spr = (w8 + kStrip - 1) / kStrip;  // strips per block row
  const int ntiles = h8 * spr;
  const int tile0 = blockIdx.x;
  load_strip(smem, tile0, ntiles, spr, coeffs, aux, n, w8);

  // the weight table as reciprocals, [c][i][r] for coefficient 8r+i: the
  // 8 rows of a pass-1 load are 8 neighbouring words (the first
  // __syncthreads of the loop publishes them)
  for (int k = t; k < kRecipFloats; k += kDctThreads) {
    const int c = k >> 6, i = (k >> 3) & 7, rr = k & 7;
    recip[k] = 1.0f / weights[(8 * rr + i) * 3 + c];
  }
  const float gs_inv = consts[0];
  const float qm[3] = {consts[1], 1.0f, consts[2]};
  const float qb[3] = {consts[3], consts[4], consts[5]};
  const float qbnum = consts[6];
  Colour col{};
  if constexpr (kMode != kXyb) col = load_colour(consts);

  const int W = 8 * w8;
  const size_t plane = (size_t)8 * h8 * W;

  for (int it = 0, tile = tile0; tile < ntiles; ++it, tile += gridDim.x) {
    float* cs = smem + (it & 1) * kStageFloats;
    const float* as = cs + 3 * kStrip * 64;
    const Strip s = strip_of(tile, spr, w8);
    wait_all_copies();
    __syncthreads();  // the strip is in; the last strip's stores have read staging
    // the next strip's copies run under this strip's arithmetic
    load_strip(smem + ((it + 1) & 1) * kStageFloats, tile + gridDim.x, ntiles, spr,
               coeffs, aux, n, w8);

    if (bl < s.nb) {  // pass 1: canonical row r of each channel
      const float hf = as[3 * kStrip + bl];
      float v[3][8];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float* blk = cs + (c * kStrip + bl) * 64;
        const float4 lo = *reinterpret_cast<const float4*>(blk + 4 * swz(bl, r, 0));
        const float4 hi = *reinterpret_cast<const float4*>(blk + 4 * swz(bl, r, 1));
        const float q[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
        const float mult = (gs_inv * qm[c]) * hf;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          // zero cells (the big-block cells of a mixed group's dense grid)
          // take the small branch and give exactly 0, never 0/0
          const float adj =
              fabsf(q[i]) <= 1.0f ? q[i] * qb[c] : q[i] - qbnum / q[i];
          v[c][i] = adj * mult * recip[(c * 8 + i) * 8 + r];
        }
      }
      const float kx = as[4 * kStrip + bl], kb = as[5 * kStrip + bl];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        v[0][i] = v[0][i] + v[1][i] * kx;
        v[2][i] = v[2][i] + v[1][i] * kb;
      }
      if (r == 0) {  // LLF at canonical position 0
#pragma unroll
        for (int c = 0; c < 3; ++c) v[c][0] = as[c * kStrip + bl];
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float u[8];
#pragma unroll
        for (int y = 0; y < 8; ++y) {
          float acc = G.g[8 * y] * v[c][0];
#pragma unroll
          for (int i = 1; i < 8; ++i) acc = fmaf(G.g[8 * y + i], v[c][i], acc);
          u[y] = acc;
        }
        float* blk = cs + (c * kStrip + bl) * 64;
        *reinterpret_cast<float4*>(blk + 4 * swz(bl, r, 0)) =
            make_float4(u[0], u[1], u[2], u[3]);
        *reinterpret_cast<float4*>(blk + 4 * swz(bl, r, 1)) =
            make_float4(u[4], u[5], u[6], u[7]);
      }
    }
    __syncthreads();

    if (bl < s.nb) {  // pass 2: sample row y = r of each channel
      const int y = r;
      float u[3][8];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float* blk = cs + (c * kStrip + bl) * 64 + (y & 3);
#pragma unroll
        for (int j = 0; j < 8; ++j) u[c][j] = blk[4 * swz(bl, j, y >> 2)];
      }
      // a pixel's 3 channels at a time, so that the colour stage needs no
      // second set of 24 samples in registers
      float o[3][8];
      uint32_t packed[3][2] = {};
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        float px[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          float acc = G.g[8 * x] * u[c][0];
#pragma unroll
          for (int j = 1; j < 8; ++j) acc = fmaf(G.g[8 * x + j], u[c][j], acc);
          px[c] = acc;
        }
        if constexpr (kMode == kXyb) {
#pragma unroll
          for (int c = 0; c < 3; ++c) o[c][x] = px[c];
        } else {
          float q[3];
          xyb_to_srgb(px[0], px[1], px[2], col, q);
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            if constexpr (kMode == kSrgbU8)
              packed[c][x >> 2] |= to_u8(q[c]) << (8 * (x & 3));
            else
              o[c][x] = __int_as_float((int)q[c]);  // toward zero, as the reference
          }
        }
      }
      if constexpr (kMode == kSrgbU8) {
        uint8_t* st = reinterpret_cast<uint8_t*>(staging);
#pragma unroll
        for (int c = 0; c < 3; ++c)
          *reinterpret_cast<uint2*>(st + (c * 8 + y) * kRowB + 8 * bl) =
              make_uint2(packed[c][0], packed[c][1]);
      } else {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          float* row = staging + (c * 8 + y) * kRowF + 8 * bl;
          *reinterpret_cast<float4*>(row) = make_float4(o[c][0], o[c][1], o[c][2], o[c][3]);
          *reinterpret_cast<float4*>(row + 4) =
              make_float4(o[c][4], o[c][5], o[c][6], o[c][7]);
        }
      }
    }
    __syncthreads();  // staging complete; this stage is free

    // the strip's 24 raster rows, whole, 16 bytes a thread (8 for u8 rows
    // when w8 is odd: such rows start 8 bytes off a 16-byte boundary)
    const size_t row0 = (size_t)s.by * 8 * W + (size_t)s.bx0 * 8;
    if constexpr (kMode == kSrgbU8) {
      const uint8_t* st = reinterpret_cast<const uint8_t*>(staging);
      uint8_t* dst = static_cast<uint8_t*>(out);
      if (!(w8 & 1)) {  // then nb is even too
        for (int e = t; e < 24 * (kStrip / 2); e += kDctThreads) {
          const int row = e / (kStrip / 2), k = e % (kStrip / 2);
          if (2 * k < s.nb)
            *reinterpret_cast<uint4*>(dst + (row >> 3) * plane + row0 +
                                      (size_t)(row & 7) * W + 16 * k) =
                *reinterpret_cast<const uint4*>(st + row * kRowB + 16 * k);
        }
      } else {
        for (int e = t; e < 24 * kStrip; e += kDctThreads) {
          const int row = e / kStrip, k = e % kStrip;
          if (k < s.nb)
            *reinterpret_cast<uint2*>(dst + (row >> 3) * plane + row0 +
                                      (size_t)(row & 7) * W + 8 * k) =
                *reinterpret_cast<const uint2*>(st + row * kRowB + 8 * k);
        }
      }
    } else {
      float* dst = static_cast<float*>(out);  // int32 samples move as bits
      for (int e = t; e < 24 * 2 * kStrip; e += kDctThreads) {
        const int row = e / (2 * kStrip), k = e % (2 * kStrip);
        if (k < 2 * s.nb)
          *reinterpret_cast<float4*>(dst + (row >> 3) * plane + row0 +
                                     (size_t)(row & 7) * W + 4 * k) =
              *reinterpret_cast<const float4*>(staging + row * kRowF + 4 * k);
      }
    }
  }
}

constexpr size_t dct8_smem(int mode) {
  return sizeof(float) * (2 * kStageFloats + kRecipFloats) +
         (mode == kSrgbU8 ? (size_t)24 * kRowB : sizeof(float) * 24 * kRowF);
}

// The persistent grid: as many CTAs as fit on the card at once (the
// occupancy of this instantiation's registers and shared memory), at most
// one a strip.
template <int kMode>
int launch_dct8(const float* coeffs, const float* aux, const float* weights,
                const float* basis, const float* consts, void* out, int n, int h8,
                int w8, cudaStream_t stream) {
  // the opt-in above 48 KB and the CTAs an SM holds, once per instantiation
  static int per_sm = 0;
  static const cudaError_t setup = [] {
    cudaError_t e = cudaFuncSetAttribute(dct8_kernel<kMode>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)dct8_smem(kMode));
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dct8_kernel<kMode>,
                                                        kDctThreads, dct8_smem(kMode));
    return e;
  }();
  if (setup != cudaSuccess) return (int)setup;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int strips = h8 * ((w8 + kStrip - 1) / kStrip);
  const int grid = max(1, min(strips, max(1, per_sm) * sms));
  Basis G;
  for (int k = 0; k < 64; ++k) G.g[k] = basis[k];
  dct8_kernel<kMode><<<grid, kDctThreads, dct8_smem(kMode), stream>>>(
      coeffs, aux, weights, G, consts, out, n, h8, w8);
  return (int)cudaGetLastError();
}

// Pointwise XYB -> sRGB over (3, H, W) raster planes.
//
// Bound: 12 bytes read and 3 (u8) or 12 (int32) written per pixel against
// some 60 fp32 operations (three gamma powers), about 4 per byte: below the H100's
// fp32 ridge of 20, so memory bytes bound it.  Design: a grid-stride loop,
// one pixel per thread per step, neighbouring threads on neighbouring
// pixels, so every load and store is coalesced.  The Pallas kernel's
// VMEM-sized stripe height has no counterpart.
template <bool kU8>
__global__ void __launch_bounds__(kThreads)
    xyb_kernel(const float* __restrict__ planes,  // (3, npix)
               const float* __restrict__ consts,  // (22,)
               void* __restrict__ out,            // (3, npix)
               long long npix) {
  const Colour col = load_colour(consts);
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       p < npix; p += step) {
    float s[3];
    xyb_to_srgb(planes[p], planes[npix + p], planes[2 * npix + p], col, s);
    if constexpr (kU8) {
      uint8_t* dst = static_cast<uint8_t*>(out);
      dst[p] = (uint8_t)to_u8(s[0]);
      dst[npix + p] = (uint8_t)to_u8(s[1]);
      dst[2 * npix + p] = (uint8_t)to_u8(s[2]);
    } else {
      int* dst = static_cast<int*>(out);
      // the int cast truncates toward zero, as the reference's does
      dst[p] = (int)s[0];
      dst[npix + p] = (int)s[1];
      dst[2 * npix + p] = (int)s[2];
    }
  }
}

}  // namespace

extern "C" {

// `basis`: the 8x8 inverse DCT basis G in host memory (taken by value)
int j40tt_reconstruct_dct8(const float* coeffs, const float* aux,
                           const float* weights, const float* basis,
                           const float* consts, float* out, int n, int h8,
                           int w8, cudaStream_t stream) {
  return launch_dct8<kXyb>(coeffs, aux, weights, basis, consts, out, n, h8, w8,
                           stream);
}

int j40tt_reconstruct_dct8_srgb(const float* coeffs, const float* aux,
                                const float* weights, const float* basis,
                                const float* consts, void* out, int n, int h8,
                                int w8, int to_u8, cudaStream_t stream) {
  return to_u8 ? launch_dct8<kSrgbU8>(coeffs, aux, weights, basis, consts, out, n,
                                      h8, w8, stream)
               : launch_dct8<kSrgbI32>(coeffs, aux, weights, basis, consts, out, n,
                                       h8, w8, stream);
}

int j40tt_xyb_to_srgb(const float* planes, const float* consts, void* out,
                      long long npix, int to_u8, int grid,
                      cudaStream_t stream) {
  if (to_u8)
    xyb_kernel<true><<<grid, kThreads, 0, stream>>>(planes, consts, out, npix);
  else
    xyb_kernel<false><<<grid, kThreads, 0, stream>>>(planes, consts, out, npix);
  return (int)cudaGetLastError();
}

const char* j40tt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
