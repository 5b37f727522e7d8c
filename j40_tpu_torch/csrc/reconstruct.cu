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
// a 10-bit mantissa in the 64-term IDCT sums costs more than 16 gray levels
// (the JAX package pins Precision.HIGHEST for that reason).  The colour
// stage uses cbrtf/powf, within one gray level of the exp/log form of the
// Pallas kernel.  No --use_fast_math: divisions stay IEEE.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileBlocks = 16;  // 8x8 blocks per CTA tile
constexpr int kThreads = 256;    // 4 groups of 64: thread t owns sample t%64

// consts22 layout (j40_tpu_torch/ops/combine.py::_pack_consts22):
// [0] 65536/global_scale, [1] qm_x, [2] qm_b, [3..5] quant_bias,
// [6] quant_bias_num, [7] pad, [8..16] opsin_inv (row-major 3x3),
// [17..19] opsin_bias, [20] 255/intensity_target, [21] (1<<bpp)-1
struct Colour {
  float inv[9];
  float bias[3];
  float cbrt_bias[3];
  float itscale;
  float maxval;
};

__device__ __forceinline__ Colour load_colour(const float* __restrict__ c22) {
  Colour c;
#pragma unroll
  for (int k = 0; k < 9; ++k) c.inv[k] = c22[8 + k];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    c.bias[d] = c22[17 + d];
    c.cbrt_bias[d] = cbrtf(c.bias[d]);
  }
  c.itscale = c22[20];
  c.maxval = c22[21];
  return c;
}

// XYB -> linear sRGB -> gamma -> quantized int (j40.h:7208-7241); the one
// colour stage shared by the fused DCT8 kernel and the pointwise kernel, as
// _xyb_to_srgb_block is shared by the two Pallas kernels.
__device__ __forceinline__ void xyb_to_srgb(float X, float Y, float B,
                                            const Colour& c, int out[3]) {
  const float p[3] = {Y + X, Y - X, B};
  float mixed[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float pp = p[d] - c.cbrt_bias[d];
    mixed[d] = (pp * pp * pp + c.bias[d]) * c.itscale;
  }
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float v = mixed[0] * c.inv[ch * 3] + mixed[1] * c.inv[ch * 3 + 1] +
                    mixed[2] * c.inv[ch * 3 + 2];
    const float srgb =
        v <= 0.0031308f
            ? 12.92f * v
            : 1.055f * powf(fmaxf(v, 1e-30f), (float)(1.0 / 2.4)) - 0.055f;
    // the int cast truncates toward zero, as the reference's does
    out[ch] = (int)(c.maxval * srgb + 0.5f);
  }
}

__device__ __forceinline__ uint8_t clamp_u8(int v) {
  return (uint8_t)min(max(v, 0), 255);
}

enum Mode { kXyb = 0, kSrgbU8 = 1, kSrgbI32 = 2 };

// Fused dequant + chroma-from-luma + LLF + 8x8 IDCT (+ colour stage) over
// a plane of DCT8 blocks, written straight into the raster layout.
//
// Bound: the function needs a separable 8x8 IDCT, 2*8^3 multiply-adds per
// block and channel, against 3*64*4 + 24 input bytes and the output: about
// 6 fp32 operations per byte, below the H100's fp32 ridge (67 TFLOP/s over
// 3.35 TB/s = 20 op/B), so memory bytes bound it.  This kernel does the
// dense 64x64 product instead (4x the separable count, ~30 op/B, above the
// ridge): simpler to keep exact, and then its own FMAs bound it.
//
// Design: each thread keeps one row of the 64x64 IDCT operator K in
// registers (its output sample i = t%64, loaded once per CTA and reused
// over every tile the CTA walks), so the inner loop is 3 FMAs per shared
// load of coefficients (float4 broadcasts: the 32 lanes of a warp read the
// same block).  A tile's coefficients are dequantized once, cooperatively,
// into shared memory with coalesced loads.  The Pallas kernel's separate
// relayout (reshape/transpose) and u8 clip are folded into the stores.
template <int kMode>
__global__ void __launch_bounds__(kThreads)
    dct8_kernel(const float* __restrict__ coeffs,   // (3, n, 64)
                const float* __restrict__ aux,      // (6, n)
                const float* __restrict__ weights,  // (64, 3)
                const float* __restrict__ kmat,     // (64, 64)
                const float* __restrict__ consts,   // (8,) or (22,)
                void* __restrict__ out,             // (3, 8*h8, 8*w8)
                int n, int h8, int w8) {
  __shared__ __align__(16) float cf[3][kTileBlocks][64];
  __shared__ float w_s[64 * 3];

  const int t = threadIdx.x;
  const int i = t & 63;
  const int sub = t >> 6;
  for (int k = t; k < 64 * 3; k += kThreads) w_s[k] = weights[k];

  float krow[64];
#pragma unroll
  for (int j = 0; j < 64; ++j) krow[j] = kmat[i * 64 + j];

  const float gs_inv = consts[0];
  const float qm[3] = {consts[1], 1.0f, consts[2]};
  const float qb[3] = {consts[3], consts[4], consts[5]};
  const float qbnum = consts[6];
  Colour col{};
  if constexpr (kMode != kXyb) col = load_colour(consts);

  const int W = 8 * w8;
  const size_t plane = (size_t)8 * h8 * W;
  const int ntiles = (n + kTileBlocks - 1) / kTileBlocks;

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int b0 = tile * kTileBlocks;
    __syncthreads();  // w_s ready; the previous tile's readers are done
    for (int e = t; e < kTileBlocks * 64; e += kThreads) {
      const int bl = e >> 6, j = e & 63, b = b0 + bl;
      float v[3] = {0.0f, 0.0f, 0.0f};
      if (b < n) {
        if (j == 0) {
          // LLF substitution at canonical position 0
#pragma unroll
          for (int c = 0; c < 3; ++c) v[c] = aux[(size_t)c * n + b];
        } else {
          const float hf = aux[(size_t)3 * n + b];
          float d[3];
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const float q = coeffs[((size_t)c * n + b) * 64 + j];
            const bool small = fabsf(q) <= 1.0f;
            // zero cells (the big-block cells of a mixed group's dense grid)
            // must give 0, never 0/0
            const float safe = q == 0.0f ? 1.0f : q;
            const float adj = small ? q * qb[c] : q - qbnum / safe;
            const float mult = (gs_inv * qm[c]) * hf;
            d[c] = adj * mult / w_s[j * 3 + c];
          }
          v[0] = d[0] + d[1] * aux[(size_t)4 * n + b];
          v[1] = d[1];
          v[2] = d[2] + d[1] * aux[(size_t)5 * n + b];
        }
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) cf[c][bl][j] = v[c];
    }
    __syncthreads();

    for (int bl = sub; bl < kTileBlocks; bl += kThreads / 64) {
      const int b = b0 + bl;
      if (b >= n) break;
      const float4* c0 = reinterpret_cast<const float4*>(cf[0][bl]);
      const float4* c1 = reinterpret_cast<const float4*>(cf[1][bl]);
      const float4* c2 = reinterpret_cast<const float4*>(cf[2][bl]);
      float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f;
#pragma unroll
      for (int j4 = 0; j4 < 16; ++j4) {
        const float4 x = c0[j4], y = c1[j4], z = c2[j4];
        const float k0 = krow[4 * j4], k1 = krow[4 * j4 + 1];
        const float k2 = krow[4 * j4 + 2], k3 = krow[4 * j4 + 3];
        acc0 = fmaf(k0, x.x, acc0);
        acc1 = fmaf(k0, y.x, acc1);
        acc2 = fmaf(k0, z.x, acc2);
        acc0 = fmaf(k1, x.y, acc0);
        acc1 = fmaf(k1, y.y, acc1);
        acc2 = fmaf(k1, z.y, acc2);
        acc0 = fmaf(k2, x.z, acc0);
        acc1 = fmaf(k2, y.z, acc1);
        acc2 = fmaf(k2, z.z, acc2);
        acc0 = fmaf(k3, x.w, acc0);
        acc1 = fmaf(k3, y.w, acc1);
        acc2 = fmaf(k3, z.w, acc2);
      }
      const int by = b / w8, bx = b - by * w8;
      const size_t o = (size_t)(by * 8 + (i >> 3)) * W + bx * 8 + (i & 7);
      if constexpr (kMode == kXyb) {
        float* dst = static_cast<float*>(out);
        dst[o] = acc0;
        dst[plane + o] = acc1;
        dst[2 * plane + o] = acc2;
      } else {
        int s[3];
        xyb_to_srgb(acc0, acc1, acc2, col, s);
        if constexpr (kMode == kSrgbU8) {
          uint8_t* dst = static_cast<uint8_t*>(out);
          dst[o] = clamp_u8(s[0]);
          dst[plane + o] = clamp_u8(s[1]);
          dst[2 * plane + o] = clamp_u8(s[2]);
        } else {
          int* dst = static_cast<int*>(out);
          dst[o] = s[0];
          dst[plane + o] = s[1];
          dst[2 * plane + o] = s[2];
        }
      }
    }
  }
}

// Pointwise XYB -> sRGB over (3, H, W) raster planes.
//
// Bound: 12 bytes read and 3 (u8) or 12 (int32) written per pixel against
// some 60 fp32 operations (three powf), about 4 per byte: below the H100's
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
    int s[3];
    xyb_to_srgb(planes[p], planes[npix + p], planes[2 * npix + p], col, s);
    if constexpr (kU8) {
      uint8_t* dst = static_cast<uint8_t*>(out);
      dst[p] = clamp_u8(s[0]);
      dst[npix + p] = clamp_u8(s[1]);
      dst[2 * npix + p] = clamp_u8(s[2]);
    } else {
      int* dst = static_cast<int*>(out);
      dst[p] = s[0];
      dst[npix + p] = s[1];
      dst[2 * npix + p] = s[2];
    }
  }
}

}  // namespace

extern "C" {

int j40tt_reconstruct_dct8(const float* coeffs, const float* aux,
                           const float* weights, const float* kmat,
                           const float* consts, float* out, int n, int h8,
                           int w8, int grid, cudaStream_t stream) {
  dct8_kernel<kXyb><<<grid, kThreads, 0, stream>>>(coeffs, aux, weights, kmat,
                                                   consts, out, n, h8, w8);
  return (int)cudaGetLastError();
}

int j40tt_reconstruct_dct8_srgb(const float* coeffs, const float* aux,
                                const float* weights, const float* kmat,
                                const float* consts, void* out, int n, int h8,
                                int w8, int to_u8, int grid,
                                cudaStream_t stream) {
  if (to_u8)
    dct8_kernel<kSrgbU8><<<grid, kThreads, 0, stream>>>(
        coeffs, aux, weights, kmat, consts, out, n, h8, w8);
  else
    dct8_kernel<kSrgbI32><<<grid, kThreads, 0, stream>>>(
        coeffs, aux, weights, kmat, consts, out, n, h8, w8);
  return (int)cudaGetLastError();
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

int j40tt_tile_blocks(void) { return kTileBlocks; }

}  // extern "C"
