// j40_tpu native host reconstruct: VarDCT coefficient -> sRGB samples.
//
// The host dual of ops/combine_jax.py (the device path): dequant + CfL +
// LLF substitution + inverse transform + XYB->sRGB for one LF group,
// multithreaded over varblocks / row bands.  Used when the decoder's
// execution planner picks the host backend (e.g. when the host<->device
// link would dominate; see Decoder(backend='auto')).  Math mirrors the
// numpy oracle VarDCTState.dequant_hf/_combine_lf_group (j40_tpu/vardct/
// state.py), itself validated against the reference (j40.h:7045-7247).
//
// Inverse transforms are supplied by the caller as basis matrices: dense
// 64x64 operators for the 8x8 special transforms (Hornuss/DCT2/DCT4/
// DCT4x8/AFV; j40.h:5993-6246) and separable row/column IDCT-III factors
// for the true DCTs (j40.h:5657-5990) — the caller derives them from the
// Python DCT library so both backends share one definition.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#if defined(__x86_64__) || defined(_M_X64)
#include <immintrin.h>
#define J40T_X86 1
#endif

#define J40T_API extern "C" __attribute__((visibility("default")))

namespace {

#if J40T_X86
// runtime dispatch: the .so is built without -mavx2 so it loads anywhere;
// the AVX2 paths are per-function target("avx2,fma") islands
static bool has_avx2() {
  static const bool v =
      __builtin_cpu_supports("avx2") && __builtin_cpu_supports("fma");
  return v;
}
#endif

struct ReconstructArgs {
  const float* coeffs[3];
  const float* llf[3];
  int32_t ggh8, ggw8, ggh, ggw;
  int32_t rect_y0, rect_x0, rect_h, rect_w;  // processed pixel window
                           // within the LF group (a 256^2 group for
                           // group-granular pipelining, or the whole gg)
  int64_t samples_stride;  // row stride of the samples planes (== rect_w
                           // for the internal scratch; caller-defined in
                           // samples-only mode)
  const int64_t* vb_coeffoff;
  const float* vb_hfmul_inv;
  const int32_t* vb_dctsel;
  const int32_t* corner_y8;
  const int32_t* corner_x8;
  int32_t nb_varblocks;
  const float* xfromy;  // per-64px CfL factors, row stride cfl_stride
  const float* bfromy;
  int32_t cfl_stride;
  const int32_t* cls_tab;  // 27 * 5: kind, log_rows, log_cols, off_a, off_b
  const float* mats;       // basis-matrix blob (offsets from cls_tab)
  const float* const* dq_w;  // 27 pointers, each (size, 3) row-major
  const float* consts;
  float* samples[3];  // (ggh, ggw) scratch planes
};

// consts layout (must match bindings.py _recon_consts):
//  0 gsi (65536/global_scale)   1 qm_x   2 qm_b
//  3..5 quant_bias[3]           6 quant_bias_num
//  7 kx_lf  8 kb_lf  9 base_corr_x  10 base_corr_b  11 inv_colour_factor
//  12..20 opsin_inv[9]  21..23 opsin_bias[3]  24..26 cbrt_bias[3]
//  27 itscale  28 maxval

#if J40T_X86
__attribute__((target("avx2,fma"))) static inline void transpose8x8(
    __m256 r[8]) {
  __m256 t0 = _mm256_unpacklo_ps(r[0], r[1]);
  __m256 t1 = _mm256_unpackhi_ps(r[0], r[1]);
  __m256 t2 = _mm256_unpacklo_ps(r[2], r[3]);
  __m256 t3 = _mm256_unpackhi_ps(r[2], r[3]);
  __m256 t4 = _mm256_unpacklo_ps(r[4], r[5]);
  __m256 t5 = _mm256_unpackhi_ps(r[4], r[5]);
  __m256 t6 = _mm256_unpacklo_ps(r[6], r[7]);
  __m256 t7 = _mm256_unpackhi_ps(r[6], r[7]);
  __m256 s0 = _mm256_shuffle_ps(t0, t2, 0x44);
  __m256 s1 = _mm256_shuffle_ps(t0, t2, 0xEE);
  __m256 s2 = _mm256_shuffle_ps(t1, t3, 0x44);
  __m256 s3 = _mm256_shuffle_ps(t1, t3, 0xEE);
  __m256 s4 = _mm256_shuffle_ps(t4, t6, 0x44);
  __m256 s5 = _mm256_shuffle_ps(t4, t6, 0xEE);
  __m256 s6 = _mm256_shuffle_ps(t5, t7, 0x44);
  __m256 s7 = _mm256_shuffle_ps(t5, t7, 0xEE);
  r[0] = _mm256_permute2f128_ps(s0, s4, 0x20);
  r[1] = _mm256_permute2f128_ps(s1, s5, 0x20);
  r[2] = _mm256_permute2f128_ps(s2, s6, 0x20);
  r[3] = _mm256_permute2f128_ps(s3, s7, 0x20);
  r[4] = _mm256_permute2f128_ps(s0, s4, 0x31);
  r[5] = _mm256_permute2f128_ps(s1, s5, 0x31);
  r[6] = _mm256_permute2f128_ps(s2, s6, 0x31);
  r[7] = _mm256_permute2f128_ps(s3, s7, 0x31);
}

// AVX2 specialization of the dominant DCT8x8 varblock: dequant + CfL +
// LLF + 2-D IDCT entirely in ymm registers.  `in` holds the stored layout
// rows (= c2d transposed, see reconstruct_varblock); the IDCT computes
// t = G @ c2d^T = (c2d @ G^T)^T, transposes, then out = G @ (c2d @ G^T).
__attribute__((target("avx2,fma"))) static inline void idct8_avx2(
    const float* G, __m256 in[8], __m256 out[8]) {
  __m256 t[8];
  for (int i = 0; i < 8; ++i) {
    __m256 acc = _mm256_mul_ps(_mm256_broadcast_ss(G + i * 8), in[0]);
    for (int j = 1; j < 8; ++j)
      acc = _mm256_fmadd_ps(_mm256_broadcast_ss(G + i * 8 + j), in[j], acc);
    t[i] = acc;
  }
  transpose8x8(t);
  for (int i = 0; i < 8; ++i) {
    __m256 acc = _mm256_mul_ps(_mm256_broadcast_ss(G + i * 8), t[0]);
    for (int j = 1; j < 8; ++j)
      acc = _mm256_fmadd_ps(_mm256_broadcast_ss(G + i * 8 + j), t[j], acc);
    out[i] = acc;
  }
}

// |q| <= 1: q * quant_bias[c]; else q - quant_bias_num / q.  The divide
// runs in all lanes (IEEE, exact; inf in masked lanes is discarded by the
// blend) — identical values to the scalar path.
__attribute__((target("avx2,fma"))) static inline void dequant8_avx2(
    const float* src, const float* winv, float qb_s, float mc_s, float qbn_s,
    __m256 dq[8]) {
  const __m256 one = _mm256_set1_ps(1.0f);
  const __m256 none = _mm256_set1_ps(-1.0f);
  const __m256 qbn = _mm256_set1_ps(qbn_s);
  const __m256 qb = _mm256_set1_ps(qb_s);
  const __m256 mc = _mm256_set1_ps(mc_s);
  for (int r = 0; r < 8; ++r) {
    const __m256 q = _mm256_loadu_ps(src + 8 * r);
    const __m256 small = _mm256_and_ps(_mm256_cmp_ps(q, one, _CMP_LE_OQ),
                                       _mm256_cmp_ps(q, none, _CMP_GE_OQ));
    const __m256 adj = _mm256_blendv_ps(
        _mm256_sub_ps(q, _mm256_div_ps(qbn, q)), _mm256_mul_ps(q, qb), small);
    dq[r] =
        _mm256_mul_ps(adj, _mm256_mul_ps(mc, _mm256_loadu_ps(winv + 8 * r)));
  }
}

// LLF substitution: lane 0 of row 0 (already-final dequantized LF value)
__attribute__((target("avx2,fma"))) static inline void set_lane0(__m256& v,
                                                                 float x) {
  alignas(32) float row0[8];
  _mm256_store_ps(row0, v);
  row0[0] = x;
  v = _mm256_load_ps(row0);
}

__attribute__((target("avx2,fma"))) static inline void idct8_store_avx2(
    const ReconstructArgs& a, const float* G, int c, int32_t y8, int32_t x8,
    int32_t eff_h, int32_t eff_w, __m256 dq[8]) {
  __m256 out[8];
  idct8_avx2(G, dq, out);
  float* dst = a.samples[c] +
               (int64_t)(y8 * 8 - a.rect_y0) * a.samples_stride +
               (x8 * 8 - a.rect_x0);
  if (eff_h == 8 && eff_w == 8) {
    for (int r = 0; r < 8; ++r)
      _mm256_storeu_ps(dst + (int64_t)r * a.samples_stride, out[r]);
  } else {
    alignas(32) float tmp[8];
    for (int r = 0; r < eff_h; ++r) {
      _mm256_store_ps(tmp, out[r]);
      memcpy(dst + (int64_t)r * a.samples_stride, tmp,
             (size_t)eff_w * sizeof(float));
    }
  }
}

__attribute__((target("avx2,fma"))) static void reconstruct_vb_dct8_avx2(
    const ReconstructArgs& a, int32_t vb, const float* G, const float* w) {
  const float* consts = a.consts;
  const int64_t off = a.vb_coeffoff[vb];
  const int32_t y8 = a.corner_y8[vb], x8 = a.corner_x8[vb];
  const float gsi_h = consts[0] * a.vb_hfmul_inv[vb];
  const float mult[3] = {gsi_h * consts[1], gsi_h, gsi_h * consts[2]};
  const int32_t cfl_idx = (y8 / 8) * a.cfl_stride + (x8 / 8);
  const float kx_hf = consts[9] + consts[11] * a.xfromy[cfl_idx];
  const float kb_hf = consts[10] + consts[11] * a.bfromy[cfl_idx];
  const float qbn = consts[6];
  const int64_t loff = off >> 6;
  const float ly = a.llf[1][loff];
  const int32_t eff_h = (a.ggh - y8 * 8) < 8 ? (a.ggh - y8 * 8) : 8;
  const int32_t eff_w = (a.ggw - x8 * 8) < 8 ? (a.ggw - x8 * 8) : 8;

  // Y dequant first (X/B chroma-from-luma reads the PRE-LLF Y coefficients
  // except at position 0, which LLF overwrites in all channels anyway —
  // matching the scalar path's dequant-all-then-substitute order)
  __m256 dqy[8], dq[8];
  dequant8_avx2(a.coeffs[1] + off, w + 64, consts[4], mult[1], qbn, dqy);

  dequant8_avx2(a.coeffs[0] + off, w, consts[3], mult[0], qbn, dq);
  {
    const __m256 k = _mm256_set1_ps(kx_hf);
    for (int r = 0; r < 8; ++r) dq[r] = _mm256_fmadd_ps(dqy[r], k, dq[r]);
  }
  set_lane0(dq[0], a.llf[0][loff] + ly * consts[7]);
  idct8_store_avx2(a, G, 0, y8, x8, eff_h, eff_w, dq);

  dequant8_avx2(a.coeffs[2] + off, w + 128, consts[5], mult[2], qbn, dq);
  {
    const __m256 k = _mm256_set1_ps(kb_hf);
    for (int r = 0; r < 8; ++r) dq[r] = _mm256_fmadd_ps(dqy[r], k, dq[r]);
  }
  set_lane0(dq[0], a.llf[2][loff] + ly * consts[8]);
  idct8_store_avx2(a, G, 2, y8, x8, eff_h, eff_w, dq);

  set_lane0(dqy[0], ly);
  idct8_store_avx2(a, G, 1, y8, x8, eff_h, eff_w, dqy);
}
#endif  // J40T_X86

void reconstruct_varblock(const ReconstructArgs& a, int32_t vb,
                          float* cf, float* tmp) {
  const float* consts = a.consts;
  const int32_t ds = a.vb_dctsel[vb];
  const int32_t* cls = a.cls_tab + ds * 5;
  const int32_t kind = cls[0], lr = cls[1], lc = cls[2];
  const int32_t R = 1 << lr, C = 1 << lc, size = R * C;
  const int64_t off = a.vb_coeffoff[vb];
  const int32_t y8 = a.corner_y8[vb], x8 = a.corner_x8[vb];

  const float gsi_h = consts[0] * a.vb_hfmul_inv[vb];
  const float mult[3] = {gsi_h * consts[1], gsi_h, gsi_h * consts[2]};
  const float qbnum = consts[6];
  const int32_t cfl_idx = (y8 / 8) * a.cfl_stride + (x8 / 8);
  const float kx_hf = consts[9] + consts[11] * a.xfromy[cfl_idx];
  const float kb_hf = consts[10] + consts[11] * a.bfromy[cfl_idx];
  // reciprocal dequant weights, channel-major (3, size): contiguous loads
  // and a multiply instead of a per-coefficient divide
  const float* w = a.dq_w[ds];

  // dequant Y first (X and B need it for chroma-from-luma)
  float* dq[3] = {cf, cf + size, cf + 2 * size};
  static const int kChannelOrder[3] = {1, 0, 2};
  for (int oi = 0; oi < 3; ++oi) {
    const int c = kChannelOrder[oi];
    const float qb = consts[3 + c], mc = mult[c];
    const float* src = a.coeffs[c] + off;
    const float* winv = w + (size_t)c * size;
    float* out = dq[c];
    for (int32_t i = 0; i < size; ++i) {
      const float q = src[i];
      const float adj =
          (q >= -1.0f && q <= 1.0f) ? q * qb : q - qbnum / q;
      out[i] = adj * (mc * winv[i]);
    }
    if (c == 0) {
      for (int32_t i = 0; i < size; ++i) out[i] += dq[1][i] * kx_hf;
    } else if (c == 2) {
      for (int32_t i = 0; i < size; ++i) out[i] += dq[1][i] * kb_hf;
    }
  }

  // LLF substitution: canonical positions y*vw8*8 + x (already-final values)
  const int32_t vh8 = 1 << ((lr < lc ? lr : lc) - 3);
  const int32_t vw8 = 1 << ((lr > lc ? lr : lc) - 3);
  const int64_t loff = off >> 6;
  const float kx_lf = consts[7], kb_lf = consts[8];
  for (int32_t y = 0; y < vh8; ++y) {
    for (int32_t x = 0; x < vw8; ++x) {
      const float ly = a.llf[1][loff + y * vw8 + x];
      const int32_t p = y * vw8 * 8 + x;
      dq[0][p] = a.llf[0][loff + y * vw8 + x] + ly * kx_lf;
      dq[1][p] = ly;
      dq[2][p] = a.llf[2][loff + y * vw8 + x] + ly * kb_lf;
    }
  }

  const int32_t eff_h = (a.ggh - y8 * 8) < R ? (a.ggh - y8 * 8) : R;
  const int32_t eff_w = (a.ggw - x8 * 8) < C ? (a.ggw - x8 * 8) : C;
  for (int c = 0; c < 3; ++c) {
    const float* src = dq[c];
    float* out = tmp;  // (R, C) samples
    if (kind == 1) {
      // dense 64x64 operator (8x8 special transforms)
      const float* M = a.mats + cls[3];
      for (int32_t i = 0; i < 64; ++i) {
        float acc = 0.0f;
        const float* row = M + i * 64;
        for (int32_t j = 0; j < 64; ++j) acc += row[j] * src[j];
        out[i] = acc;
      }
    } else {
      // separable: out = Gr @ c2d @ Gc^T, with the canonical flat layout
      // transposed for tall blocks (ops/reconstruct.py idct2d_batch)
      const float* Gr = a.mats + cls[3];
      const float* Gc = a.mats + cls[4];
      float* mid = tmp + size;  // (R, C) after the row transform
      const float* csrc = src;
      if (lc <= lr) {
        // stored layout is c2d^T: materialize c2d row-major once so the
        // accumulation loops below run over contiguous rows (the strided
        // src[k*R+j] read defeats vectorization; the transpose is O(size)
        // against O(R*size) accumulate work)
        float* tp = tmp + 2 * (size_t)size;
        for (int32_t j = 0; j < R; ++j)
          for (int32_t k = 0; k < C; ++k) tp[j * C + k] = src[k * R + j];
        csrc = tp;
      }
      // mid = Gr @ c2d
      for (int32_t i = 0; i < R; ++i) {
        const float* gr = Gr + i * R;
        float* mrow = mid + i * C;
        for (int32_t k = 0; k < C; ++k) mrow[k] = 0.0f;
        for (int32_t j = 0; j < R; ++j) {
          const float g = gr[j];
          const float* crow = csrc + j * C;
          for (int32_t k = 0; k < C; ++k) mrow[k] += g * crow[k];
        }
      }
      // out = mid @ Gc^T
      for (int32_t i = 0; i < R; ++i) {
        const float* mrow = mid + i * C;
        float* orow = out + i * C;
        for (int32_t j2 = 0; j2 < C; ++j2) {
          const float* gc = Gc + j2 * C;
          float acc = 0.0f;
          for (int32_t k = 0; k < C; ++k) acc += mrow[k] * gc[k];
          orow[j2] = acc;
        }
      }
    }
    float* dst = a.samples[c] +
                 (int64_t)(y8 * 8 - a.rect_y0) * a.samples_stride +
                 (x8 * 8 - a.rect_x0);
    for (int32_t y = 0; y < eff_h; ++y)
      memcpy(dst + (int64_t)y * a.samples_stride, out + y * C,
             eff_w * sizeof(float));
  }
}

// x^(1/2.4) over [0, kGammaMax] via a 4096-entry table + linear interp:
// max abs error ~2e-5 (the curvature blows up only below the sRGB linear
// threshold 0.0031308, which never reaches here), ~10x faster than powf.
constexpr int32_t kGammaN = 4096;
constexpr float kGammaMax = 1.0625f;

const float* gamma_lut() {
  static const std::vector<float> lut = [] {
    std::vector<float> t(kGammaN + 2);
    for (int32_t i = 0; i <= kGammaN + 1; ++i)
      t[i] = powf((float)i * (kGammaMax / kGammaN), 1.0f / 2.4f);
    return t;
  }();
  return lut.data();
}

// lut == nullptr selects exact powf: the ~2e-5 interpolation error is far
// below an 8-bit quantization step but approaches one level at bpp >= 14
static inline float srgb_gamma(float v, const float* lut) {
  if (v <= 0.0031308f) return 12.92f * v;
  if (lut == nullptr || v >= kGammaMax)
    return 1.055f * powf(v, 1.0f / 2.4f) - 0.055f;
  const float p = v * (kGammaN / kGammaMax);
  const int32_t i = (int32_t)p;
  const float frac = p - (float)i;
  return 1.055f * (lut[i] + (lut[i + 1] - lut[i]) * frac) - 0.055f;
}

// XYB -> linear sRGB -> gamma -> quantized output for rows [y0, y1).
// px_stride elements between horizontal neighbors (4 when writing the three
// color slots of an interleaved RGBA canvas directly, 1 for planar).
template <typename Dst>
void xyb_rows(const ReconstructArgs& a, Dst* const* dst, int64_t dst_stride,
              int32_t px_stride, int32_t y0, int32_t y1, Dst lo, Dst hi) {
  const float* consts = a.consts;
  const float cb0 = consts[24], cb1 = consts[25], cb2 = consts[26];
  const float ob0 = consts[21], ob1 = consts[22], ob2 = consts[23];
  const float its = consts[27], maxval = consts[28];
  const float* inv = consts + 12;
  const float* lut = maxval <= 255.5f ? gamma_lut() : nullptr;
  const int32_t W = a.rect_w;
  for (int32_t y = y0; y < y1; ++y) {
    const float* X = a.samples[0] + y * a.samples_stride;
    const float* Y = a.samples[1] + y * a.samples_stride;
    const float* B = a.samples[2] + y * a.samples_stride;
    Dst* d0 = dst[0] + (int64_t)y * dst_stride;
    Dst* d1 = dst[1] + (int64_t)y * dst_stride;
    Dst* d2 = dst[2] + (int64_t)y * dst_stride;
    for (int32_t x = 0; x < W; ++x) {
      const float p0 = Y[x] + X[x] - cb0;
      const float p1 = Y[x] - X[x] - cb1;
      const float p2 = B[x] - cb2;
      const float m0 = (p0 * p0 * p0 + ob0) * its;
      const float m1 = (p1 * p1 * p1 + ob1) * its;
      const float m2 = (p2 * p2 * p2 + ob2) * its;
      for (int c = 0; c < 3; ++c) {
        float v = inv[c * 3] * m0 + inv[c * 3 + 1] * m1 + inv[c * 3 + 2] * m2;
        v = srgb_gamma(v, lut);
        int32_t q = (int32_t)(maxval * v + 0.5f);
        if (q < (int32_t)lo) q = (int32_t)lo;
        if (q > (int32_t)hi) q = (int32_t)hi;
        (c == 0 ? d0 : c == 1 ? d1 : d2)[(int64_t)x * px_stride] = (Dst)q;
      }
    }
  }
}

#if J40T_X86
// gathered gamma-LUT lerp; lanes above the LUT range (rare out-of-gamut)
// are patched up with the scalar powf fallback, bit-identical to the
// scalar path's fallback
__attribute__((target("avx2,fma"))) static inline __m256 gamma_vec_avx2(
    __m256 v, const float* lut) {
  const __m256 gscale = _mm256_set1_ps((float)kGammaN / kGammaMax);
  const __m256 p = _mm256_mul_ps(v, gscale);
  __m256i i = _mm256_cvttps_epi32(p);
  i = _mm256_min_epi32(_mm256_max_epi32(i, _mm256_setzero_si256()),
                       _mm256_set1_epi32(kGammaN));
  const __m256 fi = _mm256_cvtepi32_ps(i);
  const __m256 frac = _mm256_sub_ps(p, fi);
  const __m256 l0 = _mm256_i32gather_ps(lut, i, 4);
  const __m256 l1 =
      _mm256_i32gather_ps(lut, _mm256_add_epi32(i, _mm256_set1_epi32(1)), 4);
  __m256 g = _mm256_fmadd_ps(_mm256_sub_ps(l1, l0), frac, l0);
  g = _mm256_fmsub_ps(_mm256_set1_ps(1.055f), g, _mm256_set1_ps(0.055f));
  // linear segment below the sRGB knee
  const __m256 lin_mask =
      _mm256_cmp_ps(v, _mm256_set1_ps(0.0031308f), _CMP_LE_OQ);
  g = _mm256_blendv_ps(g, _mm256_mul_ps(_mm256_set1_ps(12.92f), v), lin_mask);
  const int over = _mm256_movemask_ps(
      _mm256_cmp_ps(v, _mm256_set1_ps(kGammaMax), _CMP_GE_OQ));
  if (__builtin_expect(over != 0, 0)) {
    alignas(32) float vs_[8], gs[8];
    _mm256_store_ps(vs_, v);
    _mm256_store_ps(gs, g);
    for (int l = 0; l < 8; ++l)
      if (over & (1 << l)) gs[l] = 1.055f * powf(vs_[l], 1.0f / 2.4f) - 0.055f;
    g = _mm256_load_ps(gs);
  }
  return g;
}

__attribute__((target("avx2,fma"))) static inline __m256i quant_avx2(
    __m256 v, __m256 maxval, __m256 half, __m256i qlo_v, __m256i qhi_v) {
  __m256i q = _mm256_cvttps_epi32(_mm256_fmadd_ps(maxval, v, half));
  return _mm256_min_epi32(_mm256_max_epi32(q, qlo_v), qhi_v);
}

// AVX2 XYB->sRGB: 8 pixels per iteration — cube + opsin matmul + gathered
// gamma-LUT lerp + quantize.  Values match the scalar path exactly: same
// LUT, same operation order per element.
__attribute__((target("avx2,fma"))) void xyb_rows_avx2(
    const ReconstructArgs& a, void* const* dstv, int64_t dst_stride,
    int32_t px_stride, int32_t dst_is_u8, int32_t y0, int32_t y1) {
  const float* consts = a.consts;
  const float* lut = gamma_lut();
  const __m256 cb0 = _mm256_set1_ps(consts[24]);
  const __m256 cb1 = _mm256_set1_ps(consts[25]);
  const __m256 cb2 = _mm256_set1_ps(consts[26]);
  const __m256 ob0 = _mm256_set1_ps(consts[21]);
  const __m256 ob1 = _mm256_set1_ps(consts[22]);
  const __m256 ob2 = _mm256_set1_ps(consts[23]);
  const __m256 its = _mm256_set1_ps(consts[27]);
  const float maxval_s = consts[28];
  const __m256 maxval = _mm256_set1_ps(maxval_s);
  const __m256 half = _mm256_set1_ps(0.5f);
  const int32_t qlo = dst_is_u8 ? 0 : INT16_MIN;
  const int32_t qhi = dst_is_u8 ? 255 : INT16_MAX;
  const __m256i qlo_v = _mm256_set1_epi32(qlo);
  const __m256i qhi_v = _mm256_set1_epi32(qhi);
  const int32_t W = a.rect_w;
  const int32_t Wv = W & ~7;
  const bool rgba_fused =
      dst_is_u8 && px_stride == 4 &&
      (const uint8_t*)dstv[1] == (const uint8_t*)dstv[0] + 1 &&
      (const uint8_t*)dstv[2] == (const uint8_t*)dstv[0] + 2;

  for (int32_t y = y0; y < y1; ++y) {
    const float* X = a.samples[0] + y * a.samples_stride;
    const float* Y = a.samples[1] + y * a.samples_stride;
    const float* B = a.samples[2] + y * a.samples_stride;
    uint8_t* drow[3];
    int32_t* drow32[3];
    for (int c = 0; c < 3; ++c) {
      drow[c] = (uint8_t*)dstv[c] + (int64_t)y * dst_stride *
                                        (dst_is_u8 ? 1 : 4);
      drow32[c] = (int32_t*)dstv[c] + (int64_t)y * dst_stride;
    }
    for (int32_t x = 0; x < Wv; x += 8) {
      const __m256 xv = _mm256_loadu_ps(X + x);
      const __m256 yv = _mm256_loadu_ps(Y + x);
      const __m256 bv = _mm256_loadu_ps(B + x);
      const __m256 p0 = _mm256_sub_ps(_mm256_add_ps(yv, xv), cb0);
      const __m256 p1 = _mm256_sub_ps(_mm256_sub_ps(yv, xv), cb1);
      const __m256 p2 = _mm256_sub_ps(bv, cb2);
      const __m256 m0 = _mm256_mul_ps(
          _mm256_add_ps(_mm256_mul_ps(_mm256_mul_ps(p0, p0), p0), ob0), its);
      const __m256 m1 = _mm256_mul_ps(
          _mm256_add_ps(_mm256_mul_ps(_mm256_mul_ps(p1, p1), p1), ob1), its);
      const __m256 m2 = _mm256_mul_ps(
          _mm256_add_ps(_mm256_mul_ps(_mm256_mul_ps(p2, p2), p2), ob2), its);
      __m256i q[3];
      for (int c = 0; c < 3; ++c) {
        const float* inv = consts + 12 + c * 3;
        // same add order as the scalar path: (i0*m0 + i1*m1) + i2*m2
        __m256 v = _mm256_add_ps(
            _mm256_add_ps(_mm256_mul_ps(_mm256_set1_ps(inv[0]), m0),
                          _mm256_mul_ps(_mm256_set1_ps(inv[1]), m1)),
            _mm256_mul_ps(_mm256_set1_ps(inv[2]), m2));
        q[c] = quant_avx2(gamma_vec_avx2(v, lut), maxval, half, qlo_v, qhi_v);
      }
      if (rgba_fused) {
        // assemble 8 RGBA words (alpha = 255; the canvas has no real alpha
        // channel on this path — it is prefilled opaque at allocation)
        __m256i word = _mm256_or_si256(
            _mm256_or_si256(q[0], _mm256_slli_epi32(q[1], 8)),
            _mm256_or_si256(_mm256_slli_epi32(q[2], 16),
                            _mm256_set1_epi32((int32_t)0xff000000u)));
        _mm256_storeu_si256((__m256i*)(drow[0] + (int64_t)x * 4), word);
      } else if (dst_is_u8 && px_stride == 1) {
        for (int c = 0; c < 3; ++c) {
          // 8x int32 -> 8x u8 (values already clamped to [0, 255])
          const __m128i lo128 = _mm256_castsi256_si128(q[c]);
          const __m128i hi128 = _mm256_extracti128_si256(q[c], 1);
          const __m128i p16 = _mm_packus_epi32(lo128, hi128);
          const __m128i p8 = _mm_packus_epi16(p16, p16);
          _mm_storel_epi64((__m128i*)(drow[c] + x), p8);
        }
      } else if (!dst_is_u8 && px_stride == 1) {
        for (int c = 0; c < 3; ++c)
          _mm256_storeu_si256((__m256i*)(drow32[c] + x), q[c]);
      } else {
        alignas(32) int32_t qs[3][8];
        for (int c = 0; c < 3; ++c)
          _mm256_store_si256((__m256i*)qs[c], q[c]);
        for (int l = 0; l < 8; ++l)
          for (int c = 0; c < 3; ++c) {
            if (dst_is_u8)
              drow[c][(int64_t)(x + l) * px_stride] = (uint8_t)qs[c][l];
            else
              drow32[c][(int64_t)(x + l) * px_stride] = qs[c][l];
          }
      }
    }
    // scalar tail
    for (int32_t x = Wv; x < W; ++x) {
      const float pp0 = Y[x] + X[x] - consts[24];
      const float pp1 = Y[x] - X[x] - consts[25];
      const float pp2 = B[x] - consts[26];
      const float mm0 = (pp0 * pp0 * pp0 + consts[21]) * consts[27];
      const float mm1 = (pp1 * pp1 * pp1 + consts[22]) * consts[27];
      const float mm2 = (pp2 * pp2 * pp2 + consts[23]) * consts[27];
      for (int c = 0; c < 3; ++c) {
        const float* inv = consts + 12 + c * 3;
        float v = inv[0] * mm0 + inv[1] * mm1 + inv[2] * mm2;
        v = srgb_gamma(v, lut);
        int32_t qv = (int32_t)(maxval_s * v + 0.5f);
        if (qv < qlo) qv = qlo;
        if (qv > qhi) qv = qhi;
        if (dst_is_u8)
          drow[c][(int64_t)x * px_stride] = (uint8_t)qv;
        else
          drow32[c][(int64_t)x * px_stride] = qv;
      }
    }
  }
}
#endif  // J40T_X86

void run_threads(int32_t nthreads, void (*fn)(void*, int32_t), void* ctx) {
  if (nthreads <= 1) {
    fn(ctx, 0);
    return;
  }
  std::vector<std::thread> ts;
  ts.reserve(nthreads - 1);
  for (int32_t t = 1; t < nthreads; ++t)
    ts.emplace_back([fn, ctx, t] { fn(ctx, t); });
  fn(ctx, 0);
  for (auto& t : ts) t.join();
}

struct PhaseCtx {
  const ReconstructArgs* a;
  std::atomic<int32_t> next{0};
  // phase B
  void* const* dst;
  int64_t dst_stride;
  int32_t px_stride;
  int32_t dst_is_u8;
};

void phase_a(void* p, int32_t) {
  auto* ctx = (PhaseCtx*)p;
  const ReconstructArgs& a = *ctx->a;
  // per-thread scratch: 3 channel buffers + 2x transform temp (max
  // 256x256); persistent across calls — group-granular pipelining invokes
  // the kernel hundreds of times per frame and fresh mmaps would pay the
  // page-fault cost every call
  static thread_local std::vector<float> cf, tmp;
  cf.resize(3 * 65536);
  tmp.resize(3 * 65536);
#if J40T_X86
  const bool avx2 = has_avx2();
#endif
  const int32_t batch = 16;
  for (;;) {
    const int32_t lo = ctx->next.fetch_add(batch);
    if (lo >= a.nb_varblocks) break;
    const int32_t hi =
        lo + batch < a.nb_varblocks ? lo + batch : a.nb_varblocks;
    for (int32_t vb = lo; vb < hi; ++vb) {
      // group-granular rect: skip varblocks whose corner lies outside
      // (callers pass the full per-LF-group arrays; subsetting here keeps
      // the per-call Python glue O(1))
      const int32_t py = a.corner_y8[vb] * 8, px = a.corner_x8[vb] * 8;
      if (py < a.rect_y0 || py >= a.rect_y0 + a.rect_h || px < a.rect_x0 ||
          px >= a.rect_x0 + a.rect_w)
        continue;
#if J40T_X86
      const int32_t* cls = a.cls_tab + a.vb_dctsel[vb] * 5;
      if (avx2 && cls[0] == 0 && cls[1] == 3 && cls[2] == 3) {
        reconstruct_vb_dct8_avx2(a, vb, a.mats + cls[3],
                                 a.dq_w[a.vb_dctsel[vb]]);
        continue;
      }
#endif
      reconstruct_varblock(a, vb, cf.data(), tmp.data());
    }
  }
}

void phase_b(void* p, int32_t) {
  auto* ctx = (PhaseCtx*)p;
  const ReconstructArgs& a = *ctx->a;
  const int32_t batch = 32;
#if J40T_X86
  // the vector path needs the gamma LUT (maxval <= 255.5, same condition
  // as the scalar path's LUT selection); 16-bit outputs keep exact powf
  const bool avx2 = has_avx2() && a.consts[28] <= 255.5f;
#endif
  for (;;) {
    const int32_t y0 = ctx->next.fetch_add(batch);
    if (y0 >= a.rect_h) break;
    const int32_t y1 = y0 + batch < a.rect_h ? y0 + batch : a.rect_h;
#if J40T_X86
    if (avx2) {
      xyb_rows_avx2(a, ctx->dst, ctx->dst_stride, ctx->px_stride,
                    ctx->dst_is_u8, y0, y1);
      continue;
    }
#endif
    if (ctx->dst_is_u8)
      xyb_rows<uint8_t>(a, (uint8_t* const*)ctx->dst, ctx->dst_stride,
                        ctx->px_stride, y0, y1, (uint8_t)0, (uint8_t)255);
    else
      xyb_rows<int32_t>(a, (int32_t* const*)ctx->dst, ctx->dst_stride,
                        ctx->px_stride, y0, y1, (int32_t)INT16_MIN,
                        (int32_t)INT16_MAX);
  }
}

}  // namespace

J40T_API int32_t j40t_combine_lf_group(
    const float* coeff_x, const float* coeff_y, const float* coeff_b,
    const float* llf_x, const float* llf_y, const float* llf_b,
    int32_t ggh8, int32_t ggw8, int32_t ggh, int32_t ggw,
    const int64_t* vb_coeffoff, const float* vb_hfmul_inv,
    const int32_t* vb_dctsel, const int32_t* corner_y8,
    const int32_t* corner_x8, int32_t nb_varblocks, const float* xfromy,
    const float* bfromy, int32_t cfl_stride, const int32_t* cls_tab,
    const float* mats, const float* const* dq_w, const float* consts,
    void* dst0, void* dst1, void* dst2, int64_t dst_stride,
    int32_t px_stride, int32_t dst_is_u8, int32_t samples_only,
    int32_t rect_y0, int32_t rect_x0, int32_t rect_h, int32_t rect_w,
    int32_t nthreads) {
  ReconstructArgs a;
  a.coeffs[0] = coeff_x;
  a.coeffs[1] = coeff_y;
  a.coeffs[2] = coeff_b;
  a.llf[0] = llf_x;
  a.llf[1] = llf_y;
  a.llf[2] = llf_b;
  a.ggh8 = ggh8;
  a.ggw8 = ggw8;
  a.ggh = ggh;
  a.ggw = ggw;
  a.vb_coeffoff = vb_coeffoff;
  a.vb_hfmul_inv = vb_hfmul_inv;
  a.vb_dctsel = vb_dctsel;
  a.corner_y8 = corner_y8;
  a.corner_x8 = corner_x8;
  a.nb_varblocks = nb_varblocks;
  a.xfromy = xfromy;
  a.bfromy = bfromy;
  a.cfl_stride = cfl_stride;
  a.cls_tab = cls_tab;
  a.mats = mats;
  a.dq_w = dq_w;
  a.consts = consts;
  a.rect_y0 = rect_y0;
  a.rect_x0 = rect_x0;
  a.rect_h = rect_h;
  a.rect_w = rect_w;
  // persistent per-thread sample scratch (see phase_a's scratch comment)
  static thread_local std::vector<float> s0, s1, s2;
  if (samples_only) {
    // phase A writes float sample planes straight into the caller's
    // buffers (restoration filters run between reconstruction and XYB)
    a.samples[0] = (float*)dst0;
    a.samples[1] = (float*)dst1;
    a.samples[2] = (float*)dst2;
    a.samples_stride = dst_stride;
  } else {
    s0.resize((int64_t)rect_h * rect_w);
    s1.resize((int64_t)rect_h * rect_w);
    s2.resize((int64_t)rect_h * rect_w);
    a.samples[0] = s0.data();
    a.samples[1] = s1.data();
    a.samples[2] = s2.data();
    a.samples_stride = rect_w;
  }

  PhaseCtx ctx;
  ctx.a = &a;
  void* dst[3] = {dst0, dst1, dst2};
  ctx.dst = dst;
  ctx.dst_stride = dst_stride;
  ctx.px_stride = px_stride;
  ctx.dst_is_u8 = dst_is_u8;
  run_threads(nthreads, phase_a, &ctx);
  if (!samples_only) {
    ctx.next.store(0);
    run_threads(nthreads, phase_b, &ctx);
  }
  return 0;
}

// standalone XYB->sRGB conversion of (possibly filtered) sample planes;
// consts layout as above (only indices 12..28 are read)
J40T_API int32_t j40t_xyb_to_srgb(
    const float* sx, const float* sy, const float* sb, int32_t h, int32_t w,
    int64_t samples_stride, const float* consts, void* dst0, void* dst1,
    void* dst2, int64_t dst_stride, int32_t px_stride, int32_t dst_is_u8,
    int32_t nthreads) {
  ReconstructArgs a;
  memset(&a, 0, sizeof(a));
  a.ggh = h;
  a.ggw = w;
  a.rect_h = h;
  a.rect_w = w;
  a.samples[0] = (float*)sx;
  a.samples[1] = (float*)sy;
  a.samples[2] = (float*)sb;
  a.samples_stride = samples_stride;
  a.consts = consts;
  PhaseCtx ctx;
  ctx.a = &a;
  void* dst[3] = {dst0, dst1, dst2};
  ctx.dst = dst;
  ctx.dst_stride = dst_stride;
  ctx.px_stride = px_stride;
  ctx.dst_is_u8 = dst_is_u8;
  run_threads(nthreads, phase_b, &ctx);
  return 0;
}

// ------------------------------------------------- restoration filters
//
// Host duals of ops/filters.py (the reference implements these but never
// invokes them, j40.h:7251-7624; we wire them in).  Numpy/JAX versions
// remain the oracles; parity is pinned by tests/test_native_combine.py.

namespace {

// half-sample mirror (the reference's mirror1d, j40.h:7328)
static inline int32_t mirror1d(int32_t i, int32_t n) {
  for (;;) {
    if (i < 0) i = -i - 1;
    else if (i >= n) i = 2 * n - 1 - i;
    else return i;
  }
}

struct FilterCtx {
  const float* in[3];   // padded planes, (H + 2*pad) x (W + 2*pad)
  float* out[3];        // H x W
  int32_t H, W, pad;
  int64_t pstride;      // padded row stride
  // epf params
  const float* recip;   // per-8x8 reciprocal sigma (H8 x W8), may be null
  int32_t H8, W8;
  float recip_const;    // used when recip == null (modular)
  float sigma_scale, border_scale;
  float scale[3];
  const int8_t (*kernels)[2];
  int32_t nk;
  bool cross;
  // gaborish params
  float gw[3][3];  // w0, w1, w2 per channel (normalized)
  std::atomic<int32_t> next{0};
};

void gaborish_rows(void* p, int32_t) {
  auto* c = (FilterCtx*)p;
  const int64_t ps = c->pstride;
  for (;;) {
    const int32_t y0 = c->next.fetch_add(16);
    if (y0 >= c->H) break;
    const int32_t y1 = y0 + 16 < c->H ? y0 + 16 : c->H;
    for (int ch = 0; ch < 3; ++ch) {
      const float w0 = c->gw[ch][0], w1 = c->gw[ch][1], w2 = c->gw[ch][2];
      for (int32_t y = y0; y < y1; ++y) {
        const float* pa = c->in[ch] + (int64_t)y * ps;        // row y-1
        const float* pb = pa + ps;                            // row y
        const float* pc = pb + ps;                            // row y+1
        float* o = c->out[ch] + (int64_t)y * c->W;
        for (int32_t x = 0; x < c->W; ++x) {
          o[x] = pa[x] * w2 + pa[x + 1] * w1 + pa[x + 2] * w2 +
                 pb[x] * w1 + pb[x + 1] * w0 + pb[x + 2] * w1 +
                 pc[x] * w2 + pc[x + 1] * w1 + pc[x + 2] * w2;
        }
      }
    }
  }
}

void epf_rows(void* p, int32_t) {
  auto* c = (FilterCtx*)p;
  const int64_t ps = c->pstride;
  const int32_t pad = c->pad;
  for (;;) {
    const int32_t y0 = c->next.fetch_add(8);
    if (y0 >= c->H) break;
    const int32_t y1 = y0 + 8 < c->H ? y0 + 8 : c->H;
    for (int32_t y = y0; y < y1; ++y) {
      const int32_t by = (y / 8) < (c->H8 - 1) ? (y / 8) : (c->H8 - 1);
      float* o0 = c->out[0] + (int64_t)y * c->W;
      float* o1 = c->out[1] + (int64_t)y * c->W;
      float* o2 = c->out[2] + (int64_t)y * c->W;
      const float* base[3];
      for (int ch = 0; ch < 3; ++ch)
        base[ch] = c->in[ch] + (int64_t)(y + pad) * ps + pad;
      for (int32_t x = 0; x < c->W; ++x) {
        const int32_t bx = (x / 8) < (c->W8 - 1) ? (x / 8) : (c->W8 - 1);
        const float rs =
            c->recip ? c->recip[(int64_t)by * c->W8 + bx] : c->recip_const;
        if (rs < 0.0f) {  // skipped block: pixel passes through
          o0[x] = base[0][x];
          o1[x] = base[1][x];
          o2[x] = base[2][x];
          continue;
        }
        const bool border = ((((x + 1) | (y + 1)) & 7) < 2);
        const float inv_sigma =
            rs * (border ? c->border_scale : c->sigma_scale);
        float sum_w = 1.0f;
        float s0 = base[0][x], s1 = base[1][x], s2 = base[2][x];
        for (int32_t k = 0; k < c->nk; ++k) {
          // distances use (dx, dy) = (k0, k1); sampling uses the
          // TRANSPOSED (dy, dx) = (k0, k1) — replicating the reference's
          // latent index swap exactly (see ops/filters.py NOTE)
          const int32_t dxD = c->kernels[k][0], dyD = c->kernels[k][1];
          float dist = 0.0f;
          if (c->cross) {
            static const int8_t CROSS[5][2] = {
                {0, 0}, {0, -1}, {-1, 0}, {1, 0}, {0, 1}};
            for (int ch = 0; ch < 3; ++ch) {
              const float* b = c->in[ch];
              float d = 0.0f;
              for (int t = 0; t < 5; ++t) {
                const int32_t cy = y + CROSS[t][0], cx = x + CROSS[t][1];
                const float v1 = b[(int64_t)(cy + pad) * ps + cx + pad];
                const float v2 =
                    b[(int64_t)(cy + dyD + pad) * ps + cx + dxD + pad];
                d += fabsf(v1 - v2);
              }
              dist += c->scale[ch] * d;
            }
          } else {
            for (int ch = 0; ch < 3; ++ch) {
              const float* b = c->in[ch];
              const float v1 = b[(int64_t)(y + pad) * ps + x + pad];
              const float v2 =
                  b[(int64_t)(y + dyD + pad) * ps + x + dxD + pad];
              dist += c->scale[ch] * fabsf(v1 - v2);
            }
          }
          float w = 1.0f + dist * inv_sigma;
          if (w < 0.0f) w = 0.0f;
          sum_w += w;
          const int32_t dyS = c->kernels[k][0], dxS = c->kernels[k][1];
          s0 += c->in[0][(int64_t)(y + dyS + pad) * ps + x + dxS + pad] * w;
          s1 += c->in[1][(int64_t)(y + dyS + pad) * ps + x + dxS + pad] * w;
          s2 += c->in[2][(int64_t)(y + dyS + pad) * ps + x + dxS + pad] * w;
        }
        const float inv = 1.0f / sum_w;
        o0[x] = s0 * inv;
        o1[x] = s1 * inv;
        o2[x] = s2 * inv;
      }
    }
  }
}

// mirror-pad `src` (H x W) into `dst` ((H+2*pad) x (W+2*pad))
void mirror_pad_plane(const float* src, float* dst, int32_t H, int32_t W,
                      int32_t pad) {
  const int64_t ps = W + 2 * (int64_t)pad;
  for (int32_t y = -pad; y < H + pad; ++y) {
    const float* srow = src + (int64_t)mirror1d(y, H) * W;
    float* drow = dst + (int64_t)(y + pad) * ps;
    for (int32_t x = -pad; x < 0; ++x) drow[x + pad] = srow[mirror1d(x, W)];
    memcpy(drow + pad, srow, (size_t)W * sizeof(float));
    for (int32_t x = W; x < W + pad; ++x)
      drow[x + pad] = srow[mirror1d(x, W)];
  }
}

static const int8_t KERNELS12[12][2] = {
    {0, -2}, {-1, -1}, {-1, 0}, {-1, 1}, {0, -2}, {0, -1},
    {0, 1},  {0, 2},   {-1, 1}, {-1, 0}, {-1, 1}, {0, 2},
};
static const int8_t KERNELS4[4][2] = {{0, -1}, {-1, 0}, {1, 0}, {0, 1}};
constexpr float kPosMult = 1.9330952441687859f;  // -1.65*4*(sqrt(.5)-1)
constexpr float kSigmaThreshold = 0.3f;

}  // namespace

// gaborish, in place over three H x W planes (j40.h:7271-7326).
// weights: [w1, w2] per channel (w0 == 1 before normalization); borders
// replicate edges like ops/filters.py gaborish.
J40T_API int32_t j40t_gaborish(float* ch0, float* ch1, float* ch2, int32_t h,
                               int32_t w, const float* weights,
                               int32_t nthreads) {
  FilterCtx c;
  c.H = h;
  c.W = w;
  c.pad = 1;
  c.pstride = w + 2;
  float* chans[3] = {ch0, ch1, ch2};
  static thread_local std::vector<float> padbuf;
  padbuf.resize((size_t)3 * (h + 2) * (int64_t)(w + 2));
  for (int ch = 0; ch < 3; ++ch) {
    const float w1 = weights[ch * 2], w2 = weights[ch * 2 + 1];
    const float wsum = 1.0f + w1 * 4 + w2 * 4;
    c.gw[ch][0] = 1.0f / wsum;
    c.gw[ch][1] = w1 / wsum;
    c.gw[ch][2] = w2 / wsum;
    float* pb = padbuf.data() + (size_t)ch * (h + 2) * (w + 2);
    // edge-replicating pad (clamp, not mirror — matches the oracle)
    for (int32_t y = -1; y <= h; ++y) {
      int32_t sy = y < 0 ? 0 : (y >= h ? h - 1 : y);
      const float* srow = chans[ch] + (int64_t)sy * w;
      float* drow = pb + (int64_t)(y + 1) * (w + 2);
      drow[0] = srow[0];
      memcpy(drow + 1, srow, (size_t)w * sizeof(float));
      drow[w + 1] = srow[w - 1];
    }
    c.in[ch] = pb;
    c.out[ch] = chans[ch];
  }
  run_threads(nthreads, gaborish_rows, &c);
  return 0;
}

// full EPF (up to 3 steps, j40.h:7578-7622), in place over three H x W
// planes.  recip: per-8x8 reciprocal sigmas (h8 x w8) or NULL for modular
// frames (then sigma_for_modular applies uniformly).
J40T_API int32_t j40t_epf(float* ch0, float* ch1, float* ch2, int32_t h,
                          int32_t w, const float* recip, int32_t h8,
                          int32_t w8, int32_t iters, float p0_scale,
                          float p2_scale, const float* channel_scale,
                          float border_sad_mul, float sigma_for_modular,
                          int32_t nthreads) {
  if (iters <= 0) return 0;
  if (recip == nullptr && sigma_for_modular < kSigmaThreshold) return 0;
  FilterCtx c;
  c.H = h;
  c.W = w;
  c.pad = 3;
  c.pstride = w + 6;
  c.recip = recip;
  c.H8 = h8;
  c.W8 = w8;
  c.recip_const = recip ? 0.0f : 1.0f / sigma_for_modular;
  for (int i = 0; i < 3; ++i) c.scale[i] = channel_scale[i];
  float* chans[3] = {ch0, ch1, ch2};
  static thread_local std::vector<float> padbuf;
  padbuf.resize((size_t)3 * (h + 6) * (int64_t)(w + 6));

  struct Step {
    float sscale;
    const int8_t (*kern)[2];
    int32_t nk;
    bool cross;
  };
  Step steps[3];
  int32_t nsteps = 0;
  if (iters >= 3) steps[nsteps++] = {p0_scale, KERNELS12, 12, true};
  if (iters >= 1) steps[nsteps++] = {1.0f, KERNELS4, 4, true};
  if (iters >= 2) steps[nsteps++] = {p2_scale, KERNELS4, 4, false};

  for (int32_t s = 0; s < nsteps; ++s) {
    for (int ch = 0; ch < 3; ++ch) {
      float* pb = padbuf.data() + (size_t)ch * (h + 6) * (w + 6);
      mirror_pad_plane(chans[ch], pb, h, w, 3);
      c.in[ch] = pb;
      c.out[ch] = chans[ch];
    }
    c.sigma_scale = steps[s].sscale * kPosMult;
    c.border_scale = c.sigma_scale * border_sad_mul;
    c.kernels = steps[s].kern;
    c.nk = steps[s].nk;
    c.cross = steps[s].cross;
    c.next.store(0);
    run_threads(nthreads, epf_rows, &c);
  }
  return 0;
}

// ------------------------------------------------- integer render
//
// Host dual of Decoder._render's per-channel clamp+interleave
// (j40_tpu/decode.py::_one): int32 modular planes -> interleaved RGBA8/16
// with the reference's clamp+scale semantics (j40.h:7910-7962).  numpy's
// clip/astype/strided-store chain costs ~30 ms/MP on this shape; this is
// one fused pass, row-parallel.

namespace {

struct RenderCtx {
  const int32_t* p[4];  // r, g, b, alpha (alpha may be null -> opaque)
  int64_t stride[4];    // elements per plane row
  int32_t h, w;
  void* out;            // u8 or u16, (h, w, 4) contiguous
  int32_t depth;        // 8 or 16 (output dtype width)
  int32_t bpp;          // source bit depth; != depth rescales
  std::atomic<int32_t> next{0};
};

template <typename O>
static void render_rows_scalar(RenderCtx* c, int32_t y0, int32_t y1) {
  const int32_t omax = (1 << c->depth) - 1;
  const int32_t maxpixel = (1 << c->bpp) - 1;
  const int32_t half = 1 << (c->bpp - 1);
  const bool plain = c->bpp == c->depth;
  for (int32_t y = y0; y < y1; ++y) {
    O* dst = (O*)c->out + (size_t)y * c->w * 4;
    for (int ch = 0; ch < 4; ++ch) {
      const int32_t* src =
          c->p[ch] ? c->p[ch] + (size_t)y * c->stride[ch] : nullptr;
      if (!src) {
        for (int32_t x = 0; x < c->w; ++x) dst[(size_t)x * 4 + ch] = (O)omax;
      } else if (plain) {
        for (int32_t x = 0; x < c->w; ++x) {
          int32_t v = src[x];
          v = v < 0 ? 0 : (v > omax ? omax : v);
          dst[(size_t)x * 4 + ch] = (O)v;
        }
      } else {
        for (int32_t x = 0; x < c->w; ++x) {
          int64_t v = src[x];
          v = v < 0 ? 0 : (v > maxpixel ? maxpixel : v);
          dst[(size_t)x * 4 + ch] = (O)((v * omax + half) / maxpixel);
        }
      }
    }
  }
}

#if J40T_X86
__attribute__((target("avx2")))
static void render_rows_avx2_u8(RenderCtx* c, int32_t y0, int32_t y1) {
  // depth == bpp == 8: clamp each plane to [0,255] and byte-pack
  // r | g<<8 | b<<16 | a<<24 per pixel, 8 pixels per iteration
  const __m256i zero = _mm256_setzero_si256();
  const __m256i v255 = _mm256_set1_epi32(255);
  const int32_t w8 = c->w & ~7;
  for (int32_t y = y0; y < y1; ++y) {
    uint8_t* dst = (uint8_t*)c->out + (size_t)y * c->w * 4;
    const int32_t* r = c->p[0] + (size_t)y * c->stride[0];
    const int32_t* g = c->p[1] + (size_t)y * c->stride[1];
    const int32_t* b = c->p[2] + (size_t)y * c->stride[2];
    const int32_t* a = c->p[3] ? c->p[3] + (size_t)y * c->stride[3] : nullptr;
    int32_t x = 0;
    for (; x < w8; x += 8) {
      __m256i vr = _mm256_min_epi32(
          _mm256_max_epi32(_mm256_loadu_si256((const __m256i*)(r + x)), zero),
          v255);
      __m256i vg = _mm256_min_epi32(
          _mm256_max_epi32(_mm256_loadu_si256((const __m256i*)(g + x)), zero),
          v255);
      __m256i vb = _mm256_min_epi32(
          _mm256_max_epi32(_mm256_loadu_si256((const __m256i*)(b + x)), zero),
          v255);
      __m256i va = a ? _mm256_min_epi32(
                           _mm256_max_epi32(
                               _mm256_loadu_si256((const __m256i*)(a + x)),
                               zero),
                           v255)
                     : v255;
      __m256i px = _mm256_or_si256(
          _mm256_or_si256(vr, _mm256_slli_epi32(vg, 8)),
          _mm256_or_si256(_mm256_slli_epi32(vb, 16),
                          _mm256_slli_epi32(va, 24)));
      _mm256_storeu_si256((__m256i*)(dst + (size_t)x * 4), px);
    }
    for (; x < c->w; ++x) {
      auto cl = [](int32_t v) {
        return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
      };
      dst[(size_t)x * 4 + 0] = cl(r[x]);
      dst[(size_t)x * 4 + 1] = cl(g[x]);
      dst[(size_t)x * 4 + 2] = cl(b[x]);
      dst[(size_t)x * 4 + 3] = a ? cl(a[x]) : 255;
    }
  }
}
#endif

static void render_worker(void* p, int32_t) {
  auto* c = (RenderCtx*)p;
  const int32_t BAND = 64;
  const int32_t nbands = (c->h + BAND - 1) / BAND;
  for (;;) {
    int32_t band = c->next.fetch_add(1);
    if (band >= nbands) return;
    int32_t y0 = band * BAND;
    int32_t y1 = y0 + BAND < c->h ? y0 + BAND : c->h;
#if J40T_X86
    if (c->depth == 8 && c->bpp == 8 && has_avx2()) {
      render_rows_avx2_u8(c, y0, y1);
      continue;
    }
#endif
    if (c->depth == 8)
      render_rows_scalar<uint8_t>(c, y0, y1);
    else
      render_rows_scalar<uint16_t>(c, y0, y1);
  }
}

}  // namespace

J40T_API int32_t j40t_render_interleave(
    const int32_t* r, const int32_t* g, const int32_t* b, const int32_t* a,
    int64_t stride_r, int64_t stride_g, int64_t stride_b, int64_t stride_a,
    int32_t h, int32_t w, void* out, int32_t depth, int32_t bpp,
    int32_t nthreads) {
  if (depth != 8 && depth != 16) return 1;
  if (bpp < 1 || bpp > depth) return 1;
  RenderCtx c;
  c.p[0] = r; c.p[1] = g; c.p[2] = b; c.p[3] = a;
  c.stride[0] = stride_r; c.stride[1] = stride_g;
  c.stride[2] = stride_b; c.stride[3] = stride_a;
  c.h = h; c.w = w; c.out = out; c.depth = depth; c.bpp = bpp;
  run_threads(nthreads, render_worker, &c);
  return 0;
}
