// CPU thread shim for the CUDA kernels of j40_tpu_torch/csrc (tools/cpu_shim):
// one std::thread per CUDA thread, blocks one at a time; __syncthreads and
// the warp collectives through std::barrier (threads that exit drop out).
#pragma once
#include <atomic>
#include <barrier>
#include <cstdint>
#include <cstring>
#include <cmath>
#include <functional>
#include <thread>
#include <vector>
#include <algorithm>
#include <memory>
using std::min; using std::max;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__ __restrict
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
struct uint2 { uint32_t x, y; };
struct uint4 { uint32_t x, y, z, w; };
struct int2 { int x, y; };
struct alignas(16) int4 { int x, y, z, w; };
struct alignas(8) float2 { float x, y; };
inline float2 make_float2(float a, float b) { return {a, b}; }
struct alignas(16) float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
#define __align__(n) __attribute__((aligned(n)))
inline uint2 make_uint2(uint32_t a, uint32_t b) { return {a, b}; }
inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) { return {a, b, c, d}; }
inline int2 make_int2(int a, int b) { return {a, b}; }
inline int4 make_int4(int a, int b, int c, int d) { return {a, b, c, d}; }
extern thread_local dim3 threadIdx, blockIdx;
extern dim3 blockDim, gridDim;
struct ShimBlock;
extern thread_local ShimBlock* shim_blk;
extern thread_local int shim_tid;
struct ShimBlock {
  int nthreads;
  std::unique_ptr<std::barrier<>> bar;
  std::vector<std::unique_ptr<std::barrier<>>> wbar;
  std::vector<uint64_t> xch;  // per thread exchange slots
  std::atomic<int> orv{0};
};
inline void __syncthreads() { shim_blk->bar->arrive_and_wait(); }
inline int __syncthreads_or(int p) {
  if (shim_tid == 0) shim_blk->orv = 0;
  shim_blk->bar->arrive_and_wait();
  if (p) shim_blk->orv = 1;
  shim_blk->bar->arrive_and_wait();
  int r = shim_blk->orv;
  shim_blk->bar->arrive_and_wait();
  return r;
}
inline void __syncwarp(unsigned = 0xFFFFFFFFu) { shim_blk->wbar[shim_tid / 32]->arrive_and_wait(); }
template <typename T> inline T shim_shfl(T v, int src) {
  int w = shim_tid / 32;
  std::memcpy(&shim_blk->xch[shim_tid], &v, sizeof(T));
  shim_blk->wbar[w]->arrive_and_wait();
  T r; std::memcpy(&r, &shim_blk->xch[w * 32 + (src & 31)], sizeof(T));
  shim_blk->wbar[w]->arrive_and_wait();
  return r;
}
#define __shfl_sync(m, v, s) shim_shfl(v, s)
template <typename T> inline T __shfl_up_sync(unsigned, T v, int d) { int lane = shim_tid & 31; T r = shim_shfl(v, lane >= d ? lane - d : lane); return r; }
template <typename T> inline T __shfl_down_sync(unsigned, T v, int d) { int lane = shim_tid & 31; return shim_shfl(v, lane + d < 32 ? lane + d : lane); }
template <typename T> inline T __shfl_xor_sync(unsigned, T v, int d) { int lane = shim_tid & 31; return shim_shfl(v, lane ^ d); }
inline unsigned __ballot_sync(unsigned, int p) {
  int w = shim_tid / 32;
  shim_blk->xch[shim_tid] = p ? 1 : 0;
  shim_blk->wbar[w]->arrive_and_wait();
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) if (shim_blk->xch[w * 32 + i]) r |= 1u << i;
  shim_blk->wbar[w]->arrive_and_wait();
  return r;
}
inline int __any_sync(unsigned m, int p) { return __ballot_sync(m, p) != 0; }
inline int __all_sync(unsigned m, int p) { return __ballot_sync(m, p) == 0xFFFFFFFFu; }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __popcll(unsigned long long x) { return __builtin_popcountll(x); }
inline int __ffs(int x) { return __builtin_ffs(x); }
inline int __clz(int x) { return x ? __builtin_clz(x) : 32; }
inline int __ffsll(long long x) { return __builtin_ffsll(x); }
template <typename T> inline T __ldg(const T* p) { return *p; }
inline void __threadfence_block() { std::atomic_thread_fence(std::memory_order_seq_cst); }
inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }
inline void __nanosleep(unsigned) { std::this_thread::yield(); }
template <typename T> inline T atomicAdd(T* p, T v) { return std::atomic_ref<T>(*p).fetch_add(v); }
template <typename T> inline T atomicMax(T* p, T v) { std::atomic_ref<T> a(*p); T o = a.load(); while (o < v && !a.compare_exchange_weak(o, v)) {} return o; }
template <typename T> inline T atomicMin(T* p, T v) { std::atomic_ref<T> a(*p); T o = a.load(); while (o > v && !a.compare_exchange_weak(o, v)) {} return o; }
template <typename T> inline T atomicOr(T* p, T v) { return std::atomic_ref<T>(*p).fetch_or(v); }
template <typename T> inline T atomicExch(T* p, T v) { return std::atomic_ref<T>(*p).exchange(v); }
inline float fminf(float a, float b) { return std::fmin(a, b); }
inline float fmaxf(float a, float b) { return std::fmax(a, b); }
inline float fabsf(float a) { return std::fabs(a); }
extern char* shim_dyn_smem;
extern int shim_last_error;
void shim_launch(dim3 g, dim3 b, size_t smem, std::function<void()> body);
inline cudaError_t cudaGetLastError() { int e = shim_last_error; shim_last_error = 0; return e; }
template <typename K> inline cudaError_t cudaFuncSetAttribute(K, int, int) { return 0; }
inline const char* cudaGetErrorString(cudaError_t e) { return e ? "shim error" : "no error"; }
inline cudaError_t cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) { std::memset(p, v, n); return 0; }
enum { cudaDevAttrMultiProcessorCount = 16, cudaDevAttrMaxSharedMemoryPerBlockOptin = 97 };
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
// two SMs of one CTA each: a persistent grid walks several tiles a CTA
inline cudaError_t cudaDeviceGetAttribute(int* v, int a, int) {
  *v = a == cudaDevAttrMultiProcessorCount ? 2 : 232448;
  return 0;
}
template <typename K> inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, size_t) { *n = 1; return 0; }
inline float __frcp_rn(float x) { return 1.0f / x; }
inline unsigned __float_as_uint(float f) { unsigned x; std::memcpy(&x, &f, 4); return x; }
// a + b rounded toward -inf (the double sum of two floats is exact here)
inline float __fadd_rd(float a, float b) {
  const double d = (double)a + (double)b;
  float r = (float)d;
  if ((double)r > d) r = std::nextafter(r, -INFINITY);
  return r;
}
inline float __int_as_float(int x) { float f; std::memcpy(&f, &x, 4); return f; }
