// What the RG-LRU scan's forward (rglru_scan.cu) and backward
// (rglru_scan_bwd.cu) kernels share: the block's shape, two-channel loads
// and stores, one step's coefficients with rg_lru's arithmetic, and the
// flag loads and stores that order a chunk after its neighbour.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace rglru {

constexpr int kSeg = 8;                // steps a warp walks (ref.py SEGMENT)
constexpr int kWarps = 8;              // segments a chunk
constexpr int kChunk = kSeg * kWarps;  // steps a block takes (ref.py CHUNK)
constexpr int kThreads = kWarps * 32;
constexpr int kSlice = 64;             // channels a block, two a lane (ops.py SLICE)
constexpr float kC = 8.0f;             // LRU_C

template <typename T>
struct Pair;

// Two adjacent channels: loaded as one 8-byte float2 or 4-byte bf16x2 (Raw),
// widened to float2 when used.
template <>
struct Pair<float> {
  using Raw = float2;
  static __device__ __forceinline__ Raw load(const float* p) { return *reinterpret_cast<const float2*>(p); }
  static __device__ __forceinline__ float2 wide(Raw v) { return v; }
  static __device__ __forceinline__ void store(float* p, float2 v) {
    *reinterpret_cast<float2*>(p) = v;
  }
  static __device__ __forceinline__ float mul(float a, float b) { return a * b; }
  static __device__ __forceinline__ float round(float a) { return a; }
};

template <>
struct Pair<__nv_bfloat16> {
  using Raw = __nv_bfloat162;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return *reinterpret_cast<const __nv_bfloat162*>(p);
  }
  static __device__ __forceinline__ float2 wide(Raw v) { return __bfloat1622float2(v); }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float2 v) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v.x, v.y);
  }
  // a * b in bf16: the float product of two bf16 values is exact; round it once
  static __device__ __forceinline__ float mul(float a, float b) { return round(a * b); }
  static __device__ __forceinline__ float round(float a) { return __bfloat162float(__float2bfloat16_rn(a)); }
};

__device__ __forceinline__ float log_sigmoid(float v) {
  return fminf(v, 0.f) - log1pf(expf(-fabsf(v)));
}

// One step's coefficients for one channel: h <- a h + b.  c8lsl is
// 8 * log_sigmoid(lam); r * c8lsl has the bits of (8 r) * log_sigmoid(lam),
// since scaling by 8 is exact.
template <typename T>
__device__ __forceinline__ void coeff(float r, float ig, float x, float c8lsl, float* a, float* b) {
  const float log_a = r * c8lsl;
  *a = expf(log_a);
  const float beta = sqrtf(fmaxf(1.f - expf(2.f * log_a), 1e-12f));
  *b = beta * Pair<T>::mul(ig, x);
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// h <- a h + b for both channels.
__device__ __forceinline__ float2 step(float2 a, float2 h, float2 b) {
  return make_float2(fmaf(a.x, h.x, b.x), fmaf(a.y, h.y, b.y));
}

}  // namespace rglru
