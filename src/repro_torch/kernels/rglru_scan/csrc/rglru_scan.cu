// The RG-LRU recurrence (RecurrentGemma / Griffin) for Hopper (sm_90a),
// hand-written CUDA C++.
//
// Replaces no Pallas kernel: the JAX package runs this recurrence as
// jax.lax.associative_scan (src/repro/models/rglru.py:91, `rg_lru`), which
// XLA compiles on the TPU.  On the card a scan on the hot path becomes a
// kernel.  It computes what `rg_lru` computes, per batch row and channel:
//   log_a   = 8 * r * log_sigmoid(lam)          float32
//   a       = exp(log_a)
//   beta    = sqrt(max(1 - exp(2 log_a), 1e-12))
//   gated_x = i * x formed in x's type (bf16: the exact float product
//             rounded once, as PyTorch and XLA form it), widened to float32
//   h_t     = a_t h_{t-1} + beta_t gated_x_t    from h0, in float32
// and writes h in x's type and the last state h_last in float32
// (ref.py::rglru_scan_ref is the same loop in plain torch).
//
// What bounds it on the H100: bytes.  At recurrentgemma-9b's prefill
// (B 4, T 4096, Dr 4096, bf16) it must read x, r and i (3 x 134.2 MB) and
// write h (134.2 MB): ~0.160 ms at 3.35 TB/s.  Its operations (two exp,
// one sqrt and a few multiplies an element) are far below the card's rate.
//
// Design.  One thread walking all T steps of one channel gives only
// B x Dr = 16,384 chains at that shape, each waiting on a dependent load
// every step: the card would sit mostly idle.  So the walk is cut into
// chunks of kChunk steps, in three launches (ref.py::rglru_scan_chunked_ref
// is this algorithm in plain torch):
//   1. chunk_kernel: each (batch, chunk but the last, channel pair) from a
//      zero state: the chunk's decay product and local end state, float32
//      scratch [B, NC, Dr] each (8.4 MB at that shape).
//   2. carry_kernel: per (batch, channel pair), the chunk starts in order
//      from h0, s_{c+1} = A_c s_c + H_c, written over the decay products.
//   3. scan_kernel: each (batch, chunk, channel pair) again, step by step
//      from its start, writing h; the last chunk writes h_last.
// That is ~0.5 M threads at that shape; the inputs are read twice, so the
// design's own floor is ~0.28 ms.  A thread takes two adjacent channels
// (one 4-byte bf16x2 or 8-byte float2 load a tensor a step: a warp reads
// 128 or 256 contiguous bytes), and loads kUnroll steps ahead of their
// updates.  When T fits one chunk (decode's T = 1) the scan kernel alone
// runs, from h0.  No atomics: two calls give equal bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 64;     // steps a chunk walks (ref.py CHUNK)
constexpr int kUnroll = 8;     // steps whose inputs load before their updates
constexpr int kThreads = 128;  // channel pairs a block
constexpr float kC = 8.0f;     // LRU_C

struct Args {
  const void* x;
  const void* r;
  const void* i;
  long long sx[2], sr[2], si[2];  // element strides: batch, time
  const float* lam;               // [Dr]
  const float* h0;                // [B, Dr]
  void* h;                        // [B, T, Dr] contiguous, x's type
  float* h_last;                  // [B, Dr]
  float* decay;                   // [B, NC, Dr]: decay products, then chunk starts
  float* local;                   // [B, NC, Dr]: local end states (slots 0..NC-2)
  int T, Dr, NC;
};

template <typename T>
struct Pair;

template <>
struct Pair<float> {
  static __device__ __forceinline__ float2 load(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  static __device__ __forceinline__ void store(float* p, float2 v) {
    *reinterpret_cast<float2*>(p) = v;
  }
  static __device__ __forceinline__ float mul(float a, float b) { return a * b; }
};

template <>
struct Pair<__nv_bfloat16> {
  static __device__ __forceinline__ float2 load(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float2 v) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v.x, v.y);
  }
  // i * x in bf16: the float product of two bf16 values is exact; round it once
  static __device__ __forceinline__ float mul(float a, float b) {
    return __bfloat162float(__float2bfloat16_rn(a * b));
  }
};

__device__ __forceinline__ float log_sigmoid(float v) {
  return fminf(v, 0.f) - log1pf(expf(-fabsf(v)));
}

// One step's coefficients for one channel: h <- a h + b.
template <typename T>
__device__ __forceinline__ void coeff(float r, float ig, float x, float lsl, float* a, float* b) {
  const float log_a = kC * r * lsl;
  *a = expf(log_a);
  const float beta = sqrtf(fmaxf(1.f - expf(2.f * log_a), 1e-12f));
  *b = beta * Pair<T>::mul(ig, x);
}

// Walks steps [s0, s1) of batch row b, channels (d, d + 1), from h.  kPass
// 1 also multiplies the decays into `decay`; kPass 3 writes each h to `out`.
template <typename T, int kPass>
__device__ __forceinline__ void walk(const Args& a, int b, int d, int s0, int s1, float2 lsl,
                                     float2* h, float2* decay) {
  const T* xp = static_cast<const T*>(a.x) + b * a.sx[0] + d;
  const T* rp = static_cast<const T*>(a.r) + b * a.sr[0] + d;
  const T* ip = static_cast<const T*>(a.i) + b * a.si[0] + d;
  T* op = static_cast<T*>(a.h) + (long long)b * a.T * a.Dr + d;
  for (int s = s0; s < s1; s += kUnroll) {
    float2 xv[kUnroll], rv[kUnroll], iv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (s + u < s1) {
        xv[u] = Pair<T>::load(xp + (long long)(s + u) * a.sx[1]);
        rv[u] = Pair<T>::load(rp + (long long)(s + u) * a.sr[1]);
        iv[u] = Pair<T>::load(ip + (long long)(s + u) * a.si[1]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (s + u < s1) {
        float a0, b0, a1, b1;
        coeff<T>(rv[u].x, iv[u].x, xv[u].x, lsl.x, &a0, &b0);
        coeff<T>(rv[u].y, iv[u].y, xv[u].y, lsl.y, &a1, &b1);
        h->x = fmaf(a0, h->x, b0);
        h->y = fmaf(a1, h->y, b1);
        if (kPass == 1) {
          decay->x *= a0;
          decay->y *= a1;
        }
        if (kPass == 3) Pair<T>::store(op + (long long)(s + u) * a.Dr, *h);
      }
    }
  }
}

__device__ __forceinline__ float2 lsl_pair(const Args& a, int d) {
  const float2 lam = *reinterpret_cast<const float2*>(a.lam + d);
  return make_float2(log_sigmoid(lam.x), log_sigmoid(lam.y));
}

// Pass 1: grid (channel-pair blocks, NC - 1, B).
template <typename T>
__global__ void __launch_bounds__(kThreads) chunk_kernel(const Args a) {
  const int d = 2 * (blockIdx.x * kThreads + threadIdx.x);
  if (d >= a.Dr) return;
  const int c = blockIdx.y, b = blockIdx.z;
  float2 h = make_float2(0.f, 0.f), decay = make_float2(1.f, 1.f);
  walk<T, 1>(a, b, d, c * kChunk, (c + 1) * kChunk, lsl_pair(a, d), &h, &decay);
  const long long o = ((long long)b * a.NC + c) * a.Dr + d;
  *reinterpret_cast<float2*>(a.decay + o) = decay;
  *reinterpret_cast<float2*>(a.local + o) = h;
}

// Pass 2: grid (channel-pair blocks, B).  Chunk c's start goes over its
// decay product, once that is read.
__global__ void __launch_bounds__(kThreads) carry_kernel(const Args a) {
  const int d = 2 * (blockIdx.x * kThreads + threadIdx.x);
  if (d >= a.Dr) return;
  const int b = blockIdx.y;
  float2 h = *reinterpret_cast<const float2*>(a.h0 + (long long)b * a.Dr + d);
  for (int c = 0; c < a.NC; ++c) {
    float2* slot = reinterpret_cast<float2*>(a.decay + ((long long)b * a.NC + c) * a.Dr + d);
    if (c + 1 < a.NC) {
      const float2 dec = *slot;
      const float2 loc = *reinterpret_cast<const float2*>(a.local + ((long long)b * a.NC + c) * a.Dr + d);
      *slot = h;
      h = make_float2(fmaf(dec.x, h.x, loc.x), fmaf(dec.y, h.y, loc.y));
    } else {
      *slot = h;
    }
  }
}

// Pass 3: grid (channel-pair blocks, NC, B).  Starts from the carried
// starts, or from h0 when there is one chunk.
template <typename T>
__global__ void __launch_bounds__(kThreads) scan_kernel(const Args a) {
  const int d = 2 * (blockIdx.x * kThreads + threadIdx.x);
  if (d >= a.Dr) return;
  const int c = blockIdx.y, b = blockIdx.z;
  const float* starts = a.NC == 1 ? a.h0 : a.decay;  // row stride NC * Dr either way
  float2 h = *reinterpret_cast<const float2*>(starts + ((long long)b * a.NC + c) * a.Dr + d);
  walk<T, 3>(a, b, d, c * kChunk, min((c + 1) * kChunk, a.T), lsl_pair(a, d), &h, nullptr);
  if (c + 1 == a.NC) *reinterpret_cast<float2*>(a.h_last + (long long)b * a.Dr + d) = h;
}

template <typename T>
int launch(const Args& a, int batch, cudaStream_t st) {
  const unsigned pairs = static_cast<unsigned>((a.Dr / 2 + kThreads - 1) / kThreads);
  if (a.NC > 1) {
    chunk_kernel<T><<<dim3(pairs, a.NC - 1, batch), kThreads, 0, st>>>(a);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    carry_kernel<<<dim3(pairs, batch), kThreads, 0, st>>>(a);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  scan_kernel<T><<<dim3(pairs, a.NC, batch), kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Runs the scan on `stream`; returns 0 on success, else the cudaError_t of
// the first launch refused.  x, r, i: [B, T, Dr], float32 (is_bf16 = 0) or
// bf16, the last dimension contiguous, Dr even, pointers and the batch and
// time strides (elements, strides = {x: b, t; r: b, t; i: b, t}) aligned
// for two-element loads.  lam [Dr], h0 and h_last [B, Dr]: contiguous
// float32, 8-byte aligned.  h [B, T, Dr] contiguous in x's type.  With
// more than one chunk of 64 steps, decay and local are float32 scratch of
// [B, ceil(T / 64), Dr] each; otherwise they may be null.
int repro_rglru_scan(int device, int is_bf16, const void* x, const void* r, const void* i,
                     const long long* strides, const void* lam, const void* h0, void* h,
                     void* h_last, void* decay, void* local, int batch, int T, int Dr,
                     void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  Args a;
  a.x = x;
  a.r = r;
  a.i = i;
  for (int k = 0; k < 2; ++k) {
    a.sx[k] = strides[k];
    a.sr[k] = strides[2 + k];
    a.si[k] = strides[4 + k];
  }
  a.lam = static_cast<const float*>(lam);
  a.h0 = static_cast<const float*>(h0);
  a.h = h;
  a.h_last = static_cast<float*>(h_last);
  a.decay = static_cast<float*>(decay);
  a.local = static_cast<float*>(local);
  a.T = T;
  a.Dr = Dr;
  a.NC = (T + kChunk - 1) / kChunk;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(a, batch, st) : launch<float>(a, batch, st);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
