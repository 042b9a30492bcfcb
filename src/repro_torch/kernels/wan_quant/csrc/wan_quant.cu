// Per-block int8 absmax quantisation of the WAN hop, for Hopper (sm_90a),
// hand-written CUDA C++.
//
// Replaces the Pallas TPU kernels src/repro/kernels/wan_quant/kernel.py
// `wan_quant` (body `_quant_kernel`) and `wan_dequant` (`_dequant_kernel`),
// and computes what they and repro/distributed/compression.py::int8_compress
// compute, bit for bit:
//   x     = input widened to float32 (bf16 input is widened first)
//   scale = absmax > 0 ? absmax / 127 : 1        per 256-lane block of a row
//   q     = clamp(round_half_even(x / scale), -127, 127)  as int8
//   back  = float(q) * scale
// Bit-exactness rests on three choices: x / scale is an IEEE division (not a
// multiply by the reciprocal), rintf rounds half to even as jnp.round does,
// and the file is built without --use_fast_math (which would turn both
// divisions approximate).
//
// Lanes past a row's last column are zero padding up to a multiple of 256,
// as jnp.pad makes them: they never move the absmax, their int8 is 0, and
// dequantisation writes only the real columns.  So a leaf of any last
// dimension goes in with no padded copy, and comes back at its own width.
//
// Design.  One warp per 256-lane block (a row of the TPU kernel's
// (row_tile x 256) tile): each lane holds 8 values, strided by 32 so that
// every load and store of the warp is one contiguous run; a shuffle
// reduction gives the absmax.  Dequantisation uses the same mapping.  The
// TPU kernel's sequential grid carries nothing, so blocks need no order.
//
// What bounds it on the H100: bytes.  Over the stacked 2-pod gradient of
// distilgpt2-82m (2 x 81,126,144 float32 values) quantisation reads 649 MB
// and writes 162 MB of int8 and 2.5 MB of scales: ~0.24 ms at 3.35 TB/s;
// dequantisation moves the same bytes the other way.  Its operations (one
// division per value) are far below the card's rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;             // lanes per scale (the wire format)
constexpr int kPerLane = kBlock / 32;   // values each lane of a warp holds
constexpr int kWarpsPerCta = 8;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void __launch_bounds__(kWarpsPerCta * 32)
    quant_kernel(const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ s,
                 long long rows, int cols, int nblocks) {
  const long long w = (long long)blockIdx.x * kWarpsPerCta + (threadIdx.x >> 5);
  if (w >= rows * nblocks) return;
  const int lane = threadIdx.x & 31;
  const long long row = w / nblocks;
  const int c0 = static_cast<int>(w % nblocks) * kBlock;
  const T* xr = x + row * cols;
  float v[kPerLane];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int c = c0 + i * 32 + lane;
    v[i] = c < cols ? to_f(xr[c]) : 0.f;
    amax = fmaxf(amax, fabsf(v[i]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float scale = amax > 0.f ? amax / 127.0f : 1.0f;
  int8_t* qr = q + row * (long long)nblocks * kBlock + c0;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const float r = fminf(fmaxf(rintf(v[i] / scale), -127.f), 127.f);
    qr[i * 32 + lane] = static_cast<int8_t>(r);
  }
  if (lane == 0) s[w] = scale;
}

__global__ void __launch_bounds__(kWarpsPerCta * 32)
    dequant_kernel(const int8_t* __restrict__ q, const float* __restrict__ s,
                   float* __restrict__ out, long long rows, int cols, int nblocks) {
  const long long w = (long long)blockIdx.x * kWarpsPerCta + (threadIdx.x >> 5);
  if (w >= rows * nblocks) return;
  const int lane = threadIdx.x & 31;
  const long long row = w / nblocks;
  const int c0 = static_cast<int>(w % nblocks) * kBlock;
  const float scale = s[w];
  const int8_t* qr = q + row * (long long)nblocks * kBlock + c0;
  float* orow = out + row * cols;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int c = c0 + i * 32 + lane;
    if (c < cols) orow[c] = static_cast<float>(qr[i * 32 + lane]) * scale;
  }
}

unsigned grid_for(long long rows, int nblocks) {
  return static_cast<unsigned>((rows * nblocks + kWarpsPerCta - 1) / kWarpsPerCta);
}

}  // namespace

extern "C" {

// Quantises a contiguous [rows, cols] float32 (is_bf16 = 0) or bf16 matrix
// into int8 q [rows, nblocks * 256] and float32 scales [rows, nblocks],
// nblocks = ceil(cols / 256), on `stream`.  Returns cudaGetLastError() of
// the launch (0 on success).
int repro_wan_quant(int device, int is_bf16, const void* x, void* q, void* s, long long rows,
                    int cols, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int nblocks = (cols + kBlock - 1) / kBlock;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = grid_for(rows, nblocks);
  if (is_bf16)
    quant_kernel<<<grid, kWarpsPerCta * 32, 0, st>>>(static_cast<const __nv_bfloat16*>(x),
                                                     static_cast<int8_t*>(q),
                                                     static_cast<float*>(s), rows, cols, nblocks);
  else
    quant_kernel<<<grid, kWarpsPerCta * 32, 0, st>>>(static_cast<const float*>(x),
                                                     static_cast<int8_t*>(q),
                                                     static_cast<float*>(s), rows, cols, nblocks);
  return static_cast<int>(cudaGetLastError());
}

// out [rows, cols] float32 = q * scale, from q [rows, nblocks * 256] int8 and
// scales [rows, nblocks]; the padding lanes are not written.
int repro_wan_dequant(int device, const void* q, const void* s, void* out, long long rows,
                      int cols, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int nblocks = (cols + kBlock - 1) / kBlock;
  dequant_kernel<<<grid_for(rows, nblocks), kWarpsPerCta * 32, 0,
                   static_cast<cudaStream_t>(stream)>>>(static_cast<const int8_t*>(q),
                                                        static_cast<const float*>(s),
                                                        static_cast<float*>(out), rows, cols,
                                                        nblocks);
  return static_cast<int>(cudaGetLastError());
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
