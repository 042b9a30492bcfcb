// RWKV6 WKV recurrence for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rwkv6_wkv/kernel.py
// (`wkv6_fwd`, body `_wkv_kernel`) and computes what it computes, per batch
// b and head h, with an N x N float32 state S[i][j] (i the key index):
//   y_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//          = sum_i r_t[i] * S[i][j]  +  v_t[j] * sum_i r_t[i] * u[i] * k_t[i]
//   S[i][j] <- S[i][j] * w_t[i] + k_t[i] * v_t[j]
// starting from state0 and writing the final state.  r, k, v (one type,
// bf16 or float32) and w (bf16 or float32) are widened to float32; the
// output y is float32 [B, T, H, N], as the TPU kernel's.
//
// Design.  The TPU grid (B, H, T / chunk) runs its time axis in order and
// carries S in VMEM scratch from chunk to chunk.  Here one thread block per
// (head, batch) carries S through all T steps in a loop, so nothing has to
// carry over between blocks.  The block has N threads; thread j owns column
// j of the state, S[:, j], as N float32 registers.  Each step:
//   1. thread j stages {r_t[j], k_t[j], w_t[j], u[j] * k_t[j]} into shared
//      memory as one float4; the buffer alternates between two, so a single
//      __syncthreads a step keeps a fast thread from overwriting what a slow
//      one still reads;
//   2. it issues the loads of step t + 1 into registers, to land while it
//      computes step t;
//   3. it reads the staged float4 of every i (a broadcast: all threads read
//      the same address), forms y_t[j] and updates its column;
//   4. it writes y_t[j]; after the last step, its column of the final state.
// No atomics and a fixed order of sums: the result is the same on every run.
// The final state may alias state0 (decode updates its cache in place):
// thread j reads column j before the loop and writes it after, and no
// other thread touches it.  The inputs come in through element strides for
// batch, time and head (the last dimension contiguous), so the model's
// projections go in with no copy.
//
// What bounds it on the H100.  At the serving path's prefill shape (B=4,
// T=4096, H=64, N=64; r, k, v bf16, w and y float32) it must move 14 B per
// (b, t, h, n) element, 940 MB, ~0.28 ms at 3.35 TB/s, and do 4 N^2 float32
// operations per (b, t, h), 17.2 GFLOP, ~0.26 ms at 67 TFLOP/s: the floor
// is memory.  This first kernel does not reach it.  The grid is only
// B * H = 256 blocks of 64 threads (about two a streaming multiprocessor)
// over 4096 dependent steps, so each step's latency (the shared-memory
// barrier, the load of the next step, a chain of N FMAs per thread) is paid
// in series: it is latency-bound.  What it leaves for a later design:
// staging whole time chunks through shared memory with asynchronous copies,
// several threads per column, or the chunked matrix form of the recurrence
// on the tensor cores.  Its measured times stand beside the bound in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

struct Args {
  const void* r;
  const void* k;
  const void* v;
  const void* w;
  const float* u;  // [H, N]
  const float* s0;  // [B, H, N, N]; may alias sout
  float* out;       // [B, T, H, N]
  float* sout;      // [B, H, N, N]
  long long sr[3], sk[3], sv[3], sw[3];  // element strides: batch, time, head
  int T, H;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <int N, typename TI, typename TW>
__global__ void __launch_bounds__(N) wkv6_kernel(const Args a) {
  const int j = threadIdx.x;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const long long bh = static_cast<long long>(b) * a.H + h;

  const TI* rp = static_cast<const TI*>(a.r) + b * a.sr[0] + h * a.sr[2] + j;
  const TI* kp = static_cast<const TI*>(a.k) + b * a.sk[0] + h * a.sk[2] + j;
  const TI* vp = static_cast<const TI*>(a.v) + b * a.sv[0] + h * a.sv[2] + j;
  const TW* wp = static_cast<const TW*>(a.w) + b * a.sw[0] + h * a.sw[2] + j;
  const long long o_stride = static_cast<long long>(a.H) * N;  // out [B, T, H, N]: one time step
  float* op = a.out + static_cast<long long>(b) * a.T * o_stride + h * N + j;  // + t * o_stride

  __shared__ float4 stage[2][N];  // {r_i, k_i, w_i, u_i * k_i}

  float S[N];
  const float* s0 = a.s0 + bh * N * N + j;
#pragma unroll
  for (int i = 0; i < N; ++i) S[i] = s0[i * N];
  const float uj = a.u[h * N + j];

  float rn = to_f(rp[0]), kn = to_f(kp[0]), vn = to_f(vp[0]), wn = to_f(wp[0]);
  for (int t = 0; t < a.T; ++t) {
    const int buf = t & 1;
    const float vj = vn;
    stage[buf][j] = make_float4(rn, kn, wn, uj * kn);
    __syncthreads();
    if (t + 1 < a.T) {
      const long long n = t + 1;
      rn = to_f(rp[n * a.sr[1]]);
      kn = to_f(kp[n * a.sk[1]]);
      vn = to_f(vp[n * a.sv[1]]);
      wn = to_f(wp[n * a.sw[1]]);
    }
    // two partial sums each: shorter dependent chains
    float y0 = 0.f, y1 = 0.f, ruk0 = 0.f, ruk1 = 0.f;
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      const float4 e0 = stage[buf][i];
      const float4 e1 = stage[buf][i + 1];
      y0 = fmaf(e0.x, S[i], y0);
      y1 = fmaf(e1.x, S[i + 1], y1);
      ruk0 = fmaf(e0.x, e0.w, ruk0);
      ruk1 = fmaf(e1.x, e1.w, ruk1);
      S[i] = fmaf(S[i], e0.z, e0.y * vj);
      S[i + 1] = fmaf(S[i + 1], e1.z, e1.y * vj);
    }
    op[t * o_stride] = fmaf(vj, ruk0 + ruk1, y0 + y1);
  }

  float* so = a.sout + bh * N * N + j;
#pragma unroll
  for (int i = 0; i < N; ++i) so[i * N] = S[i];
}

template <int N, typename TI>
cudaError_t launch_n(const Args& a, int w_bf16, int B, cudaStream_t st) {
  const dim3 grid(a.H, B);
  if (w_bf16)
    wkv6_kernel<N, TI, __nv_bfloat16><<<grid, N, 0, st>>>(a);
  else
    wkv6_kernel<N, TI, float><<<grid, N, 0, st>>>(a);
  return cudaGetLastError();
}

template <typename TI>
cudaError_t launch_t(const Args& a, int N, int w_bf16, int B, cudaStream_t st) {
  switch (N) {
    case 8: return launch_n<8, TI>(a, w_bf16, B, st);
    case 16: return launch_n<16, TI>(a, w_bf16, B, st);
    case 32: return launch_n<32, TI>(a, w_bf16, B, st);
    case 64: return launch_n<64, TI>(a, w_bf16, B, st);
    case 128: return launch_n<128, TI>(a, w_bf16, B, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// out [B, T, H, N] float32 and the final state [B, H, N, N] float32 (sout,
// which may be s0 itself) of the WKV6 recurrence from state s0, on
// `stream`.  r, k, v are float32 (rkv_bf16 = 0) or bf16, w likewise
// (w_bf16); `strides` holds 12 element strides (batch, time, head of r, k,
// v, w; the last dimension contiguous).  N is one of 8, 16, 32, 64, 128.
// Returns cudaGetLastError() of the launch (0 on success).
int repro_wkv6_fwd(int device, int rkv_bf16, int w_bf16, int N, const void* r, const void* k,
                   const void* v, const void* w, const void* u, const void* s0, void* out,
                   void* sout, const long long* strides, int B, int T, int H, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  Args a;
  a.r = r;
  a.k = k;
  a.v = v;
  a.w = w;
  a.u = static_cast<const float*>(u);
  a.s0 = static_cast<const float*>(s0);
  a.out = static_cast<float*>(out);
  a.sout = static_cast<float*>(sout);
  for (int d = 0; d < 3; ++d) {
    a.sr[d] = strides[d];
    a.sk[d] = strides[3 + d];
    a.sv[d] = strides[6 + d];
    a.sw[d] = strides[9 + d];
  }
  a.T = T;
  a.H = H;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  e = rkv_bf16 ? launch_t<__nv_bfloat16>(a, N, w_bf16, B, st) : launch_t<float>(a, N, w_bf16, B, st);
  return static_cast<int>(e);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
