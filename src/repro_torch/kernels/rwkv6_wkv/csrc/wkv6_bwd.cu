// The gradient of the RWKV6 WKV recurrence for Hopper (sm_90a), hand-written CUDA C++.
//
// No TPU counterpart: the JAX package trains RWKV6 through jax.grad of
// repro.models.rwkv6._wkv_with_initial_state (a lax.scan over time,
// jax.checkpoint-ed in chunks of WKV_CHUNK = 256 steps), and the port's
// tests hold this kernel's plain version to that gradient.  Per batch b and
// head h, with the forward (wkv6.cu)
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T,   y_t = S_{t-1}^T r_t + (r_t . (u * k_t)) v_t
// and G_t = dL/dS_t (G_T = dstate, zeros when absent), going back in time:
//   H_t[i][j] = G_t[i][j] + u_i r_t[i] dy_t[j]
//   dr_t[i] = sum_j dy_t[j] S_{t-1}[i][j] + u_i k_t[i] (v_t . dy_t)
//   dk_t[i] = sum_j H_t[i][j] v_t[j]
//   dv_t[j] = sum_i H_t[i][j] k_t[i]
//   dw_t[i] = sum_j G_t[i][j] S_{t-1}[i][j]
//   du_i   += r_t[i] k_t[i] (v_t . dy_t)          (over b and t)
//   G_{t-1} = diag(w_t) G_t + r_t dy_t^T,   dstate0 = G_0
// S_{t-1} is recomputed forward from the state the forward saved before
// each chunk of C steps (`bounds`), never rebuilt backward as
// (S_t - k_t v_t^T) / w_t: RWKV6's w = exp(-exp(.)) reaches ~0 and the
// division overflows.  That is the schedule of JAX's checkpointed chunks.
//
// What bounds it on the H100.  At the path shape (B=4, T=4096, H=64,
// N=64; r, k, v bf16, w and dy float32 in; dr, dk, dv bf16 and dw float32
// out) the bytes are 24 B per (b, t, h, n) element plus the saved states,
// ~1.68 GB, 0.50 ms at 3.35 TB/s.  The operations are ~15 float32
// operations per state element and step (the recomputed forward 3, dr 2,
// H 2, dk 2, dv 1, dw 2, G 3), 64 GFLOP, 0.96 ms at 67 TFLOP/s without the
// tensor cores: it is bound by operations, and in practice by instruction
// issue and latency, since the recurrence is sequential in t.
//
// What the design does about it, simply (speed is later work).  The rows
// i of the state are independent in every recurrence but dv's sum over i,
// so a block owns RB rows of one (b, h) (grid: row groups x H x B; 1024
// blocks at the path shape) and threads own E = 4 adjacent columns of one
// row, both S and G in registers; the row sums (dr, dk, dw, v . dy) are
// shuffles among the N / E lanes of a row.  Per chunk, backward in time:
//   A. from the saved state, the state before each 16-step sub-chunk is
//      recomputed into shared memory (C / 16 tiles);
//   B. per sub-chunk, backward: its inputs staged in shared memory as
//      float32, its 16 states S_{t-1} recomputed into a shared-memory
//      history, then the 16 steps run backward, each thread overwriting
//      its history entries with its H k terms, which the block then sums
//      over its rows in a fixed order into a per-row-group dv partial.
// A second kernel sums the row groups' dv partials and the per-(b, h) du
// partials in a fixed order: no atomics, the same bits on every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int L = 16;  // steps a sub-chunk

template <int N>
struct Shape {
  static constexpr int E = N == 8 ? 2 : 4;                           // columns a thread owns
  static constexpr int RB = N == 64 ? 16 : (N == 128 ? 8 : N);       // rows a block owns
  static constexpr int Q = N / E;                                    // lanes sharing a row
  static constexpr int kThreads = RB * Q;
  static constexpr int kGroups = N / RB;
  static constexpr int kTile = RB * N;
  static_assert(Q <= 32 && 32 % Q == 0 && kThreads % 32 == 0, "a row's lanes lie in one warp");
};

struct Args {
  const void* r;
  const void* k;
  const void* v;
  const void* w;
  const float* u;       // [H, N]
  const float* bounds;  // [B, ceil(T / chunk), H, N, N]
  const float* dy;      // [B, T, H, N]
  const float* dstate;  // [B, H, N, N] or null
  void* dr;
  void* dk;
  void* dw;
  float* dstate0;   // [B, H, N, N]
  float* dv_parts;  // [groups, B, T, H, N]
  float* du_parts;  // [B, H, N]
  int B, T, H, chunk;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <int Q>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = Q / 2; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// E adjacent floats of shared memory as one 8- or 16-byte access
template <int E>
__device__ __forceinline__ void load_e(const float* p, float (&x)[E]) {
  if constexpr (E == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    x[0] = q.x, x[1] = q.y, x[2] = q.z, x[3] = q.w;
  } else {
    const float2 q = *reinterpret_cast<const float2*>(p);
    x[0] = q.x, x[1] = q.y;
  }
}
template <int E>
__device__ __forceinline__ void store_e(float* p, const float (&x)[E]) {
  if constexpr (E == 4)
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  else
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
}

template <int N>
size_t smem_bytes(int chunk) {
  using Sh = Shape<N>;
  return (size_t(chunk / L + L) * Sh::kTile + size_t(L) * (3 * Sh::RB + 2 * N)) * sizeof(float);
}

template <int N, typename TI, typename TW>
__global__ void __launch_bounds__(Shape<N>::kThreads) wkv6_bwd_kernel(const Args a) {
  using Sh = Shape<N>;
  constexpr int E = Sh::E, RB = Sh::RB, Q = Sh::Q, kTile = Sh::kTile, kThreads = Sh::kThreads;
  extern __shared__ __align__(16) float smem[];
  const int C = a.chunk, T = a.T, H = a.H;
  float* slots = smem;                 // [C / L][kTile]: the state before each sub-chunk
  float* hist = slots + (C / L) * kTile;  // [L][kTile]: S_{t-1}, then H_t k_t
  float* rs = hist + L * kTile;        // staged inputs, float32: [L][RB] r, k, w of the rows
  float* ks = rs + L * RB;
  float* ws = ks + L * RB;
  float* vs = ws + L * RB;             // [L][N] v and dy
  float* dys = vs + L * N;

  const int tid = threadIdx.x, row = tid / Q, cq = tid % Q, col0 = cq * E;
  const int g = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int i = g * RB + row;  // the state row this thread works on
  const long long bh = static_cast<long long>(b) * H + h;
  const float ui = a.u[h * N + i];
  const TI* r = static_cast<const TI*>(a.r);
  const TI* k = static_cast<const TI*>(a.k);
  const TI* v = static_cast<const TI*>(a.v);
  const TW* w = static_cast<const TW*>(a.w);
  auto at = [&](int t) { return ((static_cast<long long>(b) * T + t) * H + h) * N; };  // [b, t, h, 0]

  // steps [t0, t0 + nt) of the inputs into shared memory, as float32
  auto stage = [&](int t0, int nt) {
    __syncthreads();  // every thread is done with the previous sub-chunk's
    constexpr int kRow = 3 * RB + 2 * N;
    for (int idx = tid; idx < nt * kRow; idx += kThreads) {
      const int t = idx / kRow, e = idx - t * kRow;
      const long long base = at(t0 + t);
      if (e < RB) rs[t * RB + e] = to_f(r[base + g * RB + e]);
      else if (e < 2 * RB) ks[t * RB + e - RB] = to_f(k[base + g * RB + e - RB]);
      else if (e < 3 * RB) ws[t * RB + e - 2 * RB] = to_f(w[base + g * RB + e - 2 * RB]);
      else if (e < 3 * RB + N) vs[t * N + e - 3 * RB] = to_f(v[base + e - 3 * RB]);
      else dys[t * N + e - 3 * RB - N] = a.dy[base + e - 3 * RB - N];
    }
    __syncthreads();
  };

  float G[E], S[E];
  const long long mine = (bh * N + i) * N + col0;  // this thread's elements of a [B, H, N, N] state
#pragma unroll
  for (int e = 0; e < E; ++e) G[e] = a.dstate ? a.dstate[mine + e] : 0.f;
  float du = 0.f;
  const int nc = (T + C - 1) / C;
  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * C, tc = min(C, T - t0), nsub = (tc + L - 1) / L;
    const float* saved = a.bounds + (static_cast<long long>(b) * nc + c) * H * N * N + h * N * N + i * N + col0;
#pragma unroll
    for (int e = 0; e < E; ++e) S[e] = saved[e];
    // A: the state before each sub-chunk of this chunk
    for (int s = 0; s < nsub; ++s) {
      store_e<E>(slots + s * kTile + tid * E, S);
      if (s == nsub - 1) break;
      stage(t0 + s * L, L);
      for (int t = 0; t < L; ++t) {
        const float kk = ks[t * RB + row], ww = ws[t * RB + row];
        float vj[E];
        load_e<E>(vs + t * N + col0, vj);
#pragma unroll
        for (int e = 0; e < E; ++e) S[e] = fmaf(S[e], ww, kk * vj[e]);
      }
    }
    // B: the sub-chunks, last first
    for (int s = nsub - 1; s >= 0; --s) {
      const int ts = t0 + s * L, nt = min(L, tc - s * L);
      stage(ts, nt);
      load_e<E>(slots + s * kTile + tid * E, S);
      for (int t = 0; t < nt; ++t) {  // forward: S_{t-1} into the history; dr
        const float rr = rs[t * RB + row], kk = ks[t * RB + row], ww = ws[t * RB + row];
        float vj[E], dj[E], sdy = 0.f, vdy = 0.f;
        load_e<E>(vs + t * N + col0, vj);
        load_e<E>(dys + t * N + col0, dj);
        store_e<E>(hist + t * kTile + tid * E, S);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          sdy = fmaf(S[e], dj[e], sdy);
          vdy = fmaf(vj[e], dj[e], vdy);
          S[e] = fmaf(S[e], ww, kk * vj[e]);
        }
        sdy = row_sum<Q>(sdy);
        vdy = row_sum<Q>(vdy);
        if (cq == 0) from_f(static_cast<TI*>(a.dr) + at(ts + t) + i, fmaf(ui * kk, vdy, sdy));
        du = fmaf(rr * kk, vdy, du);
      }
      for (int t = nt - 1; t >= 0; --t) {  // backward: dk, dw, the dv terms, G
        float* hp = hist + t * kTile + tid * E;
        const float rr = rs[t * RB + row], kk = ks[t * RB + row], ww = ws[t * RB + row];
        const float ur = ui * rr;
        float vj[E], dj[E], sp[E], hk[E], gv = 0.f, gs = 0.f;
        load_e<E>(vs + t * N + col0, vj);
        load_e<E>(dys + t * N + col0, dj);
        load_e<E>(hp, sp);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float hij = fmaf(ur, dj[e], G[e]);
          gv = fmaf(hij, vj[e], gv);
          gs = fmaf(G[e], sp[e], gs);
          hk[e] = hij * kk;
          G[e] = fmaf(G[e], ww, rr * dj[e]);
        }
        store_e<E>(hp, hk);
        gv = row_sum<Q>(gv);
        gs = row_sum<Q>(gs);
        if (cq == 0) {
          from_f(static_cast<TI*>(a.dk) + at(ts + t) + i, gv);
          from_f(static_cast<TW*>(a.dw) + at(ts + t) + i, gs);
        }
      }
      __syncthreads();
      // this row group's share of dv: the H k terms summed over its rows in order
      float* parts = a.dv_parts + static_cast<long long>(g) * a.B * T * H * N;
      for (int idx = tid; idx < nt * N; idx += kThreads) {
        const int t = idx / N, j = idx - t * N;
        float acc = 0.f;
#pragma unroll 4
        for (int q = 0; q < RB; ++q) acc += hist[t * kTile + q * N + j];
        parts[at(ts + t) + j] = acc;
      }
    }
  }
#pragma unroll
  for (int e = 0; e < E; ++e) a.dstate0[mine + e] = G[e];
  if (cq == 0) a.du_parts[bh * N + i] = du;
}

// dv = the row groups' partials summed in order; du = the batch's partials
// summed in order.
template <typename TI>
__global__ void wkv6_bwd_finish(const float* dv_parts, TI* dv, long long n, int groups, const float* du_parts,
                                float* du, int B, int hn) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (long long x = first; x < n; x += stride) {
    float acc = dv_parts[x];
    for (int q = 1; q < groups; ++q) acc += dv_parts[q * n + x];
    from_f(dv + x, acc);
  }
  for (long long x = first; x < hn; x += stride) {
    float acc = du_parts[x];
    for (int q = 1; q < B; ++q) acc += du_parts[q * static_cast<long long>(hn) + x];
    du[x] = acc;
  }
}

template <int N, typename TI, typename TW>
cudaError_t launch_w(const Args& a, void* dv, float* du, cudaStream_t st) {
  auto kernel = wkv6_bwd_kernel<N, TI, TW>;
  const size_t smem = smem_bytes<N>(a.chunk);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                       cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess && smem > 48 * 1024)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kernel<<<dim3(Shape<N>::kGroups, a.H, a.B), Shape<N>::kThreads, smem, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long n = static_cast<long long>(a.B) * a.T * a.H * N;
  const long long blocks = (n + 255) / 256;
  wkv6_bwd_finish<TI><<<static_cast<unsigned>(blocks < 132 * 32 ? blocks : 132 * 32), 256, 0, st>>>(
      a.dv_parts, static_cast<TI*>(dv), n, Shape<N>::kGroups, a.du_parts, du, a.B, a.H * N);
  return cudaGetLastError();
}

template <int N, typename TI>
cudaError_t launch_n(const Args& a, int w_bf16, void* dv, float* du, cudaStream_t st) {
  return w_bf16 ? launch_w<N, TI, __nv_bfloat16>(a, dv, du, st) : launch_w<N, TI, float>(a, dv, du, st);
}

template <typename TI>
cudaError_t launch_t(const Args& a, int N, int w_bf16, void* dv, float* du, cudaStream_t st) {
  switch (N) {
    case 8: return launch_n<8, TI>(a, w_bf16, dv, du, st);
    case 16: return launch_n<16, TI>(a, w_bf16, dv, du, st);
    case 32: return launch_n<32, TI>(a, w_bf16, dv, du, st);
    case 64: return launch_n<64, TI>(a, w_bf16, dv, du, st);
    case 128: return launch_n<128, TI>(a, w_bf16, dv, du, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Row groups a (b, h) is split into at head dim N: the leading dimension of
// repro_wkv6_bwd's dv_parts.  0 for an N the kernel does not take.
int repro_wkv6_bwd_groups(int N) {
  switch (N) {
    case 8: return Shape<8>::kGroups;
    case 16: return Shape<16>::kGroups;
    case 32: return Shape<32>::kGroups;
    case 64: return Shape<64>::kGroups;
    case 128: return Shape<128>::kGroups;
    default: return 0;
  }
}

// The gradient of repro_wkv6_fwd, on `stream`.  r, k, v (one type, bf16 if
// rkv_bf16) and w (bf16 if w_bf16) are contiguous [B, T, H, N]; u [H, N],
// bounds [B, ceil(T / chunk), H, N, N] (the forward's saved states), dy
// [B, T, H, N] and dstate [B, H, N, N] (null: zeros) float32.  Writes dr,
// dk, dv (r's type), dw (w's type), du [H, N] and dstate0 [B, H, N, N]
// float32, through the scratch dv_parts [groups, B, T, H, N] and du_parts
// [B, H, N] float32.  chunk is a multiple of 16 up to 256; N one of 8, 16,
// 32, 64, 128.  Returns cudaGetLastError() of the launches (0 on success).
int repro_wkv6_bwd(int device, int rkv_bf16, int w_bf16, int N, const void* r, const void* k, const void* v,
                   const void* w, const void* u, const void* bounds, const void* dy, const void* dstate,
                   void* dr, void* dk, void* dv, void* dw, void* du, void* dstate0, void* dv_parts,
                   void* du_parts, int B, int T, int H, int chunk, void* stream) {
  if (chunk < L || chunk % L != 0 || chunk > 256) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  Args a;
  a.r = r;
  a.k = k;
  a.v = v;
  a.w = w;
  a.u = static_cast<const float*>(u);
  a.bounds = static_cast<const float*>(bounds);
  a.dy = static_cast<const float*>(dy);
  a.dstate = static_cast<const float*>(dstate);
  a.dr = dr;
  a.dk = dk;
  a.dw = dw;
  a.dstate0 = static_cast<float*>(dstate0);
  a.dv_parts = static_cast<float*>(dv_parts);
  a.du_parts = static_cast<float*>(du_parts);
  a.B = B;
  a.T = T;
  a.H = H;
  a.chunk = chunk;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* duf = static_cast<float*>(du);
  e = rkv_bf16 ? launch_t<__nv_bfloat16>(a, N, w_bf16, dv, duf, st) : launch_t<float>(a, N, w_bf16, dv, duf, st);
  return static_cast<int>(e);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
