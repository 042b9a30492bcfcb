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
// What bounds it on the H100.  At the serving path's prefill shape (B=4,
// T=4096, H=64, N=64; r, k, v bf16, w and y float32) three floors stand
// close together:
//   * bytes: 14 B per (b, t, h, n) element plus the two states, 940 MB,
//     0.283 ms at 3.35 TB/s;
//   * float32 operations: 4 N^2 per (b, t, h), 17.2 GFLOP, 0.26 ms at
//     67 TFLOP/s;
//   * instruction issue: three float32 instructions per state element and
//     step (k * v, S * w + kv, y += r * S) over 4.29e9 element-steps,
//     12.9e9 lane-instructions, ~0.4 ms on 132 SMs x 128 lanes.
// The first port of this kernel (one block of N threads per (b, h), thread
// j owning column j, a barrier and a one-step-deep prefetch every step) sat
// at ~0.67 us a step whatever N: each step paid a device-memory load
// latency in series.  This design answers each floor:
//   * bytes and load latency: every input byte is read once, by cp.async
//     (16-byte copies wherever the addresses and strides allow; L2 only)
//     into a ring of kStages time chunks of L steps in shared memory, up
//     to three chunks ahead of the one in use, so no step waits on device
//     memory; y is written once, as 16-byte vectors, the state once at
//     each end;
//   * operations and issue: the recurrence runs on consumer warps that do
//     nothing else.  A consumer owns a tile of R = N / 4 rows by C columns
//     of S in registers (C = 4 at N = 64), so one broadcast 16-byte
//     shared-memory read of {r_i, k_i, w_i} feeds 3 C instructions and the
//     steps of a chunk need no barrier; what is left is ~3.4 instructions
//     per element-step;
//   * everything else (the copies, widening r, k, v, w to float32 once per
//     element instead of once per column, the per-step bonus sum
//     sum_i r_i u_i k_i once per step, and summing the row groups' partial
//     y into the output) runs on producer warps, concurrently, one chunk
//     ahead of the consumers through double buffers handed over by named
//     barriers.
// Measured times stand beside the bound in PERF.md.
//
// Design.  One block per (head, batch): kConsumers = (N / C) * 4 consumer
// threads and kProducers producer threads (64 + 128 at N = 64, so two
// blocks an SM hold the path's 256 (b, h) in one wave).  Consumer (p, jc)
// owns rows [p R, p R + R) of columns Sh::col(jc, cc); the lanes of a warp
// share one row group, so the {r, k, w} reads are broadcasts.  Per chunk c
// (buffer c & 1):
//   producers: sum chunk c - 2's partial y into the output (after the
//     consumers release its buffer: "empty"); wait for chunk c's copies;
//     issue chunk c + kStages - 1's; widen chunk c into float4 {r, k, w}
//     rows, v rows and the bonus sums (a fixed shuffle order); "full".
//   consumers: wait "full"; run the chunk's steps on their tiles, leaving
//     each step's partial y in shared memory; "empty".
// No atomics and fixed orders of summation: the same bits on every run.
// The final state may alias state0 (decode updates its cache in place):
// each state element is read and written by one consumer only, before and
// after the loop.  The inputs come in through element strides for batch,
// time and head (the last dimension contiguous), with no copy; narrower
// strides take 8-, 4- or 2-byte copies.  T = 1 (a decode step) takes
// wkv6_step_kernel below, where the state is the traffic.  For training
// the kernel's kBounds instance also writes the state before every
// `bchunk` steps (the consumers hold it in registers at each chunk's
// start) for the backward, wkv6_bwd.cu; serving and decode launch the
// instance without it, unchanged.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStages = 4;  // time chunks in the shared-memory ring

struct Args {
  const void* r;
  const void* k;
  const void* v;
  const void* w;
  const float* u;   // [H, N]
  const float* s0;  // [B, H, N, N]; may alias sout
  float* out;       // [B, T, H, N]
  float* sout;      // [B, H, N, N]
  long long sr[3], sk[3], sv[3], sw[3];  // element strides: batch, time, head
  int T, H;
  int unit;      // bytes per copy: 16, 8, 4 or 2
  int step_vec;  // s0 and sout 16-byte aligned: T = 1 may take the step kernel
  float* bounds;  // [B, ceil(T / bchunk), H, N, N]: the state before every bchunk steps, or null
  int bchunk;     // a multiple of Shape<N>::L
};

template <int N>
struct Shape {
  static constexpr int C = N == 64 ? 4 : (N == 128 ? 2 : 1);  // columns a consumer thread owns
  static constexpr int P = 4;                // row groups: consumer threads that share a column
  static constexpr int L = N == 128 ? 8 : 16;  // steps a chunk
  static constexpr int R = N / P;            // rows a consumer thread owns
  static constexpr int kCols = N / C;        // consumer threads across the columns
  static constexpr int kConsumers = kCols * P;
  static constexpr int kProducers = N >= 64 ? 128 : 64;
  static constexpr int kThreads = kConsumers + kProducers;
  static constexpr int kMinBlocks = N <= 64 ? 2 : 1;  // blocks an SM must hold
  // column cc of consumer jc: C adjacent columns, read and written as
  // 16-byte vectors when C is a multiple of 4
  static __device__ __forceinline__ int col(int jc, int cc) { return C * jc + cc; }
};

template <int N, typename TI, typename TW>
struct Smem {
  static constexpr int L = Shape<N>::L, P = Shape<N>::P;
  static constexpr size_t kRkv = size_t(L) * N * sizeof(TI);  // one of r, k, v in a slot
  static constexpr size_t kSlot = 3 * kRkv + size_t(L) * N * sizeof(TW);
  // Per buffer (two of each): float4 {r, k, w, 0} rows, v rows, the partial
  // y of every row group, the per-step bonus sums.
  static constexpr size_t kF4 = size_t(L) * N * sizeof(float4);
  static constexpr size_t kV = size_t(L) * N * sizeof(float);
  static constexpr size_t kY = size_t(L) * P * N * sizeof(float);
  static constexpr size_t kRuk = ((L * sizeof(float) + 15) / 16) * 16;
  static constexpr size_t kBuf = kF4 + kV + kY + kRuk;
  static constexpr size_t kTotal = kStages * kSlot + 2 * kBuf;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void copy_async(void* dst, const void* src, int unit) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  switch (unit) {
    case 16:
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
      break;
    case 8:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src) : "memory");
      break;
    case 4:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
      break;
    default:  // 2-byte aligned bf16 strides: a plain copy
      *static_cast<uint16_t*>(dst) = *static_cast<const uint16_t*>(src);
  }
}

// `rows` rows of kRowBytes (global row stride `stride` bytes) into
// consecutive rows of dst, 16 bytes a copy, spread over kBy threads.
template <int kRowBytes, int kMaxRows, int kBy>
__device__ __forceinline__ void copy_rows16(unsigned char* dst, const unsigned char* src, long long stride,
                                            int rows, int id) {
  constexpr int kPerRow = kRowBytes / 16, kAll = kMaxRows * kPerRow;
#pragma unroll
  for (int q = 0; q < (kAll + kBy - 1) / kBy; ++q) {
    const int idx = id + q * kBy, r = idx / kPerRow, off = (idx % kPerRow) * 16;
    if ((kAll % kBy == 0 || idx < kAll) && r < rows) copy_async(dst + r * kRowBytes + off, src + r * stride + off, 16);
  }
}

// Named barriers (0 is __syncthreads): the producers among themselves, and
// per buffer "full" (producers arrive, consumers wait) and "empty"
// (consumers arrive, producers wait).
constexpr int kBarProducers = 1, kBarFull = 2, kBarEmpty = 4;

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

template <int N, typename TI, typename TW, bool kBounds>
__global__ void __launch_bounds__(Shape<N>::kThreads, Shape<N>::kMinBlocks) wkv6_kernel(const Args a) {
  using Sh = Shape<N>;
  using Sm = Smem<N, TI, TW>;
  constexpr int L = Sh::L, P = Sh::P, R = Sh::R, C = Sh::C, kCols = Sh::kCols;
  constexpr int kConsumers = Sh::kConsumers, kProducers = Sh::kProducers, kThreads = Sh::kThreads;
  constexpr int kVec = C % 4 == 0 ? 4 : 1;

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* bufs = smem + kStages * Sm::kSlot;
  auto f4_of = [&](int c) { return reinterpret_cast<float4*>(bufs + (c & 1) * Sm::kBuf); };
  auto v_of = [&](int c) { return reinterpret_cast<float*>(bufs + (c & 1) * Sm::kBuf + Sm::kF4); };
  auto y_of = [&](int c) { return reinterpret_cast<float*>(bufs + (c & 1) * Sm::kBuf + Sm::kF4 + Sm::kV); };
  auto ruk_of = [&](int c) {
    return reinterpret_cast<float*>(bufs + (c & 1) * Sm::kBuf + Sm::kF4 + Sm::kV + Sm::kY);
  };

  const int tid = threadIdx.x;
  const int h = blockIdx.x, b = blockIdx.y;
  const long long bh = static_cast<long long>(b) * a.H + h;
  const int T = a.T;
  const int nchunks = (T + L - 1) / L;

  if (tid >= kConsumers) {
    // ---- producers: copies, widening, and writing y ----
    const int pid = tid - kConsumers;
    const unsigned char* src[4] = {
        static_cast<const unsigned char*>(a.r) + (b * a.sr[0] + h * a.sr[2]) * sizeof(TI),
        static_cast<const unsigned char*>(a.k) + (b * a.sk[0] + h * a.sk[2]) * sizeof(TI),
        static_cast<const unsigned char*>(a.v) + (b * a.sv[0] + h * a.sv[2]) * sizeof(TI),
        static_cast<const unsigned char*>(a.w) + (b * a.sw[0] + h * a.sw[2]) * sizeof(TW),
    };
    const long long tstride[4] = {a.sr[1] * (long long)sizeof(TI), a.sk[1] * (long long)sizeof(TI),
                                  a.sv[1] * (long long)sizeof(TI), a.sw[1] * (long long)sizeof(TW)};
    auto issue = [&](int c) {  // chunk c into its ring slot
      const int t0 = c * L, nt = min(L, T - t0);
      unsigned char* slot = smem + (c % kStages) * Sm::kSlot;
      if (a.unit == 16) {  // the usual case: copy positions fixed at compile time
        copy_rows16<N * sizeof(TI), L, kProducers>(slot, src[0] + t0 * tstride[0], tstride[0], nt, pid);
        copy_rows16<N * sizeof(TI), L, kProducers>(slot + Sm::kRkv, src[1] + t0 * tstride[1], tstride[1], nt, pid);
        copy_rows16<N * sizeof(TI), L, kProducers>(slot + 2 * Sm::kRkv, src[2] + t0 * tstride[2], tstride[2], nt,
                                                   pid);
        copy_rows16<N * sizeof(TW), L, kProducers>(slot + 3 * Sm::kRkv, src[3] + t0 * tstride[3], tstride[3], nt,
                                                   pid);
        return;
      }
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int row_bytes = N * (x < 3 ? sizeof(TI) : sizeof(TW));
        const int per_row = row_bytes / a.unit;
        const unsigned char* g = src[x] + t0 * tstride[x];
        for (int idx = pid; idx < nt * per_row; idx += kProducers) {
          const int r = idx / per_row, off = (idx - r * per_row) * a.unit;
          copy_async(slot + x * Sm::kRkv + r * row_bytes + off, g + r * tstride[x] + off, a.unit);
        }
      }
    };
    // Widening: G producers a step, producer (pt, sub) taking elements
    // i = sub + G q of step pt; the u entries it needs.
    constexpr int G = kProducers / L, kPer = N / G;
    static_assert(kProducers % L == 0 && N % G == 0 && 32 % G == 0, "widening layout");
    const int pt = pid / G, sub = pid % G;
    float uu[kPer];
#pragma unroll
    for (int q = 0; q < kPer; ++q) uu[q] = a.u[h * N + sub + G * q];

    float* out = a.out + (static_cast<long long>(b) * T * a.H + h) * N;  // + t * H * N
    const long long ostride = static_cast<long long>(a.H) * N;
    auto write_y = [&](int c) {  // sum the row groups' partials in order: 16-byte vectors
      bar_sync(kBarEmpty + (c & 1), kThreads);  // the consumers are done with chunk c
      const int t0 = c * L, nt = min(L, T - t0);
      const float* yb = y_of(c);
      constexpr int V = N / 4;
      for (int idx = pid; idx < nt * V; idx += kProducers) {
        const int t = idx / V, j4 = idx - t * V;
        const float4* y4 = reinterpret_cast<const float4*>(yb + t * P * N) + j4;
        float4 acc = y4[0];
#pragma unroll
        for (int q = 1; q < P; ++q) {
          const float4 e = y4[q * V];
          acc.x += e.x;
          acc.y += e.y;
          acc.z += e.z;
          acc.w += e.w;
        }
        reinterpret_cast<float4*>(out + (t0 + t) * ostride)[j4] = acc;
      }
    };

    for (int c = 0; c < kStages - 1; ++c) {
      if (c < nchunks) issue(c);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    for (int c = 0; c < nchunks; ++c) {
      if (c >= 2) write_y(c - 2);  // frees buffer c & 1
      asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
      bar_sync(kBarProducers, kProducers);  // chunk c landed; every producer is done with chunk c - 1's slot
      if (c + kStages - 1 < nchunks) issue(c + kStages - 1);
      asm volatile("cp.async.commit_group;\n" ::: "memory");

      const int nt = min(L, T - c * L);
      const unsigned char* slot = smem + (c % kStages) * Sm::kSlot;
      const TI* rr = reinterpret_cast<const TI*>(slot) + pt * N;
      const TI* kk = reinterpret_cast<const TI*>(slot + Sm::kRkv) + pt * N;
      const TI* vv = reinterpret_cast<const TI*>(slot + 2 * Sm::kRkv) + pt * N;
      const TW* ww = reinterpret_cast<const TW*>(slot + 3 * Sm::kRkv) + pt * N;
      float4* f4 = f4_of(c);
      float* vb = v_of(c);
      float acc = 0.f;
      if (pt < nt) {
#pragma unroll
        for (int q = 0; q < kPer; ++q) {
          const int i = sub + G * q;
          const float rf = to_f(rr[i]), kf = to_f(kk[i]);
          f4[pt * N + i] = make_float4(rf, kf, to_f(ww[i]), 0.f);
          vb[pt * N + i] = to_f(vv[i]);
          acc = fmaf(rf * uu[q], kf, acc);
        }
      }
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (sub == 0 && pt < nt) ruk_of(c)[pt] = acc;
      bar_arrive(kBarFull + (c & 1), kThreads);
    }
    for (int c = nchunks >= 2 ? nchunks - 2 : 0; c < nchunks; ++c) write_y(c);
    return;
  }

  // ---- consumers: the recurrence on a tile of the state ----
  // Thread (p, jc) owns rows i0 .. i0 + R of columns Sh::col(jc, cc).
  const int p = tid / kCols, jc = tid % kCols, i0 = p * R;
  float S[C][R];
  const float* s0 = a.s0 + bh * N * N;
#pragma unroll
  for (int cc = 0; cc < C; ++cc)
#pragma unroll
    for (int r = 0; r < R; ++r) S[cc][r] = s0[(i0 + r) * N + Sh::col(jc, cc)];

  for (int c = 0; c < nchunks; ++c) {
    const int nt = min(L, T - c * L);
    const float4* f4 = f4_of(c);
    const float* vb = v_of(c);
    const float* ruk = ruk_of(c);
    float* yb = y_of(c);
    if constexpr (kBounds) {  // training: the state before every bchunk steps, for the backward
      if ((c * L) % a.bchunk == 0) {
        const long long nb = (T + a.bchunk - 1) / a.bchunk;
        float* bo = a.bounds + ((b * nb + (c * L) / a.bchunk) * a.H + h) * N * N;
#pragma unroll
        for (int cc = 0; cc < C; ++cc)
#pragma unroll
          for (int r = 0; r < R; ++r) bo[(i0 + r) * N + Sh::col(jc, cc)] = S[cc][r];
      }
    }
    bar_sync(kBarFull + (c & 1), kThreads);  // chunk c is widened

#pragma unroll 2
    for (int t = 0; t < nt; ++t) {
      float v[C], y0[C], y1[C];
      const float bonus = ruk[t];
#pragma unroll
      for (int cc = 0; cc < C; cc += kVec) {
        if constexpr (kVec == 4) {
          const float4 x = *reinterpret_cast<const float4*>(vb + t * N + Sh::col(jc, cc));
          v[cc] = x.x;
          v[cc + 1] = x.y;
          v[cc + 2] = x.z;
          v[cc + 3] = x.w;
        } else {
          v[cc] = vb[t * N + Sh::col(jc, cc)];
        }
      }
#pragma unroll
      for (int cc = 0; cc < C; ++cc) {
        y0[cc] = p == 0 ? v[cc] * bonus : 0.f;
        y1[cc] = 0.f;
      }
      const float4* e = f4 + t * N + i0;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 x = e[r];  // {r_i, k_i, w_i, 0}: one address across the warp
#pragma unroll
        for (int cc = 0; cc < C; ++cc) {
          if (r & 1)
            y1[cc] = fmaf(x.x, S[cc][r], y1[cc]);
          else
            y0[cc] = fmaf(x.x, S[cc][r], y0[cc]);
          S[cc][r] = fmaf(S[cc][r], x.z, x.y * v[cc]);
        }
      }
#pragma unroll
      for (int cc = 0; cc < C; cc += kVec) {
        float* dst = yb + (t * P + p) * N + Sh::col(jc, cc);
        if constexpr (kVec == 4)
          *reinterpret_cast<float4*>(dst) = make_float4(y0[cc] + y1[cc], y0[cc + 1] + y1[cc + 1],
                                                        y0[cc + 2] + y1[cc + 2], y0[cc + 3] + y1[cc + 3]);
        else
          *dst = y0[cc] + y1[cc];
      }
    }
    bar_arrive(kBarEmpty + (c & 1), kThreads);
  }

  float* so = a.sout + bh * N * N;
#pragma unroll
  for (int cc = 0; cc < C; ++cc)
#pragma unroll
    for (int r = 0; r < R; ++r) so[(i0 + r) * N + Sh::col(jc, cc)] = S[cc][r];
}

// The decode step (T = 1): the state is the traffic, 2 N^2 floats a (b, h)
// against 4 N inputs, so it goes in and out as 16-byte vectors.  Thread
// (rg, cg) owns columns 4 cg .. 4 cg + 3 of rows rg, rg + RG, ...; it reads
// r_i, k_i, w_i of its rows (one address across a warp) and v of its
// columns from device memory directly, and the RG partial y of a column are
// summed in order through shared memory.  No ring, one barrier.
template <int N>
struct Step {
  static constexpr int CG = N / 4;  // column groups of 4
  static constexpr int RG = (256 / CG < N) ? 256 / CG : N;  // row groups
  static constexpr int RPT = N / RG;  // rows a thread owns
  static constexpr int kThreads = CG * RG;
};

template <int N, typename TI, typename TW>
__global__ void __launch_bounds__(Step<N>::kThreads) wkv6_step_kernel(const Args a) {
  constexpr int CG = Step<N>::CG, RG = Step<N>::RG, RPT = Step<N>::RPT;
  __shared__ float4 part[RG][CG];
  const int tid = threadIdx.x, cg = tid % CG, rg = tid / CG;
  const int h = blockIdx.x, b = blockIdx.y;
  const long long bh = static_cast<long long>(b) * a.H + h;
  const TI* rp = static_cast<const TI*>(a.r) + b * a.sr[0] + h * a.sr[2];
  const TI* kp = static_cast<const TI*>(a.k) + b * a.sk[0] + h * a.sk[2];
  const TI* vp = static_cast<const TI*>(a.v) + b * a.sv[0] + h * a.sv[2] + 4 * cg;
  const TW* wp = static_cast<const TW*>(a.w) + b * a.sw[0] + h * a.sw[2];
  const float4* s0 = reinterpret_cast<const float4*>(a.s0 + bh * N * N) + cg;
  float4* so = reinterpret_cast<float4*>(a.sout + bh * N * N) + cg;

  float4 S[RPT];
#pragma unroll
  for (int q = 0; q < RPT; ++q) S[q] = s0[(rg + RG * q) * CG];
  const float v0 = to_f(vp[0]), v1 = to_f(vp[1]), v2 = to_f(vp[2]), v3 = to_f(vp[3]);
  float4 y = make_float4(0.f, 0.f, 0.f, 0.f);
  float bonus = 0.f;
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    const int i = rg + RG * q;
    const float ri = to_f(rp[i]), ki = to_f(kp[i]), wi = to_f(wp[i]);
    bonus = fmaf(ri * a.u[h * N + i], ki, bonus);
    float4& s = S[q];
    y.x = fmaf(ri, s.x, y.x);
    y.y = fmaf(ri, s.y, y.y);
    y.z = fmaf(ri, s.z, y.z);
    y.w = fmaf(ri, s.w, y.w);
    s.x = fmaf(s.x, wi, ki * v0);
    s.y = fmaf(s.y, wi, ki * v1);
    s.z = fmaf(s.z, wi, ki * v2);
    s.w = fmaf(s.w, wi, ki * v3);
    so[i * CG] = s;  // the thread that read this state element writes it
  }
  part[rg][cg] = make_float4(fmaf(v0, bonus, y.x), fmaf(v1, bonus, y.y), fmaf(v2, bonus, y.z),
                             fmaf(v3, bonus, y.w));
  __syncthreads();
  if (tid < CG) {
    float4 acc = part[0][tid];
#pragma unroll
    for (int g = 1; g < RG; ++g) {
      const float4 e = part[g][tid];
      acc.x += e.x;
      acc.y += e.y;
      acc.z += e.z;
      acc.w += e.w;
    }
    reinterpret_cast<float4*>(a.out + bh * N)[tid] = acc;  // out [B, 1, H, N]
  }
}

template <int N, typename TI, typename TW>
cudaError_t launch_w(const Args& a, int B, cudaStream_t st) {
  if (a.T == 1 && a.step_vec && !a.bounds) {
    wkv6_step_kernel<N, TI, TW><<<dim3(a.H, B), Step<N>::kThreads, 0, st>>>(a);
    return cudaGetLastError();
  }
  auto kernel = a.bounds ? wkv6_kernel<N, TI, TW, true> : wkv6_kernel<N, TI, TW, false>;
  constexpr size_t smem = Smem<N, TI, TW>::kTotal;
  // all of the SM's unified memory as shared memory, so two blocks fit
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                       cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess && smem > 48 * 1024)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kernel<<<dim3(a.H, B), Shape<N>::kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

template <int N, typename TI>
cudaError_t launch_n(const Args& a, int w_bf16, int B, cudaStream_t st) {
  return w_bf16 ? launch_w<N, TI, __nv_bfloat16>(a, B, st) : launch_w<N, TI, float>(a, B, st);
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
// bounds, if not null, receives the state before every `chunk` steps
// ([B, ceil(T / chunk), H, N, N] float32, entry 0 = s0; chunk a multiple
// of 16) for the backward, wkv6_bwd.cu.  Returns cudaGetLastError() of the
// launch (0 on success).
int repro_wkv6_fwd(int device, int rkv_bf16, int w_bf16, int N, const void* r, const void* k,
                   const void* v, const void* w, const void* u, const void* s0, void* out,
                   void* sout, const long long* strides, int B, int T, int H, void* stream,
                   void* bounds, int chunk) {
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
  a.bounds = static_cast<float*>(bounds);
  a.bchunk = chunk;
  if (bounds && (chunk < 16 || chunk % 16 != 0)) return static_cast<int>(cudaErrorInvalidValue);
  // The widest copy every address and byte stride allows.
  const int isz[4] = {rkv_bf16 ? 2 : 4, rkv_bf16 ? 2 : 4, rkv_bf16 ? 2 : 4, w_bf16 ? 2 : 4};
  const void* ptrs[4] = {r, k, v, w};
  int unit = 16;
  for (int x = 0; x < 4; ++x) {
    while (unit > 2) {
      bool ok = reinterpret_cast<uintptr_t>(ptrs[x]) % unit == 0;
      for (int d = 0; d < 3; ++d) ok = ok && (strides[3 * x + d] * isz[x]) % unit == 0;
      if (ok) break;
      unit /= 2;
    }
  }
  a.unit = unit;
  a.step_vec = reinterpret_cast<uintptr_t>(s0) % 16 == 0 && reinterpret_cast<uintptr_t>(sout) % 16 == 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  e = rkv_bf16 ? launch_t<__nv_bfloat16>(a, N, w_bf16, B, st) : launch_t<float>(a, N, w_bf16, B, st);
  return static_cast<int>(e);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
