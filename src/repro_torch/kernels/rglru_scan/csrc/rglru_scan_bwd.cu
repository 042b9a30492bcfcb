// The gradient of the RG-LRU recurrence (rglru_scan.cu) for Hopper
// (sm_90a), hand-written CUDA C++.
//
// Replaces no Pallas kernel: the JAX package differentiates
// jax.lax.associative_scan (src/repro/models/rglru.py:67-92, `rg_lru`).
// It computes what jax.grad of rg_lru computes, per batch row and channel,
// with the forward's arithmetic (rglru.cuh, `coeff`):
//   dh_t     = dy_t + a_{t+1} dh_{t+1}           from dh_last (or 0)
//   dlog_a_t = dh_t h_{t-1} a_t - dh_t g_t exp(2 log_a_t) / beta_t
//              (the second term 0 where the 1e-12 clamp binds, r = 0: the
//              gradient jnp.maximum gives there)
//   dg_t     = dh_t beta_t rounded to x's type;  dx = dg i, di = dg x
//              (each product rounded once in x's type)
//   dr       = 8 log_sigmoid(lam) dlog_a, rounded to x's type
//   dlam     = sigmoid(-lam) sum_{b,t} 8 r dlog_a   (float32)
//   dh0      = a_0 dh_0                            (float32)
// with h_{t-1} in float32, as in JAX (ref.py::rglru_scan_bwd_ref is the
// same recurrence step by step; ref.py::rglru_scan_bwd_chunked_ref this
// kernel's algorithm in plain torch).
//
// What bounds it on the H100: bytes.  At the training path's 1 x 4096 x
// 4096 bf16 it reads x, r, i and dy and writes dx, dr and di (7 x 33.6 MB,
// ~0.070 ms at 3.35 TB/s); the float32 chunk states and carries add 4 MB
// each way.  Its operations (three exp, a sqrt, a division and ~20
// multiplies an element) are far below the card's rate.
//
// Design: the forward's block shape and chunk chain, run backwards.
//   * A block takes (chunk of 64 steps, batch row, slice of 64 channels);
//     its 8 warps take 8 steps each (a segment), a lane two adjacent
//     channels.  A thread loads its segment's x, r, i and dy once, keeps
//     them and the coefficients a_t, b_t = beta_t g_t in registers, and
//     forms the segment's decay product A_w, its forward local end state
//     H_w (from a zero state) and its backward local carry L_w (walking
//     back from a zero carry: dh = dy + carry, carry = a dh).
//   * Warp 0 folds the segments: forwards, from the chunk's start (h0, or
//     the state the forward kernel published for the chunk before, which
//     the wrapper kept), into each segment's start state; backwards, from
//     the carry that enters the chunk's last step (dh_last for the last
//     chunk, else the next chunk's published carry, behind its ready
//     flag), into each segment's incoming carry.  It publishes the carry
//     leaving the chunk's first step (A_c G + L_c; for chunk 0 that is
//     dh0) and sets its flag (release after the carry's stores).
//   * Each warp walks its 8 steps forwards from its start state to recover
//     h_{t-1} in float32, then backwards from its carry, writing dx, dr
//     and di, and summing 8 r dlog_a for dlam.
//   * dlam: the 8 warps' sums added in order into one row of a partial
//     buffer per (chunk, batch row); dlam_kernel adds the rows in order
//     and multiplies by sigmoid(-lam).  No float atomics: two calls give
//     equal bits.
// Blocks take their (chunk, batch, slice) from an atomic ticket that deals
// the LAST chunk first, so the block a waiting block needs (chunk c + 1)
// took an earlier ticket and is resident or done: the wait cannot
// deadlock.  The wrapper zeroes the flags and the ticket for every call.
// When T fits one chunk there is no carry scratch, flag or ticket.

#include "rglru.cuh"

namespace {

using namespace rglru;

struct Args {
  const void* x;
  const void* r;
  const void* i;
  long long sx[2], sr[2], si[2];  // element strides: batch, time
  const float* lam;               // [Dr]
  const float* h0;                // [B, Dr]
  const float* state;             // [B, NC, Dr]: the forward's chunk c inclusive state (c < NC - 1), or null
  const void* dy;                 // [B, T, Dr] contiguous, x's type, or null: zero
  const float* dh_last;           // [B, Dr], or null: zero
  void* dx;                       // [B, T, Dr] contiguous, x's type
  void* dr;
  void* di;
  float* dh0;      // [B, Dr]
  float* carry;    // [B, NC, Dr]: the carry leaving chunk c's first step (c > 0), or null
  int* flags;      // [NC, B, NS] ready flags, then the ticket: zero on entry; or null
  float* partial;  // [NC * B, Dr]: sum over a chunk's steps of 8 r dlog_a
  float* dlam;     // [Dr]
  int B, T, Dr, NC, NS;
};

// One step's gradient for one channel from its dh and h_{t-1}: returns
// dlog_a, sets dg (float32).
template <typename T>
__device__ __forceinline__ float step_grad(float dh, float h_prev, float r, float ig, float x, float c8lsl,
                                           float a, float* dg) {
  const float log_a = r * c8lsl;
  const float u = expf(2.f * log_a);
  const float free = 1.f - u;
  const float beta = sqrtf(fmaxf(free, 1e-12f));
  const float g = Pair<T>::mul(ig, x);
  float dlog_a = dh * h_prev * a;
  if (free > 1e-12f) dlog_a -= dh * g * u / beta;
  *dg = dh * beta;
  return dlog_a;
}

// Grid: NC * B * NS blocks, one ticket each, the last chunk's first.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2) scan_bwd_kernel(const Args a) {
  using Raw = typename Pair<T>::Raw;
  __shared__ float4 seg[kWarps][32];    // a segment's forward (A.x, A.y, H.x, H.y), per lane
  __shared__ float2 back[kWarps][32];   // its backward local carry L, per lane
  __shared__ float2 start[kWarps][32];  // its start state
  __shared__ float2 cin[kWarps][32];    // the carry entering its last step
  __shared__ float2 part[kWarps][32];   // its sum of 8 r dlog_a
  __shared__ int ticket_s;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int level = a.B * a.NS;  // blocks a chunk
  int ticket = blockIdx.x;       // with one chunk no block waits on another
  if (a.flags != nullptr) {
    if (threadIdx.x == 0) ticket_s = atomicAdd(a.flags + static_cast<long long>(a.NC) * level, 1);
    __syncthreads();
    ticket = ticket_s;
  }
  const int c = a.NC - 1 - ticket / level, bs = ticket % level;  // chunk (the last first), (batch, slice)
  const int b = bs / a.NS;
  const int d = (bs % a.NS) * kSlice + 2 * lane;  // this thread's channels d, d + 1
  const bool live = d < a.Dr;
  const int s0 = c * kChunk + warp * kSeg;        // its first step
  const int n = live ? min(kSeg, a.T - s0) : 0;   // its steps (<= 0: none)

  // This segment's inputs, read once and kept in registers, and its
  // coefficients.
  Raw xr[kSeg], rr[kSeg], ir[kSeg];
  float2 dy[kSeg], av[kSeg], bv[kSeg];
  float2 c8lsl = make_float2(0.f, 0.f);
  {
    const T* xp = static_cast<const T*>(a.x) + b * a.sx[0] + d;
    const T* rp = static_cast<const T*>(a.r) + b * a.sr[0] + d;
    const T* ip = static_cast<const T*>(a.i) + b * a.si[0] + d;
    const T* dp = a.dy == nullptr ? nullptr
                                  : static_cast<const T*>(a.dy) + static_cast<long long>(b) * a.T * a.Dr + d;
#pragma unroll
    for (int u = 0; u < kSeg; ++u) {
      dy[u] = make_float2(0.f, 0.f);
      if (u < n) {
        const long long s = s0 + u;
        xr[u] = Pair<T>::load(xp + s * a.sx[1]);
        rr[u] = Pair<T>::load(rp + s * a.sr[1]);
        ir[u] = Pair<T>::load(ip + s * a.si[1]);
        if (dp != nullptr) dy[u] = Pair<T>::wide(Pair<T>::load(dp + s * a.Dr));
      }
    }
    if (live) {
      const float2 lam = *reinterpret_cast<const float2*>(a.lam + d);
      c8lsl = make_float2(kC * log_sigmoid(lam.x), kC * log_sigmoid(lam.y));
    }
#pragma unroll
    for (int u = 0; u < kSeg; ++u) {
      if (u < n) {
        const float2 x = Pair<T>::wide(xr[u]), r = Pair<T>::wide(rr[u]), i = Pair<T>::wide(ir[u]);
        coeff<T>(r.x, i.x, x.x, c8lsl.x, &av[u].x, &bv[u].x);
        coeff<T>(r.y, i.y, x.y, c8lsl.y, &av[u].y, &bv[u].y);
      } else {  // past T, or a channel past Dr: the identity step
        av[u] = make_float2(1.f, 1.f);
        bv[u] = make_float2(0.f, 0.f);
      }
    }
  }

  // The segment from a zero state (forwards) and from a zero carry
  // (backwards).
  float2 A = make_float2(1.f, 1.f), H = make_float2(0.f, 0.f), L = make_float2(0.f, 0.f);
#pragma unroll
  for (int u = 0; u < kSeg; ++u) {
    A = make_float2(A.x * av[u].x, A.y * av[u].y);
    H = step(av[u], H, bv[u]);
  }
#pragma unroll
  for (int u = kSeg - 1; u >= 0; --u)
    L = make_float2(av[u].x * (dy[u].x + L.x), av[u].y * (dy[u].y + L.y));
  seg[warp][lane] = make_float4(A.x, A.y, H.x, H.y);
  back[warp][lane] = L;
  __syncthreads();

  if (warp == 0) {
    // Forwards: each segment's start from the chunk's.
    float2 st = make_float2(0.f, 0.f);
    if (live)
      st = *reinterpret_cast<const float2*>(
          c == 0 ? a.h0 + static_cast<long long>(b) * a.Dr + d
                 : a.state + (static_cast<long long>(b) * a.NC + c - 1) * a.Dr + d);
#pragma unroll
    for (int k = 0; k < kWarps; ++k) {
      start[k][lane] = st;
      const float4 g = seg[k][lane];
      st = step(make_float2(g.x, g.y), st, make_float2(g.z, g.w));
    }
    // Backwards: the chunk's (A_c, L_c), the segments folded from the last.
    float2 ca = make_float2(1.f, 1.f), cl = make_float2(0.f, 0.f);
#pragma unroll
    for (int k = kWarps - 1; k >= 0; --k) {
      const float4 g = seg[k][lane];
      ca = make_float2(g.x * ca.x, g.y * ca.y);
      cl = step(make_float2(g.x, g.y), cl, back[k][lane]);
    }
    // The carry entering the chunk's last step: dh_last, or the next
    // chunk's published carry.
    float2 G = make_float2(0.f, 0.f);
    if (c == a.NC - 1) {
      if (live && a.dh_last != nullptr)
        G = *reinterpret_cast<const float2*>(a.dh_last + static_cast<long long>(b) * a.Dr + d);
    } else {
      const int* ready = a.flags + static_cast<long long>(c + 1) * level + bs;
      while (ld_acquire(ready) == 0) __nanosleep(32);
      if (live)
        G = __ldcg(reinterpret_cast<const float2*>(
            a.carry + (static_cast<long long>(b) * a.NC + c + 1) * a.Dr + d));
    }
    const float2 out = step(ca, G, cl);  // the carry leaving the chunk's first step
    if (c > 0) {
      if (live)
        __stcg(reinterpret_cast<float2*>(a.carry + (static_cast<long long>(b) * a.NC + c) * a.Dr + d), out);
      __threadfence();
      __syncwarp();
      if (lane == 0) st_release(a.flags + static_cast<long long>(c) * level + bs, 1);
    } else if (live) {
      *reinterpret_cast<float2*>(a.dh0 + static_cast<long long>(b) * a.Dr + d) = out;
    }
#pragma unroll
    for (int k = kWarps - 1; k >= 0; --k) {
      cin[k][lane] = G;
      const float4 g = seg[k][lane];
      G = step(make_float2(g.x, g.y), G, back[k][lane]);
    }
  }
  __syncthreads();

  // h_{t-1} for each step, from this segment's start.
  float2 hp[kSeg];
  {
    float2 hv = start[warp][lane];
#pragma unroll
    for (int u = 0; u < kSeg; ++u) {
      hp[u] = hv;
      hv = step(av[u], hv, bv[u]);
    }
  }
  // The walk back from this segment's carry, writing dx, dr and di.
  const long long row = static_cast<long long>(b) * a.T * a.Dr + d;
  T* dxp = static_cast<T*>(a.dx) + row;
  T* drp = static_cast<T*>(a.dr) + row;
  T* dip = static_cast<T*>(a.di) + row;
  float2 carry = cin[warp][lane], acc = make_float2(0.f, 0.f);
#pragma unroll
  for (int u = kSeg - 1; u >= 0; --u) {
    if (u < n) {
      const float2 x = Pair<T>::wide(xr[u]), r = Pair<T>::wide(rr[u]), i = Pair<T>::wide(ir[u]);
      const float2 dh = make_float2(dy[u].x + carry.x, dy[u].y + carry.y);
      float2 dg, dla;
      dla.x = step_grad<T>(dh.x, hp[u].x, r.x, i.x, x.x, c8lsl.x, av[u].x, &dg.x);
      dla.y = step_grad<T>(dh.y, hp[u].y, r.y, i.y, x.y, c8lsl.y, av[u].y, &dg.y);
      acc.x += dla.x * (kC * r.x);
      acc.y += dla.y * (kC * r.y);
      dg = make_float2(Pair<T>::round(dg.x), Pair<T>::round(dg.y));
      const long long off = static_cast<long long>(s0 + u) * a.Dr;
      Pair<T>::store(dxp + off, make_float2(Pair<T>::mul(dg.x, i.x), Pair<T>::mul(dg.y, i.y)));
      Pair<T>::store(drp + off, make_float2(dla.x * c8lsl.x, dla.y * c8lsl.y));
      Pair<T>::store(dip + off, make_float2(Pair<T>::mul(dg.x, x.x), Pair<T>::mul(dg.y, x.y)));
      carry = make_float2(av[u].x * dh.x, av[u].y * dh.y);
    }
  }
  part[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && live) {
    float2 sum = make_float2(0.f, 0.f);
#pragma unroll
    for (int k = 0; k < kWarps; ++k) sum = make_float2(sum.x + part[k][lane].x, sum.y + part[k][lane].y);
    *reinterpret_cast<float2*>(a.partial + (static_cast<long long>(c) * a.B + b) * a.Dr + d) = sum;
  }
}

// dlam[d] = sigmoid(-lam[d]) * the rows of `partial` added in order.
__global__ void dlam_kernel(const Args a) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= a.Dr) return;
  float sum = 0.f;
  const int rows = a.NC * a.B;
  for (int row = 0; row < rows; ++row) sum += a.partial[static_cast<long long>(row) * a.Dr + d];
  a.dlam[d] = sum / (1.f + expf(a.lam[d]));
}

template <typename T>
int launch(const Args& a, cudaStream_t st) {
  const long long blocks = static_cast<long long>(a.NC) * a.B * a.NS;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  scan_bwd_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  dlam_kernel<<<(a.Dr + 255) / 256, 256, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Runs the backward on `stream`; returns 0 on success, else the first
// cudaError_t of a launch.  x, r, i: [B, T, Dr] as the forward takes them
// (strides = {x: b, t; r: b, t; i: b, t}, elements).  lam [Dr], h0 [B, Dr]:
// contiguous float32, 8-byte aligned.  With more than one chunk of 64
// steps (NC = ceil(T / 64) > 1), state is the forward's float32 [B, NC,
// Dr] scratch, carry float32 scratch of the same shape and flags int32 of
// NC * B * ceil(Dr / 64) + 1, zeroed; otherwise all three may be null.
// dy [B, T, Dr] contiguous in x's type, or null; dh_last [B, Dr] float32,
// or null.  dx, dr, di [B, T, Dr] contiguous in x's type; dlam [Dr], dh0
// [B, Dr] float32; partial float32 scratch of [NC * B, Dr].
int repro_rglru_scan_bwd(int device, int is_bf16, const void* x, const void* r, const void* i,
                         const long long* strides, const void* lam, const void* h0, const void* state,
                         const void* dy, const void* dh_last, void* dx, void* dr, void* di, void* dlam,
                         void* dh0, void* carry, void* flags, void* partial, int batch, int T, int Dr,
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
  a.dy = dy;
  a.dh_last = static_cast<const float*>(dh_last);
  a.dx = dx;
  a.dr = dr;
  a.di = di;
  a.dh0 = static_cast<float*>(dh0);
  a.partial = static_cast<float*>(partial);
  a.dlam = static_cast<float*>(dlam);
  a.B = batch;
  a.T = T;
  a.Dr = Dr;
  a.NC = (T + kChunk - 1) / kChunk;
  a.NS = (Dr + kSlice - 1) / kSlice;
  a.state = a.NC > 1 ? static_cast<const float*>(state) : nullptr;
  a.carry = a.NC > 1 ? static_cast<float*>(carry) : nullptr;
  a.flags = a.NC > 1 ? static_cast<int*>(flags) : nullptr;
  if (a.NC > 1 && (a.state == nullptr || a.carry == nullptr || a.flags == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(a, st) : launch<float>(a, st);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
