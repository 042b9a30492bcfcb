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
// Design: one launch that reads each input once.
// ref.py::rglru_scan_chunked_ref is this algorithm in plain torch.
//   * A block takes (chunk of kChunk = 64 steps, batch row, slice of 64
//     channels).  Its 8 warps take 8 steps each (a segment), a lane two
//     adjacent channels: one 4-byte bf16x2 or 8-byte float2 load a tensor a
//     step, so a warp reads one 128- or 256-byte row.  A thread issues all
//     its segment's loads of x, r and i at once, forms a_t and
//     beta_t * gated_x_t in float32 and keeps them in its registers (32
//     floats) until the rewalk: the inputs are read once and nothing goes
//     back to HBM but h.  Steps past T are the identity (a = 1, b = 0).
//   * Each thread folds its 8 steps into the segment's (decay product,
//     local end state); warp 0 folds the 8 segments, in order, into the
//     chunk's (A_c, H_c).
//   * Chunk c's start s_c is chunk c - 1's published inclusive state (h0
//     for chunk 0): warp 0 waits on that chunk's ready flag, reads its
//     state from float32 scratch, publishes s_{c+1} = A_c s_c + H_c and
//     sets its own flag (release after the state's stores; the reader
//     acquires), then writes the 8 segment starts to shared memory
//     (s_c, then A_w s + H_w segment by segment).
//   * Each warp rewalks its 8 steps from its start out of its registers,
//     writing h; the warp holding step T - 1 writes h_last.
// Blocks take their (chunk, batch, slice) from an atomic ticket, chunk
// major, so the block a waiting block needs took an earlier ticket and is
// resident or done: the wait cannot deadlock.  The ticket and the flags
// only order the blocks (the only atomics).  A chunk's start is always its
// immediate predecessor's state, combined in a fixed order, so no sum
// depends on timing and two calls give equal bits.  The wrapper zeroes the
// flags and the ticket for every call.  When T fits one chunk (decode's
// T = 1) there is no scratch, no flag and no ticket: each block starts from
// h0.
// Sizes, from timings on the card (PERF.md, Findings): a block's phases
// (loads, coefficients, fold, wait, rewalk) run one after another, so the
// card is kept busy by blocks in different phases: 64 registers a thread
// let 4 blocks of 256 threads share an SM.  16-step segments (2 blocks an
// SM), 16 warps a block, and persistent blocks that prefetch their next
// chunk were slower; the chain of waits costs little (removing it saves
// ~3%).

#include "rglru.cuh"

namespace {

using namespace rglru;

constexpr int kBlocks = 4;  // resident blocks a SM: 64 registers a thread

struct Args {
  const void* x;
  const void* r;
  const void* i;
  long long sx[2], sr[2], si[2];  // element strides: batch, time
  const float* lam;               // [Dr]
  const float* h0;                // [B, Dr]
  void* h;                        // [B, T, Dr] contiguous, x's type
  float* h_last;                  // [B, Dr]
  float* state;                   // [B, NC, Dr]: chunk c's inclusive state (c < NC - 1), or null
  int* flags;                     // [NC, B, NS] ready flags, then the ticket: zero on entry; or null
  int B, T, Dr, NC, NS;
};

// Grid: NC * B * NS blocks, one ticket each.
template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocks) scan_kernel(const Args a) {
  using Raw = typename Pair<T>::Raw;
  __shared__ float4 seg[kWarps][32];    // a segment's (A.x, A.y, H.x, H.y), per lane
  __shared__ float2 start[kWarps][32];  // a segment's start, per lane
  __shared__ int ticket_s;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int level = a.B * a.NS;  // blocks a chunk
  int ticket = blockIdx.x;       // with one chunk no block waits on another
  if (a.flags != nullptr) {
    if (threadIdx.x == 0) ticket_s = atomicAdd(a.flags + static_cast<long long>(a.NC) * level, 1);
    __syncthreads();
    ticket = ticket_s;
  }
  const int c = ticket / level, bs = ticket % level;  // chunk, (batch, slice)
  const int b = bs / a.NS;
  const int d = (bs % a.NS) * kSlice + 2 * lane;  // this thread's channels d, d + 1
  const bool live = d < a.Dr;
  const int s0 = c * kChunk + warp * kSeg;        // its first step
  const int n = live ? min(kSeg, a.T - s0) : 0;   // its steps (<= 0: none)

  // This segment's coefficients, read once and kept in registers.
  float2 av[kSeg], bv[kSeg];
  {
    const T* xp = static_cast<const T*>(a.x) + b * a.sx[0] + d;
    const T* rp = static_cast<const T*>(a.r) + b * a.sr[0] + d;
    const T* ip = static_cast<const T*>(a.i) + b * a.si[0] + d;
    Raw xr[kSeg], rr[kSeg], ir[kSeg];
#pragma unroll
    for (int u = 0; u < kSeg; ++u) {
      if (u < n) {
        const long long s = s0 + u;
        xr[u] = Pair<T>::load(xp + s * a.sx[1]);
        rr[u] = Pair<T>::load(rp + s * a.sr[1]);
        ir[u] = Pair<T>::load(ip + s * a.si[1]);
      }
    }
    float2 c8lsl = make_float2(0.f, 0.f);
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

  // The segment from a zero state: its decay product and local end state.
  float2 A = make_float2(1.f, 1.f), H = make_float2(0.f, 0.f);
#pragma unroll
  for (int u = 0; u < kSeg; ++u) {
    A = make_float2(A.x * av[u].x, A.y * av[u].y);
    H = step(av[u], H, bv[u]);
  }
  seg[warp][lane] = make_float4(A.x, A.y, H.x, H.y);
  __syncthreads();

  if (warp == 0) {
    // The chunk's (A_c, H_c): its segments folded in order.
    float2 ca = make_float2(1.f, 1.f), ch = make_float2(0.f, 0.f);
#pragma unroll
    for (int k = 0; k < kWarps; ++k) {
      const float4 g = seg[k][lane];
      ca = make_float2(g.x * ca.x, g.y * ca.y);
      ch = step(make_float2(g.x, g.y), ch, make_float2(g.z, g.w));
    }
    // The chunk's start: h0, or the previous chunk's published state.
    float2 st = make_float2(0.f, 0.f);
    if (c == 0) {
      if (live) st = *reinterpret_cast<const float2*>(a.h0 + static_cast<long long>(b) * a.Dr + d);
    } else {
      const int* ready = a.flags + static_cast<long long>(c - 1) * level + bs;
      while (ld_acquire(ready) == 0) __nanosleep(32);
      if (live)
        st = __ldcg(reinterpret_cast<const float2*>(
            a.state + (static_cast<long long>(b) * a.NC + c - 1) * a.Dr + d));
    }
    if (c + 1 < a.NC) {  // publish this chunk's inclusive state
      if (live)
        __stcg(reinterpret_cast<float2*>(a.state + (static_cast<long long>(b) * a.NC + c) * a.Dr + d),
               step(ca, st, ch));
      __threadfence();
      __syncwarp();
      if (lane == 0) st_release(a.flags + static_cast<long long>(c) * level + bs, 1);
    }
#pragma unroll
    for (int k = 0; k < kWarps; ++k) {
      start[k][lane] = st;
      const float4 g = seg[k][lane];
      st = step(make_float2(g.x, g.y), st, make_float2(g.z, g.w));
    }
  }
  __syncthreads();

  // The rewalk from this segment's start, writing h.
  T* op = static_cast<T*>(a.h) + static_cast<long long>(b) * a.T * a.Dr + d;
  float2 hv = start[warp][lane];
#pragma unroll
  for (int u = 0; u < kSeg; ++u) {
    hv = step(av[u], hv, bv[u]);
    if (u < n) Pair<T>::store(op + static_cast<long long>(s0 + u) * a.Dr, hv);
  }
  // The warp holding step T - 1 ends there (the identity steps after it
  // leave h as it was).
  if (live && s0 <= a.T - 1 && a.T - 1 < s0 + kSeg)
    *reinterpret_cast<float2*>(a.h_last + static_cast<long long>(b) * a.Dr + d) = hv;
}

template <typename T>
int launch(const Args& a, cudaStream_t st) {
  const long long blocks = static_cast<long long>(a.NC) * a.B * a.NS;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  scan_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Runs the scan on `stream`; returns 0 on success, else the cudaError_t of
// the launch.  x, r, i: [B, T, Dr], float32 (is_bf16 = 0) or bf16, the
// last dimension contiguous, Dr even, pointers and the batch and time
// strides (elements, strides = {x: b, t; r: b, t; i: b, t}) aligned for
// two-element loads.  lam [Dr], h0 and h_last [B, Dr]: contiguous float32,
// 8-byte aligned.  h [B, T, Dr] contiguous in x's type.  With more than
// one chunk of 64 steps (NC = ceil(T / 64) > 1), state is float32
// scratch of [B, NC, Dr] (which the wrapper keeps for the backward,
// rglru_scan_bwd.cu) and flags int32 of NC * B * ceil(Dr / 64) + 1, zeroed;
// otherwise both may be null.
int repro_rglru_scan(int device, int is_bf16, const void* x, const void* r, const void* i,
                     const long long* strides, const void* lam, const void* h0, void* h,
                     void* h_last, void* state, void* flags, int batch, int T, int Dr,
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
  a.B = batch;
  a.T = T;
  a.Dr = Dr;
  a.NC = (T + kChunk - 1) / kChunk;
  a.NS = (Dr + kSlice - 1) / kSlice;
  a.state = a.NC > 1 ? static_cast<float*>(state) : nullptr;
  a.flags = a.NC > 1 ? static_cast<int*>(flags) : nullptr;
  if (a.NC > 1 && (a.state == nullptr || a.flags == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(a, st) : launch<float>(a, st);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
