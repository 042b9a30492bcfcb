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
// multiplies an element) are far below the card's rate.  The chain of
// carries runs through 64 chunks at T 4096, a flag round trip through L2
// a hop; tools/rglru_scan_bwd_chain.py times a build without the wait.
//
// Design: persistent and warp-specialised, the forward's tile and chunk
// chain run backwards.
//   * A ticket is (chunk of 64 steps, batch row, slice of 64 channels).
//     The grid is the blocks that fit the card at once; each block takes
//     tickets from an atomic counter in a loop and works them in the order
//     it took them.  A producer warp (one lane) takes the next tickets and
//     keeps their x, r, i and dy tiles (64 steps x 64 channels, 8 KB each in
//     bf16) in flight by TMA into a 2-stage ring (full / empty mbarriers);
//     the 8 consumer warps work the current ticket meanwhile: the loads
//     stay in flight while they fold, wait on the next chunk's carry and
//     walk back.  Tiles past T or Dr load as zeros, which are identity
//     steps (a = 1, b = 0).  dx, dr and di go to a staging tile in shared
//     memory and out by TMA store, which the block waits for only before
//     it writes the staging tile again, a ticket later.
//   * Within a ticket the consumer warps take 8 steps each (a segment), a
//     lane two adjacent channels.  A thread reads its segment's x, r, i
//     and dy from the ring, keeps the coefficients a_t, b_t = beta_t g_t in
//     registers, and forms the segment's decay product A_w, its forward
//     local end state H_w (from a zero state) and its backward local carry
//     L_w (walking back from a zero carry: dh = dy + carry, carry = a dh).
//   * Warp 0 folds the segments: forwards, from the chunk's start (h0, or
//     the state the forward kernel published for the chunk before, which
//     the wrapper kept), into each segment's start state; backwards, from
//     the carry that enters the chunk's last step (dh_last for the last
//     chunk, else the next chunk's published carry), into each segment's
//     incoming carry.  It publishes the carry leaving the chunk's first
//     step (A_c G + L_c; for chunk 0 that is dh0).  The carry scratch
//     starts as a NaN pattern no arithmetic makes (kUnset), so each word
//     is its own ready signal: a hop is one store and one poll through L2,
//     with no flag and no fence.
//   * Each warp walks its 8 steps forwards from its start state to recover
//     h_{t-1} in float32, then backwards from its carry (x, r, i and dy
//     read from the ring again, which it then frees), writing dx, dr and di
//     and summing 8 r dlog_a for dlam.
//   * dlam: the 8 warps' sums added in order into one row of a partial
//     buffer per (chunk, batch row); dlam_kernel adds the rows in order
//     and multiplies by sigmoid(-lam).  No float atomics: two calls give
//     equal bits.
// The ticket deals the LAST chunk first, so the ticket a waiting one needs
// (chunk c + 1) is an earlier one; a block works its tickets in the order
// it took them, so the earliest unfinished ticket's block has finished all
// its others and is working it: the waits cannot deadlock.  The wrapper
// fills the carry scratch with kUnset and zeroes the ticket for every call.
// When T fits one chunk there is no carry scratch, only the ticket.


#include "../../flash_attention/csrc/hopper.cuh"
#include "rglru.cuh"

namespace {

using namespace rglru;

constexpr int kStages = 2;                   // tickets in the ring
constexpr int kBlockThreads = kThreads + 32;  // 8 consumer warps + the producer warp
constexpr int kBarConsumers = 1;             // named barrier of the consumer warps

struct Params {
  CUtensorMap tx, tr, ti, tdy;  // loads: (channels, time, batch), boxes of kSlice x kChunk
  CUtensorMap tdx, tdr, tdi;    // stores, the same boxes
  const float* lam;             // [Dr]
  const float* h0;              // [B, Dr]
  const float* state;           // [B, NC, Dr]: the forward's chunk c inclusive state (c < NC - 1), or null
  const float* dh_last;         // [B, Dr], or null: zero
  float* dh0;                   // [B, Dr]
  float* carry;  // [B, NC, Dr]: the carry leaving chunk c's first step (c > 0), kUnset until written; or null
  int* ticket;   // zero on entry
  float* partial;  // [NC * B, Dr]: sum over a chunk's steps of 8 r dlog_a
  float* dlam;     // [Dr]
  int has_dy;      // dy given (else zero)
  int B, T, Dr, NC, NS;
};

// Shared memory past the static arrays: the ring of kStages x (x, r, i,
// dy) tiles, then the dx, dr, di staging tiles; 128-byte aligned.
template <typename T>
struct Smem {
  static constexpr int kTile = kChunk * kSlice * static_cast<int>(sizeof(T));  // 64 steps x 64 channels
  static constexpr int kStage = 4 * kTile;
  static constexpr int kOut = kStages * kStage;  // + array * kTile
  static constexpr int kBytes = kOut + 3 * kTile + 128;
};

// The bits of a carry not written yet (the wrapper fills the scratch with
// them): a NaN that no arithmetic of the card produces (its NaNs are
// 0x7fffffff).
constexpr uint32_t kUnset = 0xffffffffu;

__device__ __forceinline__ uint32_t ld_relaxed(const float* p) {
  uint32_t v;
  asm volatile("ld.relaxed.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(float* p, float v) {
  asm volatile("st.relaxed.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(__float_as_uint(v)) : "memory");
}

// The carry chunk c + 1 published for channels d, d + 1 (at `src`): each
// word is its own signal, so the wait is one round trip through L2 once
// it is there, with no flag and no fence.
__device__ __forceinline__ float2 wait_carry(const float* src) {
  uint32_t x, y;
  do {
    x = ld_relaxed(src);
    y = ld_relaxed(src + 1);
  } while (x == kUnset || y == kUnset);
  return make_float2(__uint_as_float(x), __uint_as_float(y));
}

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

template <typename T>
__device__ __forceinline__ float2 ld_pair(const unsigned char* tile, int step, int lane) {
  return Pair<T>::wide(Pair<T>::load(reinterpret_cast<const T*>(tile) + step * kSlice + 2 * lane));
}

template <typename T>
__global__ void __launch_bounds__(kBlockThreads, 2) scan_bwd_kernel(const __grid_constant__ Params p) {
  using S = Smem<T>;
  __shared__ float4 seg[kWarps][32];    // a segment's forward (A.x, A.y, H.x, H.y), per lane
  __shared__ float2 back[kWarps][32];   // its backward local carry L, per lane
  __shared__ float2 start[kWarps][32];  // its start state
  __shared__ float2 cin[kWarps][32];    // the carry entering its last step
  __shared__ float2 part[kWarps][32];   // its sum of 8 r dlog_a
  __shared__ int tick[kStages];         // the ticket in each stage
  __shared__ __align__(8) uint64_t bars[2 * kStages];  // full, empty
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t base = (raw + 127u) & ~127u;
  unsigned char* gbase = smem_raw + (base - raw);  // the same bytes, generic
  const uint32_t bar_full = hopper::smem_addr(bars), bar_empty = bar_full + 8 * kStages;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int level = p.B * p.NS;  // tickets a chunk
  const int total = p.NC * level;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(bar_full + 8 * s, 1);        // the producer's arrival (+ the TMA's bytes)
      hopper::mbar_init(bar_empty + 8 * s, kWarps);  // one lane of each consumer warp
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (warp == kWarps) {
    // ---- producer: lane 0 takes tickets and loads their tiles ----
    if (lane == 0) {
      for (int k = 0;; ++k) {
        const int stage = k % kStages;
        hopper::mbar_wait(bar_empty + 8 * stage, ((k / kStages) % 2) ^ 1);
        const int t = atomicAdd(p.ticket, 1);
        tick[stage] = t;
        if (t >= total) {  // no tickets left: the consumers stop here
          hopper::mbar_arrive(bar_full + 8 * stage);
          break;
        }
        const int c = p.NC - 1 - t / level, bs = t % level;
        const int b = bs / p.NS, d0 = (bs % p.NS) * kSlice, s0 = c * kChunk;
        const uint32_t dst = base + stage * S::kStage, full = bar_full + 8 * stage;
        hopper::mbar_arrive_expect_tx(full, (p.has_dy ? 4 : 3) * S::kTile);
        hopper::tma_load_3d(dst, &p.tx, full, d0, s0, b);
        hopper::tma_load_3d(dst + S::kTile, &p.tr, full, d0, s0, b);
        hopper::tma_load_3d(dst + 2 * S::kTile, &p.ti, full, d0, s0, b);
        if (p.has_dy) hopper::tma_load_3d(dst + 3 * S::kTile, &p.tdy, full, d0, s0, b);
      }
    }
    return;
  }

  // ---- consumers: 8 warps, a segment of 8 steps each ----
  for (int k = 0;; ++k) {
    const int stage = k % kStages;
    hopper::mbar_wait(bar_full + 8 * stage, (k / kStages) % 2);
    const int t = tick[stage];
    if (t >= total) break;
    const int c = p.NC - 1 - t / level, bs = t % level;  // chunk (the last first), (batch, slice)
    const int b = bs / p.NS, d0 = (bs % p.NS) * kSlice;
    const int d = d0 + 2 * lane;  // this thread's channels d, d + 1
    const bool live = d < p.Dr;
    const int s0 = c * kChunk + warp * kSeg;  // its first step
    const unsigned char* in = gbase + stage * S::kStage;
    const unsigned char *xs = in, *rs = in + S::kTile, *is = in + 2 * S::kTile, *dys = in + 3 * S::kTile;

    // warp 0's global reads for the fold, in flight during the segment's
    float2 st_in = make_float2(0.f, 0.f), g_last = make_float2(0.f, 0.f);
    if (warp == 0 && live) {
      st_in = *reinterpret_cast<const float2*>(
          c == 0 ? p.h0 + static_cast<long long>(b) * p.Dr + d
                 : p.state + (static_cast<long long>(b) * p.NC + c - 1) * p.Dr + d);
      if (c == p.NC - 1 && p.dh_last != nullptr)
        g_last = *reinterpret_cast<const float2*>(p.dh_last + static_cast<long long>(b) * p.Dr + d);
    }
    float2 c8lsl = make_float2(0.f, 0.f);
    if (live) {
      const float2 lam = *reinterpret_cast<const float2*>(p.lam + d);
      c8lsl = make_float2(kC * log_sigmoid(lam.x), kC * log_sigmoid(lam.y));
    }

    // The segment's coefficients (zero tiles past T or Dr give a = 1, b =
    // 0), and its aggregates from a zero state and a zero carry.
    float2 av[kSeg], bv[kSeg];
#pragma unroll
    for (int u = 0; u < kSeg; ++u) {
      const int row = warp * kSeg + u;
      const float2 x = ld_pair<T>(xs, row, lane), r = ld_pair<T>(rs, row, lane), i = ld_pair<T>(is, row, lane);
      coeff<T>(r.x, i.x, x.x, c8lsl.x, &av[u].x, &bv[u].x);
      coeff<T>(r.y, i.y, x.y, c8lsl.y, &av[u].y, &bv[u].y);
    }
    float2 A = make_float2(1.f, 1.f), H = make_float2(0.f, 0.f), L = make_float2(0.f, 0.f);
#pragma unroll
    for (int u = 0; u < kSeg; ++u) {
      A = make_float2(A.x * av[u].x, A.y * av[u].y);
      H = step(av[u], H, bv[u]);
    }
#pragma unroll
    for (int u = kSeg - 1; u >= 0; --u) {
      const float2 dy = p.has_dy ? ld_pair<T>(dys, warp * kSeg + u, lane) : make_float2(0.f, 0.f);
      L = make_float2(av[u].x * (dy.x + L.x), av[u].y * (dy.y + L.y));
    }
    seg[warp][lane] = make_float4(A.x, A.y, H.x, H.y);
    back[warp][lane] = L;
    hopper::named_barrier_sync(kBarConsumers, kThreads);

    if (warp == 0) {
      // Forwards: each segment's start from the chunk's.
      float2 st = st_in;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        start[w][lane] = st;
        const float4 g = seg[w][lane];
        st = step(make_float2(g.x, g.y), st, make_float2(g.z, g.w));
      }
      // Backwards: the chunk's (A_c, L_c), the segments folded from the last.
      float2 ca = make_float2(1.f, 1.f), cl = make_float2(0.f, 0.f);
#pragma unroll
      for (int w = kWarps - 1; w >= 0; --w) {
        const float4 g = seg[w][lane];
        ca = make_float2(g.x * ca.x, g.y * ca.y);
        cl = step(make_float2(g.x, g.y), cl, back[w][lane]);
      }
      // The carry entering the chunk's last step: dh_last, or the next
      // chunk's published carry.
      float2 G = g_last;
      if (c < p.NC - 1 && live) G = wait_carry(p.carry + (static_cast<long long>(b) * p.NC + c + 1) * p.Dr + d);
      const float2 out = step(ca, G, cl);  // the carry leaving the chunk's first step
      if (c > 0) {
        if (live) {
          float* dst = p.carry + (static_cast<long long>(b) * p.NC + c) * p.Dr + d;
          st_relaxed(dst, out.x);
          st_relaxed(dst + 1, out.y);
        }
      } else if (live) {
        *reinterpret_cast<float2*>(p.dh0 + static_cast<long long>(b) * p.Dr + d) = out;
      }
#pragma unroll
      for (int w = kWarps - 1; w >= 0; --w) {
        cin[w][lane] = G;
        const float4 g = seg[w][lane];
        G = step(make_float2(g.x, g.y), G, back[w][lane]);
      }
      // the previous ticket's stores have read the staging tiles
      if (lane == 0) hopper::bulk_wait_read<0>();
    }
    hopper::named_barrier_sync(kBarConsumers, kThreads);

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
    // The walk back from this segment's carry: dx, dr and di into the
    // staging tiles.
    T* out = reinterpret_cast<T*>(gbase + S::kOut);
    float2 carry = cin[warp][lane], acc = make_float2(0.f, 0.f);
#pragma unroll
    for (int u = kSeg - 1; u >= 0; --u) {
      const int row = warp * kSeg + u;
      const float2 x = ld_pair<T>(xs, row, lane), r = ld_pair<T>(rs, row, lane), i = ld_pair<T>(is, row, lane);
      const float2 dy = p.has_dy ? ld_pair<T>(dys, row, lane) : make_float2(0.f, 0.f);
      const float2 dh = make_float2(dy.x + carry.x, dy.y + carry.y);
      float2 dg, dla;
      dla.x = step_grad<T>(dh.x, hp[u].x, r.x, i.x, x.x, c8lsl.x, av[u].x, &dg.x);
      dla.y = step_grad<T>(dh.y, hp[u].y, r.y, i.y, x.y, c8lsl.y, av[u].y, &dg.y);
      if (s0 + u < p.T) {
        acc.x += dla.x * (kC * r.x);
        acc.y += dla.y * (kC * r.y);
      }
      dg = make_float2(Pair<T>::round(dg.x), Pair<T>::round(dg.y));
      const int off = row * kSlice + 2 * lane;
      Pair<T>::store(out + off, make_float2(Pair<T>::mul(dg.x, i.x), Pair<T>::mul(dg.y, i.y)));
      Pair<T>::store(out + kChunk * kSlice + off, make_float2(dla.x * c8lsl.x, dla.y * c8lsl.y));
      Pair<T>::store(out + 2 * kChunk * kSlice + off, make_float2(Pair<T>::mul(dg.x, x.x), Pair<T>::mul(dg.y, x.y)));
      carry = make_float2(av[u].x * dh.x, av[u].y * dh.y);
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(bar_empty + 8 * stage);  // this warp is done with the stage
    part[warp][lane] = acc;
    hopper::fence_proxy_async();  // the staging writes, before the TMA store reads them
    hopper::named_barrier_sync(kBarConsumers, kThreads);

    if (warp == 0) {
      if (lane == 0) {
        const int s_chunk = c * kChunk;
        hopper::tma_store_3d(&p.tdx, base + S::kOut, d0, s_chunk, b);
        hopper::tma_store_3d(&p.tdr, base + S::kOut + S::kTile, d0, s_chunk, b);
        hopper::tma_store_3d(&p.tdi, base + S::kOut + 2 * S::kTile, d0, s_chunk, b);
        hopper::bulk_commit();
      }
      if (live) {
        float2 sum = make_float2(0.f, 0.f);
#pragma unroll
        for (int w = 0; w < kWarps; ++w) sum = make_float2(sum.x + part[w][lane].x, sum.y + part[w][lane].y);
        *reinterpret_cast<float2*>(p.partial + (static_cast<long long>(c) * p.B + b) * p.Dr + d) = sum;
      }
    }
  }
  if (threadIdx.x == 0) hopper::bulk_wait_all<0>();  // the last stores are written
}

// dlam[d] = sigmoid(-lam[d]) * the rows of `partial` added in order.
__global__ void dlam_kernel(const float* partial, const float* lam, float* dlam, int rows, int Dr) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= Dr) return;
  float sum = 0.f;
  for (int row = 0; row < rows; ++row) sum += partial[static_cast<long long>(row) * Dr + d];
  dlam[d] = sum / (1.f + expf(lam[d]));
}

template <typename T>
int launch(Params& p, const void* x, const void* r, const void* i, const void* dy, void* dx, void* dr, void* di,
           const long long* strides, int ld, cudaStream_t st) {
  constexpr bool kBf16 = sizeof(T) == 2;
  hopper::EncodeTiled fn;
  cudaError_t e = hopper::encode_fn(&fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long out_st[2] = {static_cast<long long>(p.T) * ld, ld};  // dy, dx, dr, di: [B, T, ld]
  const struct {
    CUtensorMap* map;
    const void* ptr;
    const long long* st;
  } maps[] = {{&p.tx, x, strides},      {&p.tr, r, strides + 2}, {&p.ti, i, strides + 4},
              {&p.tdy, dy, out_st},     {&p.tdx, dx, out_st},    {&p.tdr, dr, out_st},
              {&p.tdi, di, out_st}};
  for (const auto& m : maps) {
    if (m.ptr == nullptr) continue;  // no dy
    const int err = hopper::encode_3d(fn, m.map, kBf16, m.ptr, p.Dr, p.T, p.B, m.st, kSlice, kChunk);
    if (err) return err;
  }
  auto kernel = scan_bwd_kernel<T>;
  const int smem = Smem<T>::kBytes;
  int device, sms, per_sm;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kBlockThreads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long tickets = static_cast<long long>(p.NC) * p.B * p.NS;
  const int grid = static_cast<int>(tickets < static_cast<long long>(per_sm) * sms ? tickets : per_sm * sms);
  kernel<<<grid, kBlockThreads, smem, st>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  dlam_kernel<<<(p.Dr + 255) / 256, 256, 0, st>>>(p.partial, p.lam, p.dlam, p.NC * p.B, p.Dr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Runs the backward on `stream`; returns 0 on success, else the first
// cudaError_t of a launch, or hopper::kEncodeError plus the CUresult of a
// failed tensor-map encode.  x, r, i: [B, T, Dr] as the forward takes them
// (strides = {x: b, t; r: b, t; i: b, t}, elements; each a multiple of 16
// bytes, the address 16-byte aligned, channels contiguous).  lam [Dr], h0
// [B, Dr]: contiguous float32, 8-byte aligned.  With more than one chunk
// of 64 steps (NC = ceil(T / 64) > 1), state is the forward's float32 [B,
// NC, Dr] scratch and carry float32 scratch of the same shape with every
// word 0xffffffff (kUnset); otherwise both may be null.  ticket: one int32,
// zeroed.  dh_last [B, Dr] float32, or null.  dy
// (or null: zero), dx, dr, di [B, T, Dr] in x's type, each the first Dr
// channels of rows of `ld` elements (ld times the type's size a multiple
// of 16 bytes, the addresses 16-byte aligned); dlam [Dr], dh0 [B, Dr]
// float32; partial float32 scratch of [NC * B, Dr].
int repro_rglru_scan_bwd(int device, int is_bf16, const void* x, const void* r, const void* i,
                         const long long* strides, const void* lam, const void* h0, const void* state,
                         const void* dy, const void* dh_last, void* dx, void* dr, void* di, void* dlam,
                         void* dh0, void* carry, void* ticket, void* partial, int batch, int T, int Dr,
                         int ld, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  Params p;
  p.lam = static_cast<const float*>(lam);
  p.h0 = static_cast<const float*>(h0);
  p.dh_last = static_cast<const float*>(dh_last);
  p.dh0 = static_cast<float*>(dh0);
  p.partial = static_cast<float*>(partial);
  p.dlam = static_cast<float*>(dlam);
  p.has_dy = dy != nullptr;
  p.B = batch;
  p.T = T;
  p.Dr = Dr;
  p.NC = (T + kChunk - 1) / kChunk;
  p.NS = (Dr + kSlice - 1) / kSlice;
  p.state = p.NC > 1 ? static_cast<const float*>(state) : nullptr;
  p.carry = p.NC > 1 ? static_cast<float*>(carry) : nullptr;
  p.ticket = static_cast<int*>(ticket);
  if (p.ticket == nullptr || (p.NC > 1 && (p.state == nullptr || p.carry == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(p, x, r, i, dy, dx, dr, di, strides, ld, st)
                 : launch<float>(p, x, r, i, dy, dx, dr, di, strides, ld, st);
}

const char* repro_cuda_error_string(int err) { return hopper::error_string(err); }

}  // extern "C"
