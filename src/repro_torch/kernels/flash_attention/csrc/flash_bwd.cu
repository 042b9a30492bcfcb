// Flash-attention backward pass for Hopper (sm_90a), hand-written CUDA C++.
//
// The JAX package has no backward kernel: it trains through dense attention
// and autodiff.  This is the gradient of csrc/flash_fwd.cu (the port of
// src/repro/kernels/flash_attention/kernel.py `flash_attention_fwd`), with
// the FlashAttention-2 recurrence, and the same masks as the forward:
//   D  = rowsum(dO * O)                                  (delta_kernel)
//   x  = (q . k) * scale;  x = cap * tanh(x / cap)         (if softcap > 0)
//   masked pairs (causal k > q, window k <= q - window) take x = -1e30
//   P  = exp(x - lse)        lse is the forward's float32 log-sum-exp
//   dV = P^T dO;  dP = dO V^T;  dS = P * (dP - D) * (1 - tanh^2(.) under a
//   softcap), and 0 on masked pairs (the mask cuts the gradient)
//   dK = dS^T Q * scale;  dQ = dS K * scale
// Keys past Sk and query rows past Sq (the ragged edge of the last tile)
// take P = dS = 0 and zero operands; rows past Sk or Sq are not written.
// GQA: kv head j serves query heads j*G .. j*G+G-1, G = H / KVH, as in the
// forward's index map; dK and dV sum over them.
//
// Every route runs D first, then two kernels that each own their output, so
// there are no atomics and the result is the same bit for bit on every run:
// one writes dK and dV, walking the queries that see a key tile; the other
// writes dQ, walking the keys a query tile sees, as the forward does.  Both
// recompute P from q, k and lse; neither stores it.  The caller names the
// route (ops.py::bwd_route), and a route that does not fit the dtype and
// head_dim is refused:
//   * "wgmma" (bf16, head_dim 64, 128 and 256): flash_bwd_dkdv_wgmma and
//     flash_bwd_dq_wgmma below, the Hopper design.  Every full-width
//     training path runs it, recurrentgemma-9b's local attention at 256
//     among them.
//   * "mma_sync" (bf16, head_dim 16 and 96): flash_bwd_dkdv_bf16 and
//     flash_bwd_dq_bf16, the first port's kernels (a block per 64-row tile,
//     four warps, mma.sync m16n8k16, synchronous loads with transposed
//     shared-memory copies), kept for the smoke configs' 16-wide heads
//     (8 and 12 zero-padded to 16 by the wrapper) and phi-3-vision's 96.
//   * "f32" (float32, head_dim 16, 64, 96, 128, 256): one thread per key
//     row (dK/dV) or query row (dQ), scalar FMA in float32 (no TF32); at 256
//     the streamed tiles hold 32 rows and a thread's rows live in local
//     memory (float32 checks, not a path).
// All tensors go in through element strides (batch, seq, head; head_dim
// contiguous), as in the forward.  P and dS are rounded to bf16 as operands
// of the bf16 products (the plain version keeps them in float32: inside the
// bf16 tolerance).
//
// What bounds it on the H100.  At the training path's shape (B=8, H=12,
// S=1024, hd=64, bf16, causal) the work is ~32 GFLOP (five products of
// 2 * hd flops per query-key pair the mask keeps: ~0.033 ms at 989 TFLOP/s
// dense bf16) and ~101 MB (q, k, v, o, dO, lse read once, dQ, dK, dV
// written once: ~0.030 ms at 3.35 TB/s): bound by operations, barely.  The
// two-kernel split recomputes S and dP in the dQ kernel: seven products, 40%
// more tensor work than the bound counts, the price of no atomics.
//
// Design of the wgmma route.  Both kernels are persistent (one CTA per SM)
// with 384 threads in three warpgroups: a producer (registers lowered to 24
// with setmaxnreg; 40 in the hd-256 dK/dV kernel) and two consumers (raised
// to 240; 232 there).  Work items are
// numbered heaviest first and dealt in rounds of alternating direction, as
// in the forward.  Tiles arrive by TMA through 4-D tensor maps (hd, heads,
// seq, batch) in the 128-byte swizzle, and every product is a wgmma: K-major
// operands read as they land, MN-major ones through the descriptor's
// transpose bit, so nothing is transposed by hand.
//   * flash_bwd_dkdv_wgmma.  An item is one 128-key tile of one (kv head,
//     batch); under the causal mask the first key tiles are the heaviest.
//     Its K and V stay in shared memory (two item buffers at hd 64, so the
//     next item's load hides under this one).  The producer streams 64-row
//     Q and dO tiles through a ring that runs across the G query heads and
//     on into the next item; one producer warp also copies each tile's lse
//     (times log2 e, +inf past Sq, so those rows get P = 0 with no compare)
//     and D rows into the stage.  Each consumer owns 64 keys: per query tile
//     (in two passes of 32 queries at hd 128, to stay in 240 registers with
//     no spill) S^T = K Q^T and dP^T = V dO^T from shared memory, P^T and
//     dS^T in registers in the exp2 domain (the scale and log2 e in one FFMA
//     with lse * log2 e subtracted), then dV += P^T dO and dK += dS^T Q with
//     the rounded accumulators as A fragments from registers and dO, Q
//     MN-major.  The next pass's S^T and dP^T are issued while those run.
//     A consumer skips a tile its keys cannot see, and only tiles on the
//     causal diagonal or the window's edge pay for the index compare.  A key
//     tile no query sees still writes zeros.  Epilogue: dK * scale and dV in
//     bf16 over the consumer's own K and V rows, in the swizzled layout, out
//     by TMA store (rows past Sk dropped).
//   * D: delta_kernel_vec, one 16-byte vector of O and of dO a thread.
//   * flash_bwd_dq_wgmma.  The forward's skeleton: an item is a 128-row
//     query tile of one (batch, head), the last tiles first; Q and dO in two
//     buffers; K and V through a ring of 64-key tiles (S, dP and dQ stay
//     in 240 registers at hd 128).  Per tile S = Q K^T and
//     dP = dO V^T from shared memory, dS in registers (keys past Sk masked:
//     their zero K rows would not cancel an overflowing P), then dQ += dS K
//     with K MN-major, in flight while the next tile's S and dP are issued.
//     Epilogue: dQ * scale in bf16 by TMA store.
//   * Head_dim 256 (recurrentgemma-9b: 16 heads over 1, window 2048).  A dK
//     or dV accumulator of 64 keys x 256 takes 128 registers a thread, so
//     a consumer cannot hold both.  In flash_bwd_dkdv_wgmma an item is 64
//     keys that both consumers share: K and V resident (32 KB each), Q and
//     dO through a ring of two 64 KB stages.  Consumer 0 forms S^T and P^T
//     and accumulates dV; it hands P^T (times the softcap factor) to
//     consumer 1 through two float32 buffers in shared memory (16 KB each,
//     named barriers for full and empty), which forms dP^T, dS^T and
//     accumulates dK: four products a tile, as at 64 and 128.  Each 256-
//     wide product is two m64n128 ones over the atoms 0-1 and 2-3.  With
//     one kv head (recurrentgemma-9b) there are few items, 64 at 1 x 4096:
//     half the SMs would idle while each walked 16 query heads.  So an
//     item goes to a cluster of 1, 2 or 4 CTAs (ops.py::dkdv_cluster, a
//     divisor of G), each walking its share of the G query heads: the
//     item's K and V are multicast to all of them (each CTA's producer
//     loads its share of the atoms), and the float32 partials of dK and dV
//     are summed in rank order through distributed shared memory (each CTA
//     owns 256 / cluster columns; dkdv_consumers_hd256), with no atomics and
//     no global scratch.  In flash_bwd_dq_wgmma the item's Q and dO take
//     128 KB, so there is one query buffer and K and V stream as 32-key
//     tiles (ring of three).
//   * Head_dim 128 under GQA (mixtral's groups of 6): an item's G query
//     heads may be split over a pair of CTAs (the kernel's kCluster
//     instance; ops.py::dkdv_cluster_128 picks 2 where the items are fewer
//     than the SMs), K and V multicast as at 256.  Each CTA then holds
//     float32 partials of both consumers' dK and dV (64 keys x 128 each);
//     after the item every consumer of the pair says it is done with its
//     ring (bar_ready), CTA r owns the 8-column blocks [8 r, 8 r + 8) of
//     each, the other's blocks go into its Q and dO ring (cluster_sum_128,
//     one arrival a sender warp), it adds the two partials and stores its
//     blocks as bf16 straight to global memory (store_owned_128).  The ring
//     is free for that because there is one K/V buffer (kBufs == 1): the
//     producer's next Q/dO loads wait behind the next item's K/V, which
//     waits for bar_kv_empty, released only after the sum.  Splitting the
//     heads halves the mesh training shard's heaviest items (128 items on
//     132 SMs); with items enough to fill the card a pair's wait and sum at
//     each item's end cost more than they even out.
// Masked pairs get P = 0 directly: exp(-1e30 - lse) is 0 in float32 for
// every lse a row that sees a key can have (the wrappers refuse rows that
// see none).  The tensor maps are encoded on the host (hopper.cuh, no
// -lcuda); a failed encode, attribute or launch returns an error code and
// the wrapper raises on it.  There is no fallback to another route.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kBlockM = 64;  // query rows per tile
constexpr int kBlockN = 64;  // keys per tile
constexpr int kWarps = 4;    // bf16 kernels: 16 rows per warp
constexpr float kNegInf = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // [B, H, Sq] float32, contiguous
  float* delta;      // [B, H, Sq] float32 scratch: rowsum(dO * O)
  void* dq;
  void* dk;
  void* dv;
  // element strides (batch, seq, head) of q, k, v, o, dO, dQ, dK, dV
  long long sq[3], sk[3], sv[3], so[3], sdo[3], sdq[3], sdk[3], sdv[3];
  int B, H, KVH, Sq, Sk, hd;
  int causal;
  int window;     // <= 0: no window
  float softcap;  // <= 0: no softcap
  float sm_scale;
};

// P for one (query, key) pair from its raw q.k, and the factor dS takes:
// 0 where the pair is masked or out of range, 1 - tanh^2 under a softcap,
// else 1.  A masked pair's p is exp(-1e30 - lse), as in the forward.
__device__ __forceinline__ float prob(const Args& a, float s, int qi, int kj, float lse,
                                      float* dfac) {
  if (qi >= a.Sq || kj >= a.Sk) {
    *dfac = 0.f;
    return 0.f;
  }
  float x = s * a.sm_scale, f = 1.f;
  if (a.softcap > 0.f) {
    const float th = tanhf(x / a.softcap);
    x = a.softcap * th;
    f = 1.f - th * th;
  }
  bool keep = true;
  if (a.causal) keep = keep && (kj <= qi);
  if (a.window > 0) keep = keep && (kj > qi - a.window);
  *dfac = keep ? f : 0.f;
  return expf((keep ? x : kNegInf) - lse);
}

// Keys the query tile [q0, q0 + kBlockM) can see: [beg, end), beg rounded
// down to a key tile (the forward's key_range).
__device__ __forceinline__ void key_range(const Args& a, int q0, int* beg, int* end) {
  const int q_last = min(q0 + kBlockM, a.Sq) - 1;
  int e = a.Sk;
  if (a.causal) e = min(e, q_last + 1);
  int b = 0;
  if (a.window > 0) b = max(0, q0 - a.window + 1);
  *beg = (b / kBlockN) * kBlockN;
  *end = e;
}

// Queries that can see a key of the tile [k0, k0 + kBlockN): [beg, end),
// beg rounded down to a query tile.
__device__ __forceinline__ void query_range(const Args& a, int k0, int* beg, int* end) {
  const int k_last = min(k0 + kBlockN, a.Sk) - 1;
  int b = 0, e = a.Sq;
  if (a.causal) b = k0;                                  // k <= q
  if (a.window > 0) e = min(e, k_last + a.window);       // q < k + window
  *beg = (b / kBlockM) * kBlockM;
  *end = e;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D += A.B for one 16x8x16 tile: A row-major 16x16, B column-major 16x8.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment of rows [r0, r0 + 16), columns [c0, c0 + 16) of a
// row-major bf16 tile with leading dimension ld.
__device__ __forceinline__ void frag_a(uint32_t (&f)[4], const bf16* base, int ld, int r0,
                                       int c0, int g, int t) {
  const bf16* p = base + (r0 + g) * ld + c0 + 2 * t;
  f[0] = ld32(p);
  f[1] = ld32(p + 8 * ld);
  f[2] = ld32(p + 8);
  f[3] = ld32(p + 8 * ld + 8);
}

// D += A.B where B's column n is row n0 + n of a row-major tile (ld), read
// from column c0: the col-major B fragment of the forward.
__device__ __forceinline__ void mma_rows(float (&d)[4], const uint32_t (&a)[4], const bf16* base,
                                         int ld, int n0, int c0, int g, int t) {
  const bf16* p = base + (n0 + g) * ld + c0 + 2 * t;
  mma_bf16(d, a, ld32(p), ld32(p + 8));
}

// The A fragment of a 16x16 block from two adjacent 8-column accumulator
// tiles: the accumulator layout of m16n8 is that of the A operand.
__device__ __forceinline__ void acc_to_a(uint32_t (&f)[4], const float (&lo)[4],
                                         const float (&hi)[4]) {
  f[0] = pack_bf16(lo[0], lo[1]);
  f[1] = pack_bf16(lo[2], lo[3]);
  f[2] = pack_bf16(hi[0], hi[1]);
  f[3] = pack_bf16(hi[2], hi[3]);
}

// Rows [r0, r0 + rows) of a [seq, HD] bf16 slice (row stride ld_g) into a
// padded shared tile (row stride ld_s), zeros past n_valid; optionally also
// transposed into tt ([HD][ldt]).
template <int HD>
__device__ __forceinline__ void load_tile(bf16* dst, int ld_s, bf16* tt, int ldt, const bf16* src,
                                          long long ld_g, int r0, int n_valid, int rows) {
  constexpr int VEC = 8, CPR = HD / VEC;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int i = threadIdx.x; i < rows * CPR; i += blockDim.x) {
    const int r = i / CPR, c = (i % CPR) * VEC;
    uint4 val = zero;
    if (r0 + r < n_valid) val = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * ld_g + c);
    *reinterpret_cast<uint4*>(dst + r * ld_s + c) = val;
    if (tt != nullptr) {
      const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
      for (int j = 0; j < VEC; ++j) tt[(c + j) * ldt + r] = e[j];
    }
  }
}

// D = rowsum(dO * O) in float32: one warp per (batch, head, query) row.
template <typename T>
__global__ void delta_kernel(const Args a) {
  const long long row = (long long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (row >= (long long)a.B * a.H * a.Sq) return;
  const int lane = threadIdx.x & 31;
  const int qi = static_cast<int>(row % a.Sq);
  const int h = static_cast<int>((row / a.Sq) % a.H);
  const int b = static_cast<int>(row / ((long long)a.Sq * a.H));
  const T* op = static_cast<const T*>(a.o) + b * a.so[0] + (long long)qi * a.so[1] + h * a.so[2];
  const T* dp =
      static_cast<const T*>(a.dout) + b * a.sdo[0] + (long long)qi * a.sdo[1] + h * a.sdo[2];
  float acc = 0.f;
  for (int d = lane; d < a.hd; d += 32) acc = fmaf(to_f(op[d]), to_f(dp[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) a.delta[row] = acc;
}

// The same for bf16 rows of HD on the wgmma route: HD / 8 threads a row,
// each one 16-byte vector of O and of dO (the wrapper checks the
// alignment), summed over the row's threads by shuffles.
template <int HD>
__global__ void delta_kernel_vec(const Args a) {
  constexpr int kPerRow = HD / 8;
  const long long rows = (long long)a.B * a.H * a.Sq;
  const long long row = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / kPerRow;
  const int part = threadIdx.x % kPerRow;
  float acc = 0.f;
  if (row < rows) {
    const int qi = static_cast<int>(row % a.Sq);
    const int h = static_cast<int>((row / a.Sq) % a.H);
    const int b = static_cast<int>(row / ((long long)a.Sq * a.H));
    const uint4 ov = *reinterpret_cast<const uint4*>(
        static_cast<const bf16*>(a.o) + b * a.so[0] + (long long)qi * a.so[1] + h * a.so[2] + 8 * part);
    const uint4 dv = *reinterpret_cast<const uint4*>(
        static_cast<const bf16*>(a.dout) + b * a.sdo[0] + (long long)qi * a.sdo[1] + h * a.sdo[2] + 8 * part);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 of = __bfloat1622float2(o2[i]), df = __bfloat1622float2(d2[i]);
      acc = fmaf(of.x, df.x, acc);
      acc = fmaf(of.y, df.y, acc);
    }
  }
#pragma unroll
  for (int off = kPerRow / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < rows && part == 0) a.delta[row] = acc;
}

constexpr int kLDT = kBlockM + 8;  // padded row of a transposed [HD][64] tile

template <int HD>
constexpr size_t dkdv_bf16_smem() {
  return (size_t(4) * 64 * (HD + 8) + size_t(2) * HD * kLDT) * sizeof(bf16) +
         2 * kBlockM * sizeof(float);
}

template <int HD>
__global__ void __launch_bounds__(kWarps * 32) flash_bwd_dkdv_bf16(const Args a) {
  static_assert(HD % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int LD = HD + 8;
  constexpr int SUB = 64;  // query (dK/dV) or key (dQ) columns per pass
  constexpr int NT = SUB / 8;   // 8-query column tiles of S^T per pass
  constexpr int DT = HD / 8;    // 8-wide column tiles of dK, dV
  constexpr int KC = HD / 16;   // 16-deep steps over head_dim

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + kBlockN * LD;
  bf16* sQ = sV + kBlockN * LD;
  bf16* sdO = sQ + kBlockM * LD;
  bf16* sQt = sdO + kBlockM * LD;  // [HD][kLDT]
  bf16* sdOt = sQt + HD * kLDT;    // [HD][kLDT]
  float* sL = reinterpret_cast<float*>(sdOt + HD * kLDT);
  float* sD = sL + kBlockM;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * kBlockN, kvh = blockIdx.y, b = blockIdx.z;
  const int groups = a.H / a.KVH;
  const int wr = warp * 16;
  const int kr0 = k0 + wr + g, kr1 = kr0 + 8;

  load_tile<HD>(sK, LD, nullptr, 0,
                static_cast<const bf16*>(a.k) + b * a.sk[0] + kvh * a.sk[2], a.sk[1], k0, a.Sk,
                kBlockN);
  load_tile<HD>(sV, LD, nullptr, 0,
                static_cast<const bf16*>(a.v) + b * a.sv[0] + kvh * a.sv[2], a.sv[1], k0, a.Sk,
                kBlockN);

  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int dn = 0; dn < DT; ++dn)
#pragma unroll
    for (int r = 0; r < 4; ++r) dk[dn][r] = dv[dn][r] = 0.f;

  int qbeg, qend;
  query_range(a, k0, &qbeg, &qend);
  for (int hh = 0; hh < groups; ++hh) {
    const int h = kvh * groups + hh;
    const bf16* qp = static_cast<const bf16*>(a.q) + b * a.sq[0] + h * a.sq[2];
    const bf16* dop = static_cast<const bf16*>(a.dout) + b * a.sdo[0] + h * a.sdo[2];
    const float* lp = a.lse + ((long long)b * a.H + h) * a.Sq;
    const float* dlp = a.delta + ((long long)b * a.H + h) * a.Sq;
    for (int q0 = qbeg; q0 < qend; q0 += kBlockM) {
      __syncthreads();  // every warp is done with the previous query tile
      load_tile<HD>(sQ, LD, sQt, kLDT, qp, a.sq[1], q0, a.Sq, kBlockM);
      load_tile<HD>(sdO, LD, sdOt, kLDT, dop, a.sdo[1], q0, a.Sq, kBlockM);
      for (int i = tid; i < kBlockM; i += kWarps * 32) {
        const bool in = q0 + i < a.Sq;
        sL[i] = in ? lp[q0 + i] : 0.f;
        sD[i] = in ? dlp[q0 + i] : 0.f;
      }
      __syncthreads();

#pragma unroll
      for (int sub = 0; sub < kBlockM / SUB; ++sub) {
        const int c0 = sub * SUB;  // first query column of this pass
        // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x SUB queries.
        float st[NT][4], dpt[NT][4];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int r = 0; r < 4; ++r) st[nt][r] = dpt[nt][r] = 0.f;
#pragma unroll
        for (int kc = 0; kc < KC; ++kc) {
          uint32_t ka[4], va[4];
          frag_a(ka, sK, LD, wr, kc * 16, g, t);
          frag_a(va, sV, LD, wr, kc * 16, g, t);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            mma_rows(st[nt], ka, sQ, LD, c0 + nt * 8, kc * 16, g, t);
            mma_rows(dpt[nt], va, sdO, LD, c0 + nt * 8, kc * 16, g, t);
          }
        }
        // P^T and dS^T in place.
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int qc = c0 + nt * 8 + 2 * t + (r & 1);
            float f;
            const float p = prob(a, st[nt][r], q0 + qc, r < 2 ? kr0 : kr1, sL[qc], &f);
            st[nt][r] = p;
            dpt[nt][r] = p * (dpt[nt][r] - sD[qc]) * f;
          }
        }
        // dV += P^T dO and dK += dS^T Q over this pass's queries.
#pragma unroll
        for (int kc = 0; kc < SUB / 16; ++kc) {
          uint32_t pa[4], da[4];
          acc_to_a(pa, st[2 * kc], st[2 * kc + 1]);
          acc_to_a(da, dpt[2 * kc], dpt[2 * kc + 1]);
#pragma unroll
          for (int dn = 0; dn < DT; ++dn) {
            mma_rows(dv[dn], pa, sdOt, kLDT, dn * 8, c0 + kc * 16, g, t);
            mma_rows(dk[dn], da, sQt, kLDT, dn * 8, c0 + kc * 16, g, t);
          }
        }
      }
    }
  }

  bf16* dkp = static_cast<bf16*>(a.dk) + b * a.sdk[0] + kvh * a.sdk[2];
  bf16* dvp = static_cast<bf16*>(a.dv) + b * a.sdv[0] + kvh * a.sdv[2];
  const float sc = a.sm_scale;
#pragma unroll
  for (int dn = 0; dn < DT; ++dn) {
    const int col = dn * 8 + 2 * t;
    if (kr0 < a.Sk) {
      *reinterpret_cast<uint32_t*>(dkp + (long long)kr0 * a.sdk[1] + col) =
          pack_bf16(dk[dn][0] * sc, dk[dn][1] * sc);
      *reinterpret_cast<uint32_t*>(dvp + (long long)kr0 * a.sdv[1] + col) =
          pack_bf16(dv[dn][0], dv[dn][1]);
    }
    if (kr1 < a.Sk) {
      *reinterpret_cast<uint32_t*>(dkp + (long long)kr1 * a.sdk[1] + col) =
          pack_bf16(dk[dn][2] * sc, dk[dn][3] * sc);
      *reinterpret_cast<uint32_t*>(dvp + (long long)kr1 * a.sdv[1] + col) =
          pack_bf16(dv[dn][2], dv[dn][3]);
    }
  }
}

template <int HD>
constexpr size_t dq_bf16_smem() {
  return (size_t(4) * 64 * (HD + 8) + size_t(HD) * kLDT) * sizeof(bf16);
}

template <int HD>
__global__ void __launch_bounds__(kWarps * 32) flash_bwd_dq_bf16(const Args a) {
  static_assert(HD % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int LD = HD + 8;
  constexpr int SUB = 64;  // query (dK/dV) or key (dQ) columns per pass
  constexpr int NT = SUB / 8;   // 8-key column tiles of S per pass
  constexpr int DT = HD / 8;    // 8-wide column tiles of dQ
  constexpr int KC = HD / 16;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sdO = sQ + kBlockM * LD;
  bf16* sK = sdO + kBlockM * LD;
  bf16* sV = sK + kBlockN * LD;
  bf16* sKt = sV + kBlockN * LD;  // [HD][kLDT]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kBlockM, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.KVH);
  const int wr = warp * 16;
  const int row0 = q0 + wr + g, row1 = row0 + 8;
  const bf16* kp = static_cast<const bf16*>(a.k) + b * a.sk[0] + kvh * a.sk[2];
  const bf16* vp = static_cast<const bf16*>(a.v) + b * a.sv[0] + kvh * a.sv[2];

  load_tile<HD>(sQ, LD, nullptr, 0, static_cast<const bf16*>(a.q) + b * a.sq[0] + h * a.sq[2],
                a.sq[1], q0, a.Sq, kBlockM);
  load_tile<HD>(sdO, LD, nullptr, 0,
                static_cast<const bf16*>(a.dout) + b * a.sdo[0] + h * a.sdo[2], a.sdo[1], q0,
                a.Sq, kBlockM);
  const long long lrow = ((long long)b * a.H + h) * a.Sq;
  const float l0 = row0 < a.Sq ? a.lse[lrow + row0] : 0.f;
  const float l1 = row1 < a.Sq ? a.lse[lrow + row1] : 0.f;
  const float d0 = row0 < a.Sq ? a.delta[lrow + row0] : 0.f;
  const float d1 = row1 < a.Sq ? a.delta[lrow + row1] : 0.f;

  float dq[DT][4];
#pragma unroll
  for (int dn = 0; dn < DT; ++dn) dq[dn][0] = dq[dn][1] = dq[dn][2] = dq[dn][3] = 0.f;

  int kbeg, kend;
  key_range(a, q0, &kbeg, &kend);
  for (int k0 = kbeg; k0 < kend; k0 += kBlockN) {
    __syncthreads();  // sQ, sdO are written; every warp is done with the previous key tile
    load_tile<HD>(sK, LD, sKt, kLDT, kp, a.sk[1], k0, a.Sk, kBlockN);
    load_tile<HD>(sV, LD, nullptr, 0, vp, a.sv[1], k0, a.Sk, kBlockN);
    __syncthreads();

#pragma unroll
    for (int sub = 0; sub < kBlockN / SUB; ++sub) {
      const int c0 = sub * SUB;  // first key column of this pass
      // S = Q K^T and dP = dO V^T: this warp's 16 queries x SUB keys.
      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) s[nt][r] = dp[nt][r] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t qa[4], da[4];
        frag_a(qa, sQ, LD, wr, kc * 16, g, t);
        frag_a(da, sdO, LD, wr, kc * 16, g, t);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          mma_rows(s[nt], qa, sK, LD, c0 + nt * 8, kc * 16, g, t);
          mma_rows(dp[nt], da, sV, LD, c0 + nt * 8, kc * 16, g, t);
        }
      }
      // dS in place of dP.
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int kj = k0 + c0 + nt * 8 + 2 * t + (r & 1);
          const bool top = r < 2;
          float f;
          const float p = prob(a, s[nt][r], top ? row0 : row1, kj, top ? l0 : l1, &f);
          dp[nt][r] = p * (dp[nt][r] - (top ? d0 : d1)) * f;
        }
      }
      // dQ += dS K over this pass's keys.
#pragma unroll
      for (int kc = 0; kc < SUB / 16; ++kc) {
        uint32_t sa[4];
        acc_to_a(sa, dp[2 * kc], dp[2 * kc + 1]);
#pragma unroll
        for (int dn = 0; dn < DT; ++dn) mma_rows(dq[dn], sa, sKt, kLDT, dn * 8, c0 + kc * 16, g, t);
      }
    }
  }

  bf16* dqp = static_cast<bf16*>(a.dq) + b * a.sdq[0] + h * a.sdq[2];
  const float sc = a.sm_scale;
#pragma unroll
  for (int dn = 0; dn < DT; ++dn) {
    const int col = dn * 8 + 2 * t;
    if (row0 < a.Sq)
      *reinterpret_cast<uint32_t*>(dqp + (long long)row0 * a.sdq[1] + col) =
          pack_bf16(dq[dn][0] * sc, dq[dn][1] * sc);
    if (row1 < a.Sq)
      *reinterpret_cast<uint32_t*>(dqp + (long long)row1 * a.sdq[1] + col) =
          pack_bf16(dq[dn][2] * sc, dq[dn][3] * sc);
  }
}

// Rows of the streamed tiles of the float32 kernels (query rows in dK/dV,
// keys in dQ): 32 at head_dim 256, where 64-row tiles of all four tensors
// would pass the 227 KB a block can have.
template <int HD>
constexpr int kF32Rows = HD == 256 ? 32 : 64;

template <int HD>
constexpr size_t f32_smem() {
  return (size_t(2) * 64 * (HD + 1) + size_t(2) * kF32Rows<HD> * HD) * sizeof(float) +
         2 * kBlockM * sizeof(float);
}

// float32 rows [r0, r0 + ROWS) of a [seq, HD] slice into a shared tile with
// row stride ld_s, zeros past n_valid.
template <int HD, int ROWS = 64>
__device__ __forceinline__ void load_rows_f32(float* dst, int ld_s, const float* src,
                                              long long ld_g, int r0, int n_valid) {
  for (int i = threadIdx.x; i < ROWS * HD; i += blockDim.x) {
    const int r = i / HD, c = i % HD;
    dst[r * ld_s + c] = (r0 + r < n_valid) ? src[(long long)(r0 + r) * ld_g + c] : 0.f;
  }
}

// One thread per key row; its k and v rows padded by one float so the
// threads of a warp read 32 distinct banks, the query rows read as
// broadcasts.  At head_dim 256 a thread's dK and dV rows (512 floats) live
// in local memory: the route serves float32 checks, not a training path.
template <int HD>
__global__ void __launch_bounds__(kBlockN) flash_bwd_dkdv_f32(const Args a) {
  constexpr int LDK = HD + 1;
  constexpr int QM = kF32Rows<HD>;  // query rows a pass
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sK = reinterpret_cast<float*>(smem_raw);
  float* sV = sK + kBlockN * LDK;
  float* sQ = sV + kBlockN * LDK;
  float* sdO = sQ + QM * HD;
  float* sL = sdO + QM * HD;
  float* sD = sL + kBlockM;

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * kBlockN, kvh = blockIdx.y, b = blockIdx.z;
  const int groups = a.H / a.KVH;
  const int key = k0 + tid;
  load_rows_f32<HD>(sK, LDK, static_cast<const float*>(a.k) + b * a.sk[0] + kvh * a.sk[2],
                    a.sk[1], k0, a.Sk);
  load_rows_f32<HD>(sV, LDK, static_cast<const float*>(a.v) + b * a.sv[0] + kvh * a.sv[2],
                    a.sv[1], k0, a.Sk);

  float dk[HD], dv[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) dk[d] = dv[d] = 0.f;

  int qbeg, qend;
  query_range(a, k0, &qbeg, &qend);
  for (int hh = 0; hh < groups; ++hh) {
    const int h = kvh * groups + hh;
    const float* qp = static_cast<const float*>(a.q) + b * a.sq[0] + h * a.sq[2];
    const float* dop = static_cast<const float*>(a.dout) + b * a.sdo[0] + h * a.sdo[2];
    const float* lp = a.lse + ((long long)b * a.H + h) * a.Sq;
    const float* dlp = a.delta + ((long long)b * a.H + h) * a.Sq;
    for (int q0 = qbeg; q0 < qend; q0 += QM) {
      __syncthreads();
      load_rows_f32<HD, QM>(sQ, HD, qp, a.sq[1], q0, a.Sq);
      load_rows_f32<HD, QM>(sdO, HD, dop, a.sdo[1], q0, a.Sq);
      for (int i = tid; i < QM; i += kBlockN) {
        const bool in = q0 + i < a.Sq;
        sL[i] = in ? lp[q0 + i] : 0.f;
        sD[i] = in ? dlp[q0 + i] : 0.f;
      }
      __syncthreads();
      const int jn = min(QM, a.Sq - q0);
      for (int j = 0; j < jn; ++j) {
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int d = 0; d < HD; ++d) {
          s = fmaf(sK[tid * LDK + d], sQ[j * HD + d], s);
          dp = fmaf(sV[tid * LDK + d], sdO[j * HD + d], dp);
        }
        float f;
        const float p = prob(a, s, q0 + j, key, sL[j], &f);
        const float ds = p * (dp - sD[j]) * f;
#pragma unroll
        for (int d = 0; d < HD; ++d) {
          dv[d] = fmaf(p, sdO[j * HD + d], dv[d]);
          dk[d] = fmaf(ds, sQ[j * HD + d], dk[d]);
        }
      }
    }
  }
  if (key < a.Sk) {
    float* dkp = static_cast<float*>(a.dk) + b * a.sdk[0] + (long long)key * a.sdk[1] + kvh * a.sdk[2];
    float* dvp = static_cast<float*>(a.dv) + b * a.sdv[0] + (long long)key * a.sdv[1] + kvh * a.sdv[2];
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      dkp[d] = dk[d] * a.sm_scale;
      dvp[d] = dv[d];
    }
  }
}

// One thread per query row, as the float32 forward.
template <int HD>
__global__ void __launch_bounds__(kBlockM) flash_bwd_dq_f32(const Args a) {
  constexpr int LDQ = HD + 1;
  constexpr int KN = kF32Rows<HD>;  // keys a tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sdO = sQ + kBlockM * LDQ;
  float* sK = sdO + kBlockM * LDQ;
  float* sV = sK + KN * HD;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kBlockM, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.KVH);
  const int row = q0 + tid;
  const float* kp = static_cast<const float*>(a.k) + b * a.sk[0] + kvh * a.sk[2];
  const float* vp = static_cast<const float*>(a.v) + b * a.sv[0] + kvh * a.sv[2];
  load_rows_f32<HD>(sQ, LDQ, static_cast<const float*>(a.q) + b * a.sq[0] + h * a.sq[2], a.sq[1],
                    q0, a.Sq);
  load_rows_f32<HD>(sdO, LDQ, static_cast<const float*>(a.dout) + b * a.sdo[0] + h * a.sdo[2],
                    a.sdo[1], q0, a.Sq);
  const long long lrow = ((long long)b * a.H + h) * a.Sq + row;
  const float lse = row < a.Sq ? a.lse[lrow] : 0.f;
  const float dl = row < a.Sq ? a.delta[lrow] : 0.f;

  float dq[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) dq[d] = 0.f;

  int kbeg, kend;
  key_range(a, q0, &kbeg, &kend);
  for (int k0 = kbeg; k0 < kend; k0 += KN) {
    __syncthreads();
    load_rows_f32<HD, KN>(sK, HD, kp, a.sk[1], k0, a.Sk);
    load_rows_f32<HD, KN>(sV, HD, vp, a.sv[1], k0, a.Sk);
    __syncthreads();
    const int jn = min(KN, kend - k0);
    for (int j = 0; j < jn; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) {
        s = fmaf(sQ[tid * LDQ + d], sK[j * HD + d], s);
        dp = fmaf(sdO[tid * LDQ + d], sV[j * HD + d], dp);
      }
      float f;
      const float p = prob(a, s, row, k0 + j, lse, &f);
      const float ds = p * (dp - dl) * f;
#pragma unroll
      for (int d = 0; d < HD; ++d) dq[d] = fmaf(ds, sK[j * HD + d], dq[d]);
    }
  }
  if (row < a.Sq) {
    float* dqp = static_cast<float*>(a.dq) + b * a.sdq[0] + (long long)row * a.sdq[1] + h * a.sdq[2];
#pragma unroll
    for (int d = 0; d < HD; ++d) dqp[d] = dq[d] * a.sm_scale;
  }
}

// ---- The Hopper kernels: TMA rings, wgmma, warp specialisation ------------

namespace wg {

constexpr int kThreads = 384;   // producer + two consumer warpgroups
constexpr int kRowBytes = 128;  // one row of a 64-column swizzle atom
using hopper::kLog2e;

struct Params {
  // 4-D (hd, heads, seq, batch) maps; the number is the box's rows
  CUtensorMap tq64, tdo64, tk_kv, tv_kv;  // dK/dV kernel: query tiles, the item's keys
  CUtensorMap tq128, tdo128, tk_dq, tv_dq;  // dQ kernel: the item's queries, key tiles
  CUtensorMap tdq, tdk, tdv;               // stores, 64 rows
  const float* lse;                        // [B, H, Sq], natural log
  const float* delta;                      // [B, H, Sq]
  int B, H, KVH, Sq, Sk;
  int causal, window;
  float softcap, softcap_inv, sm_scale;
  int n_ktiles, n_qtiles;  // key items (dK/dV: KvShape::kKeys), 128-row items (dQ)
  int cluster;             // dK/dV at head_dim 128 and 256: CTAs a cluster, each a share of an item's query heads
  bf16* dk;                // dK/dV at head_dim 128 in a cluster: each CTA's summed columns, stored directly
  bf16* dv;
  long long sdk[3], sdv[3];  // their element strides (batch, seq, head)
};

// dK/dV kernel: an item is kKeys keys of one (kv head, batch); 64-row
// query tiles stream through a ring of kStages.  At head_dim 64 and 128 an
// item is 128 keys, 64 per consumer.  At 256 it is 64 keys that both
// consumers share (K and V 32 KB each, a ring of two 64 KB Q + dO stages,
// and the P^T exchange buffers: 226 KB).
template <int HD>
struct KvShape {
  static constexpr int kKeys = HD == 256 ? 64 : 128;
  static constexpr int kAtoms = HD / 64;
  static constexpr int kKVAtom = kKeys * kRowBytes;  // a 64-column atom of the item's K or V
  static constexpr int kKVTile = kAtoms * kKVAtom;
  static constexpr int kQAtom = 64 * kRowBytes;      // a 64-column atom of a query tile
  static constexpr int kQTile = kAtoms * kQAtom;
  static constexpr int kBufs = HD == 64 ? 2 : 1;     // K/V item buffers
  static constexpr int kStages = HD == 256 ? 2 : 4;
  static constexpr int kK = 0;                       // + buffer * kKVTile
  static constexpr int kV = kK + kBufs * kKVTile;
  static constexpr int kQ = kV + kBufs * kKVTile;    // + stage * kQTile
  static constexpr int kdO = kQ + kStages * kQTile;
  static constexpr int kP = kdO + kStages * kQTile;  // float [2][64 x 64] (head_dim 256): P^T times the softcap factor
  static constexpr int kL = kP + (HD == 256 ? 2 * 64 * 64 * 4 : 0);  // float [stage][64]: lse * log2 e, +inf past Sq
  static constexpr int kD = kL + kStages * 64 * 4;   // float [stage][64]: D, 0 past Sq
  static constexpr int kBar = kD + kStages * 64 * 4;
  // barriers: full, empty [kStages]; K/V full, K/V empty [kBufs]; at head_dim
  // 128 and 256 also the cluster's consumers done with the item, and each
  // consumer's partials received
  static constexpr int kBars = 2 * kStages + 2 * kBufs + (HD >= 128 ? 3 : 0);
  static constexpr int kAlloc = kBar + 8 * kBars + 1024;  // + room to align
  static_assert(kAlloc <= 232448, "more shared memory than a block can have");
};

// dQ kernel: an item is 128 query rows (64 per consumer) of one (batch,
// head); kN-key K and V tiles stream through a ring of kStages.  64-key
// tiles keep S, dP and dQ in the consumers' 240 registers at hd 128 and
// measured faster than 128-key ones at hd 64 (PERF.md).  At 256 the Q and
// dO of an item take 128 KB: one query buffer, and 32-key tiles (16 KB
// each of K and V) in a ring of three.
template <int HD>
struct DqShape {
  static constexpr int kN = HD == 256 ? 32 : 64;
  static constexpr int kAtoms = HD / 64;
  static constexpr int kQAtom = 128 * kRowBytes;
  static constexpr int kQTile = kAtoms * kQAtom;
  static constexpr int kKAtom = kN * kRowBytes;
  static constexpr int kKTile = kAtoms * kKAtom;
  static constexpr int kBufs = HD == 256 ? 1 : 2;  // query buffers, Q and dO each
  static constexpr int kStages = HD == 64 ? 6 : 3;
  static constexpr int kQ = 0;     // + buffer * kQTile
  static constexpr int kdO = kQ + kBufs * kQTile;
  static constexpr int kK = kdO + kBufs * kQTile;  // + stage * kKTile
  static constexpr int kV = kK + kStages * kKTile;
  static constexpr int kBar = kV + kStages * kKTile;
  // barriers: Q full, Q empty [kBufs]; full, empty [kStages]
  static constexpr int kAlloc = kBar + 8 * (2 * kBufs + 2 * kStages) + 1024;
  static_assert(kAlloc <= 232448, "more shared memory than a block can have");
};

// The i-th item of the CTA's cluster of `cs` CTAs (consecutive blockIdx.x;
// 1 outside the hd-256 dK/dV kernel): rounds of gridDim.x / cs items,
// taken in order in even rounds and in reverse in odd ones, as in the
// forward.
__device__ __forceinline__ int item_index(int i, int cs = 1) {
  const int n = gridDim.x / cs, id = blockIdx.x / cs;
  const int lane = i % 2 == 0 ? id : n - 1 - id;
  return i * n + lane;
}

// A dK/dV item of kKeys keys and the 64-row query tiles [qt_beg, qt_end)
// that see them (empty when no query does: its dK and dV are then zeros).
// Items are numbered by key tile first: under the causal mask the first
// key tiles, which every later query sees, are the heaviest.
struct KvItem {
  int b, kvh, k0, qt_beg, qt_end;
};

template <int kKeys>
__device__ __forceinline__ KvItem kv_item(const Params& p, int w) {
  KvItem it;
  const int per_tile = p.B * p.KVH;
  const int rest = w % per_tile;
  it.b = rest / p.KVH;
  it.kvh = rest % p.KVH;
  it.k0 = (w / per_tile) * kKeys;
  const int k_last = min(it.k0 + kKeys - 1, p.Sk - 1);
  const int q_beg = p.causal ? it.k0 : 0;                        // k <= q
  const int q_end = p.window > 0 ? min(p.Sq, k_last + p.window) : p.Sq;  // q < k + window
  it.qt_beg = q_beg / 64;
  it.qt_end = q_beg < q_end ? (q_end + 63) / 64 : it.qt_beg;
  return it;
}

// A dQ item and the kN-key tiles [kt_beg, kt_end) its rows see; the last
// query tiles (the longest causal rows) come first.
struct QItem {
  int b, h, kvh, q0, kt_beg, kt_end;
};

template <int kN>
__device__ __forceinline__ QItem q_item(const Params& p, int w) {
  QItem it;
  const int per_tile = p.B * p.H;
  const int rest = w % per_tile;
  it.b = rest / p.H;
  it.h = rest % p.H;
  it.kvh = it.h / (p.H / p.KVH);
  it.q0 = (p.n_qtiles - 1 - w / per_tile) * 128;
  const int q_last = min(it.q0 + 128, p.Sq) - 1;
  const int e = p.causal ? min(p.Sk, q_last + 1) : p.Sk;
  const int b = p.window > 0 ? max(0, it.q0 - p.window + 1) : 0;
  it.kt_beg = b / kN;
  it.kt_end = (e + kN - 1) / kN;
  return it;
}

// P (in place of x) and dS (in place of dP) for one (query, key) pair from
// the raw q.k `x`; lse2 = lse * log2 e.  Masked pairs take P = dS = 0.
template <bool kSoftcap>
__device__ __forceinline__ void p_ds(const Params& p, float& x, float& dp, float lse2, float d,
                                     bool keep) {
  float pr, f = 1.f;
  if (kSoftcap) {
    const float th = hopper::tanh_fast(x * p.sm_scale * p.softcap_inv);
    pr = hopper::ex2(fmaf(p.softcap * kLog2e, th, -lse2));
    f = 1.f - th * th;
  } else {
    pr = hopper::ex2(fmaf(x, p.sm_scale * kLog2e, -lse2));
  }
  pr = keep ? pr : 0.f;
  x = pr;
  dp = kSoftcap ? pr * (dp - d) * f : pr * (dp - d);
}

__device__ __forceinline__ bool visible(const Params& p, int q, int key) {
  return (!p.causal || key <= q) && (p.window <= 0 || key > q - p.window);
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// A 64 x HD float32 accumulator (the wgmma layout), times `scale`, as bf16
// into rows [0, 64) of a swizzled tile whose 64-column atoms are `atom`
// bytes apart.
template <int HD>
__device__ __forceinline__ void store_acc(uint32_t dst, int atom, const float (&acc)[HD / 2],
                                          float scale, int warp, int g, int t) {
  const int lr = 16 * warp + g;  // lr % 8 == g: the swizzle's row phase
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const uint32_t a = dst + (j / 8) * atom + lr * kRowBytes + ((j % 8) ^ g) * 16 + 4 * t;
    st_shared(a, hopper::pack_bf16x2(acc[4 * j + 0] * scale, acc[4 * j + 1] * scale));
    st_shared(a + 8 * kRowBytes, hopper::pack_bf16x2(acc[4 * j + 2] * scale, acc[4 * j + 3] * scale));
  }
}

// Rounds an accumulator of n columns to bf16 A fragments of n / 16 steps.
template <int KS>
__device__ __forceinline__ void pack_a(uint32_t (&a)[KS][4], const float (&x)[8 * KS]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    a[kk][0] = hopper::pack_bf16x2(x[8 * kk + 0], x[8 * kk + 1]);
    a[kk][1] = hopper::pack_bf16x2(x[8 * kk + 2], x[8 * kk + 3]);
    a[kk][2] = hopper::pack_bf16x2(x[8 * kk + 4], x[8 * kk + 5]);
    a[kk][3] = hopper::pack_bf16x2(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

__device__ __forceinline__ uint64_t kmajor(uint32_t addr) { return hopper::smem_desc(addr, 16, 1024); }

// P^T and dS^T over one consumer's 64 keys x W queries, rounded to the A
// fragments pa and da 16 queries at a time (so st and dpt die as they are
// packed): rows are keys (key0, key0 + 8 for this thread), columns
// queries from q0; sL, sD the lse * log2 e and D of those queries.
template <int W, bool kSoftcap, bool kMask>
__device__ __forceinline__ void ds_t_tile(const Params& p, float (&st)[W / 2], float (&dpt)[W / 2],
                                          uint32_t (&pa)[W / 16][4], uint32_t (&da)[W / 16][4],
                                          const float* sL, const float* sD, int key0, int q0,
                                          int t) {
#pragma unroll
  for (int j = 0; j < W / 8; ++j) {
    const float2 l2 = *reinterpret_cast<const float2*>(sL + 8 * j + 2 * t);
    const float2 dd = *reinterpret_cast<const float2*>(sD + 8 * j + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int q = q0 + 8 * j + 2 * t + (e & 1);
      const bool keep = !kMask || visible(p, q, key0 + (e >> 1) * 8);
      p_ds<kSoftcap>(p, st[4 * j + e], dpt[4 * j + e], (e & 1) ? l2.y : l2.x, (e & 1) ? dd.y : dd.x,
                     keep);
    }
    const int kk = j / 2, h = (j % 2) * 2;  // A fragment: 8-column blocks 2kk, 2kk + 1
    pa[kk][h] = hopper::pack_bf16x2(st[4 * j + 0], st[4 * j + 1]);
    pa[kk][h + 1] = hopper::pack_bf16x2(st[4 * j + 2], st[4 * j + 3]);
    da[kk][h] = hopper::pack_bf16x2(dpt[4 * j + 0], dpt[4 * j + 1]);
    da[kk][h + 1] = hopper::pack_bf16x2(dpt[4 * j + 2], dpt[4 * j + 3]);
  }
}

// dS over one consumer's 64 queries x N keys: rows are queries (r0, r0 + 8
// for this thread), columns keys from k0.
template <int N, bool kSoftcap, bool kMask>
__device__ __forceinline__ void ds_tile(const Params& p, float (&s)[N / 2], float (&dp)[N / 2],
                                        const float (&lse2)[2], const float (&d)[2], int r0, int k0,
                                        int t) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = k0 + 8 * j + 2 * t + (e & 1);
      const int row = r0 + (e >> 1) * 8;
      const bool keep = !kMask || (key < p.Sk && visible(p, row, key));
      p_ds<kSoftcap>(p, s[4 * j + e], dp[4 * j + e], lse2[e >> 1], d[e >> 1], keep);
    }
  }
}

// Named barriers of the hd-256 dK/dV consumers (1 and 2 are each
// consumer's own): P^T exchange buffer b full (consumer 0 arrives, 1
// syncs) and empty (1 arrives, 0 syncs).
constexpr int kBarPFull = 4, kBarPEmpty = 6;

// P^T over the item's 64 keys x one 64-query tile (in place of S^T) and,
// into the exchange buffer `pf` (float4 [8][128 threads]), P^T times the
// softcap's 1 - tanh^2 (1 without one), from which consumer 1 forms dS^T.
// Rows are keys (key0, key0 + 8 for this thread), columns queries from q0;
// sL the queries' lse * log2 e.  P as p_ds forms it.
template <bool kSoftcap, bool kMask>
__device__ __forceinline__ void p_t_tile(const Params& p, float (&st)[32], float4* pf, const float* sL,
                                         int key0, int q0, int t, int tid) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 l2 = *reinterpret_cast<const float2*>(sL + 8 * j + 2 * t);
    float f[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int q = q0 + 8 * j + 2 * t + (e & 1);
      const bool keep = !kMask || visible(p, q, key0 + (e >> 1) * 8);
      const float lse2 = (e & 1) ? l2.y : l2.x;
      float pr;
      f[e] = 1.f;
      if (kSoftcap) {
        const float th = hopper::tanh_fast(st[4 * j + e] * p.sm_scale * p.softcap_inv);
        pr = hopper::ex2(fmaf(p.softcap * kLog2e, th, -lse2));
        f[e] = 1.f - th * th;
      } else {
        pr = hopper::ex2(fmaf(st[4 * j + e], p.sm_scale * kLog2e, -lse2));
      }
      pr = keep ? pr : 0.f;
      st[4 * j + e] = pr;
      f[e] *= pr;
    }
    pf[j * 128 + tid] = make_float4(f[0], f[1], f[2], f[3]);
  }
}

// dS^T = pf (dP^T - D) in place of dP^T, from consumer 0's exchange buffer
// (0 on masked pairs and on query rows past Sq); sD the queries' D.
__device__ __forceinline__ void ds_t_from(float (&dpt)[32], const float4* pf, const float* sD, int t, int tid) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float4 f = pf[j * 128 + tid];
    const float2 dd = *reinterpret_cast<const float2*>(sD + 8 * j + 2 * t);
    dpt[4 * j + 0] = f.x * (dpt[4 * j + 0] - dd.x);
    dpt[4 * j + 1] = f.y * (dpt[4 * j + 1] - dd.y);
    dpt[4 * j + 2] = f.z * (dpt[4 * j + 2] - dd.x);
    dpt[4 * j + 3] = f.w * (dpt[4 * j + 3] - dd.y);
  }
}

// rows [0, 64) of a 64 x 256 float32 accumulator, times `scale`, as bf16
// into a swizzled tile (atoms `atom` bytes apart): only its 8-column blocks
// [j_lo, j_hi), the columns this CTA of the cluster owns.
__device__ __forceinline__ void store_acc_cols(uint32_t dst, int atom, const float (&acc)[128], float scale,
                                               int warp, int g, int t, int j_lo, int j_hi) {
  const int lr = 16 * warp + g;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    if (j < j_lo || j >= j_hi) continue;
    const uint32_t a = dst + (j / 8) * atom + lr * kRowBytes + ((j % 8) ^ g) * 16 + 4 * t;
    st_shared(a, hopper::pack_bf16x2(acc[4 * j + 0] * scale, acc[4 * j + 1] * scale));
    st_shared(a + 8 * kRowBytes, hopper::pack_bf16x2(acc[4 * j + 2] * scale, acc[4 * j + 3] * scale));
  }
}

// The pair's sum of one consumer's dK and dV partials (64 keys x 128 each)
// after an item at head_dim 128: CTA r owns the 8-column blocks [8 r, 8 r +
// 8) of each; the other CTA's blocks go into its receive area `recv` (its Q
// and dO ring: float4 [consumer][dK, dV][8 blocks][128 threads], 64 KB),
// then it arrives on that CTA's bar_recv; once the other's have arrived,
// each owned block is the two partials added (two addends: the same bits
// in either order, every call), in place in dk and dv.
__device__ __forceinline__ void cluster_sum_128(float (&dk)[64], float (&dv)[64], uint32_t recv,
                                                const unsigned char* grecv, uint32_t bar_recv, int c, int item,
                                                int tid) {
  const int rank = static_cast<int>(hopper::cluster_ctarank());
  const uint32_t other = rank ^ 1;
  // float4 index of (block j % 8 of its owner, tensor x)
  auto at = [&](int j, int x) { return ((c * 2 + x) * 8 + j % 8) * 128 + tid; };
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if (j / 8 == rank) continue;
    hopper::st_cluster(hopper::mapa(recv + 16 * at(j, 0), other), dk[4 * j], dk[4 * j + 1], dk[4 * j + 2],
                       dk[4 * j + 3]);
    hopper::st_cluster(hopper::mapa(recv + 16 * at(j, 1), other), dv[4 * j], dv[4 * j + 1], dv[4 * j + 2],
                       dv[4 * j + 3]);
  }
  // one arrival a warp on the other CTA (a barrier of 128 remote arrivals
  // a sender would take them one at a time): the warp's stores, then lane 0
  // releases them at cluster scope
  hopper::fence_acq_rel_cluster();
  __syncwarp();
  if (tid % 32 == 0) hopper::mbar_arrive_cluster(hopper::mapa(bar_recv, other));
  hopper::mbar_wait_cluster(bar_recv, item % 2);
  const float4* slots = reinterpret_cast<const float4*>(grecv);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if (j / 8 != rank) continue;
    const float4 xk = slots[at(j, 0)], xv = slots[at(j, 1)];
    dk[4 * j] += xk.x, dk[4 * j + 1] += xk.y, dk[4 * j + 2] += xk.z, dk[4 * j + 3] += xk.w;
    dv[4 * j] += xv.x, dv[4 * j + 1] += xv.y, dv[4 * j + 2] += xv.z, dv[4 * j + 3] += xv.w;
  }
}

// This CTA's blocks of one consumer's summed dK (times the scale) and dV
// as bf16, from registers to global memory (its keys key0 and key0 + 8;
// keys past Sk are not written).
__device__ __forceinline__ void store_owned_128(const Params& p, const float (&dk)[64], const float (&dv)[64],
                                                const KvItem& it, int key0, int t) {
  const int rank = static_cast<int>(hopper::cluster_ctarank());
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if (j / 8 != rank) continue;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int key = key0 + 8 * e;
      if (key >= p.Sk) continue;
      const int col = 8 * j + 2 * t;
      *reinterpret_cast<uint32_t*>(p.dk + it.b * p.sdk[0] + key * p.sdk[1] + it.kvh * p.sdk[2] + col) =
          hopper::pack_bf16x2(dk[4 * j + 2 * e] * p.sm_scale, dk[4 * j + 2 * e + 1] * p.sm_scale);
      *reinterpret_cast<uint32_t*>(p.dv + it.b * p.sdv[0] + key * p.sdv[1] + it.kvh * p.sdv[2] + col) =
          hopper::pack_bf16x2(dv[4 * j + 2 * e], dv[4 * j + 2 * e + 1]);
    }
  }
}

// The producer warp of flash_bwd_dkdv_wgmma at head_dim 256, in the 40
// registers setmaxnreg leaves it (kProducerRegs256; what it needs is
// recomputed from the parameters rather than kept).  Per item: once every
// CTA of the cluster is done with the last one, its share of K's and V's atoms
// (atoms rank, rank + cluster, ...) multicast to all of them; then, for
// this CTA's query heads, each 64-row Q and dO tile by TMA and its lse *
// log2 e (+inf past Sq) and D rows by the 32 lanes.
__device__ __forceinline__ void dkdv_producer_hd256(const Params& p, uint32_t base, int n_items) {
  using L = KvShape<256>;
  constexpr int kStages = L::kStages;
  static_assert(L::kBufs == 1, "one K/V buffer at head_dim 256");
  const uint32_t bar_full = base + L::kBar, bar_empty = bar_full + 8 * kStages;
  const uint32_t bar_kv = bar_empty + 8 * kStages, bar_kv_empty = bar_kv + 8;
  const int lane = threadIdx.x % 32;
  int tiles = 0;
  for (int i = 0; item_index(i, p.cluster) < n_items; ++i) {
    const KvItem it = kv_item<L::kKeys>(p, item_index(i, p.cluster));
    const int rank = static_cast<int>(hopper::cluster_ctarank());
    hopper::mbar_wait_cluster(bar_kv_empty, (i % 2) ^ 1);
    if (lane == 0) {
      hopper::mbar_arrive_expect_tx(bar_kv, 2 * L::kKVTile);
      for (int a = rank; a < L::kAtoms; a += p.cluster) {
        const uint32_t off = a * L::kKVAtom;
        if (p.cluster == 1) {
          hopper::tma_load_4d(base + L::kK + off, &p.tk_kv, bar_kv, a * 64, it.kvh, it.k0, it.b);
          hopper::tma_load_4d(base + L::kV + off, &p.tv_kv, bar_kv, a * 64, it.kvh, it.k0, it.b);
        } else {
          const uint16_t all = static_cast<uint16_t>((1u << p.cluster) - 1);
          hopper::tma_load_4d_multicast(base + L::kK + off, &p.tk_kv, bar_kv, a * 64, it.kvh, it.k0, it.b, all);
          hopper::tma_load_4d_multicast(base + L::kV + off, &p.tv_kv, bar_kv, a * 64, it.kvh, it.k0, it.b, all);
        }
      }
    }
    const int nh = p.H / p.KVH / p.cluster;
    const int h_beg = it.kvh * nh * p.cluster + rank * nh;  // this CTA's first query head
    for (int h = h_beg; h < h_beg + nh; ++h) {
      for (int qt = it.qt_beg; qt < it.qt_end; ++qt, ++tiles) {
        const int stage = tiles % kStages;
        hopper::mbar_wait(bar_empty + 8 * stage, ((tiles / kStages) % 2) ^ 1);
        if (lane == 0) {
          hopper::mbar_arrive_expect_tx(bar_full + 8 * stage, 2 * L::kQTile);
          for (int a = 0; a < L::kAtoms; ++a) {
            const uint32_t off = stage * L::kQTile + a * L::kQAtom;
            hopper::tma_load_4d(base + L::kQ + off, &p.tq64, bar_full + 8 * stage, a * 64, h, qt * 64, it.b);
            hopper::tma_load_4d(base + L::kdO + off, &p.tdo64, bar_full + 8 * stage, a * 64, h, qt * 64, it.b);
          }
        }
        for (int r = lane; r < 64; r += 32) {
          const int q = qt * 64 + r;
          const long long at = (static_cast<long long>(it.b) * p.H + h) * p.Sq + q;
          const bool in = q < p.Sq;
          st_shared(base + L::kL + (stage * 64 + r) * 4, __float_as_uint(in ? p.lse[at] * kLog2e : INFINITY));
          st_shared(base + L::kD + (stage * 64 + r) * 4, __float_as_uint(in ? p.delta[at] : 0.f));
        }
        hopper::mbar_arrive(bar_full + 8 * stage);
      }
    }
  }
}

// The cluster's sum of one consumer's partials (dV for consumer 0, dK for
// 1) after an item, for CS = 2 or 4 CTAs: each CTA owns the 8-column blocks
// [rank 32 / CS, (rank + 1) 32 / CS); the blocks another CTA owns go into
// this consumer's slot (its rank among the owner's others) of the owner's
// receive area `recv`, then it arrives on the owner's bar_recv; once all
// the others' have arrived the owned blocks are the CS partials added in
// rank order, in place in acc.
template <int CS>
__device__ __forceinline__ void cluster_sum(float (&acc)[128], uint32_t recv, const unsigned char* grecv,
                                            uint32_t bar_recv, int item, int tid) {
  constexpr int kPer = 32 / CS;
  const int rank = static_cast<int>(hopper::cluster_ctarank());
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int owner = j / kPer;
    if (owner != rank) {
      const int slot = rank < owner ? rank : rank - 1;
      const uint32_t at = recv + ((slot * kPer + j % kPer) * 128 + tid) * 16;
      hopper::st_cluster(hopper::mapa(at, owner), acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
#pragma unroll
  for (int q = 0; q < CS; ++q)
    if (q != rank) hopper::mbar_arrive_cluster(hopper::mapa(bar_recv, q));
  hopper::mbar_wait_cluster(bar_recv, item % 2);
  const float4* slots = reinterpret_cast<const float4*>(grecv);
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    if (j / kPer != rank) continue;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int q = 0; q < CS; ++q) {
      const float4 v = q == rank ? make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3])
                                 : slots[((q < rank ? q : q - 1) * kPer + j % kPer) * 128 + tid];
      sum = q == 0 ? v : make_float4(sum.x + v.x, sum.y + v.y, sum.z + v.z, sum.w + v.w);
    }
    acc[4 * j] = sum.x;
    acc[4 * j + 1] = sum.y;
    acc[4 * j + 2] = sum.z;
    acc[4 * j + 3] = sum.w;
  }
}

// The consumers of flash_bwd_dkdv_wgmma at head_dim 256.  Both take the
// item's 64 keys; a dK or dV accumulator of 64 keys x 256 takes 128 of
// the 232 registers, so each consumer owns one: consumer 0 forms S^T = K
// Q^T and P^T, hands P^T (times the softcap factor) to consumer 1 through
// shared memory, and accumulates dV += P^T dO; consumer 1 forms dP^T = V
// dO^T, takes P^T, and accumulates dK += dS^T Q.  Two products each a
// query tile, the four a tile needs.
//
// The item's G query heads are split over the cluster's `cs` CTAs (rank r
// walks heads r G / cs .. (r + 1) G / cs - 1), so each CTA holds float32
// partials of dK and dV.  After the item every consumer of the cluster
// says it is done with its ring (bar_ready); rank r then owns columns
// [r 256 / cs, (r + 1) 256 / cs): each consumer stores the columns it does
// not own into their owner's ring, in its own slot (the sender's rank
// among the others), and arrives on the owner's bar_recv; the owner adds
// the cs partials of its columns in rank order (the same bits every
// call), rounds them to bf16 over its own K or V buffer and TMA-stores its
// columns.  Then each consumer arrives on every CTA's K/V empty barrier:
// the next item's K and V are multicast into all of them.
template <bool kSoftcap>
__device__ __forceinline__ void dkdv_consumers_hd256(const Params& p, uint32_t base, unsigned char* gbase,
                                                     uint32_t bar_full, uint32_t bar_empty, uint32_t bar_kv,
                                                     uint32_t bar_kv_empty, uint32_t bar_ready, uint32_t bar_recv,
                                                     int n_items, int groups) {
  using L = KvShape<256>;
  constexpr int kStages = L::kStages, kBufs = L::kBufs;
  const int c = threadIdx.x / 128 - 1;  // 0: P^T and dV; 1: dP^T, dS^T and dK
  const int tid = threadIdx.x % 128, lane = threadIdx.x % 32;
  const int warp = tid / 32, g = lane / 4, t = lane % 4;
  const int cs = p.cluster;
  const int nh = groups / cs;  // this CTA's query heads of an item
  float acc[128], s[32];
  uint32_t fa[4][4];
  int tiles = 0, passed = 0;  // ring tiles; P^T tiles exchanged (equal on both consumers)
  auto release = [&](int stage) {
    if (lane == 0) hopper::mbar_arrive(bar_empty + 8 * stage);
  };
  for (int i = 0; item_index(i, cs) < n_items; ++i) {
    const KvItem it = kv_item<L::kKeys>(p, item_index(i, cs));
    const int kb = i % kBufs;
    const int key0 = it.k0 + 16 * warp + g;  // this thread's keys: key0, key0 + 8
    const uint32_t sK = base + L::kK + kb * L::kKVTile;
    const uint32_t sV = base + L::kV + kb * L::kKVTile;
#pragma unroll
    for (int j = 0; j < 128; ++j) acc[j] = 0.f;
    hopper::mbar_wait(bar_kv + 8 * kb, (i / kBufs) % 2);
    int pending = -1;  // the stage the product in flight reads
    for (int hh = 0; hh < nh; ++hh) {
      for (int qt = it.qt_beg; qt < it.qt_end; ++qt, ++tiles) {
        const int stage = tiles % kStages;
        const int q0 = qt * 64;
        hopper::mbar_wait(bar_full + 8 * stage, (tiles / kStages) % 2);
        const uint32_t sQ = base + L::kQ + stage * L::kQTile;
        const uint32_t sdO = base + L::kdO + stage * L::kQTile;
        // S^T = K Q^T (consumer 0) or dP^T = V dO^T (consumer 1): 64 keys x
        // 64 queries, both K-major; the previous tile's dV or dK product
        // may still run.  (Every query tile of an item sees a key of it.)
        const uint32_t sa = c == 0 ? sK : sV, sb = c == 0 ? sQ : sdO;
        hopper::fence_regs(s);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 16; ++kk) {
          const uint32_t col = (kk % 4) * 32;
          hopper::wgmma_ss<64>(s, kmajor(sa + (kk / 4) * L::kKVAtom + col), kmajor(sb + (kk / 4) * L::kQAtom + col),
                               kk > 0);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(s);
        hopper::fence_regs(acc);
        hopper::fence_regs(fa);
        if (pending >= 0) release(pending);  // the previous tile's stage
        float4* pf = reinterpret_cast<float4*>(gbase + L::kP) + (passed % 2) * 8 * 128;
        if (c == 0) {
          const float* sL = reinterpret_cast<const float*>(gbase + L::kL) + stage * 64;
          if (passed >= 2) hopper::named_barrier_sync(kBarPEmpty + passed % 2, 256);
          if ((p.causal && it.k0 + 63 > q0) || (p.window > 0 && it.k0 <= q0 + 63 - p.window)) {
            p_t_tile<kSoftcap, true>(p, s, pf, sL, key0, q0, t, tid);
          } else {
            p_t_tile<kSoftcap, false>(p, s, pf, sL, key0, q0, t, tid);
          }
          __threadfence_block();
          hopper::named_barrier_arrive(kBarPFull + passed % 2, 256);
        } else {
          const float* sD = reinterpret_cast<const float*>(gbase + L::kD) + stage * 64;
          hopper::named_barrier_sync(kBarPFull + passed % 2, 256);
          ds_t_from(s, pf, sD, t, tid);
          __threadfence_block();
          hopper::named_barrier_arrive(kBarPEmpty + passed % 2, 256);
        }
        ++passed;
        pack_a<4>(fa, s);
        // dV += P^T dO (consumer 0) or dK += dS^T Q (consumer 1): 4 steps of
        // 16 queries, dO or Q MN-major.
        const uint32_t sm = c == 0 ? sdO : sQ;
        hopper::fence_regs(acc);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) hopper::wgmma_rs_hd<256>(acc, fa[kk], sm + kk * 16 * kRowBytes, L::kQAtom);
        hopper::wgmma_commit();
        pending = stage;
      }
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    hopper::fence_regs(fa);
    if (pending >= 0) release(pending);

    // Every consumer of the cluster is done with its ring and its K and V.
    hopper::named_barrier_sync(1 + c, 128);
    if (tid == 0)
      for (int q = 0; q < cs; ++q) hopper::mbar_arrive_cluster(hopper::mapa(bar_ready, q));
    hopper::mbar_wait_cluster(bar_ready, i % 2);
    // this consumer's receive area: its ring's Q (consumer 0) or dO (1) stages
    const int recv = c == 0 ? L::kQ : L::kdO;
    if (cs == 2) cluster_sum<2>(acc, base + recv, gbase + recv, bar_recv + 8 * c, i, tid);
    if (cs == 4) cluster_sum<4>(acc, base + recv, gbase + recv, bar_recv + 8 * c, i, tid);

    // Epilogue: this CTA's columns of dV into V's buffer (consumer 0), of
    // dK * scale into K's (consumer 1), as bf16 in the swizzled layout, then
    // TMA stores (rows past Sk dropped); then every CTA's K/V buffer may
    // take the next item's multicast.
    const uint32_t dst = c == 0 ? sV : sK;
    const int rank = static_cast<int>(hopper::cluster_ctarank()), per = 32 / cs;
    store_acc_cols(dst, L::kKVAtom, acc, c == 0 ? 1.f : p.sm_scale, warp, g, t, rank * per, (rank + 1) * per);
    hopper::fence_proxy_async();
    hopper::named_barrier_sync(1 + c, 128);
    if (tid == 0) {
      if (it.k0 < p.Sk) {
        for (int a = rank * L::kAtoms / cs; a < (rank + 1) * L::kAtoms / cs; ++a)
          hopper::tma_store_4d(c == 0 ? &p.tdv : &p.tdk, dst + a * L::kKVAtom, a * 64, it.kvh, it.k0, it.b);
        hopper::tma_store_wait_read();
      }
      for (int q = 0; q < cs; ++q) hopper::mbar_arrive_cluster(hopper::mapa(bar_kv_empty + 8 * kb, q));
    }
  }
  // consumer 1's last two arrivals on the empty barriers, taken
  if (c == 0)
    for (int n = max(0, passed - 2); n < passed; ++n) hopper::named_barrier_sync(kBarPEmpty + n % 2, 256);
}

// Registers of the hd-256 dK/dV kernel's producer and consumer warpgroups
// after setmaxnreg (128 x producer + 256 x consumer = the 384 x 168 the
// launch has).  The producer's multicast and head split spilled at 24
// (24 bytes); the consumers fit 232 with no spill (ptxas, on the card).
constexpr int kProducerRegs256 = 40, kConsumerRegs256 = 232;

// kCluster: the instance whose items' query heads a pair of CTAs splits at
// head_dim 128 (at 256 every instance takes p.cluster; at 128 the lone
// instance keeps cs = 1 at compile time, and its registers).
template <int HD, bool kSoftcap, bool kCluster = false>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkdv_wgmma(const __grid_constant__ Params p) {
  static_assert(HD == 64 || HD == 128 || HD == 256, "head_dim 64, 128 or 256");
  using L = KvShape<HD>;
  constexpr int kStages = L::kStages, kBufs = L::kBufs;
  constexpr int NO = HD / 2;  // dK, dV accumulator floats per thread
  // Queries per pass of a 64-row tile: at hd 128 two passes of 32, so that
  // dK, dV, S^T, dP^T and the A fragments fit the consumers' 240 registers
  // while the next pass's S^T and dP^T are issued beside this pass's dV and
  // dK (one 64-query pass there spilled, and waiting for dV and dK first
  // measured slower at the GQA shape).
  constexpr int kW = HD == 64 ? 64 : 32;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);  // the same bytes, generic
  const uint32_t bar_full = base + L::kBar;        // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * kStages;
  const uint32_t bar_kv = bar_empty + 8 * kStages;  // + 8 * buffer
  const uint32_t bar_kv_empty = bar_kv + 8 * kBufs;
  const uint32_t bar_ready = bar_kv_empty + 8 * kBufs;  // head_dim 128 and 256
  const uint32_t bar_recv = bar_ready + 8;              // + 8 * consumer
  const int n_items = p.n_ktiles * p.B * p.KVH;
  const int groups = p.H / p.KVH;
  const int lane = threadIdx.x % 32;
  // CTAs a cluster: at head_dim 256 (p.cluster) and 128 (kCluster: a pair)
  // each takes a share of an item's query heads
  static_assert(!kCluster || HD == 128, "the kCluster instance is head_dim 128's");
  static_assert(!kCluster || L::kBufs == 1,
                "the pair's sum reuses the Q/dO ring: the next item's loads must wait for bar_kv_empty");
  static_assert(!kCluster || 2 * 2 * 8 * 128 * 16 <= L::kP - L::kQ, "the receive area fits the Q/dO ring");
  const int cs = HD == 256 ? p.cluster : kCluster ? 2 : 1;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(bar_full + 8 * s, 33);  // the TMA's bytes + 32 producer lanes' lse and D
      hopper::mbar_init(bar_empty + 8 * s, 8);  // one lane of each consumer warp
    }
    for (int b = 0; b < kBufs; ++b) {
      hopper::mbar_init(bar_kv + 8 * b, 1);
      hopper::mbar_init(bar_kv_empty + 8 * b, 2 * cs);  // one thread of each consumer (of the cluster), after its store
    }
    if constexpr (HD >= 128) {
      hopper::mbar_init(bar_ready, 2 * cs);  // one thread of each consumer of the cluster
      // the senders' threads (head_dim 256) or the other CTA's warps (128)
      for (int c = 0; c < 2; ++c) hopper::mbar_init(bar_recv + 8 * c, cs > 1 ? (HD == 256 ? 128 : 4) * (cs - 1) : 1);
    }
    hopper::mbar_init_fence();
  }
  if (HD == 256 || cs > 1) {
    hopper::cluster_sync();  // the cluster's barriers are initialised before any CTA uses another's
  } else {
    __syncthreads();
  }

  if (threadIdx.x / 128 == 0) {
    // ---- producer: warp 0; lane 0 issues the TMA loads ----
    hopper::setmaxnreg_dec<HD == 256 ? kProducerRegs256 : 24>();
    if constexpr (HD == 256) {
      if (threadIdx.x < 32) dkdv_producer_hd256(p, base, n_items);
    } else if (threadIdx.x < 32) {
      // Rank r of a cluster (head_dim 128) takes the r-th share of an
      // item's query heads, and loads its share of K's and V's atoms into
      // every CTA of it once every consumer of the cluster is done with the
      // last item; a lone CTA (cs = 1) takes them all.
      const int nh = groups / cs;  // this CTA's query heads of an item
      int tiles = 0;
      for (int i = 0; item_index(i, cs) < n_items; ++i) {
        const KvItem it = kv_item<L::kKeys>(p, item_index(i, cs));
        const int kb = i % kBufs;
        const int rank = cs > 1 ? static_cast<int>(hopper::cluster_ctarank()) : 0;
        if (cs > 1) {
          hopper::mbar_wait_cluster(bar_kv_empty + 8 * kb, ((i / kBufs) % 2) ^ 1);
        } else {
          hopper::mbar_wait(bar_kv_empty + 8 * kb, ((i / kBufs) % 2) ^ 1);
        }
        if (lane == 0) {
          hopper::mbar_arrive_expect_tx(bar_kv + 8 * kb, 2 * L::kKVTile);
          for (int a = 0; a < L::kAtoms; ++a) {
            const uint32_t off = kb * L::kKVTile + a * L::kKVAtom;
            if (cs > 1) {
              const uint16_t all = static_cast<uint16_t>((1u << cs) - 1);
              if ((2 * a) % cs == rank)
                hopper::tma_load_4d_multicast(base + L::kK + off, &p.tk_kv, bar_kv + 8 * kb, a * 64, it.kvh, it.k0,
                                              it.b, all);
              if ((2 * a + 1) % cs == rank)
                hopper::tma_load_4d_multicast(base + L::kV + off, &p.tv_kv, bar_kv + 8 * kb, a * 64, it.kvh, it.k0,
                                              it.b, all);
            } else {
              hopper::tma_load_4d(base + L::kK + off, &p.tk_kv, bar_kv + 8 * kb, a * 64, it.kvh, it.k0, it.b);
              hopper::tma_load_4d(base + L::kV + off, &p.tv_kv, bar_kv + 8 * kb, a * 64, it.kvh, it.k0, it.b);
            }
          }
        }
        for (int hh = 0; hh < nh; ++hh) {
          const int h = it.kvh * groups + rank * nh + hh;
          const long long row = (static_cast<long long>(it.b) * p.H + h) * p.Sq;
          for (int qt = it.qt_beg; qt < it.qt_end; ++qt, ++tiles) {
            const int stage = tiles % kStages;
            hopper::mbar_wait(bar_empty + 8 * stage, ((tiles / kStages) % 2) ^ 1);
            if (lane == 0) {
              hopper::mbar_arrive_expect_tx(bar_full + 8 * stage, 2 * L::kQTile);
              for (int a = 0; a < L::kAtoms; ++a) {
                const uint32_t off = stage * L::kQTile + a * L::kQAtom;
                hopper::tma_load_4d(base + L::kQ + off, &p.tq64, bar_full + 8 * stage, a * 64, h, qt * 64, it.b);
                hopper::tma_load_4d(base + L::kdO + off, &p.tdo64, bar_full + 8 * stage, a * 64, h, qt * 64, it.b);
              }
            }
            float* sL = reinterpret_cast<float*>(gbase + L::kL) + stage * 64;
            float* sD = reinterpret_cast<float*>(gbase + L::kD) + stage * 64;
            for (int r = lane; r < 64; r += 32) {
              const int q = qt * 64 + r;
              const bool in = q < p.Sq;
              sL[r] = in ? p.lse[row + q] * kLog2e : INFINITY;
              sD[r] = in ? p.delta[row + q] : 0.f;
            }
            hopper::mbar_arrive(bar_full + 8 * stage);
          }
        }
      }
    }
  } else if constexpr (HD == 256) {
    hopper::setmaxnreg_inc<kConsumerRegs256>();
    dkdv_consumers_hd256<kSoftcap>(p, base, gbase, bar_full, bar_empty, bar_kv, bar_kv_empty, bar_ready, bar_recv,
                                   n_items, groups);
  } else {
    // ---- consumers: 64 keys of each item ----
    hopper::setmaxnreg_inc<240>();
    const int c = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x % 128) / 32, g = lane / 4, t = lane % 4;
    float dk[NO], dv[NO], st[kW / 2], dpt[kW / 2];
    uint32_t pa[kW / 16][4], da[kW / 16][4];
    int tiles = 0;
    auto release = [&](int stage) {
      if (lane == 0) hopper::mbar_arrive(bar_empty + 8 * stage);
    };
    const int nh = groups / cs;  // this CTA's query heads of an item
    for (int i = 0; item_index(i, cs) < n_items; ++i) {
      const KvItem it = kv_item<L::kKeys>(p, item_index(i, cs));
      const int kb = i % kBufs;
      const int kc0 = it.k0 + 64 * c;      // this consumer's first key
      const int key0 = kc0 + 16 * warp + g;  // this thread's keys: key0, key0 + 8
      // this consumer's rows of each atom of the item's K and V
      const uint32_t sK = base + L::kK + kb * L::kKVTile + c * 64 * kRowBytes;
      const uint32_t sV = base + L::kV + kb * L::kKVTile + c * 64 * kRowBytes;
#pragma unroll
      for (int j = 0; j < NO; ++j) dk[j] = dv[j] = 0.f;
      hopper::mbar_wait(bar_kv + 8 * kb, (i / kBufs) % 2);
      int pending = -1;  // the stage the products in flight read
      for (int hh = 0; hh < nh; ++hh) {
        for (int qt = it.qt_beg; qt < it.qt_end; ++qt, ++tiles) {
          const int stage = tiles % kStages;
          const int q0 = qt * 64;
          hopper::mbar_wait(bar_full + 8 * stage, (tiles / kStages) % 2);
          if (kc0 >= p.Sk || (p.causal && kc0 > q0 + 63) ||
              (p.window > 0 && kc0 + 63 <= q0 - p.window)) {
            // no key of this consumer is seen by a query of the tile: free it,
            // and the one the products in flight read (the ring must not stall)
            release(stage);
            if (pending >= 0) {
              hopper::wgmma_wait<0>();
              hopper::fence_regs(dk);
              hopper::fence_regs(dv);
              release(pending);
              pending = -1;
            }
            continue;
          }
          const uint32_t sQ = base + L::kQ + stage * L::kQTile;
          const uint32_t sdO = base + L::kdO + stage * L::kQTile;
#pragma unroll 1
          for (int sub = 0; sub < 64 / kW; ++sub) {
            const int qs = q0 + sub * kW;  // this pass's first query
            const uint32_t row = sub * kW * kRowBytes;
            // S^T = K Q^T and dP^T = V dO^T (64 keys x kW queries), both
            // K-major; the previous pass's dV and dK products may still run.
            hopper::fence_regs(st);
            hopper::fence_regs(dpt);
            hopper::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < HD / 16; ++kk) {
              const uint32_t col = (kk % 4) * 32;
              hopper::wgmma_ss<kW>(st, kmajor(sK + (kk / 4) * L::kKVAtom + col),
                                   kmajor(sQ + (kk / 4) * L::kQAtom + row + col), kk > 0);
              hopper::wgmma_ss<kW>(dpt, kmajor(sV + (kk / 4) * L::kKVAtom + col),
                                   kmajor(sdO + (kk / 4) * L::kQAtom + row + col), kk > 0);
            }
            hopper::wgmma_commit();
            hopper::wgmma_wait<0>();
            hopper::fence_regs(st);
            hopper::fence_regs(dpt);
            hopper::fence_regs(dk);
            hopper::fence_regs(dv);
            hopper::fence_regs(pa);
            hopper::fence_regs(da);
            if (pending >= 0 && pending != stage) release(pending);  // the last pass's stage
            const float* sL = reinterpret_cast<const float*>(gbase + L::kL) + stage * 64 + sub * kW;
            const float* sD = reinterpret_cast<const float*>(gbase + L::kD) + stage * 64 + sub * kW;
            if ((p.causal && kc0 + 63 > qs) || (p.window > 0 && kc0 <= qs + kW - 1 - p.window)) {
              ds_t_tile<kW, kSoftcap, true>(p, st, dpt, pa, da, sL, sD, key0, qs, t);
            } else {
              ds_t_tile<kW, kSoftcap, false>(p, st, dpt, pa, da, sL, sD, key0, qs, t);
            }
            // dV += P^T dO and dK += dS^T Q: kW / 16 steps of 16 queries, dO
            // and Q MN-major.
            hopper::fence_regs(dk);
            hopper::fence_regs(dv);
            hopper::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < kW / 16; ++kk) {
              const uint32_t at = row + kk * 16 * kRowBytes;
              hopper::wgmma_rs<HD>(dv, pa[kk], hopper::smem_desc(sdO + at, L::kQAtom, 1024), 1);
              hopper::wgmma_rs<HD>(dk, da[kk], hopper::smem_desc(sQ + at, L::kQAtom, 1024), 1);
            }
            hopper::wgmma_commit();
            pending = stage;
          }
        }
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dk);
      hopper::fence_regs(dv);
      hopper::fence_regs(pa);
      hopper::fence_regs(da);
      if (pending >= 0) release(pending);

      if constexpr (kCluster) {
        // Every consumer of the pair is done with its ring and its K and
        // V; the partials are summed into the columns each CTA owns, which
        // it stores; then both CTAs' K/V buffers may take the next item's
        // multicast (and only then their rings the next item's Q and dO).
        const int tid = threadIdx.x % 128;
        hopper::named_barrier_sync(1 + c, 128);
        if (tid == 0)
          for (int q = 0; q < cs; ++q) hopper::mbar_arrive_cluster(hopper::mapa(bar_ready, q));
        hopper::mbar_wait_cluster(bar_ready, i % 2);
        cluster_sum_128(dk, dv, base + L::kQ, gbase + L::kQ, bar_recv + 8 * c, c, i, tid);
        store_owned_128(p, dk, dv, it, key0, t);
        hopper::named_barrier_sync(1 + c, 128);  // this consumer's receive area is read
        if (tid == 0)
          for (int q = 0; q < cs; ++q) hopper::mbar_arrive_cluster(hopper::mapa(bar_kv_empty + 8 * kb, q));
        continue;
      }

      // Epilogue: dK * scale and dV as bf16 over this consumer's own K and V
      // rows, then TMA stores (rows past Sk dropped); then the buffer is free.
      store_acc<HD>(sK, L::kKVAtom, dk, p.sm_scale, warp, g, t);
      store_acc<HD>(sV, L::kKVAtom, dv, 1.f, warp, g, t);
      hopper::fence_proxy_async();
      hopper::named_barrier_sync(1 + c, 128);
      if (threadIdx.x % 128 == 0) {
        if (kc0 < p.Sk) {
          for (int a = 0; a < L::kAtoms; ++a) {
            hopper::tma_store_4d(&p.tdk, sK + a * L::kKVAtom, a * 64, it.kvh, kc0, it.b);
            hopper::tma_store_4d(&p.tdv, sV + a * L::kKVAtom, a * 64, it.kvh, kc0, it.b);
          }
          hopper::tma_store_wait_read();
        }
        hopper::mbar_arrive(bar_kv_empty + 8 * kb);
      }
    }
  }
  // no CTA of a cluster leaves while another may still arrive on its barriers
  if (HD == 256 || cs > 1) hopper::cluster_sync();
}

template <int HD, bool kSoftcap>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_wgmma(const __grid_constant__ Params p) {
  static_assert(HD == 64 || HD == 128 || HD == 256, "head_dim 64, 128 or 256");
  using L = DqShape<HD>;
  constexpr int kStages = L::kStages, kBufs = L::kBufs, kN = L::kN;
  constexpr int NO = HD / 2;  // dQ accumulator floats per thread
  constexpr int NS = kN / 2;  // S, dP accumulator floats per thread
  constexpr int KS = kN / 16;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (hopper::smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_q = base + L::kBar;  // + 8 * buffer
  const uint32_t bar_q_empty = bar_q + 8 * kBufs;
  const uint32_t bar_full = bar_q_empty + 8 * kBufs;  // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * kStages;
  const int n_items = p.n_qtiles * p.B * p.H;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int b = 0; b < kBufs; ++b) {
      hopper::mbar_init(bar_q + 8 * b, 1);
      hopper::mbar_init(bar_q_empty + 8 * b, 2);  // one thread of each consumer, after its store
    }
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(bar_full + 8 * s, 1);
      hopper::mbar_init(bar_empty + 8 * s, 8);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x / 128 == 0) {
    // ---- producer ----
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      int tiles = 0;
      for (int i = 0; item_index(i) < n_items; ++i) {
        const QItem it = q_item<kN>(p, item_index(i));
        const int qb = i % kBufs;
        hopper::mbar_wait(bar_q_empty + 8 * qb, ((i / kBufs) % 2) ^ 1);
        hopper::mbar_arrive_expect_tx(bar_q + 8 * qb, 2 * L::kQTile);
        for (int a = 0; a < L::kAtoms; ++a) {
          const uint32_t off = qb * L::kQTile + a * L::kQAtom;
          hopper::tma_load_4d(base + L::kQ + off, &p.tq128, bar_q + 8 * qb, a * 64, it.h, it.q0, it.b);
          hopper::tma_load_4d(base + L::kdO + off, &p.tdo128, bar_q + 8 * qb, a * 64, it.h, it.q0, it.b);
        }
        for (int kt = it.kt_beg; kt < it.kt_end; ++kt, ++tiles) {
          const int stage = tiles % kStages;
          hopper::mbar_wait(bar_empty + 8 * stage, ((tiles / kStages) % 2) ^ 1);
          hopper::mbar_arrive_expect_tx(bar_full + 8 * stage, 2 * L::kKTile);
          for (int a = 0; a < L::kAtoms; ++a) {
            const uint32_t off = stage * L::kKTile + a * L::kKAtom;
            hopper::tma_load_4d(base + L::kK + off, &p.tk_dq, bar_full + 8 * stage, a * 64, it.kvh, kt * kN, it.b);
            hopper::tma_load_4d(base + L::kV + off, &p.tv_dq, bar_full + 8 * stage, a * 64, it.kvh, kt * kN, it.b);
          }
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows of each item ----
    hopper::setmaxnreg_inc<240>();
    const int c = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x % 128) / 32, g = lane / 4, t = lane % 4;
    float dq[NO], s[NS], dp[NS];
    uint32_t da[KS][4];
    int tiles = 0;
    auto release = [&](int stage) {
      if (lane == 0) hopper::mbar_arrive(bar_empty + 8 * stage);
    };
    for (int i = 0; item_index(i) < n_items; ++i) {
      const QItem it = q_item<kN>(p, item_index(i));
      const int qb = i % kBufs;
      const int wg_row0 = it.q0 + 64 * c;      // first row of this warpgroup
      const int r0 = wg_row0 + 16 * warp + g;  // this thread's rows: r0, r0 + 8
      const uint32_t sQ = base + L::kQ + qb * L::kQTile + c * 64 * kRowBytes;  // its rows of each atom
      const uint32_t sdO = base + L::kdO + qb * L::kQTile + c * 64 * kRowBytes;
      float lse2[2], d[2];
      const long long row = (static_cast<long long>(it.b) * p.H + it.h) * p.Sq;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = r0 + 8 * e;
        lse2[e] = r < p.Sq ? p.lse[row + r] * kLog2e : INFINITY;
        d[e] = r < p.Sq ? p.delta[row + r] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < NO; ++j) dq[j] = 0.f;
      hopper::mbar_wait(bar_q + 8 * qb, (i / kBufs) % 2);
      int pending = -1;
      for (int kt = it.kt_beg; kt < it.kt_end; ++kt, ++tiles) {
        const int stage = tiles % kStages;
        const int k0 = kt * kN;
        hopper::mbar_wait(bar_full + 8 * stage, (tiles / kStages) % 2);
        if (wg_row0 >= p.Sq || (p.causal && k0 > wg_row0 + 63) ||
            (p.window > 0 && k0 + kN - 1 <= wg_row0 - p.window)) {
          // no row of this consumer sees a key of the tile: free it, and the
          // one the product in flight reads (the ring must not stall)
          release(stage);
          if (pending >= 0) {
            hopper::wgmma_wait<0>();
            hopper::fence_regs(dq);
            release(pending);
            pending = -1;
          }
          continue;
        }
        const uint32_t sK = base + L::kK + stage * L::kKTile;
        const uint32_t sV = base + L::kV + stage * L::kKTile;
        // S = Q K^T and dP = dO V^T (64 rows x kN keys), both K-major; the
        // previous tile's dQ product may still run.
        hopper::fence_regs(s);
        hopper::fence_regs(dp);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const uint32_t col = (kk % 4) * 32;
          hopper::wgmma_ss<kN>(s, kmajor(sQ + (kk / 4) * L::kQAtom + col), kmajor(sK + (kk / 4) * L::kKAtom + col), kk > 0);
          hopper::wgmma_ss<kN>(dp, kmajor(sdO + (kk / 4) * L::kQAtom + col), kmajor(sV + (kk / 4) * L::kKAtom + col), kk > 0);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(s);
        hopper::fence_regs(dp);
        hopper::fence_regs(dq);
        hopper::fence_regs(da);
        if (pending >= 0) release(pending);
        if (k0 + kN > p.Sk || (p.causal && k0 + kN - 1 > wg_row0) ||
            (p.window > 0 && k0 <= wg_row0 + 63 - p.window)) {
          ds_tile<kN, kSoftcap, true>(p, s, dp, lse2, d, r0, k0, t);
        } else {
          ds_tile<kN, kSoftcap, false>(p, s, dp, lse2, d, r0, k0, t);
        }
        pack_a(da, dp);
        // dQ += dS K: kN / 16 steps of 16 keys, K MN-major.
        hopper::fence_regs(dq);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          hopper::wgmma_rs_hd<HD>(dq, da[kk], sK + kk * 16 * kRowBytes, L::kKAtom);
        hopper::wgmma_commit();
        pending = stage;
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dq);
      hopper::fence_regs(da);
      if (pending >= 0) release(pending);

      // Epilogue: dQ * scale as bf16 over this warpgroup's rows of the Q
      // buffer, one TMA store (rows past Sq dropped); then the buffer is free.
      store_acc<HD>(sQ, L::kQAtom, dq, p.sm_scale, warp, g, t);
      hopper::fence_proxy_async();
      hopper::named_barrier_sync(1 + c, 128);
      if (threadIdx.x % 128 == 0) {
        if (wg_row0 < p.Sq) {
          for (int a = 0; a < L::kAtoms; ++a)
            hopper::tma_store_4d(&p.tdq, sQ + a * L::kQAtom, a * 64, it.h, wg_row0, it.b);
          hopper::tma_store_wait_read();
        }
        hopper::mbar_arrive(bar_q_empty + 8 * qb);
      }
    }
  }
}

template <typename Kernel>
cudaError_t launch_persistent(Kernel kernel, const Params& p, long long n_items, int smem,
                              cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int device, sms;
  if (e == cudaSuccess) e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  const int grid = static_cast<int>(n_items < sms ? n_items : sms);  // one CTA per SM
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// dK/dV, then dQ (D must be written already).
template <int HD>
int launch(const Args& a, int kv_cluster, cudaStream_t stream) {
  hopper::EncodeTiled fn;
  cudaError_t e = hopper::encode_fn(&fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  Params p;
  constexpr int kN = DqShape<HD>::kN;
  constexpr int kKeys = KvShape<HD>::kKeys;
  const struct {
    CUtensorMap* map;
    const void* ptr;
    int heads, seq;
    const long long* st;
    int rows;
  } maps[] = {
      {&p.tq64, a.q, a.H, a.Sq, a.sq, 64},      {&p.tdo64, a.dout, a.H, a.Sq, a.sdo, 64},
      {&p.tk_kv, a.k, a.KVH, a.Sk, a.sk, kKeys}, {&p.tv_kv, a.v, a.KVH, a.Sk, a.sv, kKeys},
      {&p.tq128, a.q, a.H, a.Sq, a.sq, 128},    {&p.tdo128, a.dout, a.H, a.Sq, a.sdo, 128},
      {&p.tk_dq, a.k, a.KVH, a.Sk, a.sk, kN},   {&p.tv_dq, a.v, a.KVH, a.Sk, a.sv, kN},
      {&p.tdq, a.dq, a.H, a.Sq, a.sdq, 64},     {&p.tdk, a.dk, a.KVH, a.Sk, a.sdk, 64},
      {&p.tdv, a.dv, a.KVH, a.Sk, a.sdv, 64},
  };
  for (const auto& m : maps) {
    const int err = hopper::encode(fn, m.map, m.ptr, HD, m.heads, m.seq, a.B, m.st, m.rows);
    if (err) return err;
  }
  p.lse = a.lse;
  p.delta = a.delta;
  p.B = a.B;
  p.H = a.H;
  p.KVH = a.KVH;
  p.Sq = a.Sq;
  p.Sk = a.Sk;
  p.causal = a.causal;
  p.window = a.window;
  p.softcap = a.softcap;
  p.softcap_inv = a.softcap > 0.f ? 1.f / a.softcap : 0.f;
  p.sm_scale = a.sm_scale;
  p.n_ktiles = (a.Sk + kKeys - 1) / kKeys;
  p.n_qtiles = (a.Sq + 127) / 128;
  p.cluster = kv_cluster;
  p.dk = static_cast<bf16*>(a.dk);
  p.dv = static_cast<bf16*>(a.dv);
  for (int i = 0; i < 3; ++i) {
    p.sdk[i] = a.sdk[i];
    p.sdv[i] = a.sdv[i];
  }
  // cluster sizes (ops.py::KV_CLUSTER_SIZES): 1, 2, 4 at head_dim 256; 1, 2
  // at 128; 1 at 64
  const bool size_ok = HD == 256   ? kv_cluster == 1 || kv_cluster == 2 || kv_cluster == 4
                       : HD == 128 ? kv_cluster == 1 || kv_cluster == 2
                                   : kv_cluster == 1;
  if (!size_ok || (a.H / a.KVH) % kv_cluster) return static_cast<int>(cudaErrorInvalidValue);
  const long long kv_items = static_cast<long long>(p.n_ktiles) * a.B * a.KVH;
  const long long q_items = static_cast<long long>(p.n_qtiles) * a.B * a.H;
  if (kv_items > 0x7fffffffLL || q_items > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const bool cap = a.softcap > 0.f;
  auto dkdv = cap ? &flash_bwd_dkdv_wgmma<HD, true> : &flash_bwd_dkdv_wgmma<HD, false>;
  if constexpr (HD == 128) {
    if (kv_cluster > 1)
      dkdv = cap ? &flash_bwd_dkdv_wgmma<128, true, true> : &flash_bwd_dkdv_wgmma<128, false, true>;
  }
  e = HD == 256 || kv_cluster > 1
          ? hopper::launch_clusters(dkdv, p, kv_cluster, kThreads, kv_items, KvShape<HD>::kAlloc, stream)
          : launch_persistent(dkdv, p, kv_items, KvShape<HD>::kAlloc, stream);
  if (e == cudaSuccess)
    e = launch_persistent(cap ? &flash_bwd_dq_wgmma<HD, true> : &flash_bwd_dq_wgmma<HD, false>, p,
                          q_items, DqShape<HD>::kAlloc, stream);
  return static_cast<int>(e);
}

}  // namespace wg

template <typename Kernel>
cudaError_t launch(Kernel kernel, const Args& a, dim3 grid, int threads, size_t smem,
                   cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

// Routes, as ops.py::bwd_route names them.
constexpr int kRouteF32 = 0;
constexpr int kRouteMmaSync = 1;
constexpr int kRouteWgmma = 2;

int dispatch(int route, const Args& a, int kv_cluster, cudaStream_t stream) {
  const long long rows = (long long)a.B * a.H * a.Sq;
  const dim3 grid_delta(static_cast<unsigned>((rows + 7) / 8));
  const dim3 grid_kv((a.Sk + kBlockN - 1) / kBlockN, a.KVH, a.B);
  const dim3 grid_q((a.Sq + kBlockM - 1) / kBlockM, a.H, a.B);
  cudaError_t e;
  if (route == kRouteWgmma && (a.hd == 64 || a.hd == 128 || a.hd == 256)) {
    const dim3 grid_vec(static_cast<unsigned>((rows * (a.hd / 8) + 255) / 256));
    e = launch(a.hd == 64 ? delta_kernel_vec<64> : a.hd == 128 ? delta_kernel_vec<128> : delta_kernel_vec<256>, a,
               grid_vec, 256, 0, stream);
    if (e != cudaSuccess) return static_cast<int>(e);
    return a.hd == 64    ? wg::launch<64>(a, kv_cluster, stream)
           : a.hd == 128 ? wg::launch<128>(a, kv_cluster, stream)
                         : wg::launch<256>(a, kv_cluster, stream);
  }
  if (kv_cluster != 1) return static_cast<int>(cudaErrorInvalidValue);  // only the wgmma route splits
  if (route == kRouteMmaSync && (a.hd == 16 || a.hd == 96)) {
    e = launch(delta_kernel<bf16>, a, grid_delta, 256, 0, stream);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (a.hd == 16) {
      e = launch(flash_bwd_dkdv_bf16<16>, a, grid_kv, kWarps * 32, dkdv_bf16_smem<16>(), stream);
      if (e == cudaSuccess)
        e = launch(flash_bwd_dq_bf16<16>, a, grid_q, kWarps * 32, dq_bf16_smem<16>(), stream);
    } else {
      e = launch(flash_bwd_dkdv_bf16<96>, a, grid_kv, kWarps * 32, dkdv_bf16_smem<96>(), stream);
      if (e == cudaSuccess)
        e = launch(flash_bwd_dq_bf16<96>, a, grid_q, kWarps * 32, dq_bf16_smem<96>(), stream);
    }
    return static_cast<int>(e);
  }
  if (route == kRouteF32 && (a.hd == 16 || a.hd == 64 || a.hd == 96 || a.hd == 128 || a.hd == 256)) {
    e = launch(delta_kernel<float>, a, grid_delta, 256, 0, stream);
    if (e != cudaSuccess) return static_cast<int>(e);
    switch (a.hd) {
      case 16:
        e = launch(flash_bwd_dkdv_f32<16>, a, grid_kv, kBlockN, f32_smem<16>(), stream);
        if (e == cudaSuccess) e = launch(flash_bwd_dq_f32<16>, a, grid_q, kBlockM, f32_smem<16>(), stream);
        break;
      case 64:
        e = launch(flash_bwd_dkdv_f32<64>, a, grid_kv, kBlockN, f32_smem<64>(), stream);
        if (e == cudaSuccess) e = launch(flash_bwd_dq_f32<64>, a, grid_q, kBlockM, f32_smem<64>(), stream);
        break;
      case 96:
        e = launch(flash_bwd_dkdv_f32<96>, a, grid_kv, kBlockN, f32_smem<96>(), stream);
        if (e == cudaSuccess) e = launch(flash_bwd_dq_f32<96>, a, grid_q, kBlockM, f32_smem<96>(), stream);
        break;
      case 128:
        e = launch(flash_bwd_dkdv_f32<128>, a, grid_kv, kBlockN, f32_smem<128>(), stream);
        if (e == cudaSuccess) e = launch(flash_bwd_dq_f32<128>, a, grid_q, kBlockM, f32_smem<128>(), stream);
        break;
      default:
        e = launch(flash_bwd_dkdv_f32<256>, a, grid_kv, kBlockN, f32_smem<256>(), stream);
        if (e == cudaSuccess) e = launch(flash_bwd_dq_f32<256>, a, grid_q, kBlockM, f32_smem<256>(), stream);
    }
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaErrorInvalidValue);  // a route that does not fit the dtype or head_dim
}

}  // namespace
extern "C" {

// Launches the backward pass on `stream` (D, then dK/dV, then dQ) and
// returns 0 on success, else the first cudaError_t of an attribute call or
// a launch, or hopper::kEncodeError plus the CUresult of a failed
// tensor-map encode (see repro_cuda_error_string).
// route: 0 "f32" (float32, head_dim 16/64/96/128/256), 1 "mma_sync" (bf16,
// 16/96), 2 "wgmma" (bf16, 64/128/256); any other pairing is refused.
// kv_cluster: CTAs that split a dK/dV item's query heads on the wgmma route
// at head_dim 256 (1, 2 or 4) and 128 (1 or 2), dividing H / KVH
// (ops.py::bwd_cluster); 1 everywhere else.
// dims = {B, H, KVH, Sq, Sk}; strides = element strides {batch, seq, head}
// of q, k, v, o, dO, dQ, dK, dV in that order.  lse (the forward's) and
// delta (scratch the wrapper allocates) are contiguous float32 [B, H, Sq].
int repro_flash_bwd(int device, int route, int head_dim, const void* q, const void* k,
                    const void* v, const void* o, const void* dout, const void* lse, void* delta,
                    void* dq, void* dk, void* dv, const long long* strides, const int* dims,
                    int causal, int window, float softcap, float sm_scale, int kv_cluster, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<float*>(delta);
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  long long* dst[8] = {a.sq, a.sk, a.sv, a.so, a.sdo, a.sdq, a.sdk, a.sdv};
  for (int j = 0; j < 8; ++j)
    for (int i = 0; i < 3; ++i) dst[j][i] = strides[3 * j + i];
  a.B = dims[0];
  a.H = dims[1];
  a.KVH = dims[2];
  a.Sq = dims[3];
  a.Sk = dims[4];
  a.hd = head_dim;
  a.causal = causal;
  a.window = window;
  a.softcap = softcap;
  a.sm_scale = sm_scale;
  return dispatch(route, a, kv_cluster, static_cast<cudaStream_t>(stream));
}

const char* repro_cuda_error_string(int err) { return hopper::error_string(err); }

}  // extern "C"
