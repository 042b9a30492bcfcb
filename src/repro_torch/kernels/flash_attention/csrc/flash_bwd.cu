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
// Design.  Two kernels that each own their output, so no atomics and the
// result is the same on every run:
//   * flash_bwd_dkdv: one block per (64-key tile, kv head, batch).  A loop
//     inside the block walks the G query heads and, for each, the 64-row
//     query tiles the causal and window masks let see its keys; dK and dV
//     accumulate in registers.
//   * flash_bwd_dq: one block per (64-row query tile, head, batch), walking
//     the key tiles the masks allow, as the forward does; dQ accumulates in
//     registers.
// Both recompute P from q, k and lse; neither stores it.
//   * bf16: four warps, 16 rows (keys, or queries) each; every product runs
//     on the tensor cores with mma.sync m16n8k16 (bf16 in, float32
//     accumulate), with the fragment layouts of the forward.  dK/dV
//     computes S^T = K Q^T and dP^T = V dO^T so that P^T and dS^T land in
//     registers as exactly the A fragments of dV = P^T dO and dK = dS^T Q;
//     Q and dO are stored transposed as well, as their B operands.  dQ
//     stores K transposed for dQ = dS K.  P and dS are rounded to bf16 as
//     operands (the plain version keeps them in float32: inside the bf16
//     tolerance).  At head_dim 128 the query tile is taken in halves to
//     bound the registers.
//   * float32: one thread per key row (dK/dV) or query row (dQ), scalar FMA
//     in float32 (no TF32).
// All tensors go in through element strides (batch, seq, head; head_dim
// contiguous), as in the forward.
//
// What bounds it on the H100.  At the training path's shape (B=8, H=12,
// S=1024, hd=64, bf16, causal) the work is ~32 GFLOP (five products of
// 2 * hd flops per query-key pair the mask keeps: ~0.033 ms at 989 TFLOP/s
// dense bf16) and ~101 MB (q, k, v, o, dO, lse read once, dQ, dK, dV
// written once: ~0.030 ms at 3.35 TB/s): bound by operations, barely.
// This first kernel does not reach it: mma.sync instead of wgmma,
// synchronous tile loads with transposed shared-memory stores, and no
// overlap of copy and compute.  Its measured time stands beside the bound in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

constexpr int kLDT = kBlockM + 8;  // padded row of a transposed [HD][64] tile

// Query (dK/dV) or key (dQ) columns per pass: halves at head_dim 128.
template <int HD>
struct SubTile {
  static constexpr int value = HD >= 128 ? 32 : 64;
};

template <int HD>
constexpr size_t dkdv_bf16_smem() {
  return (size_t(4) * 64 * (HD + 8) + size_t(2) * HD * kLDT) * sizeof(bf16) +
         2 * kBlockM * sizeof(float);
}

template <int HD>
__global__ void __launch_bounds__(kWarps * 32) flash_bwd_dkdv_bf16(const Args a) {
  static_assert(HD % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int LD = HD + 8;
  constexpr int SUB = SubTile<HD>::value;
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
  constexpr int SUB = SubTile<HD>::value;
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

template <int HD>
constexpr size_t f32_smem() {
  return (size_t(2) * 64 * (HD + 1) + size_t(2) * 64 * HD) * sizeof(float) +
         2 * kBlockM * sizeof(float);
}

// float32 rows [r0, r0 + 64) of a [seq, HD] slice into a shared tile with
// row stride ld_s, zeros past n_valid.
template <int HD>
__device__ __forceinline__ void load_rows_f32(float* dst, int ld_s, const float* src,
                                              long long ld_g, int r0, int n_valid) {
  for (int i = threadIdx.x; i < 64 * HD; i += blockDim.x) {
    const int r = i / HD, c = i % HD;
    dst[r * ld_s + c] = (r0 + r < n_valid) ? src[(long long)(r0 + r) * ld_g + c] : 0.f;
  }
}

// One thread per key row; its k and v rows padded by one float so the
// threads of a warp read 32 distinct banks, the query rows read as broadcasts.
template <int HD>
__global__ void __launch_bounds__(kBlockN) flash_bwd_dkdv_f32(const Args a) {
  constexpr int LDK = HD + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sK = reinterpret_cast<float*>(smem_raw);
  float* sV = sK + kBlockN * LDK;
  float* sQ = sV + kBlockN * LDK;
  float* sdO = sQ + kBlockM * HD;
  float* sL = sdO + kBlockM * HD;
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
    for (int q0 = qbeg; q0 < qend; q0 += kBlockM) {
      __syncthreads();
      load_rows_f32<HD>(sQ, HD, qp, a.sq[1], q0, a.Sq);
      load_rows_f32<HD>(sdO, HD, dop, a.sdo[1], q0, a.Sq);
      for (int i = tid; i < kBlockM; i += kBlockN) {
        const bool in = q0 + i < a.Sq;
        sL[i] = in ? lp[q0 + i] : 0.f;
        sD[i] = in ? dlp[q0 + i] : 0.f;
      }
      __syncthreads();
      const int jn = min(kBlockM, a.Sq - q0);
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
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sdO = sQ + kBlockM * LDQ;
  float* sK = sdO + kBlockM * LDQ;
  float* sV = sK + kBlockN * HD;

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
  for (int k0 = kbeg; k0 < kend; k0 += kBlockN) {
    __syncthreads();
    load_rows_f32<HD>(sK, HD, kp, a.sk[1], k0, a.Sk);
    load_rows_f32<HD>(sV, HD, vp, a.sv[1], k0, a.Sk);
    __syncthreads();
    const int jn = min(kBlockN, kend - k0);
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

template <int HD>
cudaError_t dispatch(int is_bf16, const Args& a, cudaStream_t stream) {
  const long long rows = (long long)a.B * a.H * a.Sq;
  const dim3 grid_delta(static_cast<unsigned>((rows + 7) / 8));
  const dim3 grid_kv((a.Sk + kBlockN - 1) / kBlockN, a.KVH, a.B);
  const dim3 grid_q((a.Sq + kBlockM - 1) / kBlockM, a.H, a.B);
  cudaError_t e;
  if (is_bf16) {
    e = launch(delta_kernel<bf16>, a, grid_delta, 256, 0, stream);
    if (e == cudaSuccess)
      e = launch(flash_bwd_dkdv_bf16<HD>, a, grid_kv, kWarps * 32, dkdv_bf16_smem<HD>(), stream);
    if (e == cudaSuccess)
      e = launch(flash_bwd_dq_bf16<HD>, a, grid_q, kWarps * 32, dq_bf16_smem<HD>(), stream);
    return e;
  }
  e = launch(delta_kernel<float>, a, grid_delta, 256, 0, stream);
  if (e == cudaSuccess) e = launch(flash_bwd_dkdv_f32<HD>, a, grid_kv, kBlockN, f32_smem<HD>(), stream);
  if (e == cudaSuccess) e = launch(flash_bwd_dq_f32<HD>, a, grid_q, kBlockM, f32_smem<HD>(), stream);
  return e;
}

}  // namespace

extern "C" {

// Launches the backward pass on `stream` (three kernels: D, then dK/dV,
// then dQ) and returns the first launch error (0 on success).
// dims = {B, H, KVH, Sq, Sk}; strides = element strides {batch, seq, head}
// of q, k, v, o, dO, dQ, dK, dV in that order.  lse (the forward's) and
// delta (scratch the wrapper allocates) are contiguous float32 [B, H, Sq].
// head_dim is one of 16, 64, 128; is_bf16 selects bf16 (else float32) for
// every tensor but lse and delta.
int repro_flash_bwd(int device, int is_bf16, int head_dim, const void* q, const void* k,
                    const void* v, const void* o, const void* dout, const void* lse, void* delta,
                    void* dq, void* dk, void* dv, const long long* strides, const int* dims,
                    int causal, int window, float softcap, float sm_scale, void* stream) {
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: return static_cast<int>(dispatch<16>(is_bf16, a, s));
    case 64: return static_cast<int>(dispatch<64>(is_bf16, a, s));
    case 128: return static_cast<int>(dispatch<128>(is_bf16, a, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
