// Flash-attention forward pass for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (`flash_attention_fwd`, body `_flash_kernel`).  It computes what that
// kernel computes, in the same order:
//   logits = (q . k) * head_dim**-0.5
//   logits = softcap * tanh(logits / softcap)           (if softcap > 0)
//   mask by index from 0: causal k <= q, window k > q - window; masked
//   logits are -1e30 (NEG_INF), as in the TPU kernel
//   online max / sum / accumulator in float32
//   out = acc / max(l, 1e-30), cast to the input's type
//   lse = m + log(max(l, 1e-30)) in float32, if asked for (the backward
//   pass, csrc/flash_bwd.cu, recomputes p = exp(logit - lse) from it)
// GQA: query head h reads kv head h / (H / KVH), the TPU kernel's index map.
// Keys past Sk (the ragged edge of the last tile) get -inf and zero values,
// so they never count; rows past Sq are not written.  A masked logit stays
// the finite -1e30 (not -inf), so a row whose first tile is all masked
// holds m = -1e30 until a visible key resets it, exactly as on the TPU.
//
// Three kernels; the caller names one by its route (ops.py::fwd_route),
// and a route that does not fit the dtype and head_dim is refused:
//   * "wgmma" (bf16, head_dim 64, 128 and 256): flash_fwd_wgmma below, the
//     Hopper design.  It serves every full-width path, recurrentgemma-9b's
//     local attention at 256 among them.
//   * "mma_sync" (bf16, head_dim 16 and 96): flash_fwd_bf16, the first
//     port's Ampere-style kernel, kept for the smoke configs' 16-wide heads
//     (8 and 12 zero-padded to 16 by the wrapper) and phi-3-vision's 96.
//   * "f32" (float32, head_dim 16, 64, 96, 128, 256): flash_fwd_f32, scalar
//     FMA.  At 256 a thread's accumulator row (256 floats) lives in local
//     memory: that instance serves float32 checks, not a path.
//
// What bounds it on the H100.  At the serving path's shape (B=8, H=12,
// S=1024, hd=64, bf16, causal) it must move ~50 MB (q, k, v, o once each:
// ~15 us at 3.35 TB/s) and do ~12.9 GFLOP (~13 us at 989 TFLOP/s dense
// bf16), so the floor is memory at ~15 us.  Per 128 x 128 tile the two
// products take ~1024 tensor-core cycles of an SM at hd 64, and the 16384
// exponentials as many cycles of its 16 MUFU lanes: the kernel has to keep
// both units fed at once.  Clock counters in the consumers on the card put
// most of each one's time in the softmax and in issuing wgmma, little in
// waiting for data, with the two consumers in phase: that, not memory, is
// what holds it back (PERF.md, Findings).  At head_dim 256
// (recurrentgemma-9b: 4 x 4096, 16 heads over 1 kv head, window 2048) the
// floor is the tensor cores: ~412 GFLOP of kept pairs, ~0.42 ms; a tile's
// products take four times the exponentials' cycles, so there the softmax
// hides under the products.
//
// Design of flash_fwd_wgmma.  A persistent grid, one CTA per SM, of 384
// threads in three warpgroups.  A work item is one 128-row query tile of
// one (batch, head); items are numbered heaviest first (the last query
// tiles, with the longest causal rows, of every head), the heads of one
// query tile one after another so that those sharing a kv head read its
// K/V tiles from L2, and dealt to the CTAs in rounds that alternate
// direction, so the load evens out.  Per instance (Smem<HD>): K/V tiles of
// kN keys, the ring's depth and the number of query buffers:
//   head_dim   kN   ring   query buffers   shared memory
//      64     128     4          2            160 KB
//     128     128     2          2            192 KB
//     256      64     2          1            192 KB
// At 256 a 128-key K or V tile would be 64 KB and a 128-row query tile is
// 64 KB, so the tiles hold 64 keys and the query buffer is single; with
// 64-key tiles the consumers' S (32 registers) and P (16) fit beside the
// O accumulator's 128 under 240 registers.  A launch at 256 whose 128-row
// items would fill at most half the SMs (a short prompt) takes 64-row
// items for consumer 0 alone: such a launch lasts as long as its longest
// item, which then walks its keys for half the rows on an SM of its own.
//   * Producer (warpgroup 0, registers lowered to 24 with setmaxnreg): one
//     thread issues TMA loads of each item's query tile into a query
//     buffer, and of its K and V tiles into a ring in shared memory, which
//     runs on from one item to the next.  Each ring stage has a full
//     barrier per tensor (transaction bytes) and an empty barrier per
//     tensor (one arrival per consumer warp); each query buffer has a full
//     and an empty barrier.  With two buffers the next item's query tile
//     loads while this item finishes; with one, the next item's first K/V
//     tiles load first, then its query tile, once both consumers have
//     stored this item's O out of the buffer.  The tensor maps are 4-D over
//     (hd, H, S, B) with the tensors' own byte strides, so strided q, k, v
//     load with no copy, and rows past Sq or Sk arrive as zeros without
//     reading into the next batch.
//   * Two consumers (warpgroups 1 and 2, registers raised to 240), 64
//     query rows of each item: S = Q K^T with wgmma m64nkN from shared
//     memory (both K-major, 128-byte swizzle, head_dim / 16 steps), the
//     online softmax in the exp2 domain in registers, then O += P V with P
//     from registers (the S accumulators rounded to bf16 are the A
//     fragments) and V from shared memory through the descriptor's
//     transpose bit, so V is never transposed by hand; at 256 each 16-key
//     step is two m64n128 products over V's atoms 0-1 and 2-3.  Q K^T of
//     tile kt is issued beside P V of tile kt - 1, and the softmax of tile
//     kt runs while that product is in flight.  The probabilities p are
//     rounded to bf16 for P.V, where the TPU kernel keeps them in float32;
//     that stays inside the bf16 tolerance (2e-2).
//   * Only the tiles that need it pay for the index compare: the tiles
//     holding the causal diagonal, the window's leading edge or the ragged
//     end of Sk.  The loop bounds skip fully masked tiles (key_tiles).
//   * Epilogue: O / l is written as bf16 into the consumer's own rows of the
//     item's query buffer in the swizzled layout and stored with one TMA
//     store per 64 columns, which drops rows past Sq; lse goes out with
//     plain stores in natural log (m * ln 2 + log l).
// The tensor maps are encoded on the host with cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPoint, so the library links against the
// runtime alone (no -lcuda).  A failed encode, attribute or launch returns an
// error code, and the wrapper raises on it.  Tried on the card and dropped
// (PERF.md, Findings): ping-pong turns between the consumers (at hd 64 and
// 128), deeper rings (at 128 with one query buffer), 64-key tiles at 128, O
// rescaled under the next tile's Q K^T, a 192-row CTA of three consumers at
// hd 64, the next tile's Q K^T issued ahead into a second S accumulator, the
// next item's first Q K^T issued under this item's epilogue (the last two
// make ptxas serialise the wgmma pipeline), and at hd 128 under GQA a
// cluster of 2-8 CTAs taking one (batch, kv head)'s query heads at one query
// tile with each K/V tile multicast to all (slower at every size: a slot is
// refilled only once every CTA of the cluster is done with it, while a
// group's CTAs already share its tiles through L2).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <stdio.h>

#include "hopper.cuh"

namespace {

constexpr int kBlockM = 64;      // query rows per block
constexpr int kBlockN = 64;      // keys per tile
constexpr int kWarps = 4;        // bf16 kernel: 16 query rows per warp
constexpr int kChunk = 16;       // float32 kernel: keys per softmax update
constexpr float kNegInf = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // [B, H, Sq] float32, or null: not written
  long long sq[3], sk[3], sv[3], so[3];  // element strides: batch, seq, head
  int H, KVH, Sq, Sk;
  int causal;
  int window;     // <= 0: no window
  float softcap;  // <= 0: no softcap
  float sm_scale;
};

// First and one-past-last key the query tile [q0, q0 + kBlockM) can see;
// the first is rounded down to a tile boundary.
__device__ __forceinline__ void key_range(const Args& a, int q0, int* beg, int* end) {
  const int q_last = min(q0 + kBlockM, a.Sq) - 1;
  int e = a.Sk;
  if (a.causal) e = min(e, q_last + 1);
  int b = 0;
  if (a.window > 0) b = max(0, q0 - a.window + 1);
  *beg = (b / kBlockN) * kBlockN;
  *end = e;
}

// Raw q.k -> the logit the softmax sees.
__device__ __forceinline__ float logit(const Args& a, float s, int qi, int kj) {
  if (kj >= a.Sk) return -INFINITY;
  float x = s * a.sm_scale;
  if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
  bool keep = true;
  if (a.causal) keep = keep && (kj <= qi);
  if (a.window > 0) keep = keep && (kj > qi - a.window);
  return keep ? x : kNegInf;
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
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

template <int HD>
constexpr size_t bf16_smem_bytes() {
  return (size_t(2) * kBlockM * (HD + 8) + size_t(HD) * (kBlockN + 8)) * sizeof(__nv_bfloat16);
}

// The "mma_sync" route (bf16, head_dim 16 and 96).  One block per (64-row query
// tile, head, batch), four warps of 16 rows, a loop over 64-key tiles; q, k
// and v (transposed) in padded shared memory, loaded synchronously; both
// products with mma.sync m16n8k16 (bf16 in, float32 accumulate).
template <int HD>
__global__ void __launch_bounds__(kWarps * 32) flash_fwd_bf16(const Args a) {
  static_assert(HD % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int LD = HD + 8;         // padded row of sQ and sK
  constexpr int LDV = kBlockN + 8;   // padded row of sVt ([HD][kBlockN])
  constexpr int VEC = 8;             // bf16 per 16-byte load
  constexpr int CPR = HD / VEC;      // 16-byte chunks per row
  constexpr int NT = kBlockN / 8;    // 8-key column tiles of S
  constexpr int DT = HD / 8;         // 8-wide column tiles of O
  constexpr int KC = HD / 16;        // 16-deep steps of Q.K^T

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + kBlockM * LD;
  __nv_bfloat16* sVt = sK + kBlockN * LD;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kBlockM, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.KVH);
  const __nv_bfloat16* qp = static_cast<const __nv_bfloat16*>(a.q) + b * a.sq[0] + h * a.sq[2];
  const __nv_bfloat16* kp = static_cast<const __nv_bfloat16*>(a.k) + b * a.sk[0] + kvh * a.sk[2];
  const __nv_bfloat16* vp = static_cast<const __nv_bfloat16*>(a.v) + b * a.sv[0] + kvh * a.sv[2];
  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(a.o) + b * a.so[0] + h * a.so[2];
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  for (int i = tid; i < kBlockM * CPR; i += kWarps * 32) {
    const int r = i / CPR, c = (i % CPR) * VEC;
    uint4 val = zero;
    if (q0 + r < a.Sq) val = *reinterpret_cast<const uint4*>(qp + (long long)(q0 + r) * a.sq[1] + c);
    *reinterpret_cast<uint4*>(sQ + r * LD + c) = val;
  }
  __syncthreads();

  // This warp's 16 query rows as A fragments, kept in registers.
  const int wr = warp * 16;
  uint32_t qa[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    const __nv_bfloat16* p = sQ + (wr + g) * LD + kc * 16 + 2 * t;
    qa[kc][0] = ld32(p);
    qa[kc][1] = ld32(p + 8 * LD);
    qa[kc][2] = ld32(p + 8);
    qa[kc][3] = ld32(p + 8 * LD + 8);
  }

  float o[DT][4];
#pragma unroll
  for (int dn = 0; dn < DT; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // per-thread partial sums; reduced over the quad at the end
  const int row0 = q0 + wr + g, row1 = row0 + 8;

  int kbeg, kend;
  key_range(a, q0, &kbeg, &kend);
  for (int k0 = kbeg; k0 < kend; k0 += kBlockN) {
    __syncthreads();  // every warp is done with the previous tile
    for (int i = tid; i < kBlockN * CPR; i += kWarps * 32) {
      const int r = i / CPR, c = (i % CPR) * VEC;
      uint4 kv = zero, vv = zero;
      if (k0 + r < a.Sk) {
        kv = *reinterpret_cast<const uint4*>(kp + (long long)(k0 + r) * a.sk[1] + c);
        vv = *reinterpret_cast<const uint4*>(vp + (long long)(k0 + r) * a.sv[1] + c);
      }
      *reinterpret_cast<uint4*>(sK + r * LD + c) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int j = 0; j < VEC; ++j) sVt[(c + j) * LDV + r] = ve[j];
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys.
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        const __nv_bfloat16* p = sK + (nt * 8 + g) * LD + kc * 16 + 2 * t;
        mma_bf16(s[nt], qa[kc], ld32(p), ld32(p + 8));
      }
    }

    // Scale, softcap and mask; row max over the quad that shares a row.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int col = k0 + nt * 8 + 2 * t + (r & 1);
        s[nt][r] = logit(a, s[nt][r], r < 2 ? row0 : row1, col);
        mx[r >> 1] = fmaxf(mx[r >> 1], s[nt][r]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        s[nt][r] = expf(s[nt][r] - m[r >> 1]);
        rs[r >> 1] += s[nt][r];
      }
    }
    l[0] = alpha[0] * l[0] + rs[0];
    l[1] = alpha[1] * l[1] + rs[1];
#pragma unroll
    for (int dn = 0; dn < DT; ++dn) {
      o[dn][0] *= alpha[0];
      o[dn][1] *= alpha[0];
      o[dn][2] *= alpha[1];
      o[dn][3] *= alpha[1];
    }

    // O += P V: the S accumulators of two adjacent 8-key tiles are exactly
    // the A fragment of one 16-key step.
#pragma unroll
    for (int kc = 0; kc < kBlockN / 16; ++kc) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kc][0], s[2 * kc][1]),
          pack_bf16(s[2 * kc][2], s[2 * kc][3]),
          pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
          pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]),
      };
#pragma unroll
      for (int dn = 0; dn < DT; ++dn) {
        const __nv_bfloat16* p = sVt + (dn * 8 + g) * LDV + kc * 16 + 2 * t;
        mma_bf16(o[dn], pa, ld32(p), ld32(p + 8));
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = fmaxf(l[i], 1e-30f);
  }
  if (a.lse != nullptr && t == 0) {
    float* lp = a.lse + ((long long)b * a.H + h) * a.Sq;
    if (row0 < a.Sq) lp[row0] = m[0] + logf(l[0]);
    if (row1 < a.Sq) lp[row1] = m[1] + logf(l[1]);
  }
#pragma unroll
  for (int dn = 0; dn < DT; ++dn) {
    const int col = dn * 8 + 2 * t;
    if (row0 < a.Sq)
      *reinterpret_cast<uint32_t*>(op + (long long)row0 * a.so[1] + col) =
          pack_bf16(o[dn][0] / l[0], o[dn][1] / l[0]);
    if (row1 < a.Sq)
      *reinterpret_cast<uint32_t*>(op + (long long)row1 * a.so[1] + col) =
          pack_bf16(o[dn][2] / l[1], o[dn][3] / l[1]);
  }
}

template <int HD>
constexpr size_t f32_smem_bytes() {
  return (size_t(kBlockM) * (HD + 1) + size_t(2) * kBlockN * HD) * sizeof(float);
}

// The "f32" route.  One thread per query row, scalar FMA in float32 (no
// TF32), softmax updated every 16 keys to bound the registers; q rows
// padded by one float so the threads of a warp read 32 distinct banks, k
// and v rows read as broadcasts.
template <int HD>
__global__ void __launch_bounds__(kBlockM) flash_fwd_f32(const Args a) {
  constexpr int LDQ = HD + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sK = sQ + kBlockM * LDQ;
  float* sV = sK + kBlockN * HD;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kBlockM, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.KVH);
  const float* qp = static_cast<const float*>(a.q) + b * a.sq[0] + h * a.sq[2];
  const float* kp = static_cast<const float*>(a.k) + b * a.sk[0] + kvh * a.sk[2];
  const float* vp = static_cast<const float*>(a.v) + b * a.sv[0] + kvh * a.sv[2];
  float* op = static_cast<float*>(a.o) + b * a.so[0] + h * a.so[2];

  for (int i = tid; i < kBlockM * HD; i += kBlockM) {
    const int r = i / HD, c = i % HD;
    sQ[r * LDQ + c] = (q0 + r < a.Sq) ? qp[(long long)(q0 + r) * a.sq[1] + c] : 0.f;
  }

  const int row = q0 + tid;
  float acc[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) acc[d] = 0.f;
  float m = kNegInf, l = 0.f;

  int kbeg, kend;
  key_range(a, q0, &kbeg, &kend);
  for (int k0 = kbeg; k0 < kend; k0 += kBlockN) {
    __syncthreads();  // sQ is written, and every thread is done with the previous tile
    for (int i = tid; i < kBlockN * HD; i += kBlockM) {
      const int r = i / HD, c = i % HD;
      const bool in = k0 + r < a.Sk;
      sK[i] = in ? kp[(long long)(k0 + r) * a.sk[1] + c] : 0.f;
      sV[i] = in ? vp[(long long)(k0 + r) * a.sv[1] + c] : 0.f;
    }
    __syncthreads();

    for (int j0 = 0; j0 < kBlockN && k0 + j0 < kend; j0 += kChunk) {
      float s[kChunk];
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) s[jj] = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) {
        const float qd = sQ[tid * LDQ + d];
#pragma unroll
        for (int jj = 0; jj < kChunk; ++jj) s[jj] = fmaf(qd, sK[(j0 + jj) * HD + d], s[jj]);
      }
      float mx = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        s[jj] = logit(a, s[jj], row, k0 + j0 + jj);
        mx = fmaxf(mx, s[jj]);
      }
      const float m_new = fmaxf(m, mx);
      const float alpha = expf(m - m_new);
      m = m_new;
      float rs = 0.f;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        s[jj] = expf(s[jj] - m);
        rs += s[jj];
      }
      l = alpha * l + rs;
#pragma unroll
      for (int d = 0; d < HD; ++d) {
        float x = acc[d] * alpha;
#pragma unroll
        for (int jj = 0; jj < kChunk; ++jj) x = fmaf(s[jj], sV[(j0 + jj) * HD + d], x);
        acc[d] = x;
      }
    }
  }

  if (row < a.Sq) {
    const float denom = fmaxf(l, 1e-30f);
#pragma unroll
    for (int d = 0; d < HD; ++d) op[(long long)row * a.so[1] + d] = acc[d] / denom;
    if (a.lse != nullptr) a.lse[((long long)b * a.H + h) * a.Sq + row] = m + logf(denom);
  }
}

// ---- The Hopper kernel: TMA ring, wgmma, warp specialisation ------------

namespace wg {

// 128 query rows per work item: two consumer warpgroups of 64, with 240
// registers each (the O accumulator at head_dim 256 takes 128 of them).
constexpr int kM = 128;
constexpr int kThreads = 384;     // producer + two consumer warpgroups
constexpr int kQAtom = kM * 128;  // bytes of one 64-column atom of a query tile
using hopper::kLog2e;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNegInf2 = kNegInf * kLog2e;  // the masked logit, in base-2 units

struct Params {
  CUtensorMap tq, tk, tv, to;  // 4-D (hd, H, S, B) maps; boxes 64 x rows (q), kN (k, v), 64 (o)
  float* lse;                  // [B, H, Sq] float32, or null
  int B, H, KVH, Sq, Sk;
  int causal, window;
  float softcap, softcap_inv, sm_scale;
  int n_qtiles;
  int rows;       // query rows an item takes: kM, or 64 on a narrow grid (head_dim 256)
  int consumers;  // consumer warpgroups that work: 2, or 1 on a narrow grid
};

// One instance's tiling and shared memory: query buffers, then the K and V
// rings, then the barriers.  At head_dim 256 a 128-key K or V tile (64 KB)
// and two query buffers (128 KB) do not fit beside each other: the tiles
// hold 64 keys and there is one query buffer.
template <int HD>
struct Smem {
  static constexpr int kN = HD == 256 ? 64 : 128;       // keys per K/V tile
  static constexpr int kAtom = kN * 128;                 // bytes of one 64-column atom of a K or V tile
  static constexpr int kQBufs = HD == 256 ? 1 : 2;       // query-tile buffers
  static constexpr int kStages = HD == 64 ? 4 : 2;       // K/V ring depth
  static constexpr int kQTile = (HD / 64) * kQAtom;      // bytes of one query tile
  static constexpr int kTile = (HD / 64) * kAtom;        // bytes of one K or V tile
  static constexpr int kQ = 0;                            // + buffer * kQTile
  static constexpr int kK = kQBufs * kQTile;              // + stage * kTile
  static constexpr int kV = kK + kTile * kStages;         // + stage * kTile
  static constexpr int kBar = kV + kTile * kStages;
  // barriers: full Q, empty Q [kQBufs] each, then full K, full V, empty K, empty V [kStages] each
  static constexpr int kBytes = kBar + 8 * (2 * kQBufs + 4 * kStages);
  static constexpr int kAlloc = kBytes + 1024;  // room to align the base to 1024
  static_assert(kAlloc <= 232448, "more shared memory than a block can have");
};

// First and one-past-last kN-key tile the query tile [q0, q0 + rows) can see.
template <int kN>
__device__ __forceinline__ void key_tiles(const Params& p, int q0, int rows, int* beg, int* end) {
  const int q_last = min(q0 + rows, p.Sq) - 1;
  int e = p.Sk;
  if (p.causal) e = min(e, q_last + 1);
  int b = 0;
  if (p.window > 0) b = max(0, q0 - p.window + 1);
  *beg = b / kN;
  *end = (e + kN - 1) / kN;
}

// A work item: one query tile (`rows` rows) of one (batch, head).  Items are
// numbered heaviest first: the last query tiles (the longest causal rows)
// of every head come first, and the heads of one query tile one after
// another.
struct Item {
  int b, h, kvh, q0, kt_beg, kt_end;
};

// The CTA's i-th item: rounds of gridDim.x items, taken in order in even
// rounds and in reverse in odd ones, so each CTA's heavy and light ends of
// the rounds even out.
__device__ __forceinline__ int item_index(int i) {
  const int lane = i % 2 == 0 ? blockIdx.x : gridDim.x - 1 - blockIdx.x;
  return i * gridDim.x + lane;
}

template <int kN>
__device__ __forceinline__ Item work_item(const Params& p, int w, int rows) {
  Item it;
  const int per_tile = p.B * p.H;
  const int z = w / per_tile, rest = w % per_tile;
  it.b = rest / p.H;
  it.h = rest % p.H;
  it.kvh = it.h / (p.H / p.KVH);
  it.q0 = (p.n_qtiles - 1 - z) * rows;
  key_tiles<kN>(p, it.q0, rows, &it.kt_beg, &it.kt_end);
  return it;
}

using hopper::ex2;
using hopper::pack_bf16x2;
using hopper::rcp;
using hopper::tanh_fast;

// One consumer's online-softmax step on its S tile (64 rows x kN keys):
// softcap and (kMask) mask, update the running max m and sum l, leave
// p = 2^(x - m) in s and the factor O must be scaled by in alpha.  m is in
// base-2 units.  In a tile with no softcap and no mask s stays the raw q.k
// and the scale rides in the exponent's FFMA (the max commutes with a
// positive scale).  A masked tile is scaled first, so that a masked entry
// is exactly -1e30 (in base-2 units) and x - m is exact: an FFMA's unrounded
// product would leave a residual of ~1e23 beside m = -1e30.  Rows: r0 holds
// d[4j], r0 + 8 holds d[4j + 2].
template <int kN, bool kSoftcap, bool kMask>
__device__ __forceinline__ void softmax_tile(const Params& p, float (&s)[kN / 2], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2], int r0, int k0,
                                             int t) {
  constexpr bool kScaled = kSoftcap || kMask;  // s is rewritten in base-2 units
  const float scale2 = p.sm_scale * kLog2e;
  const float unit = kScaled ? 1.f : scale2;  // base-2 units per unit of s
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < kN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * j + e];
      if (kSoftcap) {
        x = p.softcap * tanh_fast(x * p.sm_scale * p.softcap_inv) * kLog2e;
      } else if (kMask) {
        x *= scale2;
      }
      if (kMask) {
        const int key = k0 + 8 * j + 2 * t + (e & 1);
        const int row = r0 + (e >> 1) * 8;
        bool keep = true;
        if (p.causal) keep = keep && key <= row;
        if (p.window > 0) keep = keep && key > row - p.window;
        x = key >= p.Sk ? -INFINITY : (keep ? x : kNegInf2);
      }
      if (kScaled) s[4 * j + e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m[i], mx[i] * unit);
    alpha[i] = ex2(m[i] - m_new);
    m[i] = m_new;
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < kN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[4 * j + e] = ex2(fmaf(s[4 * j + e], unit, -m[e >> 1]));
      rs[e >> 1] += s[4 * j + e];
    }
  }
  l[0] = alpha[0] * l[0] + rs[0];
  l[1] = alpha[1] * l[1] + rs[1];
}

// One 16-deep step of S (64 x kN) += Q K^T, both from shared memory.
template <int kN>
__device__ __forceinline__ void wgmma_qk(float (&s)[kN / 2], uint64_t q, uint64_t k, int scale_d) {
  if constexpr (kN == 128) {
    hopper::wgmma_ss_m64n128(s, q, k, scale_d);
  } else {
    hopper::wgmma_ss_m64n64(s, q, k, scale_d);
  }
}

// One 16-key step of O (64 x HD) += P V: V's 16 rows start at `v` and its
// 64-column atoms lie `atom` bytes apart (the descriptor's leading byte
// offset under the transpose bit).  At head_dim 256 two N-128 products, one
// over atoms 0-1 into O's columns 0-127, one over atoms 2-3 into 128-255.
template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&o)[HD / 2], const uint32_t (&a)[4], uint32_t v,
                                         uint32_t atom) {
  if constexpr (HD == 64) {
    hopper::wgmma_rs_m64n64(o, a, hopper::smem_desc(v, atom, 1024), 1);
  } else if constexpr (HD == 128) {
    hopper::wgmma_rs_m64n128(o, a, hopper::smem_desc(v, atom, 1024), 1);
  } else {
    hopper::wgmma_rs_m64n128(*reinterpret_cast<float(*)[64]>(&o[0]), a, hopper::smem_desc(v, atom, 1024), 1);
    hopper::wgmma_rs_m64n128(*reinterpret_cast<float(*)[64]>(&o[64]), a,
                             hopper::smem_desc(v + 2 * atom, atom, 1024), 1);
  }
}

template <int HD, bool kSoftcap>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_wgmma(const __grid_constant__ Params p) {
  static_assert(HD == 64 || HD == 128 || HD == 256, "head_dim 64, 128 or 256");
  using L = Smem<HD>;
  constexpr int kN = L::kN;
  constexpr int kAtom = L::kAtom;
  constexpr int kQBufs = L::kQBufs;
  constexpr int kStages = L::kStages;
  constexpr int kConsumerWarps = 8;
  constexpr int NO = HD / 2;  // O accumulator floats per thread
  constexpr int kAtoms = HD / 64;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (hopper::smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_q = base + L::kBar;                    // + 8 * buffer
  const uint32_t bar_empty_q = bar_q + 8 * kQBufs;          // + 8 * buffer
  const uint32_t bar_k = bar_empty_q + 8 * kQBufs;          // + 8 * stage
  const uint32_t bar_v = bar_k + 8 * kStages;               // + 8 * stage
  const uint32_t bar_empty_k = bar_v + 8 * kStages;         // + 8 * stage
  const uint32_t bar_empty_v = bar_empty_k + 8 * kStages;   // + 8 * stage
  const int n_items = p.n_qtiles * p.B * p.H;
  // 128-row items for both consumers; at head_dim 256 on a grid that would
  // leave SMs idle, 64-row items for consumer 0 alone (launch chooses).
  const int rows = HD == 256 ? p.rows : kM;
  const int consumers = HD == 256 ? p.consumers : 2;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kQBufs; ++i) {
      hopper::mbar_init(bar_q + 8 * i, 1);
      hopper::mbar_init(bar_empty_q + 8 * i, consumers);  // one thread of each consumer, after its store
    }
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(bar_k + 8 * s, 1);
      hopper::mbar_init(bar_v + 8 * s, 1);
      hopper::mbar_init(bar_empty_k + 8 * s, kConsumerWarps / 2 * consumers);
      hopper::mbar_init(bar_empty_v + 8 * s, kConsumerWarps / 2 * consumers);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  // The i-th item of this CTA uses query buffer i % kQBufs; its K/V tiles
  // continue the ring where the previous item's stopped (`tiles` counts them).
  if (threadIdx.x / 128 == 0) {
    // ---- producer ----
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      int tiles = 0;
      for (int i = 0; item_index(i) < n_items; ++i) {
        const Item it = work_item<kN>(p, item_index(i), rows);
        const int qb = i % kQBufs;
        auto load_q = [&]() {
          const uint32_t sQ = base + L::kQ + qb * L::kQTile;
          hopper::mbar_wait(bar_empty_q + 8 * qb, ((i / kQBufs) % 2) ^ 1);
          hopper::mbar_arrive_expect_tx(bar_q + 8 * qb, kAtoms * rows * 128);
          for (int a = 0; a < kAtoms; ++a)
            hopper::tma_load_4d(sQ + a * kQAtom, &p.tq, bar_q + 8 * qb, a * 64, it.h, it.q0, it.b);
        };
        // With one query buffer a later item's first K/V tiles (as many as
        // the ring holds) load before its query tile, which waits for the
        // previous item's O to leave the buffer.
        if (kQBufs == 2 || i == 0) load_q();
        for (int kt = it.kt_beg; kt < it.kt_end; ++kt, ++tiles) {
          const int stage = tiles % kStages;
          const uint32_t phase = (tiles / kStages) % 2;
          const uint32_t sK = base + L::kK + stage * L::kTile;
          const uint32_t sV = base + L::kV + stage * L::kTile;
          hopper::mbar_wait(bar_empty_k + 8 * stage, phase ^ 1);
          hopper::mbar_arrive_expect_tx(bar_k + 8 * stage, L::kTile);
          for (int a = 0; a < kAtoms; ++a)
            hopper::tma_load_4d(sK + a * kAtom, &p.tk, bar_k + 8 * stage, a * 64, it.kvh, kt * kN,
                                it.b);
          hopper::mbar_wait(bar_empty_v + 8 * stage, phase ^ 1);
          hopper::mbar_arrive_expect_tx(bar_v + 8 * stage, L::kTile);
          for (int a = 0; a < kAtoms; ++a)
            hopper::tma_load_4d(sV + a * kAtom, &p.tv, bar_v + 8 * stage, a * 64, it.kvh, kt * kN,
                                it.b);
          if constexpr (kQBufs == 1) {
            if (i > 0 && kt - it.kt_beg + 1 == min(kStages, it.kt_end - it.kt_beg)) load_q();
          }
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows of each item ----
    hopper::setmaxnreg_inc<240>();
    const int c = threadIdx.x / 128 - 1;
    if (HD == 256 && c >= consumers) return;  // a narrow grid's idle consumer
    const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
    const int g = lane / 4, t = lane % 4;
    float o[NO], m[2], l[2], alpha[2];
    float s[kN / 2];
    uint32_t pa[kN / 16][4];
    int tiles = 0;
    for (int i = 0; item_index(i) < n_items; ++i) {
      const Item it = work_item<kN>(p, item_index(i), rows);
      const int qb = i % kQBufs;
      const int wg_row0 = it.q0 + 64 * c;         // first row of this warpgroup
      const int r0 = wg_row0 + 16 * warp + g;     // this thread's rows: r0, r0 + 8
      const uint32_t sQc = base + L::kQ + qb * L::kQTile + c * 64 * 128;  // its rows of each atom
#pragma unroll
      for (int j = 0; j < NO; ++j) o[j] = 0.f;
      m[0] = m[1] = kNegInf2;
      l[0] = l[1] = 0.f;  // per-thread partial sums; reduced over the quad at the end

      auto issue_qk = [&](uint32_t sK) {
        // S = Q K^T: HD / 16 steps of 16 along head_dim, 32 bytes apart in an atom.
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const uint32_t col = (kk % 4) * 32;
          wgmma_qk<kN>(s, hopper::smem_desc(sQc + (kk / 4) * kQAtom + col, 16, 1024),
                       hopper::smem_desc(sK + (kk / 4) * kAtom + col, 16, 1024), kk > 0);
        }
        hopper::wgmma_commit();
      };
      auto issue_pv = [&](uint32_t sV) {  // O += P V: kN / 16 steps of 16 keys, 2048 bytes apart
#pragma unroll
        for (int kk = 0; kk < kN / 16; ++kk) wgmma_pv<HD>(o, pa[kk], sV + kk * 16 * 128, kAtom);
        hopper::wgmma_commit();
      };
      auto softmax = [&](int kt) {
        // Only a tile where some row of this warpgroup could see a masked key pays for the mask.
        const int k0 = kt * kN;
        const bool need_mask = k0 + kN > p.Sk || (p.causal && k0 + kN - 1 > wg_row0) ||
                               (p.window > 0 && k0 <= wg_row0 + 63 - p.window);
        if (need_mask) {
          softmax_tile<kN, kSoftcap, true>(p, s, m, l, alpha, r0, k0, t);
        } else {
          softmax_tile<kN, kSoftcap, false>(p, s, m, l, alpha, r0, k0, t);
        }
      };
      // O *= alpha, then P as bf16 A fragments: only once the previous P V
      // has landed, since it reads o and pa.
      auto rescale_pack = [&]() {
#pragma unroll
        for (int j = 0; j < NO / 4; ++j) {
          o[4 * j + 0] *= alpha[0];
          o[4 * j + 1] *= alpha[0];
          o[4 * j + 2] *= alpha[1];
          o[4 * j + 3] *= alpha[1];
        }
#pragma unroll
        for (int kk = 0; kk < kN / 16; ++kk) {
          pa[kk][0] = pack_bf16x2(s[8 * kk + 0], s[8 * kk + 1]);
          pa[kk][1] = pack_bf16x2(s[8 * kk + 2], s[8 * kk + 3]);
          pa[kk][2] = pack_bf16x2(s[8 * kk + 4], s[8 * kk + 5]);
          pa[kk][3] = pack_bf16x2(s[8 * kk + 6], s[8 * kk + 7]);
        }
      };
      auto release = [&](uint32_t bar) {
        if (lane == 0) hopper::mbar_arrive(bar);
      };
      // Ring slot of the item's tile kt.
      auto stage_of = [&](int kt) { return (tiles + kt - it.kt_beg) % kStages; };
      auto phase_of = [&](int kt) {
        return static_cast<uint32_t>((tiles + kt - it.kt_beg) / kStages % 2);
      };
      auto wait_k = [&](int kt) {
        hopper::mbar_wait(bar_k + 8 * stage_of(kt), phase_of(kt));
        return base + L::kK + stage_of(kt) * L::kTile;
      };
      auto wait_v = [&](int kt) {
        hopper::mbar_wait(bar_v + 8 * stage_of(kt), phase_of(kt));
        return base + L::kV + stage_of(kt) * L::kTile;
      };

      // The pipeline, per tile kt: Q K^T(kt) -> softmax(kt) -> P V(kt).  Q
      // K^T of tile kt is issued before P V of tile kt - 1, and the softmax
      // of tile kt runs while that product is in flight; O is rescaled and P
      // packed once it has landed.
      hopper::mbar_wait(bar_q + 8 * qb, (i / kQBufs) % 2);
      hopper::fence_regs(s);
      hopper::fence_regs(o);
      hopper::wgmma_fence();
      issue_qk(wait_k(it.kt_beg));
      hopper::wgmma_wait<0>();
      hopper::fence_regs(s);
      release(bar_empty_k + 8 * stage_of(it.kt_beg));
      softmax(it.kt_beg);
      rescale_pack();
      for (int kt = it.kt_beg + 1; kt < it.kt_end; ++kt) {
        const uint32_t sK = wait_k(kt);
        const uint32_t sV = wait_v(kt - 1);
        hopper::fence_regs(s);
        hopper::fence_regs(o);
        hopper::wgmma_fence();
        issue_qk(sK);
        issue_pv(sV);
        hopper::wgmma_wait<1>();  // Q K^T(kt) has landed; P V(kt - 1) may still run
        hopper::fence_regs(s);
        release(bar_empty_k + 8 * stage_of(kt));
        softmax(kt);
        hopper::wgmma_wait<0>();
        hopper::fence_regs(o);
        release(bar_empty_v + 8 * stage_of(kt - 1));
        rescale_pack();
      }
      // The last tile's P V.
      const uint32_t sV = wait_v(it.kt_end - 1);
      hopper::fence_regs(o);
      hopper::wgmma_fence();
      issue_pv(sV);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(o);
      release(bar_empty_v + 8 * stage_of(it.kt_end - 1));
      tiles += it.kt_end - it.kt_beg;

      // Epilogue: l over the quad, lse, O / l through this warpgroup's rows
      // of the query buffer to a TMA store; then the buffer is free.
      float inv[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        l[j] += __shfl_xor_sync(0xffffffffu, l[j], 1);
        l[j] += __shfl_xor_sync(0xffffffffu, l[j], 2);
        l[j] = fmaxf(l[j], 1e-30f);
        inv[j] = 1.f / l[j];
      }
      if (p.lse != nullptr && t == 0) {
        float* lp = p.lse + (static_cast<long long>(it.b) * p.H + it.h) * p.Sq;
        if (r0 < p.Sq) lp[r0] = m[0] * kLn2 + logf(l[0]);
        if (r0 + 8 < p.Sq) lp[r0 + 8] = m[1] * kLn2 + logf(l[1]);
      }
      const int lr = 16 * warp + g;  // local row in this warpgroup's 64; lr % 8 == g
#pragma unroll
      for (int j = 0; j < NO / 4; ++j) {
        const uint32_t atom = sQc + (j / 8) * kQAtom;
        const uint32_t chunk = ((j % 8) ^ g) * 16 + 4 * t;
        const uint32_t v0 = pack_bf16x2(o[4 * j + 0] * inv[0], o[4 * j + 1] * inv[0]);
        const uint32_t v1 = pack_bf16x2(o[4 * j + 2] * inv[1], o[4 * j + 3] * inv[1]);
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(atom + lr * 128 + chunk), "r"(v0) : "memory");
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(atom + (lr + 8) * 128 + chunk), "r"(v1)
                     : "memory");
      }
      hopper::fence_proxy_async();
      hopper::named_barrier_sync(1 + c, 128);
      if (threadIdx.x % 128 == 0) {
        if (wg_row0 < p.Sq) {
          for (int a = 0; a < kAtoms; ++a)
            hopper::tma_store_4d(&p.to, sQc + a * kQAtom, a * 64, it.h, wg_row0, it.b);
          hopper::tma_store_wait_read();
        }
        hopper::mbar_arrive(bar_empty_q + 8 * qb);
      }
    }
  }
}

template <int HD>
int launch(const Args& a, int batch, cudaStream_t stream) {
  using L = Smem<HD>;
  hopper::EncodeTiled fn;
  cudaError_t e = hopper::encode_fn(&fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  int device, sms;
  e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  Params p;
  // At head_dim 256 a grid of 128-row items that fills at most half the SMs
  // is cut into 64-row items for one consumer each: the longest item, which
  // bounds such a launch, then walks its keys for half the rows.
  p.rows = kM;
  p.consumers = 2;
  if (HD == 256 && 2LL * ((a.Sq + kM - 1) / kM) * batch * a.H <= sms) {
    p.rows = 64;
    p.consumers = 1;
  }
  int err = hopper::encode(fn, &p.tq, a.q, HD, a.H, a.Sq, batch, a.sq, p.rows);
  if (!err) err = hopper::encode(fn, &p.tk, a.k, HD, a.KVH, a.Sk, batch, a.sk, L::kN);
  if (!err) err = hopper::encode(fn, &p.tv, a.v, HD, a.KVH, a.Sk, batch, a.sv, L::kN);
  if (!err) err = hopper::encode(fn, &p.to, a.o, HD, a.H, a.Sq, batch, a.so, 64);
  if (err) return err;
  p.lse = a.lse;
  p.B = batch;
  p.H = a.H;
  p.KVH = a.KVH;
  p.Sq = a.Sq;
  p.Sk = a.Sk;
  p.causal = a.causal;
  p.window = a.window;
  p.softcap = a.softcap;
  p.softcap_inv = a.softcap > 0.f ? 1.f / a.softcap : 0.f;
  p.sm_scale = a.sm_scale;
  p.n_qtiles = (a.Sq + p.rows - 1) / p.rows;
  const long long n_items = static_cast<long long>(p.n_qtiles) * batch * a.H;
  if (n_items > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = a.softcap > 0.f ? &flash_fwd_wgmma<HD, true> : &flash_fwd_wgmma<HD, false>;
  constexpr int smem = L::kAlloc;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int grid = static_cast<int>(n_items < sms ? n_items : sms);  // one CTA per SM, persistent
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

template <typename Kernel>
cudaError_t launch(Kernel kernel, const Args& a, int batch, int threads, size_t smem,
                   cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((a.Sq + kBlockM - 1) / kBlockM, a.H, batch);
  kernel<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

// Routes, as ops.py::fwd_route names them.
constexpr int kRouteF32 = 0;
constexpr int kRouteMmaSync = 1;
constexpr int kRouteWgmma = 2;

int dispatch(int route, int head_dim, const Args& a, int batch, cudaStream_t s) {
  if (route == kRouteWgmma && head_dim == 64) return wg::launch<64>(a, batch, s);
  if (route == kRouteWgmma && head_dim == 128) return wg::launch<128>(a, batch, s);
  if (route == kRouteWgmma && head_dim == 256) return wg::launch<256>(a, batch, s);
  if (route == kRouteMmaSync && head_dim == 16)
    return static_cast<int>(launch(flash_fwd_bf16<16>, a, batch, kWarps * 32, bf16_smem_bytes<16>(), s));
  if (route == kRouteMmaSync && head_dim == 96)
    return static_cast<int>(launch(flash_fwd_bf16<96>, a, batch, kWarps * 32, bf16_smem_bytes<96>(), s));
  if (route == kRouteF32 && head_dim == 16)
    return static_cast<int>(launch(flash_fwd_f32<16>, a, batch, kBlockM, f32_smem_bytes<16>(), s));
  if (route == kRouteF32 && head_dim == 64)
    return static_cast<int>(launch(flash_fwd_f32<64>, a, batch, kBlockM, f32_smem_bytes<64>(), s));
  if (route == kRouteF32 && head_dim == 96)
    return static_cast<int>(launch(flash_fwd_f32<96>, a, batch, kBlockM, f32_smem_bytes<96>(), s));
  if (route == kRouteF32 && head_dim == 128)
    return static_cast<int>(launch(flash_fwd_f32<128>, a, batch, kBlockM, f32_smem_bytes<128>(), s));
  if (route == kRouteF32 && head_dim == 256)
    return static_cast<int>(launch(flash_fwd_f32<256>, a, batch, kBlockM, f32_smem_bytes<256>(), s));
  return static_cast<int>(cudaErrorInvalidValue);  // a route that does not fit the head_dim
}

}  // namespace

extern "C" {

// Launches the forward pass on `stream` and returns 0 on success, else a
// cudaError_t of the attribute call or the launch, or kEncodeError plus the
// CUresult of a failed tensor-map encode (see repro_cuda_error_string).
// route: 0 "f32" (float32, head_dim 16/64/96/128/256), 1 "mma_sync" (bf16, 16/96),
// 2 "wgmma" (bf16, 64/128/256); any other pairing is refused.  dims = {B, H,
// KVH, Sq, Sk}; strides = element strides {batch, seq, head} of q, k, v, o
// in that order.  sm_scale is head_dim**-0.5 rounded once to float32, as the
// TPU kernel has it.  lse is a contiguous float32 [B, H, Sq] output, or null
// (serving needs none).
int repro_flash_fwd(int device, int route, int head_dim, const void* q, const void* k,
                    const void* v, void* o, void* lse, const long long* strides, const int* dims,
                    int causal, int window, float softcap, float sm_scale, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.lse = static_cast<float*>(lse);
  for (int i = 0; i < 3; ++i) {
    a.sq[i] = strides[i];
    a.sk[i] = strides[3 + i];
    a.sv[i] = strides[6 + i];
    a.so[i] = strides[9 + i];
  }
  a.H = dims[1];
  a.KVH = dims[2];
  a.Sq = dims[3];
  a.Sk = dims[4];
  a.causal = causal;
  a.window = window;
  a.softcap = softcap;
  a.sm_scale = sm_scale;
  return dispatch(route, head_dim, a, dims[0], static_cast<cudaStream_t>(stream));
}

const char* repro_cuda_error_string(int err) { return hopper::error_string(err); }

}  // extern "C"
