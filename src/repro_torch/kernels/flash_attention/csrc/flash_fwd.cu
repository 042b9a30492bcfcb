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
// GQA: query head h reads kv head h / (H / KVH), the TPU kernel's index map.
// Keys past Sk (the ragged edge of the last tile) get -inf and zero values,
// so they never count; rows past Sq are not written.
//
// Design.  One thread block per (64-row query tile, head, batch); a loop
// inside the block walks 64-key tiles, which takes the place of the TPU
// grid's sequential ("arbitrary") key dimension.  The loop bounds come from
// the causal and window masks: the counterpart of the TPU kernel's
// `pl.when(in_range)` block skip.  The q, k and v tiles sit in shared
// memory (v transposed, so P.V reads it as the column-major B operand);
// rows are padded by 8 elements so the fragment loads hit 32 distinct banks.
//   * bf16: four warps, 16 query rows each.  Both products run on the
//     tensor cores with mma.sync m16n8k16 (bf16 in, float32 accumulate).
//     The probabilities p are rounded to bf16 for the P.V product, where
//     the TPU kernel keeps them in float32; that stays inside the bf16
//     tolerance (2e-2) and is what every bf16 flash kernel does.
//   * float32: one thread per query row, scalar FMA in float32 (no TF32),
//     softmax updated every 16 keys to bound the registers.
// The kernel takes element strides for batch, sequence and head (head_dim
// contiguous), so the model's [B, S, H, hd] tensors go in with no copy.
//
// What bounds it on the H100.  At the serving path's shape (B=8, H=12,
// S=1024, hd=64, bf16, causal) it must move ~50 MB (q, k, v, o once each:
// ~15 us at 3.35 TB/s) and do ~12.9 GFLOP (~13 us at 989 TFLOP/s dense
// bf16), so the floor is memory at ~15 us.  This first kernel does not
// reach it: mma.sync runs at a fraction of the tensor-core rate that only
// wgmma reaches, every tile load is synchronous (no copy/compute overlap),
// and each block re-reads its k/v tiles from L2.  What it leaves for the
// redesign: wgmma on shared-memory operands, TMA loads into a ring of tiles
// with mbarriers, warp specialisation (a producer warp feeding consumer
// warpgroups), and a persistent grid ordered so causal tiles balance.  Its
// measured times stand beside the bound in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

// One thread per query row; q rows padded by one float so the threads of a
// warp read 32 distinct banks, k and v rows read as broadcasts.
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
  }
}

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

template <int HD>
cudaError_t dispatch(int is_bf16, const Args& a, int batch, cudaStream_t stream) {
  if (is_bf16) return launch(flash_fwd_bf16<HD>, a, batch, kWarps * 32, bf16_smem_bytes<HD>(), stream);
  return launch(flash_fwd_f32<HD>, a, batch, kBlockM, f32_smem_bytes<HD>(), stream);
}

}  // namespace

extern "C" {

// Launches the forward pass on `stream` and returns cudaGetLastError() of
// the launch (0 on success).  dims = {B, H, KVH, Sq, Sk}; strides = element
// strides {batch, seq, head} of q, k, v, o in that order.  head_dim is one of
// 16, 64, 128; is_bf16 selects bf16 (else float32) for all four tensors.
// sm_scale is head_dim**-0.5 rounded once to float32, as the TPU kernel has it.
int repro_flash_fwd(int device, int is_bf16, int head_dim, const void* q, const void* k,
                    const void* v, void* o, const long long* strides, const int* dims,
                    int causal, int window, float softcap, float sm_scale, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: return static_cast<int>(dispatch<16>(is_bf16, a, dims[0], s));
    case 64: return static_cast<int>(dispatch<64>(is_bf16, a, dims[0], s));
    case 128: return static_cast<int>(dispatch<128>(is_bf16, a, dims[0], s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
