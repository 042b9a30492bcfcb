// The gradient of the RWKV6 WKV recurrence for Hopper (sm_90a), hand-written CUDA C++.
//
// No TPU counterpart: the JAX package trains RWKV6 through jax.grad of
// repro.models.rwkv6._wkv_with_initial_state (src/repro/models/rwkv6.py:165,
// a lax.scan over time, jax.checkpoint-ed in chunks of WKV_CHUNK = 256
// steps), and the port's tests hold this kernel's plain versions to that
// gradient.  Per batch b and head h, with the forward (wkv6.cu)
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T,   y_t = S_{t-1}^T r_t + (r_t . (u * k_t)) v_t
// and G_t = dL/dS_t (G_T = dstate, zeros when absent), going back in time:
//   dr_t[i] = sum_j dy_t[j] S_{t-1}[i][j] + u_i k_t[i] (v_t . dy_t)
//   dk_t[i] = sum_j G_t[i][j] v_t[j] + u_i r_t[i] (v_t . dy_t)
//   dv_t[j] = sum_i G_t[i][j] k_t[i] + (r_t . (u * k_t)) dy_t[j]
//   dw_t[i] = sum_j G_t[i][j] S_{t-1}[i][j]
//   du_i   += r_t[i] k_t[i] (v_t . dy_t)          (over b and t)
//   G_{t-1} = diag(w_t) G_t + r_t dy_t^T,   dstate0 = G_0
// from the state the forward saved before each chunk of C steps (`bounds`).
//
// What bounds it on the H100.  At the path shape (B=4, T=4096, H=64,
// N=64; r, k, v bf16, w and dy float32 in; dr, dk, dv bf16 and dw float32
// out) every input read once and every output written once is 24 B per
// (b, t, h, n) element plus the saved states: ~1.69 GB, 0.504 ms at
// 3.35 TB/s.  That is the floor.  The ~15 N^2 float32 operations a step of
// the plain recurrence (0.96 ms at 67 TFLOP/s) are no floor here: this
// design does its N^2 work as matrix products on the tensor cores and
// keeps O(L N) a step on the CUDA cores.
//
// The design: chunk-parallel over time, whole rows in a cluster, products
// on the tensor cores.
//   1. G at every chunk's end, in parallel over chunks: wkv6_gloc_kernel
//      gives each chunk c >= 1 alone (one block for all N rows) G_loc =
//      R~^T DY over its C steps (r scaled by the decay from the chunk's
//      start) and its decay D_c; wkv6_gscan_kernel then runs
//      G_{c-1} = D_c G_c + G_loc,c elementwise.  Scratch: one N x N state
//      a chunk (34 MB at 2 x 4096; dv partials summed through device
//      memory would take 537 MB).
//   2. wkv6_bwd_kernel: a cluster per (chunk, h, b) of N / R blocks of 8
//      warps, each block owning R = 16 rows of the state, so the cluster
//      holds all N rows of the (b, h).  A block recomputes the state before
//      each 16-step sub-chunk from the saved one (S <- diag(cL) S + K~^T V,
//      two sub-chunks a job where their inputs fit one staging buffer:
//      bf16; every 4th kept in a first pass, the others again per group of 4:
//      7 states in shared memory at C = 256), then walks the sub-chunks
//      backward.  For a sub-chunk with S0 and GL at its ends, P = DY S0^T,
//      Q = V GL^T, A = DY V^T, per row X = U [A^T | Q] (U[t][s] =
//      W[t][s] k_s), dv = K~ GL + B DY and GL <- diag(cL) GL + R~^T DY are
//      mma.sync m16n8k8 products with float32 sums.  The pair terms, with
//      a decay W[q][t] = prod_{t < p < q} w_p for each step pair and row,
//      are O(L) a step per element on the CUDA cores (float4 rows in shared
//      memory).  dw comes from its parts: rowsum(S0 * GL), e Q-terms,
//      cp P-terms and the pair-of-decays term through X; never from
//      w dw = ..., which would divide by w.
//   3. dv sums over all N rows: each block writes its rows' share into
//      shared memory; block q of the cluster sums columns
//      [q N / CS, (q + 1) N / CS) over the CS blocks in rank order through
//      distributed shared memory, during the next sub-chunk (split cluster
//      barrier: arrive after writing, wait just before reading).  du sums
//      over b and t: per-block partials, then wkv6_du_kernel in a fixed
//      order.  No atomics: the same bits on every run.
// Numerics.  Every decay is a running product of w over steps of one
// sub-chunk (one chunk for R~ in step 1), i.e. exp(b_a - b_b), a >= b,
// for b the cumulative log-decay, formed without a log: a factor in
// [0, 1] that can underflow but never overflow, w == 0 gives exact zeros,
// no inverse decay is formed and nothing divides by w.  Operands go to the
// tensor cores as TF32 (r, k, v bf16: the path, tolerance 5e-2) or split
// into high and low TF32 parts, three products each (3xTF32; float32
// r, k, v: tolerance 1e-4).  Inputs are staged two sub-chunks ahead with
// cp.async (zero-filled past T).
// Where it stands (PERF.md): ~18x the bytes floor at the path shape.  A
// block walks 30 short jobs a chunk (16 backward sub-chunks; 24 state
// recomputes in 14 jobs), ~6 dependent phases each, each ended by a
// barrier; its time goes to those phases' latencies, not to bytes or to
// tensor-core work.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int L = 16;          // steps a sub-chunk
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kGlocThreads = 256;  // wkv6_gloc_kernel's block
constexpr int kGroup = 4;      // sub-chunks between the states the first forward pass keeps
constexpr int kMaxJobs = 64;   // jobs a chunk of 256 steps needs: 40 at most (30 with double forward jobs)
constexpr int kStages = 3;     // staged sub-chunks: two in flight while one is used
constexpr int ST = 20;         // row stride (floats) of [.][L] tiles: 16-byte rows

template <int N>
struct Shape {
  static constexpr int R = N < 16 ? N : 16;  // state rows a block owns
  static constexpr int CS = N / R;           // blocks a cluster: all N rows of a (b, h)
  static constexpr int SN = N + 4;           // row stride of [.][N] tiles
  static constexpr int SR = R + 1;           // row stride of [t][i] row data
  static constexpr int NT = N / 8;           // 8-column tiles across N
};

struct Args {
  const void* r;
  const void* k;
  const void* v;
  const void* w;
  const float* u;        // [H, N]
  const float* bounds;   // [B, nc, H, N, N]: the state before each chunk
  const float* dy;       // [B, T, H, N]
  const float* dstate;   // [B, H, N, N] or null
  void* dr;
  void* dk;
  void* dv;
  void* dw;
  float* du;             // [H, N]
  float* dstate0;        // [B, H, N, N]
  float* gend;           // [B, nc, H, N, N]: G at each chunk's end
  float* cdecay;         // [B, nc, H, N]: each chunk's decay (entries c >= 1)
  float* du_parts;       // [B, nc, H, N]
  int B, T, H, chunk, nc;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__host__ __device__ constexpr int up4(int x) { return (x + 3) & ~3; }
__host__ __device__ constexpr int up16(int x) { return (x + 15) & ~15; }

// 16 bytes global -> shared, or 16 zero bytes where !valid (cp.async's zero fill)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_wait1() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

// `rows` rows of bytes_per_row (a multiple of 16), global rows gstride bytes
// apart, into shared rows sstride bytes apart, 16 bytes a copy by all kT
// threads; rows from nt on are zeros
template <int kT>
__device__ __forceinline__ void copy_rows(unsigned char* dst, int sstride, const unsigned char* src, long long gstride,
                                          int rows, int nt, int bytes_per_row) {
  const int per = bytes_per_row / 16;
  for (int x = threadIdx.x; x < rows * per; x += kT) {
    const int row = x / per, p = x - row * per;
    const bool valid = row < nt;
    cp_async16(dst + row * sstride + p * 16, src + (valid ? row * gstride : 0) + p * 16, valid);
  }
}

// The cluster barrier in two halves: arrive after writing what the other
// blocks read, wait before reading theirs.
__device__ __forceinline__ void cluster_arrive() { asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory"); }

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void mma8(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One m16n8k8 step on the tensor cores, d += a b with float32 sums, from
// float fragments: TF32 operands, or with kSplit each operand as a high and
// a low TF32 part (3xTF32: the low x low product dropped).  Fragments of
// lane g = lane / 4, q = lane % 4: a = (g, q), (g+8, q), (g, q+4), (g+8, q+4);
// b = (q, g), (q+4, g); d = (g, 2q), (g, 2q+1), (g+8, 2q), (g+8, 2q+1).
template <bool kSplit>
__device__ __forceinline__ void mma_step(float (&d)[4], const float (&af)[4], const float (&bf)[2]) {
  uint32_t ah[4], bh[2];
#pragma unroll
  for (int e = 0; e < 4; ++e) ah[e] = tf32(af[e]);
#pragma unroll
  for (int e = 0; e < 2; ++e) bh[e] = tf32(bf[e]);
  if constexpr (kSplit) {
    uint32_t al[4], bl[2];
#pragma unroll
    for (int e = 0; e < 4; ++e) al[e] = tf32(af[e] - __uint_as_float(ah[e]));
#pragma unroll
    for (int e = 0; e < 2; ++e) bl[e] = tf32(bf[e] - __uint_as_float(bh[e]));
    mma8(d, al, bh);
    mma8(d, ah, bl);
  }
  mma8(d, ah, bh);
}

template <class FA>
__device__ __forceinline__ void load_a(float (&af)[4], int k0, FA fa) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  af[0] = fa(g, k0 + q);
  af[1] = fa(g + 8, k0 + q);
  af[2] = fa(g, k0 + q + 4);
  af[3] = fa(g + 8, k0 + q + 4);
}
template <class FB>
__device__ __forceinline__ void load_b(float (&bf)[2], int k0, FB fb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  bf[0] = fb(k0 + q, g);
  bf[1] = fb(k0 + q + 4, g);
}

// d (a 16 x 8 tile) += sum over KS x 8 of fa(m, k) fb(k, n); four
// accumulators take the k-steps in turn (independent chains) and are summed
// at the end in a fixed order.
template <bool kSplit, int KS, class FA, class FB>
__device__ __forceinline__ void mma_tile(float (&d)[4], FA fa, FB fb) {
  float acc[4][4] = {};
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    float af[4], bf[2];
    load_a(af, ks * 8, fa);
    load_b(bf, ks * 8, fb);
    mma_step<kSplit>(acc[ks & 3], af, bf);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += (acc[0][e] + acc[1][e]) + (acc[2][e] + acc[3][e]);
}

// Widen a staged sub-chunk's r, k, w of the block's rows (raw [t][R]; steps
// from nt on: zeros, w = 1) into [i][t] rows and scan their decays across
// the 16 lanes of a row (fixed trees of products): e[i][t] from step t to
// the sub-chunk's end (exclusive), cL[i] over all of it and, with kPrefix,
// r and cp[i][t] from the sub-chunk's start to step t (exclusive), by kT
// threads.  f(i, t, r, k, w, cp, e, cL) stores.
template <int R, typename TI, typename TW, bool kPrefix, int kT, class F>
__device__ __forceinline__ void widen_rows(const unsigned char* src, int kRawK, int kRawW, int nt, F f) {
  const TI* sr = reinterpret_cast<const TI*>(src);
  const TI* sk = reinterpret_cast<const TI*>(src + kRawK);
  const TW* sw = reinterpret_cast<const TW*>(src + kRawW);
#pragma unroll
  for (int x = threadIdx.x; x < R * L; x += kT) {  // R L is a multiple of 32: whole warps take part
    const int i = x >> 4, t = x & 15;
    const float rx = kPrefix ? to_f(sr[t * R + i]) : 0.f;
    const float kx = to_f(sk[t * R + i]);
    const float wx = t < nt ? to_f(sw[t * R + i]) : 1.f;
    float inc = wx, sfx = wx;
#pragma unroll
    for (int off = 1; off < L; off <<= 1) {
      if constexpr (kPrefix) {
        const float y = __shfl_up_sync(0xffffffffu, inc, off, L);
        if (t >= off) inc *= y;
      }
      const float z = __shfl_down_sync(0xffffffffu, sfx, off, L);
      if (t + off < L) sfx *= z;
    }
    float cpx = 1.f;
    if constexpr (kPrefix) {
      cpx = __shfl_up_sync(0xffffffffu, inc, 1, L);
      if (t == 0) cpx = 1.f;
    }
    float ex = __shfl_down_sync(0xffffffffu, sfx, 1, L);
    const float clx = __shfl_sync(0xffffffffu, sfx, 0, L);
    if (t == L - 1) ex = 1.f;
    f(i, t, rx, kx, wx, cpx, ex, clx);
  }
}

// Shared-memory layout of the main kernel, in floats: everything 16-byte
// aligned; the state slots last, their number set by the chunk.
template <int N, typename TI, typename TW>
struct Smem {
  using Sh = Shape<N>;
  static constexpr int R = Sh::R, SN = Sh::SN, SR = Sh::SR;
  // one staged sub-chunk (bytes): r, k [L][R] TI; w [L][R] TW; v [L][N] TI; dy [L][SN] float
  static constexpr int kRawK = L * R * sizeof(TI);
  static constexpr int kRawW = 2 * kRawK;
  static constexpr int kRawV = up16(kRawW + L * R * sizeof(TW));
  static constexpr int kRawD = up16(kRawV + L * N * sizeof(TI));
  static constexpr int kRaw = kRawD + L * SN * 4;
  // a forward job's staging: k [nf L][R] TI, w [nf L][R] TW, v [nf L][N] TI
  // for nf = 1 or 2 sub-chunks; two when they fit in one buffer
  static constexpr int kFwdW = up16(2 * L * R * sizeof(TI));
  static constexpr int kFwdV = up16(kFwdW + 2 * L * R * sizeof(TW));
  static constexpr bool kDouble = kFwdV + 2 * L * N * sizeof(TI) <= kRaw;
  static constexpr int oRaw = 0;                                 // kStages staged sub-chunks
  static constexpr int oG = oRaw + kStages * kRaw / 4;           // GL [R][SN]
  static constexpr int oRows = oG + R * SN;                      // r, k, w, cp, e, K~, R~: 7 x [R][ST]
  static constexpr int oVec = oRows + 7 * R * ST;                // cL, u, du, gamma: 4 x [16]
  static constexpr int oV = oVec + 64;                           // v [L][SN]
  static constexpr int oPQ = oV + L * SN;                        // P^T, Q^T: 2 x [R][ST]
  static constexpr int oAT = oPQ + 2 * R * ST;                   // A^T, B: 2 x [L][ST]
  static constexpr int oScr = oAT + 2 * L * ST;                      // per warp: W^T [L][ST], X [L][ST], T2 [L]
  static constexpr int kScr = 2 * L * ST + L;
  static constexpr int oDvp = oScr + kWarps * kScr;              // dv partials: 2 x [L][SN]
  static constexpr int oOut = oDvp + 2 * L * SN;                 // dr, dk, dw: 3 x [L][SR]
  static constexpr int oJobs = up4(oOut + 3 * L * SR);           // short[kMaxJobs]
  static constexpr int oSlots = up4(oJobs + kMaxJobs / 2);       // [nslots][R][SN]
  static size_t bytes(int nslots) { return (size_t(oSlots) + size_t(nslots) * R * SN) * sizeof(float); }
};

__host__ __device__ __forceinline__ int num_groups(int nsub) { return (nsub + kGroup - 1) / kGroup; }

template <int N, typename TI, typename TW, bool kSplit>
__global__ void __launch_bounds__(kThreads, 2) wkv6_bwd_kernel(const Args a) {
  using Sh = Shape<N>;
  using Sm = Smem<N, TI, TW>;
  constexpr int R = Sh::R, CS = Sh::CS, SN = Sh::SN, SR = Sh::SR, NT = Sh::NT, KR = (R + 7) / 8;
  extern __shared__ __align__(16) float smem[];
  unsigned char* raw = reinterpret_cast<unsigned char*>(smem + Sm::oRaw);
  float* G = smem + Sm::oG;
  float* rrT = smem + Sm::oRows;  // [i][t] rows of the sub-chunk's r, k, w
  float* kkT = rrT + R * ST;
  float* wwT = kkT + R * ST;
  float* cpT = wwT + R * ST;      // the decay from the sub-chunk's start to step t, exclusive
  float* eT = cpT + R * ST;       // the decay from step t to the sub-chunk's end, exclusive
  float* ktT = eT + R * ST;       // K~ = k e
  float* rtT = ktT + R * ST;      // R~ = r cp
  float* cl = smem + Sm::oVec;    // the sub-chunk's whole decay
  float* uu = cl + 16;
  float* duacc = uu + 16;
  float* gam = duacc + 16;        // rowsum(GL * S0)
  float* vv = smem + Sm::oV;
  float* PT = smem + Sm::oPQ;     // P^T[i][t] = S0[i] . dy_t
  float* QT = PT + R * ST;        // Q^T[i][t] = GL[i] . v_t
  float* AT = smem + Sm::oAT;     // A^T[s][q] = dy_q . v_s
  float* Bs = AT + L * ST;        // B[t][q]: sum_i W[q][t] r_q k_t (q > t), sum_i r_t u k_t (q = t)
  float* dvp = smem + Sm::oDvp;
  float* odr = smem + Sm::oOut;
  float* odk = odr + L * SR;
  float* odw = odk + L * SR;
  short* jobs = reinterpret_cast<short*>(smem + Sm::oJobs);
  float* slots = smem + Sm::oSlots;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int rank = blockIdx.x, i0 = rank * R;
  const int c = blockIdx.y / a.H, h = blockIdx.y - c * a.H, b = blockIdx.z;
  const int T = a.T, H = a.H, t0c = c * a.chunk;
  const int nsub = (min(a.chunk, T - t0c) + L - 1) / L, ng = num_groups(nsub);
  const long long bh = static_cast<long long>(b) * H + h;
  auto at = [&](int t) { return ((static_cast<long long>(b) * T + t) * H + h) * N; };  // [b, t, h, 0]
  auto slot = [&](int m) { return slots + ((m % kGroup == 0) ? m / kGroup : ng + m % kGroup - 1) * (R * SN); };

  // -- the prologue: the job list, u, the chunk's saved state and G (with job 0's copies) --
  // a job is m | kind << 8: kind 0 the state forward over sub-chunk m,
  // 2 over sub-chunks m and m + 1, 1 the backward over sub-chunk m
  if (tid == 0) {
    int n = 0;
    auto forward = [&](int m0, int m1) {  // S_m0 -> S_m1
      for (int m = m0; m < m1;) {
        const bool two = Sm::kDouble && m + 2 <= m1;
        jobs[n++] = m | (two ? 2 : 0) << 8;
        m += two ? 2 : 1;
      }
    };
    forward(0, (ng - 1) * kGroup);  // to the kept states
    for (int gr = ng - 1; gr >= 0; --gr) {
      const int m0 = gr * kGroup, mend = min(nsub, m0 + kGroup);
      forward(m0, mend - 1);  // inside the group
      for (int m = mend - 1; m >= m0; --m) jobs[n++] = m | 1 << 8;
    }
    jobs[kMaxJobs - 1] = n;
  }
  if (tid < R) {
    uu[tid] = a.u[h * N + i0 + tid];
    duacc[tid] = 0.f;
  }
  {
    const long long sbase = ((static_cast<long long>(b) * a.nc + c) * H + h) * N * N + i0 * N;
    copy_rows<kThreads>(reinterpret_cast<unsigned char*>(slots), SN * 4,
              reinterpret_cast<const unsigned char*>(a.bounds + sbase), N * 4, R, R, N * 4);
    copy_rows<kThreads>(reinterpret_cast<unsigned char*>(G), SN * 4, reinterpret_cast<const unsigned char*>(a.gend + sbase),
              N * 4, R, R, N * 4);
  }
  auto issue = [&](int job, int buf) {
    const int m = job & 255, kind = job >> 8;
    const int ts = t0c + m * L, nt = min(L, T - ts);
    unsigned char* dst = raw + buf * Sm::kRaw;
    const long long tsz = static_cast<long long>(H) * N;  // elements between steps
    const long long row0 = at(ts) + i0;
    if (kind != 1) {  // forward: whole sub-chunks (every one but the chunk's last)
      const int rows = kind == 2 ? 2 * L : L;
      copy_rows<kThreads>(dst, R * sizeof(TI), static_cast<const unsigned char*>(a.k) + row0 * sizeof(TI),
                          tsz * sizeof(TI), rows, rows, R * sizeof(TI));
      copy_rows<kThreads>(dst + Sm::kFwdW, R * sizeof(TW), static_cast<const unsigned char*>(a.w) + row0 * sizeof(TW),
                          tsz * sizeof(TW), rows, rows, R * sizeof(TW));
      copy_rows<kThreads>(dst + Sm::kFwdV, N * sizeof(TI), static_cast<const unsigned char*>(a.v) + at(ts) * sizeof(TI),
                          tsz * sizeof(TI), rows, rows, N * sizeof(TI));
      return;
    }
    copy_rows<kThreads>(dst, R * sizeof(TI), static_cast<const unsigned char*>(a.r) + row0 * sizeof(TI), tsz * sizeof(TI), L,
                        nt, R * sizeof(TI));
    copy_rows<kThreads>(dst + Sm::kRawK, R * sizeof(TI), static_cast<const unsigned char*>(a.k) + row0 * sizeof(TI),
              tsz * sizeof(TI), L, nt, R * sizeof(TI));
    copy_rows<kThreads>(dst + Sm::kRawW, R * sizeof(TW), static_cast<const unsigned char*>(a.w) + row0 * sizeof(TW),
              tsz * sizeof(TW), L, nt, R * sizeof(TW));
    copy_rows<kThreads>(dst + Sm::kRawV, N * sizeof(TI), static_cast<const unsigned char*>(a.v) + at(ts) * sizeof(TI),
              tsz * sizeof(TI), L, nt, N * sizeof(TI));
    copy_rows<kThreads>(dst + Sm::kRawD, SN * 4, reinterpret_cast<const unsigned char*>(a.dy + at(ts)), tsz * 4, L, nt, N * 4);
  };
  __syncthreads();  // the job list
  const int njobs = jobs[kMaxJobs - 1];
  issue(jobs[0], 0);
  cp_commit();
  if (njobs > 1) issue(jobs[1], 1);
  cp_commit();

  // dv of the last backward job, summed in the next backward job (before it
  // writes its own partial) once every block of the cluster has written its
  // partial: the half-barrier's wait comes late and rarely waits
  bool pending = false;
  int pts = 0, pnt = 0, nbwd = 0;
  auto finish_dv = [&]() {
    constexpr int kCols = N / CS;
    const float* mine = dvp + ((nbwd - 1) & 1) * (L * SN);
    const float* parts[CS];
    if constexpr (CS > 1) {
      cluster_wait();
      cg::cluster_group cluster = cg::this_cluster();
#pragma unroll
      for (int p = 0; p < CS; ++p) parts[p] = cluster.map_shared_rank(mine, p);
    } else {
      parts[0] = mine;
    }
    for (int x = tid; x < pnt * kCols; x += kThreads) {
      const int t = x / kCols, j = rank * kCols + x - t * kCols;
      float acc = parts[0][t * SN + j];
#pragma unroll
      for (int p = 1; p < CS; ++p) acc += parts[p][t * SN + j];
      from_f(static_cast<TI*>(a.dv) + at(pts + t) + j, acc);
    }
    pending = false;
  };

  for (int n = 0; n < njobs; ++n) {
    cp_wait1();
    __syncthreads();  // job n's inputs landed; every thread is done with job n - 1
    if (n + 2 < njobs) issue(jobs[n + 2], (n + 2) % kStages);  // into job n - 1's buffer
    cp_commit();

    const int job = jobs[n], m = job & 255, nf = job >> 8 == 2 ? 2 : 1;
    const bool bwd = job >> 8 == 1;
    const int ts = t0c + m * L, nt = min(L, T - ts);
    const unsigned char* src = raw + (n % kStages) * Sm::kRaw;
    const float* dyr = reinterpret_cast<const float*>(src + Sm::kRawD);  // dy [L][SN], zeros past nt

    // -- widen r, k, w and scan the decays; widen v; gamma = rowsum(GL * S0) --
    if (bwd) {
      widen_rows<R, TI, TW, true, kThreads>(src, Sm::kRawK, Sm::kRawW, nt,
                                            [&](int i, int t, float rx, float kx, float wx, float cpx, float ex,
                                                float clx) {
                                              rrT[i * ST + t] = rx;
                                              kkT[i * ST + t] = kx;
                                              wwT[i * ST + t] = wx;
                                              cpT[i * ST + t] = cpx;
                                              eT[i * ST + t] = ex;
                                              ktT[i * ST + t] = kx * ex;
                                              rtT[i * ST + t] = rx * cpx;
                                              if (t == 0) cl[i] = clx;
                                            });
      const float* S0 = slot(m);
#pragma unroll
      for (int x = tid; x < R * L; x += kThreads) {  // row i over 16 lanes, a fixed tree
        const int i = x >> 4, p = x & 15;
        float acc = 0.f;
#pragma unroll
        for (int j = p; j < N; j += 16) acc = fmaf(G[i * SN + j], S0[i * SN + j], acc);
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
        if (p == 0) gam[i] = acc;
      }
      const TI* sv = reinterpret_cast<const TI*>(src + Sm::kRawV);
      for (int x = tid; x < L * N; x += kThreads) {
        const int t = x / N;
        vv[t * SN + x - t * N] = to_f(sv[x]);
      }
    } else {  // sub-chunk m + h's K~ and cL into (ktT, cl) for h = 0, (rtT, gam) for h = 1; its v into vv, scratch
      for (int hh = 0; hh < nf; ++hh) {
        float* kth = hh ? rtT : ktT;
        float* clh = hh ? gam : cl;
        widen_rows<R, TI, TW, false, kThreads>(src + hh * L * R * sizeof(TI), 0,
                                               Sm::kFwdW + hh * L * R * (int(sizeof(TW)) - int(sizeof(TI))), L,
                                               [&](int i, int t, float, float kx, float, float, float ex, float clx) {
                                                 kth[i * ST + t] = kx * ex;
                                                 if (t == 0) clh[i] = clx;
                                               });
      }
      const TI* sv = reinterpret_cast<const TI*>(src + Sm::kFwdV);
      float* v2 = smem + Sm::oScr;  // the second sub-chunk's v: the pair terms' scratch is free here
      for (int x = tid; x < nf * L * N; x += kThreads) {
        const int t = x / N;
        (t < L ? vv : v2)[(t & (L - 1)) * SN + x - t * N] = to_f(sv[x]);
      }
    }
    __syncthreads();

    if (!bwd) {
      // -- forward: S_{m+1} = diag(cL) S_m + K~^T V (warps over 8-column tiles), then
      // for a double job S_{m+2} from S_{m+1} in the same registers --
      const float* s0 = slot(m);
      float* s1 = slot(m + 1);
      float* s2 = slot(m + 2);
      const float* v2 = smem + Sm::oScr;
      float af[2][4], af2[2][4];
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        load_a(af[ks], ks * 8, [&](int i, int s) { return i < R ? ktT[i * ST + s] : 0.f; });
        load_a(af2[ks], ks * 8, [&](int i, int s) { return i < R ? rtT[i * ST + s] : 0.f; });
      }
      for (int nt8 = warp; nt8 < NT; nt8 += kWarps) {
        const int j0 = nt8 * 8;
        float d[4];
        d[0] = g < R ? cl[g] * s0[g * SN + j0 + 2 * q] : 0.f;
        d[1] = g < R ? cl[g] * s0[g * SN + j0 + 2 * q + 1] : 0.f;
        d[2] = g + 8 < R ? cl[g + 8] * s0[(g + 8) * SN + j0 + 2 * q] : 0.f;
        d[3] = g + 8 < R ? cl[g + 8] * s0[(g + 8) * SN + j0 + 2 * q + 1] : 0.f;
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          float bf[2];
          load_b(bf, ks * 8, [&](int s, int j) { return vv[s * SN + j0 + j]; });
          mma_step<kSplit>(d, af[ks], bf);
        }
        if (g < R) {
          s1[g * SN + j0 + 2 * q] = d[0];
          s1[g * SN + j0 + 2 * q + 1] = d[1];
        }
        if (g + 8 < R) {
          s1[(g + 8) * SN + j0 + 2 * q] = d[2];
          s1[(g + 8) * SN + j0 + 2 * q + 1] = d[3];
        }
        if (nf == 2) {
          d[0] *= g < R ? gam[g] : 0.f;
          d[1] *= g < R ? gam[g] : 0.f;
          d[2] *= g + 8 < R ? gam[g + 8] : 0.f;
          d[3] *= g + 8 < R ? gam[g + 8] : 0.f;
#pragma unroll
          for (int ks = 0; ks < 2; ++ks) {
            float bf[2];
            load_b(bf, ks * 8, [&](int s, int j) { return v2[s * SN + j0 + j]; });
            mma_step<kSplit>(d, af2[ks], bf);
          }
          if (g < R) {
            s2[g * SN + j0 + 2 * q] = d[0];
            s2[g * SN + j0 + 2 * q + 1] = d[1];
          }
          if (g + 8 < R) {
            s2[(g + 8) * SN + j0 + 2 * q] = d[2];
            s2[(g + 8) * SN + j0 + 2 * q + 1] = d[3];
          }
        }
      }
      continue;  // the next job's first barrier orders these writes
    }

    const float* S0 = slot(m);
    // -- P^T, Q^T (i x t) and A^T (s x q): 2 R / 8 + 2 tiles of K = N --
    {
      constexpr int kPQ = R / 8;
      for (int tile = warp; tile < 2 * kPQ + 2; tile += kWarps) {
        float d[4] = {0.f, 0.f, 0.f, 0.f};
        float* out;
        int n0;
        if (tile < kPQ) {
          n0 = tile * 8;
          mma_tile<kSplit, N / 8>(
              d, [&](int t, int j) { return dyr[t * SN + j]; }, [&](int j, int i) { return S0[(n0 + i) * SN + j]; });
          out = PT;
        } else if (tile < 2 * kPQ) {
          n0 = (tile - kPQ) * 8;
          mma_tile<kSplit, N / 8>(
              d, [&](int t, int j) { return vv[t * SN + j]; }, [&](int j, int i) { return G[(n0 + i) * SN + j]; });
          out = QT;
        } else {
          n0 = (tile - 2 * kPQ) * 8;
          mma_tile<kSplit, N / 8>(
              d, [&](int t, int j) { return dyr[t * SN + j]; }, [&](int j, int s) { return vv[(n0 + s) * SN + j]; });
          out = AT;
        }
        out[(n0 + 2 * q) * ST + g] = d[0];
        out[(n0 + 2 * q + 1) * ST + g] = d[1];
        out[(n0 + 2 * q) * ST + g + 8] = d[2];
        out[(n0 + 2 * q + 1) * ST + g + 8] = d[3];
      }
    }
    __syncthreads();

    // -- per row: the pair terms on the CUDA cores.  A warp pass takes one row
    // i, lane (half, t): step t, and of the later steps q those in
    // [8 half, 8 half + 8). --
    {
      float* scr = smem + Sm::oScr + warp * Sm::kScr;
      const int half = lane >> 4, t = lane & 15, q0 = half * 8;
      float* WT = scr;               // W^T[t][q] = W[q][t] = prod_{t < p < q} w_p (q > t)
      float* XX = scr + L * ST;      // X[t][q] = sum_s W[t][s] k_s A[q][s]
      float* T2 = scr + 2 * L * ST;  // T2[t] = sum_s W[t][s] k_s Q[s]
      float bp[8], bdiag = 0.f;  // B[t][q0 + x] over this warp's rows: W[q][t] r_q k_t; the diagonal r_t u k_t
#pragma unroll
      for (int x = 0; x < 8; ++x) bp[x] = 0.f;
      for (int i = warp; i < R; i += kWarps) {
        // W: half 0, lane t as column s = t, a running product down the steps
        if (half == 0) {
          const int s = t;
          float run = 1.f;
#pragma unroll
          for (int t4 = 0; t4 < L; t4 += 4) {
            const float4 w4 = *reinterpret_cast<const float4*>(wwT + i * ST + t4);
            const float wq[4] = {w4.x, w4.y, w4.z, w4.w};
            float o[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              o[e] = t4 + e > s ? run : 0.f;
              if (t4 + e > s) run *= wq[e];
            }
            *reinterpret_cast<float4*>(WT + s * ST + t4) = make_float4(o[0], o[1], o[2], o[3]);
          }
        }
        __syncwarp();
        // X and T2: U = W k (t x s) times [A^T | Q^T] (s x 17), K = L
        {
          float d[3][4] = {};
#pragma unroll
          for (int ks = 0; ks < 2; ++ks) {
            float af[4];
            load_a(af, ks * 8, [&](int tt, int s) { return WT[s * ST + tt] * kkT[i * ST + s]; });
#pragma unroll
            for (int n8 = 0; n8 < 3; ++n8) {
              float bf[2];
              load_b(bf, ks * 8, [&](int s, int qq) {
                return n8 < 2 ? AT[s * ST + n8 * 8 + qq] : (qq == 0 ? QT[i * ST + s] : 0.f);
              });
              mma_step<kSplit>(d[n8], af, bf);
            }
          }
#pragma unroll
          for (int n8 = 0; n8 < 2; ++n8) {
            *reinterpret_cast<float2*>(XX + g * ST + n8 * 8 + 2 * q) = make_float2(d[n8][0], d[n8][1]);
            *reinterpret_cast<float2*>(XX + (g + 8) * ST + n8 * 8 + 2 * q) = make_float2(d[n8][2], d[n8][3]);
          }
          if (q == 0) {
            T2[g] = d[2][0];
            T2[g + 8] = d[2][2];
          }
        }
        __syncwarp();
        // the dot products over this lane's later steps q > t
        const float ui = uu[i], kt = kkT[i * ST + t], rt = rrT[i * ST + t];
        float dka = 0.f, t3 = 0.f, t4s = 0.f;
#pragma unroll
        for (int c4 = 0; c4 < 8; c4 += 4) {
          const int qb = q0 + c4;
          const float4 wt = *reinterpret_cast<const float4*>(WT + t * ST + qb);
          const float4 r4 = *reinterpret_cast<const float4*>(rrT + i * ST + qb);
          const float4 a4 = *reinterpret_cast<const float4*>(AT + t * ST + qb);
          const float4 p4 = *reinterpret_cast<const float4*>(PT + i * ST + qb);
          const float4 x4 = *reinterpret_cast<const float4*>(XX + t * ST + qb);
          const float vq[4] = {wt.x * r4.x, wt.y * r4.y, wt.z * r4.z, wt.w * r4.w};  // W[q][t] r_q
          const float av[4] = {a4.x, a4.y, a4.z, a4.w}, pv[4] = {p4.x, p4.y, p4.z, p4.w};
          const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            dka = fmaf(vq[e], av[e], dka);
            t3 = fmaf(vq[e], pv[e], t3);
            t4s = fmaf(vq[e], xv[e], t4s);
            bp[c4 + e] = fmaf(vq[e], kt, bp[c4 + e]);
          }
        }
        dka += __shfl_xor_sync(0xffffffffu, dka, 16);  // the two halves' later steps (a + b == b + a)
        t3 += __shfl_xor_sync(0xffffffffu, t3, 16);
        t4s += __shfl_xor_sync(0xffffffffu, t4s, 16);
        const float att = AT[t * ST + t];
        float dux = 0.f;
        if (half == 0) {
          const float cpt = cpT[i * ST + t], et = eT[i * ST + t];
          odr[t * SR + i] = fmaf(cpt, PT[i * ST + t], XX[t * ST + t]) + ui * kt * att;
          odk[t * SR + i] = fmaf(et, QT[i * ST + t], dka) + ui * rt * att;
          odw[t * SR + i] = fmaf(cpt * et, gam[i], fmaf(et, T2[t], fmaf(cpt, t3, t4s)));
          bdiag = fmaf(rt * ui, kt, bdiag);
          dux = rt * kt * att;
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) dux += __shfl_xor_sync(0xffffffffu, dux, off);
        if (lane == 0) duacc[i] += dux;
        __syncwarp();  // the next pass overwrites W, X and T2
      }
      // this warp's B partial [t][q] into its W^T region, the diagonal's extra in column L
#pragma unroll
      for (int x = 0; x < 8; x += 4)
        *reinterpret_cast<float4*>(scr + t * ST + q0 + x) = make_float4(bp[x], bp[x + 1], bp[x + 2], bp[x + 3]);
      if (half == 0) scr[t * ST + L] = bdiag;
    }
    __syncthreads();
    // B summed over the warps in order
    for (int x = tid; x < L * L; x += kThreads) {
      const int t = x >> 4, qq = x & 15;
      const float* bw = smem + Sm::oScr + t * ST;
      float acc = 0.f;
#pragma unroll
      for (int wp = 0; wp < kWarps; ++wp) acc += bw[wp * Sm::kScr + qq];
      if (t == qq) {
#pragma unroll
        for (int wp = 0; wp < kWarps; ++wp) acc += bw[wp * Sm::kScr + L];
      }
      Bs[t * ST + qq] = acc;
    }
    __syncthreads();
    // the previous backward job's dv: the other blocks have long written their partials
    if (pending) finish_dv();

    // -- dv partial = K~ GL + B DY (t x j), then GL <- diag(cL) GL + R~^T DY, warps over 8-column tiles --
    float* dvb = dvp + (nbwd & 1) * (L * SN);
    {
      float bfr[2][4], kfr[KR][4], rfr[2][4];
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) load_a(bfr[ks], ks * 8, [&](int t, int qq) { return Bs[t * ST + qq]; });
#pragma unroll
      for (int ks = 0; ks < KR; ++ks) load_a(kfr[ks], ks * 8, [&](int t, int i) { return i < R ? ktT[i * ST + t] : 0.f; });
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) load_a(rfr[ks], ks * 8, [&](int i, int s) { return i < R ? rtT[i * ST + s] : 0.f; });
      for (int nt8 = warp; nt8 < NT; nt8 += kWarps) {
        const int j0 = nt8 * 8;
        float d[4] = {0.f, 0.f, 0.f, 0.f}, d2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int ks = 0; ks < KR; ++ks) {
          float bf[2];
          load_b(bf, ks * 8, [&](int i, int j) { return i < R ? G[i * SN + j0 + j] : 0.f; });
          mma_step<kSplit>(d, kfr[ks], bf);
        }
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          float bf[2];
          load_b(bf, ks * 8, [&](int qq, int j) { return dyr[qq * SN + j0 + j]; });
          mma_step<kSplit>(d2, bfr[ks], bf);
        }
        *reinterpret_cast<float2*>(dvb + g * SN + j0 + 2 * q) = make_float2(d[0] + d2[0], d[1] + d2[1]);
        *reinterpret_cast<float2*>(dvb + (g + 8) * SN + j0 + 2 * q) = make_float2(d[2] + d2[2], d[3] + d2[3]);
        __syncwarp();  // every lane has read its GL operands before any lane writes GL
        float e[4];
        e[0] = g < R ? cl[g] * G[g * SN + j0 + 2 * q] : 0.f;
        e[1] = g < R ? cl[g] * G[g * SN + j0 + 2 * q + 1] : 0.f;
        e[2] = g + 8 < R ? cl[g + 8] * G[(g + 8) * SN + j0 + 2 * q] : 0.f;
        e[3] = g + 8 < R ? cl[g + 8] * G[(g + 8) * SN + j0 + 2 * q + 1] : 0.f;
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          float bf[2];
          load_b(bf, ks * 8, [&](int s, int j) { return dyr[s * SN + j0 + j]; });
          mma_step<kSplit>(e, rfr[ks], bf);
        }
        __syncwarp();
        if (g < R) *reinterpret_cast<float2*>(G + g * SN + j0 + 2 * q) = make_float2(e[0], e[1]);
        if (g + 8 < R) *reinterpret_cast<float2*>(G + (g + 8) * SN + j0 + 2 * q) = make_float2(e[2], e[3]);
      }
    }
    if constexpr (CS > 1) cluster_arrive();  // this block's dv partial is written
    // dr, dk, dw of this block's rows
    for (int x = tid; x < nt * R; x += kThreads) {
      const int t = x / R, i = x - t * R;
      const long long o = at(ts + t) + i0 + i;
      from_f(static_cast<TI*>(a.dr) + o, odr[t * SR + i]);
      from_f(static_cast<TI*>(a.dk) + o, odk[t * SR + i]);
      from_f(static_cast<TW*>(a.dw) + o, odw[t * SR + i]);
    }
    pending = true;
    pts = ts;
    pnt = nt;
    ++nbwd;
  }
  __syncthreads();
  if (pending) finish_dv();
  if (c == 0) {  // G before the first step
    for (int x = tid; x < R * N; x += kThreads) {
      const int i = x / N, j = x - i * N;
      a.dstate0[(bh * N + i0 + i) * N + j] = G[i * SN + j];
    }
  }
  if (tid < R) a.du_parts[((static_cast<long long>(b) * a.nc + c) * H + h) * N + i0 + tid] = duacc[tid];
  if constexpr (CS > 1) {  // no block leaves while another still reads its dv partials
    cluster_arrive();
    cluster_wait();
  }
}

// G_loc of chunk c >= 1 (R~^T DY over its steps, R~ = r times the decay
// from the chunk's start) into gend[b, c - 1], and the chunk's decay into
// cdecay[b, c].  Grid ((nc - 1) H, B): a block takes all N rows of a
// (chunk, h, b), so dy is staged once; warps over 16 x 8 output tiles.
template <int N, typename TI, typename TW>
struct GlocSmem {
  static constexpr int SN = N + 4;
  static constexpr int kRawW = L * N * sizeof(TI);                  // staged r [L][N], w [L][N], dy [L][SN]
  static constexpr int kRawD = up16(kRawW + L * N * sizeof(TW));
  static constexpr int kRaw = kRawD + L * SN * 4;
  static constexpr int kBytes = kStages * kRaw + N * ST * 4 + N * 4;  // + R~ [N][ST], the carried decay [N]
};

template <int N, typename TI, typename TW, bool kSplit>
__global__ void __launch_bounds__(kGlocThreads) wkv6_gloc_kernel(const Args a) {
  using Gs = GlocSmem<N, TI, TW>;
  constexpr int SN = Gs::SN, MT = (N + 15) / 16, NT = N / 8, kW = kGlocThreads / 32;
  constexpr int kTiles = (MT * NT + kW - 1) / kW;
  extern __shared__ __align__(16) unsigned char gsm[];
  float* rtT = reinterpret_cast<float*>(gsm + kStages * Gs::kRaw);
  float* carry = rtT + N * ST;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int c = 1 + blockIdx.x / a.H, h = blockIdx.x % a.H, b = blockIdx.y;
  const int T = a.T, H = a.H, t0c = c * a.chunk;
  const int nsub = (min(a.chunk, T - t0c) + L - 1) / L;
  auto at = [&](int t) { return ((static_cast<long long>(b) * T + t) * H + h) * N; };
  auto issue = [&](int m, int buf) {
    const int ts = t0c + m * L, nt = min(L, T - ts);
    const long long tsz = static_cast<long long>(H) * N;
    unsigned char* dst = gsm + buf * Gs::kRaw;
    copy_rows<kGlocThreads>(dst, N * sizeof(TI), static_cast<const unsigned char*>(a.r) + at(ts) * sizeof(TI),
                            tsz * sizeof(TI), L, nt, N * sizeof(TI));
    copy_rows<kGlocThreads>(dst + Gs::kRawW, N * sizeof(TW), static_cast<const unsigned char*>(a.w) + at(ts) * sizeof(TW),
                            tsz * sizeof(TW), L, nt, N * sizeof(TW));
    copy_rows<kGlocThreads>(dst + Gs::kRawD, SN * 4, reinterpret_cast<const unsigned char*>(a.dy + at(ts)), tsz * 4, L,
                            nt, N * 4);
  };
  float acc[kTiles][4] = {};
  for (int i = tid; i < N; i += kGlocThreads) carry[i] = 1.f;
  issue(0, 0);
  cp_commit();
  if (nsub > 1) issue(1, 1);
  cp_commit();
  for (int m = 0; m < nsub; ++m) {
    cp_wait1();
    __syncthreads();
    if (m + 2 < nsub) issue(m + 2, (m + 2) % kStages);
    cp_commit();
    const int nt = min(L, T - (t0c + m * L));
    const unsigned char* src = gsm + (m % kStages) * Gs::kRaw;
    const float* dyr = reinterpret_cast<const float*>(src + Gs::kRawD);
    // R~ = r times the decay from the chunk's start: the carry times the scan inside the sub-chunk
    widen_rows<N, TI, TW, true, kGlocThreads>(src, 0, Gs::kRawW, nt,
                                              [&](int i, int t, float rx, float, float, float cpx, float, float clx) {
                                                const float c0 = carry[i];
                                                rtT[i * ST + t] = rx * (c0 * cpx);
                                                __syncwarp();
                                                if (t == 0) carry[i] = c0 * clx;
                                              });
    __syncthreads();
#pragma unroll
    for (int x = 0; x < kTiles; ++x) {
      const int tile = warp + x * kW, i0 = (tile / NT) * 16, j0 = (tile % NT) * 8;
      if (tile < MT * NT) {
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          float af[4], bf[2];
          load_a(af, ks * 8, [&](int i, int s) { return i0 + i < N ? rtT[(i0 + i) * ST + s] : 0.f; });
          load_b(bf, ks * 8, [&](int s, int j) { return dyr[s * SN + j0 + j]; });
          mma_step<kSplit>(acc[x], af, bf);
        }
      }
    }
  }
  float* out = a.gend + ((static_cast<long long>(b) * a.nc + c - 1) * H + h) * N * N;
#pragma unroll
  for (int x = 0; x < kTiles; ++x) {
    const int tile = warp + x * kW, i0 = (tile / NT) * 16, j0 = (tile % NT) * 8;
    if (tile >= MT * NT) continue;
    if (i0 + g < N) {
      out[(i0 + g) * N + j0 + 2 * q] = acc[x][0];
      out[(i0 + g) * N + j0 + 2 * q + 1] = acc[x][1];
    }
    if (i0 + g + 8 < N) {
      out[(i0 + g + 8) * N + j0 + 2 * q] = acc[x][2];
      out[(i0 + g + 8) * N + j0 + 2 * q + 1] = acc[x][3];
    }
  }
  __syncthreads();
  for (int i = tid; i < N; i += kGlocThreads)
    a.cdecay[((static_cast<long long>(b) * a.nc + c) * H + h) * N + i] = carry[i];
}

// G at each chunk's end: gend[b, nc - 1] = dstate, then backward over the
// chunks G_{c-1} = D_c G_c + G_loc,c, elementwise (G_loc,c is in gend[b, c - 1]).
template <int N>
__global__ void wkv6_gscan_kernel(const Args a) {
  const long long n = static_cast<long long>(a.B) * a.H * N * N;
  const long long hnn = static_cast<long long>(a.H) * N * N;
  for (long long x = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; x < n;
       x += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long b = x / hnn, rest = x - b * hnn;  // rest = (h N + i) N + j
    const long long hi = rest / N;                     // h N + i
    float gx = a.dstate ? a.dstate[x] : 0.f;
    float* col = a.gend + b * a.nc * hnn + rest;       // gend[b, c] at col + c hnn
    col[static_cast<long long>(a.nc - 1) * hnn] = gx;
    for (int c = a.nc - 1; c >= 1; --c) {
      gx = fmaf(a.cdecay[(b * a.nc + c) * a.H * N + hi], gx, col[(c - 1) * hnn]);
      col[(c - 1) * hnn] = gx;
    }
  }
}

// du = the per-block partials summed over b and the chunks in order.
__global__ void wkv6_du_kernel(const float* du_parts, float* du, int B, int nc, int hn) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= hn) return;
  float acc = 0.f;
  for (int b = 0; b < B; ++b)
    for (int c = 0; c < nc; ++c) acc += du_parts[(static_cast<long long>(b) * nc + c) * hn + x];
  du[x] = acc;
}


template <int N, typename TI, typename TW, bool kSplit>
cudaError_t launch_w(const Args& a, cudaStream_t st) {
  using Sh = Shape<N>;
  cudaError_t e;
  if (a.nc > 1) {
    auto gloc = wkv6_gloc_kernel<N, TI, TW, kSplit>;
    constexpr int gsmem = GlocSmem<N, TI, TW>::kBytes;
    if (gsmem > 48 * 1024 &&
        (e = cudaFuncSetAttribute(gloc, cudaFuncAttributeMaxDynamicSharedMemorySize, gsmem)) != cudaSuccess)
      return e;
    gloc<<<dim3((a.nc - 1) * a.H, a.B), kGlocThreads, gsmem, st>>>(a);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  const long long n = static_cast<long long>(a.B) * a.H * N * N;
  const long long blocks = (n + 255) / 256;
  wkv6_gscan_kernel<N><<<static_cast<unsigned>(blocks < 132 * 16 ? blocks : 132 * 16), 256, 0, st>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  auto kernel = wkv6_bwd_kernel<N, TI, TW, kSplit>;
  const int nsub = (a.chunk + L - 1) / L;
  const size_t smem = Smem<N, TI, TW>::bytes(num_groups(nsub) + kGroup - 1);
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess) e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(Sh::CS, a.nc * a.H, a.B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = Sh::CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if ((e = cudaLaunchKernelEx(&cfg, kernel, a)) != cudaSuccess) return e;
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const int hn = a.H * N;
  wkv6_du_kernel<<<(hn + 255) / 256, 256, 0, st>>>(a.du_parts, a.du, a.B, a.nc, hn);
  return cudaGetLastError();
}

template <int N, typename TI, bool kSplit>
cudaError_t launch_n(const Args& a, int w_bf16, cudaStream_t st) {
  return w_bf16 ? launch_w<N, TI, __nv_bfloat16, kSplit>(a, st) : launch_w<N, TI, float, kSplit>(a, st);
}

template <typename TI, bool kSplit>
cudaError_t launch_t(const Args& a, int N, int w_bf16, cudaStream_t st) {
  switch (N) {
    case 8: return launch_n<8, TI, kSplit>(a, w_bf16, st);
    case 16: return launch_n<16, TI, kSplit>(a, w_bf16, st);
    case 32: return launch_n<32, TI, kSplit>(a, w_bf16, st);
    case 64: return launch_n<64, TI, kSplit>(a, w_bf16, st);
    case 128: return launch_n<128, TI, kSplit>(a, w_bf16, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The gradient of repro_wkv6_fwd, on `stream`.  r, k, v (one type, bf16 if
// rkv_bf16) and w (bf16 if w_bf16) are contiguous [B, T, H, N]; u [H, N],
// bounds [B, nc = ceil(T / chunk), H, N, N] (the forward's saved states), dy
// [B, T, H, N] and dstate [B, H, N, N] (null: zeros) float32.  Writes dr,
// dk, dv (r's type), dw (w's type), du [H, N] and dstate0 [B, H, N, N]
// float32, through the scratch gend [B, nc, H, N, N], cdecay and du_parts
// [B, nc, H, N] float32.  `split` names the route: 1 for 3xTF32 (float32
// r, k, v), 0 for TF32 (bf16); any other pairing is refused.  chunk is a
// multiple of 16 up to 256; N one of 8, 16, 32, 64, 128.  Returns
// cudaGetLastError() of the launches (0 on success).
int repro_wkv6_bwd(int device, int rkv_bf16, int w_bf16, int split, int N, const void* r, const void* k,
                   const void* v, const void* w, const void* u, const void* bounds, const void* dy,
                   const void* dstate, void* dr, void* dk, void* dv, void* dw, void* du, void* dstate0, void* gend,
                   void* cdecay, void* du_parts, int B, int T, int H, int chunk, void* stream) {
  if (chunk < L || chunk % L != 0 || chunk > L * kGroup * kGroup || split != !rkv_bf16)
    return static_cast<int>(cudaErrorInvalidValue);
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
  a.dv = dv;
  a.dw = dw;
  a.du = static_cast<float*>(du);
  a.dstate0 = static_cast<float*>(dstate0);
  a.gend = static_cast<float*>(gend);
  a.cdecay = static_cast<float*>(cdecay);
  a.du_parts = static_cast<float*>(du_parts);
  a.B = B;
  a.T = T;
  a.H = H;
  a.chunk = chunk;
  a.nc = (T + chunk - 1) / chunk;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  e = rkv_bf16 ? launch_t<__nv_bfloat16, false>(a, N, w_bf16, st) : launch_t<float, true>(a, N, w_bf16, st);
  return static_cast<int>(e);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
