// Backward of the causal / sliding-window flash attention on Hopper
// (sm_90a), bf16.
//
// Training only: the TPU package has no backward kernel (its training
// forward runs the jnp reference, repro/models/attention.py), so this has
// no Pallas counterpart.  The forward is flash_attention.cu, which now also
// writes each row's log-sum-exp lse = ln sum_j exp(scale s_j) (BH, S) f32;
// the backward reads it and never re-runs the forward.
//
// Layout as the forward: q, o, dO, dQ (BH, S, D); k, v, dK, dV (BH_kv, S,
// D), kv row bh / rep serving query row bh (MQA and GQA read in place).
// FA2's scheme, two launches on the stream:
//   1. dq    per (q head, 64-row q block), 4 warps of 16 rows: Delta =
//            rowsum(dO .* O) for its rows (f32, also written to a (BH, S)
//            workspace for launch 2), then for every 32-key kv tile that a
//            row of the block sees: S = Q K^T, P = exp(scale S - lse),
//            dP = dO V^T, dS = P .* (dP - Delta), dQ += dS K.
//   2. dkdv  per (kv head, 64-row kv block, half of D), 4 warps of 16 kv
//            rows: for each of the rep query heads that share the kv head
//            and every 32-row q tile that sees the block: S^T = K Q^T,
//            P^T, dP^T = V dO^T, dS^T, then dV += P^T dO and dK += dS^T Q
//            over the CTA's columns of D.  The heads' sums run in the CTA
//            in a fixed order: no atomics, and two runs are bitwise equal.
// Tiles wholly outside the causal window are skipped, as in the forward;
// the rest are masked per entry (p = 0 for an invisible key or a row past
// S).
//
// D = 256 is the squeeze.  A warp's f32 dK and dV accumulators over all of
// D would be 16 x 256 x 2 floats, 256 registers a thread: launch 2 splits
// D into halves (two CTAs a kv block, each recomputing S^T and dP^T over
// the full D), so a thread holds 2 x 64 accumulator floats.  Launch 1
// keeps dQ's 16 x 256 in 128 registers a thread.  Shared memory (bf16
// rows padded to D + 8 elements, so the fragment loads are free of bank
// conflicts), at D = 256 (dq_smem and dkdv_smem below):
//   dq:    Q and dO 64 rows, K and V 32 rows: 101,376 B + lse and Delta;
//   dkdv:  K and V 64 rows, Q and dO 32 rows: 101,376 B + lse and Delta.
//
// Products: bf16 mma.sync m16n8k16 with f32 accumulation; P and dS are
// rounded to bf16 as the A operand of dV, dQ and dK (FA2 does the same);
// exp, the row terms and the accumulators are f32; the gradients are
// written in bf16.  Bound on this card: operations.  At the
// RecurrentGemma-9B training shape (q (32, 4096, 256), one kv head per 16
// q heads, window 2048) the visible (q, key) pairs are 6.29 M a head; the
// backward needs 4 D flops a pair for each of dV, dP, dQ and dK (~515
// GFLOP, 0.52 ms at 989 TFLOP/s); the two launches recompute S twice and
// dP twice (and launch 2 S^T and dP^T once more for its second half of D).
// This is the simple first version: plain loads into shared memory, no
// pipelining, no wgmma.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 128;   // 4 warps of 16 rows
constexpr int kBQ = 64;         // q rows of a dq CTA
constexpr int kBK = 32;         // kv rows of a dq tile
constexpr int kBKV = 64;        // kv rows of a dkdv CTA
constexpr int kBQT = 32;        // q rows of a dkdv tile

__device__ __forceinline__ bool visible(int qpos, int kpos, int S, int causal,
                                        int window) {
  bool ok = qpos < S && kpos < S;
  if (causal) ok = ok && kpos <= qpos;
  if (window > 0) ok = ok && kpos > qpos - window;
  return ok;
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t pack2f(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a b, m16n8k16, bf16 in, f32 accumulate.  Fragments (g = lane / 4,
// t = lane % 4): a[0] rows g, columns 2t, 2t + 1; a[1] row g + 8; a[2],
// a[3] the same at columns + 8.  b[0] k rows 2t, 2t + 1 of column g, b[1]
// k rows + 8.  d[0..1] row g, columns 2t, 2t + 1; d[2..3] row g + 8.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A fragment: A[r][k] = T[r0 + r][k0 + k], T row-major with stride ld.
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* T,
                                       int ld, int r0, int k0, int g, int t) {
  const bf16* p = T + (r0 + g) * ld + k0 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

// B fragment with B[k][n] = T[n0 + n][k0 + k] (T row-major by n).
__device__ __forceinline__ void frag_b_nk(uint32_t (&b)[2], const bf16* T,
                                          int ld, int n0, int k0, int g,
                                          int t) {
  const bf16* p = T + (n0 + g) * ld + k0 + 2 * t;
  b[0] = ld32(p);
  b[1] = ld32(p + 8);
}

// B fragment with B[k][n] = T[k0 + k][n0 + n] (T row-major by k).
__device__ __forceinline__ void frag_b_kn(uint32_t (&b)[2], const bf16* T,
                                          int ld, int n0, int k0, int g,
                                          int t) {
  const bf16* p = T + (k0 + 2 * t) * ld + n0 + g;
  b[0] = pack2(p[0], p[ld]);
  b[1] = pack2(p[8 * ld], p[9 * ld]);
}

// Rows [row0, row0 + rows) of a (S, D) bf16 matrix into shared memory with
// row stride ld (>= DP), zero past S and past D, 16 bytes a thread a step.
template <int DP>
__device__ __forceinline__ void stage(bf16* dst, const bf16* src, int row0,
                                      int rows, int S, int D, int ld) {
  constexpr int kVec = DP / 8;   // 16-byte pieces a row
  for (int e = threadIdx.x; e < rows * kVec; e += kThreads) {
    const int r = e / kVec, c = (e % kVec) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S && c < D)
      v = *reinterpret_cast<const uint4*>(src + size_t(row0 + r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = v;
  }
}

template <int DP>
constexpr size_t dq_smem() {
  return sizeof(bf16) * size_t(2 * kBQ + 2 * kBK) * (DP + 8) +
         2 * kBQ * sizeof(float);
}

template <int DP>
constexpr size_t dkdv_smem() {
  return sizeof(bf16) * size_t(2 * kBKV + 2 * kBQT) * (DP + 8) +
         2 * kBQT * sizeof(float);
}
static_assert(dq_smem<256>() <= 232448, "dq tiles exceed 227 KB");
static_assert(dkdv_smem<256>() <= 232448, "dkdv tiles exceed 227 KB");

// ---------------------------------------------------------------------------
// 1. dq (and Delta).
// ---------------------------------------------------------------------------

template <int DP>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ o,
                 const bf16* __restrict__ dout,
                 const float* __restrict__ lse, float* __restrict__ delta,
                 bf16* __restrict__ dq, int BH, int rep, int S, int D,
                 float scale, int causal, int window) {
  constexpr int LD = DP + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + kBQ * LD;
  bf16* Ks = dOs + kBQ * LD;
  bf16* Vs = Ks + kBK * LD;
  float* sLse = reinterpret_cast<float*>(Vs + kBK * LD);
  float* sDelta = sLse + kBQ;

  const int bh = blockIdx.x % BH;
  const int q_start = (blockIdx.x / BH) * kBQ;
  const size_t off = size_t(bh) * S * D;
  const size_t off_kv = size_t(bh / rep) * S * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;

  stage<DP>(Qs, q + off, q_start, kBQ, S, D, LD);
  stage<DP>(dOs, dout + off, q_start, kBQ, S, D, LD);
  // Delta = rowsum(dO .* O) of the warp's 16 rows, lanes over D.
  for (int r = 16 * warp; r < 16 * warp + 16; ++r) {
    const int row = q_start + r;
    float acc = 0.0f;
    if (row < S)
      for (int c = lane; c < D; c += 32) {
        const size_t at = off + size_t(row) * D + c;
        acc += __bfloat162float(dout[at]) * __bfloat162float(o[at]);
      }
#pragma unroll
    for (int sh = 16; sh > 0; sh >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, sh);
    if (lane == 0) {
      sDelta[r] = acc;
      sLse[r] = row < S ? lse[size_t(bh) * S + row] : 0.0f;
      if (row < S) delta[size_t(bh) * S + row] = acc;
    }
  }

  // kv tiles with a key some row of the block sees.
  const int q_last = min(S - 1, q_start + kBQ - 1);
  const int k_first = window > 0 ? max(0, q_start - window + 1) : 0;
  const int k_last = causal ? q_last : S - 1;
  const int r_lo = 16 * warp + g;   // this thread's rows r_lo, r_lo + 8
  float dacc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dacc[n][e] = 0.0f;

  for (int kt = k_first / kBK; kt <= k_last / kBK; ++kt) {
    const int k_start = kt * kBK;
    __syncthreads();   // Q, dO, Delta staged; the last tile's K, V read
    stage<DP>(Ks, k + off_kv, k_start, kBK, S, D, LD);
    stage<DP>(Vs, v + off_kv, k_start, kBK, S, D, LD);
    __syncthreads();

    float s[kBK / 8][4], dp[kBK / 8][4];
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
#pragma unroll 4
    for (int kk = 0; kk < DP; kk += 16) {
      uint32_t aq[4], ad[4];
      frag_a(aq, Qs, LD, 16 * warp, kk, g, t);
      frag_a(ad, dOs, LD, 16 * warp, kk, g, t);
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n) {
        uint32_t b[2];
        frag_b_nk(b, Ks, LD, 8 * n, kk, g, t);
        mma(s[n], aq, b);
        frag_b_nk(b, Vs, LD, 8 * n, kk, g, t);
        mma(dp[n], ad, b);
      }
    }
    // dS = P .* (dP - Delta) in place of s.
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r_lo + 8 * (e >> 1);
        const int kpos = k_start + 8 * n + 2 * t + (e & 1);
        const float p = visible(q_start + r, kpos, S, causal, window)
                            ? expf(s[n][e] * scale - sLse[r])
                            : 0.0f;
        s[n][e] = p * (dp[n][e] - sDelta[r]);
      }
    // dQ += dS K: dS as the A operand (the accumulator fragment of two
    // n8 tiles is the A fragment of one k16 step), K row-major by key.
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {
      const uint32_t a[4] = {pack2f(s[2 * j][0], s[2 * j][1]),
                             pack2f(s[2 * j][2], s[2 * j][3]),
                             pack2f(s[2 * j + 1][0], s[2 * j + 1][1]),
                             pack2f(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        uint32_t b[2];
        frag_b_kn(b, Ks, LD, 8 * n, 16 * j, g, t);
        mma(dacc[n], a, b);
      }
    }
  }

#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    const int col = 8 * n + 2 * t;
    if (col >= D) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q_start + r_lo + 8 * h;
      if (row < S)
        *reinterpret_cast<uint32_t*>(dq + off + size_t(row) * D + col) =
            pack2f(dacc[n][2 * h] * scale, dacc[n][2 * h + 1] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// 2. dkdv.
// ---------------------------------------------------------------------------

template <int DP, int DH>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, int BH_kv, int rep, int S, int D,
                   float scale, int causal, int window) {
  constexpr int LD = DP + 8;
  constexpr int kSplit = DP / DH;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + kBKV * LD;
  bf16* Qs = Vs + kBKV * LD;
  bf16* dOs = Qs + kBQT * LD;
  float* sLse = reinterpret_cast<float*>(dOs + kBQT * LD);
  float* sDelta = sLse + kBQT;

  const int bkv = blockIdx.x % BH_kv;
  const int rest = blockIdx.x / BH_kv;
  const int d0 = (rest % kSplit) * DH;   // this CTA's columns of D
  const int k_start = (rest / kSplit) * kBKV;
  const size_t off_kv = size_t(bkv) * S * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r_lo = 16 * warp + g;   // this thread's kv rows r_lo, r_lo + 8

  stage<DP>(Ks, k + off_kv, k_start, kBKV, S, D, LD);
  stage<DP>(Vs, v + off_kv, k_start, kBKV, S, D, LD);

  // q rows that see a key of the block.
  const int k_last = min(S - 1, k_start + kBKV - 1);
  const int q_first = causal ? k_start : 0;
  const int q_last = window > 0 ? min(S - 1, k_last + window - 1) : S - 1;

  float kacc[DH / 8][4], vacc[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) kacc[n][e] = vacc[n][e] = 0.0f;

  for (int hh = 0; hh < rep; ++hh) {
    const int bh = bkv * rep + hh;
    const size_t off = size_t(bh) * S * D;
    for (int qt = q_first / kBQT; qt <= q_last / kBQT; ++qt) {
      const int q0 = qt * kBQT;
      __syncthreads();   // the last tile's Q, dO, lse and Delta read
      stage<DP>(Qs, q + off, q0, kBQT, S, D, LD);
      stage<DP>(dOs, dout + off, q0, kBQT, S, D, LD);
      for (int r = threadIdx.x; r < kBQT; r += kThreads) {
        const bool in = q0 + r < S;
        sLse[r] = in ? lse[size_t(bh) * S + q0 + r] : 0.0f;
        sDelta[r] = in ? delta[size_t(bh) * S + q0 + r] : 0.0f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: the warp's 16 kv rows x 32 q.
      float st[kBQT / 8][4], dpt[kBQT / 8][4];
#pragma unroll
      for (int n = 0; n < kBQT / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.0f;
#pragma unroll 4
      for (int kk = 0; kk < DP; kk += 16) {
        uint32_t ak[4], av[4];
        frag_a(ak, Ks, LD, 16 * warp, kk, g, t);
        frag_a(av, Vs, LD, 16 * warp, kk, g, t);
#pragma unroll
        for (int n = 0; n < kBQT / 8; ++n) {
          uint32_t b[2];
          frag_b_nk(b, Qs, LD, 8 * n, kk, g, t);
          mma(st[n], ak, b);
          frag_b_nk(b, dOs, LD, 8 * n, kk, g, t);
          mma(dpt[n], av, b);
        }
      }
      // P^T in st, dS^T in dpt.
#pragma unroll
      for (int n = 0; n < kBQT / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k_start + r_lo + 8 * (e >> 1);
          const int c = 8 * n + 2 * t + (e & 1);
          const float p = visible(q0 + c, kpos, S, causal, window)
                              ? expf(st[n][e] * scale - sLse[c])
                              : 0.0f;
          st[n][e] = p;
          dpt[n][e] = p * (dpt[n][e] - sDelta[c]);
        }
      // dV += P^T dO and dK += dS^T Q over this CTA's columns.
#pragma unroll
      for (int j = 0; j < kBQT / 16; ++j) {
        const uint32_t ap[4] = {pack2f(st[2 * j][0], st[2 * j][1]),
                                pack2f(st[2 * j][2], st[2 * j][3]),
                                pack2f(st[2 * j + 1][0], st[2 * j + 1][1]),
                                pack2f(st[2 * j + 1][2], st[2 * j + 1][3])};
        const uint32_t as[4] = {pack2f(dpt[2 * j][0], dpt[2 * j][1]),
                                pack2f(dpt[2 * j][2], dpt[2 * j][3]),
                                pack2f(dpt[2 * j + 1][0], dpt[2 * j + 1][1]),
                                pack2f(dpt[2 * j + 1][2],
                                       dpt[2 * j + 1][3])};
#pragma unroll
        for (int n = 0; n < DH / 8; ++n) {
          uint32_t b[2];
          frag_b_kn(b, dOs, LD, d0 + 8 * n, 16 * j, g, t);
          mma(vacc[n], ap, b);
          frag_b_kn(b, Qs, LD, d0 + 8 * n, 16 * j, g, t);
          mma(kacc[n], as, b);
        }
      }
    }
  }

#pragma unroll
  for (int n = 0; n < DH / 8; ++n) {
    const int col = d0 + 8 * n + 2 * t;
    if (col >= D) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = k_start + r_lo + 8 * h;
      if (row >= S) continue;
      const size_t at = off_kv + size_t(row) * D + col;
      *reinterpret_cast<uint32_t*>(dk + at) =
          pack2f(kacc[n][2 * h] * scale, kacc[n][2 * h + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + at) =
          pack2f(vacc[n][2 * h], vacc[n][2 * h + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// Launcher.
// ---------------------------------------------------------------------------

template <int DP>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* lse, void* delta, void* dq,
           void* dk, void* dv, int BH, int BH_kv, int S, int D, int causal,
           int window, cudaStream_t stream) {
  constexpr int DH = DP > 128 ? 128 : DP;
  const auto dq_k = fa_bwd_dq_kernel<DP>;
  const auto dkdv_k = fa_bwd_dkdv_kernel<DP, DH>;
  cudaError_t err = cudaFuncSetAttribute(
      dq_k, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(dq_smem<DP>()));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dkdv_k,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(dkdv_smem<DP>()));
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale =
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
  const int rep = BH / BH_kv;
  const unsigned dq_grid = static_cast<unsigned>((S + kBQ - 1) / kBQ) * BH;
  dq_k<<<dq_grid, kThreads, dq_smem<DP>(), stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(o),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<bf16*>(dq), BH, rep, S, D,
      scale, causal, window);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const unsigned kv_grid =
      static_cast<unsigned>((S + kBKV - 1) / kBKV) * (DP / DH) * BH_kv;
  dkdv_k<<<kv_grid, kThreads, dkdv_smem<DP>(), stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), BH_kv, rep, S, D,
      scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o, dout, dq: (BH, S, D) bf16; k, v, dk, dv: (BH_kv, S, D) bf16 with
// BH_kv dividing BH; lse (the forward's) and the workspace delta: (BH, S)
// f32.  Contiguous, 16-byte aligned, on the stream's device; D a multiple
// of 16 and at most 256.  Two launches on the stream; returns the first
// nonzero cudaError_t (0 on success), cudaErrorInvalidValue for a shape the
// kernels do not take.
extern "C" int repro_flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int BH, int BH_kv, int S, int D, int causal, int window,
    void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (BH <= 0 || BH_kv <= 0 || BH % BH_kv != 0 || S <= 0 || D <= 0 ||
      D % 16 != 0 || D > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  if (D <= 64)
    return launch<64>(q, k, v, o, dout, lse, delta, dq, dk, dv, BH, BH_kv, S,
                      D, causal, window, st);
  if (D <= 128)
    return launch<128>(q, k, v, o, dout, lse, delta, dq, dk, dv, BH, BH_kv,
                       S, D, causal, window, st);
  return launch<256>(q, k, v, o, dout, lse, delta, dq, dk, dv, BH, BH_kv, S,
                     D, causal, window, st);
}
