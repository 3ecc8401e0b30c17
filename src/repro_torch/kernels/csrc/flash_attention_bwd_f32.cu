// Backward of the causal / sliding-window flash attention on Hopper
// (sm_90a), f32.
//
// Training only: the TPU package has no backward kernel (its training
// forward runs the jnp reference, repro/models/attention.py), so this has
// no Pallas counterpart.  It is the f32 entry beside the bf16 one of
// flash_attention_bwd.cu: the same FA2 formulas from the forward's
// log-sum-exp lse = ln sum_j exp(scale s_j) (BH, S) f32, in exact f32
// arithmetic (fmaf, no tensor cores, no TF32), as the f32 forward of
// flash_attention.cu computes.
//
// Layout as the forward: q, o, dO, dQ (BH, S, D); k, v, dK, dV (BH_kv, S,
// D), kv row bh / rep serving query row bh (MQA and GQA read in place).
// Three launches on the stream:
//   1. prep  a thread a row: Delta = rowsum(dO .* O) into a (BH, S) f32
//            workspace, summed in the order of dP's sums (below).
//   2. dq    a CTA per (q head, 64-row q block), over every visible kv
//            tile of 32 rows: S = Q K^T, P = exp(scale S - lse), dP =
//            dO V^T, dS = P .* (dP - Delta), dQ += dS K; dQ scaled at the
//            end.
//   3. dkdv  a CTA per (32-row kv block, kv head), over the rep query
//            heads of the kv head in order and each one's visible q tiles
//            of 64 rows: S^T = K Q^T, dP^T = V dO^T, dV += P^T dO, dK +=
//            dS^T Q.  The heads' sum runs inside the CTA in a fixed order:
//            no atomics, so two launches are bitwise equal.
//
// Bound on this card: operations.  At the RecurrentGemma-9B training shape
// (q (32, 4096, 256), one kv head per 16 q heads, window 2048) the visible
// (q, key) pairs are 6.29 M a head and the function needs 2 D flops a pair
// for each of S, dP, dV, dQ and dK (~515 GFLOP, 7.7 ms at the 67 TFLOP/s
// of f32 FMA); the dq launch computes S and dP again (7 products).
//
// Design: a simple tiled kernel in shared memory, as the f32 forward.
// Tiles are staged by cp.async (16 bytes a copy, rows past S and columns
// past D zero-filled) into rows padded by 4 floats, so a quarter-warp's
// 16-byte loads of 8 rows fall on distinct banks.  Each product keeps a
// register tile per thread: a warp owns rows of one operand, loaded as
// 16-byte broadcasts, and its lanes own rows (the S-like products) or
// 4 columns of D (the accumulating products) of the other; 8 warps a CTA,
// one CTA an SM (217 KB of shared memory at D = 256).  f32 sums of D
// terms and of a tile's rows run in a fixed order.  Loads and products do
// not overlap (one tile buffer); that and the 32-row kv tiles are what a
// faster design would change.
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

constexpr int kThreads = 256;   // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kBQ = 64;         // q rows of a tile
constexpr int kBK = 32;         // kv rows of a tile
constexpr int kPQ = kBQ + 4;    // row stride of P^T and dS^T (dkdv)
constexpr int kPK = kBK + 4;    // row stride of dS (dq)

// At head dimension DP (64, 128 or 256): the columns the lanes cover (4 a
// lane, 128 a warp, so at least 128), the row stride of a staged tile, the
// float4 columns a lane owns, and each launch's dynamic shared memory.
template <int DP>
struct Cfg {
  static constexpr int kDW = DP < 128 ? 128 : DP;
  static constexpr int kLD = kDW + 4;
  static constexpr int kNC = kDW / 128;
  // K, V; Q, dO; P^T, dS^T; lse and Delta of the q tile.
  static constexpr size_t kDkdvSmem =
      sizeof(float) * (2 * kBK * kLD + 2 * kBQ * kLD + 2 * kBK * kPQ +
                       2 * kBQ);
  // Q, dO; K, V; dS.
  static constexpr size_t kDqSmem =
      sizeof(float) * (2 * kBQ * kLD + 2 * kBK * kLD + kBQ * kPK);
  static_assert(kDkdvSmem <= 232448, "dkdv tiles exceed 227 KB");
  static_assert(kDqSmem <= 232448, "dq tiles exceed 227 KB");
};

__device__ __forceinline__ bool visible(int qpos, int kpos, int S, int causal,
                                        int window) {
  bool ok = qpos < S && kpos < S;
  if (causal) ok = ok && kpos <= qpos;
  if (window > 0) ok = ok && kpos > qpos - window;
  return ok;
}

// Whether any (q, key) pair of a (kBQ-row q tile, kBK-row kv tile) is
// visible: the forward's skip test.
__device__ __forceinline__ bool tile_runs(int q0, int k0, int causal,
                                          int window) {
  bool run = true;
  if (causal) run = k0 <= q0 + kBQ - 1;
  if (window > 0) run = run && (k0 + kBK - 1 > q0 - window);
  return run;
}

// Stage rows [r0, r0 + ROWS) of a (S, D) matrix into `dst` (row stride
// kLD, kDW columns): 16-byte cp.async copies, zero-filled past S and D.
template <int DP, int ROWS>
__device__ __forceinline__ void stage(float* dst,
                                      const float* __restrict__ src, int r0,
                                      int S, int D) {
  constexpr int kC4 = Cfg<DP>::kDW / 4;
  static_assert((ROWS * kC4) % kThreads == 0, "uneven staging");
#pragma unroll
  for (int it = 0; it < ROWS * kC4 / kThreads; ++it) {
    const int e = threadIdx.x + it * kThreads;
    const int r = e / kC4, c = 4 * (e % kC4);
    const bool in = r0 + r < S && c < D;
    const float* from = in ? src + static_cast<size_t>(r0 + r) * D + c : src;
    const unsigned to = static_cast<unsigned>(
        __cvta_generic_to_shared(dst + r * Cfg<DP>::kLD + c));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(to),
                 "l"(from), "r"(in ? 16 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void staged() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc += x . y over four terms, in order.
__device__ __forceinline__ float dot4(float4 x, float4 y, float acc) {
  acc = fmaf(x.x, y.x, acc);
  acc = fmaf(x.y, y.y, acc);
  acc = fmaf(x.z, y.z, acc);
  return fmaf(x.w, y.w, acc);
}

// acc[0..3] += s * y.
__device__ __forceinline__ void axpy4(float s, float4 y, float* acc) {
  acc[0] = fmaf(s, y.x, acc[0]);
  acc[1] = fmaf(s, y.y, acc[1]);
  acc[2] = fmaf(s, y.z, acc[2]);
  acc[3] = fmaf(s, y.w, acc[3]);
}

__device__ __forceinline__ float comp(float4 x, int u) {
  return u == 0 ? x.x : u == 1 ? x.y : u == 2 ? x.z : x.w;
}

// ---------------------------------------------------------------------------
// 1. prep: Delta per row.
// ---------------------------------------------------------------------------

constexpr int kPrepThreads = 128;   // a thread a row

// Delta_i sums dO_i . O_i over D in the order the dq and dkdv launches sum
// dP_ij = dO_i . V_j (one fmaf a column, from column 0): where a row's
// softmax sits on one key, O_i is V_j bitwise, and dS_ij = P_ij (dP_ij -
// Delta_i) is exactly 0, as it is in exact arithmetic.
__global__ void __launch_bounds__(kPrepThreads)
fa32_bwd_prep_kernel(const float* __restrict__ o,
                     const float* __restrict__ dout,
                     float* __restrict__ delta, long long rows, int D) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kPrepThreads + threadIdx.x;
  if (row >= rows) return;
  const size_t base = static_cast<size_t>(row) * D;
  float acc = 0.0f;
  for (int c = 0; c < D; c += 4)
    acc = dot4(ld4(dout + base + c), ld4(o + base + c), acc);
  delta[row] = acc;
}

// ---------------------------------------------------------------------------
// 2. dq: rows j = warp + 8 a of the q tile; S and dP at key `lane` of the
// kv tile; dQ at columns 4 (lane + 32 c) + e.
// ---------------------------------------------------------------------------

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
fa32_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v,
                   const float* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dq,
                   int rep, int S, int D, float scale, int causal,
                   int window) {
  using C = Cfg<DP>;
  constexpr int kRows = kBQ / kWarps;   // 8 q rows a warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Os = Qs + kBQ * C::kLD;        // dO
  float* Ks = Os + kBQ * C::kLD;
  float* Vs = Ks + kBK * C::kLD;
  float* Ds = Vs + kBK * C::kLD;        // dS (kBQ, kPK)

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;   // heaviest first
  const int bh = blockIdx.y;
  const size_t q_off = static_cast<size_t>(bh) * S * D;
  const size_t kv_off = static_cast<size_t>(bh / rep) * S * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  stage<DP, kBQ>(Qs, q + q_off, q0, S, D);
  stage<DP, kBQ>(Os, dout + q_off, q0, S, D);
  float lse_r[kRows], delta_r[kRows];
#pragma unroll
  for (int a = 0; a < kRows; ++a) {
    const int qpos = q0 + warp + kWarps * a;
    const size_t row = static_cast<size_t>(bh) * S + qpos;
    lse_r[a] = qpos < S ? lse[row] : 0.0f;
    delta_r[a] = qpos < S ? delta[row] : 0.0f;
  }
  float acc[kRows][C::kNC][4];
#pragma unroll
  for (int a = 0; a < kRows; ++a)
#pragma unroll
    for (int c = 0; c < C::kNC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][c][e] = 0.0f;

  const int nk = (S + kBK - 1) / kBK;
  for (int kb = 0; kb < nk; ++kb) {
    const int k0 = kb * kBK;
    if (!tile_runs(q0, k0, causal, window)) continue;
    __syncthreads();   // the last tile's K and dS are read
    stage<DP, kBK>(Ks, k + kv_off, k0, S, D);
    stage<DP, kBK>(Vs, v + kv_off, k0, S, D);
    staged();
    __syncthreads();

    float s[kRows], dp[kRows];
#pragma unroll
    for (int a = 0; a < kRows; ++a) s[a] = 0.0f, dp[a] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < DP; d += 4) {
      const float4 kf = ld4(Ks + lane * C::kLD + d);
      const float4 vf = ld4(Vs + lane * C::kLD + d);
#pragma unroll
      for (int a = 0; a < kRows; ++a) {
        const int j = warp + kWarps * a;
        s[a] = dot4(ld4(Qs + j * C::kLD + d), kf, s[a]);
        dp[a] = dot4(ld4(Os + j * C::kLD + d), vf, dp[a]);
      }
    }
#pragma unroll
    for (int a = 0; a < kRows; ++a) {
      const int j = warp + kWarps * a;
      const float p = visible(q0 + j, k0 + lane, S, causal, window)
                          ? expf(s[a] * scale - lse_r[a])
                          : 0.0f;
      Ds[j * kPK + lane] = p * (dp[a] - delta_r[a]);
    }
    __syncthreads();

#pragma unroll 2
    for (int i = 0; i < kBK; i += 4) {
      float4 ds[kRows];
#pragma unroll
      for (int a = 0; a < kRows; ++a)
        ds[a] = ld4(Ds + (warp + kWarps * a) * kPK + i);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int c = 0; c < C::kNC; ++c) {
          const float4 kf = ld4(Ks + (i + u) * C::kLD + 4 * (lane + 32 * c));
#pragma unroll
          for (int a = 0; a < kRows; ++a) axpy4(comp(ds[a], u), kf, acc[a][c]);
        }
      }
    }
  }
  staged();   // nothing left in flight, also when no kv tile ran

#pragma unroll
  for (int a = 0; a < kRows; ++a) {
    const int qpos = q0 + warp + kWarps * a;
    if (qpos >= S) continue;
#pragma unroll
    for (int c = 0; c < C::kNC; ++c) {
      const int col = 4 * (lane + 32 * c);
      if (col < D)
        *reinterpret_cast<float4*>(dq + q_off + static_cast<size_t>(qpos) * D +
                                   col) =
            make_float4(acc[a][c][0] * scale, acc[a][c][1] * scale,
                        acc[a][c][2] * scale, acc[a][c][3] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// 3. dkdv: kv rows i = warp + 8 a of the block; S^T and dP^T at q rows
// lane + 32 b of the q tile; dK and dV at columns 4 (lane + 32 c) + e.
// ---------------------------------------------------------------------------

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
fa32_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int rep, int S, int D,
                     float scale, int causal, int window) {
  using C = Cfg<DP>;
  constexpr int kRows = kBK / kWarps;   // 4 kv rows a warp
  constexpr int kCols = kBQ / 32;       // 2 q rows a lane
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);
  float* Vs = Ks + kBK * C::kLD;
  float* Qs = Vs + kBK * C::kLD;
  float* Os = Qs + kBQ * C::kLD;        // dO
  float* Ps = Os + kBQ * C::kLD;        // P^T (kBK, kPQ)
  float* Ds = Ps + kBK * kPQ;           // dS^T (kBK, kPQ)
  float* Ls = Ds + kBK * kPQ;           // lse of the q tile's rows
  float* Es = Ls + kBQ;                 // Delta

  const int k0 = blockIdx.x * kBK;
  const int hkv = blockIdx.y;
  const size_t kv_off = static_cast<size_t>(hkv) * S * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  stage<DP, kBK>(Ks, k + kv_off, k0, S, D);
  stage<DP, kBK>(Vs, v + kv_off, k0, S, D);
  float acc_k[kRows][C::kNC][4], acc_v[kRows][C::kNC][4];
#pragma unroll
  for (int a = 0; a < kRows; ++a)
#pragma unroll
    for (int c = 0; c < C::kNC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_k[a][c][e] = 0.0f, acc_v[a][c][e] = 0.0f;

  const int nq = (S + kBQ - 1) / kBQ;
  for (int hq = 0; hq < rep; ++hq) {
    const int bh = hkv * rep + hq;
    const size_t q_off = static_cast<size_t>(bh) * S * D;
    for (int qb = 0; qb < nq; ++qb) {
      const int q0 = qb * kBQ;
      if (!tile_runs(q0, k0, causal, window)) continue;
      __syncthreads();   // the last tile's Q, dO, P^T and dS^T are read
      stage<DP, kBQ>(Qs, q + q_off, q0, S, D);
      stage<DP, kBQ>(Os, dout + q_off, q0, S, D);
      if (threadIdx.x < kBQ) {
        const int qpos = q0 + threadIdx.x;
        const size_t row = static_cast<size_t>(bh) * S + qpos;
        Ls[threadIdx.x] = qpos < S ? lse[row] : 0.0f;
        Es[threadIdx.x] = qpos < S ? delta[row] : 0.0f;
      }
      staged();
      __syncthreads();

      float s[kRows][kCols], dp[kRows][kCols];
#pragma unroll
      for (int a = 0; a < kRows; ++a)
#pragma unroll
        for (int b = 0; b < kCols; ++b) s[a][b] = 0.0f, dp[a][b] = 0.0f;
#pragma unroll 2
      for (int d = 0; d < DP; d += 4) {
        float4 qf[kCols], of[kCols];
#pragma unroll
        for (int b = 0; b < kCols; ++b) {
          qf[b] = ld4(Qs + (lane + 32 * b) * C::kLD + d);
          of[b] = ld4(Os + (lane + 32 * b) * C::kLD + d);
        }
#pragma unroll
        for (int a = 0; a < kRows; ++a) {
          const int i = warp + kWarps * a;
          const float4 kf = ld4(Ks + i * C::kLD + d);
          const float4 vf = ld4(Vs + i * C::kLD + d);
#pragma unroll
          for (int b = 0; b < kCols; ++b) {
            s[a][b] = dot4(kf, qf[b], s[a][b]);
            dp[a][b] = dot4(vf, of[b], dp[a][b]);
          }
        }
      }
#pragma unroll
      for (int a = 0; a < kRows; ++a) {
        const int i = warp + kWarps * a;
#pragma unroll
        for (int b = 0; b < kCols; ++b) {
          const int j = lane + 32 * b;
          const float p = visible(q0 + j, k0 + i, S, causal, window)
                              ? expf(s[a][b] * scale - Ls[j])
                              : 0.0f;
          Ps[i * kPQ + j] = p;
          Ds[i * kPQ + j] = p * (dp[a][b] - Es[j]);
        }
      }
      __syncthreads();

#pragma unroll 1
      for (int j = 0; j < kBQ; j += 4) {
        float4 pf[kRows], df[kRows];
#pragma unroll
        for (int a = 0; a < kRows; ++a) {
          pf[a] = ld4(Ps + (warp + kWarps * a) * kPQ + j);
          df[a] = ld4(Ds + (warp + kWarps * a) * kPQ + j);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
#pragma unroll
          for (int c = 0; c < C::kNC; ++c) {
            const int col = 4 * (lane + 32 * c);
            const float4 o4 = ld4(Os + (j + u) * C::kLD + col);
            const float4 q4 = ld4(Qs + (j + u) * C::kLD + col);
#pragma unroll
            for (int a = 0; a < kRows; ++a) {
              axpy4(comp(pf[a], u), o4, acc_v[a][c]);
              axpy4(comp(df[a], u), q4, acc_k[a][c]);
            }
          }
        }
      }
    }
  }
  staged();   // nothing left in flight, also when no q tile ran

#pragma unroll
  for (int a = 0; a < kRows; ++a) {
    const int kpos = k0 + warp + kWarps * a;
    if (kpos >= S) continue;
    const size_t row = kv_off + static_cast<size_t>(kpos) * D;
#pragma unroll
    for (int c = 0; c < C::kNC; ++c) {
      const int col = 4 * (lane + 32 * c);
      if (col >= D) continue;
      *reinterpret_cast<float4*>(dk + row + col) =
          make_float4(acc_k[a][c][0] * scale, acc_k[a][c][1] * scale,
                      acc_k[a][c][2] * scale, acc_k[a][c][3] * scale);
      *reinterpret_cast<float4*>(dv + row + col) =
          make_float4(acc_v[a][c][0], acc_v[a][c][1], acc_v[a][c][2],
                      acc_v[a][c][3]);
    }
  }
}

template <int DP>
int launch(const float* q, const float* k, const float* v, const float* o,
           const float* dout, const float* lse, float* delta, float* dq,
           float* dk, float* dv, int BH, int BH_kv, int S, int D, int causal,
           int window, cudaStream_t stream) {
  const int rep = BH / BH_kv;
  const float scale =
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
  cudaError_t err = cudaFuncSetAttribute(
      fa32_bwd_dq_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Cfg<DP>::kDqSmem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fa32_bwd_dkdv_kernel<DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(Cfg<DP>::kDkdvSmem));
  if (err != cudaSuccess) return static_cast<int>(err);

  const long long rows = static_cast<long long>(BH) * S;
  const unsigned prep_grid =
      static_cast<unsigned>((rows + kPrepThreads - 1) / kPrepThreads);
  fa32_bwd_prep_kernel<<<prep_grid, kPrepThreads, 0, stream>>>(o, dout, delta,
                                                               rows, D);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  const dim3 dq_grid((S + kBQ - 1) / kBQ, BH);
  fa32_bwd_dq_kernel<DP><<<dq_grid, kThreads, Cfg<DP>::kDqSmem, stream>>>(
      q, k, v, dout, lse, delta, dq, rep, S, D, scale, causal, window);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  const dim3 kv_grid((S + kBK - 1) / kBK, BH_kv);
  fa32_bwd_dkdv_kernel<DP><<<kv_grid, kThreads, Cfg<DP>::kDkdvSmem, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, rep, S, D, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o, dout, dq: (BH, S, D) f32; k, v, dk, dv: (BH_kv, S, D) f32 with
// BH_kv dividing BH; lse (the forward's): (BH, S) f32; the workspace ws:
// (BH, S) f32 (Delta).  Contiguous, 16-byte aligned, on the stream's
// device; D a multiple of 8 and at most 256.  Three launches on the
// stream; returns the first nonzero cudaError_t (0 on success),
// cudaErrorInvalidValue for a shape the kernels do not take.
extern "C" int repro_flash_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* ws, void* dq, void* dk,
    void* dv, int BH, int BH_kv, int S, int D, int causal, int window,
    void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (BH <= 0 || BH_kv <= 0 || BH % BH_kv != 0 || BH_kv > 65535 ||
      BH > 65535 || S <= 0 || D <= 0 || D % 8 != 0 || D > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto w = [](void* p) { return static_cast<float*>(p); };
  if (D <= 64)
    return launch<64>(f(q), f(k), f(v), f(o), f(dout), f(lse), w(ws), w(dq),
                      w(dk), w(dv), BH, BH_kv, S, D, causal, window, st);
  if (D <= 128)
    return launch<128>(f(q), f(k), f(v), f(o), f(dout), f(lse), w(ws),
                       w(dq), w(dk), w(dv), BH, BH_kv, S, D, causal, window,
                       st);
  return launch<256>(f(q), f(k), f(v), f(o), f(dout), f(lse), w(ws), w(dq),
                     w(dk), w(dv), BH, BH_kv, S, D, causal, window, st);
}
