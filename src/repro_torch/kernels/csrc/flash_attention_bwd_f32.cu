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
// Layout as the forward: q, o, dO, dQ (BH, S, D); k, v, dK, dV (BH_kv,
// S_kv, D), kv row bh / rep serving query row bh (MQA and GQA read in
// place); S_kv = S unless the attention is non-causal with no window (a
// cross-attention): dq streams kv tiles over S_kv keys, dkdv runs over S_kv
// key rows and streams q tiles over S query rows.
// Three launches on the stream:
//   1. prep  a thread a row: Delta = rowsum(dO .* O) into a (BH, S) f32
//            workspace, summed in the order of dkdv's dP sums (below).
//   2. dq    a CTA per (48-row q block, q head), heaviest q block first,
//            over every visible kv tile of 16 rows, two at a time: S = Q
//            K^T, P = exp(scale S - lse), dS_ij = P_ij (dO_i . (V_j -
//            O_i)); dQ = scale (dS K - m P K) with m_i = sum_j dS_ij /
//            sum_j P_ij.  A row's dQ is a sum of dS_ij K_j that nearly
//            cancels (sum_j dS_ij = 0) and is small wherever the row's
//            g_ij = dO_i . (V_j - O_i) nearly agree, so three things keep
//            its digits: V_j - O_i is taken element by element inside the
//            sum over D (where a row's softmax sits nearly on one key,
//            V_j ~ O_i, and dP_ij - Delta_i would leave mostly the
//            rounding of two near-equal sums); that sum is compensated
//            (dot4_diff); and m_i, 0 in exact arithmetic (sum_j P_ij V_j
//            = O_i), takes out the rounding of the saved O and lse
//            against this P, which would reach dQ as m_i times the
//            P-weighted mean of K.
//   3. dkdv  a CTA per (32-row kv block, kv head, query-head group),
//            heaviest kv block first, over the group's query heads in
//            order and each one's visible q tiles of 32 rows, two at a
//            time: S^T = K Q^T, dP^T = V dO^T, dV += P^T dO, dK += dS^T
//            Q, with dS^T = P^T .* (dP^T - Delta).  While the kv blocks
//            alone would leave the SMs ragged over two waves,
//            a kv block's query heads split into two groups, the CTAs of
//            a cluster of two, which sum their dK and dV through
//            distributed shared memory, group 0's part first.  No
//            atomics: two launches are bitwise equal.
//
// Bound on this card: operations.  At the RecurrentGemma-9B training shape
// (q (32, 4096, 256), one kv head per 16 q heads, window 2048) the visible
// (q, key) pairs are 6.29 M a head and the function needs 2 D flops a pair
// for each of S, dP, dV, dQ and dK (~515 GFLOP, 7.7 ms at the 67 TFLOP/s
// of f32 FMA); the dq launch computes S and dP again (7 products).
//
// Design: register-tiled FMA on cp.async copies.  A shared-memory load
// delivers at most 32 words a clock to an SM's lanes, broadcast or not,
// against 128 FMAs, so a product runs at the FMA rate only where a thread
// loads at most one word for every 4 of its multiply-adds: an r x c
// micro-tile of an output loads r + c words a column of the sum for r c
// of them.  The accumulating products (dV += P^T dO, dK += dS^T Q) keep
// 8 x 8 tiles (0.25 words a multiply-add), dS K and P K 6 x 8 on the same
// K loads (0.21).  The
// S-like products (S and dO (V - O); S^T and dP^T) are small a tile, so
// each launch gives one of them to each half of the CTA (warp groups A
// and B, 4 warps each), as the bf16 backward's consumers split them, and
// takes its streamed tiles two at a time (K and V in dq; Q, dO, lse and
// Delta in dkdv): in dkdv 16 entries a thread, 4 x 4 (0.5 words), where
// both products over all 8 warps on one tile would have 4 (1.0); in dq
// 12, 3 x 4 (0.58 words; 0.83 with O beside dO).  Each group copies its
// own operands with cp.async and waits on its own copies, and copies the
// next pair's as soon as it is past this pair's (dq: V during dS and dS
// K, K while group B starts on dO (V - O); dkdv: a half while the other
// half's dK and dV run).  Tiles are staged into rows padded by 4 floats,
// so a quarter-warp's 16-byte loads of 8 rows fall on distinct banks; 256
// threads a CTA, one CTA an SM (224.75 and 212.5 KB of shared memory at
// D = 256: Q, dO and O of 48 rows beside the K and V pairs and P and dS;
// 64 rows of O would not fit).  Every sum over D runs from column 0 (one
// fmaf chain, but dq's dO (V - O), compensated a quad at a time) and
// every sum over keys or query rows in order: two launches are bitwise
// equal.
//
// Soft-capping (softcap > 0): the forward capped each scaled score x as
// cap t, t = tanhf(x / cap), and wrote the lse of the capped scores.  P
// is exp(cap t - lse), and each dS meets K or Q times g = 1 - t^2: group A
// leaves g in the dS buffer beside P, and group B, which forms dS, scales
// it there (and, in dq, P too), so no buffer is added.  dq's sums keep
// their form: dQ = scale (sum_j g dS'_ij K_j - m_i sum_j g P_ij K_j) with
// dS' and m_i = sum_j dS'_ij / sum_j P_ij unchanged, the row sums of dS'
// and P taken by group B where it forms them (a lane's keys, then the 8
// lanes of a row) and handed to the dQ rows' warps through shared memory
// at the end.  The cap is a compile-time flag (kCap) of the dq and dkdv
// kernels: the uncapped instantiations are the code above unchanged; the
// capped ones are built from this file by
// flash_attention_bwd_f32_capped.cu, a source of their own, beside them.
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "fa32_fma.cuh"

namespace {

constexpr int kThreads = 256;   // 8 warps
constexpr int kStages = 2;      // tiles of a pair (K, V in dq; Q, dO dkdv)
constexpr int kBQ = 48;         // dq: q rows a CTA
constexpr int kBK = 16;         // dq: kv rows a tile, two to a pair
constexpr int kBKV = 32;        // dkdv: kv rows a CTA
constexpr int kBQT = 32;        // dkdv: q rows an item, two to a pair
constexpr int kPK = kStages * kBK + 4;   // row stride of P and dS (dq)
constexpr int kPQ = kStages * kBQT + 4;  // row stride of P^T, dS^T (dkdv)

// At head dimension DP (64, 128 or 256): the columns the lanes cover (4 a
// lane, 128 a warp, so at least 128), the row stride of a staged tile, the
// float4 columns a lane owns, and each launch's dynamic shared memory.
template <int DP>
struct Cfg {
  static constexpr int kDW = DP < 128 ? 128 : DP;
  static constexpr int kLD = kDW + 4;
  static constexpr int kNC = kDW / 128;
  // dq: Q, dO, O; a pair of K tiles and of V tiles; P and dS.
  static constexpr size_t kDqSmem =
      sizeof(float) *
      (3 * kBQ * kLD + 2 * kStages * kBK * kLD + 2 * kBQ * kPK);
  // dkdv: K, V; a pair of items' Q, dO, lse and Delta; P^T and dS^T.
  static constexpr size_t kDkdvSmem =
      sizeof(float) * (2 * kBKV * kLD + kStages * (2 * kBQT * kLD + 2 * kBQT) +
                       2 * kBKV * kPQ);
  static_assert(kDkdvSmem <= 232448, "dkdv tiles exceed 227 KB");
  static_assert(kDqSmem <= 232448, "dq tiles exceed 227 KB");
  // The cluster's exchange of one gradient's partial sum reuses the
  // pair's Q and dO.
  static_assert(2 * kStages * kBQT * kLD >= kBKV * kDW, "exchange too big");
};

__device__ __forceinline__ bool visible(int qpos, int kpos, int S, int Skv,
                                        int causal, int window) {
  bool ok = qpos < S && kpos < Skv;
  if (causal) ok = ok && kpos <= qpos;
  if (window > 0) ok = ok && kpos > qpos - window;
  return ok;
}

// Whether any (q, key) pair of a (bq-row q tile, bk-row kv tile) is
// visible: the forward's skip test.
__device__ __forceinline__ bool tile_runs(int q0, int k0, int bq, int bk,
                                          int causal, int window) {
  bool run = true;
  if (causal) run = k0 <= q0 + bq - 1;
  if (window > 0) run = run && (k0 + bk - 1 > q0 - window);
  return run;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Stage rows [r0, r0 + ROWS) of a (S, D) matrix into `dst` (row stride
// kLD, kDW columns) by NT threads, this one thread tid of them
// (fa32_fma.cuh).
template <int DP, int ROWS, int NT>
__device__ __forceinline__ void stage(float* dst,
                                      const float* __restrict__ src, int r0,
                                      int S, int D, int tid) {
  fa32::stage<Cfg<DP>::kLD, Cfg<DP>::kDW, ROWS, NT>(dst, src, r0, S, D, tid);
}

// One float of a row vector, element r of [r0, r0 + n), zero past S: a
// 4-byte cp.async (lse and Delta rows need not be 16-byte aligned).
__device__ __forceinline__ void stage_one(float* dst,
                                          const float* __restrict__ src,
                                          int r0, int r, int S) {
  const bool in = r0 + r < S;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst + r)),
               "l"(in ? src + r0 + r : src), "r"(in ? 4 : 0)
               : "memory");
}

using fa32::axpy4;
using fa32::commit;
using fa32::comp;
using fa32::dot4;
using fa32::ld4;

// ---------------------------------------------------------------------------
// 1. prep: Delta per row.
// ---------------------------------------------------------------------------

constexpr int kPrepThreads = 128;   // a thread a row

// Delta_i sums dO_i . O_i over D in the order the dkdv launch sums dP_ij =
// dO_i . V_j (one fmaf a column, from column 0): where a row's softmax
// sits on one key, O_i is V_j bitwise, and dS_ij = P_ij (dP_ij - Delta_i)
// is exactly 0, as it is in exact arithmetic.
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
// Warp groups: each launch gives one S-like product to each half of the
// CTA (4 warps each, group A and group B).
// ---------------------------------------------------------------------------

constexpr int kGroup = kThreads / 2;   // threads of a warp group

// A named barrier of one warp group (ids 1 and 2; 0 is __syncthreads).
__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + group), "r"(kGroup)
               : "memory");
}

// ---------------------------------------------------------------------------
// 2. dq.  The kv tiles a q block sees go in pairs (32 keys; the last pair
// may hold one tile).  Group A computes S and P, group B dO (V - O) and
// then dS = P .* dO (V - O): warp w % 4 of a group owns q rows 12 (w % 4)
// .. + 11, lane 8 g + j holding rows 12 (w % 4) + 3 g + i (i < 3) against
// keys j + 8 c (c < 4; c < 2 the pair's first tile).  dS K and P K (and
// the rows' sums of dS and P, in every lane): warp w owns q rows 6 w .. 6
// w + 5, the lane float4 columns 4 (lane + 32 h).  Group A copies Q and the K pairs, group B dO, O and the
// V pairs, each waiting on its own copies: the next pair's V is copied
// while this pair's dS and dS K run, its K once dS K is done (while group
// B starts on the next dO (V - O)).
// ---------------------------------------------------------------------------

// acc + x . (y - o) over four terms, each difference rounded once (where
// y ~ o the terms are small and nothing cancels after the sum): the four
// in one fmaf chain, that partial then added to acc compensated (Kahan:
// err carries acc's own rounding), so a sum over D = 256 keeps about 8
// times the digits of one fmaf chain.  A row's dS_ij - dS_ik rests on
// g_ij - g_ik = dO_i . (V_j - V_k), which one chain over D leaves with
// ~1e-5 of |g| where two keys' g nearly agree.
__device__ __forceinline__ void dot4_diff(float4 x, float4 y, float4 o,
                                          float& acc, float& err) {
  float part = x.x * (y.x - o.x);
  part = fmaf(x.y, y.y - o.y, part);
  part = fmaf(x.z, y.z - o.z, part);
  part = fmaf(x.w, y.w - o.w, part);
  const float t0 = part - err;
  const float t1 = acc + t0;
  err = (t1 - acc) - t0;
  acc = t1;
}

template <int DP, bool kCap>
__global__ void __launch_bounds__(kThreads, 1)
fa32_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ o,
                   const float* __restrict__ dout,
                   const float* __restrict__ lse, float* __restrict__ dq,
                   int BH, int rep, int S, int Skv, int D, float scale,
                   float cap, int causal, int window) {
  using C = Cfg<DP>;
  constexpr int kPair = kStages * kBK;   // keys of a pair
  constexpr int kRows = kBQ / 16;        // S rows a lane (3)
  constexpr int kAcc = kBQ / 8;          // dQ rows a warp (6)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ds = Qs + kBQ * C::kLD;        // dO
  float* Os = Ds + kBQ * C::kLD;        // O
  float* Ks = Os + kBQ * C::kLD;        // (kPair, kLD)
  float* Vs = Ks + kPair * C::kLD;      // (kPair, kLD)
  float* Ps = Vs + kPair * C::kLD;      // P (kBQ, kPK)
  float* Dss = Ps + kBQ * kPK;          // dS (kBQ, kPK)

  const int nq = (S + kBQ - 1) / kBQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x / BH)) * kBQ;
  const int bh = static_cast<int>(blockIdx.x % BH);
  const size_t q_off = static_cast<size_t>(bh) * S * D;
  const size_t kv_off = static_cast<size_t>(bh / rep) * Skv * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool group_b = warp >= 4;
  const int tg = threadIdx.x % kGroup;      // thread within its group
  const int g = lane / 8, j8 = lane % 8;
  const int sr = 12 * (warp % 4) + kRows * g;   // S rows sr + i

  // The kv tiles the q block sees: one contiguous range, in pairs.
  const int nk = (Skv + kBK - 1) / kBK;
  int lo = 0, hi = nk - 1;
  while (lo < nk && !tile_runs(q0, lo * kBK, kBQ, kBK, causal, window)) ++lo;
  while (hi >= lo && !tile_runs(q0, hi * kBK, kBQ, kBK, causal, window)) --hi;
  const int n_pairs = hi >= lo ? (hi - lo + 2) / 2 : 0;

  // The group's operands: Q and K (group A) or dO, O and V (group B).
  float* X = group_b ? Ds : Qs;
  float* Y = group_b ? Vs : Ks;
  const float* y_src = (group_b ? v : k) + kv_off;
  stage<DP, kBQ, kGroup>(X, (group_b ? dout : q) + q_off, q0, S, D, tg);
  if (group_b) stage<DP, kBQ, kGroup>(Os, o + q_off, q0, S, D, tg);
  if (n_pairs > 0) stage<DP, kPair, kGroup>(Y, y_src, lo * kBK, Skv, D, tg);
  commit();
  // Group A reads each row's lse.
  float row_lse[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qpos = q0 + sr + i;
    row_lse[i] =
        !group_b && qpos < S ? lse[static_cast<size_t>(bh) * S + qpos] : 0.0f;
  }
  // dS K and P K, and each row's sums of dS and of P, over the keys in
  // order.
  float acc[kAcc][C::kNC][4], pk[kAcc][C::kNC][4];
  float sum_ds[kAcc], sum_p[kAcc];
  // kCap: group B's sums of P and dS' of rows sr + i over its lanes' keys.
  float lane_p[kRows] = {}, lane_ds[kRows] = {};
#pragma unroll
  for (int r = 0; r < kAcc; ++r) {
    sum_ds[r] = sum_p[r] = 0.0f;
#pragma unroll
    for (int h = 0; h < C::kNC; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][h][e] = pk[r][h][e] = 0.0f;
  }

  for (int pr = 0; pr < n_pairs; ++pr) {
    const int t0 = lo + 2 * pr;
    const int tiles = t0 < hi ? 2 : 1;
    const bool more = pr + 1 < n_pairs;
    fa32::wait<0>();
    group_sync(group_b);   // the group's operands of this pair are in

    // S = Q K^T (group A; one fmaf chain over D from column 0 an entry)
    // or dO (V - O) (group B; compensated, dot4_diff).
    float s[kRows][4];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.0f;
    if (!group_b) {
#pragma unroll 2
      for (int d = 0; d < DP; d += 4) {
        float4 xa[kRows], yb[4];
#pragma unroll
        for (int i = 0; i < kRows; ++i) xa[i] = ld4(X + (sr + i) * C::kLD + d);
#pragma unroll
        for (int c = 0; c < 4; ++c) yb[c] = ld4(Y + (j8 + 8 * c) * C::kLD + d);
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[i][c] = dot4(xa[i], yb[c], s[i][c]);
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int at = (sr + i) * kPK + j8 + 8 * c;
          float x = s[i][c] * scale;
          if constexpr (kCap) {
            const float tc = tanhf(x / cap);
            x = tc * cap;
            Dss[at] = 1.0f - tc * tc;   // g, for group B
          }
          Ps[at] = visible(q0 + sr + i, t0 * kBK + j8 + 8 * c, S, Skv,
                           causal, window)
                       ? expf(x - row_lse[i])
                       : 0.0f;
        }
    } else {
      float err[kRows][4];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) err[i][c] = 0.0f;
      for (int d = 0; d < DP; d += 4) {
        float4 xa[kRows], oa[kRows], yb[4];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          xa[i] = ld4(X + (sr + i) * C::kLD + d);
          oa[i] = ld4(Os + (sr + i) * C::kLD + d);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) yb[c] = ld4(Y + (j8 + 8 * c) * C::kLD + d);
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            dot4_diff(xa[i], yb[c], oa[i], s[i][c], err[i][c]);
      }
    }
    __syncthreads();   // P is in; group B is past this pair's V
    if (group_b) {
      if (more) {
        stage<DP, kPair, kGroup>(Vs, y_src, (t0 + 2) * kBK, Skv, D, tg);
        commit();
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int at = (sr + i) * kPK + j8 + 8 * c;
          if constexpr (kCap) {
            // dS' and P into the rows' sums; g dS' and g P to dS K, P K.
            const float p = Ps[at], dsp = p * s[i][c], gc = Dss[at];
            lane_p[i] += p;
            lane_ds[i] += dsp;
            Dss[at] = gc * dsp;
            Ps[at] = gc * p;
          } else {
            Dss[at] = Ps[at] * s[i][c];
          }
        }
    }
    __syncthreads();   // dS is in

    // dS K and P K, and the rows' sums, over the pair's keys in order.
#pragma unroll
    for (int tt = 0; tt < kStages; ++tt) {
      if (tt == tiles) break;
#pragma unroll
      for (int j = kBK * tt; j < kBK * (tt + 1); j += 4) {
        float4 df[kAcc], pf[kAcc];
#pragma unroll
        for (int r = 0; r < kAcc; ++r) {
          df[r] = ld4(Dss + (kAcc * warp + r) * kPK + j);
          pf[r] = ld4(Ps + (kAcc * warp + r) * kPK + j);
          if constexpr (!kCap) {
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              sum_ds[r] += comp(df[r], u);
              sum_p[r] += comp(pf[r], u);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
#pragma unroll
          for (int h = 0; h < C::kNC; ++h) {
            const float4 kf =
                ld4(Ks + (j + u) * C::kLD + 4 * (lane + 32 * h));
#pragma unroll
            for (int r = 0; r < kAcc; ++r) {
              axpy4(comp(df[r], u), kf, acc[r][h]);
              axpy4(comp(pf[r], u), kf, pk[r][h]);
            }
          }
        }
      }
    }
    if (more) {
      __syncthreads();   // every warp is past this pair's K, P and dS
      if (!group_b) {
        stage<DP, kPair, kGroup>(Ks, y_src, (t0 + 2) * kBK, Skv, D, tg);
        commit();
      }
    }
  }
  fa32::wait<0>();   // nothing left in flight, also when no kv tile ran
  if constexpr (kCap) {
    // Each row's sums over its 8 lanes, then to the warps of its dQ rows.
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int sh = 1; sh < 8; sh <<= 1) {
        lane_p[i] += __shfl_xor_sync(0xffffffffu, lane_p[i], sh);
        lane_ds[i] += __shfl_xor_sync(0xffffffffu, lane_ds[i], sh);
      }
    __syncthreads();   // every warp is past P and dS
    if (group_b && j8 == 0)
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        Ps[sr + i] = lane_p[i];
        Ps[kBQ + sr + i] = lane_ds[i];
      }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kAcc; ++r) {
      sum_p[r] = Ps[kAcc * warp + r];
      sum_ds[r] = Ps[kBQ + kAcc * warp + r];
    }
  }

  // dQ = scale (dS K - (sum dS / sum P) P K): the row's dS less its
  // P-weighted mean, which is 0 in exact arithmetic (sum_j P_ij V_j = O_i)
  // and otherwise the rounding of the saved O and lse against this P.
#pragma unroll
  for (int r = 0; r < kAcc; ++r) {
    const int qpos = q0 + kAcc * warp + r;
    if (qpos >= S) continue;
    const float mean = sum_p[r] > 0.0f ? sum_ds[r] / sum_p[r] : 0.0f;
#pragma unroll
    for (int h = 0; h < C::kNC; ++h) {
      const int col = 4 * (lane + 32 * h);
      float out[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        out[e] = fmaf(-mean, pk[r][h][e], acc[r][h][e]) * scale;
      if (col < D)
        *reinterpret_cast<float4*>(dq + q_off + static_cast<size_t>(qpos) * D +
                                   col) =
            make_float4(out[0], out[1], out[2], out[3]);
    }
  }
}

// ---------------------------------------------------------------------------
// 3. dkdv.  The items (query head, q tile) go in pairs (64 q rows; the last
// pair may hold one).  Group A computes S^T, P^T and dK += dS^T Q, group
// B dP^T, dS^T = P^T (dP^T - Delta) and dV += P^T dO, so each reads one
// streamed operand (Q and lse; dO and Delta), which it copies itself.
// S^T and dP^T: warp w % 4 of a group owns kv rows 8 (w % 4) .. + 7, lane
// 16 g + j holding kv rows 8 (w % 4) + 4 g + i (i < 4) against the pair's
// q rows j + 16 c (c < 4; c < 2 the first item), 0.5 shared words a
// multiply-add.  dK and dV: warp w % 4 of a group owns kv rows 8 (w % 4)
// .. + 7, the lane float4 columns 4 (lane + 32 h).
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ float4 ld_remote4(uint32_t local, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(local), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(remote)
               : "memory");
  return v;
}

template <int DP, bool kCap>
__global__ void __launch_bounds__(kThreads, 1)
fa32_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int BH_kv, int rep, int groups,
                     int S, int Skv, int D, float scale, float cap,
                     int causal, int window) {
  using C = Cfg<DP>;
  constexpr int kPairQ = kStages * kBQT;   // q rows of a pair of items
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);
  float* Vs = Ks + kBKV * C::kLD;
  float* Qp = Vs + kBKV * C::kLD;       // (kPairQ, kLD)
  float* Op = Qp + kPairQ * C::kLD;     // dO (kPairQ, kLD)
  float* Lp = Op + kPairQ * C::kLD;     // lse (kPairQ)
  float* Ep = Lp + kPairQ;              // Delta (kPairQ)
  float* Ps = Ep + kPairQ;              // P^T (kBKV, kPQ)
  float* Dss = Ps + kBKV * kPQ;         // dS^T (kBKV, kPQ)

  // Heaviest kv block first; a kv block's groups side by side (a cluster).
  const int grp = static_cast<int>(blockIdx.x % groups);
  const int hkv = static_cast<int>((blockIdx.x / groups) % BH_kv);
  const int k0 = static_cast<int>(blockIdx.x / (groups * BH_kv)) * kBKV;
  const size_t kv_off = static_cast<size_t>(hkv) * Skv * D;
  const int hq_lo = grp * rep / groups, hq_hi = (grp + 1) * rep / groups;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gw = warp % 4;                  // warp within its group
  const bool group_b = warp >= 4;
  const int tg = threadIdx.x % kGroup;      // thread within its group
  const int g = lane / 16, j16 = lane % 16;
  const int sr = 8 * gw + 4 * g;            // S^T (dP^T) rows sr + i

  // The q tiles the kv block sees: one contiguous range, for each head;
  // the items (head, q tile) go in pairs.
  const int nq = (S + kBQT - 1) / kBQT;
  int lo = 0, hi = nq - 1;
  while (lo < nq && !tile_runs(lo * kBQT, k0, kBQT, kBKV, causal, window))
    ++lo;
  while (hi >= lo && !tile_runs(hi * kBQT, k0, kBQT, kBKV, causal, window))
    --hi;
  const int n_tiles = hi - lo + 1;
  const int n_items = n_tiles > 0 ? (hq_hi - hq_lo) * n_tiles : 0;
  const int n_pairs = (n_items + 1) / 2;
  const auto item_q0 = [&](int item) {
    return (lo + item % n_tiles) * kBQT;
  };

  // The group's operand: Q and lse (group A) or dO and Delta (group B),
  // item `item` into half `half` of the pair's rows.
  float* Y = group_b ? Op : Qp;
  float* R = group_b ? Ep : Lp;
  const auto stage_half = [&](int item, int half) {
    const int bh = hkv * rep + hq_lo + item / n_tiles;
    const int q0 = item_q0(item);
    stage<DP, kBQT, kGroup>(Y + half * kBQT * C::kLD,
                            (group_b ? dout : q) + static_cast<size_t>(bh) *
                                                       S * D,
                            q0, S, D, tg);
    if (tg < kBQT)
      stage_one(R + half * kBQT,
                (group_b ? delta : lse) + static_cast<size_t>(bh) * S, q0,
                tg, S);
  };

  stage<DP, kBKV, kThreads>(Ks, k + kv_off, k0, Skv, D, threadIdx.x);
  stage<DP, kBKV, kThreads>(Vs, v + kv_off, k0, Skv, D, threadIdx.x);
  for (int half = 0; half < kStages && half < n_items; ++half)
    stage_half(half, half);
  commit();

  const float* X = group_b ? Vs : Ks;       // rows of the group's S-like
  const float* W = group_b ? Ps : Dss;      // P^T (group B) or dS^T (A)
  float acc[8][C::kNC][4];                  // dK (group A) or dV (group B)
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int h = 0; h < C::kNC; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][h][e] = 0.0f;

  for (int pr = 0; pr < n_pairs; ++pr) {
    const int items = 2 * pr + 1 < n_items ? 2 : 1;
    const int next = 2 * pr + kStages;      // the next pair's first item
    fa32::wait<0>();
    __syncthreads();   // the pair is in; every warp is past the last one

    // S^T = K Q^T (group A) or dP^T = V dO^T (group B): kv rows sr + i
    // against the pair's q rows j16 + 16 c (half c / 2), one fmaf chain
    // over D from column 0 an entry (Delta's order).
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.0f;
#pragma unroll 2
    for (int d = 0; d < DP; d += 4) {
      float4 xa[4], yb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) xa[i] = ld4(X + (sr + i) * C::kLD + d);
#pragma unroll
      for (int c = 0; c < 4; ++c) yb[c] = ld4(Y + (j16 + 16 * c) * C::kLD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[i][c] = dot4(xa[i], yb[c], s[i][c]);
    }
    if (!group_b) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = j16 + 16 * c;
        const int half = c / 2;
        const int qpos = item_q0(2 * pr + half) + j - half * kBQT;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float x = s[i][c] * scale;
          if constexpr (kCap) {
            const float tc = tanhf(x / cap);
            x = tc * cap;
            Dss[(sr + i) * kPQ + j] = 1.0f - tc * tc;   // g, for group B
          }
          Ps[(sr + i) * kPQ + j] =
              half < items &&
                      visible(qpos, k0 + sr + i, S, Skv, causal, window)
                  ? expf(x - Lp[j])
                  : 0.0f;
        }
      }
    }
    __syncthreads();   // P^T is in
    if (group_b) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = j16 + 16 * c;
          const int at = (sr + i) * kPQ + j;
          if constexpr (kCap)
            Dss[at] = Ps[at] * (s[i][c] - Ep[j]) * Dss[at];
          else
            Dss[at] = Ps[at] * (s[i][c] - Ep[j]);
        }
    }
    __syncthreads();   // dS^T is in

    // dK += dS^T Q (group A) or dV += P^T dO (group B) over the pair's q
    // rows in order; once the group is past a half, it copies the next
    // pair's item of that half.
#pragma unroll
    for (int half = 0; half < kStages; ++half) {
      if (half == items) break;
#pragma unroll 2
      for (int j = kBQT * half; j < kBQT * (half + 1); j += 4) {
        float4 wf[8];
#pragma unroll
        for (int a = 0; a < 8; ++a) wf[a] = ld4(W + (8 * gw + a) * kPQ + j);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
#pragma unroll
          for (int h = 0; h < C::kNC; ++h) {
            const float4 zf = ld4(Y + (j + u) * C::kLD + 4 * (lane + 32 * h));
#pragma unroll
            for (int a = 0; a < 8; ++a) axpy4(comp(wf[a], u), zf, acc[a][h]);
          }
        }
      }
      if (next + half < n_items) {
        group_sync(group_b);   // the group is past this half
        stage_half(next + half, half);
        commit();
      }
    }
  }
  fa32::wait<0>();   // nothing left in flight, also when no q tile ran

  float* out = (group_b ? dv : dk) + kv_off;
  const float sc = group_b ? 1.0f : scale;
  if (groups > 1) {
    // The cluster's two CTAs: rank 0 finishes dV (group B), rank 1 dK
    // (group A).  The other group of each leaves its partial in the (now
    // free) pair buffers; the sum takes group 0's part first in either CTA.
    const uint32_t rank = cluster_rank();
    const bool mine = rank == 0 ? group_b : !group_b;
    float4* xb = reinterpret_cast<float4*>(Qp);
    __syncthreads();   // every warp is past the pair buffers
    if (!mine)
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int h = 0; h < C::kNC; ++h)
          xb[(a * C::kNC + h) * kGroup + tg] =
              make_float4(acc[a][h][0], acc[a][h][1], acc[a][h][2],
                          acc[a][h][3]);
    cluster_sync();
    if (mine)
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int h = 0; h < C::kNC; ++h) {
          const float4 r = ld_remote4(
              smem_u32(xb + (a * C::kNC + h) * kGroup + tg), rank ^ 1u);
          const float part[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[a][h][e] = rank == 0 ? acc[a][h][e] + part[e]
                                     : part[e] + acc[a][h][e];
        }
    cluster_sync();   // the peer has read this CTA's partial
    if (!mine) return;
  }
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int kpos = k0 + 8 * gw + a;
    if (kpos >= Skv) continue;
#pragma unroll
    for (int h = 0; h < C::kNC; ++h) {
      const int col = 4 * (lane + 32 * h);
      if (col < D)
        *reinterpret_cast<float4*>(out + static_cast<size_t>(kpos) * D + col) =
            make_float4(acc[a][h][0] * sc, acc[a][h][1] * sc,
                        acc[a][h][2] * sc, acc[a][h][3] * sc);
    }
  }
}

// Query-head groups of the dkdv launch: two (a cluster) while the kv
// blocks of the kv heads alone would leave SMs idle for two waves.
int dkdv_groups(int rep, int n_kv_blocks) {
  return rep >= 2 && n_kv_blocks < 2 * 132 ? 2 : 1;
}

// The launches of one call: all three (part < 0) or only prep (0), dq (1)
// or dkdv (2), which reads what the earlier ones wrote.
template <int DP, bool kCap>
int launch(const float* q, const float* k, const float* v, const float* o,
           const float* dout, const float* lse, float* delta, float* dq,
           float* dk, float* dv, int BH, int BH_kv, int S, int Skv, int D,
           int Dh, int causal, int window, float softcap, int part,
           cudaStream_t stream) {
  const int rep = BH / BH_kv;
  const float scale =
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(Dh)));
  cudaError_t err = cudaFuncSetAttribute(
      fa32_bwd_dq_kernel<DP, kCap>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Cfg<DP>::kDqSmem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fa32_bwd_dkdv_kernel<DP, kCap>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(Cfg<DP>::kDkdvSmem));
  if (err != cudaSuccess) return static_cast<int>(err);

  if (part < 0 || part == 0) {
    const long long rows = static_cast<long long>(BH) * S;
    const unsigned prep_grid =
        static_cast<unsigned>((rows + kPrepThreads - 1) / kPrepThreads);
    fa32_bwd_prep_kernel<<<prep_grid, kPrepThreads, 0, stream>>>(
        o, dout, delta, rows, D);
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
  }
  if (part < 0 || part == 1) {
    const unsigned dq_grid = static_cast<unsigned>((S + kBQ - 1) / kBQ) * BH;
    fa32_bwd_dq_kernel<DP, kCap>
        <<<dq_grid, kThreads, Cfg<DP>::kDqSmem, stream>>>(
            q, k, v, o, dout, lse, dq, BH, rep, S, Skv, D, scale, softcap,
            causal, window);
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
  }
  if (part >= 0 && part != 2) return 0;

  const int nkb = (Skv + kBKV - 1) / kBKV;
  const int groups = dkdv_groups(rep, nkb * BH_kv);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(nkb * BH_kv * groups));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Cfg<DP>::kDkdvSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(groups);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fa32_bwd_dkdv_kernel<DP, kCap>, q, k, v,
                           dout, lse, static_cast<const float*>(delta), dk,
                           dv, BH_kv, rep, groups, S, Skv, D, scale, softcap,
                           causal, window);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The launches of one call of one cap flag, by head dimension.
template <bool kCap>
int run_any(const void* q, const void* k, const void* v, const void* o,
            const void* dout, const void* lse, void* ws, void* dq, void* dk,
            void* dv, int BH, int BH_kv, int S, int Skv, int D, int Dh,
            int causal, int window, float softcap, int part,
            cudaStream_t st) {
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto w = [](void* p) { return static_cast<float*>(p); };
  if (D <= 64)
    return launch<64, kCap>(f(q), f(k), f(v), f(o), f(dout), f(lse), w(ws),
                            w(dq), w(dk), w(dv), BH, BH_kv, S, Skv, D, Dh,
                            causal, window, softcap, part, st);
  if (D <= 128)
    return launch<128, kCap>(f(q), f(k), f(v), f(o), f(dout), f(lse), w(ws),
                             w(dq), w(dk), w(dv), BH, BH_kv, S, Skv, D, Dh,
                             causal, window, softcap, part, st);
  return launch<256, kCap>(f(q), f(k), f(v), f(o), f(dout), f(lse), w(ws),
                           w(dq), w(dk), w(dv), BH, BH_kv, S, Skv, D, Dh,
                           causal, window, softcap, part, st);
}

}  // namespace

// The capped launches: flash_attention_bwd_f32_capped.cu compiles this
// file with REPRO_FA_CAPPED defined and holds them, so that nvcc builds
// the capped and the uncapped kernels as two sources, in parallel.
int repro_fa_bwd_f32_capped(const void* q, const void* k, const void* v,
                            const void* o, const void* dout, const void* lse,
                            void* ws, void* dq, void* dk, void* dv, int BH,
                            int BH_kv, int S, int Skv, int D, int Dh,
                            int causal, int window, float softcap, int part,
                            cudaStream_t st);

#ifdef REPRO_FA_CAPPED

int repro_fa_bwd_f32_capped(const void* q, const void* k, const void* v,
                            const void* o, const void* dout, const void* lse,
                            void* ws, void* dq, void* dk, void* dv, int BH,
                            int BH_kv, int S, int Skv, int D, int Dh,
                            int causal, int window, float softcap, int part,
                            cudaStream_t st) {
  return run_any<true>(q, k, v, o, dout, lse, ws, dq, dk, dv, BH, BH_kv, S,
                       Skv, D, Dh, causal, window, softcap, part, st);
}

#else

namespace {

int run(const void* q, const void* k, const void* v, const void* o,
        const void* dout, const void* lse, void* ws, void* dq, void* dk,
        void* dv, int BH, int BH_kv, int S, int Skv, int D, int Dh,
        int causal, int window, float softcap, int part, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (BH <= 0 || BH_kv <= 0 || BH % BH_kv != 0 || S <= 0 || Skv <= 0 ||
      (Skv != S && (causal || window > 0)) || D <= 0 || D % 8 != 0 ||
      D > 256 || Dh <= 0 || Dh > D || part > 2 ||
      !(softcap >= 0.0f && softcap <= 3.4e38f))
    return static_cast<int>(cudaErrorInvalidValue);
  if (softcap > 0.0f)
    return repro_fa_bwd_f32_capped(q, k, v, o, dout, lse, ws, dq, dk, dv,
                                   BH, BH_kv, S, Skv, D, Dh, causal, window,
                                   softcap, part, st);
  return run_any<false>(q, k, v, o, dout, lse, ws, dq, dk, dv, BH, BH_kv, S,
                        Skv, D, Dh, causal, window, softcap, part, st);
}

}  // namespace

// q, o, dout, dq: (BH, S, D) f32; k, v, dk, dv: (BH_kv, S_kv, D) f32 with
// BH_kv dividing BH and S_kv = S unless causal is 0 and window <= 0; lse
// (the forward's): (BH, S) f32; the workspace ws: (BH, S) f32 (Delta).
// Contiguous, 16-byte aligned, on the stream's device; D a multiple of 8
// and at most 256; Dh (at most D) sets the softmax scale 1 / sqrt(Dh), as
// in the forward; softcap (finite, >= 0; 0 is none) the forward's cap.
// Three launches on the
// stream; returns the first nonzero cudaError_t (0 on success),
// cudaErrorInvalidValue for a shape the kernels do not take.
extern "C" int repro_flash_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* ws, void* dq, void* dk,
    void* dv, int BH, int BH_kv, int S, int S_kv, int D, int Dh, int causal,
    int window, float softcap, void* stream) {
  return run(q, k, v, o, dout, lse, ws, dq, dk, dv, BH, BH_kv, S, S_kv, D,
             Dh, causal, window, softcap, -1, stream);
}

// One launch of the above alone, so that each can be timed between CUDA
// events: prep (part 0), dq (1) or dkdv (2), on the same arguments; dkdv
// reads the Delta that an earlier prep left in ws.
extern "C" int repro_flash_attention_bwd_f32_part(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* ws, void* dq, void* dk,
    void* dv, int BH, int BH_kv, int S, int S_kv, int D, int Dh, int causal,
    int window, float softcap, int part, void* stream) {
  if (part < 0) return static_cast<int>(cudaErrorInvalidValue);
  return run(q, k, v, o, dout, lse, ws, dq, dk, dv, BH, BH_kv, S, S_kv, D,
             Dh, causal, window, softcap, part, stream);
}

#endif  // REPRO_FA_CAPPED
