// Causal / sliding-window flash attention on Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py `flash_attention`
// (`_flash_kernel`), the Pallas TPU kernel of every local-attention layer's
// prefill.  On the TPU the kv-block axis is the sequential grid dimension
// and the online-softmax state (m, l, acc) lives in VMEM scratch across it.
//
// q, k, v, o are (BH, S, D) with heads folded into the batch and the kv
// heads already expanded; window <= 0 means unbounded; a key is visible to
// a query when key < S, (causal) key <= query, and (window) key > query -
// window.  kv blocks that lie wholly after the q block (causal) or wholly
// before its window are skipped, as the TPU kernel skips them.
//
// Bound on this card: operations for bf16 at long S (4 flops per visible
// score entry per head dimension against one read of q, k, v and one
// write of o; at the RecurrentGemma-9B prefill shape (64, 4096, 256),
// window 2048, ~412 GFLOP against 537 MB), bytes for short S.
//
// Design: one CTA per (bh, 64-row q block) for bf16, (bh, 32-row q block)
// for f32.  The q tile stays in shared memory; k and v tiles of the same
// height are streamed through shared memory one at a time (no software
// pipelining or TMA yet).  The head dimension is zero-padded in shared
// memory to DP in {64, 128, 256}, a template parameter, so every loop over
// it unrolls; padded rows past S are zero and masked.
//
// * bf16: tensor cores through mma.sync m16n8k16 (bf16 in, f32 out).  Each
//   of the 4 warps owns 16 q rows: S = Q K^T for its rows lands in
//   registers, the online softmax runs on them with the running max m and
//   sum l per row in registers (reduced over the 4 lanes that share a row),
//   the probabilities are rounded to bf16 and fed straight back as the A
//   operand of P V, whose f32 accumulator (16 x DP per warp) stays in
//   registers.  At DP = 256 the three tiles take 99 KB of shared memory,
//   above the 48 KB default, so the launcher raises the limit with
//   cudaFuncSetAttribute.
// * f32: exact f32 FMA, no tensor cores (no TF32).  32 x 32 tiles; each
//   warp owns the q rows r = warp (mod 4) for scores, softmax and output,
//   so only the k/v tiles are shared between warps.
//
// Fully masked rows of a block contribute exactly 0 (the p = 0 guard), the
// final division is floored at 1e-30, and every sum runs in a fixed order
// with no atomics, so two runs give bitwise equal outputs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;

__device__ __forceinline__ bool visible(int qpos, int kpos, int S, int causal,
                                        int window) {
  bool ok = kpos < S;
  if (causal) ok = ok && kpos <= qpos;
  if (window > 0) ok = ok && kpos > qpos - window;
  return ok;
}

// The TPU kernel's skip test for a (q block, kv block) pair.
__device__ __forceinline__ bool block_runs(int q_start, int k_start, int bq,
                                           int bk, int causal, int window) {
  bool run = true;
  if (causal) run = k_start <= q_start + bq - 1;
  if (window > 0) run = run && (k_start + bk - 1 > q_start - window);
  return run;
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores.
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;   // q rows per CTA (16 per warp)
constexpr int kBK = 64;   // kv rows per streamed tile
constexpr int kTC = 128;  // threads

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two bf16 in one register, the first in the low half.
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo,
                                          __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// rows [start, start + 64) of a (S, D) matrix into a (64, DP + 8) tile,
// 16 bytes a thread per step; zero past S and past D.
template <int DP>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* tile,
                                               const __nv_bfloat16* src,
                                               int start, int S, int D) {
  constexpr int kStride = DP + 8;
  constexpr int kChunks = DP / 8;  // 16-byte chunks per row
  for (int e = threadIdx.x; e < 64 * kChunks; e += kTC) {
    const int r = e / kChunks;
    const int c = (e % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (start + r < S && c < D)
      val = *reinterpret_cast<const uint4*>(
          src + static_cast<size_t>(start + r) * D + c);
    *reinterpret_cast<uint4*>(tile + r * kStride + c) = val;
  }
}

template <int DP>
__global__ void __launch_bounds__(kTC)
flash_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ o, int S, int D, float scale,
                  int causal, int window) {
  constexpr int kStride = DP + 8;  // bf16 per shared row: no bank conflicts
  constexpr int kDn = DP / 8;      // n-tiles of the output
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + kBQ * kStride;
  __nv_bfloat16* Vs = Ks + kBK * kStride;

  // Heaviest q blocks (last under causal) first.
  const int q_start = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const size_t off = static_cast<size_t>(blockIdx.y) * S * D;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;   // row within the warp's 8-row half
  const int tig = lane & 3;  // lane within the row's quad
  const int qpos0 = q_start + warp * 16 + g;
  const int qpos1 = qpos0 + 8;

  load_tile_bf16<DP>(Qs, q + off, q_start, S, D);

  float acc[kDn][4];
#pragma unroll
  for (int n = 0; n < kDn; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.0f, 0.0f};

  const int nk = (S + kBK - 1) / kBK;
  for (int kb = 0; kb < nk; ++kb) {
    const int k_start = kb * kBK;
    if (!block_runs(q_start, k_start, kBQ, kBK, causal, window)) continue;
    __syncthreads();  // every warp is done with the previous k/v tiles
    load_tile_bf16<DP>(Ks, k + off, k_start, S, D);
    load_tile_bf16<DP>(Vs, v + off, k_start, S, D);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys.
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < DP; kk += 16) {
      const __nv_bfloat16* qa = Qs + (warp * 16 + g) * kStride + kk + 2 * tig;
      const uint32_t a0 = ld32(qa), a1 = ld32(qa + 8 * kStride);
      const uint32_t a2 = ld32(qa + 8), a3 = ld32(qa + 8 * kStride + 8);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const __nv_bfloat16* kp = Ks + (n * 8 + g) * kStride + kk + 2 * tig;
        mma_bf16(s[n], a0, a1, a2, a3, ld32(kp), ld32(kp + 8));
      }
    }

    // Online softmax over the tile, rows qpos0 (e < 2) and qpos1 (e >= 2).
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k_start + n * 8 + 2 * tig + (e & 1);
        const int qpos = e < 2 ? qpos0 : qpos1;
        const float x = visible(qpos, kpos, S, causal, window)
                            ? s[n][e] * scale
                            : kNegInf;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m_run[h], mx[h]);
      alpha[h] = expf(m_run[h] - m_new);
      m_run[h] = m_new;
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // A row with no visible key in this tile adds exactly 0.
        const float p = s[n][e] > 0.5f * kNegInf
                            ? expf(s[n][e] - m_run[e >> 1])
                            : 0.0f;
        s[n][e] = p;
        sum[e >> 1] += p;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      l_run[h] = l_run[h] * alpha[h] + sum[h];
    }
#pragma unroll
    for (int n = 0; n < kDn; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // acc += P V: the score fragments of n-tiles 2j, 2j+1 are the A
    // fragment of the 16-key step j.
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t a0 = pack2(s[2 * j][0], s[2 * j][1]);
      const uint32_t a1 = pack2(s[2 * j][2], s[2 * j][3]);
      const uint32_t a2 = pack2(s[2 * j + 1][0], s[2 * j + 1][1]);
      const uint32_t a3 = pack2(s[2 * j + 1][2], s[2 * j + 1][3]);
      const __nv_bfloat16* vp = Vs + (j * 16 + 2 * tig) * kStride + g;
#pragma unroll
      for (int n = 0; n < kDn; ++n) {
        const __nv_bfloat16* vc = vp + n * 8;
        const uint32_t b0 = pack2(vc[0], vc[kStride]);
        const uint32_t b1 = pack2(vc[8 * kStride], vc[9 * kStride]);
        mma_bf16(acc[n], a0, a1, a2, a3, b0, b1);
      }
    }
  }

  const float d0 = fmaxf(l_run[0], 1e-30f);
  const float d1 = fmaxf(l_run[1], 1e-30f);
#pragma unroll
  for (int n = 0; n < kDn; ++n) {
    const int col = n * 8 + 2 * tig;
    if (col >= D) continue;
    if (qpos0 < S)
      *reinterpret_cast<uint32_t*>(o + off + static_cast<size_t>(qpos0) * D +
                                   col) = pack2(acc[n][0] / d0,
                                                acc[n][1] / d0);
    if (qpos1 < S)
      *reinterpret_cast<uint32_t*>(o + off + static_cast<size_t>(qpos1) * D +
                                   col) = pack2(acc[n][2] / d1,
                                                acc[n][3] / d1);
  }
}

// ---------------------------------------------------------------------------
// f32 with exact FMA arithmetic.
// ---------------------------------------------------------------------------

constexpr int kBQ32 = 32;
constexpr int kBK32 = 32;
constexpr int kT32 = 128;
constexpr int kRows32 = kBQ32 / 4;  // q rows per warp

template <int DP>
constexpr size_t f32_smem_bytes() {
  // Q (32, DP), K (32, DP + 1), V (32, DP), P (32, 33)
  return sizeof(float) *
         (kBQ32 * DP + kBK32 * (DP + 1) + kBK32 * DP + kBQ32 * (kBK32 + 1));
}

template <int DP>
__global__ void __launch_bounds__(kT32)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int S,
                 int D, float scale, int causal, int window) {
  constexpr int kCols = DP / 32;  // output columns per lane
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);  // (32, DP)
  float* Ks = Qs + kBQ32 * DP;                 // (32, DP + 1)
  float* Vs = Ks + kBK32 * (DP + 1);           // (32, DP)
  float* Ps = Vs + kBK32 * DP;                 // (32, 33)

  const int q_start = (gridDim.x - 1 - blockIdx.x) * kBQ32;
  const size_t off = static_cast<size_t>(blockIdx.y) * S * D;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  for (int e = threadIdx.x; e < kBQ32 * DP; e += kT32) {
    const int r = e / DP, c = e % DP;
    Qs[e] = (q_start + r < S && c < D)
                ? q[off + static_cast<size_t>(q_start + r) * D + c]
                : 0.0f;
  }

  float acc[kRows32][kCols];
  float m_run[kRows32], l_run[kRows32];
#pragma unroll
  for (int r = 0; r < kRows32; ++r) {
    m_run[r] = kNegInf;
    l_run[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.0f;
  }

  const int nk = (S + kBK32 - 1) / kBK32;
  for (int kb = 0; kb < nk; ++kb) {
    const int k_start = kb * kBK32;
    if (!block_runs(q_start, k_start, kBQ32, kBK32, causal, window))
      continue;
    __syncthreads();
    for (int e = threadIdx.x; e < kBK32 * DP; e += kT32) {
      const int r = e / DP, c = e % DP;
      const bool in = k_start + r < S && c < D;
      const size_t src = off + static_cast<size_t>(k_start + r) * D + c;
      Ks[r * (DP + 1) + c] = in ? k[src] : 0.0f;
      Vs[e] = in ? v[src] : 0.0f;
    }
    __syncthreads();

    // Scores of rows warp + 4 r against key `lane`, then the online softmax
    // of those rows by this warp alone.
    const int kpos = k_start + lane;
    float alpha[kRows32];
#pragma unroll
    for (int r = 0; r < kRows32; ++r) {
      const int i = warp + 4 * r;
      const float* qi = Qs + i * DP;
      const float* kj = Ks + lane * (DP + 1);
      float dot = 0.0f;
#pragma unroll 16
      for (int d = 0; d < DP; ++d) dot = fmaf(qi[d], kj[d], dot);
      const float x = visible(q_start + i, kpos, S, causal, window)
                          ? dot * scale
                          : kNegInf;
      float mx = x;
#pragma unroll
      for (int sh = 16; sh > 0; sh >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, sh));
      const float m_new = fmaxf(m_run[r], mx);
      alpha[r] = expf(m_run[r] - m_new);
      m_run[r] = m_new;
      const float p = x > 0.5f * kNegInf ? expf(x - m_new) : 0.0f;
      float sum = p;
#pragma unroll
      for (int sh = 16; sh > 0; sh >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, sh);
      l_run[r] = l_run[r] * alpha[r] + sum;
      Ps[i * (kBK32 + 1) + lane] = p;
    }
    __syncwarp();

#pragma unroll
    for (int r = 0; r < kRows32; ++r) {
      const float* pi = Ps + (warp + 4 * r) * (kBK32 + 1);
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float* vc = Vs + lane + 32 * c;
        float pv = 0.0f;
#pragma unroll 8
        for (int j = 0; j < kBK32; ++j) pv = fmaf(pi[j], vc[j * DP], pv);
        acc[r][c] = acc[r][c] * alpha[r] + pv;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows32; ++r) {
    const int qpos = q_start + warp + 4 * r;
    if (qpos >= S) continue;
    const float den = fmaxf(l_run[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = lane + 32 * c;
      if (col < D) o[off + static_cast<size_t>(qpos) * D + col] =
          acc[r][c] / den;
    }
  }
}

// ---------------------------------------------------------------------------
// Launchers.
// ---------------------------------------------------------------------------

float softmax_scale(int D) {
  return static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
}

template <int DP>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int BH,
                int S, int D, int causal, int window, cudaStream_t stream) {
  const size_t smem = 3ull * 64 * (DP + 8) * sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bf16_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, BH);
  flash_bf16_kernel<DP><<<grid, kTC, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), S,
      D, softmax_scale(D), causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch_f32(const void* q, const void* k, const void* v, void* o, int BH,
               int S, int D, int causal, int window, cudaStream_t stream) {
  const size_t smem = f32_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ32 - 1) / kBQ32, BH);
  flash_f32_kernel<DP><<<grid, kT32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, D,
      softmax_scale(D), causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o: (BH, S, D), contiguous, 16-byte aligned, one dtype, on the
// stream's device; D a multiple of 8 and at most 256.  Returns the
// cudaError_t of the launch (0 on success); cudaErrorInvalidValue for a D
// the kernels do not take.
extern "C" int repro_flash_attention_bf16(const void* q, const void* k,
                                          const void* v, void* o, int BH,
                                          int S, int D, int causal,
                                          int window, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 0 || D % 8 != 0 || D > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  if (D <= 64) return launch_bf16<64>(q, k, v, o, BH, S, D, causal, window, st);
  if (D <= 128)
    return launch_bf16<128>(q, k, v, o, BH, S, D, causal, window, st);
  return launch_bf16<256>(q, k, v, o, BH, S, D, causal, window, st);
}

extern "C" int repro_flash_attention_f32(const void* q, const void* k,
                                         const void* v, void* o, int BH,
                                         int S, int D, int causal, int window,
                                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 0 || D % 8 != 0 || D > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  if (D <= 64) return launch_f32<64>(q, k, v, o, BH, S, D, causal, window, st);
  if (D <= 128)
    return launch_f32<128>(q, k, v, o, BH, S, D, causal, window, st);
  return launch_f32<256>(q, k, v, o, BH, S, D, causal, window, st);
}
