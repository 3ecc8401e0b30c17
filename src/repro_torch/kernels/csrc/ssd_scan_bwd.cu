// Backward of the Mamba-2 SSD chunked scan on Hopper (sm_90a), f32.
//
// Training only: the TPU package has no backward kernel (its training
// forward runs the jnp reference, repro/models/ssd.py), so this has no
// Pallas counterpart.  It is the backward of ssd_scan.cu's y (the final
// state gets no gradient) in the same head-folded layout: x, dy, dx
// (BH, S, P); dt, ddt (BH, S); A, dA (BH,); B, C, dB, dC (BG, S, N), head bh
// reading row bh / rep of B and C.
//
// It reads three of the forward's workspaces instead of recomputing them:
// cum (the in-chunk cumulative sum of dt * A, f64), G = C B^T per group and
// chunk (the causal tiles), and the state before each chunk S_prev (the
// `states` workspace after the forward's `pass`).  Saving them costs the
// forward nothing (they exist already) and 67 MB of S_prev a layer at the
// Mamba-2 1.3B training shape; recomputing them would repeat three of the
// forward's five launches.
//
// Per head and chunk, with Lm = exp(cum_l - cum_m) (m <= l, a select:
// exp of l < m overflows), M = G .* Lm .* dt_m and w = dt exp(cum_last -
// cum), six launches on the stream:
//   1. ychunk  per (bh, chunk): Y_c = sum_l exp(cum_l) C_l dy_l^T (N, P).
//   2. rpass   per bh: the state gradients from the last chunk back,
//              R_c = Y_c + exp(cum_last) R_{c+1}; in place of Y_c it
//              leaves dS_c = R_{c+1}, the gradient of the chunk's own state,
//              and ddecay_c = sum(dS_c .* S_prev).
//   3. row     per (bh, chunk, 32 rows l): dG = (dy x^T) .* Lm .* dt_m
//              over the tiles m <= l, dC_h = dG B + exp(cum_l) S_prev dy_l,
//              and the row part of dcum: sum_m dG .* G + C_l . (exp(cum_l)
//              S_prev dy_l).
//   4. col     per (bh, chunk, 32 rows m): v = dS x_m, dx = M^T dy + w B dS,
//              dB_h = dG^T C + w v, ddt (without its cum term) = sum_l
//              dM .* G .* Lm + exp(cum_last - cum_m) (B . v), the column
//              part of dcum, -sum_l dG .* G - w (B . v), and sum_m w (B . v)
//              for cum_last.
//   5. dcum    per (bh, chunk): dcum = row + column parts, cum_last's own
//              terms added (sum_m w (B . v) + ddecay exp(cum_last)); its
//              reverse in-chunk cumsum is d(dt * A): ddt += A d(dt A), and
//              the chunk's part of dA = sum dt d(dt A).
//   6. reduce  dB and dC summed over the rep heads of a group, dA over the
//              chunks: a second launch and not atomics, so two runs are
//              bitwise equal.
// tests/test_torch_ssd.py holds these steps, written out in PyTorch
// (kernels/ref.py ssd_scan_bwd_plain), to autograd through the plain
// forward.
//
// Arithmetic: exact f32 FMA (no tensor cores), against a gate of 1e-4
// relative Frobenius to autograd through the plain version.  The sums that
// build dcum (the row and column sums of G .* dG, sum_m w (B . v)), its
// reverse cumsum and dA run in f64, as autograd through the forward's f64
// cumsum runs them: the row and column sums cancel in the reverse cumsum,
// at Mamba-2's decays to ~1e-3 of their size, which in f32 put ~1e-3 into
// dA.  Single TF32
// misses the forward's gate tenfold (ssd_scan.cu), so the backward, whose
// sums are longer, would need 3xTF32 as the forward does; FMA meets the
// gate with no splitting and is the simple first version.  Bound on this
// card: operations.  The function needs 4 chunk N P + chunk^2 (N + P)
// multiply-adds a (bh, chunk), the causal triangle once (2.1e7 at the
// Mamba-2 1.3B training shape: BH = 256, S = 2048, P = 64, N = 128, chunk
// 256), ~86 GFLOP a call: 0.17 ms at the 495 TFLOP/s TF32 peak, 1.3 ms at
// the 67 TFLOP/s of exact f32 FMA, against ~0.5 GB of traffic (0.15 ms at
// 3.35 TB/s).  This kernel computes dy x^T twice (row and col) and reads
// both operands of every multiply-add from shared memory; making it fast
// is later work.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTR = 32;           // rows of a tile (l or m)
constexpr int kLdT = kTR + 1;     // stride of a kTR x kTR tile
constexpr int kMaxNP = 128 * 64;  // N * P at most
constexpr int kPer = kMaxNP / kThreads;   // state elements a thread

// Block-wide sum of one float a thread, in a fixed order; the result is
// valid in thread 0.  `red` holds kThreads / 32 floats.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int sh = 16; sh > 0; sh >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, sh);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.0f;
  if (threadIdx.x == 0)
    for (int w = 0; w < kThreads / 32; ++w) s += red[w];
  return s;
}

// Rows [row0, row0 + kTR) of a (chunk, cols) block into shared memory with
// stride ld, zero past the chunk.
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int row0, int chunk, int cols,
                                           int ld) {
  for (int e = threadIdx.x; e < kTR * cols; e += kThreads) {
    const int r = e / cols, c = e - r * cols;
    dst[r * ld + c] =
        row0 + r < chunk ? src[size_t(row0 + r) * cols + c] : 0.0f;
  }
}

// ---------------------------------------------------------------------------
// 1. ychunk.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
ssd_bwd_ychunk_kernel(const float* __restrict__ C,
                      const float* __restrict__ dy,
                      const double* __restrict__ cum, float* __restrict__ yc,
                      int S, int P, int N, int rep, int chunk) {
  extern __shared__ float sm_y[];
  float* Cs = sm_y;              // [kTR][N], scaled by exp(cum_l)
  float* dys = Cs + kTR * N;     // [kTR][P]
  const int c = blockIdx.x, bh = blockIdx.y, nc = gridDim.x;
  const size_t row0 = size_t(c) * chunk;
  const float* Cg = C + (size_t(bh / rep) * S + row0) * N;
  const float* dyg = dy + (size_t(bh) * S + row0) * P;
  const double* cm = cum + size_t(bh) * S + row0;
  const int np = N * P;
  float acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = 0.0f;
  for (int l0 = 0; l0 < chunk; l0 += kTR) {
    __syncthreads();
    for (int e = threadIdx.x; e < kTR * N; e += kThreads) {
      const int l = l0 + e / N;
      Cs[e] = l < chunk ? Cg[size_t(l) * N + e % N] *
                              expf(static_cast<float>(cm[l]))
                        : 0.0f;
    }
    stage_rows(dys, dyg, l0, chunk, P, P);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int idx = threadIdx.x + kThreads * i;
      if (idx >= np) break;
      const int n = idx / P, p = idx - n * P;
      float a = acc[i];
#pragma unroll 8
      for (int r = 0; r < kTR; ++r) a = fmaf(Cs[r * N + n], dys[r * P + p], a);
      acc[i] = a;
    }
  }
  float* out = yc + (size_t(bh) * nc + c) * np;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int idx = threadIdx.x + kThreads * i;
    if (idx < np) out[idx] = acc[i];
  }
}

// ---------------------------------------------------------------------------
// 2. rpass.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
ssd_bwd_rpass_kernel(float* __restrict__ ds, const float* __restrict__ sprev,
                     const double* __restrict__ cum,
                     float* __restrict__ ddecay, int S, int np, int chunk,
                     int nc) {
  __shared__ float red[kThreads / 32];
  const int bh = blockIdx.x;
  float r[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) r[i] = 0.0f;
  for (int c = nc - 1; c >= 0; --c) {
    const float decay = expf(static_cast<float>(
        cum[size_t(bh) * S + size_t(c) * chunk + chunk - 1]));
    const size_t base = (size_t(bh) * nc + c) * np;
    float part = 0.0f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int idx = threadIdx.x + kThreads * i;
      if (idx >= np) break;
      const float y = ds[base + idx];
      ds[base + idx] = r[i];
      part = fmaf(r[i], sprev[base + idx], part);
      r[i] = fmaf(decay, r[i], y);
    }
    const float tot = block_sum(part, red);
    if (threadIdx.x == 0) ddecay[size_t(bh) * nc + c] = tot;
  }
}

// ---------------------------------------------------------------------------
// 3. row: per (bh, chunk, rows l).
// ---------------------------------------------------------------------------

size_t row_smem(int P, int N) {
  return sizeof(double) * kTR * 3 +
         sizeof(float) * (size_t(N) * (P + 1) + 2 * kTR * (P + 1) +
                          kTR * (N + 1) + 2 * kTR * kLdT + kTR);
}

__global__ void __launch_bounds__(kThreads)
ssd_bwd_row_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ B, const float* __restrict__ C,
                   const float* __restrict__ dy,
                   const double* __restrict__ cum,
                   const float* __restrict__ G,
                   const float* __restrict__ sprev, float* __restrict__ dCh,
                   double* __restrict__ dcum_row, int S, int P, int N,
                   int rep, int chunk, int ntiles) {
  extern __shared__ double sm_row[];
  double* cumL = sm_row;
  double* cumM = cumL + kTR;
  double* rsum = cumM + kTR;                          // row sums of dcum
  float* sP = reinterpret_cast<float*>(rsum + kTR);   // [N][P + 1]
  float* dyL = sP + N * (P + 1);                      // [kTR][P + 1]
  float* xM = dyL + kTR * (P + 1);                    // [kTR][P + 1]
  float* BM = xM + kTR * (P + 1);                     // [kTR][N + 1]
  float* Gt = BM + kTR * (N + 1);                     // [l][m]
  float* dGs = Gt + kTR * kLdT;                       // [l][m]
  float* dtM = dGs + kTR * kLdT;

  const int lt = blockIdx.x % ntiles, c = blockIdx.x / ntiles;
  const int bh = blockIdx.y, grp = bh / rep, nc = S / chunk;
  const size_t row0 = size_t(c) * chunk;   // the chunk's first row
  const int l0 = lt * kTR;                 // the tile's first row
  const float* xg = x + (size_t(bh) * S + row0) * P;
  const float* dyg = dy + (size_t(bh) * S + row0) * P;
  const float* Bg = B + (size_t(grp) * S + row0) * N;
  const float* Cg = C + (size_t(grp) * S + row0) * N;
  const float* Gg = G + (size_t(grp) * nc + c) * chunk * chunk;
  const double* cm = cum + size_t(bh) * S + row0;
  const float* dtg = dt + size_t(bh) * S + row0;

  for (int e = threadIdx.x; e < N * P; e += kThreads)
    sP[(e / P) * (P + 1) + e % P] =
        sprev[(size_t(bh) * nc + c) * N * P + e];
  stage_rows(dyL, dyg, l0, chunk, P, P + 1);
  for (int r = threadIdx.x; r < kTR; r += kThreads)
    cumL[r] = l0 + r < chunk ? cm[l0 + r] : 0.0;
  __syncthreads();

  // Inter: dC_l = exp(cum_l) S_prev dy_l, layout (lr, n = nq + 8 j).
  const int lr = threadIdx.x / 8, nq = threadIdx.x % 8;
  const bool lvalid = l0 + lr < chunk;
  const float el = lvalid ? expf(static_cast<float>(cumL[lr])) : 0.0f;
  float dc[16];
  float inter = 0.0f;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int n = nq + 8 * j;
    float a = 0.0f;
    if (n < N) {
      for (int p = 0; p < P; ++p)
        a = fmaf(sP[n * (P + 1) + p], dyL[lr * (P + 1) + p], a);
      a *= el;
      if (lvalid) inter = fmaf(a, Cg[size_t(l0 + lr) * N + n], inter);
    }
    dc[j] = a;
  }
#pragma unroll
  for (int sh = 1; sh < 8; sh <<= 1)
    inter += __shfl_xor_sync(0xffffffffu, inter, sh);
  if (nq == 0) rsum[lr] = inter;

  // Intra, over the tiles m <= l: layout (l = 2 ty + i, m = 2 tx + jj) for
  // dM and dG, then (lr, n) for dC.
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  double rz[2] = {0.0, 0.0};
  for (int mt = 0; mt <= lt; ++mt) {
    const int m0 = mt * kTR;
    __syncthreads();
    stage_rows(xM, xg, m0, chunk, P, P + 1);
    stage_rows(BM, Bg, m0, chunk, N, N + 1);
    for (int e = threadIdx.x; e < kTR * kTR; e += kThreads) {
      const int l = e / kTR, m = e % kTR;
      Gt[l * kLdT + m] = l0 + l < chunk && m0 + m < chunk
                             ? Gg[size_t(l0 + l) * chunk + m0 + m]
                             : 0.0f;
    }
    for (int r = threadIdx.x; r < kTR; r += kThreads) {
      const bool in = m0 + r < chunk;
      cumM[r] = in ? cm[m0 + r] : 0.0;
      dtM[r] = in ? dtg[m0 + r] : 0.0f;
    }
    __syncthreads();
    float dm[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
    for (int p = 0; p < P; ++p) {
      const float a0 = dyL[(2 * ty) * (P + 1) + p];
      const float a1 = dyL[(2 * ty + 1) * (P + 1) + p];
      const float b0 = xM[(2 * tx) * (P + 1) + p];
      const float b1 = xM[(2 * tx + 1) * (P + 1) + p];
      dm[0][0] = fmaf(a0, b0, dm[0][0]);
      dm[0][1] = fmaf(a0, b1, dm[0][1]);
      dm[1][0] = fmaf(a1, b0, dm[1][0]);
      dm[1][1] = fmaf(a1, b1, dm[1][1]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int l = 2 * ty + i, m = 2 * tx + jj;
        const bool ok =
            l0 + l < chunk && m0 + m < chunk && m0 + m <= l0 + l;
        const float Lm =
            ok ? expf(static_cast<float>(cumL[l] - cumM[m])) : 0.0f;
        const float dg = dm[i][jj] * Lm * dtM[m];
        rz[i] += static_cast<double>(dg * (ok ? Gt[l * kLdT + m] : 0.0f));
        dGs[l * kLdT + m] = dg;
      }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int n = nq + 8 * j;
      if (n >= N) break;
      float a = dc[j];
      for (int m = 0; m < kTR; ++m)
        a = fmaf(dGs[lr * kLdT + m], BM[m * (N + 1) + n], a);
      dc[j] = a;
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int sh = 1; sh < 16; sh <<= 1)
      rz[i] += __shfl_xor_sync(0xffffffffu, rz[i], sh);
  __syncthreads();
  if (tx == 0) {
    rsum[2 * ty] += rz[0];
    rsum[2 * ty + 1] += rz[1];
  }
  __syncthreads();
  if (lvalid) {
    const size_t row = size_t(bh) * S + row0 + l0 + lr;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int n = nq + 8 * j;
      if (n < N) dCh[row * N + n] = dc[j];
    }
    if (nq == 0) dcum_row[row] = rsum[lr];
  }
}

// ---------------------------------------------------------------------------
// 4. col: per (bh, chunk, rows m).
// ---------------------------------------------------------------------------

size_t col_smem(int P, int N) {
  return sizeof(double) * kTR * 4 +
         sizeof(float) * (size_t(N) * (P + 1) + 2 * kTR * (P + 1) +
                          2 * kTR * (N + 1) + 3 * kTR * kLdT + 2 * kTR);
}

__global__ void __launch_bounds__(kThreads)
ssd_bwd_col_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ B, const float* __restrict__ C,
                   const float* __restrict__ dy,
                   const double* __restrict__ cum,
                   const float* __restrict__ G, const float* __restrict__ ds,
                   float* __restrict__ dx, float* __restrict__ dBh,
                   float* __restrict__ ddt_part,
                   double* __restrict__ dcum_col, double* __restrict__ wdw,
                   int S, int P, int N, int rep, int chunk, int ntiles) {
  extern __shared__ double sm_col[];
  double* cumM = sm_col;
  double* cumL = cumM + kTR;
  double* colz = cumL + kTR;                          // column sums
  double* wd = colz + kTR;                            // w (B . v)
  float* sD = reinterpret_cast<float*>(wd + kTR);     // [N][P + 1]
  float* xM = sD + N * (P + 1);                       // [kTR][P + 1]
  float* dyL = xM + kTR * (P + 1);                    // [kTR][P + 1]
  float* BM = dyL + kTR * (P + 1);                    // [kTR][N + 1]
  float* CL = BM + kTR * (N + 1);                     // [kTR][N + 1]
  float* Gt = CL + kTR * (N + 1);                     // [l][m]
  float* Mt = Gt + kTR * kLdT;                        // [m][l]
  float* dGt = Mt + kTR * kLdT;                       // [m][l]
  float* dtM = dGt + kTR * kLdT;
  float* ddtz = dtM + kTR;

  const int mt = blockIdx.x % ntiles, c = blockIdx.x / ntiles;
  const int bh = blockIdx.y, grp = bh / rep, nc = S / chunk;
  const size_t row0 = size_t(c) * chunk;
  const int m0 = mt * kTR;
  const float* xg = x + (size_t(bh) * S + row0) * P;
  const float* dyg = dy + (size_t(bh) * S + row0) * P;
  const float* Bg = B + (size_t(grp) * S + row0) * N;
  const float* Cg = C + (size_t(grp) * S + row0) * N;
  const float* Gg = G + (size_t(grp) * nc + c) * chunk * chunk;
  const double* cm = cum + size_t(bh) * S + row0;
  const float* dtg = dt + size_t(bh) * S + row0;
  const double cum_last = cm[chunk - 1];

  for (int e = threadIdx.x; e < N * P; e += kThreads)
    sD[(e / P) * (P + 1) + e % P] = ds[(size_t(bh) * nc + c) * N * P + e];
  stage_rows(xM, xg, m0, chunk, P, P + 1);
  stage_rows(BM, Bg, m0, chunk, N, N + 1);
  for (int r = threadIdx.x; r < kTR; r += kThreads) {
    const bool in = m0 + r < chunk;
    cumM[r] = in ? cm[m0 + r] : 0.0;
    dtM[r] = in ? dtg[m0 + r] : 0.0f;
  }
  __syncthreads();

  // States: v = dS x_m, B . v, dB = w v, dx = w B dS; layout (mr, n or p =
  // nq + 8 j).
  const int mr = threadIdx.x / 8, nq = threadIdx.x % 8;
  const bool mvalid = m0 + mr < chunk;
  const float tail =
      mvalid ? expf(static_cast<float>(cum_last - cumM[mr])) : 0.0f;
  const float w = tail * dtM[mr];
  float db[16], dxa[8];
  float bv = 0.0f;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int n = nq + 8 * j;
    float a = 0.0f;
    if (n < N) {
      for (int p = 0; p < P; ++p)
        a = fmaf(sD[n * (P + 1) + p], xM[mr * (P + 1) + p], a);
      bv = fmaf(BM[mr * (N + 1) + n], a, bv);
    }
    db[j] = w * a;
  }
#pragma unroll
  for (int sh = 1; sh < 8; sh <<= 1) bv += __shfl_xor_sync(0xffffffffu, bv, sh);
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const int p = nq + 8 * jj;
    float a = 0.0f;
    if (p < P)
      for (int n = 0; n < N; ++n)
        a = fmaf(BM[mr * (N + 1) + n], sD[n * (P + 1) + p], a);
    dxa[jj] = w * a;
  }

  // Intra, over the tiles l >= m: layout (m = 2 ty + i, l = 2 tx + jj) for
  // dM^T, M^T and dG^T, then (mr, p or n) for dx and dB.
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  double cz[2] = {0.0, 0.0};
  float dz[2] = {0.0f, 0.0f};
  for (int lt = mt; lt < ntiles; ++lt) {
    const int l0 = lt * kTR;
    __syncthreads();
    stage_rows(dyL, dyg, l0, chunk, P, P + 1);
    stage_rows(CL, Cg, l0, chunk, N, N + 1);
    for (int e = threadIdx.x; e < kTR * kTR; e += kThreads) {
      const int l = e / kTR, m = e % kTR;
      Gt[l * kLdT + m] = l0 + l < chunk && m0 + m < chunk
                             ? Gg[size_t(l0 + l) * chunk + m0 + m]
                             : 0.0f;
    }
    for (int r = threadIdx.x; r < kTR; r += kThreads)
      cumL[r] = l0 + r < chunk ? cm[l0 + r] : 0.0;
    __syncthreads();
    float dm[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
    for (int p = 0; p < P; ++p) {
      const float a0 = xM[(2 * ty) * (P + 1) + p];
      const float a1 = xM[(2 * ty + 1) * (P + 1) + p];
      const float b0 = dyL[(2 * tx) * (P + 1) + p];
      const float b1 = dyL[(2 * tx + 1) * (P + 1) + p];
      dm[0][0] = fmaf(a0, b0, dm[0][0]);
      dm[0][1] = fmaf(a0, b1, dm[0][1]);
      dm[1][0] = fmaf(a1, b0, dm[1][0]);
      dm[1][1] = fmaf(a1, b1, dm[1][1]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int m = 2 * ty + i, l = 2 * tx + jj;
        const bool ok =
            l0 + l < chunk && m0 + m < chunk && m0 + m <= l0 + l;
        const float Lm =
            ok ? expf(static_cast<float>(cumL[l] - cumM[m])) : 0.0f;
        const float gv = ok ? Gt[l * kLdT + m] : 0.0f;
        const float dg = dm[i][jj] * Lm * dtM[m];
        cz[i] += static_cast<double>(dg * gv);
        dz[i] = fmaf(dm[i][jj] * gv, Lm, dz[i]);
        Mt[m * kLdT + l] = gv * Lm * dtM[m];
        dGt[m * kLdT + l] = dg;
      }
    __syncthreads();
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int p = nq + 8 * jj;
      if (p >= P) break;
      float a = dxa[jj];
      for (int l = 0; l < kTR; ++l)
        a = fmaf(Mt[mr * kLdT + l], dyL[l * (P + 1) + p], a);
      dxa[jj] = a;
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int n = nq + 8 * j;
      if (n >= N) break;
      float a = db[j];
      for (int l = 0; l < kTR; ++l)
        a = fmaf(dGt[mr * kLdT + l], CL[l * (N + 1) + n], a);
      db[j] = a;
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int sh = 1; sh < 16; sh <<= 1) {
      cz[i] += __shfl_xor_sync(0xffffffffu, cz[i], sh);
      dz[i] += __shfl_xor_sync(0xffffffffu, dz[i], sh);
    }
  __syncthreads();
  if (tx == 0) {
    colz[2 * ty] = cz[0];
    colz[2 * ty + 1] = cz[1];
    ddtz[2 * ty] = dz[0];
    ddtz[2 * ty + 1] = dz[1];
  }
  __syncthreads();
  if (nq == 0) wd[mr] = mvalid ? static_cast<double>(w * bv) : 0.0;
  if (mvalid) {
    const size_t row = size_t(bh) * S + row0 + m0 + mr;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int p = nq + 8 * jj;
      if (p < P) dx[row * P + p] = dxa[jj];
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int n = nq + 8 * j;
      if (n < N) dBh[row * N + n] = db[j];
    }
    if (nq == 0) {
      ddt_part[row] = ddtz[mr] + tail * bv;
      dcum_col[row] = -colz[mr] - static_cast<double>(w * bv);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double s = 0.0;
    for (int r = 0; r < kTR; ++r) s += wd[r];
    wdw[(size_t(bh) * nc + c) * ntiles + mt] = s;
  }
}

// ---------------------------------------------------------------------------
// 5. dcum: per (bh, chunk).
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
ssd_bwd_dcum_kernel(const float* __restrict__ dt,
                    const float* __restrict__ A,
                    const double* __restrict__ cum,
                    const double* __restrict__ dcum_row,
                    const double* __restrict__ dcum_col,
                    const float* __restrict__ ddt_part,
                    const float* __restrict__ ddecay,
                    const double* __restrict__ wdw, float* __restrict__ ddt,
                    double* __restrict__ dA_part, int S, int chunk,
                    int ntiles) {
  extern __shared__ double dc[];   // [chunk]
  const int c = blockIdx.x, bh = blockIdx.y, nc = gridDim.x;
  const size_t base = size_t(bh) * S + size_t(c) * chunk;
  for (int l = threadIdx.x; l < chunk; l += kThreads)
    dc[l] = dcum_row[base + l] + dcum_col[base + l];
  __syncthreads();
  if (threadIdx.x == 0) {
    const size_t bc = size_t(bh) * nc + c;
    double last = 0.0;
    for (int t = 0; t < ntiles; ++t) last += wdw[bc * ntiles + t];
    last += ddecay[bc] * expf(static_cast<float>(cum[base + chunk - 1]));
    dc[chunk - 1] += last;
    double acc = 0.0, da = 0.0;
    for (int l = chunk - 1; l >= 0; --l) {
      acc += dc[l];
      dc[l] = acc;
      da += static_cast<double>(dt[base + l]) * acc;
    }
    dA_part[bc] = da;
  }
  __syncthreads();
  const float a = A[bh];
  for (int l = threadIdx.x; l < chunk; l += kThreads)
    ddt[base + l] = fmaf(a, static_cast<float>(dc[l]), ddt_part[base + l]);
}

// ---------------------------------------------------------------------------
// 6. reduce: dB, dC over the heads of a group; dA over the chunks.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
ssd_bwd_reduce_kernel(const float* __restrict__ dBh,
                      const float* __restrict__ dCh,
                      const double* __restrict__ dA_part,
                      float* __restrict__ dB, float* __restrict__ dC,
                      float* __restrict__ dA, size_t group_elems, int groups,
                      int rep, int BH, int nc) {
  const size_t stride = size_t(gridDim.x) * kThreads;
  const size_t total = group_elems * groups;
  for (size_t i = size_t(blockIdx.x) * kThreads + threadIdx.x; i < total;
       i += stride) {
    const size_t grp = i / group_elems, e = i - grp * group_elems;
    const size_t h0 = grp * rep * group_elems + e;
    float sb = 0.0f, sc = 0.0f;
    for (int r = 0; r < rep; ++r) {
      sb += dBh[h0 + size_t(r) * group_elems];
      sc += dCh[h0 + size_t(r) * group_elems];
    }
    dB[i] = sb;
    dC[i] = sc;
  }
  for (size_t i = size_t(blockIdx.x) * kThreads + threadIdx.x;
       i < size_t(BH); i += stride) {
    double s = 0.0;
    for (int c = 0; c < nc; ++c) s += dA_part[i * nc + c];
    dA[i] = static_cast<float>(s);
  }
}

cudaError_t set_smem(const void* fn, size_t bytes) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

// The workspaces of repro_ssd_scan_bwd_f32, which kernels/ssd_scan.py
// allocates by the same formulas.  `ws` (f32), in order: dS (BH, S / chunk,
// N, P), dB_h and dC_h (BH, S, N), ddt's partial sums (BH, S) and ddecay
// (BH, S / chunk).  `ws64` (f64): the row and column parts of dcum (BH, S)
// each, dA's parts (BH, S / chunk) and sum w (B . v) per (bh, chunk, 32-row
// tile).
//
// x, dy, dx: (BH, S, P); dt, ddt: (BH, S); A, dA: (BH,); B, C, dB, dC:
// (BH / rep, S, N); cum (BH, S) f64, G (BH / rep, S / chunk, chunk, chunk)
// and sprev (BH, S / chunk, N, P): the forward's workspaces after its
// launches.  All f32 unless named, contiguous, on the stream's device; S a
// multiple of chunk, chunk <= 1024, N <= 128, P <= 64, BH <= 65535.  Six
// launches on the stream; returns the first nonzero cudaError_t (0 on
// success), cudaErrorInvalidValue for a shape the kernels do not take.
extern "C" int repro_ssd_scan_bwd_f32(
    const void* x, const void* dt, const void* A, const void* B,
    const void* C, const void* dy, const void* cum, const void* G,
    const void* sprev, void* dx, void* ddt, void* dA, void* dB, void* dC,
    void* ws, void* ws64, int BH, int S, int P, int N, int rep, int chunk,
    void* stream) {
  if (BH <= 0 || S <= 0 || P <= 0 || N <= 0 || rep <= 0 || BH % rep ||
      chunk <= 0 || chunk > 1024 || S % chunk || N > 128 || P > 64)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nc = S / chunk, np = N * P;
  const int ntiles = (chunk + kTR - 1) / kTR;
  const auto* xf = static_cast<const float*>(x);
  const auto* dtf = static_cast<const float*>(dt);
  const auto* Bf = static_cast<const float*>(B);
  const auto* Cf = static_cast<const float*>(C);
  const auto* dyf = static_cast<const float*>(dy);
  const auto* cumd = static_cast<const double*>(cum);
  const auto* Gf = static_cast<const float*>(G);
  const auto* spf = static_cast<const float*>(sprev);
  float* ds = static_cast<float*>(ws);
  float* dBh = ds + size_t(BH) * nc * np;
  float* dCh = dBh + size_t(BH) * S * N;
  float* ddt_part = dCh + size_t(BH) * S * N;
  float* ddecay = ddt_part + size_t(BH) * S;
  double* dcum_row = static_cast<double*>(ws64);
  double* dcum_col = dcum_row + size_t(BH) * S;
  double* dA_part = dcum_col + size_t(BH) * S;
  double* wdw = dA_part + size_t(BH) * nc;
  cudaError_t err;
  const size_t y_smem = sizeof(float) * kTR * (N + P);
  if ((err = set_smem(reinterpret_cast<const void*>(ssd_bwd_row_kernel),
                      row_smem(P, N))) != cudaSuccess ||
      (err = set_smem(reinterpret_cast<const void*>(ssd_bwd_col_kernel),
                      col_smem(P, N))) != cudaSuccess)
    return static_cast<int>(err);

  ssd_bwd_ychunk_kernel<<<dim3(nc, BH), kThreads, y_smem, st>>>(
      Cf, dyf, cumd, ds, S, P, N, rep, chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_rpass_kernel<<<BH, kThreads, 0, st>>>(ds, spf, cumd, ddecay, S, np,
                                                chunk, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_row_kernel<<<dim3(nc * ntiles, BH), kThreads, row_smem(P, N), st>>>(
      xf, dtf, Bf, Cf, dyf, cumd, Gf, spf, dCh, dcum_row, S, P, N, rep, chunk,
      ntiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_col_kernel<<<dim3(nc * ntiles, BH), kThreads, col_smem(P, N), st>>>(
      xf, dtf, Bf, Cf, dyf, cumd, Gf, ds, static_cast<float*>(dx), dBh,
      ddt_part, dcum_col, wdw, S, P, N, rep, chunk, ntiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_dcum_kernel<<<dim3(nc, BH), kThreads, sizeof(double) * chunk, st>>>(
      dtf, static_cast<const float*>(A), cumd, dcum_row, dcum_col, ddt_part,
      ddecay, wdw, static_cast<float*>(ddt), dA_part, S, chunk, ntiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int groups = BH / rep;
  ssd_bwd_reduce_kernel<<<1024, kThreads, 0, st>>>(
      dBh, dCh, dA_part, static_cast<float*>(dB), static_cast<float*>(dC),
      static_cast<float*>(dA), size_t(S) * N, groups, rep, BH, nc);
  return static_cast<int>(cudaGetLastError());
}
