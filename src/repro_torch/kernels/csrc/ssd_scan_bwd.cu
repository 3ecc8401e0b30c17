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
// `states` workspace after the forward's `pass`).
//
// Per head and chunk, with Lm = exp(cum_l - cum_m) (m <= l, a select:
// exp of l < m overflows), M = G .* Lm .* dt_m, w = dt exp(cum_last - cum)
// and e = exp(cum), five launches on the stream (kernels/ref.py
// ssd_scan_bwd_plain writes the same steps in PyTorch):
//   1. ychunk per (bh, chunk): Y_c = (e .* C)^T dy (N, P), into dS's place.
//   2. rpass  per (bh, 256 state elements), as the forward's pass: walks
//             the chunks from the last and leaves dS_c = R_{c+1} (the
//             gradient of the chunk's own state) in place of Y_c, ddecay_c's
//             part sum(dS_c .* S_prev) and R_c = Y_c + exp(cum_last) R_{c+1}.
//   3. col    per (group, chunk, 64 rows m, split of the group's heads),
//             the heads of the split in turn: g = B dS, the heads' sum of
//             (w x) dS^T, and for each 64-row tile l >= m: dM = dy x^T
//             (once), dG = dM .* Lm .* dt_m, the heads' sum of dG (in
//             shared memory), the row sums of dG .* G (a part per m tile)
//             and dx += M^T dy; then dx = ... + w g, ddt's part sum_l dM .*
//             G .* Lm + exp(cum_last - cum_m) (x . g), dcum's column part
//             -sum_l dG .* G - w (x . g), and sum_m w (x . g).  After the
//             heads: dB's part of the split, sum_h (w x) dS^T + (sum_h
//             dG)^T C, and sum_h dG, into workspaces.
//   4. row    per (group, chunk, 64 rows l, 64 columns of N), the group's
//             heads in turn:
//             P1 = dy S_prev^T, dC += e P1 and the row part C_l . e_l P1_l
//             of dcum; then dC += (sum_h dG) B over the tiles m <= l (the
//             splits' sums added in order), and dB = the splits' parts
//             added in order.
//   5. dcum   per bh: dcum = the parts above, cum_last's own terms added
//             (sum_m w (x . g) + ddecay exp(cum_last)); its reverse
//             in-chunk cumsum is d(dt * A): ddt += A d(dt A), and dA = sum
//             dt d(dt A) over the chunks.
// B and C are shared by the rep heads of a group, so dG B and dG^T C are
// formed once per group from the heads' sum of dG, and dB and dC are summed
// over the heads inside the CTAs (in head order, then over the splits in
// order): no per-head dB and dC and no reduce launch.  The splits of the
// heads (2-8, as many as keep two waves of col CTAs on the card) trade a
// small f32 workspace for parallelism.  The row launch stages each head's
// S_prev once per 64-row tile, four times a chunk of 256: a CTA holding a
// chunk's dC (128 KB of f32) would leave 32 CTAs at the training shape.
//
// Arithmetic: every product on the tensor cores, mma.sync m16n8k8 TF32 in
// 3xTF32 as in ssd_scan.cu (each operand split into hi = tf32(a) and lo =
// tf32(a - hi) as its fragment is read; lo hi + hi lo + hi hi in f32).
// Emulated on the plain version's steps (tests/test_torch_ssd.py), 3xTF32
// keeps all five gradients within ~4e-7 of autograd through the plain
// forward against a gate of 1e-4; one TF32 product each misses it (~3e-4).
// The sums that build dcum (the row and column sums of G .* dG, sum_m w
// (x . g), C_l . e_l P1_l), its reverse cumsum and dA run in f64, as
// autograd through the forward's f64 cumsum runs them: the row and column
// sums cancel in the reverse cumsum, at Mamba-2's decays to ~1e-3 of their
// size, which in f32 put ~1e-3 into dA.
//
// Bound on this card: operations.  The function needs 4 chunk N P +
// chunk^2 (N + P) multiply-adds a (bh, chunk), the causal triangle once
// (2.1e7 at the Mamba-2 1.3B training shape: BH = 256, S = 2048, P = 64,
// N = 128, chunk 256), ~86 GFLOP a call: 0.17 ms at the 495 TFLOP/s TF32
// peak against ~0.5 GB of traffic (0.15 ms at 3.35 TB/s).  With dG B and
// dG^T C formed once per group this kernel does 6 chunk N P + chunk^2 P
// multiply-adds a (bh, chunk), each as three TF32 products.  What holds it
// back (chip_smoke.py prints each launch's time; PERF.md keeps them): the
// col launch, at one CTA of 8 warps an SM (its strip of sum_h dG and the
// staged tiles take 190 KB), waits on its staging loads, barriers and the
// serial 3xTF32 chains.  Its off-diagonal Lm is a product of two
// exponentials per row (128 a tile, not 4096), and G is read while dM is
// formed.
//
// Every sum runs in a fixed order with no atomics, so two calls give
// bitwise equal outputs.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kT = 64;            // rows of a chunk tile (col, row)
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kMaxChunk = 256;
constexpr int kLdA = 68;          // rows of 64 read as [g][t]
constexpr int kLdB = 72;          // rows of 64 read as [t][g]
constexpr int kLdNA = 132;        // rows of N read as [g][t]
constexpr int kLdNB = 136;        // rows of N read as [t][g]
constexpr int kThreads = 256;     // col, row, dcum: 8 warps
constexpr int kSlab = 32;         // chunk rows a ychunk step stages
constexpr int kTileFloats = kT * kT;

// ---------------------------------------------------------------------------
// 3xTF32 on the tensor cores (as ssd_scan.cu).
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(v);
  lo = to_tf32(v - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in 3xTF32, the small terms first.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

// acc[NT] += A B for the warp's 16 rows and NT n8 column tiles over the
// depth [0, kend) (a multiple of 8): fa(r, k) is A's element at row r
// (0-15) of the warp's rows, fb(k, n) B's at column n (0 .. 8 NT - 1) of
// its columns.  The accumulator fragment: acc[nt][e] is row g + 8 (e >> 1),
// column 8 nt + 2t + (e & 1), with g = lane / 4 and t = lane % 4.
template <int NT, typename FA, typename FB>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4], int kend,
                                         FA fa, FB fb, int g, int t) {
  for (int k0 = 0; k0 < kend; k0 += 8) {
    uint32_t ah[4], al[4];
    split(fa(g, k0 + t), ah[0], al[0]);
    split(fa(g + 8, k0 + t), ah[1], al[1]);
    split(fa(g, k0 + t + 4), ah[2], al[2]);
    split(fa(g + 8, k0 + t + 4), ah[3], al[3]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      uint32_t bh[2], bl[2];
      split(fb(k0 + t, 8 * nt + g), bh[0], bl[0]);
      split(fb(k0 + t + 4, 8 * nt + g), bh[1], bl[1]);
      mma3(acc[nt], ah, al, bh, bl);
    }
  }
}

// Rows [row0, row0 + ROWS) and columns [0, CP) of a row-major block with
// row stride `stride` into shared memory with row stride ld, zero past
// `nrows` rows and past `cols` columns.  A thread issues up to 16 loads
// before it stores them, so their latencies overlap.
template <int ROWS, int CP, int THREADS>
__device__ __forceinline__ void stage(float* dst, const float* src, int row0,
                                      int nrows, int cols, int ld,
                                      int stride) {
  constexpr int kPer = ROWS * CP / THREADS;
  constexpr int kBatch = kPer < 16 ? kPer : 16;
  static_assert(ROWS * CP % THREADS == 0 && kPer % kBatch == 0, "tile");
#pragma unroll 1
  for (int b = 0; b < kPer; b += kBatch) {
    float v[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int e = threadIdx.x + (b + i) * THREADS;
      const int r = e / CP, c = e % CP;
      v[i] = row0 + r < nrows && c < cols ? src[size_t(row0 + r) * stride + c]
                                          : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int e = threadIdx.x + (b + i) * THREADS;
      dst[(e / CP) * ld + e % CP] = v[i];
    }
  }
}

// The same for a block whose row stride is its width.
template <int ROWS, int CP, int THREADS>
__device__ __forceinline__ void stage(float* dst, const float* src, int row0,
                                      int nrows, int cols, int ld) {
  stage<ROWS, CP, THREADS>(dst, src, row0, nrows, cols, ld, cols);
}

// ---------------------------------------------------------------------------
// 1. ychunk: Y_c = (e .* C)^T dy per (bh, chunk), into dS's place.
// ---------------------------------------------------------------------------

constexpr int kLdY = kMaxN + 8;   // [t][g]-read rows of C

__global__ void __launch_bounds__(kThreads, 2)
ssd_bwd_ychunk_kernel(const float* __restrict__ C,
                      const float* __restrict__ dy,
                      const double* __restrict__ cum, float* __restrict__ yc,
                      int S, int P, int N, int rep, int chunk) {
  __shared__ float Cs[kSlab * kLdY];    // [l][n], times e_l
  __shared__ float dys[kSlab * kLdB];   // [l][p]
  __shared__ float es[kSlab];
  const int c = blockIdx.x, bh = blockIdx.y, nc = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr = 16 * warp;   // the warp's 16 rows of N, all 64 of P
  const size_t row0 = size_t(c) * chunk;
  const float* Cg = C + (size_t(bh / rep) * S + row0) * N;
  const float* dyg = dy + (size_t(bh) * S + row0) * P;
  const double* cm = cum + size_t(bh) * S + row0;
  float y[8][4] = {};
  for (int l0 = 0; l0 < chunk; l0 += kSlab) {
    __syncthreads();   // the last slab read
    if (tid < kSlab)
      es[tid] = l0 + tid < chunk ? expf(static_cast<float>(cm[l0 + tid]))
                                 : 0.0f;
    stage<kSlab, kMaxN, kThreads>(Cs, Cg, l0, chunk, N, kLdY);
    stage<kSlab, kMaxP, kThreads>(dys, dyg, l0, chunk, P, kLdB);
    __syncthreads();
    if (wr < N)
      warp_mma<8>(
          y, kSlab,
          [&](int rr, int k) { return Cs[k * kLdY + wr + rr] * es[k]; },
          [&](int k, int n) { return dys[k * kLdB + n]; }, g, t);
  }
  float* out = yc + (size_t(bh) * nc + c) * N * P;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = wr + g + 8 * (e >> 1);
      const int p = 8 * nt + 2 * t + (e & 1);
      if (n < N && p < P) out[size_t(n) * P + p] = y[nt][e];
    }
}

// ---------------------------------------------------------------------------
// 2. rpass: per (bh, 256 state elements), the chunks from the last.
// ---------------------------------------------------------------------------

constexpr int kPassThreads = 256;
constexpr int kPassAhead = 8;   // chunks whose values are loaded at once

__global__ void __launch_bounds__(kPassThreads)
ssd_bwd_rpass_kernel(float* __restrict__ ds, const float* __restrict__ sprev,
                     const double* __restrict__ cum,
                     float* __restrict__ ddecay_part, int S, int NP,
                     int chunk, int nsl) {
  __shared__ float red[kPassAhead][kPassThreads / 32];
  const int sl = blockIdx.x, bh = blockIdx.y, nc = S / chunk;
  const int e = sl * kPassThreads + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const double* cl = cum + size_t(bh) * S + chunk - 1;
  const size_t base = size_t(bh) * nc * NP + e;
  float r = 0.0f;   // R, the state gradient carried backwards
  for (int c1 = nc; c1 > 0; c1 -= kPassAhead) {   // chunks c1 - 1 down
    float y[kPassAhead], sp[kPassAhead], dec[kPassAhead], part[kPassAhead];
#pragma unroll
    for (int k = 0; k < kPassAhead; ++k) {
      const int c = c1 - 1 - k;
      const bool in = c >= 0 && e < NP;
      y[k] = in ? ds[base + size_t(c) * NP] : 0.0f;
      sp[k] = in ? sprev[base + size_t(c) * NP] : 0.0f;
      dec[k] = c >= 0 ? expf(static_cast<float>(cl[size_t(c) * chunk]))
                      : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kPassAhead; ++k) {
      const int c = c1 - 1 - k;
      part[k] = 0.0f;
      if (c >= 0 && e < NP) {
        ds[base + size_t(c) * NP] = r;   // dS_c = R_{c+1}
        part[k] = r * sp[k];
        r = fmaf(dec[k], r, y[k]);
      }
#pragma unroll
      for (int sh = 16; sh > 0; sh >>= 1)
        part[k] += __shfl_xor_sync(0xffffffffu, part[k], sh);
    }
    __syncthreads();   // red of the last chunks read
    if (lane == 0)
#pragma unroll
      for (int k = 0; k < kPassAhead; ++k) red[k][warp] = part[k];
    __syncthreads();
    const int c = c1 - 1 - static_cast<int>(threadIdx.x);
    if (threadIdx.x < kPassAhead && c >= 0) {
      float s = 0.0f;
      for (int w = 0; w < kPassThreads / 32; ++w) s += red[threadIdx.x][w];
      ddecay_part[(size_t(bh) * nc + c) * nsl + sl] = s;
    }
  }
}

// ---------------------------------------------------------------------------
// 3. col: per (group, chunk, rows m, split of the heads).
// ---------------------------------------------------------------------------

// Shared memory of col: cum and the reductions in f64, then dt, the
// reductions in f32, the two factors of Lm, B's rows, x, dS (later C's
// rows), dy, M^T and the strip of the heads' sum of dG (the tiles l >= m,
// in fragment order).
constexpr size_t kColSmem =
    sizeof(double) * (kMaxChunk + 4 * kT) +
    sizeof(float) * (kMaxChunk + 6 * kT + kT * kLdNA + kT * kLdA +
                     kMaxN * kLdB + 2 * kT * kLdA +
                     (kMaxChunk / kT) * kTileFloats);
static_assert(kColSmem <= 232448, "col exceeds 227 KB");
static_assert(kMaxN * kLdB >= kT * kLdNB, "C rows do not fit dS's place");

__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_col_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ B, const float* __restrict__ C,
                   const float* __restrict__ dy,
                   const double* __restrict__ cum,
                   const float* __restrict__ G, const float* __restrict__ ds,
                   float* __restrict__ dx, float* __restrict__ dGs,
                   float* __restrict__ dBp, float* __restrict__ ddt_part,
                   double* __restrict__ rowZ, double* __restrict__ colZ,
                   double* __restrict__ wdw, int BH, int S, int P, int N,
                   int rep, int chunk, int hsplit) {
  extern __shared__ double smem_col[];
  double* cum_s = smem_col;                                // [chunk]
  double* red_d = cum_s + kMaxChunk;                       // [4][64]
  float* dt_s = reinterpret_cast<float*>(red_d + 4 * kT);  // [chunk]
  float* red_f = dt_s + kMaxChunk;                         // [4][64]
  float* el_s = red_f + 4 * kT;                            // [l]
  float* em_s = el_s + kT;                                 // [m]
  float* Bs = em_s + kT;                                   // [m][n]
  float* xs = Bs + kT * kLdNA;                             // [m][p]
  float* dss = xs + kT * kLdA;                             // [n][p]
  float* dys = dss + kMaxN * kLdB;                         // [l][p]
  float* Mts = dys + kT * kLdA;                            // [m][l]
  float* strip = Mts + kT * kLdA;                          // [tile][16][256]

  const int groups = BH / rep, nc = S / chunk;
  const int ntl = (chunk + kT - 1) / kT;
  int rest = blockIdx.x;
  const int hs = rest % hsplit;
  rest /= hsplit;
  const int grp = rest % groups;
  rest /= groups;
  const int c = rest % nc;
  const int mt = rest / nc;   // the first CTAs hold the longest strips
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr = 16 * (warp & 3);    // the warp's 16 rows
  const int wc = 32 * (warp >> 2);   // its 32 columns of a 64-wide output
  const int wn = 64 * (warp >> 2);   // its 64 columns of an N-wide output
  const int P8 = (P + 7) & ~7, N8 = (N + 7) & ~7;
  const int m0 = mt * kT;
  const size_t crow = size_t(c) * chunk;
  const int h_lo = grp * rep + (hs * rep) / hsplit;
  const int h_hi = grp * rep + ((hs + 1) * rep) / hsplit;
  const float* Bc = B + (size_t(grp) * S + crow) * N;
  const float* Cc = C + (size_t(grp) * S + crow) * N;
  const float* Gc = G + (size_t(grp) * nc + c) * chunk * chunk;

  stage<kT, kMaxN, kThreads>(Bs, Bc, m0, chunk, N, kLdNA);

  float dBacc[8][4] = {};   // (m, n)
  for (int bh = h_lo; bh < h_hi; ++bh) {
    const bool first = bh == h_lo;
    const size_t hrow = size_t(bh) * S + crow;   // the chunk's first row
    __syncthreads();   // the last head's tiles and reductions read
    for (int l = tid; l < chunk; l += kThreads) {
      cum_s[l] = cum[hrow + l];
      dt_s[l] = dt[hrow + l];
    }
    stage<kT, kMaxP, kThreads>(xs, x + hrow * P, m0, chunk, P, kLdA);
    stage<kMaxN, kMaxP, kThreads>(dss, ds + (size_t(bh) * nc + c) * N * P,
                                  0, N, P, kLdB);
    __syncthreads();
    const double cum_last = cum_s[chunk - 1];
    float wm[2];   // w of the thread's rows wr + g and wr + g + 8
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int ma = m0 + wr + g + 8 * hr;
      wm[hr] = ma < chunk
                   ? expf(static_cast<float>(cum_last - cum_s[ma])) * dt_s[ma]
                   : 0.0f;
    }

    // g = B dS (m, p); the heads' sum (w x) dS^T (m, n).
    float gacc[4][4] = {};
    if (wc < P8)
      warp_mma<4>(
          gacc, N8, [&](int rr, int k) { return Bs[(wr + rr) * kLdNA + k]; },
          [&](int k, int n) { return dss[k * kLdB + wc + n]; }, g, t);
    if (wn < N8)
      warp_mma<8>(
          dBacc, P8,
          [&](int rr, int k) {
            return wm[rr >> 3] * xs[(wr + rr) * kLdA + k];
          },
          [&](int k, int n) { return dss[(wn + n) * kLdB + k]; }, g, t);

    float dxacc[4][4] = {};
    float ddc[2] = {0.0f, 0.0f};   // sum_l dM .* G .* Lm of the rows
    double zc[2] = {0.0, 0.0};     // sum_l dG .* G of the rows
    for (int lt = mt; lt < ntl; ++lt) {
      const int l0 = lt * kT;
      __syncthreads();   // dy, M^T and the reductions of the last tile read
      stage<kT, kMaxP, kThreads>(dys, dy + hrow * P, l0, chunk, P, kLdA);
      // Below the diagonal Lm = exp(cum_l - cum_l0) exp(cum_l0 - cum_m),
      // both factors at most 1 (m < l0 <= l, cum falling as dt A <= 0, as
      // Mamba-2's A = -exp(A_log) makes it): 128 exponentials a tile.
      if (lt > mt && tid < 2 * kT) {
        const int i = tid % kT;
        const int r = tid < kT ? l0 + i : m0 + i;
        const double d = tid < kT ? cum_s[min(r, chunk - 1)] - cum_s[l0]
                                  : cum_s[l0] - cum_s[r];
        (tid < kT ? el_s : em_s)[i] = expf(static_cast<float>(d));
      }
      // G of the tile, read while the product below runs.
      float gv[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ma = m0 + wr + g + 8 * (e >> 1);
          const int la = l0 + wc + 8 * nt + 2 * t + (e & 1);
          gv[nt][e] = ma <= la && la < chunk
                          ? __ldg(Gc + size_t(la) * chunk + ma)
                          : 0.0f;
        }
      __syncthreads();
      // dM^T = x dy^T (m, l), the tile's only product of dy and x.
      float dm[4][4] = {};
      warp_mma<4>(
          dm, P8, [&](int rr, int k) { return xs[(wr + rr) * kLdA + k]; },
          [&](int k, int n) { return dys[(wc + n) * kLdA + k]; }, g, t);
      float* st = strip + (lt - mt) * kTileFloats;
      double zr[4][2] = {};   // sum over the thread's rows, per column
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = wr + g + 8 * (e >> 1);
          const int l = wc + 8 * nt + 2 * t + (e & 1);
          const int ma = m0 + m, la = l0 + l;
          const bool ok = ma <= la && la < chunk;
          const float Lm =
              !ok ? 0.0f
              : lt > mt ? el_s[l] * em_s[m]
                        : expf(static_cast<float>(cum_s[la] - cum_s[ma]));
          const float gv_ = gv[nt][e];
          const float dtm = ok ? dt_s[ma] : 0.0f;
          const float dg = dm[nt][e] * Lm * dtm;
          const double z = static_cast<double>(dg * gv_);
          zc[e >> 1] += z;
          zr[nt][e & 1] += z;
          ddc[e >> 1] += dm[nt][e] * gv_ * Lm;
          const int at = (nt * 4 + e) * kThreads + tid;
          st[at] = first ? dg : st[at] + dg;
          Mts[m * kLdA + l] = gv_ * Lm * dtm;
        }
      // The row sums of dG .* G over the tile's m: over g, then the warps.
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          double v = zr[nt][j];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (g == 0) red_d[(warp & 3) * kT + wc + 8 * nt + 2 * t + j] = v;
        }
      __syncthreads();
      if (tid < kT && l0 + tid < chunk)
        rowZ[(hrow + l0 + tid) * ntl + mt] =
            red_d[tid] + red_d[kT + tid] + red_d[2 * kT + tid] +
            red_d[3 * kT + tid];
      // dx += M^T dy (m, p).
      if (wc < P8)
        warp_mma<4>(
            dxacc, kT, [&](int rr, int k) { return Mts[(wr + rr) * kLdA + k]; },
            [&](int k, int n) { return dys[k * kLdA + wc + n]; }, g, t);
    }

    // dx = M^T dy + w g; x . g, ddt's and dcum's column parts.
    float bvp[2] = {0.0f, 0.0f};
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = wr + g + 8 * (e >> 1);
        const int p = wc + 8 * nt + 2 * t + (e & 1);
        bvp[e >> 1] = fmaf(xs[m * kLdA + p], gacc[nt][e], bvp[e >> 1]);
        if (m0 + m < chunk && p < P)
          dx[(hrow + m0 + m) * P + p] = dxacc[nt][e] + wm[e >> 1] * gacc[nt][e];
      }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
#pragma unroll
      for (int sh = 1; sh < 4; sh <<= 1) {
        bvp[hr] += __shfl_xor_sync(0xffffffffu, bvp[hr], sh);
        ddc[hr] += __shfl_xor_sync(0xffffffffu, ddc[hr], sh);
        zc[hr] += __shfl_xor_sync(0xffffffffu, zc[hr], sh);
      }
    __syncthreads();   // red_d of the last tile read
    if (t == 0)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int m = wr + g + 8 * hr, half = warp >> 2;
        red_f[half * kT + m] = bvp[hr];
        red_f[(2 + half) * kT + m] = ddc[hr];
        red_d[half * kT + m] = zc[hr];
      }
    __syncthreads();
    if (tid < kT) {
      const int ma = m0 + tid;
      double wbv = 0.0;
      if (ma < chunk) {
        const float bv = red_f[tid] + red_f[kT + tid];
        const float tail = expf(static_cast<float>(cum_last - cum_s[ma]));
        const float w = tail * dt_s[ma];
        ddt_part[hrow + ma] =
            red_f[2 * kT + tid] + red_f[3 * kT + tid] + tail * bv;
        wbv = static_cast<double>(w * bv);
        colZ[hrow + ma] = -(red_d[tid] + red_d[kT + tid]) - wbv;
      }
      red_d[2 * kT + tid] = wbv;
    }
    __syncthreads();
    if (tid == 0) {
      double s = 0.0;
      for (int m = 0; m < kT; ++m) s += red_d[2 * kT + m];
      wdw[(size_t(bh) * nc + c) * ntl + mt] = s;
    }
  }

  // dB's part: + (sum_h dG)^T C over the tiles l >= m; sum_h dG to the
  // workspace as [l][m].
  float* Cb = dss;   // [l][n]
  float* dGo = dGs + ((size_t(hs) * groups + grp) * nc + c) * chunk * chunk;
  for (int lt = mt; lt < ntl; ++lt) {
    const int l0 = lt * kT;
    __syncthreads();
    stage<kT, kMaxN, kThreads>(Cb, Cc, l0, chunk, N, kLdNB);
    const float* st = strip + (lt - mt) * kTileFloats;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = wr + g + 8 * (e >> 1);
        const int l = wc + 8 * nt + 2 * t + (e & 1);
        const float v = st[(nt * 4 + e) * kThreads + tid];
        Mts[m * kLdA + l] = v;
        if (m0 + m < chunk && l0 + l < chunk)
          dGo[size_t(l0 + l) * chunk + m0 + m] = v;
      }
    __syncthreads();
    if (wn < N8)
      warp_mma<8>(
          dBacc, kT, [&](int rr, int k) { return Mts[(wr + rr) * kLdA + k]; },
          [&](int k, int n) { return Cb[k * kLdNB + wn + n]; }, g, t);
  }
  float* dBo = dBp + ((size_t(hs) * groups + grp) * S + crow + m0) * N;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = wr + g + 8 * (e >> 1);
      const int n = wn + 8 * nt + 2 * t + (e & 1);
      if (m0 + m < chunk && n < N) dBo[size_t(m) * N + n] = dBacc[nt][e];
    }
}

// ---------------------------------------------------------------------------
// 4. row: per (group, chunk, rows l, 64 columns of N).
// ---------------------------------------------------------------------------

constexpr int kNH = 64;   // columns of N a row CTA owns

constexpr size_t kRowSmem = sizeof(double) * (kT + 2 * kT) +
                            sizeof(float) * (4 * kT * kLdA + kT * kLdB);
static_assert(2 * kRowSmem <= 232448, "two row CTAs exceed an SM");

__global__ void __launch_bounds__(kThreads, 2)
ssd_bwd_row_kernel(const float* __restrict__ B, const float* __restrict__ C,
                   const float* __restrict__ dy,
                   const double* __restrict__ cum,
                   const float* __restrict__ sprev,
                   const float* __restrict__ dGs,
                   const float* __restrict__ dBp, float* __restrict__ dB,
                   float* __restrict__ dC, double* __restrict__ rowI, int BH,
                   int S, int P, int N, int rep, int chunk, int hsplit) {
  extern __shared__ double smem_row[];
  double* cum_s = smem_row;                                // [64]
  double* red_d = cum_s + kT;                              // [2][64]
  float* Cs = reinterpret_cast<float*>(red_d + 2 * kT);    // [l][n]
  float* dys = Cs + kT * kLdA;                             // [l][p]
  float* sps = dys + kT * kLdA;                            // [n][p]
  float* As = sps + kT * kLdA;                             // [l][m]
  float* Bt = As + kT * kLdA;                              // [m][n]

  const int groups = BH / rep, nc = S / chunk;
  const int ntl = (chunk + kT - 1) / kT, nhalf = (N + kNH - 1) / kNH;
  int rest = blockIdx.x;
  const int half = rest % nhalf;
  rest /= nhalf;
  const int grp = rest % groups;
  rest /= groups;
  const int c = rest % nc;
  const int lt = ntl - 1 - rest / nc;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr = 16 * (warp & 3), wc = 32 * (warp >> 2);
  const int P8 = (P + 7) & ~7;
  const int n0 = half * kNH, nw = min(kNH, N - n0);   // this CTA's columns
  const int l0 = lt * kT;
  const size_t crow = size_t(c) * chunk;
  const size_t grow = size_t(grp) * S + crow;   // the group's chunk rows

  stage<kT, kNH, kThreads>(Cs, C + grow * N + n0, l0, chunk, nw, kLdA, N);

  float acc[4][4] = {};   // dC (l, n)
  for (int bh = grp * rep; bh < (grp + 1) * rep; ++bh) {
    const size_t hrow = size_t(bh) * S + crow;
    __syncthreads();   // the last head's tiles and reductions read
    if (tid < kT) cum_s[tid] = l0 + tid < chunk ? cum[hrow + l0 + tid] : 0.0;
    stage<kT, kMaxP, kThreads>(dys, dy + hrow * P, l0, chunk, P, kLdA);
    stage<kNH, kMaxP, kThreads>(
        sps, sprev + ((size_t(bh) * nc + c) * N + n0) * P, 0, nw, P, kLdA);
    __syncthreads();
    // P1 = dy S_prev^T (l, n); dC += e P1 and C_l . e_l P1_l.
    float p1[4][4] = {};
    if (wc < nw)
      warp_mma<4>(
          p1, P8, [&](int rr, int k) { return dys[(wr + rr) * kLdA + k]; },
          [&](int k, int n) { return sps[(wc + n) * kLdA + k]; }, g, t);
    float el[2];
    double ri[2] = {0.0, 0.0};
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int l = wr + g + 8 * hr;
      el[hr] = l0 + l < chunk ? expf(static_cast<float>(cum_s[l])) : 0.0f;
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int l = wr + g + 8 * (e >> 1);
        const int n = wc + 8 * nt + 2 * t + (e & 1);
        const float dcv = el[e >> 1] * p1[nt][e];
        ri[e >> 1] += static_cast<double>(dcv * Cs[l * kLdA + n]);
        acc[nt][e] += dcv;
      }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
#pragma unroll
      for (int sh = 1; sh < 4; sh <<= 1)
        ri[hr] += __shfl_xor_sync(0xffffffffu, ri[hr], sh);
    if (t == 0)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        red_d[(warp >> 2) * kT + wr + g + 8 * hr] = ri[hr];
    __syncthreads();
    if (tid < kT && l0 + tid < chunk)
      rowI[(size_t(half) * BH * S) + hrow + l0 + tid] =
          red_d[tid] + red_d[kT + tid];
  }

  // dC += (sum_h dG) B over the tiles m <= l, the splits added in order.
  for (int mt = 0; mt <= lt; ++mt) {
    const int m0 = mt * kT;
    __syncthreads();
    float v[kT * kT / kThreads] = {};
    for (int hs = 0; hs < hsplit; ++hs) {
      const float* src =
          dGs + ((size_t(hs) * groups + grp) * nc + c) * chunk * chunk;
#pragma unroll
      for (int i = 0; i < kT * kT / kThreads; ++i) {
        const int e = tid + i * kThreads, l = e / kT, m = e % kT;
        if (l0 + l < chunk && m0 + m < chunk)
          v[i] += src[size_t(l0 + l) * chunk + m0 + m];
      }
    }
#pragma unroll
    for (int i = 0; i < kT * kT / kThreads; ++i) {
      const int e = tid + i * kThreads;
      As[(e / kT) * kLdA + e % kT] = v[i];
    }
    stage<kT, kNH, kThreads>(Bt, B + grow * N + n0, m0, chunk, nw, kLdB, N);
    __syncthreads();
    if (wc < nw)
      warp_mma<4>(
          acc, kT, [&](int rr, int k) { return As[(wr + rr) * kLdA + k]; },
          [&](int k, int n) { return Bt[k * kLdB + wc + n]; }, g, t);
  }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int l = wr + g + 8 * (e >> 1);
      const int n = wc + 8 * nt + 2 * t + (e & 1);
      if (l0 + l < chunk && n < nw)
        dC[(grow + l0 + l) * N + n0 + n] = acc[nt][e];
    }
  // dB of the tile's rows and columns: the splits' parts added in order.
  const int rows = min(kT, chunk - l0);
  for (int e0 = 0; e0 < rows * kNH; e0 += 8 * kThreads) {
    float v[8] = {};
    for (int hs = 0; hs < hsplit; ++hs)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int e = e0 + tid + i * kThreads, r = e / kNH, n = e % kNH;
        if (r < rows && n < nw)
          v[i] += dBp[size_t(hs) * groups * S * N + (grow + l0 + r) * N +
                      n0 + n];
      }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int e = e0 + tid + i * kThreads, r = e / kNH, n = e % kNH;
      if (r < rows && n < nw) dB[(grow + l0 + r) * N + n0 + n] = v[i];
    }
  }
}

// ---------------------------------------------------------------------------
// 5. dcum: per bh, the chunks in order.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
ssd_bwd_dcum_kernel(const float* __restrict__ dt,
                    const float* __restrict__ A,
                    const double* __restrict__ cum,
                    const double* __restrict__ rowZ,
                    const double* __restrict__ rowI,
                    const double* __restrict__ colZ,
                    const double* __restrict__ wdw,
                    const float* __restrict__ ddecay_part,
                    const float* __restrict__ ddt_part,
                    float* __restrict__ ddt, float* __restrict__ dA, int BH,
                    int S, int chunk, int nsl, int nhalf) {
  __shared__ double dc[kMaxChunk];
  __shared__ float dts[kMaxChunk];
  const int bh = blockIdx.x, nc = S / chunk;
  const int ntl = (chunk + kT - 1) / kT;
  const float a = A[bh];
  double da_tot = 0.0;
  for (int c = 0; c < nc; ++c) {
    const size_t base = size_t(bh) * S + size_t(c) * chunk;
    __syncthreads();   // the last chunk's dc read
    for (int l = threadIdx.x; l < chunk; l += kThreads) {
      double s = colZ[base + l];
      for (int h = 0; h < nhalf; ++h) s += rowI[size_t(h) * BH * S + base + l];
      for (int mt = 0; mt <= l / kT; ++mt) s += rowZ[(base + l) * ntl + mt];
      dc[l] = s;
      dts[l] = dt[base + l];
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      const size_t bc = size_t(bh) * nc + c;
      double last = 0.0;
      for (int mt = 0; mt < ntl; ++mt) last += wdw[bc * ntl + mt];
      float dd = 0.0f;
      for (int s = 0; s < nsl; ++s) dd += ddecay_part[bc * nsl + s];
      last += static_cast<double>(
          dd * expf(static_cast<float>(cum[base + chunk - 1])));
      dc[chunk - 1] += last;
      double acc = 0.0, da = 0.0;
      for (int l = chunk - 1; l >= 0; --l) {
        acc += dc[l];
        dc[l] = acc;
        da += static_cast<double>(dts[l]) * acc;
      }
      da_tot += da;
    }
    __syncthreads();
    for (int l = threadIdx.x; l < chunk; l += kThreads)
      ddt[base + l] = fmaf(a, static_cast<float>(dc[l]), ddt_part[base + l]);
  }
  if (threadIdx.x == 0) dA[bh] = static_cast<float>(da_tot);
}

cudaError_t set_smem(const void* fn, size_t bytes) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

// The workspaces of repro_ssd_scan_bwd_f32, which kernels/ssd_scan.py
// allocates by the same formulas, with nc = S / chunk, ntl = chunk / 64 and
// nsl = N P / 256 rounded up, BG = BH / rep and H the splits of a group's
// heads.  `ws` (f32), in order: dS (BH, nc, N, P), the splits' sums of dG
// (H, BG, nc, chunk, chunk), the splits' parts of dB (H, BG, S, N), ddt's
// parts (BH, S) and ddecay's (BH, nc, nsl).  `ws64` (f64): the row sums of
// dG .* G per m tile (BH, S, ntl), the row part C . e P1 per 64 columns of
// N (N / 64 rounded up, BH, S), the column part of dcum (BH, S) and sum w
// (x . g) per m tile (BH, nc, ntl).
//
// x, dy, dx: (BH, S, P); dt, ddt: (BH, S); A, dA: (BH,); B, C, dB, dC:
// (BH / rep, S, N); cum (BH, S) f64, G (BH / rep, S / chunk, chunk, chunk)
// and sprev (BH, S / chunk, N, P): the forward's workspaces after its
// launches.  All f32 unless named, contiguous, on the stream's device; S a
// multiple of chunk, chunk <= 256, N <= 128, P <= 64, 1 <= H <= rep.  Five
// launches on the stream; returns the first nonzero cudaError_t (0 on
// success), cudaErrorInvalidValue for a shape the kernels do not take.
extern "C" int repro_ssd_scan_bwd_f32(
    const void* x, const void* dt, const void* A, const void* B,
    const void* C, const void* dy, const void* cum, const void* G,
    const void* sprev, void* dx, void* ddt, void* dA, void* dB, void* dC,
    void* ws, void* ws64, int BH, int S, int P, int N, int rep, int chunk,
    int hsplit, void* stream) {
  if (BH <= 0 || S <= 0 || P <= 0 || N <= 0 || rep <= 0 || BH % rep ||
      chunk <= 0 || chunk > kMaxChunk || S % chunk || N > kMaxN ||
      P > kMaxP || hsplit < 1 || hsplit > rep)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nc = S / chunk, groups = BH / rep;
  const int ntl = (chunk + kT - 1) / kT;
  const int nsl = (N * P + kPassThreads - 1) / kPassThreads;
  const auto* xf = static_cast<const float*>(x);
  const auto* dtf = static_cast<const float*>(dt);
  const auto* Bf = static_cast<const float*>(B);
  const auto* Cf = static_cast<const float*>(C);
  const auto* dyf = static_cast<const float*>(dy);
  const auto* cumd = static_cast<const double*>(cum);
  const auto* Gf = static_cast<const float*>(G);
  const auto* spf = static_cast<const float*>(sprev);
  float* ds = static_cast<float*>(ws);
  float* dGs = ds + size_t(BH) * nc * N * P;
  float* dBp = dGs + size_t(hsplit) * groups * nc * chunk * chunk;
  float* ddt_part = dBp + size_t(hsplit) * groups * S * N;
  float* ddecay_part = ddt_part + size_t(BH) * S;
  double* rowZ = static_cast<double*>(ws64);
  const int nhalf = (N + kNH - 1) / kNH;
  double* rowI = rowZ + size_t(BH) * S * ntl;
  double* colZ = rowI + size_t(nhalf) * BH * S;
  double* wdw = colZ + size_t(BH) * S;
  cudaError_t err;
  if ((err = set_smem(reinterpret_cast<const void*>(ssd_bwd_col_kernel),
                      kColSmem)) != cudaSuccess ||
      (err = set_smem(reinterpret_cast<const void*>(ssd_bwd_row_kernel),
                      kRowSmem)) != cudaSuccess)
    return static_cast<int>(err);

  ssd_bwd_ychunk_kernel<<<dim3(nc, BH), kThreads, 0, st>>>(
      Cf, dyf, cumd, ds, S, P, N, rep, chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_rpass_kernel<<<dim3(nsl, BH), kPassThreads, 0, st>>>(
      ds, spf, cumd, ddecay_part, S, N * P, chunk, nsl);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_col_kernel<<<ntl * nc * groups * hsplit, kThreads, kColSmem, st>>>(
      xf, dtf, Bf, Cf, dyf, cumd, Gf, ds, static_cast<float*>(dx), dGs, dBp,
      ddt_part, rowZ, colZ, wdw, BH, S, P, N, rep, chunk, hsplit);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_row_kernel<<<ntl * nc * groups * nhalf, kThreads, kRowSmem, st>>>(
      Bf, Cf, dyf, cumd, spf, dGs, dBp, static_cast<float*>(dB),
      static_cast<float*>(dC), rowI, BH, S, P, N, rep, chunk, hsplit);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_dcum_kernel<<<BH, kThreads, 0, st>>>(
      dtf, static_cast<const float*>(A), cumd, rowZ, rowI, colZ, wdw,
      ddecay_part, ddt_part, static_cast<float*>(ddt),
      static_cast<float*>(dA), BH, S, chunk, nsl, nhalf);
  return static_cast<int>(cudaGetLastError());
}
