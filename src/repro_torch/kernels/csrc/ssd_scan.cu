// Mamba-2 SSD chunked scan on Hopper (sm_90a), f32.
//
// Replaces: src/repro/kernels/ssd_scan.py `ssd_scan` (`_ssd_kernel`), the
// Pallas TPU kernel of the state-space-duality scan.  On the TPU the grid is
// (BH, S/chunk) with the chunk axis sequential and the (N, P) state carried
// across chunks in VMEM scratch; the output is y alone.
//
// Head-folded layout: x (BH, S, P), dt (BH, S), A (BH,), B and C (BG, S, N)
// with BH = BG * rep: head bh reads row bh / rep of B and C, so the heads of
// a group share B and C without a copy.  Per chunk of `chunk` rows, with
// cum the in-chunk cumulative sum of dt * A:
//
//   intra:  y  = ((C B^T) .* L .* dt) x, L = exp(cum_i - cum_j) for i >= j
//   inter:  y += exp(cum) .* (C S_prev)
//   state:  S  = exp(cum_last) S_prev + B^T (w .* x),
//           w  = dt exp(cum_last - cum)
//
// and after the last chunk the carried state S (N, P) is a second output
// (the decode cache), which the TPU kernel keeps in scratch and drops.
//
// Bound on this card: bytes.  Counting the causal triangle only, the
// function needs chunk^2 N flops per (group, chunk) for C B^T and
// chunk^2 P + 4 chunk N P per (bh, chunk): at the Mamba-2 1.3B prefill
// shape (BH = 256, one group of 64 heads per sequence, S = 4096, P = 64,
// N = 128, chunk 256) ~52 GFLOP a call against ~0.57 GB of traffic, so
// 0.11 ms at the 495 TFLOP/s TF32 tensor-core peak against 0.17 ms at
// 3.35 TB/s.  The arithmetic this kernel does, each product as three TF32
// products, takes 0.32 ms at that peak; exact f32 FMA would take 0.78 ms
// at 67 TFLOP/s.
//
// Design: Mamba-2's own GPU split of the SSD algorithm, five launches a
// call, each parallel over chunks:
//   1. cum     per (bh, chunk): the in-chunk cumulative sum of dt * A in
//              f64, into a (BH, S) f64 workspace.  At the model's step
//              sizes cum reaches about -180 within a chunk, where an f32
//              sum carries ~1e-5 of rounding in every exponent
//              cum_i - cum_j; each f64 difference is rounded to f32 before
//              expf.
//   2. cb      per (group, chunk, 64 x 64 tile of the causal triangle):
//              G = C B^T, once per group, into a (BG, S/chunk, chunk,
//              chunk) f32 workspace that the group's heads read from L2.
//   3. states  per (bh, chunk, 64 columns of P): s_c = B^T (w .* x) into a
//              (BH, S/chunk, N, P) f32 workspace.
//   4. pass    per (bh, 256 state elements): walks the chunks in order,
//              S_c = exp(cum_last) S_{c-1} + s_c, leaves the state before
//              each chunk in the workspace, in place, and writes the final
//              state.
//   5. out     per (bh, chunk, 64-row tile, 64 columns of P), 8 warps of
//              16 rows x 32 columns:
//              y = exp(cum) .* (C S_{c-1}) + sum_{j <= i} (G .* L .* dt) x_j.
//              The mask is a select, never a product: exp(cum_i - cum_j) for
//              i < j overflows to inf, and inf * 0 is NaN.
//
// Products: mma.sync m16n8k8 TF32 in 3xTF32.  Each operand a is split into
// hi = tf32(a) and lo = tf32(a - hi) (round to nearest, ties away) as it is
// staged in shared memory (cb: as its fragment is read), and each product
// accumulates lo*hi + hi*lo + hi*hi in f32.  Emulated on the plain
// version's algorithm (tests/test_torch_ssd.py), single TF32 misses the
// kernel's tolerance against exact f32 (5e-5 + 5e-4 |plain|) more than
// ten times over, while 3xTF32 stays within a quarter of it.  Shared-memory
// rows are padded so that the fragment loads are free of bank conflicts:
// rows read as [g][t] (8 rows x 4 columns a warp) have a stride of 4
// (mod 8) words, rows read as [t][g] a stride of 8 (mod 32).
//
// Staging: states and out load their next tile into registers while the
// current one multiplies, then split it into shared memory between two
// barriers.  At the prefill shape out takes most of a call, then states
// (chip_smoke.py prints each launch's device time; PERF.md keeps them);
// out is held up more by staging its tiles (forming G .* L .* dt takes an
// expf per element) and the barriers around it than by its products.
//
// Every sum runs in a fixed order with no atomics, so two calls give
// bitwise equal outputs.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kRT = 64;        // rows of a chunk tile (cb, out)
constexpr int kPT = 64;        // columns of P a CTA owns (states, out)
constexpr int kMaxN = 128;
constexpr int kLdP = kPT + 8;  // [t][g]-read rows of P columns
constexpr int kSlab = 32;      // chunk rows per states slab
constexpr int kLdSt = kMaxN + 8;   // [t][g]-read B rows (states)
constexpr int kLdM = kRT + 4;      // [g][t]-read A tile rows (out)

// ---------------------------------------------------------------------------
// 3xTF32 on the tensor cores.
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

// A fragment (16 x 8, row-major) of a [row][k] array: rows r0 + g (+8),
// columns k0 + t (+4).
__device__ __forceinline__ void frag_a_rk(uint32_t (&a)[4], const uint32_t* s,
                                          int ld, int r0, int k0, int g,
                                          int t) {
  a[0] = s[(r0 + g) * ld + k0 + t];
  a[1] = s[(r0 + g + 8) * ld + k0 + t];
  a[2] = s[(r0 + g) * ld + k0 + t + 4];
  a[3] = s[(r0 + g + 8) * ld + k0 + t + 4];
}

// A fragment of a [k][row] array (the transpose is the operand).
__device__ __forceinline__ void frag_a_kr(uint32_t (&a)[4], const uint32_t* s,
                                          int ld, int r0, int k0, int g,
                                          int t) {
  a[0] = s[(k0 + t) * ld + r0 + g];
  a[1] = s[(k0 + t) * ld + r0 + g + 8];
  a[2] = s[(k0 + t + 4) * ld + r0 + g];
  a[3] = s[(k0 + t + 4) * ld + r0 + g + 8];
}

// B fragment (8 x 8, column operand) of a [k][col] array.
__device__ __forceinline__ void frag_b_kc(uint32_t (&b)[2], const uint32_t* s,
                                          int ld, int c0, int k0, int g,
                                          int t) {
  b[0] = s[(k0 + t) * ld + c0 + g];
  b[1] = s[(k0 + t + 4) * ld + c0 + g];
}

// B fragment of a [col][k] array.
__device__ __forceinline__ void frag_b_ck(uint32_t (&b)[2], const uint32_t* s,
                                          int ld, int c0, int k0, int g,
                                          int t) {
  b[0] = s[(c0 + g) * ld + k0 + t];
  b[1] = s[(c0 + g) * ld + k0 + t + 4];
}

__device__ __forceinline__ void split_store4(uint32_t* hi, uint32_t* lo,
                                             float4 v) {
  uint4 h, l;
  split(v.x, h.x, l.x);
  split(v.y, h.y, l.y);
  split(v.z, h.z, l.z);
  split(v.w, h.w, l.w);
  *reinterpret_cast<uint4*>(hi) = h;
  *reinterpret_cast<uint4*>(lo) = l;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// ---------------------------------------------------------------------------
// 1. cum: inclusive cumsum of dt * A over each chunk, in f64.
// ---------------------------------------------------------------------------

constexpr int kCumThreads = 256;
constexpr int kCumWarps = kCumThreads / 32;

__global__ void __launch_bounds__(kCumThreads)
ssd_cum_kernel(const float* __restrict__ dt, const float* __restrict__ A,
               double* __restrict__ cum, int S, int chunk) {
  __shared__ double warp_tot[kCumWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.y;
  const size_t base = size_t(bh) * S + size_t(blockIdx.x) * chunk;
  const float a = A[bh];
  double carry = 0.0;
  for (int off0 = 0; off0 < chunk; off0 += kCumThreads) {
    const int l = off0 + tid;
    double v = l < chunk ? static_cast<double>(dt[base + l] * a) : 0.0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double u = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += u;
    }
    __syncthreads();   // warp_tot of the previous piece read
    if (lane == 31) warp_tot[warp] = v;
    __syncthreads();
    double pre = carry;
    for (int w = 0; w < warp; ++w) pre += warp_tot[w];
    double total = carry;
    for (int w = 0; w < kCumWarps; ++w) total += warp_tot[w];
    if (l < chunk) cum[base + l] = pre + v;
    carry = total;
  }
}

// ---------------------------------------------------------------------------
// 2. cb: G = C B^T per (group, chunk), 64 x 64 tiles with ti >= tj.
// ---------------------------------------------------------------------------

constexpr int kCbThreads = 128;   // 4 warps of 16 rows

size_t cb_smem(int N) { return 2ull * kRT * (N + 4) * sizeof(float); }

// Rows [row0, row0 + 64) of a chunk (zero past `chunk`) of a (S, N) block.
__device__ __forceinline__ void load_rows64(float* dst, const float* src,
                                            int row0, int chunk, int N,
                                            int nthreads) {
  const int q4 = N / 4, ld = N + 4;
  for (int q = threadIdx.x; q < kRT * q4; q += nthreads) {
    const int r = q / q4, c = (q - r * q4) * 4;
    const float4 v = row0 + r < chunk ? ld4(src + size_t(row0 + r) * N + c)
                                      : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(dst + r * ld + c) = v;
  }
}

__global__ void __launch_bounds__(kCbThreads)
ssd_cb_kernel(const float* __restrict__ B, const float* __restrict__ C,
              float* __restrict__ G, int S, int N, int chunk, int pairs) {
  extern __shared__ float4 smem_cb[];
  float* cs = reinterpret_cast<float*>(smem_cb);
  float* bs = cs + kRT * (N + 4);
  const int ld = N + 4;
  const int nc = S / chunk;
  const int c = blockIdx.x / pairs;
  int t = blockIdx.x - c * pairs, ti = 0;
  while (t > ti) {   // pairs (ti, tj) with tj <= ti, row by row
    t -= ti + 1;
    ++ti;
  }
  const int tj = t;
  const int grp = blockIdx.y;
  const size_t chunk0 = size_t(grp) * S + size_t(c) * chunk;
  load_rows64(cs, C + chunk0 * N, ti * kRT, chunk, N, kCbThreads);
  load_rows64(bs, B + chunk0 * N, tj * kRT, chunk, N, kCbThreads);
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int r0 = warp * 16;
  // On the diagonal tile, columns past the warp's last row are masked.
  const int nt_end = ti == tj ? 2 * warp + 2 : kRT / 8;
  float acc[kRT / 8][4] = {};
  const uint32_t* cu = reinterpret_cast<const uint32_t*>(cs);
  const uint32_t* bu = reinterpret_cast<const uint32_t*>(bs);
  for (int k0 = 0; k0 < N; k0 += 8) {
    uint32_t a[4], ah[4], al[4];
    frag_a_rk(a, cu, ld, r0, k0, g, tq);
#pragma unroll
    for (int e = 0; e < 4; ++e) split(__uint_as_float(a[e]), ah[e], al[e]);
#pragma unroll
    for (int nt = 0; nt < kRT / 8; ++nt) {
      if (nt >= nt_end) break;
      uint32_t b[2], bh2[2], bl2[2];
      frag_b_ck(b, bu, ld, nt * 8, k0, g, tq);
      split(__uint_as_float(b[0]), bh2[0], bl2[0]);
      split(__uint_as_float(b[1]), bh2[1], bl2[1]);
      mma3(acc[nt], ah, al, bh2, bl2);
    }
  }

  float* Gc = G + (size_t(grp) * nc + c) * chunk * chunk;
#pragma unroll
  for (int nt = 0; nt < kRT / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = ti * kRT + r0 + g + (e >> 1) * 8;
      const int col = tj * kRT + nt * 8 + 2 * tq + (e & 1);
      if (row < chunk && col < chunk)
        Gc[size_t(row) * chunk + col] = acc[nt][e];
    }
}

// ---------------------------------------------------------------------------
// Register-staged tiles.  A CTA loads the next tile of its loop into
// registers before it multiplies the current one from shared memory, so
// the global loads overlap the products.  A 64 x 64 tile is 32 floats a
// thread at 128 threads (16 at 256), as float4 when VEC (rows 16-byte
// aligned: chunk and P multiples of 4), else as single floats.
// ---------------------------------------------------------------------------

// Element e (0 .. per-1) of this thread's share of a (rows x 64) tile:
// its row and column, for `threads` threads.
template <bool VEC, int THREADS>
__device__ __forceinline__ void tile_rc(int e, int& r, int& c) {
  if (VEC) {
    const int q = threadIdx.x + (e >> 2) * THREADS;
    r = q >> 4;
    c = (q & 15) * 4 + (e & 3);
  } else {
    const int q = threadIdx.x + e * THREADS;
    r = q >> 6;
    c = q & 63;
  }
}

// Load the thread's share of rows [0, rows) of a 64-column tile whose
// element (r, c) is src[r * ld + c]; ok(r, c) says whether it exists
// (zero otherwise; with VEC it is asked for the first of four columns).
template <bool VEC, int THREADS, int PER, typename Ok>
__device__ __forceinline__ void load_tile(float (&v)[PER], const float* src,
                                          size_t ld, Ok ok) {
#pragma unroll
  for (int e = 0; e < PER; e += VEC ? 4 : 1) {
    int r, c;
    tile_rc<VEC, THREADS>(e, r, c);
    if (VEC) {
      const float4 x = ok(r, c) ? ld4(src + r * ld + c)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
      v[e] = x.x;
      v[e + 1] = x.y;
      v[e + 2] = x.z;
      v[e + 3] = x.w;
    } else {
      v[e] = ok(r, c) ? src[r * ld + c] : 0.f;
    }
  }
}

// Split the thread's share, transformed by f(r, c, value), into the hi and
// lo tiles (row stride ld, a multiple of 4): 16-byte stores when VEC.
template <bool VEC, int THREADS, int PER, typename F>
__device__ __forceinline__ void store_tile(uint32_t* hi, uint32_t* lo, int ld,
                                           const float (&v)[PER], F f) {
#pragma unroll
  for (int e = 0; e < PER; e += VEC ? 4 : 1) {
    int r, c;
    tile_rc<VEC, THREADS>(e, r, c);
    if (VEC) {
      split_store4(hi + r * ld + c, lo + r * ld + c,
                   make_float4(f(r, c, v[e]), f(r, c + 1, v[e + 1]),
                               f(r, c + 2, v[e + 2]), f(r, c + 3, v[e + 3])));
    } else {
      split(f(r, c, v[e]), hi[r * ld + c], lo[r * ld + c]);
    }
  }
}

// ---------------------------------------------------------------------------
// 3. states: s_c = B^T (w .* x) per (bh, chunk, P tile).
// ---------------------------------------------------------------------------

constexpr int kStThreads = 256;   // 8 warps of 16 state rows
constexpr int kStB = kSlab * kMaxN / kStThreads;   // B floats a thread
constexpr int kStX = kSlab * kPT / kStThreads;     // x floats a thread

size_t states_smem(int chunk) {
  return (2ull * kSlab * kLdSt + 2ull * kSlab * kLdP + chunk) * 4;
}

template <bool VEC>
__global__ void __launch_bounds__(kStThreads, 3)
ssd_states_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ B, const double* __restrict__ cum,
                  float* __restrict__ states, int S, int P, int N, int rep,
                  int chunk) {
  extern __shared__ uint4 smem_st[];
  uint32_t* bh_s = reinterpret_cast<uint32_t*>(smem_st);
  uint32_t* bl_s = bh_s + kSlab * kLdSt;
  uint32_t* xh_s = bl_s + kSlab * kLdSt;
  uint32_t* xl_s = xh_s + kSlab * kLdP;
  float* wd = reinterpret_cast<float*>(xl_s + kSlab * kLdP);

  const int c = blockIdx.x, nc = gridDim.x;
  const int p0 = blockIdx.y * kPT;
  const int bh = blockIdx.z;
  const size_t row0 = size_t(bh) * S + size_t(c) * chunk;   // (bh, chunk)
  const float* xc = x + row0 * P + p0;
  const float* Bc = B + (size_t(bh / rep) * S + size_t(c) * chunk) * N;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int n0 = warp * 16;

  const double last = cum[row0 + chunk - 1];
  for (int l = tid; l < chunk; l += kStThreads)
    wd[l] = expf(static_cast<float>(last - cum[row0 + l])) * dt[row0 + l];

  // B slab rows as float4 (N is a multiple of 8): element e of the
  // thread's share is row (tid + (e / 4) * 256) / 32, column
  // ((tid + ...) % 32) * 4 + e % 4; columns past N are zero.
  auto load_b = [&](float (&v)[kStB], int l0) {
#pragma unroll
    for (int e = 0; e < kStB; e += 4) {
      const int q = tid + (e >> 2) * kStThreads;
      const int r = q >> 5, n = (q & 31) * 4;
      const float4 b = (l0 + r < chunk && n < N)
                           ? ld4(Bc + size_t(l0 + r) * N + n)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
      v[e] = b.x;
      v[e + 1] = b.y;
      v[e + 2] = b.z;
      v[e + 3] = b.w;
    }
  };
  auto load_x = [&](float (&v)[kStX], int l0) {
    load_tile<VEC, kStThreads>(v, xc + size_t(l0) * P, P, [&](int r, int p) {
      return l0 + r < chunk && p0 + p < P;
    });
  };

  float vb[kStB], vx[kStX];
  load_b(vb, 0);
  load_x(vx, 0);
  float acc[kPT / 8][4] = {};
  for (int l0 = 0; l0 < chunk; l0 += kSlab) {
    __syncthreads();   // previous slab consumed; wd written
#pragma unroll
    for (int e = 0; e < kStB; e += 4) {
      const int q = tid + (e >> 2) * kStThreads;
      const int r = q >> 5, n = (q & 31) * 4;
      split_store4(bh_s + r * kLdSt + n, bl_s + r * kLdSt + n,
                   make_float4(vb[e], vb[e + 1], vb[e + 2], vb[e + 3]));
    }
    store_tile<VEC, kStThreads>(xh_s, xl_s, kLdP, vx,
                                [&](int r, int, float v) {
                                  return l0 + r < chunk ? v * wd[l0 + r]
                                                        : 0.f;
                                });
    if (l0 + kSlab < chunk) {   // the next slab, while this one multiplies
      load_b(vb, l0 + kSlab);
      load_x(vx, l0 + kSlab);
    }
    __syncthreads();
    if (n0 >= N) continue;
#pragma unroll
    for (int k0 = 0; k0 < kSlab; k0 += 8) {
      uint32_t ah[4], al[4];
      frag_a_kr(ah, bh_s, kLdSt, n0, k0, g, tq);
      frag_a_kr(al, bl_s, kLdSt, n0, k0, g, tq);
#pragma unroll
      for (int nt = 0; nt < kPT / 8; ++nt) {
        uint32_t bh2[2], bl2[2];
        frag_b_kc(bh2, xh_s, kLdP, nt * 8, k0, g, tq);
        frag_b_kc(bl2, xl_s, kLdP, nt * 8, k0, g, tq);
        mma3(acc[nt], ah, al, bh2, bl2);
      }
    }
  }
  if (n0 >= N) return;

  float* sc = states + (size_t(bh) * nc + c) * N * P;
#pragma unroll
  for (int nt = 0; nt < kPT / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = n0 + g + (e >> 1) * 8;
      const int p = p0 + nt * 8 + 2 * tq + (e & 1);
      if (n < N && p < P) sc[size_t(n) * P + p] = acc[nt][e];
    }
}

// ---------------------------------------------------------------------------
// 4. pass: the state before each chunk, in place, and the final state.
// ---------------------------------------------------------------------------

constexpr int kPassThreads = 256;
constexpr int kPassAhead = 8;   // chunks whose states are loaded at once

__global__ void __launch_bounds__(kPassThreads)
ssd_pass_kernel(float* __restrict__ states, const double* __restrict__ cum,
                float* __restrict__ final_state, int S, int NP, int chunk,
                int nc) {
  const int e = blockIdx.x * kPassThreads + threadIdx.x;
  const int bh = blockIdx.y;
  if (e >= NP) return;
  float* s = states + size_t(bh) * nc * NP + e;
  const double* cl = cum + size_t(bh) * S + chunk - 1;
  float carry = 0.f;
  for (int c0 = 0; c0 < nc; c0 += kPassAhead) {
    float v[kPassAhead], d[kPassAhead];
#pragma unroll
    for (int k = 0; k < kPassAhead; ++k)
      if (c0 + k < nc) {
        v[k] = s[size_t(c0 + k) * NP];
        d[k] = expf(static_cast<float>(cl[size_t(c0 + k) * chunk]));
      }
#pragma unroll
    for (int k = 0; k < kPassAhead; ++k)
      if (c0 + k < nc) {
        s[size_t(c0 + k) * NP] = carry;
        carry = fmaf(d[k], carry, v[k]);
      }
  }
  final_state[size_t(bh) * NP + e] = carry;
}

// ---------------------------------------------------------------------------
// 5. out: y per (bh, chunk, 64-row tile i, P tile).
// ---------------------------------------------------------------------------
//
// The CTA walks a list of 64-deep items, each an A tile (64 rows x 64 of
// the contraction) and a B tile (64 x 64 columns of P): first the inter
// items (C_i, S_prev over 64 rows of N each; none for the first chunk),
// then, after scaling the accumulators by exp(cum), the intra items
// ((G .* L .* dt) and x_j for j = 0 .. i).

constexpr int kOutThreads = 256;   // 8 warps of 16 rows x 32 columns
constexpr int kOutPer = kRT * kRT / kOutThreads;   // tile floats a thread
constexpr int kOutWords = 2 * kRT * kLdM + 2 * kRT * kLdP;

__host__ __device__ constexpr int out_tiles_offset(int chunk) {
  return (3 * chunk + 3) / 4 * 4;   // cum (f64) and dt of the chunk first
}

size_t out_smem(int chunk) {
  return (size_t(out_tiles_offset(chunk)) + kOutWords) * 4;
}

template <bool VEC>
__global__ void __launch_bounds__(kOutThreads)
ssd_out_kernel(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ C, const double* __restrict__ cum,
               const float* __restrict__ G, const float* __restrict__ states,
               float* __restrict__ y, int S, int P, int N, int rep, int chunk,
               int tiles) {
  extern __shared__ uint4 smem_out[];
  double* cum_s = reinterpret_cast<double*>(smem_out);
  float* dt_s = reinterpret_cast<float*>(cum_s + chunk);
  uint32_t* ah_s = reinterpret_cast<uint32_t*>(smem_out) +
                   out_tiles_offset(chunk);
  uint32_t* al_s = ah_s + kRT * kLdM;
  uint32_t* bh_s = al_s + kRT * kLdM;
  uint32_t* bl_s = bh_s + kRT * kLdP;

  const int c = blockIdx.x / tiles;
  const int i = tiles - 1 - (blockIdx.x - c * tiles);   // longest tiles first
  const int p0 = blockIdx.y * kPT;
  const int bh = blockIdx.z;
  const int nc = S / chunk;
  const int r0 = i * kRT;
  const size_t row0 = size_t(bh) * S + size_t(c) * chunk;   // (bh, chunk)
  const int grp = bh / rep;
  const float* xc = x + row0 * P + p0;
  const float* Cc = C + (size_t(grp) * S + size_t(c) * chunk) * N;
  const float* Gc = G + (size_t(grp) * nc + c) * chunk * chunk;
  const float* sp = states + (size_t(bh) * nc + c) * N * P + p0;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int wr = (warp & 3) * 16, wc = (warp >> 2) * 32;
  const int n_inter = c > 0 ? (N + kRT - 1) / kRT : 0;
  const int n_items = n_inter + i + 1;

  for (int l = tid; l < chunk; l += kOutThreads) {
    cum_s[l] = cum[row0 + l];
    dt_s[l] = dt[row0 + l];
  }

  // Item it into registers: A and B tiles, raw.
  auto load_item = [&](float (&va)[kOutPer], float (&vb)[kOutPer], int it) {
    if (it < n_inter) {
      const int k0 = it * kRT;
      load_tile<true, kOutThreads>(
          va, Cc + size_t(r0) * N + k0, N,
          [&](int r, int n) { return r0 + r < chunk && k0 + n < N; });
      load_tile<VEC, kOutThreads>(
          vb, sp + size_t(k0) * P, P,
          [&](int k, int p) { return k0 + k < N && p0 + p < P; });
    } else {
      const int s0 = (it - n_inter) * kRT;
      // Only the causal part of G (s <= r) is read.
      load_tile<VEC, kOutThreads>(
          va, Gc + size_t(r0) * chunk + s0, chunk, [&](int r, int s) {
            return r0 + r < chunk && s0 + s <= r0 + r;
          });
      load_tile<VEC, kOutThreads>(
          vb, xc + size_t(s0) * P, P,
          [&](int s, int p) { return s0 + s < chunk && p0 + p < P; });
    }
  };

  float va[kOutPer], vb[kOutPer];
  float acc[4][4] = {};   // 4 n8 fragments of the warp's 32 columns
  load_item(va, vb, 0);
  for (int it = 0; it < n_items; ++it) {
    const bool intra = it >= n_inter;
    const int s0 = (it - n_inter) * kRT;   // intra: first column of G
    __syncthreads();   // the tiles free (and cum_s, dt_s written)
    if (intra) {
      // (G .* L .* dt): L = exp(cum_r - cum_s) for s <= r, a select.
      store_tile<VEC, kOutThreads>(
          ah_s, al_s, kLdM, va, [&](int r, int s, float v) {
            const int rr = r0 + r, ss = s0 + s;
            return (ss <= rr && rr < chunk)
                       ? v * expf(static_cast<float>(cum_s[rr] -
                                                     cum_s[ss])) *
                             dt_s[ss]
                       : 0.f;
          });
      store_tile<VEC, kOutThreads>(bh_s, bl_s, kLdP, vb,
                                   [](int, int, float v) { return v; });
    } else {
      store_tile<true, kOutThreads>(ah_s, al_s, kLdM, va,
                                    [](int, int, float v) { return v; });
      store_tile<VEC, kOutThreads>(bh_s, bl_s, kLdP, vb,
                                   [](int, int, float v) { return v; });
    }
    if (it + 1 < n_items) load_item(va, vb, it + 1);
    __syncthreads();
    if (it == n_inter && n_inter > 0) {
      // inter done: y = exp(cum) .* (C S_prev) so far.
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r0 + wr + g + half * 8;
        const float e = r < chunk ? expf(static_cast<float>(cum_s[r])) : 0.f;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          acc[nt][half * 2] *= e;
          acc[nt][half * 2 + 1] *= e;
        }
      }
    }
    // Depth of the item: N's rows left (inter), the warp's last row on the
    // diagonal tile (intra, j = i), else 64.
    const int k_end = !intra ? min(kRT, N - it * kRT)
                      : s0 == r0 ? wr + 16 : kRT;
    for (int k0 = 0; k0 < k_end; k0 += 8) {
      uint32_t ah[4], al[4];
      frag_a_rk(ah, ah_s, kLdM, wr, k0, g, tq);
      frag_a_rk(al, al_s, kLdM, wr, k0, g, tq);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        uint32_t bh2[2], bl2[2];
        frag_b_kc(bh2, bh_s, kLdP, wc + nt * 8, k0, g, tq);
        frag_b_kc(bl2, bl_s, kLdP, wc + nt * 8, k0, g, tq);
        mma3(acc[nt], ah, al, bh2, bl2);
      }
    }
  }

  float* yc = y + row0 * P + p0;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + wr + g + (e >> 1) * 8;
      const int p = wc + nt * 8 + 2 * tq + (e & 1);
      if (r < chunk && p0 + p < P) yc[size_t(r) * P + p] = acc[nt][e];
    }
}

cudaError_t set_smem(const void* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

// x, y: (BH, S, P); dt: (BH, S); A: (BH,); B, C: (BH / rep, S, N);
// final_state: (BH, N, P).  Workspaces: cum (BH, S) f64, G (BH / rep,
// S / chunk, chunk, chunk) f32, states (BH, S / chunk, N, P) f32.  All
// contiguous, on the stream's device; B and C 16-byte aligned; S a
// multiple of chunk, chunk <= 1024, N a multiple of 8 and at most 128,
// BH at most 65535.  Five launches on the stream; returns the first
// nonzero cudaError_t (0 on success).
extern "C" int repro_ssd_scan_f32(const void* x, const void* dt,
                                  const void* A, const void* B, const void* C,
                                  void* y, void* final_state, void* cum,
                                  void* G, void* states, int BH, int S, int P,
                                  int N, int rep, int chunk, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nc = S / chunk;
  const int tiles = (chunk + kRT - 1) / kRT;
  const int ptiles = (P + kPT - 1) / kPT;
  const auto* xf = static_cast<const float*>(x);
  const auto* dtf = static_cast<const float*>(dt);
  const auto* Bf = static_cast<const float*>(B);
  const auto* Cf = static_cast<const float*>(C);
  auto* cumd = static_cast<double*>(cum);
  auto* Gf = static_cast<float*>(G);
  auto* sf = static_cast<float*>(states);
  cudaError_t err;
  // float4 rows of x, y and the states when P (and for G, chunk) allow.
  const bool vec_p = P % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vec_out = vec_p && chunk % 4 == 0;
  const auto states_k = vec_p ? ssd_states_kernel<true>
                              : ssd_states_kernel<false>;
  const auto out_k = vec_out ? ssd_out_kernel<true> : ssd_out_kernel<false>;
  if ((err = set_smem(reinterpret_cast<const void*>(ssd_cb_kernel),
                      cb_smem(N))) != cudaSuccess ||
      (err = set_smem(reinterpret_cast<const void*>(states_k),
                      states_smem(chunk))) != cudaSuccess ||
      (err = set_smem(reinterpret_cast<const void*>(out_k),
                      out_smem(chunk))) != cudaSuccess)
    return static_cast<int>(err);

  ssd_cum_kernel<<<dim3(nc, BH), kCumThreads, 0, st>>>(
      dtf, static_cast<const float*>(A), cumd, S, chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  const int pairs = tiles * (tiles + 1) / 2;
  ssd_cb_kernel<<<dim3(pairs * nc, BH / rep), kCbThreads, cb_smem(N), st>>>(
      Bf, Cf, Gf, S, N, chunk, pairs);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  states_k<<<dim3(nc, ptiles, BH), kStThreads, states_smem(chunk), st>>>(
      xf, dtf, Bf, cumd, sf, S, P, N, rep, chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  const int np = N * P;
  ssd_pass_kernel<<<dim3((np + kPassThreads - 1) / kPassThreads, BH),
                    kPassThreads, 0, st>>>(sf, cumd,
                                           static_cast<float*>(final_state),
                                           S, np, chunk, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  out_k<<<dim3(nc * tiles, ptiles, BH), kOutThreads, out_smem(chunk), st>>>(
      xf, dtf, Cf, cumd, Gf, sf, static_cast<float*>(y), S, P, N, rep, chunk,
      tiles);
  return static_cast<int>(cudaGetLastError());
}
