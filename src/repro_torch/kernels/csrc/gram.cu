// Batched weighted Gram matrix N_i = A_i^T diag(r_i) A_i on Hopper (sm_90a).
//
// Replaces: src/repro/kernels/gram.py `gram` (`_gram_kernel`), the Pallas
// TPU kernel that builds every subdomain's local normal matrix for the
// DD-KF setup (paper eq. 27).  On the TPU its grid walks m in order and
// carries a (w, w) VMEM accumulator in f32, even for f64 inputs.
//
// Bound on this card: operations.  A is (p, m, w), N is (p, w, w); the
// symmetric product needs p*m*w*(w+1) flops against 8*p*m*w bytes of A
// (f64).  At the paper size (p = 8, m = 6094, w = 1553) that is ~1.2e11
// flops over ~606 MB: ~1.8 ms at the 67 TFLOP/s f64 tensor-core peak
// against ~0.2 ms of HBM traffic, so the f64 tensor cores set the floor.
//
// f64 design (the DA path): the f64 tensor cores (DMMA) through
// mma.sync.m16n8k8.f64, Hopper's only f64 matrix instruction (wgmma has no
// f64 form).  The m8n8k4 shape of sm_80 issues more slowly than the
// sm_90 shapes on this card, so m16n8k8 is used, with f64 accumulators in
// registers.
// * One CTA of 8 warps per (subdomain i, 128 x 128 output tile), for the
//   upper-triangle tiles only (ti <= tj), so no CTA computes a tile whose
//   transpose another CTA also computes.  Each warp owns a 64 x 32
//   sub-tile (4 x 4 m16n8 fragments, 64 f64 accumulators a thread); warps
//   whose sub-tile lies wholly below the diagonal or past w skip the
//   products.  A 128-column tile halves the L2 traffic per flop of a
//   64 x 64 tile; a diagonal tile loads its one column tile once.
// * A is streamed over m in 16-row slabs through a 6-stage ring in shared
//   memory: the next five slabs load while the current one multiplies.
//   The loads are the bound next to the products (a CTA reads 32 KB of A
//   from L2 per 2048 flops a thread) and are latency-bound, hence the deep
//   ring.  Copying with 8-byte cp.async kept every warp issuing copies
//   instead of products, so one lane per row issues a single bulk copy
//   (the TMA engine without a tensor map, which the row stride of odd w
//   rules out) that completes on the stage's mbarrier; rows of A start on
//   8-byte boundaries only, so a row lands shifted by the parity of its
//   first element (issue_slab).  Ragged m edges are zero-filled; ragged w
//   edges only feed rows and columns of N past w, which are not written.
//   The warps take turns issuing and release each stage on an mbarrier,
//   with no CTA-wide barrier in the loop.
// * Slab rows are 132 doubles apart (4 mod 16), so the fragment loads,
//   4 rows x 4 columns per half-warp, hit 16 distinct 8-byte bank pairs
//   (for odd w through the column map of gram_f64_kernel).
// * r scales the left operand once, as its fragment is read from shared
//   memory; A is read from device memory once per tile pair, as before.
// * Each element with row <= col is written by exactly one thread, with
//   its mirror (col, row); every sum runs in a fixed order with no atomics,
//   so two runs give bitwise equal outputs.
//
// f32 design: exact f32 FMA (no TF32: it would not hold f32's 1e-4
// relative tolerance at m ~ 6000), 64 x 64 tiles, 256 threads each
// accumulating a 4 x 4 micro-tile over 16-row chunks staged synchronously
// through shared memory.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

// Tile pair t of the upper triangle, enumerated row by row: tile row ti
// holds (tiles - ti) pairs.
__device__ __forceinline__ void tile_pair(int t, int tiles, int& ti,
                                          int& tj) {
  ti = 0;
  while (t >= tiles - ti) {
    t -= tiles - ti;
    ++ti;
  }
  tj = ti + t;
}

// ---------------------------------------------------------------------------
// f64 on the tensor cores.
// ---------------------------------------------------------------------------

constexpr int kT64 = 128;          // edge of one output tile of N_i
constexpr int kK64 = 16;           // rows of A per slab
constexpr int kStages = 6;         // slabs in flight
constexpr int kLd64 = kT64 + 4;    // slab row stride, in doubles (4 mod 16)
constexpr int kThreads64 = 256;    // 8 warps: 2 (rows) x 4 (columns)
constexpr int kWarpRows = 64;
constexpr int kWarpCols = 32;
constexpr int kRSlab = 24;         // r slab (16 rows, shifted by <= 1)
// One stage: the left and right column tiles of a slab, then r.
constexpr int kStage64 = 2 * kK64 * kLd64 + kRSlab;
constexpr size_t kSmem64 =
    size_t(kStages) * kStage64 * sizeof(double) +
    2 * kStages * sizeof(uint64_t);   // full and empty barriers

__device__ __forceinline__ void mma_f64(double (&d)[4], const double (&a)[4],
                                        const double (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count));
}

// Arrive on the stage's barrier and add `bytes` to the transfers it awaits.
__device__ __forceinline__ void bar_arrive_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Arrive once every cp.async this thread issued has landed.
__device__ __forceinline__ void bar_arrive_cp(uint64_t* bar) {
  asm volatile(
      "cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
          smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Bulk copy (the TMA engine, no tensor map) of `bytes` from global to
// shared memory, completing on `bar`; both addresses 16-byte aligned.
__device__ __forceinline__ void bulk_copy(double* dst, const double* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// 8 bytes from global to shared memory, zero-filled when !valid.
__device__ __forceinline__ void cp_async8(double* dst, const double* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 8 : 0));
}

// Issued by warp 0 for slab k0 .. k0+15 into one stage.  Lane l copies
// row k0 + l % 16 of the left (l < 16) or right column tile with one bulk
// copy: from the 16-byte boundary at or below the tile's first column to
// the one at or above its last column inside w.  Bulk copies need 16-byte
// alignment and rows of A start on 8-byte boundaries only (w is odd at the
// paper size), so column c of the row lands at c - c0 + phi, phi = the
// parity of the row's first element.  Reading to the aligned boundaries
// never leaves the 16 bytes that hold a wanted element, except at the end
// of A when p m w is odd: there the last element is copied alone with an
// 8-byte cp.async, so nothing past A is read.  Rows past m are
// zero-filled; r is staged with 8-byte cp.async (zero past m) at the same
// parity shift as rows of r.
__device__ __forceinline__ void issue_slab(double* stage, uint64_t* bar,
                                           const double* Ai, const double* ri,
                                           size_t a0, size_t r0, int k0,
                                           int m, int w, int c0, int d0,
                                           bool diag, int lane) {
  const int side = lane >> 4, kk = lane & 15;
  const int row = k0 + kk;
  const int cx = side ? d0 : c0;
  double* dst = stage + (side * kK64 + kk) * kLd64;
  const bool copy = row < m && !(diag && side);
  int bytes = 0;
  bool tail = false;   // the last element of A, copied alone
  size_t e0 = 0;
  if (copy) {
    e0 = a0 + size_t(row) * w + cx;        // element offset from A
    size_t e1 = e0 + (min(cx + kT64, w) - cx);
    e0 &= ~size_t(1);
    tail = (e1 & 1) && e1 == size_t(gridDim.y) * m * w;
    e1 = tail ? e1 - 1 : (e1 + 1) & ~size_t(1);
    bytes = static_cast<int>(e1 - e0) * 8;
  } else if (row >= m) {
    for (int c = 0; c < kLd64; ++c) dst[c] = 0.0;
  }
  if (lane < kK64)   // row k0 + lane at slot (r0 & 1) + lane (k0 is even)
    cp_async8(stage + 2 * kK64 * kLd64 + (r0 & 1) + lane,
              k0 + lane < m ? ri + k0 + lane : ri, k0 + lane < m);
  if (tail) cp_async8(dst + bytes / 8, Ai - a0 + e0 + bytes / 8, true);
  int tx = bytes;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    tx += __shfl_xor_sync(0xffffffffu, tx, off);
  __syncwarp();
  if (lane == 0) bar_arrive_tx(bar, tx);
  __syncwarp();
  if (bytes) bulk_copy(dst, Ai - a0 + e0, bytes, bar);
  bar_arrive_cp(bar);
}

// ODD: w is odd, so the parity shift alternates between neighbouring rows.
// The fragment rows (columns) g and g + 8 then read tile columns 2g and
// 2g + 1, which keeps the fragment loads, 4 rows x 4 columns per half-warp
// with alternating shifts, on 16 distinct 8-byte bank pairs.  Otherwise
// every row has the same shift and g reads column g.
template <bool ODD>
__global__ void __launch_bounds__(kThreads64, 1)
gram_f64_kernel(const double* __restrict__ A, const double* __restrict__ r,
                double* __restrict__ N, int m, int w, int tiles) {
  extern __shared__ double smem64[];
  // full[s]: slab landed in stage s; empty[s]: all 8 warps done with it.
  uint64_t* full = reinterpret_cast<uint64_t*>(smem64 + kStages * kStage64);
  uint64_t* empty = full + kStages;
  int ti, tj;
  tile_pair(blockIdx.x, tiles, ti, tj);
  const size_t i = blockIdx.y;
  const size_t a0 = i * static_cast<size_t>(m) * w;   // A_i's first element
  const size_t r0 = i * static_cast<size_t>(m);
  const double* Ai = A + a0;
  const double* ri = r + r0;
  double* Ni = N + i * static_cast<size_t>(w) * w;
  const int c0 = ti * kT64;   // first row of the tile in N_i
  const int d0 = tj * kT64;   // first column
  const bool diag = ti == tj;  // one column tile serves both sides

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr = (warp >> 2) * kWarpRows;   // warp's rows in the tile
  const int wc = (warp & 3) * kWarpCols;    // warp's columns
  // Products only where some element of the sub-tile is written.
  const bool active = c0 + wr < w && d0 + wc < w &&
                      c0 + wr <= d0 + wc + kWarpCols - 1;
  // Parity shifts of this thread's slab rows (k0 + ks + t, + 4 with k0 and
  // ks even) and of r.
  const int phi = static_cast<int>((a0 + size_t(t) * w) & 1);
  const int phr = static_cast<int>(r0 & 1);
  // Tile column of fragment row g (+8) and of fragment column n.
  const int ra = ODD ? 2 * g : g, rb = ODD ? 2 * g + 1 : g + 8;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      bar_init(full + s, 33);   // the issuing lane's expect_tx + 32 cp.async
      bar_init(empty + s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  double acc[4][4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][b][c] = 0.0;

  const int slabs = (m + kK64 - 1) / kK64;
  if (warp == 0)
    for (int s = 0; s < kStages - 1 && s < slabs; ++s)
      issue_slab(smem64 + s * kStage64, full + s, Ai, ri, a0, r0, s * kK64,
                 m, w, c0, d0, diag, lane);

  // The warps take turns to issue the slab kStages - 1 ahead, into the
  // stage of slab kb - 1 once every warp has released it; no CTA-wide
  // barrier, so a warp may run ahead while others still multiply.
  for (int kb = 0; kb < slabs; ++kb) {
    const int next = kb + kStages - 1;
    if (warp == kb % 8 && next < slabs) {
      if (kb > 0)
        bar_wait(empty + (kb - 1) % kStages, ((kb - 1) / kStages) & 1);
      issue_slab(smem64 + (next % kStages) * kStage64, full + next % kStages,
                 Ai, ri, a0, r0, next * kK64, m, w, c0, d0, diag, lane);
    }
    bar_wait(full + kb % kStages, (kb / kStages) & 1);
    if (active) {
      const double* Ls = smem64 + (kb % kStages) * kStage64;  // left, [k][c]
      const double* Rs = diag ? Ls : Ls + kK64 * kLd64;        // right
      const double* rs = Ls + 2 * kK64 * kLd64 + phr;
#pragma unroll
      for (int ks = 0; ks < kK64; ks += 8) {
        const double r0v = rs[ks + t], r1v = rs[ks + t + 4];
        const double* l0 = Ls + (ks + t) * kLd64 + phi + wr;
        const double* l1 = l0 + 4 * kLd64;
        const double* b0 = Rs + (ks + t) * kLd64 + phi + wc;
        const double* b1 = b0 + 4 * kLd64;
        double bf[4][2];
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int col =
              ODD ? (ni >> 1) * 16 + 2 * g + (ni & 1) : ni * 8 + g;
          bf[ni][0] = b0[col];
          bf[ni][1] = b1[col];
        }
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          // A operand (row-major 16 x 8): rows = output rows, k = slab row.
          const double af[4] = {
              l0[mi * 16 + ra] * r0v, l0[mi * 16 + rb] * r0v,
              l1[mi * 16 + ra] * r1v, l1[mi * 16 + rb] * r1v};
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) mma_f64(acc[mi][ni], af, bf[ni]);
        }
      }
    }
    __syncwarp();
    if (lane == 0) bar_arrive(empty + kb % kStages);
  }

  if (!active) return;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = c0 + wr + mi * 16 + (half ? rb : ra);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = 2 * t + e;
          const int col = d0 + wc +
                          (ODD ? (ni >> 1) * 16 + 2 * n + (ni & 1)
                               : ni * 8 + n);
          if (row < w && col < w && row <= col) {
            const double v = acc[mi][ni][half * 2 + e];
            Ni[static_cast<size_t>(row) * w + col] = v;
            Ni[static_cast<size_t>(col) * w + row] = v;
          }
        }
    }
}

// ---------------------------------------------------------------------------
// f32 in exact FMA.
// ---------------------------------------------------------------------------

constexpr int kTile = 64;      // edge of one output tile of N_i
constexpr int kChunk = 16;     // rows of A staged per shared-memory step
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kMicro = 4;      // each thread owns a kMicro x kMicro tile

__global__ void __launch_bounds__(kThreads)
gram_f32_kernel(const float* __restrict__ A, const float* __restrict__ r,
                float* __restrict__ N, int m, int w, int tiles) {
  int ti, tj;
  tile_pair(blockIdx.x, tiles, ti, tj);
  const size_t i = blockIdx.y;
  const float* Ai = A + i * static_cast<size_t>(m) * w;
  const float* ri = r + i * static_cast<size_t>(m);
  float* Ni = N + i * static_cast<size_t>(w) * w;
  const int c0 = ti * kTile;  // first row of the tile in N_i
  const int d0 = tj * kTile;  // first column

  __shared__ float As[kChunk][kTile];  // r-scaled A columns c0 .. c0+63
  __shared__ float Bs[kChunk][kTile];  // A columns d0 .. d0+63

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  float acc[kMicro][kMicro];
#pragma unroll
  for (int q = 0; q < kMicro; ++q)
#pragma unroll
    for (int s = 0; s < kMicro; ++s) acc[q][s] = 0.f;

  for (int k0 = 0; k0 < m; k0 += kChunk) {
    for (int e = threadIdx.x; e < kChunk * kTile; e += kThreads) {
      const int kk = e / kTile;
      const int cc = e % kTile;
      const int row = k0 + kk;
      float a = 0.f, b = 0.f;
      if (row < m) {
        const float* arow = Ai + static_cast<size_t>(row) * w;
        if (c0 + cc < w) a = arow[c0 + cc] * ri[row];
        if (d0 + cc < w) b = arow[d0 + cc];
      }
      As[kk][cc] = a;
      Bs[kk][cc] = b;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kChunk; ++kk) {
      float a[kMicro], b[kMicro];
#pragma unroll
      for (int q = 0; q < kMicro; ++q) {
        a[q] = As[kk][ty + 16 * q];
        b[q] = Bs[kk][tx + 16 * q];
      }
#pragma unroll
      for (int q = 0; q < kMicro; ++q)
#pragma unroll
        for (int s = 0; s < kMicro; ++s) acc[q][s] += a[q] * b[s];
    }
    __syncthreads();
  }

#pragma unroll
  for (int q = 0; q < kMicro; ++q) {
    const int row = c0 + ty + 16 * q;
#pragma unroll
    for (int s = 0; s < kMicro; ++s) {
      const int col = d0 + tx + 16 * s;
      if (row < w && col < w && row <= col) {
        Ni[static_cast<size_t>(row) * w + col] = acc[q][s];
        Ni[static_cast<size_t>(col) * w + row] = acc[q][s];
      }
    }
  }
}

}  // namespace

// A (p, m, w), r (p, m) -> N (p, w, w); all contiguous, on the stream's
// device.  Returns the cudaError_t of the launch (0 on success).
// f64: A and r 16-byte aligned.
extern "C" int repro_gram_f64(const void* A, const void* r, void* N, int p,
                              int m, int w, void* stream) {
  const auto kernel = w % 2 ? gram_f64_kernel<true> : gram_f64_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmem64));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (w + kT64 - 1) / kT64;
  const dim3 grid(tiles * (tiles + 1) / 2, p);
  kernel<<<grid, kThreads64, kSmem64, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(A), static_cast<const double*>(r),
      static_cast<double*>(N), m, w, tiles);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_gram_f32(const void* A, const void* r, void* N, int p,
                              int m, int w, void* stream) {
  const int tiles = (w + kTile - 1) / kTile;
  const dim3 grid(tiles * (tiles + 1) / 2, p);
  gram_f32_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(A), static_cast<const float*>(r),
      static_cast<float*>(N), m, w, tiles);
  return static_cast<int>(cudaGetLastError());
}
