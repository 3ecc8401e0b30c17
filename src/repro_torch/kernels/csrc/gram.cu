// Batched weighted Gram matrix N_i = A_i^T diag(r_i) A_i on Hopper (sm_90a).
//
// Replaces: src/repro/kernels/gram.py `gram` (`_gram_kernel`), the Pallas
// TPU kernel that builds every subdomain's local normal matrix for the
// DD-KF setup (paper eq. 27).  On the TPU its grid walks m in order and
// carries a (w, w) VMEM accumulator in f32, even for f64 inputs.
//
// Bound on this card: operations.  A is (p, m, w), N is (p, w, w); the
// symmetric product needs p*m*w*(w+1) flops against 8*p*m*w bytes of A
// (f64).  At the paper size (p = 8, m = 6094, w ~ 1660) that is ~1.3e11
// flops over ~650 MB: ~2 ms at the 67 TFLOP/s f64 peak against ~0.2 ms
// of HBM traffic, so the FP64 pipes, not memory, set the floor.
//
// Design: one thread block per (subdomain i, 64 x 64 output tile) for the
// upper-triangle tiles only (ti <= tj), so no block computes a tile whose
// transpose another block also computes.  The block loops over m in
// chunks of 16 rows staged through shared memory (r is applied to the
// row-tile copy as it is staged), and each of its 256 threads accumulates
// a 4 x 4 micro-tile in registers, in the input type: f64 inputs
// accumulate in f64 (the Pallas kernel used f32).  Threads take strided
// micro-tile rows/columns so a warp reads consecutive shared-memory words
// (no bank conflicts).  Ragged m and w edges are masked to zero while
// staging and on the write.  Each element with row <= col is written by
// exactly one thread, together with its mirror (col, row): there are no
// atomics and the result is the same on every run.  No tensor cores,
// TMA or software pipelining yet — a correct simple kernel first.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kTile = 64;      // edge of one output tile of N_i
constexpr int kChunk = 16;     // rows of A staged per shared-memory step
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kMicro = 4;      // each thread owns a kMicro x kMicro tile

template <typename T>
__global__ void __launch_bounds__(kThreads)
gram_kernel(const T* __restrict__ A, const T* __restrict__ r,
            T* __restrict__ N, int m, int w, int tiles) {
  // blockIdx.x enumerates the upper-triangle tile pairs of one subdomain
  // row by row: tile row ti holds (tiles - ti) pairs.
  int t = blockIdx.x;
  int ti = 0;
  while (t >= tiles - ti) {
    t -= tiles - ti;
    ++ti;
  }
  const int tj = ti + t;
  const size_t i = blockIdx.y;
  const T* Ai = A + i * static_cast<size_t>(m) * w;
  const T* ri = r + i * static_cast<size_t>(m);
  T* Ni = N + i * static_cast<size_t>(w) * w;
  const int c0 = ti * kTile;  // first row of the tile in N_i
  const int d0 = tj * kTile;  // first column

  __shared__ T As[kChunk][kTile];  // r-scaled A columns c0 .. c0+63
  __shared__ T Bs[kChunk][kTile];  // A columns d0 .. d0+63

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  T acc[kMicro][kMicro];
#pragma unroll
  for (int q = 0; q < kMicro; ++q)
#pragma unroll
    for (int s = 0; s < kMicro; ++s) acc[q][s] = T(0);

  for (int k0 = 0; k0 < m; k0 += kChunk) {
    for (int e = threadIdx.x; e < kChunk * kTile; e += kThreads) {
      const int kk = e / kTile;
      const int cc = e % kTile;
      const int row = k0 + kk;
      T a = T(0), b = T(0);
      if (row < m) {
        const T* arow = Ai + static_cast<size_t>(row) * w;
        if (c0 + cc < w) a = arow[c0 + cc] * ri[row];
        if (d0 + cc < w) b = arow[d0 + cc];
      }
      As[kk][cc] = a;
      Bs[kk][cc] = b;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kChunk; ++kk) {
      T a[kMicro], b[kMicro];
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

template <typename T>
int launch_gram(const void* A, const void* r, void* N, int p, int m, int w,
                void* stream) {
  const int tiles = (w + kTile - 1) / kTile;
  const dim3 grid(tiles * (tiles + 1) / 2, p);
  gram_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(A), static_cast<const T*>(r), static_cast<T*>(N),
      m, w, tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// A (p, m, w), r (p, m) -> N (p, w, w); all contiguous, on the stream's
// device.  Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_gram_f64(const void* A, const void* r, void* N, int p,
                              int m, int w, void* stream) {
  return launch_gram<double>(A, r, N, p, m, w, stream);
}

extern "C" int repro_gram_f32(const void* A, const void* r, void* N, int p,
                              int m, int w, void* stream) {
  return launch_gram<float>(A, r, N, p, m, w, stream);
}
