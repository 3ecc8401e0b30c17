// Fused additive-Schwarz step of the DD-KF solve on Hopper (sm_90a).
//
// Replaces: src/repro/kernels/schwarz_step.py `schwarz_fwd` (`_fwd_kernel`)
// and `schwarz_bwd` (`_bwd_kernel`), the Pallas TPU kernels that run every
// Schwarz iteration.  Per subdomain i, with A_i the (m, w) local column
// block:
//
//   forward:  y_i = A_i (x_i * wdiv_i),  u_i = A_i x_i       (one pass)
//   backward: rhs_i = (A_i^T (r * (b - Ax + u_i)) + muov_i * x_i) * mask_i
//
// Bound on this card: bytes.  Each half reads A once (8*p*m*w bytes in
// f64, ~650 MB at the paper size, ~0.19 ms at 3.35 TB/s) and does 2 flops
// per element and product: 0.5 flop/byte forward (two products), 0.25
// backward, far below the ~20 flop/byte where 67 TFLOP/s of f64 would
// take over from 3.35 TB/s.
//
// Design, forward: one block per (subdomain i, chunk of 64 rows).  The
// block stages xs = [x_i * wdiv_i, x_i] (2w values) in shared memory once;
// each warp then takes one row of A_i at a time, its lanes read the row
// coalesced along w, and both dot products are reduced by warp shuffles,
// so y and u come out of one pass over A.
//
// Design, backward: threads run along w (coalesced: consecutive lanes read
// consecutive columns of a row).  One block per (subdomain i, 256-column
// tile, m-split s) walks a fixed chunk of ceil(m / kSplits) rows; the
// residual weights t = r * (b - Ax + u_i) of the chunk are formed in
// shared memory as the block goes and never written out.  Each block
// stores its partial column sums into a (p, kSplits, w) scratch, and a
// second small launch adds the kSplits partials in a fixed order and
// applies + muov * x and * mask.  No float atomics anywhere: the result is
// bitwise the same on every run, as the fleet path's "fleet == standalone"
// guarantee will need.  No TMA or vector loads yet.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kFwdThreads = 256;  // 8 warps, one row of A at a time each
constexpr int kFwdRows = 64;      // rows of A_i per forward block
constexpr int kBwdThreads = 256;  // columns per backward block
constexpr int kBwdStage = 256;    // residual weights staged at a time
constexpr int kSplits = 32;       // fixed m-splits of the backward pass

template <typename T>
__global__ void __launch_bounds__(kFwdThreads)
schwarz_fwd_kernel(const T* __restrict__ A, const T* __restrict__ x,
                   const T* __restrict__ wdiv, T* __restrict__ y,
                   T* __restrict__ u, int m, int w) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);  // [0, w): x*wdiv, [w, 2w): x
  const size_t i = blockIdx.y;
  const T* xi = x + i * w;
  const T* wi = wdiv + i * w;
  for (int c = threadIdx.x; c < w; c += blockDim.x) {
    const T xv = xi[c];
    xs[c] = xv * wi[c];
    xs[w + c] = xv;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int r0 = blockIdx.x * kFwdRows;
  const int r1 = min(m, r0 + kFwdRows);
  const T* Ai = A + i * static_cast<size_t>(m) * w;
  for (int row = r0 + warp; row < r1; row += nwarps) {
    const T* a = Ai + static_cast<size_t>(row) * w;
    T sy = T(0), su = T(0);
#pragma unroll 4
    for (int c = lane; c < w; c += 32) {
      const T av = a[c];
      sy += av * xs[c];
      su += av * xs[w + c];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sy += __shfl_down_sync(0xffffffffu, sy, off);
      su += __shfl_down_sync(0xffffffffu, su, off);
    }
    if (lane == 0) {
      y[i * m + row] = sy;
      u[i * m + row] = su;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
schwarz_bwd_partial_kernel(const T* __restrict__ A, const T* __restrict__ r,
                           const T* __restrict__ b, const T* __restrict__ Ax,
                           const T* __restrict__ u, T* __restrict__ part,
                           int m, int w, int rows_per_split) {
  __shared__ T ts[kBwdStage];
  const size_t i = blockIdx.z;
  const int s = blockIdx.y;
  const int col = blockIdx.x * kBwdThreads + threadIdx.x;
  const int r0 = s * rows_per_split;
  const int r1 = min(m, r0 + rows_per_split);
  const T* Ai = A + i * static_cast<size_t>(m) * w;
  const T* ui = u + i * static_cast<size_t>(m);
  T acc = T(0);
  for (int k0 = r0; k0 < r1; k0 += kBwdStage) {
    const int kn = min(kBwdStage, r1 - k0);
    __syncthreads();
    for (int e = threadIdx.x; e < kn; e += kBwdThreads) {
      const int k = k0 + e;
      ts[e] = r[k] * (b[k] - Ax[k] + ui[k]);
    }
    __syncthreads();
    if (col < w) {
      const T* a = Ai + static_cast<size_t>(k0) * w + col;
#pragma unroll 4
      for (int e = 0; e < kn; ++e) acc += ts[e] * a[static_cast<size_t>(e) * w];
    }
  }
  if (col < w) part[(i * kSplits + s) * static_cast<size_t>(w) + col] = acc;
}

template <typename T>
__global__ void schwarz_bwd_finish_kernel(const T* __restrict__ part,
                                          const T* __restrict__ x,
                                          const T* __restrict__ muov,
                                          const T* __restrict__ mask,
                                          T* __restrict__ out, int w) {
  const size_t i = blockIdx.y;
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= w) return;
  const T* pi = part + i * kSplits * static_cast<size_t>(w) + col;
  T acc = T(0);
  for (int s = 0; s < kSplits; ++s) acc += pi[static_cast<size_t>(s) * w];
  const size_t o = i * w + col;
  out[o] = (acc + muov[o] * x[o]) * mask[o];
}

template <typename T>
int launch_fwd(const void* A, const void* x, const void* wdiv, void* y,
               void* u, int p, int m, int w, void* stream) {
  const size_t smem = 2 * static_cast<size_t>(w) * sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        schwarz_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((m + kFwdRows - 1) / kFwdRows, p);
  schwarz_fwd_kernel<T><<<grid, kFwdThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(A), static_cast<const T*>(x),
      static_cast<const T*>(wdiv), static_cast<T*>(y), static_cast<T*>(u), m,
      w);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* A, const void* r, const void* b, const void* Ax,
               const void* u, const void* x, const void* muov,
               const void* mask, void* part, void* out, int p, int m, int w,
               void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int col_tiles = (w + kBwdThreads - 1) / kBwdThreads;
  const int rows_per_split = (m + kSplits - 1) / kSplits;
  schwarz_bwd_partial_kernel<T><<<dim3(col_tiles, kSplits, p), kBwdThreads,
                                   0, st>>>(
      static_cast<const T*>(A), static_cast<const T*>(r),
      static_cast<const T*>(b), static_cast<const T*>(Ax),
      static_cast<const T*>(u), static_cast<T*>(part), m, w, rows_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  schwarz_bwd_finish_kernel<T><<<dim3(col_tiles, p), kBwdThreads, 0, st>>>(
      static_cast<const T*>(part), static_cast<const T*>(x),
      static_cast<const T*>(muov), static_cast<const T*>(mask),
      static_cast<T*>(out), w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The m-splits of the backward pass: the scratch the caller allocates is
// (p, repro_schwarz_bwd_splits(), w) of the input type.
extern "C" int repro_schwarz_bwd_splits() { return kSplits; }

// A (p, m, w), x/wdiv (p, w) -> y, u (p, m).  Returns the cudaError_t.
extern "C" int repro_schwarz_fwd_f64(const void* A, const void* x,
                                     const void* wdiv, void* y, void* u,
                                     int p, int m, int w, void* stream) {
  return launch_fwd<double>(A, x, wdiv, y, u, p, m, w, stream);
}

extern "C" int repro_schwarz_fwd_f32(const void* A, const void* x,
                                     const void* wdiv, void* y, void* u,
                                     int p, int m, int w, void* stream) {
  return launch_fwd<float>(A, x, wdiv, y, u, p, m, w, stream);
}

// A (p, m, w), r/b/Ax (m,), u (p, m), x/muov/mask (p, w), part scratch
// (p, splits, w) -> out (p, w).  Returns the cudaError_t.
extern "C" int repro_schwarz_bwd_f64(const void* A, const void* r,
                                     const void* b, const void* Ax,
                                     const void* u, const void* x,
                                     const void* muov, const void* mask,
                                     void* part, void* out, int p, int m,
                                     int w, void* stream) {
  return launch_bwd<double>(A, r, b, Ax, u, x, muov, mask, part, out, p, m, w,
                            stream);
}

extern "C" int repro_schwarz_bwd_f32(const void* A, const void* r,
                                     const void* b, const void* Ax,
                                     const void* u, const void* x,
                                     const void* muov, const void* mask,
                                     void* part, void* out, int p, int m,
                                     int w, void* stream) {
  return launch_bwd<float>(A, r, b, Ax, u, x, muov, mask, part, out, p, m, w,
                           stream);
}
