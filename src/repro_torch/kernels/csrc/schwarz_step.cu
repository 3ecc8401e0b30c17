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
// f64: 606 MB at ex4_p8's (8, 6094, 1553), 0.181 ms at 3.35 TB/s; 75.7 MB,
// 0.023 ms, for one subdomain) and does 2 flops per element and product:
// 0.5 flop/byte forward (two products), 0.25 backward, far below the ~20
// flop/byte where 67 TFLOP/s of f64 would take over from 3.35 TB/s.
//
// Design (both kernels).  A CTA is kWarps consumer warps and one producer
// warp, whose one thread streams a range of rows of one subdomain's A_i
// into a ring of kStages stages of shared memory with 1-D bulk copies
// (cp.async.bulk: no registers, completing on the stage's full mbarrier);
// a stage holds as many rows as fit in kStageBytes, one at least, and the
// consumer warps hand it back through its empty mbarrier.  Each launch aims
// at kFill CTAs (two an SM), so one subdomain (a rank's block) fills the
// card as a batch of eight does.  w is often odd (1553: a row of 12424
// bytes) and a view may start on any element, so a row's start is not
// 16-byte aligned as a bulk copy needs: each row is copied from the 16-byte
// granule that holds its first element to the one that holds its last (at
// most 15 bytes more on either side, in the same granules, hence the same
// pages, as the row's own bytes) and read from its start's offset within
// the first granule.
//
// Forward: a CTA takes a chunk of max(kMinRows, m / kFill) rows (23 of
// ex4_p8's 6094: 265 CTAs a subdomain, three resident an SM).  Consumer
// warp k takes the chunk's rows k, k + kWarps, ...; its lanes read a row
// from the stage along w and multiply it with xs = [x*wdiv, x], staged in
// shared memory as pairs once a CTA (read through L1 instead where w is
// too wide for both, `kStageX`): fused multiply-adds in column order
// c = lane, lane + 32, ..., then a shuffle tree.  y and u of a row come
// out of one pass over A, and no row's sums depend on the CTA that takes
// it.
//
// Backward: the rows are cut into parts of clamp(m / kParts, kMinRows,
// kMaxRows) rows, and a CTA takes one part and one row segment: the whole
// row at p = 8, kFill / (p x parts) segments of at least kMinCols columns
// where p x parts CTAs would not fill the card (eight of 195 columns at
// p = 1), and always segments of at most kTileBytes.  The residual weights
// t = r*(b - Ax + u_i) of the part are formed once in shared memory and
// never written out.  A consumer
// thread keeps its columns' sums in registers, fused multiply-adds in row
// order over the part, and writes them into a (p, parts, w) scratch; a
// second launch adds the parts in order and applies + muov*x and * mask.
// No float atomics.
//
// So every sum's order is fixed by (m, w) alone: a subdomain's bits depend
// on neither p, its place in the batch, the grid nor its pointer's
// alignment, and two launches agree bitwise.  The fleet's "each stream
// bitwise its standalone run", the distributed solve's "bitwise the
// batched engine" and the resume's bitwise journal rest on this.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "tma.cuh"

namespace {

constexpr int kWarps = 8;                  // consumer warps a CTA
constexpr int kConsumers = 32 * kWarps;    // consumer threads a CTA
constexpr int kThreads = kConsumers + 32;  // and the producer warp
constexpr int kFill = 264;         // CTAs a launch aims at: 2 x 132 SMs
constexpr int kParts = 32;         // backward parts a subdomain aims at
constexpr int kMinRows = 8;        // rows a chunk or part, at least
constexpr int kMaxRows = 256;      // rows a backward part, at most
constexpr int kMinCols = 32;       // columns a backward row segment, least
constexpr int kStageBytes = 16384; // bytes of rows a stage holds (>= 1 row)
constexpr int kStages = 4;         // stages in the ring
constexpr int kTileBytes = 16384;  // bytes of a backward row segment, most
constexpr int kFinishThreads = 256;
constexpr int kFinishLoads = 8;   // parts a finish thread loads at once
constexpr int kSmemMax = 232448;   // dynamic shared memory a CTA may take
constexpr int kHead = 128;         // the mbarriers, before the ring

static_assert(kMaxRows <= kConsumers, "a consumer thread forms one t");
static_assert(2 * 8 * kStages <= kHead, "the mbarriers fit the head");

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

long long clamp(long long v, long long lo, long long hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// A launch's shape (schwarz_step.fwd_plan and bwd_plan restate it).
struct Plan {
  int rows;        // rows a CTA: forward, a chunk; backward, a part
  int chunks;      // chunks (forward) or parts (backward) a subdomain
  int cols;        // backward: columns a row segment
  int tiles;       // backward: row segments a row
  int stage_rows;  // rows a stage
  int stride;      // bytes a row segment takes in a stage
  int stages;      // stages in the ring (< 1: w too wide, refused)
  bool stage_x;    // forward: xs staged in shared memory
  size_t smem;     // dynamic shared memory
};

// Bytes a row segment of `seg` bytes takes in a stage: its granules.
long long stride_bytes(long long seg) { return cdiv(seg, 16) * 16 + 16; }

// Rows a stage of segments of `seg` bytes, at most `rows` (a CTA's).
long long rows_a_stage(long long seg, int rows) {
  return clamp(kStageBytes / seg, 1, rows);
}

// The ring for row segments of `seg` bytes and P.rows rows a CTA, beside
// `fixed` bytes (the head and what the kernel keeps after the ring).
void ring(Plan& P, long long seg, long long fixed) {
  const long long stride = stride_bytes(seg);
  P.stage_rows = static_cast<int>(rows_a_stage(seg, P.rows));
  const long long slot = P.stage_rows * stride;
  P.stages = static_cast<int>(clamp((kSmemMax - fixed) / slot, 0, kStages));
  P.stride = static_cast<int>(stride > kSmemMax ? 0 : stride);
  P.smem = static_cast<size_t>(fixed + P.stages * slot);
}

// Forward: a CTA a chunk of max(kMinRows, m / kFill) rows, a function of
// m alone.
Plan fwd_plan(int m, int w, int elt) {
  Plan P{};
  P.rows = m / kFill > kMinRows ? m / kFill : kMinRows;
  P.chunks = static_cast<int>(cdiv(m, P.rows));
  const long long seg = static_cast<long long>(w) * elt;
  const long long xs = 2LL * w * elt;   // staged where two stages fit too
  const long long two = 2 * rows_a_stage(seg, P.rows) * stride_bytes(seg);
  P.stage_x = kHead + xs + two <= kSmemMax;
  ring(P, seg, kHead + (P.stage_x ? xs : 0));
  return P;
}

// Backward: parts of clamp(m / kParts, kMinRows, kMaxRows) rows, a
// function of m alone, a CTA a part and a row segment; the segments cut a
// row into `tiles` of at most kTileBytes, and into kFill / (p x parts) (of
// kMinCols columns at least) where p x parts CTAs would not fill the card.
Plan bwd_plan(int p, int m, int w, int elt) {
  Plan P{};
  P.rows = static_cast<int>(clamp(cdiv(m, kParts), kMinRows, kMaxRows));
  P.chunks = static_cast<int>(cdiv(m, P.rows));
  const long long fill = kFill / (static_cast<long long>(p) * P.chunks);
  const long long fewest = cdiv(w, kTileBytes / elt);
  const long long most = cdiv(w, kMinCols);
  const long long tiles = clamp(fill, fewest, most > fewest ? most : fewest);
  P.cols = static_cast<int>(cdiv(w, tiles));
  P.tiles = static_cast<int>(cdiv(w, P.cols));
  const long long seg = static_cast<long long>(P.cols) * elt;
  ring(P, seg, kHead + cdiv(static_cast<long long>(P.rows) * elt, 16) * 16);
  return P;
}

template <typename T>
struct Pair;
template <>
struct Pair<double> {
  using type = double2;
};
template <>
struct Pair<float> {
  using type = float2;
};

__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}
__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}

// The consumer warps' own barrier (the producer warp does not take it).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// The 16-byte granules that hold n elements from p: their first byte and
// their length.
struct Granules {
  const void* src;
  uint32_t bytes;
};

template <typename T>
__device__ __forceinline__ Granules granules(const T* p, int n) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const uintptr_t lo = a & ~uintptr_t(15);
  const uintptr_t hi = (a + static_cast<size_t>(n) * sizeof(T) + 15) &
                       ~uintptr_t(15);
  return {reinterpret_cast<const void*>(lo), static_cast<uint32_t>(hi - lo)};
}

// Where row segment j of a stage starts in shared memory: its granules sit
// at `stage + j * stride`, its first element `g`'s offset into them on.
template <typename T>
__device__ __forceinline__ const T* staged_row(const unsigned char* stage,
                                               int j, int stride,
                                               const T* g) {
  return reinterpret_cast<const T*>(stage + static_cast<size_t>(j) * stride +
                                    (reinterpret_cast<uintptr_t>(g) & 15));
}

// The producer: rows [r0, r1) x columns [c0, c0 + nc) of the row-major
// (m, w) block Ai into the ring, stage s (rows r0 + s * stage_rows, ...) in
// slot s % stages once the consumers have released its previous stage.
template <typename T>
__device__ void produce(const T* Ai, int w, int r0, int r1, int c0, int nc,
                        unsigned char* ring, uint32_t full, uint32_t empty,
                        int stage_rows, int stages, int stride) {
  const int n = (r1 - r0 + stage_rows - 1) / stage_rows;
  const size_t slot = static_cast<size_t>(stage_rows) * stride;
  for (int s = 0; s < n; ++s) {
    const int sl = s % stages;
    if (s >= stages) tma::bar_wait(empty + 8 * sl, (s / stages - 1) & 1);
    const int k0 = r0 + s * stage_rows;
    const int nk = min(stage_rows, r1 - k0);
    uint32_t bytes = 0;
    for (int j = 0; j < nk; ++j)
      bytes += granules(Ai + static_cast<size_t>(k0 + j) * w + c0, nc).bytes;
    tma::bar_arrive_tx(full + 8 * sl, static_cast<int>(bytes));
    unsigned char* dst = ring + sl * slot;
    for (int j = 0; j < nk; ++j) {
      const Granules g =
          granules(Ai + static_cast<size_t>(k0 + j) * w + c0, nc);
      tma::bulk_load(dst + static_cast<size_t>(j) * stride, g.src, g.bytes,
                     full + 8 * sl);
    }
  }
}

template <typename T, bool kStageX>
__global__ void __launch_bounds__(kThreads, 2)
schwarz_fwd_kernel(const T* __restrict__ A, const T* __restrict__ x,
                   const T* __restrict__ wdiv, T* __restrict__ y,
                   T* __restrict__ u, int m, int w, int rows, int stage_rows,
                   int stages, int stride) {
  using T2 = typename Pair<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t full = tma::smem_u32(smem);
  const uint32_t empty = full + 8 * kStages;
  unsigned char* ring = smem + kHead;
  const size_t slot = static_cast<size_t>(stage_rows) * stride;
  const size_t i = blockIdx.y;
  const int r0 = blockIdx.x * rows;
  const int r1 = min(m, r0 + rows);
  const T* Ai = A + i * static_cast<size_t>(m) * w;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      tma::bar_init(full + 8 * s, 1);
      tma::bar_init(empty + 8 * s, kWarps);
    }
    tma::bar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers)
      produce(Ai, w, r0, r1, 0, w, ring, full, empty, stage_rows, stages,
              stride);
    return;
  }

  const T* xi = x + i * w;
  const T* wi = wdiv + i * w;
  T2* xs = reinterpret_cast<T2*>(ring + stages * slot);
  if constexpr (kStageX) {
#pragma unroll 4
    for (int c = threadIdx.x; c < w; c += kConsumers) {
      const T xv = xi[c];
      xs[c] = T2{xv * wi[c], xv};
    }
    consumer_sync();
  }

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n = (r1 - r0 + stage_rows - 1) / stage_rows;
  for (int s = 0; s < n; ++s) {
    const int sl = s % stages;
    tma::bar_wait(full + 8 * sl, (s / stages) & 1);
    const int k0 = r0 + s * stage_rows;
    const int nk = min(stage_rows, r1 - k0);
    // This warp's rows of the stage: chunk row s * stage_rows + j with
    // j = warp (mod kWarps) in chunk-row terms.
    for (int j = (warp - (s * stage_rows) % kWarps + kWarps) % kWarps; j < nk;
         j += kWarps) {
      const size_t row = k0 + j;
      const T* a = staged_row(ring + sl * slot, j, stride, Ai + row * w);
      T sy = T(0), su = T(0);
#pragma unroll 4
      for (int c = lane; c < w; c += 32) {
        const T av = a[c];
        T xw, xv;
        if constexpr (kStageX) {
          const T2 q = xs[c];
          xw = q.x;
          xv = q.y;
        } else {
          xv = __ldg(xi + c);
          xw = xv * __ldg(wi + c);
        }
        sy = fma_t(av, xw, sy);
        su = fma_t(av, xv, su);
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
    __syncwarp();
    if (lane == 0) tma::bar_arrive(empty + 8 * sl);   // the stage is free
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
schwarz_bwd_partial_kernel(const T* __restrict__ A, const T* __restrict__ r,
                           const T* __restrict__ b, const T* __restrict__ Ax,
                           const T* __restrict__ u, T* __restrict__ part,
                           int m, int w, int rows, int cols, int stage_rows,
                           int stages, int stride) {
  constexpr int kCols = kTileBytes / static_cast<int>(sizeof(T)) / kConsumers;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t full = tma::smem_u32(smem);
  const uint32_t empty = full + 8 * kStages;
  unsigned char* ring = smem + kHead;
  const size_t slot = static_cast<size_t>(stage_rows) * stride;
  T* ts = reinterpret_cast<T*>(ring + stages * slot);
  const size_t i = blockIdx.z;
  const int c0 = blockIdx.y * cols;
  const int nc = min(cols, w - c0);
  const int r0 = blockIdx.x * rows;
  const int r1 = min(m, r0 + rows);
  const T* Ai = A + i * static_cast<size_t>(m) * w;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      tma::bar_init(full + 8 * s, 1);
      tma::bar_init(empty + 8 * s, kWarps);
    }
    tma::bar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers)
      produce(Ai, w, r0, r1, c0, nc, ring, full, empty, stage_rows, stages,
              stride);
    return;
  }

  const int t = threadIdx.x;
  if (r0 + t < r1) {
    const size_t k = r0 + t;
    ts[t] = r[k] * (b[k] - Ax[k] + u[i * m + k]);
  }
  consumer_sync();

  T acc[kCols];
#pragma unroll
  for (int q = 0; q < kCols; ++q) acc[q] = T(0);
  const int lane = t & 31;
  const int n = (r1 - r0 + stage_rows - 1) / stage_rows;
  for (int s = 0; s < n; ++s) {
    const int sl = s % stages;
    tma::bar_wait(full + 8 * sl, (s / stages) & 1);
    const int k0 = r0 + s * stage_rows;
    const int nk = min(stage_rows, r1 - k0);
    for (int j = 0; j < nk; ++j) {
      const T tk = ts[s * stage_rows + j];
      const T* a = staged_row(ring + sl * slot, j, stride,
                              Ai + static_cast<size_t>(k0 + j) * w + c0);
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        const int c = t + q * kConsumers;
        if (c < nc) acc[q] = fma_t(tk, a[c], acc[q]);
      }
    }
    __syncwarp();
    if (lane == 0) tma::bar_arrive(empty + 8 * sl);
  }
  T* out = part + (i * gridDim.x + blockIdx.x) * static_cast<size_t>(w) + c0;
#pragma unroll
  for (int q = 0; q < kCols; ++q) {
    const int c = t + q * kConsumers;
    if (c < nc) out[c] = acc[q];
  }
}

template <typename T>
__global__ void __launch_bounds__(kFinishThreads)
schwarz_bwd_finish_kernel(const T* __restrict__ part,
                          const T* __restrict__ x, const T* __restrict__ muov,
                          const T* __restrict__ mask, T* __restrict__ out,
                          int w, int parts) {
  const size_t i = blockIdx.y;
  const int col = blockIdx.x * kFinishThreads + threadIdx.x;
  if (col >= w) return;
  const T* pi = part + i * parts * static_cast<size_t>(w) + col;
  T acc = pi[0];
  int g = 1;
  for (; g + kFinishLoads <= parts; g += kFinishLoads) {
    T v[kFinishLoads];   // loads in flight together, added in part order
#pragma unroll
    for (int k = 0; k < kFinishLoads; ++k)
      v[k] = pi[static_cast<size_t>(g + k) * w];
#pragma unroll
    for (int k = 0; k < kFinishLoads; ++k) acc += v[k];
  }
  for (; g < parts; ++g) acc += pi[static_cast<size_t>(g) * w];
  const size_t o = i * w + col;
  out[o] = (acc + muov[o] * x[o]) * mask[o];
}

int smem_attr(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

bool bad_shape(int p, int m, int w) {
  return p < 1 || p > 65535 || m < 1 || w < 1;
}

template <typename T>
int launch_fwd(const void* A, const void* x, const void* wdiv, void* y,
               void* u, int p, int m, int w, void* stream) {
  if (bad_shape(p, m, w)) return static_cast<int>(cudaErrorInvalidValue);
  const Plan P = fwd_plan(m, w, sizeof(T));
  if (P.stages < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = P.stage_x ? schwarz_fwd_kernel<T, true>
                          : schwarz_fwd_kernel<T, false>;
  const int err = smem_attr(reinterpret_cast<const void*>(kernel), P.smem);
  if (err) return err;
  kernel<<<dim3(P.chunks, p), kThreads, P.smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(A), static_cast<const T*>(x),
      static_cast<const T*>(wdiv), static_cast<T*>(y), static_cast<T*>(u), m,
      w, P.rows, P.stage_rows, P.stages, P.stride);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* A, const void* r, const void* b, const void* Ax,
               const void* u, const void* x, const void* muov,
               const void* mask, void* part, void* out, int p, int m, int w,
               int parts, void* stream) {
  if (bad_shape(p, m, w)) return static_cast<int>(cudaErrorInvalidValue);
  const Plan P = bwd_plan(p, m, w, sizeof(T));
  // The scratch the caller allocated holds (p, parts, w): refuse another.
  if (P.stages < 1 || parts != P.chunks || P.tiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = smem_attr(
      reinterpret_cast<const void*>(schwarz_bwd_partial_kernel<T>), P.smem);
  if (err) return err;
  schwarz_bwd_partial_kernel<T>
      <<<dim3(P.chunks, P.tiles, p), kThreads, P.smem, st>>>(
          static_cast<const T*>(A), static_cast<const T*>(r),
          static_cast<const T*>(b), static_cast<const T*>(Ax),
          static_cast<const T*>(u), static_cast<T*>(part), m, w, P.rows,
          P.cols, P.stage_rows, P.stages, P.stride);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  schwarz_bwd_finish_kernel<T>
      <<<dim3(static_cast<unsigned>(cdiv(w, kFinishThreads)), p),
         kFinishThreads, 0, st>>>(
          static_cast<const T*>(part), static_cast<const T*>(x),
          static_cast<const T*>(muov), static_cast<const T*>(mask),
          static_cast<T*>(out), w, P.chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

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
// (p, parts, w) with `parts` as schwarz_step.bwd_plan gives it -> out
// (p, w).  Returns the cudaError_t (cudaErrorInvalidValue for another
// `parts`).
extern "C" int repro_schwarz_bwd_f64(const void* A, const void* r,
                                     const void* b, const void* Ax,
                                     const void* u, const void* x,
                                     const void* muov, const void* mask,
                                     void* part, void* out, int p, int m,
                                     int w, int parts, void* stream) {
  return launch_bwd<double>(A, r, b, Ax, u, x, muov, mask, part, out, p, m, w,
                            parts, stream);
}

extern "C" int repro_schwarz_bwd_f32(const void* A, const void* r,
                                     const void* b, const void* Ax,
                                     const void* u, const void* x,
                                     const void* muov, const void* mask,
                                     void* part, void* out, int p, int m,
                                     int w, int parts, void* stream) {
  return launch_bwd<float>(A, r, b, Ax, u, x, muov, mask, part, out, p, m, w,
                           parts, stream);
}
