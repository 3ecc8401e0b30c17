// RG-LRU linear recurrence h_t = a_t * h_{t-1} + b_t on Hopper (sm_90a).
//
// Replaces: src/repro/kernels/rglru_scan.py `rglru_scan` (`_rglru_kernel`),
// the Pallas TPU kernel of every RG-LRU layer's prefill.  On the TPU the
// grid is (B, W/bw, S/bs) with the sequence axis sequential and the state
// carried across sequence blocks in VMEM scratch.
//
// Bound on this card: bytes.  Each element of a and b is read once and
// each h written once, with one multiply-add per element: at the
// RecurrentGemma-9B prefill shape (4, 4096, 4096) in f32 that is 805 MB of
// traffic against 67 MFLOP, ~0.24 ms at 3.35 TB/s.
//
// Design: one thread per (batch, channel) walks S in order with the state
// in a register, so the sum order is that of the TPU kernel and every run
// is bitwise equal.  A warp holds 32 neighbouring channels, so each step's
// loads and stores are coalesced along W.  The recurrence is a chain, but
// its inputs are not: the thread loads the next kUnroll steps of a and b
// into registers before it runs them, which keeps kUnroll loads of each in
// flight per thread (B * W threads are too few to hide the memory latency
// one step at a time).  Inputs are f32 or bf16; the state and the
// arithmetic are f32; the output is in the input type.
//
// Backward (training; no TPU counterpart: the reference trains through
// jax.lax.associative_scan): given h from the forward and dh, the reverse
// scan g_t = dh_t + a_{t+1} g_{t+1}, db_t = g_t and da_t = g_t h_{t-1}
// (h_{-1} = 0).  The same layout as the forward, one thread per (batch,
// channel) walking S from the end, with the next kUnroll steps of a, dh
// and h loaded ahead.  Bound: bytes, three reads and two writes an element
// (0.67 GB at the RecurrentGemma-9B training shape (2, 4096, 4096) in f32,
// ~0.20 ms at 3.35 TB/s).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 64;  // channels per block: more blocks than SMs
constexpr int kUnroll = 16;   // steps whose inputs are loaded ahead

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  T* __restrict__ h, int S, int W) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= W) return;
  const size_t base = static_cast<size_t>(blockIdx.y) * S * W + w;
  const T* ap = a + base;
  const T* bp = b + base;
  T* hp = h + base;
  float state = 0.0f;
  int t0 = 0;
  for (; t0 + kUnroll <= S; t0 += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const size_t off = static_cast<size_t>(t0 + u) * W;
      av[u] = to_f32(ap[off]);
      bv[u] = to_f32(bp[off]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      state = av[u] * state + bv[u];
      hp[static_cast<size_t>(t0 + u) * W] = from_f32<T>(state);
    }
  }
  for (int t = t0; t < S; ++t) {
    const size_t off = static_cast<size_t>(t) * W;
    state = to_f32(ap[off]) * state + to_f32(bp[off]);
    hp[off] = from_f32<T>(state);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_scan_bwd_kernel(const T* __restrict__ a, const T* __restrict__ h,
                      const T* __restrict__ dh, T* __restrict__ da,
                      T* __restrict__ db, int S, int W) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= W) return;
  const size_t base = static_cast<size_t>(blockIdx.y) * S * W + w;
  const T* ap = a + base;
  const T* hp = h + base;
  const T* dp = dh + base;
  T* dap = da + base;
  T* dbp = db + base;
  float g = 0.0f;       // g_{t+1}
  float a_next = 0.0f;  // a_{t+1}; 0 past the end
  int t = S - 1;
  for (; t + 1 >= kUnroll; t -= kUnroll) {
    float av[kUnroll], dv[kUnroll], hv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int tt = t - u;
      av[u] = to_f32(ap[static_cast<size_t>(tt) * W]);
      dv[u] = to_f32(dp[static_cast<size_t>(tt) * W]);
      hv[u] = tt > 0 ? to_f32(hp[static_cast<size_t>(tt - 1) * W]) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const size_t off = static_cast<size_t>(t - u) * W;
      g = dv[u] + a_next * g;
      dbp[off] = from_f32<T>(g);
      dap[off] = from_f32<T>(g * hv[u]);
      a_next = av[u];
    }
  }
  for (; t >= 0; --t) {
    const size_t off = static_cast<size_t>(t) * W;
    g = to_f32(dp[off]) + a_next * g;
    dbp[off] = from_f32<T>(g);
    dap[off] = from_f32<T>(t > 0 ? g * to_f32(hp[off - W]) : 0.0f);
    a_next = to_f32(ap[off]);
  }
}

template <typename T>
int launch_bwd(const void* a, const void* h, const void* dh, void* da,
               void* db, int B, int S, int W, void* stream) {
  const dim3 grid((W + kThreads - 1) / kThreads, B);
  rglru_scan_bwd_kernel<T><<<grid, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(h),
      static_cast<const T*>(dh), static_cast<T*>(da), static_cast<T*>(db), S,
      W);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* a, const void* b, void* h, int B, int S, int W,
           void* stream) {
  const dim3 grid((W + kThreads - 1) / kThreads, B);
  rglru_scan_kernel<T><<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(h),
      S, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a, b, h: (B, S, W), contiguous, one dtype, on the stream's device.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_rglru_scan_f32(const void* a, const void* b, void* h,
                                    int B, int S, int W, void* stream) {
  return launch<float>(a, b, h, B, S, W, stream);
}

extern "C" int repro_rglru_scan_bf16(const void* a, const void* b, void* h,
                                     int B, int S, int W, void* stream) {
  return launch<__nv_bfloat16>(a, b, h, B, S, W, stream);
}

// a, h (the forward's output), dh, da, db: (B, S, W), contiguous, one
// dtype, on the stream's device.  Returns the cudaError_t of the launch.
extern "C" int repro_rglru_scan_bwd_f32(const void* a, const void* h,
                                        const void* dh, void* da, void* db,
                                        int B, int S, int W, void* stream) {
  return launch_bwd<float>(a, h, dh, da, db, B, S, W, stream);
}

extern "C" int repro_rglru_scan_bwd_bf16(const void* a, const void* h,
                                         const void* dh, void* da, void* db,
                                         int B, int S, int W, void* stream) {
  return launch_bwd<__nv_bfloat16>(a, h, dh, da, db, B, S, W, stream);
}
