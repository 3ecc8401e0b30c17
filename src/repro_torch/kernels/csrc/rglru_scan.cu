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
// (h_{-1} = 0).  Bound: bytes, three reads and two writes an element
// (0.67 GB at the RecurrentGemma-9B training shape (2, 4096, 4096) in f32,
// ~0.20 ms at 3.35 TB/s).  A thread a channel walking all S steps gives
// B * W threads, 8192 at that shape, too few to hide a 4096-long chain's
// latency, so the backward is a chunked reverse scan over S in three
// launches.  The first and the last run a thread for each (batch, chunk of
// kChunk steps, 4 channels): 16-byte loads for f32 and 8-byte for bf16,
// coalesced along W, 131072 threads at the training shape:
//   1. chunk: reverse-scan each chunk k = [t0, t1) from a zero carry; keep
//      u_k = a_{t0} g^local_{t0}, the value the scan hands to step t0 - 1,
//      and A_k = the product of the chunk's own a_t (taken from t1 - 1
//      down), into an f32 workspace (2, B, nc, W).
//   2. carry: per (batch, channel), from x_{nc-1} = 0 walk the chunks down,
//      x_{k-1} = u_k + A_k x_k; x_k, the value that enters chunk k from
//      chunk k + 1 (a_{t1} g_{t1}: the a of chunk k + 1's first step),
//      overwrites u_k.
//   3. out: rerun each chunk's reverse scan from x_k and write da, db.
// Seven accesses an element (two in launch 1, five in launch 3) against
// the five of one pass: a decoupled look-back would keep five, but its
// carry would depend on which predecessor had published, which breaks
// the bitwise repeatability every kernel here keeps.  No atomics, every
// sum in a fixed order: two launches are bitwise equal.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

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

// ---------------------------------------------------------------------------
// Backward: the chunked reverse scan.
// ---------------------------------------------------------------------------

constexpr int kChunk = 64;      // steps a chunk (ref.RGLRU_BWD_CHUNK)
constexpr int kVec = 4;         // channels a thread
constexpr int kBwdThreads = 128;
constexpr int kAhead = 4;       // steps (carry: chunks) loaded ahead

// kVec channels of one step: 16 bytes of f32 or 8 of bf16 when the row is
// aligned for it (W % kVec == 0 and every pointer on a 16-byte boundary),
// else element by element up to W.
struct Vec {
  float v[kVec];
};

template <typename T>
__device__ __forceinline__ Vec load_vec(const T* p, bool full, int n) {
  Vec r;
  if (full) {
    if constexpr (sizeof(T) == 4) {
      const float4 x = *reinterpret_cast<const float4*>(p);
      r.v[0] = x.x, r.v[1] = x.y, r.v[2] = x.z, r.v[3] = x.w;
    } else {
      const uint2 x = *reinterpret_cast<const uint2*>(p);
      const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&x);
      const float2 lo = __bfloat1622float2(b[0]);
      const float2 hi = __bfloat1622float2(b[1]);
      r.v[0] = lo.x, r.v[1] = lo.y, r.v[2] = hi.x, r.v[3] = hi.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j) r.v[j] = j < n ? to_f32(p[j]) : 0.0f;
  }
  return r;
}

template <typename T>
__device__ __forceinline__ void store_vec(T* p, const float* v, bool full,
                                          int n) {
  if (full) {
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      uint2 x;
      __nv_bfloat162* b = reinterpret_cast<__nv_bfloat162*>(&x);
      b[0] = __floats2bfloat162_rn(v[0], v[1]);
      b[1] = __floats2bfloat162_rn(v[2], v[3]);
      *reinterpret_cast<uint2*>(p) = x;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      if (j < n) p[j] = from_f32<T>(v[j]);
  }
}

// Where a thread's kVec channels start, and how many of them lie below W.
struct Lanes {
  int w, n;
  bool full;
};

__device__ __forceinline__ Lanes lanes(int W, int vec_ok) {
  Lanes l;
  l.w = (blockIdx.x * kBwdThreads + threadIdx.x) * kVec;
  l.n = min(kVec, W - l.w);
  l.full = vec_ok && l.n == kVec;
  return l;
}

// 1. chunk: the chunk's local reverse scan from a zero carry; writes u_k
// and A_k.  Grid (W / (kVec kBwdThreads), nc, B).
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
rglru_bwd_chunk_kernel(const T* __restrict__ a, const T* __restrict__ dh,
                       float* __restrict__ ws, int B, int S, int W,
                       int vec_ok) {
  const Lanes l = lanes(W, vec_ok);
  if (l.n <= 0) return;
  const int k = blockIdx.y, nc = gridDim.y, b = blockIdx.z;
  const int t0 = k * kChunk, t1 = min(S, t0 + kChunk);
  const size_t base = static_cast<size_t>(b) * S * W + l.w;
  float g[kVec], an[kVec], prod[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) g[j] = 0.0f, an[j] = 0.0f, prod[j] = 1.0f;
  int t = t1 - 1;
  for (; t - kAhead + 1 >= t0; t -= kAhead) {
    Vec av[kAhead], dv[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const size_t off = base + static_cast<size_t>(t - u) * W;
      av[u] = load_vec(a + off, l.full, l.n);
      dv[u] = load_vec(dh + off, l.full, l.n);
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        g[j] = fmaf(an[j], g[j], dv[u].v[j]);
        an[j] = av[u].v[j];
        prod[j] *= an[j];
      }
  }
  for (; t >= t0; --t) {
    const size_t off = base + static_cast<size_t>(t) * W;
    const Vec av = load_vec(a + off, l.full, l.n);
    const Vec dv = load_vec(dh + off, l.full, l.n);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      g[j] = fmaf(an[j], g[j], dv.v[j]);
      an[j] = av.v[j];
      prod[j] *= an[j];
    }
  }
  const size_t agg = (static_cast<size_t>(b) * nc + k) * W + l.w;
  const size_t half = static_cast<size_t>(B) * nc * W;
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    if (j < l.n) {
      ws[agg + j] = an[j] * g[j];
      ws[half + agg + j] = prod[j];
    }
  }
}

// 2. carry: x_{k-1} = u_k + A_k x_k from x_{nc-1} = 0, written over u.  A
// thread a (batch, channel); grid (W / kBwdThreads, B).
__global__ void __launch_bounds__(kBwdThreads)
rglru_bwd_carry_kernel(float* __restrict__ ws, int B, int nc, int W) {
  const int w = blockIdx.x * kBwdThreads + threadIdx.x;
  if (w >= W) return;
  const size_t row = static_cast<size_t>(blockIdx.y) * nc * W + w;
  const size_t half = static_cast<size_t>(B) * nc * W;
  float* u = ws + row;
  const float* A = ws + half + row;
  float x = 0.0f;
  int k = nc - 1;
  for (; k - kAhead + 1 >= 1; k -= kAhead) {
    float uv[kAhead], Av[kAhead];
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      uv[i] = u[static_cast<size_t>(k - i) * W];
      Av[i] = A[static_cast<size_t>(k - i) * W];
    }
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      u[static_cast<size_t>(k - i) * W] = x;
      x = fmaf(Av[i], x, uv[i]);
    }
  }
  for (; k >= 1; --k) {
    const size_t off = static_cast<size_t>(k) * W;
    const float uk = u[off];
    u[off] = x;
    x = fmaf(A[off], x, uk);
  }
  u[0] = x;
}

// 3. out: the chunk's reverse scan from its incoming x_k; writes da, db.
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
rglru_bwd_out_kernel(const T* __restrict__ a, const T* __restrict__ h,
                     const T* __restrict__ dh, const float* __restrict__ ws,
                     T* __restrict__ da, T* __restrict__ db, int S, int W,
                     int vec_ok) {
  const Lanes l = lanes(W, vec_ok);
  if (l.n <= 0) return;
  const int k = blockIdx.y, nc = gridDim.y, b = blockIdx.z;
  const int t0 = k * kChunk, t1 = min(S, t0 + kChunk);
  const size_t base = static_cast<size_t>(b) * S * W + l.w;
  const size_t agg = (static_cast<size_t>(b) * nc + k) * W + l.w;
  // g = x_k with a_next = 1: the chunk's last step gets dh + x_k exactly.
  float g[kVec], an[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    g[j] = j < l.n ? ws[agg + j] : 0.0f;
    an[j] = 1.0f;
  }
  int t = t1 - 1;
  for (; t - kAhead + 1 >= t0; t -= kAhead) {
    Vec av[kAhead], dv[kAhead], hv[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int tt = t - u;
      const size_t off = base + static_cast<size_t>(tt) * W;
      av[u] = load_vec(a + off, l.full, l.n);
      dv[u] = load_vec(dh + off, l.full, l.n);
      if (tt > 0) {
        hv[u] = load_vec(h + off - W, l.full, l.n);
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j) hv[u].v[j] = 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      float gv[kVec], gh[kVec];
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        g[j] = fmaf(an[j], g[j], dv[u].v[j]);
        an[j] = av[u].v[j];
        gv[j] = g[j];
        gh[j] = g[j] * hv[u].v[j];
      }
      const size_t off = base + static_cast<size_t>(t - u) * W;
      store_vec(db + off, gv, l.full, l.n);
      store_vec(da + off, gh, l.full, l.n);
    }
  }
  for (; t >= t0; --t) {
    const size_t off = base + static_cast<size_t>(t) * W;
    const Vec av = load_vec(a + off, l.full, l.n);
    const Vec dv = load_vec(dh + off, l.full, l.n);
    Vec hv;
    if (t > 0) {
      hv = load_vec(h + off - W, l.full, l.n);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) hv.v[j] = 0.0f;
    }
    float gv[kVec], gh[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      g[j] = fmaf(an[j], g[j], dv.v[j]);
      an[j] = av.v[j];
      gv[j] = g[j];
      gh[j] = g[j] * hv.v[j];
    }
    store_vec(db + off, gv, l.full, l.n);
    store_vec(da + off, gh, l.full, l.n);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Launches 1 and 2 (chunk, carry), which read a and dh only.
template <typename T>
int launch_bwd_carry(const void* a, const void* dh, void* ws, int B, int S,
                     int W, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nc = (S + kChunk - 1) / kChunk;
  const int per_cta = kBwdThreads * kVec;
  float* w = static_cast<float*>(ws);
  const int vec_ok = W % kVec == 0 && aligned16(a) && aligned16(dh);
  rglru_bwd_chunk_kernel<T>
      <<<dim3((W + per_cta - 1) / per_cta, nc, B), kBwdThreads, 0, st>>>(
          static_cast<const T*>(a), static_cast<const T*>(dh), w, B, S, W,
          vec_ok);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rglru_bwd_carry_kernel<<<dim3((W + kBwdThreads - 1) / kBwdThreads, B),
                           kBwdThreads, 0, st>>>(w, B, nc, W);
  return static_cast<int>(cudaGetLastError());
}

// Launch 3 (out).
template <typename T>
int launch_bwd_out(const void* a, const void* h, const void* dh,
                   const void* ws, void* da, void* db, int B, int S, int W,
                   void* stream) {
  const int nc = (S + kChunk - 1) / kChunk;
  const int per_cta = kBwdThreads * kVec;
  const int vec_ok = W % kVec == 0 && aligned16(a) && aligned16(h) &&
                     aligned16(dh) && aligned16(da) && aligned16(db);
  rglru_bwd_out_kernel<T>
      <<<dim3((W + per_cta - 1) / per_cta, nc, B), kBwdThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(a), static_cast<const T*>(h),
          static_cast<const T*>(dh), static_cast<const float*>(ws),
          static_cast<T*>(da), static_cast<T*>(db), S, W, vec_ok);
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

// The backward in two calls, so that a caller may allocate da and db while
// the first runs.  a, h (the forward's output), dh, da, db: (B, S, W),
// contiguous, one dtype, on the stream's device; ws: an f32 workspace of
// 2 B nc W floats, nc = ceil(S / 64) chunks.  The carry call (launches 1
// and 2) fills ws from a and dh; the out call (launch 3) reads it and
// writes da and db.  Each returns the first nonzero cudaError_t of its
// launches (0 on success).
extern "C" int repro_rglru_scan_bwd_carry_f32(const void* a, const void* dh,
                                              void* ws, int B, int S, int W,
                                              void* stream) {
  return launch_bwd_carry<float>(a, dh, ws, B, S, W, stream);
}

extern "C" int repro_rglru_scan_bwd_carry_bf16(const void* a, const void* dh,
                                               void* ws, int B, int S, int W,
                                               void* stream) {
  return launch_bwd_carry<__nv_bfloat16>(a, dh, ws, B, S, W, stream);
}

extern "C" int repro_rglru_scan_bwd_f32(const void* a, const void* h,
                                        const void* dh, const void* ws,
                                        void* da, void* db, int B, int S,
                                        int W, void* stream) {
  return launch_bwd_out<float>(a, h, dh, ws, da, db, B, S, W, stream);
}

extern "C" int repro_rglru_scan_bwd_bf16(const void* a, const void* h,
                                         const void* dh, const void* ws,
                                         void* da, void* db, int B, int S,
                                         int W, void* stream) {
  return launch_bwd_out<__nv_bfloat16>(a, h, dh, ws, da, db, B, S, W,
                                       stream);
}
