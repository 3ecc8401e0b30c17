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
// traffic against 67 MFLOP, ~0.24 ms at 3.35 TB/s; at the training shape
// (2, 4096, 4096), ~0.12 ms.
//
// Both paths keep one sequential f32 chain a (batch, channel), state =
// fmaf(a_t, state, b_t) from t = 0, so the sum order is that of the TPU
// kernel, the two paths give the same h bitwise, and every run is bitwise
// equal.  Inputs are f32 or bf16; the state and the arithmetic are f32;
// the output is in the input type.
//
// What holds a scan back is bytes in flight, not arithmetic: the chain
// costs one dependent FMA a step (~4096 x 4 clocks a channel, far under
// the byte bound), but the card needs ~3 MB of loads in flight to run at
// its HBM rate.  A thread a channel that loads kUnroll steps ahead (the
// direct path) keeps 2 kUnroll words a thread in flight, ~1 MB over the
// card at B W = 8192 channels, a third of that.
//
// TMA path (a row stride that is a multiple of 16 bytes, W % 4 == 0 for
// f32 and W % 8 == 0 for bf16, and 16-byte aligned pointers): a CTA owns
// kTmaCh = 32 channels of one batch row, two warps.  Thread 0 of the
// producer warp issues TMA loads of (kTmaSteps = 64 steps x 32 channels)
// boxes of a and b, by a 3-D tensor map over (W, S, B), into a ring of
// kTmaStages mbarrier stages; the consumer warp (a lane a channel) waits
// on a stage, reads its 64 steps of a and b into registers, releases the
// stage, runs the chain and writes h into one of two staged tiles that a
// TMA store drains.  Steps past S and channels past W read as zeros and
// are clipped on the store; no box crosses a batch row.  At the training
// shape that is 256 CTAs, two an SM at 80 KB of shared memory each, and
// up to 128 KB of loads in flight an SM whatever B W is.
//
// Direct path (any other shape): one thread per (batch, channel) walks S,
// loading the next kUnroll steps of a and b into registers before it runs
// them; a warp holds 32 neighbouring channels, so each step's loads and
// stores are coalesced along W.
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
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "tma.cuh"

namespace {

constexpr int kThreads = 64;  // direct path: channels per block
constexpr int kUnroll = 16;   // direct path: steps whose inputs load ahead
constexpr int kTmaCh = 32;      // TMA path: channels a CTA (a warp's lanes)
constexpr int kTmaSteps = 64;   // TMA path: steps a box
constexpr int kTmaStages = 4;   // TMA path: boxes of a and b in flight
constexpr int kTmaOut = 2;      // TMA path: staged tiles of h

// The TMA path's dynamic shared memory: the ring of a and b boxes, the h
// tiles, then a full and an empty mbarrier a stage, after up to 128 bytes
// of padding that align the boxes.
template <typename T>
struct TmaCfg {
  static constexpr int kBox = kTmaCh * kTmaSteps;   // elements of a box
  static constexpr size_t kSmem =
      128 + sizeof(T) * kBox * (2 * kTmaStages + kTmaOut) + 16 * kTmaStages;
  static_assert(kSmem <= 232448, "rglru_scan boxes exceed 227 KB");
};

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

// The TMA path: warp 0 runs the chain, thread 32 issues the loads.  Grid
// (ceil(W / kTmaCh), B).
template <typename T>
__global__ void __launch_bounds__(64)
rglru_scan_tma_kernel(const __grid_constant__ CUtensorMap ta,
                      const __grid_constant__ CUtensorMap tb,
                      const __grid_constant__ CUtensorMap th, int S) {
  using C = TmaCfg<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* As = reinterpret_cast<T*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
  T* Bs = As + kTmaStages * C::kBox;
  T* Hs = Bs + kTmaStages * C::kBox;
  const uint32_t full = tma::smem_u32(Hs + kTmaOut * C::kBox);
  const uint32_t empty = full + 8 * kTmaStages;
  const int w0 = blockIdx.x * kTmaCh, b = blockIdx.y;
  const int n = (S + kTmaSteps - 1) / kTmaSteps;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kTmaStages; ++s) {
      tma::bar_init(full + 8 * s, 1);
      tma::bar_init(empty + 8 * s, 1);
    }
    tma::bar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 32) {
    // Producer: box c into stage c % kTmaStages once the consumer has
    // released the box kTmaStages before it.
    if (threadIdx.x == 32) {
      for (int c = 0; c < n; ++c) {
        const int s = c % kTmaStages;
        if (c >= kTmaStages)
          tma::bar_wait(empty + 8 * s, (c / kTmaStages - 1) & 1);
        tma::bar_arrive_tx(full + 8 * s,
                           static_cast<int>(2 * sizeof(T) * C::kBox));
        tma::tma_load(As + s * C::kBox, &ta, w0, c * kTmaSteps, b,
                     full + 8 * s);
        tma::tma_load(Bs + s * C::kBox, &tb, w0, c * kTmaSteps, b,
                     full + 8 * s);
      }
    }
    return;
  }

  // Consumer: lane = channel w0 + lane.
  const int lane = threadIdx.x;
  float state = 0.0f;
  for (int c = 0; c < n; ++c) {
    const int s = c % kTmaStages;
    tma::bar_wait(full + 8 * s, (c / kTmaStages) & 1);
    const T* ap = As + s * C::kBox + lane;
    const T* bp = Bs + s * C::kBox + lane;
    float av[kTmaSteps], bv[kTmaSteps];
#pragma unroll
    for (int u = 0; u < kTmaSteps; ++u) {
      av[u] = to_f32(ap[u * kTmaCh]);
      bv[u] = to_f32(bp[u * kTmaCh]);
    }
    __syncwarp();
    if (lane == 0) {
      tma::bar_arrive(empty + 8 * s);   // the stage is free again
      // The tile about to be written was stored kTmaOut boxes ago.
      if (c >= kTmaOut) tma::store_wait_read<kTmaOut - 1>();
    }
    __syncwarp();
    T* hp = Hs + (c % kTmaOut) * C::kBox + lane;
#pragma unroll
    for (int u = 0; u < kTmaSteps; ++u) {
      state = fmaf(av[u], state, bv[u]);
      hp[u * kTmaCh] = from_f32<T>(state);
    }
    tma::store_fence();
    __syncwarp();
    if (lane == 0) {
      tma::tma_store(&th, Hs + (c % kTmaOut) * C::kBox, w0, c * kTmaSteps, b);
      tma::store_commit();
    }
  }
  if (lane == 0) tma::store_wait_read<0>();
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

// A (B, S, W) tensor as a 3-D map of (kTmaCh channels x kTmaSteps steps)
// boxes; elements outside the tensor read as zero and are not written.
template <typename T>
bool encode_scan_map(CUtensorMap* map, const void* ptr, int B, int S,
                     int W) {
  const tma::EncodeTiledFn fn = tma::encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t es = sizeof(T);
  const cuuint64_t dims[3] = {cuuint64_t(W), cuuint64_t(S), cuuint64_t(B)};
  const cuuint64_t strides[2] = {cuuint64_t(W) * es,
                                 cuuint64_t(S) * cuuint64_t(W) * es};
  const cuuint32_t box[3] = {kTmaCh, kTmaSteps, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map,
            sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                           : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            3, const_cast<void*>(ptr), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// path 1: the TMA path, which refuses (cudaErrorInvalidValue) a row stride
// off 16 bytes or a pointer off a 16-byte boundary; path 0: the direct
// path.
template <typename T>
int launch(const void* a, const void* b, void* h, int B, int S, int W,
           int path, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || W <= 0 || (path != 0 && path != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (path == 0) {
    const dim3 grid((W + kThreads - 1) / kThreads, B);
    rglru_scan_kernel<T><<<grid, kThreads, 0, st>>>(
        static_cast<const T*>(a), static_cast<const T*>(b),
        static_cast<T*>(h), S, W);
    return static_cast<int>(cudaGetLastError());
  }
  if ((W * sizeof(T)) % 16 != 0 || !aligned16(a) || !aligned16(b) ||
      !aligned16(h))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap ta, tb, th;
  if (!encode_scan_map<T>(&ta, a, B, S, W) ||
      !encode_scan_map<T>(&tb, b, B, S, W) ||
      !encode_scan_map<T>(&th, h, B, S, W))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      rglru_scan_tma_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(TmaCfg<T>::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((W + kTmaCh - 1) / kTmaCh, B);
  rglru_scan_tma_kernel<T><<<grid, 64, TmaCfg<T>::kSmem, st>>>(ta, tb, th, S);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a, b, h: (B, S, W), contiguous, one dtype, on the stream's device;
// path 1 the TMA path (W * sizeof(T) a multiple of 16, 16-byte aligned
// pointers), 0 the direct path.  Returns the cudaError_t of the launch (0
// on success), cudaErrorInvalidValue for a shape or path it does not take.
extern "C" int repro_rglru_scan_f32(const void* a, const void* b, void* h,
                                    int B, int S, int W, int path,
                                    void* stream) {
  return launch<float>(a, b, h, B, S, W, path, stream);
}

extern "C" int repro_rglru_scan_bf16(const void* a, const void* b, void* h,
                                     int B, int S, int W, int path,
                                     void* stream) {
  return launch<__nv_bfloat16>(a, b, h, B, S, W, path, stream);
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
