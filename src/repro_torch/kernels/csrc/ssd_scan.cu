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
//   intra:  y  = ((C B^T) .* L) (dt .* x), L = exp(cum_i - cum_j) for i >= j
//   inter:  y += (C .* exp(cum)) S_prev
//   state:  S  = exp(cum_last) S_prev + (B .* dt exp(cum_last - cum))^T x
//
// and after the last chunk the carried state S (N, P) is a second output
// (the decode cache), which the TPU kernel keeps in scratch and drops.
//
// Bound on this card: operations.  Counting the causal triangle only, the
// function needs chunk^2 N flops per (group, chunk) for C B^T, which the
// heads of a group share, and chunk^2 P + 4 chunk N P per (bh, chunk); at
// the Mamba-2 1.3B prefill shape (BH = 256, one group of 64 heads per
// sequence, S = 4096, P = 64, N = 128, chunk 256) that is ~52 GFLOP a
// launch against ~0.57 GB of traffic with B and C ungrouped: 0.78 ms at
// the f32 peak (67 TFLOP/s) against 0.17 ms at 3.35 TB/s.  This kernel
// forms C B^T once per head (chunk^2 N more per (bh, chunk), ~86 GFLOP in
// all).
//
// Design (simple first; tensor cores, TMA and a chunk ring are later work):
// * One CTA of 256 threads per (P tile of 32 columns, bh).  Columns of y and
//   of S are independent in P, so two tiles at P = 64 give 512 CTAs at the
//   prefill shape.  The CTA walks the chunks in order, so the state stays in
//   shared memory ((N, 32) f32, 16 KB at N = 128) for the whole sequence.
// * cum is a block scan per chunk (warp shuffles, then the warp totals in a
//   fixed order), summed in f64.  At the model's step sizes cum reaches
//   about -180 within a chunk, where an f32 sum carries ~1e-5 of rounding
//   in every exponent cum_i - cum_j; in f64 each difference is exact to f32
//   before it reaches expf.
// * The chunk is cut into 64-row sub-tiles: for output tile i the CTA holds
//   C_i and visits B_j, x_j for j <= i only.  A whole 256-row chunk of B and
//   C in f32 would be 128 KB each.  The last output tile visits every j, and
//   the state update reads the same B_j, x_j tiles then.
// * Products are exact f32 FMA (no TF32), each thread a 4 x 4 (C B^T) or
//   4 x 2 (y, S) register tile fed by 16-byte shared-memory loads; rows of
//   B and C are padded to N + 4 floats so those loads are free of bank
//   conflicts.  112 KB of shared memory at N = 128, above the 48 KB default:
//   the launcher raises the limit with cudaFuncSetAttribute.
// * The mask is a select, never a product: exp(cum_i - cum_j) for i < j
//   overflows to inf, and inf * 0 is NaN.
// * Every sum runs in a fixed order with no atomics, so two runs give
//   bitwise equal outputs.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kT = 64;         // rows of a sub-tile
constexpr int kPT = 32;        // columns of P a CTA owns
constexpr int kLdG = kT + 4;   // row stride of the (C B^T) tile

__host__ __device__ constexpr int ld_n(int N) { return N + 4; }

size_t smem_bytes(int N, int chunk) {
  const size_t floats = 2ull * kT * ld_n(N)  // B_j, C_i
                        + kT * kPT           // x_j
                        + kT * kLdG          // masked C_i B_j^T
                        + size_t(N) * kPT    // carried state
                        + 2ull * chunk;      // decay-to-end weights, dt
  const size_t doubles = chunk + kWarps;     // cum, warp totals of the scan
  return floats * sizeof(float) + doubles * sizeof(double);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// rows [0, len) of a (rows, N) row-major block into smem rows of ld_n(N)
// floats; rows [len, kT) are zero.
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int len, int N) {
  const int q4 = N / 4;
  const int ld = ld_n(N);
  for (int q = threadIdx.x; q < kT * q4; q += kThreads) {
    const int r = q / q4, c = (q - r * q4) * 4;
    const float4 v = r < len ? ld4(src + size_t(r) * N + c)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(dst + r * ld + c) = v;
  }
}

__global__ void __launch_bounds__(kThreads, 2)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ B,
                const float* __restrict__ C, float* __restrict__ y,
                float* __restrict__ final_state, int S, int P, int N, int rep,
                int chunk) {
  extern __shared__ float4 smem4[];
  const int ld = ld_n(N);
  float* bs = reinterpret_cast<float*>(smem4);
  float* cs = bs + kT * ld;
  float* xs = cs + kT * ld;
  float* gs = xs + kT * kPT;
  float* st = gs + kT * kLdG;
  double* cum = reinterpret_cast<double*>(st + N * kPT);   // 16-byte aligned
  double* warp_tot = cum + chunk;
  float* wd = reinterpret_cast<float*>(warp_tot + kWarps);
  float* dts = wd + chunk;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.y;
  const int p0 = blockIdx.x * kPT;
  const int pw = min(kPT, P - p0);   // columns of this tile inside P
  const float a = A[bh];
  const float* xb = x + size_t(bh) * S * P + p0;
  const float* dtb = dt + size_t(bh) * S;
  const float* Bb = B + size_t(bh / rep) * S * N;
  const float* Cb = C + size_t(bh / rep) * S * N;
  float* yb = y + size_t(bh) * S * P + p0;
  const int nsub = (chunk + kT - 1) / kT;
  const bool owns_state = ty * 8 < N;   // state rows ty*8 .. ty*8+7

  for (int i = tid; i < N * kPT; i += kThreads) st[i] = 0.f;

  for (int c0 = 0; c0 < S; c0 += chunk) {
    // cum = inclusive cumsum of dt * A over the chunk, in f64.
    double carry = 0.0;
    for (int base = 0; base < chunk; base += kThreads) {
      const int l = base + tid;
      const float d = l < chunk ? dtb[c0 + l] : 0.f;
      double v = static_cast<double>(d * a);
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const double u = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += u;
      }
      __syncthreads();   // warp_tot (and cum/wd/st of the last chunk) free
      if (lane == 31) warp_tot[warp] = v;
      __syncthreads();
      double pre = carry;
      for (int w = 0; w < warp; ++w) pre += warp_tot[w];
      double total = carry;
      for (int w = 0; w < kWarps; ++w) total += warp_tot[w];
      if (l < chunk) {
        cum[l] = pre + v;
        dts[l] = d;
      }
      carry = total;
    }
    __syncthreads();
    const double last = cum[chunk - 1];
    for (int l = tid; l < chunk; l += kThreads)
      wd[l] = dts[l] * expf(static_cast<float>(last - cum[l]));

    float sacc[8][2];   // state update, rows ty*8 + u, columns tx + 16 v
#pragma unroll
    for (int u = 0; u < 8; ++u) sacc[u][0] = sacc[u][1] = 0.f;

    for (int i = 0; i < nsub; ++i) {
      const int r0 = i * kT;
      const int rlen = min(kT, chunk - r0);
      __syncthreads();   // cs free; wd written
      load_rows(cs, Cb + size_t(c0 + r0) * N, rlen, N);
      __syncthreads();

      // inter: y = exp(cum) (C_i S_prev); rows ty*4 + u, columns tx + 16 v.
      float yacc[4][2];
#pragma unroll
      for (int u = 0; u < 4; ++u) yacc[u][0] = yacc[u][1] = 0.f;
      for (int n = 0; n < N; n += 4) {
        float4 cv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) cv[u] = ld4(cs + (ty * 4 + u) * ld + n);
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const float s0 = st[(n + 0) * kPT + tx + 16 * v];
          const float s1 = st[(n + 1) * kPT + tx + 16 * v];
          const float s2 = st[(n + 2) * kPT + tx + 16 * v];
          const float s3 = st[(n + 3) * kPT + tx + 16 * v];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            float t = yacc[u][v];
            t = fmaf(cv[u].x, s0, t);
            t = fmaf(cv[u].y, s1, t);
            t = fmaf(cv[u].z, s2, t);
            t = fmaf(cv[u].w, s3, t);
            yacc[u][v] = t;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int r = ty * 4 + u;
        const float e =
            r < rlen ? expf(static_cast<float>(cum[r0 + r])) : 0.f;
        yacc[u][0] *= e;
        yacc[u][1] *= e;
      }

      for (int j = 0; j <= i; ++j) {
        const int s0 = j * kT;
        const int slen = min(kT, chunk - s0);
        __syncthreads();   // bs, xs, gs free
        load_rows(bs, Bb + size_t(c0 + s0) * N, slen, N);
        for (int q = tid; q < kT * kPT; q += kThreads) {
          const int r = q / kPT, p = q - r * kPT;
          xs[q] = (r < slen && p < pw) ? xb[size_t(c0 + s0 + r) * P + p]
                                       : 0.f;
        }
        __syncthreads();

        // masked G = C_i B_j^T: rows ty*4 + u, columns tx + 16 v.
        float g[4][4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) g[u][v] = 0.f;
        for (int n = 0; n < N; n += 4) {
          float4 cv[4], bv[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) cv[u] = ld4(cs + (ty * 4 + u) * ld + n);
#pragma unroll
          for (int v = 0; v < 4; ++v) bv[v] = ld4(bs + (tx + 16 * v) * ld + n);
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int v = 0; v < 4; ++v) {
              float t = g[u][v];
              t = fmaf(cv[u].x, bv[v].x, t);
              t = fmaf(cv[u].y, bv[v].y, t);
              t = fmaf(cv[u].z, bv[v].z, t);
              t = fmaf(cv[u].w, bv[v].w, t);
              g[u][v] = t;
            }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int rr = r0 + ty * 4 + u;   // chunk-relative rows
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const int ss = s0 + tx + 16 * v;
            gs[(ty * 4 + u) * kLdG + tx + 16 * v] =
                (ss <= rr && rr < chunk)
                    ? g[u][v] * expf(static_cast<float>(cum[rr] - cum[ss])) *
                          dts[ss]
                    : 0.f;
          }
        }
        __syncthreads();

        // y += G x_j.
        for (int s = 0; s < kT; s += 4) {
          float4 gv[4];
#pragma unroll
          for (int u = 0; u < 4; ++u)
            gv[u] = ld4(gs + (ty * 4 + u) * kLdG + s);
#pragma unroll
          for (int v = 0; v < 2; ++v) {
            const float x0 = xs[(s + 0) * kPT + tx + 16 * v];
            const float x1 = xs[(s + 1) * kPT + tx + 16 * v];
            const float x2 = xs[(s + 2) * kPT + tx + 16 * v];
            const float x3 = xs[(s + 3) * kPT + tx + 16 * v];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              float t = yacc[u][v];
              t = fmaf(gv[u].x, x0, t);
              t = fmaf(gv[u].y, x1, t);
              t = fmaf(gv[u].z, x2, t);
              t = fmaf(gv[u].w, x3, t);
              yacc[u][v] = t;
            }
          }
        }

        // The last output tile visits every j: accumulate the state update
        // B_j^T (w .* x_j) from the tiles already in shared memory.
        if (i == nsub - 1 && owns_state) {
          for (int s = 0; s < slen; ++s) {
            const float w = wd[s0 + s];
            const float4 b0 = ld4(bs + s * ld + ty * 8);
            const float4 b1 = ld4(bs + s * ld + ty * 8 + 4);
            const float bb[8] = {b0.x, b0.y, b0.z, b0.w,
                                 b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int v = 0; v < 2; ++v) {
              const float xw = w * xs[s * kPT + tx + 16 * v];
#pragma unroll
              for (int u = 0; u < 8; ++u)
                sacc[u][v] = fmaf(bb[u], xw, sacc[u][v]);
            }
          }
        }
      }

#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int r = ty * 4 + u;
        if (r >= rlen) continue;
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const int p = tx + 16 * v;
          if (p < pw) yb[size_t(c0 + r0 + r) * P + p] = yacc[u][v];
        }
      }
    }

    __syncthreads();   // every inter term of the chunk has read st
    if (owns_state) {
      const float e_last = expf(static_cast<float>(last));
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          float* sp = st + (ty * 8 + u) * kPT + tx + 16 * v;
          *sp = fmaf(e_last, *sp, sacc[u][v]);
        }
    }
  }

  __syncthreads();
  for (int q = tid; q < N * kPT; q += kThreads) {
    const int n = q / kPT, p = q - n * kPT;
    if (p < pw) final_state[(size_t(bh) * N + n) * P + p0 + p] = st[q];
  }
}

}  // namespace

// x, y: (BH, S, P); dt: (BH, S); A: (BH,); B, C: (BH / rep, S, N);
// final_state: (BH, N, P).  All f32, contiguous, 16-byte aligned, on the
// stream's device; S a multiple of chunk, chunk <= 1024, N a multiple of 8
// and at most 128.  Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_ssd_scan_f32(const void* x, const void* dt,
                                  const void* A, const void* B, const void* C,
                                  void* y, void* final_state, int BH, int S,
                                  int P, int N, int rep, int chunk,
                                  void* stream) {
  const size_t smem = smem_bytes(N, chunk);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((P + kPT - 1) / kPT, BH);
  ssd_scan_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(B),
      static_cast<const float*>(C), static_cast<float*>(y),
      static_cast<float*>(final_state), S, P, N, rep, chunk);
  return static_cast<int>(cudaGetLastError());
}
