// Device helpers of the exact-f32 attention kernels: the f32 entry of
// flash_attention.cu and flash_attention_bwd_f32.cu.  Both stage tiles
// into rows padded by 4 floats with 16-byte cp.async copies, and both sum
// over D in one fmaf chain from column 0 through dot4, so the forward's
// scores and the backward's recomputed ones (and Delta and dP) take the
// same order.  Shipped beside the sources, which include it.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace fa32 {

__device__ __forceinline__ unsigned shared_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Rows [r0, r0 + ROWS) of a (S, D) f32 matrix into `dst` (row stride LD,
// DW columns) by NT threads, this one thread tid of them: 16-byte
// cp.async copies, zero-filled past S and D.
template <int LD, int DW, int ROWS, int NT>
__device__ __forceinline__ void stage(float* dst,
                                      const float* __restrict__ src, int r0,
                                      int S, int D, int tid) {
  constexpr int kC4 = DW / 4;
  static_assert((ROWS * kC4) % NT == 0, "uneven staging");
#pragma unroll
  for (int it = 0; it < ROWS * kC4 / NT; ++it) {
    const int e = tid + it * NT;
    const int r = e / kC4, c = 4 * (e % kC4);
    const bool in = r0 + r < S && c < D;
    const float* from = in ? src + static_cast<size_t>(r0 + r) * D + c : src;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     shared_addr(dst + r * LD + c)),
                 "l"(from), "r"(in ? 16 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed copy groups are in
// flight (0: all landed).
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc + x . y over four terms, in order (one fmaf chain).
__device__ __forceinline__ float dot4(float4 x, float4 y, float acc) {
  acc = fmaf(x.x, y.x, acc);
  acc = fmaf(x.y, y.y, acc);
  acc = fmaf(x.z, y.z, acc);
  return fmaf(x.w, y.w, acc);
}

// acc[0..3] += s * y.
__device__ __forceinline__ void axpy4(float s, float4 y, float* acc) {
  acc[0] = fmaf(s, y.x, acc[0]);
  acc[1] = fmaf(s, y.y, acc[1]);
  acc[2] = fmaf(s, y.z, acc[2]);
  acc[3] = fmaf(s, y.w, acc[3]);
}

__device__ __forceinline__ float comp(float4 x, int u) {
  return u == 0 ? x.x : u == 1 ? x.y : u == 2 ? x.z : x.w;
}

}  // namespace fa32
