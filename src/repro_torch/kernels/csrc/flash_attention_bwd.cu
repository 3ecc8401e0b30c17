// Backward of the causal / sliding-window flash attention on Hopper
// (sm_90a), bf16.
//
// Training only: the TPU package has no backward kernel (its training
// forward runs the jnp reference, repro/models/attention.py), so this has
// no Pallas counterpart.  The forward is flash_attention.cu, which also
// writes each row's log-sum-exp lse = ln sum_j exp(scale s_j) (BH, S) f32;
// the backward reads it and never re-runs the forward.
//
// Layout as the forward: q, o, dO, dQ (BH, S, D); k, v, dK, dV (BH_kv,
// S_kv, D), kv row bh / rep serving query row bh (MQA and GQA read in
// place); S_kv = S unless the attention is non-causal with no window (a
// cross-attention).  The dq launch runs over S query rows and streams
// kv tiles over S_kv keys; the dkdv launch runs over S_kv key rows and
// streams q tiles over S query rows; the workspace follows S.
// FA2's formulas, three launches on the stream (two at D <= 128):
//   1. prep  per row: Delta = rowsum(dO .* O) (f32) and lse log2 e, into a
//            (2, BH, S_pad) f32 workspace, S_pad = S rounded up to 128,
//            zero past S (whole tiles for the bulk copies of launch 3).
//            At D <= 128 the dq launch does this for its own rows, from
//            the dO tile it holds and an O tile loaded beside it.
//   2. dq    per (q head, 128-row q block): S = Q K^T, P = 2^(c S -
//            lse2), dP = dO V^T, dS = P .* (dP - Delta), dQ += dS K.
//   3. dkdv  per (kv block, kv head, group of the query heads that share
//            it): S^T = K Q^T, dP^T = V dO^T, dV += P^T dO and dK += dS^T
//            Q over every 64-row q tile of each head that sees the block.
//
// Bound on this card: operations.  The function needs 2 D flops a visible
// (q, key) pair for each of S, dP, dV, dQ and dK: at OLMoE-1B-7B's
// training shape, q, k, v (64, 2048, 128), causal, ~172 GFLOP, 0.174 ms at
// 989 TFLOP/s; at the RecurrentGemma-9B training shape (q (32, 4096, 256),
// one kv head per 16 q heads, window 2048) ~515 GFLOP, 0.52 ms.  The two
// main launches compute S and dP once each (FA2: dQ outside the dK/dV
// launch keeps every sum in a fixed order, no atomics), 7 products.
//
// Both main launches are the forward's machinery: one CTA of three
// warpgroups, a producer (under setmaxnreg.dec; one thread issues every
// TMA load, 128-byte-swizzled boxes of 64 columns, through a ring of
// stages with full and empty mbarriers) and two consumer warpgroups (under
// setmaxnreg.inc) that run every product on wgmma, bf16 in and f32
// accumulate, with P and dS rounded to bf16 as register A operands (as FA2
// and FA3 do) and the f32 accumulators of dQ, dK and dV in registers.
// Masks are evaluated per entry as selects, so no branch sits between a
// product and its wait; dkdv skips them on tiles that are wholly visible.
//
// dq: each consumer owns 64 q rows (dQ 64 x D in registers); kv tiles of
// 64 rows on 4 stages (32 rows on 3 at D = 256, where Q and dO of both
// consumers take 128 KB).  dQ += dS K is m64nDk16 with dS from registers
// and K read as an MN-major (transposed) operand; dQ is scaled, rounded
// and stored by TMA from the consumer's own q tile.  At D <= 128, Q and dO
// are held as A fragments in registers (ldmatrix once a CTA), so S = Q
// K^T and dP = dO V^T read only K and V from shared memory (with both
// operands there, m64n64 products need all of its 128 bytes a clock); tile
// i's S and dP are issued behind tile i - 1's dQ product, one wait for the
// three; and the CTA computes its rows' Delta (from the dO tile and an O
// tile loaded beside it) and lse2, and writes them for dkdv, so that no
// prep launch runs.  At D = 256, S and dP are m64n32k16 with both operands
// in shared memory, each product waited for in turn.
//
// dkdv at D <= 128: 128 kv rows a CTA, 64 a consumer, which holds dK and
// dV of its rows (128 floats a thread at D = 128) and computes its own
// S^T, P^T, dP^T and dS^T (m64n64k16, both operands in shared memory); its
// dV product runs while dS^T is formed.  Q, dO, lse2 and Delta of each
// visible q tile of each head stream through 4 stages; K and V stay.
//
// dkdv at D = 256 is the squeeze: dK and dV of 64 kv rows over all of D
// are 2 x 64 x 256 f32, 256 registers a thread of one warpgroup, so the
// two consumers split the work by gradient: consumer 0 computes S^T and
// P^T, hands P^T (f32) to consumer 1 through a double buffer in shared
// memory (named barriers), and accumulates dV += P^T dO; consumer 1
// computes dP^T, reads P^T, forms dS^T and accumulates dK += dS^T Q.
//
// Query-head groups: where the kv blocks of the kv heads alone would leave
// SMs idle for two waves (RecurrentGemma: one kv head serves 16 query
// heads), the query heads of a kv head are split into two groups, and the
// two CTAs of a kv block run as a cluster that sums their f32 dK and dV
// through distributed shared memory (CTA rank 0 finishes dV, rank 1 dK;
// rank 0's part first in either), the exchange in the (now free) ring.
//
// What holds it back (chip_smoke.py prints each launch's time; PERF.md
// keeps them): at OLMoE-1B-7B's training shape dq takes ~0.21 ms and dkdv
// ~0.28 ms, each ~520 TFLOP/s on the products it runs (NVIDIA H100 80GB
// HBM3, 700 W); the dq launch recomputes S and dP (7 products where the
// bound counts 5); dkdv's S^T and dP^T read both operands from shared
// memory; each CTA's prologue and epilogue run alone on its SM (one CTA an
// SM, no persistence).  dQ formed in dkdv (5 products) and summed over the
// kv blocks in a fixed order through a semaphore a (q head, q tile) was
// right and bitwise repeatable but ~11 times slower: each hand-over (a
// fence, a signal, a poll) sits on the path of every later kv block.
//
// Soft-capping (softcap > 0): the forward capped each scaled score x as
// cap tanh(x / cap) and wrote the lse of the capped scores, so P is
// rebuilt as 2^(c t - lse2) with t = tanh(x / cap) and c = cap log2 e (t
// as the forward's bf16 kernels take it, 1 - r with r = 2 / (1 + e^(2x /
// cap))), and dS, the gradient of the capped score, meets K and Q as g .*
// dS with g = 1 - t^2 = r (2 - r) (no cancellation where |t| ~ 1).  dq
// forms g .* dS where it forms dS; dkdv at D <= 128 forms P^T and g .*
// dS^T in one pass over the fragment; at D = 256 consumer 0 hands g .*
// P^T (not P^T) to consumer 1, which forms dS^T from it as before.  The
// cap is a compile-time flag (kCap) of the dq and dkdv kernels: the
// uncapped instantiations are the code above unchanged; the capped ones
// are built from this file by flash_attention_bwd_capped.cu, a source of
// their own, beside them; the prep launch is the same for both.
//
// Every sum runs in a fixed order with no atomics: two runs are bitwise
// equal.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "tma.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 384;      // producer + two consumer warpgroups
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kBox = 64 * 128;     // one TMA box: 64 rows of 64 bf16 (128 B)
constexpr int kBQ = 128;           // q rows of a dq CTA, 64 per consumer
constexpr int kBKV = 64;           // kv rows of a dkdv CTA
constexpr int kBQT = 64;           // q rows of a dkdv tile
constexpr int kPad = 128;          // S_pad: S rounded up to this
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ bool visible(int qpos, int kpos, int S, int Skv,
                                        int causal, int window) {
  bool ok = qpos < S && kpos < Skv;
  if (causal) ok = ok && kpos <= qpos;
  if (window > 0) ok = ok && kpos > qpos - window;
  return ok;
}

// ---------------------------------------------------------------------------
// TMA, mbarriers and wgmma (tma.cuh; as flash_attention.cu).
// ---------------------------------------------------------------------------

using tma::bar_arrive;
using tma::bar_arrive_tx;
using tma::bar_init;
using tma::bar_wait;
using tma::encode_tiled;
using tma::EncodeTiledFn;
using tma::smem_u32;
using tma::tma_load;
using tma::tma_store;

// A contiguous bulk copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from global to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// wgmma descriptor of a 128-byte-swizzled operand in shared memory: start
// address, leading and stride byte offsets (all in 16-byte units), and the
// swizzle mode (1 = 128 B) in the top bits.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads of a wgmma accumulator above the
// wait that completes it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 1 - tanh(x) = 2 / (1 + e^(2x)) from x2 = 2 x log2 e, as the forward
// computes it: 0 where e^(2x) overflows, 2 where it underflows.
__device__ __forceinline__ float one_minus_tanh(float x2) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(1.0f + ex2(x2)));
  return 2.0f * y;
}

// Two bf16 in one register, the first in the low half.
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Lane 0 of each consumer warp releases a stage.
__device__ __forceinline__ void release(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0) bar_arrive(bar);
}

// d (+)= A B over one k16 step, A and B from shared memory, both K-major;
// scale_d = 0 overwrites d.  The f32 accumulator fragment gives each warp
// 16 rows: d[4n + e] is row g + 8 (e >> 1), column 8n + 2t + (e & 1), with
// g = lane / 4 and t = lane % 4.
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += A B over one k16 step, A from registers (the m64k16 fragment: a[0..3]
// hold rows g and g + 8 of each warp's 16, columns 2t, 2t + 1 and 2t + 8,
// 2t + 9), B MN-major (transposed) from shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %133, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (+)= A B over one k16 step, A from registers (the m64k16 fragment), B
// (64 rows) K-major from shared memory; scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_rs_kb(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// The warp's 16 rows of a 64-row tile in the 128-byte-swizzled layout
// ([box][64 rows][128 B]) as wgmma A fragments, one per k16 step, by
// ldmatrix: lanes 8 m + r address row r of 8 x 8 matrix m (rows 8 (m &
// 1) + r, the step's columns 8 (m >> 1) ..), which lands as a[kk][m].
template <int DP>
__device__ __forceinline__ void load_a_frags(uint32_t (&a)[DP / 16][4],
                                             const unsigned char* tile,
                                             int warp, int lane) {
  const int r = 16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const int chunk = (kk % 4) * 2 + (lane >> 4);
    const uint32_t addr = smem_u32(tile + (kk / 4) * kBox + r * 128 +
                                   ((chunk ^ (r & 7)) << 4));
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(a[kk][0]), "=r"(a[kk][1]), "=r"(a[kk][2]), "=r"(a[kk][3])
        : "r"(addr)
        : "memory");
  }
}

// The S-like products of one tile: D / 16 k16 steps of A (64 rows) times
// B^T (N rows), both K-major in 64-column boxes of aBox and bBox bytes;
// step kk lies in box kk / 4 at a 32-byte column step kk % 4.
template <int DP, int N>
__device__ __forceinline__ void issue_ss(float (&d)[N / 2], uint64_t a_desc,
                                         int a_box, uint64_t b_desc,
                                         int b_box) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t col = (kk % 4) * 32;
    wgmma_ss(d, a_desc + (((kk / 4) * a_box + col) >> 4),
             b_desc + (((kk / 4) * b_box + col) >> 4), kk > 0);
  }
}

// acc += A B over K rows (K / 16 steps) with A's fragments in a (4 words a
// step) and B (K x DP) MN-major: 64-column boxes `box` bytes apart, 8-row
// groups 1024 B apart; step j starts 16 rows (2048 B) further.
template <int DP, int K>
__device__ __forceinline__ void issue_rs(float (&acc)[DP / 2],
                                         const uint32_t* a, uint64_t b_desc) {
#pragma unroll
  for (int j = 0; j < K / 16; ++j)
    wgmma_rs(acc, a + 4 * j, b_desc + ((j * 2048) >> 4));
}

// The 128-byte-swizzled store of a 64 x DP f32 fragment (scaled, in bf16)
// into 64-column boxes of 64 rows (the layout TMA reads back).
template <int DP>
__device__ __forceinline__ void store_swizzled(unsigned char* tile,
                                               const float (&acc)[DP / 2],
                                               float scale, int warp, int g,
                                               int t) {
  const int row = 16 * warp + g;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    unsigned char* at = tile + (n / 8) * kBox + (((n % 8) ^ g) << 4) + 4 * t;
    *reinterpret_cast<uint32_t*>(at + row * 128) =
        pack2(acc[4 * n] * scale, acc[4 * n + 1] * scale);
    *reinterpret_cast<uint32_t*>(at + (row + 8) * 128) =
        pack2(acc[4 * n + 2] * scale, acc[4 * n + 3] * scale);
  }
}

// ---------------------------------------------------------------------------
// 1. prep: Delta and lse log2 e per row.
// ---------------------------------------------------------------------------

constexpr int kPrepThreads = 256;   // a warp a row

__global__ void __launch_bounds__(kPrepThreads)
fa_bwd_prep_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                   const float* __restrict__ lse, float* __restrict__ lse2,
                   float* __restrict__ delta, int BH, int S, int S_pad,
                   int D) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long row =
      static_cast<long long>(blockIdx.x) * (kPrepThreads / 32) + warp;
  if (row >= static_cast<long long>(BH) * S_pad) return;
  const int bh = static_cast<int>(row / S_pad);
  const int r = static_cast<int>(row % S_pad);
  float acc = 0.0f;
  if (r < S) {
    const size_t base = (size_t(bh) * S + r) * D;
    for (int c = 8 * lane; c < D; c += 256) {
      const uint4 a = *reinterpret_cast<const uint4*>(dout + base + c);
      const uint4 b = *reinterpret_cast<const uint4*>(o + base + c);
      const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
      const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 fa = __bfloat1622float2(pa[j]);
        const float2 fb = __bfloat1622float2(pb[j]);
        acc = fmaf(fa.x, fb.x, acc);
        acc = fmaf(fa.y, fb.y, acc);
      }
    }
  }
#pragma unroll
  for (int sh = 16; sh > 0; sh >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, sh);
  if (lane == 0) {
    delta[row] = acc;
    lse2[row] = r < S ? lse[size_t(bh) * S + r] * kLog2e : 0.0f;
  }
}

// ---------------------------------------------------------------------------
// 2. dq.
// ---------------------------------------------------------------------------

// At head dimension DP: kv tiles of BK rows (32 at 256, where Q and dO of
// both consumers take 128 KB), the ring's stages, and shared memory: the
// q and dO tiles of both consumers, the k ring, the v ring, the mbarriers
// (full q/dO; full k, full v, empty k, empty v per stage), after up to
// 1 KB of padding to the 1024-byte period of the swizzle.
template <int DP>
struct DqCfg {
  static constexpr int kNB = DP / 64;
  static constexpr int kBK = DP == 256 ? 32 : 64;
  static constexpr int kStages = DP == 256 ? 3 : 4;
  static constexpr bool kPrep = DP <= 128;         // Delta and lse2 here
  static constexpr int kQTile = kNB * kBox;        // 64 rows
  static constexpr int kKBox = kBK * 128;          // one box of a kv tile
  static constexpr int kKTile = kNB * kKBox;
  static constexpr size_t kSmem = 1024 + size_t(kPrep ? 6 : 4) * kQTile +
                                  size_t(2) * kStages * kKTile +
                                  8 * (1 + 4 * kStages);
  static_assert(kSmem <= 232448, "dq tiles exceed 227 KB");
};

template <int DP, bool kCap>
__global__ void __launch_bounds__(kThreads, 1)
fa_bwd_dq_kernel(__grid_constant__ const CUtensorMap tq,
                 __grid_constant__ const CUtensorMap tdo,
                 __grid_constant__ const CUtensorMap to,
                 __grid_constant__ const CUtensorMap tk,
                 __grid_constant__ const CUtensorMap tv,
                 __grid_constant__ const CUtensorMap tdq,
                 const float* __restrict__ lse, float* __restrict__ lse2,
                 float* __restrict__ delta, int BH, int rep, int S,
                 int Skv, int S_pad, float c, float cs2, float scale,
                 int causal, int window) {
  using Cfg = DqCfg<DP>;
  constexpr int kNB = Cfg::kNB, kBK = Cfg::kBK, kStages = Cfg::kStages;
  constexpr int kQTile = Cfg::kQTile, kKBox = Cfg::kKBox;
  constexpr int kKTile = Cfg::kKTile;
  constexpr bool kPrep = Cfg::kPrep;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* Qs = base;                  // [consumer][box][64][128 B]
  unsigned char* dOs = Qs + 2 * kQTile;
  unsigned char* Os = dOs + 2 * kQTile;      // at D <= 128
  unsigned char* Ks = Os + (kPrep ? 2 : 0) * kQTile;   // [stage][box][BK]
  unsigned char* Vs = Ks + kStages * kKTile;
  const uint32_t bars = smem_u32(Vs + kStages * kKTile);
  const uint32_t full_q = bars;
  auto full_k = [&](int s) { return bars + 8 * (1 + s); };
  auto full_v = [&](int s) { return bars + 8 * (1 + kStages + s); };
  auto empty_k = [&](int s) { return bars + 8 * (1 + 2 * kStages + s); };
  auto empty_v = [&](int s) { return bars + 8 * (1 + 3 * kStages + s); };

  // Heaviest q blocks (last under causal) first; the heads of one q block
  // side by side.  Its kv tiles are kb_lo .. kb_end - 1.
  const int nqb = (S + kBQ - 1) / kBQ;
  const int bh = blockIdx.x % BH;
  const int q_start = (nqb - 1 - static_cast<int>(blockIdx.x) / BH) * kBQ;
  const int q_last = min(S - 1, q_start + kBQ - 1);
  const int nk = (Skv + kBK - 1) / kBK;
  const int kb_end = causal ? min(nk, q_last / kBK + 1) : nk;
  const int kb_lo = window > 0 ? max(0, q_start - window + 1) / kBK : 0;
  const int n_tiles = max(0, kb_end - kb_lo);

  if (threadIdx.x == 0) {
    bar_init(full_q, 1);
    for (int s = 0; s < kStages; ++s) {
      bar_init(full_k(s), 1);
      bar_init(full_v(s), 1);
      bar_init(empty_k(s), 8);   // lane 0 of each consumer warp
      bar_init(empty_v(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // Producer.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kProducerRegs));
    if (threadIdx.x == 0) {
      const int bkv = bh / rep;
      bar_arrive_tx(full_q, (kPrep ? 6 : 4) * kQTile);
      for (int h = 0; h < 2; ++h)
        for (int j = 0; j < kNB; ++j) {
          tma_load(Qs + h * kQTile + j * kBox, &tq, 64 * j,
                   q_start + 64 * h, bh, full_q);
          tma_load(dOs + h * kQTile + j * kBox, &tdo, 64 * j,
                   q_start + 64 * h, bh, full_q);
          if (kPrep)
            tma_load(Os + h * kQTile + j * kBox, &to, 64 * j,
                     q_start + 64 * h, bh, full_q);
        }
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages, parity = ((i / kStages) & 1) ^ 1;
        const int row = (kb_lo + i) * kBK;
        bar_wait(empty_k(st), parity);
        bar_arrive_tx(full_k(st), kKTile);
        for (int j = 0; j < kNB; ++j)
          tma_load(Ks + st * kKTile + j * kKBox, &tk, 64 * j, row, bkv,
                   full_k(st));
        bar_wait(empty_v(st), parity);
        bar_arrive_tx(full_v(st), kKTile);
        for (int j = 0; j < kNB; ++j)
          tma_load(Vs + st * kKTile + j * kKBox, &tv, 64 * j, row, bkv,
                   full_v(st));
      }
    }
  } else {
    // Consumers, 64 q rows each.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        kConsumerRegs));
    const int h = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int g = lane >> 2, t = lane & 3;
    const int q0 = q_start + 64 * h;
    const int r0 = q0 + 16 * warp + g;   // this thread's rows r0, r0 + 8
    unsigned char* Qh = Qs + h * kQTile;
    const uint64_t q_desc = sw128_desc(smem_u32(Qh), 16, 1024);
    const uint64_t do_desc = sw128_desc(smem_u32(dOs + h * kQTile), 16, 1024);
    const uint32_t k_ring = smem_u32(Ks), v_ring = smem_u32(Vs);
    const size_t rows = size_t(bh) * S_pad;
    float l2[2], dl[2];   // each row's lse log2 e and Delta
    if constexpr (!kPrep) {
      l2[0] = lse2[rows + r0], l2[1] = lse2[rows + r0 + 8];
      dl[0] = delta[rows + r0], dl[1] = delta[rows + r0 + 8];
    }

    float dq[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dq[i] = 0.0f;
    float s[kBK / 2], dp[kBK / 2];
    uint32_t ds[kBK / 4];

    // dS = P .* (dP - Delta), P = 2^(c s - lse2), masked entries 0, of
    // the tile at k0, packed into ds (s and dp are only read: an
    // accumulator written outside wgmma would serialize the chained
    // products, ptxas C7515).  kCap: P = 2^(c t - lse2) and g .* dS.
    auto ds_tile = [&](int k0) {
      auto ds_at = [&](int e) {
        const int hr = (e >> 1) & 1;
        const int kpos = k0 + 8 * (e >> 2) + 2 * t + (e & 1);
        if constexpr (kCap) {
          const float r = one_minus_tanh(s[e] * cs2);
          const float p =
              visible(r0 + 8 * hr, kpos, S, Skv, causal, window)
                  ? ex2(fmaf(1.0f - r, c, -l2[hr]))
                  : 0.0f;
          return p * (dp[e] - dl[hr]) * (r * (2.0f - r));
        }
        const float p = visible(r0 + 8 * hr, kpos, S, Skv, causal, window)
                            ? ex2(fmaf(s[e], c, -l2[hr]))
                            : 0.0f;
        return p * (dp[e] - dl[hr]);
      };
#pragma unroll
      for (int j = 0; j < kBK / 4; ++j)
        ds[j] = pack2(ds_at(2 * j), ds_at(2 * j + 1));
    };
    auto issue_sdp = [&](int st) {
      issue_ss<DP, kBK>(s, q_desc, kBox,
                        sw128_desc(k_ring + st * kKTile, 16, 1024), kKBox);
      issue_ss<DP, kBK>(dp, do_desc, kBox,
                        sw128_desc(v_ring + st * kKTile, 16, 1024), kKBox);
    };

    bar_wait(full_q, 0);
    if constexpr (kPrep) {
      // This CTA's rows of the prep: Delta = dO . O from the tiles, each
      // row over its four lanes (DP / 32 16-byte chunks a lane), and lse
      // log2 e, kept here and written to the workspace for dkdv (rows
      // past S: zero-filled tiles give Delta 0; lse2 0).
      unsigned char* dOh = dOs + h * kQTile;
      unsigned char* Oh = Os + h * kQTile;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = 16 * warp + g + 8 * hr;   // the tile's row
        float acc = 0.0f;
#pragma unroll
        for (int i = 0; i < DP / 32; ++i) {
          const int ch = (DP / 32) * t + i;   // 16-byte chunk of the row
          const int off = (ch / 8) * kBox + r * 128 + (((ch % 8) ^ g) << 4);
          const uint4 a = *reinterpret_cast<const uint4*>(dOh + off);
          const uint4 b = *reinterpret_cast<const uint4*>(Oh + off);
          const auto* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
          const auto* pb = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 fa = __bfloat1622float2(pa[j]);
            const float2 fb = __bfloat1622float2(pb[j]);
            acc = fmaf(fa.x, fb.x, acc);
            acc = fmaf(fa.y, fb.y, acc);
          }
        }
        acc += __shfl_xor_sync(0xffffffffu, acc, 1);
        acc += __shfl_xor_sync(0xffffffffu, acc, 2);
        const int qr = r0 + 8 * hr;
        dl[hr] = acc;
        l2[hr] = qr < S ? lse[size_t(bh) * S + qr] * kLog2e : 0.0f;
        if (t == 0) {
          delta[rows + qr] = dl[hr];
          lse2[rows + qr] = l2[hr];
        }
      }
    }
    if constexpr (DP <= 128) {
      // Q and dO as A fragments in registers (loaded once), so that S and
      // dP read only K and V from shared memory; tile i's S and dP are
      // issued behind tile i - 1's dQ += dS K, and one wait covers the
      // three.
      uint32_t qa[DP / 16][4], da[DP / 16][4];
      load_a_frags<DP>(qa, Qh, warp, lane);
      load_a_frags<DP>(da, dOs + h * kQTile, warp, lane);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages, parity = (i / kStages) & 1;
        bar_wait(full_k(st), parity);
        bar_wait(full_v(st), parity);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          const uint32_t off = ((kk / 4) * kKBox + (kk % 4) * 32) >> 4;
          wgmma_rs_kb(s, qa[kk],
                      sw128_desc(k_ring + st * kKTile, 16, 1024) + off,
                      kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          const uint32_t off = ((kk / 4) * kKBox + (kk % 4) * 32) >> 4;
          wgmma_rs_kb(dp, da[kk],
                      sw128_desc(v_ring + st * kKTile, 16, 1024) + off,
                      kk > 0);
        }
        wgmma_commit();
        wgmma_wait0();
        fence_regs(s);
        fence_regs(dp);
        release(empty_v(st), lane);
        if (i > 0) release(empty_k((i - 1) % kStages), lane);
        ds_tile((kb_lo + i) * kBK);
        wgmma_fence();
        issue_rs<DP, kBK>(dq, ds,
                          sw128_desc(k_ring + st * kKTile, kKBox, 1024));
        wgmma_commit();
      }
      wgmma_wait0();
      fence_regs(dq);
      if (n_tiles > 0) release(empty_k((n_tiles - 1) % kStages), lane);
    } else {
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages, parity = (i / kStages) & 1;
        bar_wait(full_k(st), parity);
        bar_wait(full_v(st), parity);
        wgmma_fence();
        issue_sdp(st);
        wgmma_commit();
        wgmma_wait0();
        fence_regs(s);
        fence_regs(dp);
        release(empty_v(st), lane);
        ds_tile((kb_lo + i) * kBK);
        wgmma_fence();
        issue_rs<DP, kBK>(dq, ds,
                          sw128_desc(k_ring + st * kKTile, kKBox, 1024));
        wgmma_commit();
        wgmma_wait0();
        fence_regs(dq);
        release(empty_k(st), lane);
      }
    }

    // Epilogue: dQ scale in bf16 into this warpgroup's q tile (swizzled as
    // TMA wrote it), then one TMA store per box; rows past S are dropped.
    store_swizzled<DP>(Qh, dq, scale, warp, g, t);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    named_sync(1 + h, 128);
    if (threadIdx.x % 128 == 0) {
      for (int j = 0; j < kNB; ++j)
        tma_store(&tdq, Qh + j * kBox, 64 * j, q0, bh);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  }
}

// ---------------------------------------------------------------------------
// 3. dkdv.
// ---------------------------------------------------------------------------

// At head dimension DP: the K and V tiles, the ring of Q and dO tiles with
// lse2 and Delta, the two P^T buffers (64 x 64 f32 each), the mbarriers
// (full K/V; full and empty per stage), after up to 1 KB of padding.
template <int DP>
struct KvCfg {
  static constexpr int kNB = DP / 64;
  static constexpr int kStages = 2;
  static constexpr int kTile = kNB * kBox;           // 64 rows
  static constexpr int kRowBytes = kBQT * 4;          // lse2 or Delta
  static constexpr int kPBuf = kBKV * kBQT * 4;
  static constexpr size_t kSmem =
      1024 + size_t(2) * kTile +
      size_t(kStages) * (2 * kTile + 2 * kRowBytes) + 2 * kPBuf +
      8 * (1 + 2 * kStages);
  static_assert(kSmem <= 232448, "dkdv tiles exceed 227 KB");
  // The exchange of the cluster's partial sums reuses the ring.
  static_assert(size_t(kStages) * 2 * kTile >= size_t(128) * DP * 2,
                "dkdv exchange buffer exceeds the ring");
};

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ float4 ld_remote4(uint32_t local, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(local), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(remote)
               : "memory");
  return v;
}

// A consumer's 64 x DP accumulator fragment to global memory in bf16
// (scaled), rows past S and columns past D dropped.
template <int DP>
__device__ __forceinline__ void store_rows(bf16* out,
                                           const float (&acc)[DP / 2],
                                           float scale, int k_start, int S,
                                           int D, int warp, int g, int t) {
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    const int col = 8 * n + 2 * t;
    if (col >= D) continue;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = k_start + 16 * warp + g + 8 * hr;
      if (row < S)
        *reinterpret_cast<uint32_t*>(out + size_t(row) * D + col) =
            pack2(acc[4 * n + 2 * hr] * scale, acc[4 * n + 2 * hr + 1] * scale);
    }
  }
}

// Named barriers of the P^T hand-over (ids 1-4) and the consumers' end.
constexpr int kBarPFull = 1;    // + buffer
constexpr int kBarPEmpty = 3;   // + buffer
constexpr int kBarDone = 5;

template <int DP, bool kCap>
__global__ void __launch_bounds__(kThreads, 1)
fa_bwd_dkdvsplit_kernel(__grid_constant__ const CUtensorMap tq,
                   __grid_constant__ const CUtensorMap tdo,
                   __grid_constant__ const CUtensorMap tk,
                   __grid_constant__ const CUtensorMap tv,
                   const float* __restrict__ lse2,
                   const float* __restrict__ delta, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, int BH_kv, int rep, int groups,
                   int S, int Skv, int S_pad, int D, float c, float cs2,
                   float scale, int causal, int window) {
  using Cfg = KvCfg<DP>;
  constexpr int kNB = Cfg::kNB, kStages = Cfg::kStages, kTile = Cfg::kTile;
  constexpr int kRowBytes = Cfg::kRowBytes, kPBuf = Cfg::kPBuf;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* Ks = base;                       // [box][64][128 B]
  unsigned char* Vs = Ks + kTile;
  unsigned char* Qs = Vs + kTile;                 // [stage][box][64][128 B]
  unsigned char* dOs = Qs + kStages * kTile;
  float* L2s = reinterpret_cast<float*>(dOs + kStages * kTile);  // [stage][64]
  float* Dls = L2s + kStages * kBQT;
  float* Ps = Dls + kStages * kBQT;               // [buffer][8][128][4]
  const uint32_t bars = smem_u32(reinterpret_cast<unsigned char*>(Ps) +
                                 2 * kPBuf);
  const uint32_t full_kv = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + kStages + s); };

  // Block order: kv blocks from the first (the heaviest under causal and
  // window), the kv heads, then the groups of query heads (a cluster).
  const int grp = blockIdx.x % groups;
  const int bkv = (blockIdx.x / groups) % BH_kv;
  const int k_start = (blockIdx.x / groups / BH_kv) * kBKV;
  const int k_last = min(Skv - 1, k_start + kBKV - 1);
  const int qt_lo = (causal ? k_start : 0) / kBQT;
  const int qt_hi =
      (window > 0 ? min(S - 1, k_last + window - 1) : S - 1) / kBQT;
  const int n_qt = qt_hi - qt_lo + 1;
  const int h_lo = bkv * rep + (grp * rep) / groups;
  const int h_hi = bkv * rep + ((grp + 1) * rep) / groups;
  const int n_items = (h_hi - h_lo) * n_qt;

  if (threadIdx.x == 0) {
    bar_init(full_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      bar_init(full(s), 1);
      bar_init(empty(s), 8);   // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // Producer.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kProducerRegs));
    if (threadIdx.x == 0) {
      bar_arrive_tx(full_kv, 2 * kTile);
      for (int j = 0; j < kNB; ++j) {
        tma_load(Ks + j * kBox, &tk, 64 * j, k_start, bkv, full_kv);
        tma_load(Vs + j * kBox, &tv, 64 * j, k_start, bkv, full_kv);
      }
      for (int i = 0; i < n_items; ++i) {
        const int st = i % kStages, parity = ((i / kStages) & 1) ^ 1;
        const int bh = h_lo + i / n_qt;
        const int q0 = (qt_lo + i % n_qt) * kBQT;
        bar_wait(empty(st), parity);
        bar_arrive_tx(full(st), 2 * kTile + 2 * kRowBytes);
        for (int j = 0; j < kNB; ++j) {
          tma_load(Qs + st * kTile + j * kBox, &tq, 64 * j, q0, bh,
                   full(st));
          tma_load(dOs + st * kTile + j * kBox, &tdo, 64 * j, q0, bh,
                   full(st));
        }
        const size_t row = size_t(bh) * S_pad + q0;
        bulk_load(L2s + st * kBQT, lse2 + row, kRowBytes, full(st));
        bulk_load(Dls + st * kBQT, delta + row, kRowBytes, full(st));
      }
    }
    if (groups > 1) {   // the consumers' exchange (two cluster barriers)
      cluster_sync();
      cluster_sync();
    }
  } else {
    // Consumers: 0 the S^T / P^T / dV side, 1 the dP^T / dS^T / dK side.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        kConsumerRegs));
    const int h = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane >> 2, t = lane & 3;
    const int kr = k_start + 16 * warp + g;   // this thread's kv rows kr, +8
    const uint32_t q_ring = smem_u32(Qs), do_ring = smem_u32(dOs);
    // Consumer 0 multiplies K by Q^T and P^T by dO; consumer 1 V by dO^T
    // and dS^T by Q.
    const uint64_t a_desc = sw128_desc(smem_u32(h == 0 ? Ks : Vs), 16, 1024);
    const uint32_t b_ring = h == 0 ? q_ring : do_ring;
    const uint32_t o_ring = h == 0 ? do_ring : q_ring;

    float acc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.0f;
    float s[32];
    uint32_t pk[16];

    bar_wait(full_kv, 0);
    for (int i = 0; i < n_items; ++i) {
      const int st = i % kStages, parity = (i / kStages) & 1;
      const int q0 = (qt_lo + i % n_qt) * kBQT;
      const int buf = i & 1;
      float4* pb = reinterpret_cast<float4*>(Ps) + buf * (kPBuf / 16);
      bar_wait(full(st), parity);
      wgmma_fence();
      issue_ss<DP, 64>(s, a_desc, kBox,
                       sw128_desc(b_ring + st * kTile, 16, 1024), kBox);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(s);
      if (kCap && h == 0) {
        // P^T = 2^(c t - lse2[q]), masked entries 0, kept for dV; g .*
        // P^T to consumer 1, whose dS^T is then g .* dS^T.
        const float* l2 = L2s + st * kBQT;
        if (i >= 2) named_sync(kBarPEmpty + buf, 256);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float pg[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int e = 4 * j + u;
            const int col = 8 * (e >> 2) + 2 * t + (e & 1);
            const int kpos = kr + 8 * ((e >> 1) & 1);
            const float r = one_minus_tanh(s[e] * cs2);
            s[e] = visible(q0 + col, kpos, S, Skv, causal, window)
                       ? ex2(fmaf(1.0f - r, c, -l2[col]))
                       : 0.0f;
            pg[u] = s[e] * (r * (2.0f - r));
          }
          pb[j * 128 + tid] = make_float4(pg[0], pg[1], pg[2], pg[3]);
        }
        named_arrive(kBarPFull + buf, 256);
      } else if (h == 0) {
        // P^T = 2^(c S^T - lse2[q]), masked entries 0; to consumer 1.
        const float* l2 = L2s + st * kBQT;
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int col = 8 * (e >> 2) + 2 * t + (e & 1);
          const int kpos = kr + 8 * ((e >> 1) & 1);
          s[e] = visible(q0 + col, kpos, S, Skv, causal, window)
                     ? ex2(fmaf(s[e], c, -l2[col]))
                     : 0.0f;
        }
        if (i >= 2) named_sync(kBarPEmpty + buf, 256);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          pb[j * 128 + tid] =
              make_float4(s[4 * j], s[4 * j + 1], s[4 * j + 2], s[4 * j + 3]);
        named_arrive(kBarPFull + buf, 256);
      } else {
        // dS^T = P^T .* (dP^T - Delta[q]).
        const float* dl = Dls + st * kBQT;
        named_sync(kBarPFull + buf, 256);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float4 p = pb[j * 128 + tid];
          const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 8 * j + 2 * t + (e & 1);
            s[4 * j + e] = pv[e] * (s[4 * j + e] - dl[col]);
          }
        }
        named_arrive(kBarPEmpty + buf, 256);
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) pk[j] = pack2(s[2 * j], s[2 * j + 1]);
      // dV += P^T dO (consumer 0), dK += dS^T Q (consumer 1).
      wgmma_fence();
      issue_rs<DP, kBQT>(acc, pk,
                         sw128_desc(o_ring + st * kTile, kBox, 1024));
      wgmma_commit();
      wgmma_wait0();
      fence_regs(acc);
      release(empty(st), lane);
    }
    // Consumer 1's last arrivals on the P^T buffers.
    if (h == 0)
      for (int i = max(0, n_items - 2); i < n_items; ++i)
        named_sync(kBarPEmpty + (i & 1), 256);

    bf16* out = (h == 0 ? dv : dk) + size_t(bkv) * Skv * D;
    const float sc = h == 0 ? 1.0f : scale;
    if (groups == 1) {
      store_rows<DP>(out, acc, sc, k_start, Skv, D, warp, g, t);
    } else {
      // The cluster's two CTAs: rank 0 finishes dV, rank 1 dK.  Each
      // leaves the partial the other finishes in its (now free) ring.
      const uint32_t rank = cluster_rank();
      float4* xb = reinterpret_cast<float4*>(Qs);
      const bool mine = static_cast<int>(rank) == h;
      named_sync(kBarDone, 256);   // every consumer is past the ring
      if (!mine)
#pragma unroll
        for (int j = 0; j < DP / 8; ++j)
          xb[j * 128 + tid] = make_float4(acc[4 * j], acc[4 * j + 1],
                                          acc[4 * j + 2], acc[4 * j + 3]);
      cluster_sync();
      if (mine) {
        const uint32_t peer = rank ^ 1u;
#pragma unroll
        for (int j = 0; j < DP / 8; ++j) {
          const float4 r = ld_remote4(smem_u32(xb + j * 128 + tid), peer);
          // rank 0's part first: the same sum in either CTA.
          if (rank == 0) {
            acc[4 * j] += r.x;
            acc[4 * j + 1] += r.y;
            acc[4 * j + 2] += r.z;
            acc[4 * j + 3] += r.w;
          } else {
            acc[4 * j] = r.x + acc[4 * j];
            acc[4 * j + 1] = r.y + acc[4 * j + 1];
            acc[4 * j + 2] = r.z + acc[4 * j + 2];
            acc[4 * j + 3] = r.w + acc[4 * j + 3];
          }
        }
      }
      cluster_sync();   // the peer has read this CTA's partial
      if (mine) store_rows<DP>(out, acc, sc, k_start, Skv, D, warp, g, t);
    }
  }
}

// ---------------------------------------------------------------------------
// 3'. dkdv at head dimension 64 and 128: each consumer owns 64 kv rows.
// ---------------------------------------------------------------------------

constexpr int kBKV2 = 128;   // kv rows of a CTA, 64 a consumer

// The K and V tiles of the CTA's 128 rows (two 64-row tiles each), the
// ring of Q and dO tiles with lse2 and Delta, the mbarriers (full K/V;
// full and empty per stage), after up to 1 KB of padding.
template <int DP>
struct KvCfg2 {
  static constexpr int kNB = DP / 64;
  static constexpr int kStages = 4;
  static constexpr int kTile = kNB * kBox;            // 64 rows
  static constexpr int kRowBytes = kBQT * 4;          // lse2 or Delta
  static constexpr size_t kSmem =
      1024 + size_t(4) * kTile +
      size_t(kStages) * (2 * kTile + 2 * kRowBytes) + 8 * (1 + 2 * kStages);
  static_assert(kSmem <= 232448, "dkdv tiles exceed 227 KB");
  // The exchange of the cluster's partial sums (one gradient of 128 rows
  // in f32) reuses the ring.
  static_assert(size_t(kStages) * 2 * kTile >= size_t(kBKV2) * DP * 4,
                "dkdv exchange buffer exceeds the ring");
};

// A consumer's accumulator into the exchange buffer, and the peer CTA's
// copy of the same accumulator added to it, rank 0's part first.
template <int DP>
__device__ __forceinline__ void put_partial(float4* xb,
                                            const float (&acc)[DP / 2],
                                            int h, int tid) {
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
    xb[(h * (DP / 8) + j) * 128 + tid] = make_float4(
        acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]);
}

template <int DP>
__device__ __forceinline__ void add_partial(float (&acc)[DP / 2],
                                            const float4* xb, int h, int tid,
                                            uint32_t rank) {
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const float4 r =
        ld_remote4(smem_u32(xb + (h * (DP / 8) + j) * 128 + tid), rank ^ 1u);
    if (rank == 0) {
      acc[4 * j] += r.x;
      acc[4 * j + 1] += r.y;
      acc[4 * j + 2] += r.z;
      acc[4 * j + 3] += r.w;
    } else {
      acc[4 * j] = r.x + acc[4 * j];
      acc[4 * j + 1] = r.y + acc[4 * j + 1];
      acc[4 * j + 2] = r.z + acc[4 * j + 2];
      acc[4 * j + 3] = r.w + acc[4 * j + 3];
    }
  }
}

template <int DP, bool kCap>
__global__ void __launch_bounds__(kThreads, 1)
fa_bwd_dkdv_kernel(__grid_constant__ const CUtensorMap tq,
                   __grid_constant__ const CUtensorMap tdo,
                   __grid_constant__ const CUtensorMap tk,
                   __grid_constant__ const CUtensorMap tv,
                   const float* __restrict__ lse2,
                   const float* __restrict__ delta, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, int BH_kv, int rep, int groups,
                   int S, int Skv, int S_pad, int D, float c, float cs2,
                   float scale, int causal, int window) {
  using Cfg = KvCfg2<DP>;
  constexpr int kNB = Cfg::kNB, kStages = Cfg::kStages, kTile = Cfg::kTile;
  constexpr int kRowBytes = Cfg::kRowBytes;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* Ks = base;                       // [consumer][box][64][128 B]
  unsigned char* Vs = Ks + 2 * kTile;
  unsigned char* Qs = Vs + 2 * kTile;             // [stage][box][64][128 B]
  unsigned char* dOs = Qs + kStages * kTile;
  float* L2s = reinterpret_cast<float*>(dOs + kStages * kTile);  // [stage][64]
  float* Dls = L2s + kStages * kBQT;
  const uint32_t bars = smem_u32(Dls + kStages * kBQT);
  const uint32_t full_kv = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + kStages + s); };

  // Block order: kv blocks from the first (the heaviest under causal and
  // window), the kv heads, then the groups of query heads (a cluster).
  const int grp = blockIdx.x % groups;
  const int bkv = (blockIdx.x / groups) % BH_kv;
  const int k_start = (blockIdx.x / groups / BH_kv) * kBKV2;
  const int k_last = min(Skv - 1, k_start + kBKV2 - 1);
  const int qt_lo = (causal ? k_start : 0) / kBQT;
  const int qt_hi =
      (window > 0 ? min(S - 1, k_last + window - 1) : S - 1) / kBQT;
  const int n_qt = qt_hi - qt_lo + 1;
  const int h_lo = bkv * rep + (grp * rep) / groups;
  const int h_hi = bkv * rep + ((grp + 1) * rep) / groups;
  const int n_items = (h_hi - h_lo) * n_qt;

  if (threadIdx.x == 0) {
    bar_init(full_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      bar_init(full(s), 1);
      bar_init(empty(s), 8);   // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // Producer.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kProducerRegs));
    if (threadIdx.x == 0) {
      bar_arrive_tx(full_kv, 4 * kTile);
      for (int h = 0; h < 2; ++h)
        for (int j = 0; j < kNB; ++j) {
          tma_load(Ks + h * kTile + j * kBox, &tk, 64 * j, k_start + 64 * h,
                   bkv, full_kv);
          tma_load(Vs + h * kTile + j * kBox, &tv, 64 * j, k_start + 64 * h,
                   bkv, full_kv);
        }
      for (int i = 0; i < n_items; ++i) {
        const int st = i % kStages, parity = ((i / kStages) & 1) ^ 1;
        const int bh = h_lo + i / n_qt;
        const int q0 = (qt_lo + i % n_qt) * kBQT;
        bar_wait(empty(st), parity);
        bar_arrive_tx(full(st), 2 * kTile + 2 * kRowBytes);
        for (int j = 0; j < kNB; ++j) {
          tma_load(Qs + st * kTile + j * kBox, &tq, 64 * j, q0, bh,
                   full(st));
          tma_load(dOs + st * kTile + j * kBox, &tdo, 64 * j, q0, bh,
                   full(st));
        }
        const size_t row = size_t(bh) * S_pad + q0;
        bulk_load(L2s + st * kBQT, lse2 + row, kRowBytes, full(st));
        bulk_load(Dls + st * kBQT, delta + row, kRowBytes, full(st));
      }
    }
    if (groups > 1) {   // the consumers' exchange (two cluster barriers)
      cluster_sync();
      cluster_sync();
    }
  } else {
    // Consumers: rows k_start + 64 h .. + 63 each, with their own dK and
    // dV.  Per q tile: S^T = K Q^T and dP^T = V dO^T, then P^T and
    // dV += P^T dO, whose product runs while dS^T = P^T .* (dP^T - Delta)
    // is formed, then dK += dS^T Q.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        kConsumerRegs));
    const int h = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane >> 2, t = lane & 3;
    const int kh = k_start + 64 * h;
    const int kr = kh + 16 * warp + g;   // this thread's kv rows kr, kr + 8
    const uint32_t q_ring = smem_u32(Qs), do_ring = smem_u32(dOs);
    const uint64_t k_desc = sw128_desc(smem_u32(Ks + h * kTile), 16, 1024);
    const uint64_t v_desc = sw128_desc(smem_u32(Vs + h * kTile), 16, 1024);

    float dkr[DP / 2], dvr[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dkr[i] = dvr[i] = 0.0f;
    float s[32], dp[32];
    uint32_t pk[16], pd[16];

    // Whether every (q, key) pair of the q tile at q0 and this consumer's
    // kv rows is visible, so that P^T needs no mask.
    const bool rows_in = kh + 63 < Skv;
    auto tile_full = [&](int q0) {
      return rows_in && q0 + kBQT <= S && (!causal || kh + 63 <= q0) &&
             (window <= 0 || kh > q0 + kBQT - 1 - window);
    };

    bar_wait(full_kv, 0);
    for (int i = 0; i < n_items; ++i) {
      const int st = i % kStages, parity = (i / kStages) & 1;
      const int q0 = (qt_lo + i % n_qt) * kBQT;
      bar_wait(full(st), parity);
      wgmma_fence();
      issue_ss<DP, 64>(s, k_desc, kBox,
                       sw128_desc(q_ring + st * kTile, 16, 1024), kBox);
      issue_ss<DP, 64>(dp, v_desc, kBox,
                       sw128_desc(do_ring + st * kTile, 16, 1024), kBox);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(s);
      fence_regs(dp);
      // P^T = 2^(c S^T - lse2[q]), masked entries 0; dV += P^T dO.
      const float* l2 = L2s + st * kBQT;
      const float* dl = Dls + st * kBQT;
      if constexpr (kCap) {
        // P^T = 2^(c t - lse2[q]) and g .* dS^T in one pass (s and dp
        // only read), then dV += P^T dO and dK += (g .* dS^T) Q.
        const bool full = tile_full(q0);
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          float pe[2], de[2];
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            const int e = 2 * j + b;
            const int col = 8 * (e >> 2) + 2 * t + (e & 1);
            const int kpos = kr + 8 * ((e >> 1) & 1);
            const float r = one_minus_tanh(s[e] * cs2);
            pe[b] = full || visible(q0 + col, kpos, S, Skv, causal, window)
                        ? ex2(fmaf(1.0f - r, c, -l2[col]))
                        : 0.0f;
            de[b] = pe[b] * (dp[e] - dl[col]) * (r * (2.0f - r));
          }
          pk[j] = pack2(pe[0], pe[1]);
          pd[j] = pack2(de[0], de[1]);
        }
        wgmma_fence();
        issue_rs<DP, kBQT>(dvr, pk,
                           sw128_desc(do_ring + st * kTile, kBox, 1024));
        wgmma_commit();
        wgmma_fence();
        issue_rs<DP, kBQT>(dkr, pd,
                           sw128_desc(q_ring + st * kTile, kBox, 1024));
        wgmma_commit();
        wgmma_wait0();
        fence_regs(dvr);
        fence_regs(dkr);
        release(empty(st), lane);
        continue;
      }
      if (tile_full(q0)) {
#pragma unroll
        for (int e = 0; e < 32; ++e)
          s[e] = ex2(fmaf(s[e], c, -l2[8 * (e >> 2) + 2 * t + (e & 1)]));
      } else {
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int col = 8 * (e >> 2) + 2 * t + (e & 1);
          const int kpos = kr + 8 * ((e >> 1) & 1);
          s[e] = visible(q0 + col, kpos, S, Skv, causal, window)
                      ? ex2(fmaf(s[e], c, -l2[col]))
                      : 0.0f;
        }
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) pk[j] = pack2(s[2 * j], s[2 * j + 1]);
      wgmma_fence();
      issue_rs<DP, kBQT>(dvr, pk,
                         sw128_desc(do_ring + st * kTile, kBox, 1024));
      wgmma_commit();
      // dS^T = P^T .* (dP^T - Delta[q]); dK += dS^T Q.
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = 8 * (j >> 1) + 2 * t;
        pd[j] = pack2(s[2 * j] * (dp[2 * j] - dl[col]),
                      s[2 * j + 1] * (dp[2 * j + 1] - dl[col + 1]));
      }
      wgmma_fence();
      issue_rs<DP, kBQT>(dkr, pd,
                         sw128_desc(q_ring + st * kTile, kBox, 1024));
      wgmma_commit();
      wgmma_wait0();
      fence_regs(dvr);
      fence_regs(dkr);
      release(empty(st), lane);
    }

    if (groups == 1) {
      store_rows<DP>(dv + size_t(bkv) * Skv * D, dvr, 1.0f, kh, Skv, D, warp,
                     g, t);
      store_rows<DP>(dk + size_t(bkv) * Skv * D, dkr, scale, kh, Skv, D, warp,
                     g, t);
    } else {
      // The cluster's two CTAs: rank 0 finishes dV, rank 1 dK.  Each
      // leaves the partial the other finishes in its (now free) ring.
      const uint32_t rank = cluster_rank();
      float4* xb = reinterpret_cast<float4*>(Qs);
      named_sync(kBarDone, 256);   // every consumer is past the ring
      if (rank == 0)
        put_partial<DP>(xb, dkr, h, tid);
      else
        put_partial<DP>(xb, dvr, h, tid);
      cluster_sync();
      if (rank == 0)
        add_partial<DP>(dvr, xb, h, tid, rank);
      else
        add_partial<DP>(dkr, xb, h, tid, rank);
      cluster_sync();   // the peer has read this CTA's partial
      if (rank == 0)
        store_rows<DP>(dv + size_t(bkv) * Skv * D, dvr, 1.0f, kh, Skv, D,
                       warp, g, t);
      else
        store_rows<DP>(dk + size_t(bkv) * Skv * D, dkr, scale, kh, Skv, D,
                       warp, g, t);
    }
  }
}

// ---------------------------------------------------------------------------
// Launchers.
// ---------------------------------------------------------------------------

// A (heads, S, D) bf16 tensor as a 3-D map of boxes of 64 columns by `rows`
// rows, 128-byte swizzle; elements outside the tensor read as zero and are
// not written.
bool encode_map(CUtensorMap* map, const void* ptr, int heads, int S, int D,
                int rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {cuuint64_t(D), cuuint64_t(S), cuuint64_t(heads)};
  const cuuint64_t strides[2] = {cuuint64_t(D) * 2, cuuint64_t(S) * D * 2};
  const cuuint32_t box[3] = {64, cuuint32_t(rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Query-head groups of the dkdv launch: two (a cluster) while the kv
// blocks of the kv heads alone would leave SMs idle for two waves.
int dkdv_groups(int rep, int n_kv_blocks) {
  return rep >= 2 && n_kv_blocks < 2 * 132 ? 2 : 1;
}

// The dkdv launch at DP: at D <= 128 each consumer owns 64 of the CTA's
// 128 kv rows; at D = 256 the two consumers share 64 kv rows, split by
// gradient.
template <int DP, bool kCap>
struct Dkdv {
  static constexpr int kRows = DP <= 128 ? kBKV2 : kBKV;
  static auto kernel() {
    if constexpr (DP <= 128)
      return fa_bwd_dkdv_kernel<DP, kCap>;
    else
      return fa_bwd_dkdvsplit_kernel<DP, kCap>;
  }
  static size_t smem() {
    if constexpr (DP <= 128)
      return KvCfg2<DP>::kSmem;
    else
      return KvCfg<DP>::kSmem;
  }
};

// The launches of one call: all (part < 0) or only prep (0; none at D <=
// 128, where the dq launch does its work), dq (1) or dkdv (2), which reads
// what the earlier ones wrote.
template <int DP, bool kCap>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* lse, void* ws, void* dq, void* dk,
           void* dv, int BH, int BH_kv, int S, int Skv, int D, int Dh,
           int causal, int window, float softcap, int part,
           cudaStream_t stream) {
  const int rep = BH / BH_kv;
  const int S_pad = (S + kPad - 1) / kPad * kPad;
  float* lse2 = static_cast<float*>(ws);
  float* delta = lse2 + size_t(BH) * S_pad;
  const float scale =
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(Dh)));
  // 2^(c s) = e^(scale s); with a cap 2^(c t) = e^(cap t), t = tanh(scale
  // s / cap) = 1 - one_minus_tanh(s cs2).
  const float c = kCap ? static_cast<float>(double(softcap) * kLog2e)
                       : scale * kLog2e;
  const float cs2 =
      kCap ? static_cast<float>(2.0 * kLog2e / std::sqrt(double(Dh)) /
                                softcap)
           : 0.0f;

  CUtensorMap tq, tdo, to{}, tk_dq, tv_dq, tdq, tk, tv;
  if (!encode_map(&tq, q, BH, S, D, 64) ||
      !encode_map(&tdo, dout, BH, S, D, 64) ||
      (DqCfg<DP>::kPrep && !encode_map(&to, o, BH, S, D, 64)) ||
      !encode_map(&tk_dq, k, BH_kv, Skv, D, DqCfg<DP>::kBK) ||
      !encode_map(&tv_dq, v, BH_kv, Skv, D, DqCfg<DP>::kBK) ||
      !encode_map(&tdq, dq, BH, S, D, 64) ||
      !encode_map(&tk, k, BH_kv, Skv, D, 64) ||
      !encode_map(&tv, v, BH_kv, Skv, D, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto dkdv = Dkdv<DP, kCap>::kernel();
  const size_t dkdv_smem = Dkdv<DP, kCap>::smem();
  cudaError_t err = cudaFuncSetAttribute(
      fa_bwd_dq_kernel<DP, kCap>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(DqCfg<DP>::kSmem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dkdv,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(dkdv_smem));
  if (err != cudaSuccess) return static_cast<int>(err);

  // The prep launch at D = 256; at D <= 128 the dq launch does its work.
  if (!DqCfg<DP>::kPrep && (part < 0 || part == 0)) {
    const long long prep_rows = static_cast<long long>(BH) * S_pad;
    const unsigned prep_grid = static_cast<unsigned>(
        (prep_rows + kPrepThreads / 32 - 1) / (kPrepThreads / 32));
    fa_bwd_prep_kernel<<<prep_grid, kPrepThreads, 0, stream>>>(
        static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
        static_cast<const float*>(lse), lse2, delta, BH, S, S_pad, D);
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
  }
  if (part < 0 || part == 1) {
    const unsigned dq_grid = static_cast<unsigned>((S + kBQ - 1) / kBQ) * BH;
    fa_bwd_dq_kernel<DP, kCap>
        <<<dq_grid, kThreads, DqCfg<DP>::kSmem, stream>>>(
            tq, tdo, to, tk_dq, tv_dq, tdq, static_cast<const float*>(lse),
            lse2, delta, BH, rep, S, Skv, S_pad, c, cs2, scale, causal,
            window);
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
  }
  if (part >= 0 && part != 2) return 0;

  const int nkb = (Skv + Dkdv<DP, kCap>::kRows - 1) / Dkdv<DP, kCap>::kRows;
  const int groups = dkdv_groups(rep, nkb * BH_kv);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(nkb * BH_kv * groups));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = dkdv_smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(groups);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, dkdv, tq, tdo, tk, tv,
                           static_cast<const float*>(lse2),
                           static_cast<const float*>(delta),
                           static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                           BH_kv, rep, groups, S, Skv, S_pad, D, c, cs2,
                           scale, causal, window);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The launches of one call of one cap flag, by head dimension.
template <bool kCap>
int run_any(const void* q, const void* k, const void* v, const void* o,
            const void* dout, const void* lse, void* ws, void* dq, void* dk,
            void* dv, int BH, int BH_kv, int S, int Skv, int D, int Dh,
            int causal, int window, float softcap, int part,
            cudaStream_t st) {
  if (D <= 64)
    return launch<64, kCap>(q, k, v, o, dout, lse, ws, dq, dk, dv, BH, BH_kv,
                            S, Skv, D, Dh, causal, window, softcap, part, st);
  if (D <= 128)
    return launch<128, kCap>(q, k, v, o, dout, lse, ws, dq, dk, dv, BH,
                             BH_kv, S, Skv, D, Dh, causal, window, softcap,
                             part, st);
  return launch<256, kCap>(q, k, v, o, dout, lse, ws, dq, dk, dv, BH, BH_kv,
                           S, Skv, D, Dh, causal, window, softcap, part, st);
}

}  // namespace

// The capped launches: flash_attention_bwd_capped.cu compiles this
// file with REPRO_FA_CAPPED defined and holds them, so that nvcc builds
// the capped and the uncapped kernels as two sources, in parallel.
int repro_fa_bwd_bf16_capped(const void* q, const void* k, const void* v,
                             const void* o, const void* dout, const void* lse,
                             void* ws, void* dq, void* dk, void* dv, int BH,
                             int BH_kv, int S, int Skv, int D, int Dh,
                             int causal, int window, float softcap, int part,
                             cudaStream_t st);

#ifdef REPRO_FA_CAPPED

int repro_fa_bwd_bf16_capped(const void* q, const void* k, const void* v,
                             const void* o, const void* dout, const void* lse,
                             void* ws, void* dq, void* dk, void* dv, int BH,
                             int BH_kv, int S, int Skv, int D, int Dh,
                             int causal, int window, float softcap, int part,
                             cudaStream_t st) {
  return run_any<true>(q, k, v, o, dout, lse, ws, dq, dk, dv, BH, BH_kv, S,
                       Skv, D, Dh, causal, window, softcap, part, st);
}

#else

namespace {

int run(const void* q, const void* k, const void* v, const void* o,
        const void* dout, const void* lse, void* ws, void* dq, void* dk,
        void* dv, int BH, int BH_kv, int S, int Skv, int D, int Dh,
        int causal, int window, float softcap, int part, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (BH <= 0 || BH_kv <= 0 || BH % BH_kv != 0 || S <= 0 || Skv <= 0 ||
      (Skv != S && (causal || window > 0)) || D <= 0 || D % 16 != 0 ||
      D > 256 || Dh <= 0 || Dh > D || part > 2 ||
      !(softcap >= 0.0f && softcap <= 3.4e38f))
    return static_cast<int>(cudaErrorInvalidValue);
  if (softcap > 0.0f)
    return repro_fa_bwd_bf16_capped(q, k, v, o, dout, lse, ws, dq, dk, dv,
                                    BH, BH_kv, S, Skv, D, Dh, causal, window,
                                    softcap, part, st);
  return run_any<false>(q, k, v, o, dout, lse, ws, dq, dk, dv, BH, BH_kv, S,
                        Skv, D, Dh, causal, window, softcap, part, st);
}

}  // namespace

// q, o, dout, dq: (BH, S, D) bf16; k, v, dk, dv: (BH_kv, S_kv, D) bf16
// with BH_kv dividing BH and S_kv = S unless causal is 0 and window <= 0;
// lse (the forward's): (BH, S) f32; the workspace ws:
// (2, BH, S_pad) f32 with S_pad = S rounded up to 128.  Contiguous, 16-byte
// aligned, on the stream's device; D a multiple of 16 and at most 256; Dh
// (at most D) sets the softmax scale 1 / sqrt(Dh), as in the forward;
// softcap (finite, >= 0; 0 is none) the forward's cap.
// Three launches on the stream (two at D <= 128); returns the first
// nonzero cudaError_t (0 on success), cudaErrorInvalidValue for a shape
// the kernels do not take.
extern "C" int repro_flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* ws, void* dq, void* dk,
    void* dv, int BH, int BH_kv, int S, int S_kv, int D, int Dh, int causal,
    int window, float softcap, void* stream) {
  return run(q, k, v, o, dout, lse, ws, dq, dk, dv, BH, BH_kv, S, S_kv, D,
             Dh, causal, window, softcap, -1, stream);
}

// One launch of the above alone, so that each can be timed between CUDA
// events: prep (part 0; none at D <= 128), dq (1) or dkdv (2), on the
// same arguments; dq (at D = 256) and dkdv read the lse2 and Delta that
// an earlier prep or dq left in ws.
extern "C" int repro_flash_attention_bwd_bf16_part(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* ws, void* dq, void* dk,
    void* dv, int BH, int BH_kv, int S, int S_kv, int D, int Dh, int causal,
    int window, float softcap, int part, void* stream) {
  if (part < 0) return static_cast<int>(cudaErrorInvalidValue);
  return run(q, k, v, o, dout, lse, ws, dq, dk, dv, BH, BH_kv, S, S_kv, D,
             Dh, causal, window, softcap, part, stream);
}

#endif  // REPRO_FA_CAPPED
