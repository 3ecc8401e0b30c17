// Causal / sliding-window flash attention on Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py `flash_attention`
// (`_flash_kernel`), the Pallas TPU kernel of every local-attention layer's
// prefill.  On the TPU the kv-block axis is the sequential grid dimension
// and the online-softmax state (m, l, acc) lives in VMEM scratch across it.
//
// q and o are (BH, S, D) with heads folded into the batch; k and v are
// (BH_kv, S_kv, D), and row bh / (BH / BH_kv) of k and v serves query row
// bh (repeat_interleave's order: an MQA or GQA layer's kv heads are read in
// place, never expanded).  S_kv differs from S only in non-causal attention
// with no window (a cross-attention, whisper's decoder reading the
// encoder's frames; the TPU kernel takes one S).  window <= 0 means
// unbounded; a key is visible to a query when key < S_kv, (causal) key <=
// query, and (window) key > query - window.  Every bound on keys (the kv
// tiles, the masks, the k and v tensor maps, whose rows past S_kv TMA
// zero-fills) is S_kv; every bound on queries (the q blocks, lse and the
// output) is S.  kv blocks that lie wholly after the q block (causal) or
// wholly before its window are skipped, as the TPU kernel skips them.
//
// Bound on this card: operations for bf16 at long S (4 flops per visible
// score entry per head dimension against one read of q, k, v and one
// write of o; at the RecurrentGemma-9B prefill shape, q (64, 4096, 256)
// and one kv row per batch row, window 2048: ~412 GFLOP against ~290 MB;
// at Yi-6B's, q (128, 4096, 128), k, v (16, 4096, 128), causal: ~550
// GFLOP, 0.556 ms at 989 TFLOP/s), bytes for short S.
//
// bf16 design, common to both head-dimension groups: warp-specialised
// wgmma with TMA loads, CTAs of three warpgroups on 128-row q blocks.
// * Warpgroup 0 is the producer.  Under setmaxnreg.dec it gives up its
//   registers; one thread issues every TMA load through rings of stages
//   in shared memory with full and empty mbarriers.  The tensor maps are
//   3-D (D, S, heads), so rows past S are zero-filled by TMA and never
//   read from the next head; boxes are 64 columns (128 B) wide with the
//   128-byte swizzle, the layout wgmma reads without bank conflicts.
// * Warpgroups 1 and 2 are consumers, 64 q rows each, under
//   setmaxnreg.inc.  The online softmax runs on the S fragment in
//   registers (running max m and sum l per row, reduced over the 4 lanes
//   that share a row, in the base-2 domain with the scale folded in);
//   masks are evaluated only on tiles that cross the diagonal, the
//   window's edge or S (the tiles run as masked, unmasked and masked
//   stretches, so no branch sits between a product and its wait).  P is
//   rounded to bf16 in registers and is the A operand of O += P V, with V
//   read from shared memory as an MN-major (transposed) B operand; the f32
//   O accumulator (64 x D a warpgroup) stays in registers.
// * Schedule (FA3's): a consumer issues tile i's S together with tile
//   i - 1's P V and runs tile i's softmax while P V is in flight; the two
//   consumers take turns issuing their products (named barriers), so one's
//   softmax overlaps the other's products.
// * Epilogue: O / max(l, 1e-30) in bf16 is written in the swizzled layout
//   and stored by TMA, which drops the rows past S.  Each row's
//   log-sum-exp of the scaled scores, scale m + ln max(l, 1e-30), goes to
//   a (BH, S) f32 output that the backward (flash_attention_bwd.cu) reads
//   instead of re-running the forward.
//
// D = 64 and 128 (the uniform attention stack's D = 128: Yi, GLM-4,
// OLMoE, Mixtral):
// * kv tiles of 128 keys (kBK2) on three stages of K and V (32 KB each at
//   D = 128) and the q tiles of both consumers: 225 KB.  S is m64n128k16
//   with Q's fragments in registers (ldmatrix once an item, after which
//   the q tiles take the next item's) and K from shared memory (K-major).
//   A thread holds o[64], s[64], p[32] and Q's 32 words under
//   setmaxnreg's 240.
// * A persistent grid: one CTA an SM takes work items, (q block, q head)
//   pairs, from a counter (one int32, zeroed before the launch) as it
//   finishes; the items run kv head by kv head, heaviest q block first
//   within one, its q heads side by side, so that the CTAs at work read
//   the k and v of few kv heads (L2).  The producer fetches the next
//   item's index with its q tile while this item runs; a consumer's tiles
//   run as one stream over its items: the step that starts an item issues
//   its tile 0's S with the last item's last P V, and the last item's O
//   is stored from registers while the next runs.  The ring's phases run
//   on over the items.
// * Per row, the max and sum over a thread's 32 entries run as four
//   chains.
// * What holds it back: at Yi's prefill shape it reaches 0.58-0.59 of the
//   bound, and a non-causal call 0.61-0.63, SDPA's causal kernel's rate;
//   neither the softmax's chains, the q tile's reads from shared memory,
//   the ring's depth (2 or 3), the items' boundaries nor half the kv
//   loads moved it: the limit is the consumers' own pipeline; the turns
//   of the two consumers (named barriers) are worth 2.5% (NVIDIA H100
//   80GB HBM3, 700 W).
//
// D = 256 (RecurrentGemma): kv tiles of 64 keys, two stages, S m64n64k16
// with both operands in shared memory, one CTA a (q head, q block),
// heaviest q block first and its q heads side by side; the epilogue writes
// O into the consumer's own q tile and stores it by TMA.  Each consumer
// runs every tile of the q block, also one that none of its rows sees,
// whose masked softmax adds exactly 0.
//
// f32 design: exact f32 FMA, no tensor cores (no TF32), so the bound is
// the FMA rate (4 D flops a visible pair; at the f32 training shape, q (32,
// 4096, 256), k, v (2, 4096, 256), window 2048: ~206 GFLOP, 3.1 ms at 67
// TFLOP/s).  Shared memory delivers at most 32 words a clock to an SM's
// lanes, broadcast or not, against 128 FMAs, so each product is
// register-tiled: a thread keeps a micro-tile of S (4 rows by 4 keys, 0.5
// words loaded a multiply-add) and of O (8 rows by 4 kNC columns, 0.375:
// P is loaded again for each block of 4 columns, whose P V chain needs its
// own registers).
// 64-row q blocks, 256 threads (8 warps of 8 q rows, so the softmax and P
// stay within a warp); K and V in pairs of 32-row tiles, the next pair's
// K copied by cp.async during this pair's softmax and P V, its V during
// its scores; 212 KB of shared memory at D = 256.
//
// Fully masked rows of a block contribute exactly 0 (the p = 0 guard), the
// final division is floored at 1e-30, and every sum runs in a fixed order
// with no atomics and no split over kv, so two runs give bitwise equal
// outputs.
//
// Soft-capping (softcap > 0, Gemma 2's attn_logit_softcapping): each
// scaled score x = scale s becomes cap tanh(x / cap) before the mask and
// the softmax, as the reference caps its scores in jnp (the TPU kernel
// takes no cap).  The cap is a compile-time flag (kCap) of every kernel,
// so the uncapped instantiations are the code above unchanged; the capped
// ones are built from this file by flash_attention_capped.cu, a source of
// their own, beside them.  bf16: the
// softmax runs on t = tanh(x / cap) itself with c = cap log2 e in place
// of scale log2 e (2^(c t) = e^(cap t)), so the running max is t's and
// lse = ln 2 (c m + log2 l) is the log-sum-exp of the capped scores; t is
// 1 - r with r = 2 / (1 + 2^(2 log2 e x / cap)) (ex2 and rcp on the
// special-function units), whose error is a few ulps of 1, i.e. cap times
// that on the capped score: tanh.approx.f32's relative 2^-11 would move a
// saturated score of cap 50 by 0.024, twelve times bf16's rounding of P.
// Each score then takes three special-function operations in place of
// one, which at D <= 128 sit on the consumers' path beside their
// products.  f32: cap tanhf(x / cap), the accurate tanhf.  Masked entries
// are set after the cap (cap tanh(-inf) would be -cap, not -inf).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "fa32_fma.cuh"
#include "tma.cuh"

namespace {

constexpr float kNegInf = -1e30f;

__device__ __forceinline__ bool visible(int qpos, int kpos, int Skv,
                                        int causal, int window) {
  bool ok = kpos < Skv;
  if (causal) ok = ok && kpos <= qpos;
  if (window > 0) ok = ok && kpos > qpos - window;
  return ok;
}

// The TPU kernel's skip test for a (q block, kv block) pair.
__device__ __forceinline__ bool block_runs(int q_start, int k_start, int bq,
                                           int bk, int causal, int window) {
  bool run = true;
  if (causal) run = k_start <= q_start + bq - 1;
  if (window > 0) run = run && (k_start + bk - 1 > q_start - window);
  return run;
}

// ---------------------------------------------------------------------------
// bf16: wgmma and TMA, warp-specialised.
// ---------------------------------------------------------------------------

constexpr int kBQ = 128;           // q rows per CTA, 64 per consumer
constexpr int kBK = 64;            // kv rows per tile
constexpr int kBox = 64 * 128;     // one TMA box: 64 rows of 64 bf16 (128 B)
constexpr int kThreads = 384;      // producer + two consumer warpgroups
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

// Shared memory at head dimension DP (256): the q tiles of both
// consumers, the k ring, the v ring, then the mbarriers (full q; full k,
// full v, empty k and empty v per stage), after up to 1 KB of padding that
// aligns the tiles to the 1024-byte period of the 128-byte swizzle.
template <int DP>
struct Bf16Cfg {
  static constexpr int kNB = DP / 64;       // 64-column boxes in a row
  static constexpr int kStages = 2;
  static constexpr int kTile = kNB * kBox;  // one 64-row tile
  static constexpr size_t kSmem =
      1024 + size_t(2 + 2 * kStages) * kTile + 8 * (1 + 4 * kStages);
  // One CTA an SM: the H100's 227 KB of dynamic shared memory a CTA.
  static_assert(kSmem <= 232448, "bf16 tiles exceed 227 KB");
};

// The mbarriers by shared-memory address: full q, then full k, full v,
// empty k and empty v of each stage.
template <int kStages>
struct Barriers {
  uint32_t base;
  __device__ uint32_t full_q() const { return base; }
  __device__ uint32_t full_k(int s) const { return base + 8 * (1 + s); }
  __device__ uint32_t full_v(int s) const {
    return base + 8 * (1 + kStages + s);
  }
  __device__ uint32_t empty_k(int s) const {
    return base + 8 * (1 + 2 * kStages + s);
  }
  __device__ uint32_t empty_v(int s) const {
    return base + 8 * (1 + 3 * kStages + s);
  }
};

using tma::bar_arrive;
using tma::bar_arrive_tx;
using tma::bar_init;
using tma::bar_wait;
using tma::encode_tiled;
using tma::EncodeTiledFn;
using tma::smem_u32;
using tma::tma_load;
using tma::tma_store;

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

// Wait until at most N committed groups of products are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
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

// 1 - tanh(x) = 2 / (1 + e^(2x)) from x2 = 2 x log2 e: 0 where e^(2x)
// overflows, 2 where it underflows.
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

// d (+)= A B over one k16 step.  wgmma_ss_n64: A (64 x 16) and B (16 x 64)
// from shared memory, both K-major; scale_d = 0 overwrites d.  wgmma_rs: A
// from registers (the m64k16 fragment: a[0..3] hold rows g and g + 8 of
// each warp's 16, columns 2t, 2t + 1 and 2t + 8, 2t + 9), B MN-major
// (transposed) from shared memory, accumulating.  The f32 accumulator
// fragment gives each warp 16 rows: d[4n + e] is row g + 8 (e >> 1),
// column 8n + 2t + (e & 1), with g = lane / 4 and t = lane % 4.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
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

// One tile's online softmax for this thread's two rows (r0 and r0 + 8) on
// the S fragment, in place: updates the running max m (raw scores) and
// sum l, returns the rescale factor alpha of each row, and leaves
// P = 2^(c (s - m)) (c = scale * log2 e) in s.  kMask evaluates visible()
// per entry (keys below Skv); masked entries become exactly 0.  kCap
// first replaces each raw score by t = tanh(scale s / cap) (cs2 = 2
// log2 e scale / cap), on which m runs (c = cap log2 e).
template <bool kMask, bool kCap, int N>
__device__ __forceinline__ void softmax_tile(float (&s)[N],
                                             float (&m_run)[2],
                                             float (&l_run)[2],
                                             float (&alpha)[2], float c,
                                             float cs2, int r0, int k0,
                                             int Skv, int causal,
                                             int window) {
  // Each row's max and sum over the thread's entries in kC chains (one
  // at N = 32; four at N = 64, the 128-key tiles, whose chains of 32
  // would sit on the consumer's path between its products).
  constexpr int kC = N == 64 ? 4 : 1;
  float mx4[2][kC];
#pragma unroll
  for (int j = 0; j < kC; ++j) mx4[0][j] = m_run[0], mx4[1][j] = m_run[1];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if constexpr (kCap) s[i] = 1.0f - one_minus_tanh(s[i] * cs2);
    if (kMask && !visible(r0 + 8 * ((i >> 1) & 1),
                          k0 + 8 * (i >> 2) + (i & 1), Skv, causal, window))
      s[i] = kNegInf;
    float& m = mx4[(i >> 1) & 1][(i >> 2) % kC];
    m = fmaxf(m, s[i]);
  }
  float mx[2], mc[2], sum4[2][kC] = {}, sum[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = mx4[h][0];
#pragma unroll
    for (int j = 1; j < kC; ++j) mx[h] = fmaxf(mx[h], mx4[h][j]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    alpha[h] = ex2((m_run[h] - mx[h]) * c);
    m_run[h] = mx[h];
    mc[h] = mx[h] * c;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int h = (i >> 1) & 1;
    s[i] = (!kMask || s[i] > 0.5f * kNegInf) ? ex2(fmaf(s[i], c, -mc[h]))
                                             : 0.0f;
    sum4[h][(i >> 2) % kC] += s[i];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if constexpr (kC == 4)
      sum[h] = (sum4[h][0] + sum4[h][1]) + (sum4[h][2] + sum4[h][3]);
    else
      sum[h] = sum4[h][0];
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
    l_run[h] = l_run[h] * alpha[h] + sum[h];
  }
}

// The S = Q K^T products of one tile: D / 16 k16 steps, each in box
// kk / 4 at a 32-byte column step kk % 4.
template <int DP>
__device__ __forceinline__ void issue_qk(float (&s)[32], uint64_t q_desc,
                                         uint64_t k_desc) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t off = ((kk / 4) * kBox + (kk % 4) * 32) >> 4;
    wgmma_ss_n64(s, q_desc + off, k_desc + off, kk > 0);
  }
}

// O += P V over one tile's four k16 steps.  V (64 keys x DP) is B,
// MN-major: 64-column boxes kBox apart (leading offset), 8-key groups
// 1024 B apart (stride offset); step j starts 16 rows (2048 B) further.
// P's A fragment of step j is p[4j .. 4j + 3]: the S fragment's columns
// 16j .. 16j + 15, packed in pairs.
template <int DP>
__device__ __forceinline__ void issue_pv(float (&o)[DP / 2],
                                         const uint32_t (&p)[16],
                                         uint64_t v_desc) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wgmma_rs(o, p + 4 * j, v_desc + ((j * 2048) >> 4));
}

template <int DP>
__device__ __forceinline__ void rescale_pack(float (&o)[DP / 2],
                                             uint32_t (&p)[16],
                                             const float (&s)[32],
                                             const float (&alpha)[2]) {
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    o[4 * n] *= alpha[0];
    o[4 * n + 1] *= alpha[0];
    o[4 * n + 2] *= alpha[1];
    o[4 * n + 3] *= alpha[1];
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) p[j] = pack2(s[2 * j], s[2 * j + 1]);
}

__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Lane 0 of each consumer warp releases a stage's k or v tile.
__device__ __forceinline__ void release(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0) bar_arrive(bar);
}

// Whether every (q, key) pair of a 64-row warpgroup block and a kv tile is
// visible, so that its softmax needs no mask.
__device__ __forceinline__ bool tile_full(int k_start, int q0, int Skv,
                                          int causal, int window) {
  return k_start + kBK <= Skv && (!causal || k_start + kBK - 1 <= q0) &&
         (window <= 0 || k_start > q0 + 63 - window);
}

// One step i >= 1 of the overlapped schedule: tile i's S = Q K^T and tile
// i - 1's O += P V issued together in this consumer's turn, tile i's
// softmax while P V runs, then O rescaled and tile i's P packed.
template <int DP, bool kCap>
struct OverlapStep {
  static constexpr int kStages = Bf16Cfg<DP>::kStages;
  static constexpr int kTile = Bf16Cfg<DP>::kTile;
  uint32_t k_ring, v_ring;
  Barriers<kStages> bars;
  uint64_t q_desc;
  float c, cs2;
  int r0, Skv, causal, window, h, lane;

  template <bool kMask>
  __device__ __forceinline__ void run(float (&o)[DP / 2], float (&s)[32],
                                      uint32_t (&p)[16], float (&m_run)[2],
                                      float (&l_run)[2], int i,
                                      int k0) const {
    const int st = i % kStages, parity = (i / kStages) & 1;
    const int pst = (i - 1) % kStages, ppar = ((i - 1) / kStages) & 1;
    float alpha[2];
    bar_wait(bars.full_k(st), parity);
    bar_wait(bars.full_v(pst), ppar);
    named_sync(3 + h, 256);
    wgmma_fence();
    issue_qk<DP>(s, q_desc, sw128_desc(k_ring + st * kTile, 16, 1024));
    wgmma_commit();
    issue_pv<DP>(o, p, sw128_desc(v_ring + pst * kTile, kBox, 1024));
    wgmma_commit();
    named_arrive(4 - h, 256);
    wgmma_wait<1>();
    fence_regs(s);
    softmax_tile<kMask, kCap>(s, m_run, l_run, alpha, c, cs2, r0, k0, Skv,
                              causal, window);
    release(bars.empty_k(st), lane);
    wgmma_wait<0>();
    fence_regs(o);
    release(bars.empty_v(pst), lane);
    rescale_pack<DP>(o, p, s, alpha);
  }
};

template <int DP, bool kCap>
__global__ void __launch_bounds__(kThreads, 1)
flash_bf16_kernel(__grid_constant__ const CUtensorMap tq,
                  __grid_constant__ const CUtensorMap tk,
                  __grid_constant__ const CUtensorMap tv,
                  __grid_constant__ const CUtensorMap to,
                  float* __restrict__ lse, int BH, int rep, int S, int Skv,
                  float c, float cs2, int causal, int window) {
  using Cfg = Bf16Cfg<DP>;
  constexpr int kNB = Cfg::kNB, kStages = Cfg::kStages, kTile = Cfg::kTile;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* Qs = base;                   // [consumer][box][64][128 B]
  unsigned char* Ks = Qs + 2 * kTile;         // [stage][box][64][128 B]
  unsigned char* Vs = Ks + kStages * kTile;
  const Barriers<kStages> bars{smem_u32(Vs + kStages * kTile)};

  // Heaviest q blocks (last under causal) first; the heads of one q block
  // side by side.  The q block's kv tiles are kb_lo .. kb_lo + n_tiles - 1
  // (block_runs holds on one contiguous range).
  const int nqb = (S + kBQ - 1) / kBQ;
  const int bh = blockIdx.x % BH;
  const int q_start = (nqb - 1 - static_cast<int>(blockIdx.x) / BH) * kBQ;
  const int nk = (Skv + kBK - 1) / kBK;
  const int kb_end = causal ? min(nk, (q_start + kBQ - 1) / kBK + 1) : nk;
  int kb_lo = 0;
  while (kb_lo < kb_end &&
         !block_runs(q_start, kb_lo * kBK, kBQ, kBK, causal, window))
    ++kb_lo;
  const int n_tiles = kb_end - kb_lo;

  if (threadIdx.x == 0) {
    bar_init(bars.full_q(), 1);
    for (int s = 0; s < kStages; ++s) {
      bar_init(bars.full_k(s), 1);
      bar_init(bars.full_v(s), 1);
      bar_init(bars.empty_k(s), 8);   // lane 0 of each consumer warp
      bar_init(bars.empty_v(s), 8);
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
      bar_arrive_tx(bars.full_q(), 2 * kTile);
      for (int h = 0; h < 2; ++h)
        for (int j = 0; j < kNB; ++j)
          tma_load(Qs + (h * kNB + j) * kBox, &tq, 64 * j, q_start + 64 * h,
                   bh, bars.full_q());
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages, parity = ((i / kStages) & 1) ^ 1;
        const int row = (kb_lo + i) * kBK;
        bar_wait(bars.empty_k(st), parity);
        bar_arrive_tx(bars.full_k(st), kTile);
        for (int j = 0; j < kNB; ++j)
          tma_load(Ks + st * kTile + j * kBox, &tk, 64 * j, row, bkv,
                   bars.full_k(st));
        bar_wait(bars.empty_v(st), parity);
        bar_arrive_tx(bars.full_v(st), kTile);
        for (int j = 0; j < kNB; ++j)
          tma_load(Vs + st * kTile + j * kBox, &tv, 64 * j, row, bkv,
                   bars.full_v(st));
      }
    }
  } else {
    // Consumers.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        kConsumerRegs));
    const int h = threadIdx.x / 128 - 1;  // consumer 0 or 1
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int g = lane >> 2, t = lane & 3;
    const int q0 = q_start + 64 * h;      // the warpgroup's first row
    const int r0 = q0 + 16 * warp + g;    // this thread's rows: r0, r0 + 8
    unsigned char* Qh = Qs + h * kTile;
    const uint64_t q_desc = sw128_desc(smem_u32(Qh), 16, 1024);
    const uint32_t k_ring = smem_u32(Ks), v_ring = smem_u32(Vs);

    float o[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.0f;
    float s[32] = {};   // written by the first k16 step of every tile
    uint32_t p[16];
    float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.0f, 0.0f};

    bar_wait(bars.full_q(), 0);
    if (n_tiles > 0) {
      // Tile 0 alone: its S and its softmax, masked (the first tile
      // usually holds the window's edge or the first block's diagonal).
      if (h == 1) named_arrive(3, 256);   // consumer 0 goes first
      float alpha[2];
      bar_wait(bars.full_k(0), 0);
      named_sync(3 + h, 256);
      wgmma_fence();
      issue_qk<DP>(s, q_desc, sw128_desc(k_ring, 16, 1024));
      wgmma_commit();
      named_arrive(4 - h, 256);
      wgmma_wait<0>();
      fence_regs(s);
      softmax_tile<true, kCap>(s, m_run, l_run, alpha, c, cs2, r0,
                               kb_lo * kBK + 2 * t, Skv, causal, window);
      release(bars.empty_k(0), lane);
      rescale_pack<DP>(o, p, s, alpha);

      // Tiles 1 .. n_tiles - 1 in three runs: masked, unmasked [f0, f1),
      // masked (the diagonal, S_kv's edge).
      int f0 = n_tiles, f1 = n_tiles;
      for (int i = n_tiles - 1; i >= 1; --i)
        if (tile_full((kb_lo + i) * kBK, q0, Skv, causal, window)) {
          if (f1 == n_tiles) f1 = i + 1;
          f0 = i;
        }
      const OverlapStep<DP, kCap> step{k_ring, v_ring, bars, q_desc, c,
                                       cs2, r0, Skv, causal, window, h,
                                       lane};
      for (int i = 1; i < f0; ++i)
        step.template run<true>(o, s, p, m_run, l_run, i,
                                (kb_lo + i) * kBK + 2 * t);
      for (int i = f0; i < f1; ++i)
        step.template run<false>(o, s, p, m_run, l_run, i, 0);
      for (int i = f1; i < n_tiles; ++i)
        step.template run<true>(o, s, p, m_run, l_run, i,
                                (kb_lo + i) * kBK + 2 * t);

      // The last tile's P V alone.
      const int last = n_tiles - 1;
      const int lst = last % kStages;
      bar_wait(bars.full_v(lst), (last / kStages) & 1);
      wgmma_fence();
      issue_pv<DP>(o, p, sw128_desc(v_ring + lst * kTile, kBox, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      release(bars.empty_v(lst), lane);
      if (h == 0) named_sync(3, 256);   // consumer 1's last arrival
    }

    // Epilogue: O / l in bf16 into this warpgroup's q tile (swizzled as
    // TMA wrote it), then one TMA store per box; rows past S are dropped.
    const float d0 = fmaxf(l_run[0], 1e-30f);
    const float d1 = fmaxf(l_run[1], 1e-30f);
    const int row = 16 * warp + g;
    if (t == 0) {   // the four lanes of a row hold the same m and l
      const float ln2 = 0.6931471805599453f;
      float* lr = lse + static_cast<size_t>(bh) * S;
      if (r0 < S) lr[r0] = (m_run[0] * c + log2f(d0)) * ln2;
      if (r0 + 8 < S) lr[r0 + 8] = (m_run[1] * c + log2f(d1)) * ln2;
    }
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      unsigned char* at =
          Qh + (n / 8) * kBox + (((n % 8) ^ g) << 4) + 4 * t;
      *reinterpret_cast<uint32_t*>(at + row * 128) =
          pack2(o[4 * n] / d0, o[4 * n + 1] / d0);
      *reinterpret_cast<uint32_t*>(at + (row + 8) * 128) =
          pack2(o[4 * n + 2] / d1, o[4 * n + 3] / d1);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    named_sync(1 + h, 128);
    if (threadIdx.x % 128 == 0) {
      for (int j = 0; j < kNB; ++j)
        tma_store(&to, Qh + j * kBox, 64 * j, q0, bh);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 at head dimension 64 and 128: 128-key tiles on a persistent grid.
// ---------------------------------------------------------------------------

constexpr int kBK2 = 128;             // kv rows per tile
constexpr int kKVBox = kBK2 * 128;    // one 64-column box of a kv tile

// Shared memory at head dimension DP (64 or 128): the q tiles of both
// consumers (read into registers when an item starts, then free for the
// next item's), the k ring, the v ring (kv tiles as [box][128 rows][128
// B]), the mbarriers (full and empty q; full k, full v, empty k and empty
// v per stage), then the q tiles' work item.
template <int DP>
struct Bf16Cfg2 {
  static constexpr int kNB = DP / 64;
  static constexpr int kStages = 3;
  static constexpr int kQTile = kNB * kBox;      // 64 rows
  static constexpr int kKVTile = kNB * kKVBox;   // 128 rows
  static constexpr size_t kSmem = 1024 + size_t(2) * kQTile +
                                  size_t(2 * kStages) * kKVTile +
                                  8 * (2 + 4 * kStages) + 16;
  static_assert(kSmem <= 232448, "bf16 tiles exceed 227 KB");
};

template <int kStages>
struct Barriers2 {
  uint32_t base;
  __device__ uint32_t full_q() const { return base; }
  __device__ uint32_t empty_q() const { return base + 8; }
  __device__ uint32_t full_k(int s) const { return base + 8 * (2 + s); }
  __device__ uint32_t full_v(int s) const {
    return base + 8 * (2 + kStages + s);
  }
  __device__ uint32_t empty_k(int s) const {
    return base + 8 * (2 + 2 * kStages + s);
  }
  __device__ uint32_t empty_v(int s) const {
    return base + 8 * (2 + 3 * kStages + s);
  }
};

// d (+)= A B over one k16 step, A from registers (the m64k16 fragment), B
// (128 rows) K-major from shared memory; scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
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
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
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

// S = Q K^T over one 128-key tile: DP / 16 k16 steps of m64n128k16, Q's
// fragments from registers, K's step kk in box kk / 4 (kKVBox apart) at a
// 32-byte column step kk % 4.
template <int DP>
__device__ __forceinline__ void issue_qk2(float (&s)[64],
                                          const uint32_t (&qa)[DP / 16][4],
                                          uint64_t k_desc) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    wgmma_rs_n128(s, qa[kk],
                  k_desc + (((kk / 4) * kKVBox + (kk % 4) * 32) >> 4),
                  kk > 0);
}

// O += P V over one 128-key tile's eight k16 steps: V's 64-column boxes
// kKVBox apart (leading offset), 8-key groups 1024 B apart; step j starts
// 16 keys (2048 B) further, P's fragment p[4j .. 4j + 3].
template <int DP>
__device__ __forceinline__ void issue_pv2(float (&o)[DP / 2],
                                          const uint32_t (&p)[32],
                                          uint64_t v_desc) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
    wgmma_rs(o, p + 4 * j, v_desc + ((j * 2048) >> 4));
}

template <int DP>
__device__ __forceinline__ void rescale_pack2(float (&o)[DP / 2],
                                              uint32_t (&p)[32],
                                              const float (&s)[64],
                                              const float (&alpha)[2]) {
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    o[4 * n] *= alpha[0];
    o[4 * n + 1] *= alpha[0];
    o[4 * n + 2] *= alpha[1];
    o[4 * n + 3] *= alpha[1];
  }
#pragma unroll
  for (int j = 0; j < 32; ++j) p[j] = pack2(s[2 * j], s[2 * j + 1]);
}

// Whether every (q, key) pair of a 64-row warpgroup block and a 128-key
// tile is visible.
__device__ __forceinline__ bool tile_full2(int k_start, int q0, int Skv,
                                           int causal, int window) {
  return k_start + kBK2 <= Skv && (!causal || k_start + kBK2 - 1 <= q0) &&
         (window <= 0 || k_start > q0 + 63 - window);
}

// Work item idx of the persistent grid, a (128-row q block, q head) pair:
// kv head by kv head, and within one its q blocks heaviest first (last
// under causal), the q heads that share it side by side, so that the
// CTAs at work at one time read the k and v of few kv heads (L2).  The
// CTAs take items in this order from a counter as they finish their last
// one; each output is written by one CTA whatever the order, so the
// order does not touch the result.
struct Item {
  int bh, q_start, kb_lo, n_tiles;
};

__device__ __forceinline__ Item item_of(int idx, int rep, int S, int Skv,
                                        int causal, int window) {
  const int nqb = (S + kBQ - 1) / kBQ;
  const int per_kv = nqb * rep;
  const int w = idx % per_kv;
  Item it;
  it.bh = (idx / per_kv) * rep + w % rep;
  it.q_start = (nqb - 1 - w / rep) * kBQ;
  const int nk = (Skv + kBK2 - 1) / kBK2;
  const int kb_end =
      causal ? min(nk, (it.q_start + kBQ - 1) / kBK2 + 1) : nk;
  it.kb_lo = window > 0 ? max(0, it.q_start - window + 1) / kBK2 : 0;
  it.n_tiles = kb_end - it.kb_lo;
  return it;
}

// One step i >= 1 of an item (`it`: the tile's index on the ring, counted
// over the CTA's items): tile i's S and tile i - 1's O += P V issued in
// this consumer's turn, tile i's softmax while P V runs, O rescaled and
// tile i's P packed.
template <int DP, bool kCap>
struct OverlapStep2 {
  static constexpr int kStages = Bf16Cfg2<DP>::kStages;
  static constexpr int kKVTile = Bf16Cfg2<DP>::kKVTile;
  uint32_t k_ring, v_ring;
  Barriers2<kStages> bars;
  float c, cs2;
  int r0, Skv, causal, window, h, lane;

  template <bool kMask>
  __device__ __forceinline__ void run(float (&o)[DP / 2], float (&s)[64],
                                      uint32_t (&p)[32],
                                      const uint32_t (&qa)[DP / 16][4],
                                      float (&m_run)[2], float (&l_run)[2],
                                      int it, int k0) const {
    const int st = it % kStages, parity = (it / kStages) & 1;
    const int pst = (it - 1) % kStages, ppar = ((it - 1) / kStages) & 1;
    float alpha[2];
    bar_wait(bars.full_k(st), parity);
    bar_wait(bars.full_v(pst), ppar);
    named_sync(3 + h, 256);
    wgmma_fence();
    issue_qk2<DP>(s, qa, sw128_desc(k_ring + st * kKVTile, 16, 1024));
    wgmma_commit();
    issue_pv2<DP>(o, p, sw128_desc(v_ring + pst * kKVTile, kKVBox, 1024));
    wgmma_commit();
    named_arrive(4 - h, 256);
    wgmma_wait<1>();
    fence_regs(s);
    softmax_tile<kMask, kCap>(s, m_run, l_run, alpha, c, cs2, r0, k0, Skv,
                              causal, window);
    release(bars.empty_k(st), lane);
    wgmma_wait<0>();
    fence_regs(o);
    release(bars.empty_v(pst), lane);
    rescale_pack2<DP>(o, p, s, alpha);
  }
};

// Tile 0's softmax of an item from a fresh running max and sum, masked
// unless every pair of the tile is visible.
template <bool kCap>
__device__ __forceinline__ void softmax_first(float (&s)[64], float (&m)[2],
                                              float (&l)[2], float c,
                                              float cs2, int r0, int q0,
                                              int k0, int t, int Skv,
                                              int causal, int window) {
  float alpha[2];
  m[0] = m[1] = kNegInf;
  l[0] = l[1] = 0.0f;
  if (tile_full2(k0, q0, Skv, causal, window))
    softmax_tile<false, kCap>(s, m, l, alpha, c, cs2, r0, 0, Skv, causal,
                              window);
  else
    softmax_tile<true, kCap>(s, m, l, alpha, c, cs2, r0, k0 + 2 * t, Skv,
                             causal, window);
}

// The epilogue of this thread's rows r0 and r0 + 8 of head bh: each
// row's lse, and O / l in bf16 stored from registers (a row's four lanes
// write 16 contiguous bytes; rows past S and columns past D dropped), so
// that no shared memory waits on the store.
template <int DP>
__device__ __forceinline__ void store_rows(
    const float (&o)[DP / 2], const float (&m)[2], const float (&l)[2],
    float c, float* lse, __nv_bfloat16* out, int bh, int r0, int S, int D,
    int t) {
  const float d[2] = {fmaxf(l[0], 1e-30f), fmaxf(l[1], 1e-30f)};
  const float ln2 = 0.6931471805599453f;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = r0 + 8 * hr;
    if (r >= S) continue;
    if (t == 0)
      lse[static_cast<size_t>(bh) * S + r] =
          (m[hr] * c + log2f(d[hr])) * ln2;
    __nv_bfloat16* orow = out + (static_cast<size_t>(bh) * S + r) * D;
#pragma unroll
    for (int nn = 0; nn < DP / 8; ++nn) {
      const int col = 8 * nn + 2 * t;
      if (col < D)
        *reinterpret_cast<uint32_t*>(orow + col) =
            pack2(o[4 * nn + 2 * hr] / d[hr], o[4 * nn + 2 * hr + 1] / d[hr]);
    }
  }
}

template <int DP, bool kCap>
__global__ void __launch_bounds__(kThreads, 1)
flash_bf16_persistent_kernel(__grid_constant__ const CUtensorMap tq,
                             __grid_constant__ const CUtensorMap tk,
                             __grid_constant__ const CUtensorMap tv,
                             __nv_bfloat16* __restrict__ out,
                             float* __restrict__ lse, int* __restrict__ next,
                             int BH, int rep, int S, int Skv, int D, float c,
                             float cs2, int causal, int window) {
  using Cfg = Bf16Cfg2<DP>;
  constexpr int kNB = Cfg::kNB, kStages = Cfg::kStages;
  constexpr int kQTile = Cfg::kQTile, kKVTile = Cfg::kKVTile;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* Qs = base;              // [consumer][box][64][128 B]
  unsigned char* Ks = Qs + 2 * kQTile;   // [stage][box][128][128 B]
  unsigned char* Vs = Ks + kStages * kKVTile;
  unsigned char* bar_mem = Vs + kStages * kKVTile;
  const Barriers2<kStages> bars{smem_u32(bar_mem)};
  volatile int* q_item =
      reinterpret_cast<volatile int*>(bar_mem + 8 * (2 + 4 * kStages));
  const int total = ((S + kBQ - 1) / kBQ) * BH;

  if (threadIdx.x == 0) {
    bar_init(bars.full_q(), 1);
    bar_init(bars.empty_q(), 8);   // lane 0 of each consumer warp
    for (int s = 0; s < kStages; ++s) {
      bar_init(bars.full_k(s), 1);
      bar_init(bars.full_v(s), 1);
      bar_init(bars.empty_k(s), 8);
      bar_init(bars.empty_v(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // Producer: item k's index from the counter with its q tiles (once
    // the consumers hold item k - 1's q in registers), then its kv tiles
    // through the ring, whose stages and phases run on over the items; an
    // index past the last item ends the CTA's consumers.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kProducerRegs));
    if (threadIdx.x == 0) {
      int it = 0;
      for (int k = 0;; ++k) {
        if (k >= 1) bar_wait(bars.empty_q(), (k - 1) & 1);
        const int idx = atomicAdd(next, 1);
        *q_item = idx;
        if (idx >= total) {
          bar_arrive(bars.full_q());
          break;
        }
        const Item item = item_of(idx, rep, S, Skv, causal, window);
        bar_arrive_tx(bars.full_q(), 2 * kQTile);
        for (int h = 0; h < 2; ++h)
          for (int j = 0; j < kNB; ++j)
            tma_load(Qs + (h * kNB + j) * kBox, &tq, 64 * j,
                     item.q_start + 64 * h, item.bh, bars.full_q());
        const int bkv = item.bh / rep;
        for (int i = 0; i < item.n_tiles; ++i, ++it) {
          const int st = it % kStages, parity = ((it / kStages) & 1) ^ 1;
          const int row = (item.kb_lo + i) * kBK2;
          bar_wait(bars.empty_k(st), parity);
          bar_arrive_tx(bars.full_k(st), kKVTile);
          for (int j = 0; j < kNB; ++j)
            tma_load(Ks + st * kKVTile + j * kKVBox, &tk, 64 * j, row, bkv,
                     bars.full_k(st));
          bar_wait(bars.empty_v(st), parity);
          bar_arrive_tx(bars.full_v(st), kKVTile);
          for (int j = 0; j < kNB; ++j)
            tma_load(Vs + st * kKVTile + j * kKVBox, &tv, 64 * j, row, bkv,
                     bars.full_v(st));
        }
      }
    }
  } else {
    // Consumers: 64 q rows of each item each, taking turns (named
    // barriers 3 and 4) over the CTA's items, whose tiles run as one
    // stream: the step that starts an item issues its tile 0's S together
    // with the last item's last P V, runs tile 0's softmax while P V
    // runs, and then stores the last item's output.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        kConsumerRegs));
    const int h = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane >> 2, t = lane & 3;
    const uint32_t k_ring = smem_u32(Ks), v_ring = smem_u32(Vs);
    const int row = 16 * warp + g;
    if (h == 1) named_arrive(3, 256);   // consumer 0 goes first

    float o[DP / 2];
    float s[64] = {};   // written by the first k16 step of every tile
    uint32_t p[32];
    uint32_t qa[DP / 16][4];   // the item's Q as A fragments
    float m_run[2], l_run[2];

    int it = 0;   // the ring's tile of the current item's tile 0
    bar_wait(bars.full_q(), 0);
    int idx = *q_item;
    if (idx < total) {
      // The CTA's first item: tile 0's S alone.
      Item item = item_of(idx, rep, S, Skv, causal, window);
      int q0 = item.q_start + 64 * h;
      load_a_frags<DP>(qa, Qs + h * kQTile, warp, lane);
      release(bars.empty_q(), lane);
      {
        const int st = it % kStages;
        bar_wait(bars.full_k(st), (it / kStages) & 1);
        named_sync(3 + h, 256);
        wgmma_fence();
        issue_qk2<DP>(s, qa, sw128_desc(k_ring + st * kKVTile, 16, 1024));
        wgmma_commit();
        named_arrive(4 - h, 256);
        wgmma_wait<0>();
        fence_regs(s);
        softmax_first<kCap>(s, m_run, l_run, c, cs2, q0 + row, q0,
                            item.kb_lo * kBK2, t, Skv, causal, window);
        release(bars.empty_k(st), lane);
#pragma unroll
        for (int i = 0; i < DP / 2; ++i) o[i] = 0.0f;
#pragma unroll
        for (int j = 0; j < 32; ++j) p[j] = pack2(s[2 * j], s[2 * j + 1]);
      }
      for (int k = 0;; ++k) {
        const int n = item.n_tiles;
        const int k_lo = item.kb_lo * kBK2;
        const int r0 = q0 + row;         // this thread's rows: r0, r0 + 8

        // Tiles 1 .. n - 1 in three runs: masked, unmasked [f0, f1),
        // masked.
        int f0 = n, f1 = n;
        for (int i = n - 1; i >= 1; --i)
          if (tile_full2(k_lo + i * kBK2, q0, Skv, causal, window)) {
            if (f1 == n) f1 = i + 1;
            f0 = i;
          }
        const OverlapStep2<DP, kCap> step{k_ring, v_ring, bars, c, cs2, r0,
                                          Skv, causal, window, h, lane};
        for (int i = 1; i < f0; ++i)
          step.template run<true>(o, s, p, qa, m_run, l_run, it + i,
                                  k_lo + i * kBK2 + 2 * t);
        for (int i = f0; i < f1; ++i)
          step.template run<false>(o, s, p, qa, m_run, l_run, it + i, 0);
        for (int i = f1; i < n; ++i)
          step.template run<true>(o, s, p, qa, m_run, l_run, it + i,
                                  k_lo + i * kBK2 + 2 * t);

        const int last = it + n - 1;     // the ring's tile of the last P V
        const int lst = last % kStages;
        it += n;
        bar_wait(bars.full_q(), (k + 1) & 1);
        idx = *q_item;
        if (idx >= total) {
          // The CTA's last item: its last P V alone, then its output.
          bar_wait(bars.full_v(lst), (last / kStages) & 1);
          wgmma_fence();
          issue_pv2<DP>(o, p,
                        sw128_desc(v_ring + lst * kKVTile, kKVBox, 1024));
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(o);
          release(bars.empty_v(lst), lane);
          store_rows<DP>(o, m_run, l_run, c, lse, out, item.bh, r0, S, D, t);
          break;
        }
        // The next item's tile 0 S with this item's last P V.
        const Item next = item_of(idx, rep, S, Skv, causal, window);
        const int nq0 = next.q_start + 64 * h;
        load_a_frags<DP>(qa, Qs + h * kQTile, warp, lane);
        release(bars.empty_q(), lane);
        const int st = it % kStages;
        bar_wait(bars.full_k(st), (it / kStages) & 1);
        bar_wait(bars.full_v(lst), (last / kStages) & 1);
        named_sync(3 + h, 256);
        wgmma_fence();
        issue_qk2<DP>(s, qa, sw128_desc(k_ring + st * kKVTile, 16, 1024));
        wgmma_commit();
        issue_pv2<DP>(o, p, sw128_desc(v_ring + lst * kKVTile, kKVBox, 1024));
        wgmma_commit();
        named_arrive(4 - h, 256);
        wgmma_wait<1>();
        fence_regs(s);
        // The next item's softmax, from a fresh max and sum, while P V
        // runs; then this item's output.
        float m_new[2], l_new[2];
        softmax_first<kCap>(s, m_new, l_new, c, cs2, nq0 + row, nq0,
                            next.kb_lo * kBK2, t, Skv, causal, window);
        release(bars.empty_k(st), lane);
        wgmma_wait<0>();
        fence_regs(o);
        release(bars.empty_v(lst), lane);
        store_rows<DP>(o, m_run, l_run, c, lse, out, item.bh, r0, S, D, t);
        m_run[0] = m_new[0], m_run[1] = m_new[1];
        l_run[0] = l_new[0], l_run[1] = l_new[1];
#pragma unroll
        for (int i = 0; i < DP / 2; ++i) o[i] = 0.0f;
#pragma unroll
        for (int j = 0; j < 32; ++j) p[j] = pack2(s[2 * j], s[2 * j + 1]);
        item = next;
        q0 = nq0;
      }
    }
    if (h == 0) named_sync(3, 256);   // consumer 1's last arrival
  }
}

// ---------------------------------------------------------------------------
// f32 with exact FMA arithmetic.
// ---------------------------------------------------------------------------

constexpr int kBQ32 = 64;        // q rows of a CTA, 8 a warp
constexpr int kBK32 = 32;        // kv rows of a tile
constexpr int kT32 = 256;        // 8 warps
constexpr int kStages32 = 2;     // K and V tiles in flight: a pair
constexpr int kPL32 = kStages32 * kBK32 + 4;   // row stride of P

// At head dimension DP (64, 128 or 256): the columns of O the lanes cover
// (4 a lane, 128 a warp, so at least 128), the row stride of a staged tile
// (4 floats of padding, so a quarter-warp's 16-byte loads of 8 rows 1 or 2
// apart fall on distinct banks), the float4 columns a lane owns, and the
// dynamic shared memory: Q, a pair of K tiles and of V tiles, P.
template <int DP>
struct F32Cfg {
  static constexpr int kDW = DP < 128 ? 128 : DP;
  static constexpr int kLD = kDW + 4;
  static constexpr int kNC = kDW / 128;
  static constexpr int kKV = kBK32 * kLD;   // floats of one K or V tile
  static constexpr size_t kSmem =
      sizeof(float) * (kBQ32 * kLD + 2 * kStages32 * kKV + kBQ32 * kPL32);
  static_assert(kSmem <= 232448, "f32 tiles exceed 227 KB");
};

// Rows [r0, r0 + ROWS) of a (S, D) f32 matrix into `dst` (row stride kLD,
// kDW columns) by the CTA's threads (fa32_fma.cuh).
template <int DP, int ROWS>
__device__ __forceinline__ void stage_f32(float* dst,
                                          const float* __restrict__ src,
                                          int r0, int S, int D) {
  fa32::stage<F32Cfg<DP>::kLD, F32Cfg<DP>::kDW, ROWS, kT32>(dst, src, r0, S,
                                                            D, threadIdx.x);
}

using fa32::axpy4;
using fa32::comp;
using fa32::dot4;
using fa32::ld4;

// One CTA a (64-row q block, q head), heaviest q block first and, within
// a q block, q heads in order (those of a kv head side by side).  Warp w
// owns q rows 8 w .. 8 w + 7.  The kv tiles the block sees go in pairs
// (64 keys; the last pair may hold one tile).  Scores of a pair: lane
// 16 g + j holds rows 8 w + 4 g + i (i < 4) against keys j + 16 c (c < 4;
// c < 2 the pair's first tile), built over D by 16-byte loads (0.5 shared
// words a multiply-add); each row's max and sum reduce over the 16 lanes
// of its keys.  P goes to the warp's own rows of shared memory.  O: a lane
// holds 8 rows by kNC float4 columns 4 (lane + 32 h), fed by a broadcast
// of P and one 16-byte load of V a key (0.375 words a multiply-add).  The
// next pair's K is copied (cp.async) while this pair's softmax and P V
// run, its V while its own scores run.  Every sum runs in the first
// design's order (its 32 x 32 tiles), so O and lse are bitwise its
// own: the scores one fmaf chain over D, the online softmax updated tile
// by tile, each tile's sum a butterfly over its 32 keys, its P V a chain
// over its keys added to O alpha.
template <int DP, bool kCap>
__global__ void __launch_bounds__(kT32, 1)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int BH, int S, int Skv, int D,
                 int rep, float scale, float cap, int causal, int window) {
  using C = F32Cfg<DP>;
  constexpr int kPair = 2 * kBK32;              // keys of a pair
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);   // (kBQ32, kLD)
  float* Ks = Qs + kBQ32 * C::kLD;              // (kPair, kLD)
  float* Vs = Ks + kPair * C::kLD;              // (kPair, kLD)
  float* Ps = Vs + kPair * C::kLD;              // (kBQ32, kPL32)

  const int nq = (S + kBQ32 - 1) / kBQ32;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x / BH)) * kBQ32;
  const int bh = static_cast<int>(blockIdx.x % BH);
  const size_t off = static_cast<size_t>(bh) * S * D;
  const size_t off_kv = static_cast<size_t>(bh / rep) * Skv * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 16, j16 = lane % 16;
  const int sr = 8 * warp + 4 * g;              // score rows sr + i
  float* Pw = Ps + 8 * warp * kPL32;

  // The kv tiles the q block sees: one contiguous range, in pairs.
  const int nk = (Skv + kBK32 - 1) / kBK32;
  int lo = 0, hi = nk - 1;
  while (lo < nk && !block_runs(q0, lo * kBK32, kBQ32, kBK32, causal, window))
    ++lo;
  while (hi >= lo && !block_runs(q0, hi * kBK32, kBQ32, kBK32, causal, window))
    --hi;
  const int n_pairs = hi >= lo ? (hi - lo + 2) / 2 : 0;

  stage_f32<DP, kBQ32>(Qs, q + off, q0, S, D);
  if (n_pairs > 0) stage_f32<DP, kPair>(Ks, k + off_kv, lo * kBK32, Skv, D);
  fa32::commit();
  if (n_pairs > 0) stage_f32<DP, kPair>(Vs, v + off_kv, lo * kBK32, Skv, D);
  fa32::commit();

  float acc[8][C::kNC][4];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int h = 0; h < C::kNC; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][h][e] = 0.0f;
  float m_run[4], l_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m_run[i] = kNegInf, l_run[i] = 0.0f;

  for (int pr = 0; pr < n_pairs; ++pr) {
    const int t0 = lo + 2 * pr;
    const int tiles = t0 < hi ? 2 : 1;
    const bool more = pr + 1 < n_pairs;
    fa32::wait<1>();   // this pair's K is in (its V may not be)
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.0f;
#pragma unroll 2
    for (int d = 0; d < DP; d += 4) {
      float4 qa[4], kf[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = ld4(Qs + (sr + i) * C::kLD + d);
#pragma unroll
      for (int c = 0; c < 4; ++c) kf[c] = ld4(Ks + (j16 + 16 * c) * C::kLD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[i][c] = dot4(qa[i], kf[c], s[i][c]);
    }
    __syncthreads();   // every warp is past this pair's K
    if (more) {
      stage_f32<DP, kPair>(Ks, k + off_kv, (t0 + 2) * kBK32, Skv, D);
      fa32::commit();
    }

    // The online softmax of rows sr + i, tile by tile.
    float alpha[2][4];
#pragma unroll
    for (int tt = 0; tt < 2; ++tt) {
      if (tt == tiles) break;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qpos = q0 + sr + i;
        float x[2], p[2];
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const int c = 2 * tt + b;
          float xc = s[i][c] * scale;
          if constexpr (kCap) xc = tanhf(xc / cap) * cap;
          x[b] = visible(qpos, t0 * kBK32 + j16 + 16 * c, Skv, causal,
                         window)
                     ? xc
                     : kNegInf;
        }
        float mx = fmaxf(x[0], x[1]);
#pragma unroll
        for (int sh = 8; sh > 0; sh >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, sh));
        const float m_new = fmaxf(m_run[i], mx);
        alpha[tt][i] = expf(m_run[i] - m_new);
        m_run[i] = m_new;
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          p[b] = x[b] > 0.5f * kNegInf ? expf(x[b] - m_new) : 0.0f;
          Pw[(4 * g + i) * kPL32 + j16 + 16 * (2 * tt + b)] = p[b];
        }
        // A butterfly over the tile's 32 keys, key bits 4 to 0 (b, then
        // the lanes').
        float sum = p[0] + p[1];
#pragma unroll
        for (int sh = 8; sh > 0; sh >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, sh);
        l_run[i] = l_run[i] * alpha[tt][i] + sum;
      }
    }
    if (more)
      fa32::wait<1>();   // this pair's V is in (the next K may not be)
    else
      fa32::wait<0>();
    __syncthreads();

    // O rows 8 w + r, tile by tile: the tile's P V (pv, one fmaf chain over
    // its keys from 0), then O = O alpha + pv, a column block at a time.
#pragma unroll
    for (int tt = 0; tt < 2; ++tt) {
      if (tt == tiles) break;
      float a_o[8];
#pragma unroll
      for (int r = 0; r < 8; ++r)
        a_o[r] = __shfl_sync(0xffffffffu, alpha[tt][r & 3], 16 * (r >> 2));
#pragma unroll
      for (int h = 0; h < C::kNC; ++h) {
        float pv[8][4];
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int e = 0; e < 4; ++e) pv[r][e] = 0.0f;
#pragma unroll 2
        for (int j = kBK32 * tt; j < kBK32 * (tt + 1); j += 4) {
          float4 pf[8];
#pragma unroll
          for (int r = 0; r < 8; ++r) pf[r] = ld4(Pw + r * kPL32 + j);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float4 vf =
                ld4(Vs + (j + u) * C::kLD + 4 * (lane + 32 * h));
#pragma unroll
            for (int r = 0; r < 8; ++r) axpy4(comp(pf[r], u), vf, pv[r]);
          }
        }
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[r][h][e] = acc[r][h][e] * a_o[r] + pv[r][e];
      }
    }
    __syncthreads();   // every warp is past this pair's V and P
    if (more) {
      stage_f32<DP, kPair>(Vs, v + off_kv, (t0 + 2) * kBK32, Skv, D);
      fa32::commit();
    }
  }
  fa32::wait<0>();   // nothing left in flight, also when no tile ran

#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const float l_r = __shfl_sync(0xffffffffu, l_run[r & 3], 16 * (r >> 2));
    const float m_r = __shfl_sync(0xffffffffu, m_run[r & 3], 16 * (r >> 2));
    const int qpos = q0 + 8 * warp + r;
    if (qpos >= S) continue;
    const float den = fmaxf(l_r, 1e-30f);
    if (lane == 0) lse[static_cast<size_t>(bh) * S + qpos] = m_r + logf(den);
#pragma unroll
    for (int h = 0; h < C::kNC; ++h) {
      const int col = 4 * (lane + 32 * h);
      if (col < D)
        *reinterpret_cast<float4*>(o + off + static_cast<size_t>(qpos) * D +
                                   col) =
            make_float4(acc[r][h][0] / den, acc[r][h][1] / den,
                        acc[r][h][2] / den, acc[r][h][3] / den);
    }
  }
}

// ---------------------------------------------------------------------------
// Launchers.
// ---------------------------------------------------------------------------

float softmax_scale(int D) {
  return static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
}

// A (heads, S, D) bf16 tensor as a 3-D map of boxes of 64 columns by
// `rows` rows, 128-byte swizzle; elements outside the tensor read as zero
// and are not written.
bool encode_map(CUtensorMap* map, const void* ptr, int heads, int S, int D,
                int rows = 64) {
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

// The bf16 kernels' softmax factors: c with 2^(c s) = e^(scale s) (the
// scale and log2 e folded into one factor), or with a cap c = cap log2 e
// on t = tanh(scale s / cap) and cs2 = 2 log2 e scale / cap
// (softmax_tile).
struct Bf16Factors {
  float c, cs2;
};

Bf16Factors bf16_factors(int Dh, float softcap) {
  const double log2e = 1.4426950408889634;
  const double sqrt_dh = std::sqrt(static_cast<double>(Dh));
  if (softcap > 0.0f)
    return {static_cast<float>(softcap * log2e),
            static_cast<float>(2.0 * log2e / sqrt_dh / softcap)};
  return {static_cast<float>(log2e / sqrt_dh), 0.0f};
}

template <int DP, bool kCap>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                void* lse, int BH, int BH_kv, int S, int Skv, int D, int Dh,
                int causal, int window, float softcap, cudaStream_t stream) {
  const size_t bytes = Bf16Cfg<DP>::kSmem;
  CUtensorMap tq, tk, tv, to;
  if (!encode_map(&tq, q, BH, S, D) || !encode_map(&tk, k, BH_kv, Skv, D) ||
      !encode_map(&tv, v, BH_kv, Skv, D) || !encode_map(&to, o, BH, S, D))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bf16_kernel<DP, kCap>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>((S + kBQ - 1) / kBQ) * BH;
  const Bf16Factors f = bf16_factors(Dh, softcap);
  flash_bf16_kernel<DP, kCap><<<grid, kThreads, bytes, stream>>>(
      tq, tk, tv, to, static_cast<float*>(lse), BH, BH / BH_kv, S, Skv, f.c,
      f.cs2, causal, window);
  return static_cast<int>(cudaGetLastError());
}

// The current device's SMs.
int num_sms() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || n <= 0)
    return 132;
  return n;
}

// D <= 128: one persistent CTA an SM, at most one a work item; `next`
// is the work items' counter, one int32 of scratch, zeroed here on the
// stream.
template <int DP, bool kCap>
int launch_bf16_persistent(const void* q, const void* k, const void* v,
                           void* o, void* lse, void* next, int BH, int BH_kv,
                           int S, int Skv, int D, int Dh, int causal,
                           int window, float softcap, cudaStream_t stream) {
  const size_t bytes = Bf16Cfg2<DP>::kSmem;
  CUtensorMap tq, tk, tv;
  if (!encode_map(&tq, q, BH, S, D) ||
      !encode_map(&tk, k, BH_kv, Skv, D, kBK2) ||
      !encode_map(&tv, v, BH_kv, Skv, D, kBK2))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bf16_persistent_kernel<DP, kCap>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(next, 0, sizeof(int), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long items = static_cast<long long>((S + kBQ - 1) / kBQ) * BH;
  const int sms = num_sms();
  const unsigned grid = static_cast<unsigned>(items < sms ? items : sms);
  const Bf16Factors f = bf16_factors(Dh, softcap);
  flash_bf16_persistent_kernel<DP, kCap><<<grid, kThreads, bytes, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse),
      static_cast<int*>(next), BH, BH / BH_kv, S, Skv, D, f.c, f.cs2, causal,
      window);
  return static_cast<int>(cudaGetLastError());
}

template <int DP, bool kCap>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               void* lse, int BH, int BH_kv, int S, int Skv, int D, int Dh,
               int causal, int window, float softcap, cudaStream_t stream) {
  const size_t bytes = F32Cfg<DP>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel<DP, kCap>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>((S + kBQ32 - 1) / kBQ32) * BH;
  flash_f32_kernel<DP, kCap><<<grid, kT32, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), BH, S, Skv, D, BH / BH_kv, softmax_scale(Dh),
      softcap, causal, window);
  return static_cast<int>(cudaGetLastError());
}

// S_kv differs from S only in non-causal attention with no window; the
// cap is finite and >= 0 (0: none).
bool bad_shape(int BH, int BH_kv, int S, int Skv, int D, int Dh, int causal,
               int window, float softcap) {
  return BH <= 0 || BH_kv <= 0 || BH % BH_kv != 0 || S <= 0 || Skv <= 0 ||
         (Skv != S && (causal || window > 0)) || D <= 0 || D % 8 != 0 ||
         D > 256 || Dh <= 0 || Dh > D ||
         !(softcap >= 0.0f && softcap <= 3.4e38f);
}

// Every bf16 or f32 launch of one cap flag, by head dimension.
template <bool kCap>
int launch_bf16_any(const void* q, const void* k, const void* v, void* o,
                    void* lse, void* work, int BH, int BH_kv, int S,
                    int S_kv, int D, int Dh, int causal, int window,
                    float softcap, cudaStream_t st) {
  if (D <= 64)
    return launch_bf16_persistent<64, kCap>(q, k, v, o, lse, work, BH, BH_kv,
                                            S, S_kv, D, Dh, causal, window,
                                            softcap, st);
  if (D <= 128)
    return launch_bf16_persistent<128, kCap>(q, k, v, o, lse, work, BH,
                                             BH_kv, S, S_kv, D, Dh, causal,
                                             window, softcap, st);
  return launch_bf16<256, kCap>(q, k, v, o, lse, BH, BH_kv, S, S_kv, D, Dh,
                                causal, window, softcap, st);
}

template <bool kCap>
int launch_f32_any(const void* q, const void* k, const void* v, void* o,
                   void* lse, int BH, int BH_kv, int S, int S_kv, int D,
                   int Dh, int causal, int window, float softcap,
                   cudaStream_t st) {
  if (D <= 64)
    return launch_f32<64, kCap>(q, k, v, o, lse, BH, BH_kv, S, S_kv, D, Dh,
                                causal, window, softcap, st);
  if (D <= 128)
    return launch_f32<128, kCap>(q, k, v, o, lse, BH, BH_kv, S, S_kv, D, Dh,
                                 causal, window, softcap, st);
  return launch_f32<256, kCap>(q, k, v, o, lse, BH, BH_kv, S, S_kv, D, Dh,
                               causal, window, softcap, st);
}

}  // namespace

// The capped launches.  flash_attention_capped.cu compiles this file with
// REPRO_FA_CAPPED defined and holds them, so that nvcc builds the capped
// and the uncapped kernels as two sources, in parallel.
int repro_fa_bf16_capped(const void* q, const void* k, const void* v,
                         void* o, void* lse, void* work, int BH, int BH_kv,
                         int S, int S_kv, int D, int Dh, int causal,
                         int window, float softcap, cudaStream_t st);
int repro_fa_f32_capped(const void* q, const void* k, const void* v, void* o,
                        void* lse, int BH, int BH_kv, int S, int S_kv, int D,
                        int Dh, int causal, int window, float softcap,
                        cudaStream_t st);

#ifdef REPRO_FA_CAPPED

int repro_fa_bf16_capped(const void* q, const void* k, const void* v,
                         void* o, void* lse, void* work, int BH, int BH_kv,
                         int S, int S_kv, int D, int Dh, int causal,
                         int window, float softcap, cudaStream_t st) {
  return launch_bf16_any<true>(q, k, v, o, lse, work, BH, BH_kv, S, S_kv, D,
                               Dh, causal, window, softcap, st);
}

int repro_fa_f32_capped(const void* q, const void* k, const void* v, void* o,
                        void* lse, int BH, int BH_kv, int S, int S_kv, int D,
                        int Dh, int causal, int window, float softcap,
                        cudaStream_t st) {
  return launch_f32_any<true>(q, k, v, o, lse, BH, BH_kv, S, S_kv, D, Dh,
                              causal, window, softcap, st);
}

#else

// q, o: (BH, S, D); k, v: (BH_kv, S_kv, D) with BH_kv dividing BH and S_kv
// = S unless causal is 0 and window <= 0; lse: (BH, S)
// f32, each row's log-sum-exp of its scaled scores; contiguous, 16-byte
// aligned, one dtype, on the stream's device; D a multiple of 8 and at most
// 256; Dh (at most D) sets the softmax scale 1 / sqrt(Dh): a head dimension
// that is not a multiple of 8, zero-padded to D by the caller.  softcap >
// 0 caps each scaled score x as softcap tanh(x / softcap) before the mask
// (lse is then that of the capped scores); 0 runs the uncapped kernels.
// bf16 only:
// `work`, one int32 of scratch on the device (the persistent grid's work
// counter at D <= 128, zeroed on the stream before the launch; unused, and
// may be null, at D = 256).  Returns the cudaError_t of the launch (0 on
// success); cudaErrorInvalidValue for a shape the kernels do not take.
extern "C" int repro_flash_attention_bf16(const void* q, const void* k,
                                          const void* v, void* o,
                                          void* lse, void* work, int BH,
                                          int BH_kv, int S, int S_kv, int D,
                                          int Dh, int causal, int window,
                                          float softcap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_shape(BH, BH_kv, S, S_kv, D, Dh, causal, window, softcap) ||
      (D <= 128 && work == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (softcap > 0.0f)
    return repro_fa_bf16_capped(q, k, v, o, lse, work, BH, BH_kv, S, S_kv,
                                D, Dh, causal, window, softcap, st);
  return launch_bf16_any<false>(q, k, v, o, lse, work, BH, BH_kv, S, S_kv, D,
                                Dh, causal, window, softcap, st);
}

extern "C" int repro_flash_attention_f32(const void* q, const void* k,
                                         const void* v, void* o, void* lse,
                                         int BH, int BH_kv, int S, int S_kv,
                                         int D, int Dh, int causal,
                                         int window, float softcap,
                                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_shape(BH, BH_kv, S, S_kv, D, Dh, causal, window, softcap))
    return static_cast<int>(cudaErrorInvalidValue);
  if (softcap > 0.0f)
    return repro_fa_f32_capped(q, k, v, o, lse, BH, BH_kv, S, S_kv, D, Dh,
                               causal, window, softcap, st);
  return launch_f32_any<false>(q, k, v, o, lse, BH, BH_kv, S, S_kv, D, Dh,
                               causal, window, softcap, st);
}

#endif  // REPRO_FA_CAPPED
