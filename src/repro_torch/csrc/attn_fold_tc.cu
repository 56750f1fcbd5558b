// Tensor-core forms of the three attention-fold kernels, CUDA C++ for
// Hopper (sm_90a): the bfloat16 flash forward (fold_fwd_tc) and the dq
// and dk/dv folds of the flash backward (fold_dq_tc, fold_dkv_tc), and the
// float32 forward, dq and dk/dv folds (fold_fwd_tf32, fold_dq_tf32,
// fold_dkv_tf32: three TF32 products a product). They compute what
// fold_fwd_kernel, fold_dq_kernel and fold_dkv_kernel of attn_fold.cu
// compute (the reference's softmax_pair_kernel_spec, assoc.py:330, and
// softmax_pair_bwd_dq_kernel_spec, assoc.py:443, on KVBlocks, and
// softmax_pair_bwd_dkv_kernel_spec, assoc.py:486, on QBlocks, under
// fold_carry, kernels/scan_engine/schedules.py:722, and the split pass of
// fold_decoupled, :778); float32 shapes outside the 3xTF32 forms' range
// (a decode step's q block of 8 rows among them) keep the SIMT kernels.
//
// Bound. A (128 x 128) cell costs 4·128·128·d flops forward and 6·128·128·d
// for dq, 8·128·128·d for dk/dv, against 2·128·d bf16 elements of k and v,
// so at prefill and training shapes the folds are bound by operations
// (989 TFLOP/s bf16 on the tensor cores; in float32 three TF32 products a
// product at 495); a decode step is bound by reading the cache once. What
// the design does about it:
//   - every product is a wgmma (bf16 operands from shared memory, float32
//     accumulators): s = q·kᵀ, then p·v; for dq s = q·kᵀ and dp = dO·vᵀ,
//     then dq += ds·k; on the dk/dv side sᵀ = k·qᵀ and dpᵀ = v·dOᵀ, then
//     dv += pᵀ·dO and dk += dsᵀ·q;
//   - p (and p·g, ds, pᵀ, dsᵀ) go to shared memory as two bf16 terms,
//     hi = rn(p) and lo = rn(p - hi), and the second product reads both:
//     a p rounded to bf16 alone (FlashAttention's choice) misses the bf16
//     bar against the plain versions wherever a sum cancels, hi + lo
//     keeps ~16 bits;
//   - tiles come into shared memory by TMA (cp.async.bulk.tensor, 128-byte
//     swizzle, the layout the wgmma descriptors read) in a ring of stages
//     with full / empty mbarriers, one thread keeping the loads in flight
//     (the forward's producer warp or warpgroup, a dq block's thread 0,
//     a dk/dv block's thread 128);
//   - two consumer warpgroups share a block wherever registers allow, so
//     that one warpgroup's products overlap the other's exp and softcap:
//     a forward block holds two q tiles of 64 rows (bq = 128, d <= 128),
//     reading each k/v tile once per q block, and its producer warpgroup
//     hands registers to them (setmaxnreg 40 / 232); decode (bq < 64)
//     packs the q rows of all heads of a GQA group into one 64-row tile,
//     so a block reads its kv head's cache once for the whole group; a dq
//     block splits one q tile's cell between a p·g warpgroup and a ds
//     warpgroup, each then owning half of dq's columns.
//
// Geometry. The layout's (bq, bk) cells stay the unit of liveness, of
// count_cells and of the element the combine sees. The forward splits a
// cell's bk = 128 kv rows into two 64-row ring slots of k and two of v;
// dq streams the cell's v slots, then its k slots. A dk/dv block takes 64
// kv rows and up to 128 columns of dk and dv and walks each q block in
// chunks of 64 rows with two warpgroups: one forms
// sᵀ, pᵀ and dv, and hands p·g (g = tanh' under softcap, else 1) through
// shared memory to the other, which forms dpᵀ, dsᵀ and dk, so neither
// product of a chunk is computed twice. Registers (ptxas must report no
// spills): the forward's carry is 64·d / 128 floats a thread beside s (64,
// or 32 live under the two-tile blocks' 232, the first k tile's logits
// waiting in shared memory; p·v reuses s), and at d = 256 a block holds
// one q tile so that a thread may use 255; a dk/dv warpgroup keeps its
// carry and the cell's element (64 floats each) beside 32 q rows of sᵀ
// or dpᵀ (16) at a time, in a block of 256 threads (255 registers; a
// producer warpgroup would leave 240); a dq warpgroup keeps its carry over
// its dq columns (64 floats at d = 256) beside one 64-column tile of s, dp
// or the cell's element (32 each), in a block of 256 threads (255
// registers; a producer warp's ninth warp would share a quarter of the
// register file with two others and leave 168, under which the d = 256
// form spilled); divisions in the fold loops are a reciprocal and a
// product (an IEEE division calls a slow path, which costs registers).
//
// Association, as in attn_fold.cu: the cell's element (m_e, l_e, p·v),
// dq_e or (dk_e, dv_e) is accumulated from zero, then combined into the
// carry with __fmul_rn / __fadd_rn, so a skipped dead cell and a
// page-permuted pool (kv_block_map) give the bits of folding the identity
// and of the contiguous pool. expf and tanhf, never the fast intrinsics.
//
// Interface: plain C functions loaded with ctypes, as attn_fold.cu's; each
// also takes the dynamic shared memory the caller computed for the launch
// (cuda_fold.tc_tiling) and refuses a launch whose tiling disagrees.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "attn_fold.cuh"   // FoldArgs, FoldPtrs, kNegInf, cell_live

// The TMA descriptors of one launch (kernel parameters, __grid_constant__).
struct TcMaps {
  CUtensorMap q, k, v, dout;
};

namespace {

// 64 rows of 64 bf16: 128 bytes a row, one row of the 128-byte swizzle
constexpr int kPanelBytes = 64 * 128;

// -- shared memory, mbarriers, TMA -------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// mbarriers and TMA destinations by their shared-memory address.
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

// One arrival that also announces `bytes` of TMA traffic to come.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` has completed. A wait past
// ~2^35 cycles (tens of seconds) can only be a fault of the ring: it traps,
// so the launch fails instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long start = clock64();
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - start > (1ll << 35)) __trap();
  } while (!done);
}

// Has the phase of parity `parity` completed? Does not wait.
__device__ __forceinline__ bool mbar_ready(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// A contiguous copy of `bytes` (a multiple of 16) from global memory.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// -- wgmma --------------------------------------------------------------------

// A shared-memory matrix descriptor of a 128-byte-swizzled tile: start
// address, leading and stride byte offsets, layout type 1 (SWIZZLE_128B).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// A tile of 64 rows x d bf16 lies in shared memory as d / 64 panels of
// [64 rows][64 columns], each row 128 bytes, swizzled as TMA writes it.
// K-major operand (the contraction runs along the row): k-step kk covers
// columns 16 kk .. 16 kk + 15, 32 bytes into the row of panel kk / 4.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int kk) {
  return sw128_desc(tile + (kk >> 2) * kPanelBytes + (kk & 3) * 32, 16, 1024);
}

// MN-major operand (the contraction runs down the rows, the columns are
// the product's N): k-step kk covers rows 16 kk .. 16 kk + 15 (2048 bytes),
// N starts at panel `pnl`, and the next 64 columns lie one panel further.
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int kk,
                                                 int pnl) {
  return sw128_desc(tile + pnl * kPanelBytes + kk * 2048, kPanelBytes, 1024);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Orders every later use of the registers after the last wgmma wait (the
// compiler does not know wgmma writes and reads them asynchronously).
template <int N>
__device__ __forceinline__ void keep(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (64 x 32, f32) = [d +] A (64 x 16) * B (16 x 32), bf16 tiles in shared
// memory (128-byte swizzle): A K-major, B K-major; scale_d = 0 drops d.
__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64, f32) = [d +] A (64 x 16) * B (16 x 64), bf16 tiles in shared
// memory (128-byte swizzle): A K-major, B K-major; scale_d = 0 drops d.
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64, f32) = [d +] A (64 x 16) * B (16 x 64), bf16 tiles in shared
// memory (128-byte swizzle): A K-major, B MN-major (its N contiguous);
// scale_d = 0 drops d.
__device__ __forceinline__ void wgmma_n64_mn(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 128, f32) = [d +] A (64 x 16) * B (16 x 128), bf16 tiles in shared
// memory (128-byte swizzle): A K-major, B MN-major (its N contiguous);
// scale_d = 0 drops d.
__device__ __forceinline__ void wgmma_n128_mn(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int NC>
__device__ __forceinline__ void wgmma_mn(float (&d)[NC / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (NC == 64)
    wgmma_n64_mn(d, da, db, scale_d);
  else
    wgmma_n128_mn(d, da, db, scale_d);
}

// The 128 threads of consumer warpgroup wg meet (named barrier 1 + wg).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
}

// Makes this thread's shared-memory stores visible to wgmma's reads.
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// The two rows of a thread in a 64-row wgmma tile: warp w holds rows
// 16 w .. 16 w + 15, lane l rows l / 4 and l / 4 + 8. Accumulator entry x
// of a (64 x N) product lies at row i = (x >> 1) & 1 of those two and
// column 8 (x >> 2) + 2 (l % 4) + (x & 1).
__device__ __forceinline__ int tile_row(int tid, int i) {
  return (tid / 32) * 16 + (tid % 32) / 4 + 8 * i;
}

// 1 / x for a finite x >= 1 (a softcap, a row's l): rcp.approx and one
// Newton step, within an ulp of the IEEE quotient. An IEEE division
// compiles to a call of a slow path for special operands, and a call in
// the fold loop costs registers that the accumulators need.
__device__ __forceinline__ float recip(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return __fmaf_rn(r, __fmaf_rn(-x, r, 1.f), r);
}

// attn_fold.cu's logit() with s / cap as s · (1 / cap).
__device__ __forceinline__ float logit_tc(const FoldArgs& a, float dot,
                                          float inv_cap) {
  float s = dot * a.scale;
  if (a.has_softcap) s = a.softcap * tanhf(s * inv_cap);
  return s;
}

__device__ __forceinline__ int clamp_to(long long x, int n) {
  return (int)(x < 0 ? 0 : x > n ? n : x);
}

// attn_fold.cu's elem_live along a row: entry (row, col0 + c) is live
// iff lo <= c < hi, for c in [0, n).
__device__ __forceinline__ int2 live_cols(const FoldArgs& a, long long row,
                                          long long col0, int n) {
  long long lo = 0, hi = n;
  if (a.has_kv_len && a.kv_len - col0 < hi) hi = a.kv_len - col0;
  if (a.causal && row + 1 - col0 < hi) hi = row + 1 - col0;
  if (a.has_window && row - a.window + 1 - col0 > lo)
    lo = row - a.window + 1 - col0;
  return make_int2(clamp_to(lo, n), clamp_to(hi, n));
}

// elem_live down a column: entry (row0 + r, col) is live iff lo <= r < hi,
// for r in [0, n).
__device__ __forceinline__ int2 live_rows(const FoldArgs& a, long long col,
                                          long long row0, int n) {
  long long lo = 0, hi = n;
  if (a.has_kv_len && col >= a.kv_len) hi = 0;
  if (a.causal && col - row0 > lo) lo = col - row0;
  if (a.has_window && col + a.window - row0 < hi) hi = col + a.window - row0;
  return make_int2(clamp_to(lo, n), clamp_to(hi, n));
}

// The byte offset of a thread's entries x, x + 1 (x even) of a (64 x 64)
// accumulator in a K-major panel of bf16 (64 rows of 128 bytes, swizzled
// as TMA would write them).
__device__ __forceinline__ uint32_t pair_offset(int x, int tid) {
  const int r = tile_row(tid, (x >> 1) & 1);
  return r * 128 + (((x >> 2) ^ (r & 7)) << 4) + 4 * (tid % 4);
}

// Entries x, x + 1 of a thread's accumulator, v0 and v1, as bf16 hi = rn(v)
// into panel `hi` and lo = rn(v - hi) into panel `lo`: hi + lo keeps v to
// about 16 bits, so the product that reads both keeps the float32
// operand's precision (p and ds rounded to bf16 alone miss the bf16 bar
// against the plain versions where sums cancel).
__device__ __forceinline__ void store_pair(uint32_t hi, uint32_t lo, int x,
                                           int tid, float v0, float v1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(__fsub_rn(v0, hf.x), __fsub_rn(v1, hf.y));
  const uint32_t off = pair_offset(x, tid);
  asm volatile("st.shared.b32 [%0], %1;" ::"r"(hi + off),
               "r"(*reinterpret_cast<const uint32_t*>(&h))
               : "memory");
  asm volatile("st.shared.b32 [%0], %1;" ::"r"(lo + off),
               "r"(*reinterpret_cast<const uint32_t*>(&l))
               : "memory");
}

// The pair store_pair wrote, as hi + lo.
__device__ __forceinline__ float2 load_pair(uint32_t hi, uint32_t lo, int x,
                                            int tid) {
  const uint32_t off = pair_offset(x, tid);
  uint32_t h, l;
  asm volatile("ld.shared.b32 %0, [%1];" : "=r"(h) : "r"(hi + off));
  asm volatile("ld.shared.b32 %0, [%1];" : "=r"(l) : "r"(lo + off));
  const float2 hf = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&h));
  const float2 lf = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&l));
  return make_float2(__fadd_rn(hf.x, lf.x), __fadd_rn(hf.y, lf.y));
}

// A thread's 32 floats x to (store) or from shared memory, word e at
// [e][thread] of the 8 KB regions a (e < 16) and b: thread-private, no
// two threads of a warp on one bank.
__device__ __forceinline__ void stash(uint32_t a, uint32_t b, float (&x)[32],
                                      int tid, bool store) {
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const uint32_t addr = (e < 16 ? a : b) + ((e & 15) * 128 + tid) * 4;
    if (store)
      asm volatile("st.shared.f32 [%0], %1;" ::"r"(addr), "f"(x[e])
                   : "memory");
    else
      asm volatile("ld.shared.f32 %0, [%1];" : "=f"(x[e]) : "r"(addr));
  }
}

// Named barriers between consumer warpgroups (0 is __syncthreads').
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// The mask and softcapped logits of a thread's 32 entries of a (64 x 64)
// s tile whose column 8 (x >> 2) + (x & 1) is c0 + that (c0 holds the
// thread's 2 (l % 4)), against the rows' live column ranges; m_e takes
// the thread's share of their row max.
__device__ __forceinline__ void mask_logits(const FoldArgs& a,
                                            float (&s)[32], int c0,
                                            const int2 (&live)[2],
                                            float inv_cap, float (&m_e)[2]) {
#pragma unroll
  for (int x = 0; x < 32; ++x) {
    const int i = (x >> 1) & 1, c = c0 + 8 * (x >> 2) + (x & 1);
    const bool ok = c >= live[i].x && c < live[i].y;
    s[x] = ok ? logit_tc(a, s[x], inv_cap) : kNegInf;
    m_e[i] = fmaxf(m_e[i], s[x]);
  }
}

// The row max over the four lanes that share a row.
__device__ __forceinline__ void row_max(float (&m)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 1));
    m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 2));
  }
}

// p = exp(s - m_e) of a tile as mask_logits lays it out, masked entries
// exactly 0, added into the thread's row sums l_e and stored as hi + lo
// into the panels hi and lo.
__device__ __forceinline__ void exp_store(const float (&s)[32], int c0,
                                          const int2 (&live)[2],
                                          const float (&m_e)[2],
                                          float (&l_e)[2], uint32_t hi,
                                          uint32_t lo, int tid) {
#pragma unroll
  for (int x = 0; x < 32; x += 2) {
    const int i = (x >> 1) & 1, c = c0 + 8 * (x >> 2);
    const float p0 =
        c >= live[i].x && c < live[i].y ? expf(s[x] - m_e[i]) : 0.f;
    const float p1 = c + 1 >= live[i].x && c + 1 < live[i].y
                         ? expf(s[x + 1] - m_e[i]) : 0.f;
    l_e[i] = __fadd_rn(__fadd_rn(l_e[i], p0), p1);
    store_pair(hi, lo, x, tid, p0, p1);
  }
}

// -- forward (softmax_pair) ---------------------------------------------------

template <int D, int NWG>
struct FwdTiles {
  static constexpr int kPanels = D / 64;
  static constexpr int kTileBytes = kPanels * kPanelBytes;  // 64 rows x D
  // the ring of 64-row k / v tiles: a cell (bk = 128) takes four
  static constexpr int kSlots = D == 256 ? 4 : NWG == 2 && D == 128 ? 6 : 8;
  static constexpr int kNC = 64;   // p·v columns per product
  static constexpr bool kStash = NWG == 2;   // see the consumer
  // a warpgroup's p as hi and lo, each two 64-column panels (bk <= 128)
  static constexpr int kPBytes = 4 * kPanelBytes;
  // two consumer warpgroups take a producer warpgroup (setmaxnreg moves
  // its registers to them); one takes a producer warp
  static constexpr int kThreads = NWG == 2 ? 384 : 160;
  static constexpr int kSmem = 1024 + NWG * (kTileBytes + kPBytes) +
                               kSlots * kTileBytes + 8 * (2 * kSlots + 1);
};

// Block (kv head hk, q block qi, tile group bt), split y. The tiles of a
// (kv head, q block): the group's q heads x bq rows, in that order, cut
// into 64-row tiles; tile row r of tile t is q row (64 t + r) % bq of head
// hk·group + (64 t + r) / bq (a row past the group is computed, never
// stored). Warpgroup w < NWG owns tile bt·NWG + w; warpgroup NWG
// produces.
template <int D, int NWG>
__global__ void __launch_bounds__(FwdTiles<D, NWG>::kThreads, 1)
    fold_fwd_tc_kernel(const __grid_constant__ TcMaps maps, FoldArgs a,
                       FoldPtrs p) {
  using G = FwdTiles<D, NWG>;
  constexpr int NC = G::kNC;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = align1024(smem_raw);             // NWG q tiles
  uint8_t* p_s = q_s + NWG * G::kTileBytes;       // NWG p tiles (hi, lo)
  uint8_t* ring = p_s + NWG * G::kPBytes;         // kSlots k / v tiles
  // mbarriers: full[kSlots], empty[kSlots], then the q tiles'
  const uint32_t q_u = smem_u32(q_s), ring_u = smem_u32(ring);
  const uint32_t full = ring_u + G::kSlots * G::kTileBytes;
  const uint32_t empty = full + 8 * G::kSlots, qbar = empty + 8 * G::kSlots;

  const int nb = (a.group * a.bq + 63) / 64 / NWG;  // blocks per (hk, qi)
  const int bt = blockIdx.x % nb;
  const int qi = (blockIdx.x / nb) % a.nq;
  const int hk = blockIdx.x / nb / a.nq;
  const int nsub = a.bk / 64;
  const int f0 = blockIdx.y * a.bpc;
  if (threadIdx.x == 0) {
    for (int s = 0; s < G::kSlots; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, NWG * 128);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == NWG) {  // the producer: one thread issues every load
    if constexpr (NWG == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (threadIdx.x == NWG * 128) {
      mbar_expect_tx(qbar, NWG * G::kTileBytes);
      for (int w = 0; w < NWG; ++w) {
        const int vr = 64 * (bt * NWG + w);
        for (int pn = 0; pn < G::kPanels; ++pn)
          tma_load_3d(q_u + w * G::kTileBytes + pn * kPanelBytes, &maps.q,
                      qbar, 64 * pn, qi * a.bq + vr % a.bq,
                      hk * a.group + vr / a.bq);
      }
      int slot = 0;
      uint32_t phase = 0;
      for (int f = f0; f < f0 + a.bpc; ++f) {
        if (!cell_live(a, qi, f)) continue;
        const int phys = p.kv_map ? p.kv_map[f] : f;
        const int row = hk * a.tk + phys * a.bk;
        for (int kv = 0; kv < 2; ++kv) {  // the cell's k tiles, then its v
          for (int h = 0; h < nsub; ++h) {
            mbar_wait(empty + 8 * slot, phase ^ 1);
            mbar_expect_tx(full + 8 * slot, G::kTileBytes);
            const uint32_t dst = ring_u + slot * G::kTileBytes;
            for (int pn = 0; pn < G::kPanels; ++pn)
              tma_load_2d(dst + pn * kPanelBytes, kv ? &maps.v : &maps.k,
                          full + 8 * slot, 64 * pn, row + 64 * h);
            if (++slot == G::kSlots) {
              slot = 0;
              phase ^= 1;
            }
          }
        }
      }
    }
  } else {  // a consumer warpgroup: one 64-row q tile
    if constexpr (NWG == 2)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
    const int tid = threadIdx.x % 128, quad = tid % 4;
    const int t = bt * NWG + wg;
    int qr[2];   // the thread's rows within the q block
#pragma unroll
    for (int i = 0; i < 2; ++i) qr[i] = (64 * t + tile_row(tid, i)) % a.bq;
    float acc[D / 2];
#pragma unroll
    for (int x = 0; x < D / 2; ++x) acc[x] = 0.f;
    float m_c[2] = {kNegInf, kNegInf}, l_c[2] = {0.f, 0.f};
    const float inv_cap = a.has_softcap ? recip(a.softcap) : 0.f;
    int count = 0, slot = 0;
    uint32_t phase = 0;
    const uint32_t q_tile = q_u + wg * G::kTileBytes;
    // p as hi (two panels), then lo
    const uint32_t p_hi = smem_u32(p_s) + wg * G::kPBytes;
    mbar_wait(qbar, 0);
    __syncwarp();
    for (int f = f0; f < f0 + a.bpc; ++f) {
      if (!cell_live(a, qi, f)) continue;
      ++count;
      // s = q·kᵀ, one (64 x 64) product per 64-row k tile of the cell, the
      // mask and softcapped logits, the cell's row max m_e; then p =
      // exp(s - m_e) (a masked entry is zeroed, not left to underflow: in a
      // fully masked row m_e = NEG_INF and exp(s - m_e) would be 1), its
      // row sum l_e, and p into the panels as hi + lo, the A operand of p·v
      const uint32_t ph = p_hi, pl = p_hi + 2 * kPanelBytes;
      float s[2][32];
      float m_e[2] = {kNegInf, kNegInf}, l_e[2] = {0.f, 0.f};
      int2 live[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        live[i] = live_cols(a, (long long)qi * a.pos_bq + qr[i],
                            (long long)f * a.pos_bk, 64 * nsub);
      if constexpr (G::kStash) {
        // under setmaxnreg's 232 registers, a tile at a time: the first
        // tile's logits wait in the panels (hi 0, lo 0) while the second
        // is formed, so that 32 of s are live, not 64
        wg_sync(wg);   // every warp's last p·v has read the panels
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (h >= nsub) break;
          mbar_wait(full + 8 * slot, phase);
          __syncwarp();
          const uint32_t kt = ring_u + slot * G::kTileBytes;
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)
            wgmma_n64(s[0], kmajor_desc(q_tile, kk), kmajor_desc(kt, kk),
                      kk > 0);
          wg_commit();
          wg_wait();
          keep(s[0]);
          mbar_arrive(empty + 8 * slot);
          if (++slot == G::kSlots) {
            slot = 0;
            phase ^= 1;
          }
          mask_logits(a, s[0], 64 * h + 2 * quad, live, inv_cap, m_e);
          if (h + 1 < nsub) stash(ph, pl, s[0], tid, true);
        }
        row_max(m_e);
#pragma unroll
        for (int h = 1; h >= 0; --h) {   // the last tile first
          if (h >= nsub) continue;
          if (h + 1 < nsub) {
            stash(ph, pl, s[0], tid, false);
            wg_sync(wg);   // every stash is read before panel 0 is written
          }
          exp_store(s[0], 64 * h + 2 * quad, live, m_e, l_e,
                    ph + h * kPanelBytes, pl + h * kPanelBytes, tid);
        }
      } else {
        // both tiles at once
        const int k0 = slot;   // the cell's k tiles fill slots k0, k0 + 1
        wg_fence();
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (h < nsub) {
            mbar_wait(full + 8 * slot, phase);
            __syncwarp();
            const uint32_t kt = ring_u + slot * G::kTileBytes;
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk)
              wgmma_n64(s[h], kmajor_desc(q_tile, kk), kmajor_desc(kt, kk),
                        kk > 0);
            if (++slot == G::kSlots) {
              slot = 0;
              phase ^= 1;
            }
          }
        }
        wg_commit();
        wg_wait();
        keep(s[0]);
        keep(s[1]);
        for (int h = 0; h < nsub; ++h)
          mbar_arrive(empty + 8 * ((k0 + h) % G::kSlots));
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (h < nsub)
            mask_logits(a, s[h], 64 * h + 2 * quad, live, inv_cap, m_e);
        row_max(m_e);
        wg_sync(wg);   // every warp's last p·v has read the panels
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (h < nsub)
            exp_store(s[h], 64 * h + 2 * quad, live, m_e, l_e,
                      ph + h * kPanelBytes, pl + h * kPanelBytes, tid);
      }
      fence_async();
      wg_sync(wg);
      float a1[2], a2[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l_e[i] = __fadd_rn(l_e[i], __shfl_xor_sync(0xffffffffu, l_e[i], 1));
        l_e[i] = __fadd_rn(l_e[i], __shfl_xor_sync(0xffffffffu, l_e[i], 2));
        // the combine's scalars: carry (m_c, l_c) the earlier operand
        const float mn = fmaxf(m_c[i], m_e[i]);
        a1[i] = expf(m_c[i] - mn);
        a2[i] = expf(m_e[i] - mn);
        l_c[i] =
            __fadd_rn(__fmul_rn(l_c[i], a1[i]), __fmul_rn(l_e[i], a2[i]));
        m_c[i] = mn;
      }

      // the cell's p·v from zero, NC columns at a time, combined into acc
      const int v0 = slot;   // and its v tiles v0, v0 + 1
      for (int h = 0; h < nsub; ++h) {
        mbar_wait(full + 8 * slot, phase);
        if (++slot == G::kSlots) {
          slot = 0;
          phase ^= 1;
        }
      }
      __syncwarp();
#pragma unroll
      for (int c = 0; c < D / NC; ++c) {
        float(&pv)[NC / 2] = s[0];   // p now lies in shared memory
        wg_fence();
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (h < nsub) {
            const uint32_t vt = ring_u + (v0 + h) % G::kSlots * G::kTileBytes;
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              const uint64_t vd = mnmajor_desc(vt, kk, c * NC / 64);
              wgmma_mn<NC>(pv, kmajor_desc(ph, 4 * h + kk), vd,
                           (h | kk) != 0);
              wgmma_mn<NC>(pv, kmajor_desc(pl, 4 * h + kk), vd, 1);
            }
          }
        }
        wg_commit();
        wg_wait();
        keep(pv);
#pragma unroll
        for (int x = 0; x < NC / 2; ++x) {
          const int i = (x >> 1) & 1;
          acc[c * NC / 2 + x] =
              __fadd_rn(__fmul_rn(acc[c * NC / 2 + x], a1[i]),
                        __fmul_rn(pv[x], a2[i]));
        }
      }
      for (int h = 0; h < nsub; ++h)
        mbar_arrive(empty + 8 * ((v0 + h) % G::kSlots));
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int hj = (64 * t + tile_row(tid, i)) / a.bq;  // head in the group
      if (hj >= a.group) continue;   // a row of the next group's heads
      const long long h = (long long)hk * a.group + hj;
      if (p.c0) {  // split pass: publish the chunk's (m, l, acc)
        const long long cr =
            ((h * a.nq + qi) * a.splits + blockIdx.y) * a.bq + qr[i];
        if (quad == 0) {
          p.c0[cr] = m_c[i];
          p.c1[cr] = l_c[i];
        }
        float* dst = p.c2 + cr * D + 2 * quad;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<float2*>(dst + 8 * j) =
              make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
        continue;
      }
      // l == 0 marks a fully masked row (or an empty fold): acc is 0 there
      const long long row = h * a.tq + (long long)qi * a.bq + qr[i];
      const float inv = recip(l_c[i] == 0.f ? 1.f : l_c[i]);
      __nv_bfloat16* dst =
          static_cast<__nv_bfloat16*>(p.out0) + row * D + 2 * quad;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j + 2 * i] * inv,
                                  acc[4 * j + 2 * i + 1] * inv);
      if (p.m_out && quad == 0) {
        p.m_out[row] = m_c[i];
        p.l_out[row] = l_c[i];
      }
    }
    if (p.counts && tid < 64) {   // one writer per head whose rows start here
      const int vr = 64 * t + tid;
      if (vr % a.bq == 0 && vr / a.bq < a.group)
        p.counts[(long long)(hk * a.group + vr / a.bq) * a.nq + qi] = count;
    }
  }
}

// -- backward dk/dv (softmax_bwd_dkv) -----------------------------------------

template <int D>
struct DkvTiles {
  static constexpr int kPanels = D / 64;
  static constexpr int kTileBytes = kPanels * kPanelBytes;  // 64 rows x D
  static constexpr int kDC = D < 128 ? D : 128;   // dk / dv columns a block
  static constexpr int kStages = D == 256 ? 2 : 4;
  static constexpr int kStageBytes = 2 * kTileBytes;  // 64 rows of q and dO
  // pᵀ as hi, lo (warpgroup 0's dv operand), then p·g and dsᵀ as hi, lo
  static constexpr int kPBytes = 4 * kPanelBytes;
  static constexpr int kStatBytes = 3 * 64 * 4;       // the rows' m, l, delta
  static constexpr int kThreads = 256;
  static constexpr int kSmem = 1024 + 2 * kTileBytes + kStages * kStageBytes +
                               kPBytes + kStages * kStatBytes +
                               8 * (2 * kStages + 1);
};

// Block (kv head hk, kv block jb, 64-row sub-block sub, kDC columns cp of
// dk and dv), split y; folds the (group x q-block) axis as attn_fold.cu's
// fold_dkv_kernel does. Warpgroup 0 forms pᵀ (sᵀ = k·qᵀ) and dv; it hands
// p·g (g = tanh' under softcap, else 1) through shared memory to
// warpgroup 1, which forms dsᵀ = p·g (dpᵀ - delta) (dpᵀ = v·dOᵀ) and dk.
// Warpgroup 1's first thread also issues the loads, kStages chunks ahead
// of the fold (a separate producer would leave the consumers 240
// registers, fewer than the two accumulators of 128 columns and sᵀ need).
// Named barriers: 1 + wg within a warpgroup, 3 "p·g of this chunk is
// written", 4 "the panels of the last chunk are read".
template <int D>
__global__ void __launch_bounds__(256, 1)
    fold_dkv_tc_kernel(const __grid_constant__ TcMaps maps, FoldArgs a,
                       FoldPtrs p) {
  using G = DkvTiles<D>;
  constexpr int DC = G::kDC;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* k_s = align1024(smem_raw);   // this block's 64 kv rows, whole d
  const uint32_t k_u = smem_u32(k_s), v_u = k_u + G::kTileBytes;
  const uint32_t stages_u = v_u + G::kTileBytes;
  const uint32_t pt = stages_u + G::kStages * G::kStageBytes;
  const uint32_t stats_u = pt + G::kPBytes;
  const float* stats = reinterpret_cast<const float*>(
      k_s + (stats_u - k_u));
  // mbarriers: full[kStages], empty[kStages], then k and v's
  const uint32_t full = stats_u + G::kStages * G::kStatBytes;
  const uint32_t empty = full + 8 * G::kStages, kvbar = empty + 8 * G::kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < G::kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 256);
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  constexpr int ncp = D / DC;
  const int nsub = a.bk / 64;
  const int cp = blockIdx.x % ncp;
  const int sub = (blockIdx.x / ncp) % nsub;
  const int jb = (blockIdx.x / ncp / nsub) % a.nk;
  const int hk = blockIdx.x / ncp / nsub / a.nk;
  const int nch = a.bq / 64;
  const int f0 = blockIdx.y * a.bpc;
  const int wg = threadIdx.x / 128;
  const bool loader = threadIdx.x == 128;
  // the loader's walk over the live chunks (lf, lc) of the fold
  int lf = f0, lc = 0, lstage = 0;
  uint32_t lphase = 0;
  auto skip_dead = [&]() {
    while (lf < f0 + a.bpc && !cell_live(a, lf % a.nq, jb)) ++lf;
  };
  auto load_next = [&]() {   // chunk (lf, lc) into stage lstage, then on
    const uint32_t bar = full + 8 * lstage;
    mbar_wait(empty + 8 * lstage, lphase ^ 1);
    mbar_expect_tx(bar, G::kStageBytes + G::kStatBytes);
    const uint32_t st = stages_u + lstage * G::kStageBytes;
    const int qrow = (hk * a.group + lf / a.nq) * a.tq +
                     (lf % a.nq) * a.bq + 64 * lc;
    for (int pn = 0; pn < G::kPanels; ++pn) {
      tma_load_2d(st + pn * kPanelBytes, &maps.q, bar, 64 * pn, qrow);
      tma_load_2d(st + G::kTileBytes + pn * kPanelBytes, &maps.dout, bar,
                  64 * pn, qrow);
    }
    const uint32_t sts = stats_u + lstage * G::kStatBytes;
    bulk_load(sts, p.m + qrow, 256, bar);
    bulk_load(sts + 256, p.l + qrow, 256, bar);
    bulk_load(sts + 512, p.delta + qrow, 256, bar);
    if (++lstage == G::kStages) {
      lstage = 0;
      lphase ^= 1;
    }
    if (++lc == nch) {
      lc = 0;
      ++lf;
      skip_dead();
    }
  };
  if (loader) {
    const int kvrow = hk * a.tk + jb * a.bk + 64 * sub;
    mbar_expect_tx(kvbar, 2 * G::kTileBytes);
    for (int pn = 0; pn < G::kPanels; ++pn) {
      tma_load_2d(k_u + pn * kPanelBytes, &maps.k, kvbar, 64 * pn, kvrow);
      tma_load_2d(v_u + pn * kPanelBytes, &maps.v, kvbar, 64 * pn, kvrow);
    }
    skip_dead();
    for (int k = 0; k < G::kStages && lf < f0 + a.bpc; ++k) load_next();
  }
  {  // warpgroup wg: 0 forms dv, 1 forms dk
    const int tid = threadIdx.x % 128, quad = tid % 4;
    float acc[DC / 2];   // the carry: dv (warpgroup 0) or dk (1)
#pragma unroll
    for (int x = 0; x < DC / 2; ++x) acc[x] = 0.f;
    const float inv_cap = a.has_softcap ? recip(a.softcap) : 0.f;
    int count = 0, stage = 0, chunks = 0;
    uint32_t phase = 0;
    mbar_wait(kvbar, 0);
    __syncwarp();
    for (int f = f0; f < f0 + a.bpc; ++f) {
      const int qi = f % a.nq;
      if (!cell_live(a, qi, jb)) continue;
      ++count;
      float el[DC / 2];   // the cell's element: dv_e or dk_e
      for (int c = 0; c < nch; ++c, ++chunks) {
        mbar_wait(full + 8 * stage, phase);
        __syncwarp();
        const uint32_t qt = stages_u + stage * G::kStageBytes;
        const uint32_t dt = qt + G::kTileBytes;
        const float* sts = stats + stage * 192;
        // pᵀ hi, lo, then p·g (later dsᵀ) hi, lo: one 64-column panel each
        const uint32_t p_hi = pt, p_lo = pt + kPanelBytes;
        const uint32_t g_hi = pt + 2 * kPanelBytes;
        const uint32_t g_lo = pt + 3 * kPanelBytes;
        if (chunks > 0) {   // the last chunk's panels are read
          if (wg == 0)
            bar_sync(4, 256);
          else
            bar_arrive(4, 256);
        }
        int2 live[2];   // warpgroup 0: the q rows of the chunk each kv row sees
#pragma unroll
        for (int i = 0; i < 2; ++i)
          live[i] = live_rows(
              a, (long long)jb * a.pos_bk + 64 * sub + tile_row(tid, i),
              (long long)qi * a.pos_bq + 64 * c, 64);
        // sᵀ = k·qᵀ (warpgroup 0) or dpᵀ = v·dOᵀ (1): kv rows x the chunk's
        // q rows 32 hs .. 32 hs + 31, one half at a time (s is 16 floats);
        // entry x of a half is entry x + 16 hs of the chunk's (64 x 64) tile
#pragma unroll
        for (int hs = 0; hs < 2; ++hs) {
          float s[16];
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)
            wgmma_n32(s, kmajor_desc(wg == 0 ? k_u : v_u, kk),
                      kmajor_desc((wg == 0 ? qt : dt) + hs * 4096, kk),
                      kk > 0);
          wg_commit();
          wg_wait();
          keep(s);
          if (wg == 0) {
            // pᵀ = exp(s - m) / l, and p·g for warpgroup 1
#pragma unroll
            for (int x = 0; x < 16; x += 2) {
              const int i = (x >> 1) & 1;
              float pv[2], pg[2];
#pragma unroll
              for (int u = 0; u < 2; ++u) {
                const int qc = 32 * hs + 8 * (x >> 2) + 2 * quad + u;
                const bool ok = qc >= live[i].x && qc < live[i].y;
                const float sv = logit_tc(a, s[x + u], inv_cap);
                const float l = sts[64 + qc];
                pv[u] = ok ? expf(sv - sts[qc]) * recip(l == 0.f ? 1.f : l)
                           : 0.f;
                pg[u] = pv[u];
                if (a.has_softcap) {   // tanh' = 1 - (s / cap)^2
                  const float t = sv * inv_cap;
                  pg[u] = pv[u] * __fsub_rn(1.f, __fmul_rn(t, t));
                }
              }
              store_pair(p_hi, p_lo, x + 16 * hs, tid, pv[0], pv[1]);
              store_pair(g_hi, g_lo, x + 16 * hs, tid, pg[0], pg[1]);
            }
          } else {
            // dsᵀ = p·g (dpᵀ - delta), over the p·g warpgroup 0 wrote
            if (hs == 0) bar_sync(3, 256);
#pragma unroll
            for (int x = 0; x < 16; x += 2) {
              const int qc = 32 * hs + 8 * (x >> 2) + 2 * quad;
              const float2 pg = load_pair(g_hi, g_lo, x + 16 * hs, tid);
              store_pair(g_hi, g_lo, x + 16 * hs, tid,
                         __fmul_rn(pg.x, __fsub_rn(s[x], sts[128 + qc])),
                         __fmul_rn(pg.y, __fsub_rn(s[x + 1], sts[129 + qc])));
            }
          }
        }
        fence_async();
        if (wg == 0) bar_arrive(3, 256);   // p·g is written
        wg_sync(wg);                       // and this warpgroup's operand
        // the cell's dv_e += pᵀ·dO or dk_e += dsᵀ·q (columns DC cp ..),
        // from zero at the first chunk
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t bd = mnmajor_desc(wg == 0 ? dt : qt, kk,
                                           cp * DC / 64);
          wgmma_mn<DC>(el, kmajor_desc(wg == 0 ? p_hi : g_hi, kk), bd,
                       (c | kk) != 0);
          wgmma_mn<DC>(el, kmajor_desc(wg == 0 ? p_lo : g_lo, kk), bd, 1);
        }
        wg_commit();
        wg_wait();
        keep(el);
        mbar_arrive(empty + 8 * stage);
        if (++stage == G::kStages) {
          stage = 0;
          phase ^= 1;
        }
        if (loader && lf < f0 + a.bpc) load_next();   // kStages chunks ahead
      }
      const float sc = wg == 0 ? 1.f : a.scale;   // dk = dk + scale·dk_e
#pragma unroll
      for (int x = 0; x < DC / 2; ++x)
        acc[x] = wg == 0 ? __fadd_rn(acc[x], el[x])
                         : __fadd_rn(acc[x], __fmul_rn(el[x], sc));
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int kr = 64 * sub + tile_row(tid, i);   // kv row of the block
      const int col = DC * cp + 2 * quad;
      if (p.c0) {
        float* dst = (wg == 0 ? p.c1 : p.c0) +
                     (((long long)(hk * a.nk + jb) * a.splits + blockIdx.y) *
                          a.bk + kr) * D + col;
#pragma unroll
        for (int j = 0; j < DC / 8; ++j)
          *reinterpret_cast<float2*>(dst + 8 * j) =
              make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
      } else {
        __nv_bfloat16* dst =
            static_cast<__nv_bfloat16*>(wg == 0 ? p.out1 : p.out0) +
            ((long long)hk * a.tk + (long long)jb * a.bk + kr) * D + col;
#pragma unroll
        for (int j = 0; j < DC / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
              __floats2bfloat162_rn(acc[4 * j + 2 * i],
                                    acc[4 * j + 2 * i + 1]);
      }
    }
    if (!p.c0 && p.counts && wg == 1 && sub == 0 && cp == 0 && tid == 0)
      p.counts[hk * a.nk + jb] = count;
  }
}

// -- backward dk/dv in float32 on the tensor cores (3xTF32) ------------------
//
// fold_dkv_tf32: what fold_dkv_kernel computes on float32 operands
// (softmax_bwd_dkv on QBlocks, the carry fold and the split pass), with
// every product on the tensor cores. A TF32 product keeps ~11 bits of
// each operand, too few for the float32 bars (1e-5 / 1e-4); the split
// x = hi + lo, hi = tf32(x) (cvt.rna), lo = tf32(x - hi), keeps ~22, and
// x·y = hi·hi' + hi·lo' + lo·hi' drops only lo·lo' (~2^-22 of the
// product), with float32 accumulators: three TF32 wgmmas a product, at
// 495 TFLOP/s against the 67 of float32 on the CUDA cores. TF32 wgmma
// reads its shared-memory operands K-major only (no transpose), so:
//   * sᵀ = k·qᵀ and dpᵀ = v·dOᵀ contract over d, the q / dO chunk's
//     contiguous axis: the chunk, split into hi and lo tiles in shared
//     memory, is the B operand as TMA writes it; k / v (resident, as
//     loaded) is the A operand, from registers, read by index and split
//     there;
//   * dvᵀ += dOᵀ·p and dkᵀ += qᵀ·ds contract over the chunk's q rows: the
//     products are formed transposed, d the M axis; the A operand dOᵀ /
//     qᵀ is read by index from the chunk's hi and lo tiles into
//     registers, and the B operand pᵀ / dsᵀ [kv][q] is written into shared
//     memory as hi and lo tiles straight from sᵀ's accumulator layout;
//   * a block (256 threads, two warpgroups, one of whose threads issues
//     the loads) takes 64 kv rows and walks each live cell's q block in
//     chunks of 32 rows; warpgroup 0 forms sᵀ, pᵀ and dvᵀ and hands p·g
//     to warpgroup 1 through shared memory, which forms dpᵀ, dsᵀ and
//     dkᵀ;
//   * d <= 128: a stage holds a whole chunk (its four tiles take R d 16
//     bytes: d = 128 fits two stages beside k, v and the pᵀ / dsᵀ tiles in
//     227 KB), held through the updates, and the association of
//     fold_dkv_tc's cell element and carry (dk = dk + scale·dk_e, dv = dv
//     + dv_e, __fadd_rn / __fmul_rn) is kept;
//   * d = 256: k and v alone take 128 KB and a whole chunk 128 KB more, so
//     a chunk streams through the ring in stages of 64 columns: four for
//     sᵀ and dpᵀ (q and dO split in place), then one for each 64-row tile
//     of dvᵀ and dkᵀ (q and dO raw, read by index and split in registers;
//     the first brings the rows' m, l, delta), each released once read,
//     so that the next stage's load is in flight (two stages of 33 KB
//     fit). A warpgroup's registers hold its four tiles of dvᵀ or dkᵀ but
//     not a cell element beside them, so the element is a chunk's, one
//     64-row tile at a time, from zero, then combined as above (a
//     skipped dead cell still adds nothing: the bits do not depend on the
//     bounds; accumulating every chunk in the wgmma accumulators instead
//     was faster but gave a larger error against the plain fold).
// Named barriers: 1 + wg within a warpgroup, 3 "p·g of this chunk is
// written" (warpgroup 0 arrives), 4 "the last chunk's dsᵀ is read" (1
// arrives), 5 "the chunk's dO is split" (1 arrives); each side that only
// arrives waits on another barrier that the other side passes after its
// wait, so an arrival never runs a generation ahead.

template <int D>
struct Tf32DkvTiles {
  static constexpr int kRows = 32;                 // q rows a chunk
  static constexpr int kKvPanel = 64 * 128;        // 64 rows x 32 floats
  static constexpr int kQPanel = kRows * 128;      // 32 rows x 32 floats
  static constexpr int kKvBytes = D / 32 * kKvPanel;   // 64 kv rows x D
  static constexpr int kMT = D / 64;           // 64-row tiles of dkᵀ / dvᵀ
  // d = 256 streams a chunk through stages of 64 columns (above); d <=
  // 128 holds it whole in one stage
  static constexpr bool kStream = D == 256;
  static constexpr int kDChunk = kStream ? 64 : D;   // columns a stage
  static constexpr int kScoreStages = D / kDChunk;
  static constexpr int kChunkStages = kStream ? kScoreStages + kMT : 1;
  static constexpr int kStatStage = kStream ? kScoreStages : 0;
  static constexpr int kQBytes = kDChunk / 32 * kQPanel;   // 32 rows
  static constexpr int kStages = D == 64 ? 4 : 2;
  // a stage: q hi, q lo, dO hi, dO lo (raw q at 0 and dO at 2 kQBytes in
  // an update stage), and apart the rows' m, l, delta (kStatStage's)
  static constexpr int kStageBytes = 4 * kQBytes;
  static constexpr int kStatBytes = 3 * kRows * 4;
  // pᵀ hi, lo, then p·g / dsᵀ hi and dsᵀ lo: [64 kv][32 q] each
  static constexpr int kPBytes = 4 * kKvPanel;
  static constexpr int kThreads = 256;
  static constexpr int kSmem = 1024 + 2 * kKvBytes + kPBytes +
                               kStages * (kStageBytes + kStatBytes) +
                               8 * (2 * kStages + 1);
};

// The shared-memory address of float (r, c) of a tile of 32-column panels
// of `panel` bytes each, rows of 128 bytes swizzled as TMA writes them.
__device__ __forceinline__ uint32_t f32_at(uint32_t tile, int panel, int r,
                                           int c) {
  return tile + (c >> 5) * panel + r * 128 +
         ((((c & 31) >> 2) ^ (r & 7)) << 4) + ((c & 3) << 2);
}

__device__ __forceinline__ float ld_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(addr));
  return v;
}
__device__ __forceinline__ uint32_t ld_b32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];" : "=r"(v) : "r"(addr));
  return v;
}

// x rounded to TF32 (10 mantissa bits, to nearest, ties away), as a
// float32 bit pattern whose 13 low bits are 0.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}
// x = hi + lo to ~22 bits: hi = tf32(x), lo = tf32(x - hi) (x - hi exact).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(__fsub_rn(x, __uint_as_float(hi)));
}

// A warpgroup splits `bytes` of float32 at `raw` (a TMA-written tile) into
// TF32 hi, in place, and lo at `lo`, 16 bytes a thread at a time.
__device__ __forceinline__ void split_tile(uint32_t raw, uint32_t lo,
                                           int bytes, int tid) {
  for (int i = tid; i < bytes / 16; i += 128) {
    float4 v;
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
                 : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
                 : "r"(raw + 16 * i));
    uint32_t h[4], l[4];
    split_tf32(v.x, h[0], l[0]);
    split_tf32(v.y, h[1], l[1]);
    split_tf32(v.z, h[2], l[2]);
    split_tf32(v.w, h[3], l[3]);
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};" ::"r"(
                     raw + 16 * i),
                 "r"(h[0]), "r"(h[1]), "r"(h[2]), "r"(h[3])
                 : "memory");
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};" ::"r"(
                     lo + 16 * i),
                 "r"(l[0]), "r"(l[1]), "r"(l[2]), "r"(l[3])
                 : "memory");
  }
}

// K-major descriptor of k-step kk (8 tf32 columns, 32 bytes) of a tile of
// 32-column panels of `panel` bytes.
__device__ __forceinline__ uint64_t tf32_desc(uint32_t tile, int kk,
                                              int panel) {
  return sw128_desc(tile + (kk >> 2) * panel + (kk & 3) * 32, 16, 1024);
}

__device__ __forceinline__ void wg_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
}

// d (64 x 32, f32) = [d +] A (64 x 8) * B (8 x 32), TF32: A from registers
// (a thread's a0 .. a3 at rows g, g + 8 and columns t, t + 4 of its warp's
// 16 rows, g = lane / 4, t = lane % 4), B K-major in shared memory.
__device__ __forceinline__ void wgmma_tf32(float (&d)[16],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d (64 x 64, f32) = [d +] A (64 x 8) * B (8 x 64), TF32, as above.
__device__ __forceinline__ void wgmma_tf32(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// The byte offset of a thread's entries x, x + 1 (x even) of a (64 x 32)
// accumulator in a [64][32] float32 panel (rows of 128 bytes, swizzled).
__device__ __forceinline__ uint32_t f32_pair(int x, int tid) {
  const int r = tile_row(tid, (x >> 1) & 1), c = 8 * (x >> 2) + 2 * (tid % 4);
  return r * 128 + (((c >> 2) ^ (r & 7)) << 4) + ((c & 3) << 2);
}

__device__ __forceinline__ void st_f32x2(uint32_t addr, float v0, float v1) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};" ::"r"(addr), "f"(v0),
               "f"(v1)
               : "memory");
}
__device__ __forceinline__ float2 ld_f32x2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];"
               : "=f"(v.x), "=f"(v.y)
               : "r"(addr));
  return v;
}

// Entries x, x + 1 as TF32 hi into panel `hi` and lo into panel `lo`.
__device__ __forceinline__ void store_split(uint32_t hi, uint32_t lo, int x,
                                            int tid, float v0, float v1) {
  uint32_t h0, l0, h1, l1;
  split_tf32(v0, h0, l0);
  split_tf32(v1, h1, l1);
  const uint32_t off = f32_pair(x, tid);
  st_f32x2(hi + off, __uint_as_float(h0), __uint_as_float(h1));
  st_f32x2(lo + off, __uint_as_float(l0), __uint_as_float(l1));
}

// acc (64 x N) [+]= A (64 x 8 KS) · B over KS k-steps, three TF32
// products of the split operands: A float32 in shared memory, tiles of
// 32-column panels of APANEL bytes, A(m, k) at (m, c0 + k), or at (c0 +
// k, m) when transposed (AT), read by index and split in registers; B the
// K-major split tiles b_hi / b_lo (panels of BPANEL bytes); from zero when
// `first`; the A registers of STEPS k-steps in flight (2, or 1 where a
// kernel has no registers to spare; KS a multiple of STEPS).
// fold_dkv_tf32's sᵀ = k·qᵀ and dpᵀ = v·dOᵀ (N 32) and, at d = 256, dvᵀ
// and dkᵀ with A transposed (N 64); fold_dq_tf32's s = q·kᵀ and dp =
// dO·vᵀ, and dqᵀ = kᵀ·dsᵀ with A transposed (N 64).
template <int KS, int APANEL, bool AT, int BPANEL, int STEPS = 2, int NA>
__device__ __forceinline__ void tf32_mma(float (&s)[NA], uint32_t a, int c0,
                                         uint32_t b_hi, uint32_t b_lo,
                                         int tid, bool first) {
  const int quad = tid % 4;
#pragma unroll
  for (int kb = 0; kb < KS; kb += STEPS) {
    uint32_t ah[STEPS][4], al[STEPS][4];
#pragma unroll
    for (int u = 0; u < STEPS; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = tile_row(tid, e & 1);
        const int k = c0 + 8 * (kb + u) + quad + 4 * (e >> 1);
        split_tf32(ld_f32(AT ? f32_at(a, APANEL, k, m)
                             : f32_at(a, APANEL, m, k)),
                   ah[u][e], al[u][e]);
      }
    wg_fence();
#pragma unroll
    for (int u = 0; u < STEPS; ++u) {
      const int kk = kb + u;
      const uint64_t dh = tf32_desc(b_hi, kk, BPANEL);
      const uint64_t dl = tf32_desc(b_lo, kk, BPANEL);
      wgmma_tf32(s, al[u], dh, !(first && kk == 0));
      wgmma_tf32(s, ah[u], dl, 1);
      wgmma_tf32(s, ah[u], dh, 1);
    }
    wg_commit();
    if constexpr (STEPS == 1)
      wg_wait();
    else
      wg_wait1();   // the batch before is done: its A registers are free
  }
  wg_wait();
  keep(s);
}

// el (the block's dkᵀ / dvᵀ columns, kMT 64-row tiles) [+]= Aᵀ·P: dvᵀ +=
// dOᵀ·p (warpgroup 0) or dkᵀ += qᵀ·ds (1), A read by index from the
// chunk's split tiles, tile mt's 64 columns starting at a_hi[mt] /
// a_lo[mt] ([32 q][·] panels), P the [64 kv][32 q] split tiles p_hi /
// p_lo; first: the cell's first chunk (from zero).
template <int D>
__device__ __forceinline__ void tf32_update(
    float (&el)[Tf32DkvTiles<D>::kMT][32],
    const uint32_t (&a_hi)[Tf32DkvTiles<D>::kMT],
    const uint32_t (&a_lo)[Tf32DkvTiles<D>::kMT], uint32_t p_hi,
    uint32_t p_lo, bool first, int tid) {
  using G = Tf32DkvTiles<D>;
  constexpr int MT = G::kMT;
  const int quad = tid % 4;
#pragma unroll
  for (int kk = 0; kk < G::kRows / 8; ++kk) {
    uint32_t ah[MT][4], al[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int q = 8 * kk + quad + 4 * (e >> 1);
        const int m = tile_row(tid, e & 1);
        ah[mt][e] = ld_b32(f32_at(a_hi[mt], G::kQPanel, q, m));
        al[mt][e] = ld_b32(f32_at(a_lo[mt], G::kQPanel, q, m));
      }
    wg_fence();
    const uint64_t dh = tf32_desc(p_hi, kk, G::kKvPanel);
    const uint64_t dl = tf32_desc(p_lo, kk, G::kKvPanel);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      wgmma_tf32(el[mt], al[mt], dh, !(first && kk == 0));
      wgmma_tf32(el[mt], ah[mt], dl, 1);
      wgmma_tf32(el[mt], ah[mt], dh, 1);
    }
    wg_commit();
    wg_wait1();
  }
  wg_wait();
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) keep(el[mt]);
}

// Block (kv head hk, kv block jb, 64-row sub-block sub), split y; folds
// the (group x q-block) axis as fold_dkv_tc_kernel does.
template <int D>
__global__ void __launch_bounds__(256, 1)
    fold_dkv_tf32_kernel(const __grid_constant__ TcMaps maps, FoldArgs a,
                         FoldPtrs p) {
  using G = Tf32DkvTiles<D>;
  constexpr int R = G::kRows, MT = G::kMT, NS = G::kScoreStages;
  constexpr int NJ = G::kChunkStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* k_s = align1024(smem_raw);   // this block's 64 kv rows, whole d
  const uint32_t k_u = smem_u32(k_s), v_u = k_u + G::kKvBytes;
  const uint32_t pt = v_u + G::kKvBytes;           // pᵀ hi, lo, g hi, lo
  const uint32_t stages_u = pt + G::kPBytes;
  const uint32_t stats_u = stages_u + G::kStages * G::kStageBytes;
  // mbarriers: full[kStages], empty[kStages], then k and v's
  const uint32_t full = stats_u + G::kStages * G::kStatBytes;
  const uint32_t empty = full + 8 * G::kStages, kvbar = empty + 8 * G::kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < G::kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 256);
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int nsub = a.bk / 64;
  const int sub = blockIdx.x % nsub;
  const int jb = (blockIdx.x / nsub) % a.nk;
  const int hk = blockIdx.x / nsub / a.nk;
  const int nch = a.bq / R;
  const int f0 = blockIdx.y * a.bpc;
  const int wg = threadIdx.x / 128;
  const bool loader = threadIdx.x == 128;
  // the loader's walk over the live chunks (lf, lc) of the fold, stage lj
  // of the chunk
  int lf = f0, lc = 0, lj = 0, lstage = 0;
  uint32_t lphase = 0;
  auto skip_dead = [&]() {
    while (lf < f0 + a.bpc && !cell_live(a, lf % a.nq, jb)) ++lf;
  };
  auto load_next = [&]() {   // stage lj of chunk (lf, lc) into lstage, then on
    const uint32_t bar = full + 8 * lstage;
    const bool stats = lj == G::kStatStage;
    mbar_wait(empty + 8 * lstage, lphase ^ 1);
    mbar_expect_tx(bar, 2 * G::kQBytes + (stats ? G::kStatBytes : 0));
    const uint32_t st = stages_u + lstage * G::kStageBytes;
    const int qrow = (hk * a.group + lf / a.nq) * a.tq +
                     (lf % a.nq) * a.bq + R * lc;
    // score stage lj's columns, or those of update stage lj's tile lj - NS
    const int col = G::kDChunk * (lj % NS);
    for (int pn = 0; pn < G::kDChunk / 32; ++pn) {
      tma_load_2d(st + pn * G::kQPanel, &maps.q, bar, col + 32 * pn, qrow);
      tma_load_2d(st + 2 * G::kQBytes + pn * G::kQPanel, &maps.dout, bar,
                  col + 32 * pn, qrow);
    }
    if (stats) {
      const uint32_t sts = stats_u + lstage * G::kStatBytes;
      bulk_load(sts, p.m + qrow, 4 * R, bar);
      bulk_load(sts + 4 * R, p.l + qrow, 4 * R, bar);
      bulk_load(sts + 8 * R, p.delta + qrow, 4 * R, bar);
    }
    if (++lstage == G::kStages) {
      lstage = 0;
      lphase ^= 1;
    }
    if (++lj == NJ) {
      lj = 0;
      if (++lc == nch) {
        lc = 0;
        ++lf;
        skip_dead();
      }
    }
  };
  if (loader) {
    const int kvrow = hk * a.tk + jb * a.bk + 64 * sub;
    mbar_expect_tx(kvbar, 2 * G::kKvBytes);
    for (int pn = 0; pn < D / 32; ++pn) {
      tma_load_2d(k_u + pn * G::kKvPanel, &maps.k, kvbar, 32 * pn, kvrow);
      tma_load_2d(v_u + pn * G::kKvPanel, &maps.v, kvbar, 32 * pn, kvrow);
    }
    skip_dead();
    for (int k = 0; k < G::kStages && lf < f0 + a.bpc; ++k) load_next();
  }
  {  // warpgroup wg: 0 forms dv, 1 forms dk
    const int tid = threadIdx.x % 128, quad = tid % 4;
    float acc[MT][32];   // the carry: dvᵀ (warpgroup 0) or dkᵀ (1)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int x = 0; x < 32; ++x) acc[mt][x] = 0.f;
    const float inv_cap = a.has_softcap ? recip(a.softcap) : 0.f;
    const uint32_t p_hi = pt, p_lo = pt + G::kKvPanel;
    const uint32_t g_hi = pt + 2 * G::kKvPanel, g_lo = pt + 3 * G::kKvPanel;
    // this warpgroup's update operands: P (pᵀ or dsᵀ), and the offset of
    // A (dO or q) in a stage
    const uint32_t b_hi = wg == 0 ? p_hi : g_hi, b_lo = wg == 0 ? p_lo : g_lo;
    const uint32_t a_off = 2 * G::kQBytes * (1 - wg);
    const float sc = wg == 0 ? 1.f : a.scale;   // dk = dk + scale·dk_e
    int count = 0, stage = 0, chunks = 0;
    uint32_t phase = 0;
    auto release = [&]() {   // the current stage is read: refill, move on
      mbar_arrive(empty + 8 * stage);
      if (++stage == G::kStages) {
        stage = 0;
        phase ^= 1;
      }
      if (loader && lf < f0 + a.bpc) load_next();   // kStages ahead
    };
    mbar_wait(kvbar, 0);
    __syncwarp();
    for (int f = f0; f < f0 + a.bpc; ++f) {
      const int qi = f % a.nq;
      if (!cell_live(a, qi, jb)) continue;
      ++count;
      float el[G::kStream ? 1 : MT][32];   // d <= 128: dvᵀ_e or dkᵀ_e
      for (int c = 0; c < nch; ++c, ++chunks) {
        if (wg == 1 && chunks > 0) bar_arrive(4, 256);   // the last is done
        // sᵀ = k·qᵀ (warpgroup 0) or dpᵀ = v·dOᵀ (1) over the score
        // stages; warpgroup 0 splits each one's q, 1 its dO (hi in place)
        float s[16];
#pragma unroll 1
        for (int j = 0; j < NS; ++j) {
          mbar_wait(full + 8 * stage, phase);
          __syncwarp();
          const uint32_t hi = stages_u + stage * G::kStageBytes +
                              2 * G::kQBytes * wg;
          split_tile(hi, hi + G::kQBytes, G::kQBytes, tid);
          fence_async();
          wg_sync(wg);
          if (wg == 1 && j == NS - 1) bar_arrive(5, 256);   // dO is split
          tf32_mma<G::kDChunk / 8, G::kKvPanel, false, G::kQPanel>(
              s, wg == 0 ? k_u : v_u, G::kDChunk * j, hi, hi + G::kQBytes,
              tid, j == 0);
          if (G::kStream) release();
        }
        // the stage with the rows' (m, l, delta): d <= 128 the chunk's,
        // held through the update; d = 256 the first update stage
        if (G::kStream) {
          mbar_wait(full + 8 * stage, phase);
          __syncwarp();
        }
        const float* sts = reinterpret_cast<const float*>(
            k_s + (stats_u + stage * G::kStatBytes - k_u));
        int2 live[2];   // the chunk's q rows each of the thread's kv rows sees
#pragma unroll
        for (int i = 0; i < 2; ++i)
          live[i] = live_rows(
              a, (long long)jb * a.pos_bk + 64 * sub + tile_row(tid, i),
              (long long)qi * a.pos_bq + R * c, R);
        if (wg == 0) {
          if (chunks > 0) bar_sync(4, 256);   // the last dsᵀ / p·g is read
          // pᵀ = exp(s - m) / l as hi, lo; p·g (g = tanh' under softcap)
          // whole, for warpgroup 1
#pragma unroll
          for (int x = 0; x < 16; x += 2) {
            const int i = (x >> 1) & 1;
            float pv[2], pg[2];
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const int qc = 8 * (x >> 2) + 2 * quad + u;
              const bool ok = qc >= live[i].x && qc < live[i].y;
              const float sv = logit_tc(a, s[x + u], inv_cap);
              const float l = sts[R + qc];
              pv[u] = ok ? expf(sv - sts[qc]) * recip(l == 0.f ? 1.f : l)
                         : 0.f;
              pg[u] = pv[u];
              if (a.has_softcap) {   // tanh' = 1 - (s / cap)^2
                const float t = sv * inv_cap;
                pg[u] = pv[u] * __fsub_rn(1.f, __fmul_rn(t, t));
              }
            }
            store_split(p_hi, p_lo, x, tid, pv[0], pv[1]);
            st_f32x2(g_hi + f32_pair(x, tid), pg[0], pg[1]);
          }
          fence_async();
          bar_sync(5, 256);     // warpgroup 1 has split dO
          bar_arrive(3, 256);   // p·g is written
          wg_sync(0);           // and pᵀ, for this warpgroup's products
        } else {
          bar_sync(3, 256);   // p·g from warpgroup 0
          // dsᵀ = p·g (dpᵀ - delta) as hi (over p·g) and lo
#pragma unroll
          for (int x = 0; x < 16; x += 2) {
            const int qc = 8 * (x >> 2) + 2 * quad;
            const float2 pg = ld_f32x2(g_hi + f32_pair(x, tid));
            store_split(g_hi, g_lo, x, tid,
                        __fmul_rn(pg.x, __fsub_rn(s[x], sts[2 * R + qc])),
                        __fmul_rn(pg.y,
                                  __fsub_rn(s[x + 1], sts[2 * R + qc + 1])));
          }
          fence_async();
          wg_sync(1);
        }
        if constexpr (G::kStream) {
          // the chunk's dvᵀ_e = dOᵀ·p (dkᵀ_e = qᵀ·ds) a 64-row tile a
          // stage, A raw from the stage by index, from zero; then dv = dv +
          // dv_e (dk = dk + scale·dk_e)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            if (mt > 0) {
              mbar_wait(full + 8 * stage, phase);
              __syncwarp();
            }
            float e[32];   // one k-step's A in flight: 255 registers
            tf32_mma<R / 8, G::kQPanel, true, G::kKvPanel, 1>(
                e, stages_u + stage * G::kStageBytes + a_off, 0, b_hi, b_lo,
                tid, true);
            release();
#pragma unroll
            for (int x = 0; x < 32; ++x)   // e · 1 is e: dv = dv + dv_e
              acc[mt][x] = __fadd_rn(acc[mt][x], __fmul_rn(e[x], sc));
          }
        } else {
          // the cell's dvᵀ_e += dOᵀ·p (dkᵀ_e += qᵀ·ds), A from the held
          // stage's split tiles, from zero at the cell's first chunk
          uint32_t a_hi[MT], a_lo[MT];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            a_hi[mt] = stages_u + stage * G::kStageBytes + a_off +
                       2 * mt * G::kQPanel;
            a_lo[mt] = a_hi[mt] + G::kQBytes;
          }
          tf32_update<D>(el, a_hi, a_lo, b_hi, b_lo, c == 0, tid);
          release();
        }
      }
      if constexpr (!G::kStream) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int x = 0; x < 32; ++x)
            acc[mt][x] = wg == 0 ? __fadd_rn(acc[mt][x], el[mt][x])
                                 : __fadd_rn(acc[mt][x],
                                             __fmul_rn(el[mt][x], sc));
      }
    }

    // entry x of row tile mt: d column 64 mt + tile_row(tid, i), kv row
    // 8 (x >> 2) + 2 quad + (x & 1) of the block's 64
    float* dst;
    long long row0;
    if (p.c0) {
      dst = wg == 0 ? p.c1 : p.c0;
      row0 = ((long long)(hk * a.nk + jb) * a.splits + blockIdx.y) * a.bk;
    } else {
      dst = static_cast<float*>(wg == 0 ? p.out1 : p.out0);
      row0 = (long long)hk * a.tk + (long long)jb * a.bk;
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        const int col = 64 * mt + tile_row(tid, (x >> 1) & 1);
        const int kr = 64 * sub + 8 * (x >> 2) + 2 * quad + (x & 1);
        dst[(row0 + kr) * D + col] = acc[mt][x];
      }
    if (!p.c0 && p.counts && wg == 1 && sub == 0 && tid == 0)
      p.counts[hk * a.nk + jb] = count;
  }
}

// -- backward dq in float32 on the tensor cores (3xTF32) ---------------------
//
// fold_dq_tf32: what fold_dq_kernel computes on float32 operands
// (softmax_bwd_dq on KVBlocks, the carry fold and the split pass), every
// product as three TF32 wgmmas of the split operands, as fold_dkv_tf32's.
// TF32 wgmma reads shared memory K-major only, so:
//   * s = q·kᵀ and dp = dO·vᵀ (M = the block's 64 q rows) contract over
//     d: q and dO, resident as loaded, are the A operand, read by index
//     and split in registers; k and v, whose rows are K-major as stored,
//     are the B operand, split into hi and lo tiles in shared memory;
//   * dq = ds·k contracts over kv rows, along which k is not contiguous:
//     it is formed transposed, dqᵀ += kᵀ·dsᵀ (M = 64 columns of d), with
//     A = kᵀ read by index from the k rows and split in registers, and B =
//     dsᵀ written as [q][kv] hi and lo tiles straight from s's
//     accumulator layout (K-major: kv contiguous).
// Budget at d = 256: q and dO take 64 KB each and a 64-row k or v tile as
// hi + lo 128 KB, so k and v stream through a ring of 32 KB stages: a
// 64-row kv tile of a cell takes d / 32 stages of 32 columns of k and of
// v (split in place, hi over the raw floats, for s and dp) and then
// stages of 64 columns of k for each warpgroup's dqᵀ tiles (raw, k read
// again). A block (256 threads, two warpgroups, one of whose threads
// issues the loads) takes one 64-row q tile; warpgroup 0 forms s and p·g
// (p = exp(s - m) / l, g = tanh' under softcap, else 1) into the ds
// tiles, warpgroup 1 dp and ds = p·g (dp - delta) over them, then each
// forms its columns of dqᵀ: both own half of d >= 128, warpgroup 0 all
// 64 at d = 64 (two 64-row tiles at most, 64 accumulator registers). The
// element a kv tile adds, dq_e = kᵀ·dsᵀ from zero over its 64 rows, is
// combined into the carry with __fmul_rn / __fadd_rn (dq = dq +
// scale·dq_e): a skipped dead cell and a page-permuted pool give the bits
// of folding it and of the contiguous pool, as in the other forms.
// Named barriers: 1 + wg within a warpgroup, 3 "p·g is written" (0
// arrives), 4 "ds is written" (1 arrives), 5 "the last tile's ds is read"
// (1 arrives), ordered as fold_dkv_tf32's.

template <int D>
struct Tf32DqTiles {
  static constexpr int kPanel = 64 * 128;             // 64 rows x 32 floats
  static constexpr int kTileBytes = D / 32 * kPanel;  // 64 rows x D
  static constexpr int kMT = D / 64;                  // 64-row tiles of dqᵀ
  static constexpr int kOwn = D < 128 ? 1 : kMT / 2;  // ... a warpgroup owns
  // stages a 64-row kv tile: 32 columns of k and v each, then a 64-column
  // k tile for each warpgroup's dqᵀ tile
  static constexpr int kScoreStages = D / 32;
  static constexpr int kTileStages = kScoreStages + kOwn;
  static constexpr int kStageBytes = 4 * kPanel;
  static constexpr int kStages = D == 256 ? 2 : D == 128 ? 4 : 5;
  // ds (p·g first) as hi, then lo: [64 q][64 kv], two panels each
  static constexpr int kDsBytes = 4 * kPanel;
  static constexpr int kThreads = 256;
  static constexpr int kSmem = 1024 + 2 * kTileBytes + kDsBytes +
                               kStages * kStageBytes + 8 * (2 * kStages + 1);
};

// Block (q head h, q block qi, 64-row q tile sub), split y; folds the KV
// blocks as fold_dq_kernel does.
template <int D>
__global__ void __launch_bounds__(256, 1)
    fold_dq_tf32_kernel(const __grid_constant__ TcMaps maps, FoldArgs a,
                        FoldPtrs p) {
  using G = Tf32DqTiles<D>;
  constexpr int NS = G::kScoreStages, NJ = G::kTileStages, PN = G::kPanel;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_u = smem_u32(align1024(smem_raw));
  const uint32_t do_u = q_u + G::kTileBytes;
  const uint32_t ds_hi = do_u + G::kTileBytes, ds_lo = ds_hi + 2 * PN;
  const uint32_t ring_u = ds_hi + G::kDsBytes;
  // mbarriers: full[kStages], empty[kStages], then the q and dO tiles'
  const uint32_t full = ring_u + G::kStages * G::kStageBytes;
  const uint32_t empty = full + 8 * G::kStages, qbar = empty + 8 * G::kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < G::kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 256);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int nt = a.bq / 64;   // 64-row tiles of a q block
  const int sub = blockIdx.x % nt;
  const int qi = (blockIdx.x / nt) % a.nq;
  const int h = blockIdx.x / nt / a.nq;
  const int hk = h / a.group;
  const int nsub = a.bk / 64;
  const int f0 = blockIdx.y * a.bpc;
  const long long qrow0 = (long long)h * a.tq + (long long)qi * a.bq + 64 * sub;
  const int wg = threadIdx.x / 128;
  const bool loader = threadIdx.x == 128;
  // the loader's walk: live cell lf, its 64-row kv tile lt, stage lj of
  // the tile, into ring slot lstage
  int lf = f0, lt = 0, lj = 0, lstage = 0;
  uint32_t lphase = 0;
  auto skip_dead = [&]() {
    while (lf < f0 + a.bpc && !cell_live(a, qi, lf)) ++lf;
  };
  auto load_next = [&]() {
    const uint32_t bar = full + 8 * lstage;
    mbar_wait(empty + 8 * lstage, lphase ^ 1);
    const uint32_t st = ring_u + lstage * G::kStageBytes;
    const int phys = p.kv_map ? p.kv_map[lf] : lf;
    const int row = hk * a.tk + phys * a.bk + 64 * lt;
    if (lj < NS) {   // columns 32 lj .. of k (at 0) and v (at 2 panels)
      mbar_expect_tx(bar, 2 * PN);
      tma_load_2d(st, &maps.k, bar, 32 * lj, row);
      tma_load_2d(st + 2 * PN, &maps.v, bar, 32 * lj, row);
    } else {   // warpgroup w's dqᵀ tile: 64 columns of k at 2 w panels
      int parts = 0;
      for (int w = 0; w < 2; ++w) parts += G::kOwn * w + lj - NS < G::kMT;
      mbar_expect_tx(bar, parts * 2 * PN);
      for (int w = 0; w < 2; ++w) {
        const int mt = G::kOwn * w + lj - NS;
        if (mt >= G::kMT) continue;
        tma_load_2d(st + 2 * PN * w, &maps.k, bar, 64 * mt, row);
        tma_load_2d(st + 2 * PN * w + PN, &maps.k, bar, 64 * mt + 32, row);
      }
    }
    if (++lstage == G::kStages) {
      lstage = 0;
      lphase ^= 1;
    }
    if (++lj == NJ) {
      lj = 0;
      if (++lt == nsub) {
        lt = 0;
        ++lf;
        skip_dead();
      }
    }
  };
  if (loader) {
    mbar_expect_tx(qbar, 2 * G::kTileBytes);
    for (int pn = 0; pn < D / 32; ++pn) {
      tma_load_2d(q_u + pn * PN, &maps.q, qbar, 32 * pn, (int)qrow0);
      tma_load_2d(do_u + pn * PN, &maps.dout, qbar, 32 * pn, (int)qrow0);
    }
    skip_dead();
    for (int k = 0; k < G::kStages && lf < f0 + a.bpc; ++k) load_next();
  }

  const int tid = threadIdx.x % 128, quad = tid % 4;
  float acc[G::kOwn][32];   // the carry: this warpgroup's dqᵀ tiles
#pragma unroll
  for (int j = 0; j < G::kOwn; ++j)
#pragma unroll
    for (int x = 0; x < 32; ++x) acc[j][x] = 0.f;
  const float inv_cap = a.has_softcap ? recip(a.softcap) : 0.f;
  // the thread's rows: position, and the forward's m, 1 / l (l == 0
  // marks a fully masked row: 1), delta
  long long qpos[2];
  float m_r[2], il_r[2], dl_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long g = qrow0 + tile_row(tid, i);
    qpos[i] = (long long)qi * a.pos_bq + 64 * sub + tile_row(tid, i);
    m_r[i] = p.m[g];
    const float l = p.l[g];
    il_r[i] = recip(l == 0.f ? 1.f : l);
    dl_r[i] = p.delta[g];
  }
  int count = 0, stage = 0, tiles = 0;
  uint32_t phase = 0;
  auto release = [&]() {   // the current stage is read: refill, move on
    mbar_arrive(empty + 8 * stage);
    if (++stage == G::kStages) {
      stage = 0;
      phase ^= 1;
    }
    if (loader && lf < f0 + a.bpc) load_next();   // kStages ahead
  };
  mbar_wait(qbar, 0);
  __syncwarp();
  for (int f = f0; f < f0 + a.bpc; ++f) {
    if (!cell_live(a, qi, f)) continue;
    ++count;
    for (int t = 0; t < nsub; ++t, ++tiles) {
      if (wg == 1 && tiles > 0) bar_arrive(5, 256);   // the last ds is read
      // s = q·kᵀ (warpgroup 0) or dp = dO·vᵀ (1), 32 columns of d a stage
      float s[32];
#pragma unroll 1
      for (int j = 0; j < NS; ++j) {
        mbar_wait(full + 8 * stage, phase);
        __syncwarp();
        const uint32_t b = ring_u + stage * G::kStageBytes + 2 * PN * wg;
        split_tile(b, b + PN, PN, tid);
        fence_async();
        wg_sync(wg);
        tf32_mma<4, PN, false, PN>(s, wg == 0 ? q_u : do_u, 32 * j, b,
                                   b + PN, tid, j == 0);
        release();
      }
      if (wg == 0) {
        // p·g on the live entries into the ds tiles (hi), whole; a masked
        // entry is 0, not left to underflow (a fully masked row has m =
        // NEG_INF)
        int2 live[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          live[i] = live_cols(a, qpos[i], (long long)f * a.pos_bk + 64 * t,
                              64);
        if (tiles > 0) bar_sync(5, 256);   // the last tile's ds is read
#pragma unroll
        for (int x = 0; x < 32; x += 2) {
          const int i = (x >> 1) & 1, c = 8 * (x >> 2) + 2 * quad;
          float pg[2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const bool ok = c + u >= live[i].x && c + u < live[i].y;
            const float sv = logit_tc(a, s[x + u], inv_cap);
            pg[u] = ok ? expf(sv - m_r[i]) * il_r[i] : 0.f;
            if (a.has_softcap) {   // tanh' = 1 - (s / cap)^2
              const float tc = sv * inv_cap;
              pg[u] = pg[u] * __fsub_rn(1.f, __fmul_rn(tc, tc));
            }
          }
          st_f32x2(ds_hi + (x >> 4) * PN + f32_pair(x & 15, tid), pg[0],
                   pg[1]);
        }
        bar_arrive(3, 256);   // p·g is written
        bar_sync(4, 256);     // ds is written
      } else {
        bar_sync(3, 256);     // p·g from warpgroup 0
        // ds = p·g (dp - delta) as hi (over p·g) and lo
#pragma unroll
        for (int x = 0; x < 32; x += 2) {
          const int i = (x >> 1) & 1;
          const uint32_t hi = ds_hi + (x >> 4) * PN, lo = ds_lo + (x >> 4) * PN;
          const float2 pg = ld_f32x2(hi + f32_pair(x & 15, tid));
          store_split(hi, lo, x & 15, tid,
                      __fmul_rn(pg.x, __fsub_rn(s[x], dl_r[i])),
                      __fmul_rn(pg.y, __fsub_rn(s[x + 1], dl_r[i])));
        }
        fence_async();
        bar_arrive(4, 256);   // ds is written
        wg_sync(1);           // and visible to this warpgroup's wgmma
      }
      // this warpgroup's dqᵀ tiles: the element dq_e = kᵀ·dsᵀ from zero
      // over the kv tile's 64 rows, then dq = dq + scale·dq_e
#pragma unroll
      for (int j = 0; j < G::kOwn; ++j) {
        mbar_wait(full + 8 * stage, phase);
        __syncwarp();
        if (G::kOwn * wg + j < G::kMT) {
          float e[32];
          tf32_mma<8, PN, true, PN>(
              e, ring_u + stage * G::kStageBytes + 2 * PN * wg, 0, ds_hi,
              ds_lo, tid, true);
#pragma unroll
          for (int x = 0; x < 32; ++x)
            acc[j][x] = __fadd_rn(acc[j][x], __fmul_rn(e[x], a.scale));
        }
        release();
      }
    }
  }

  // entry x of tile j: d column 64 (kOwn wg + j) + tile_row(tid, i), q
  // row 8 (x >> 2) + 2 quad + (x & 1) of the block's 64
#pragma unroll
  for (int j = 0; j < G::kOwn; ++j) {
    const int mt = G::kOwn * wg + j;
    if (mt >= G::kMT) continue;
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const int col = 64 * mt + tile_row(tid, (x >> 1) & 1);
      const int r = 8 * (x >> 2) + 2 * quad + (x & 1);
      if (p.c0)   // split pass: publish the chunk's dq
        p.c0[((((long long)h * a.nq + qi) * a.splits + blockIdx.y) * a.bq +
              64 * sub + r) * D + col] = acc[j][x];
      else
        static_cast<float*>(p.out0)[(qrow0 + r) * D + col] = acc[j][x];
    }
  }
  if (!p.c0 && p.counts && sub == 0 && wg == 0 && tid == 0)
    p.counts[(long long)h * a.nq + qi] = count;
}

// -- forward in float32 on the tensor cores (3xTF32) -------------------------
//
// fold_fwd_tf32: what fold_fwd_kernel computes on float32 operands
// (softmax_pair on KVBlocks: the carry fold, which finalizes the output and
// writes the (m, l) statistics when the spec asks for them, and the split
// pass, which publishes (m, l, acc) to fold_chain), every product as three
// TF32 wgmmas of the split operands, as fold_dq_tf32's. TF32 wgmma reads
// shared memory K-major only, so:
//   * s = q·kᵀ (M = the block's 64 q rows) contracts over d: q, resident as
//     loaded, is the A operand, read by index and split in registers; k's
//     rows, K-major as stored, are the B operand, split into hi and lo tiles
//     in shared memory, in place;
//   * p·v contracts over kv rows, along which v is not contiguous: it is
//     formed transposed, accᵀ += vᵀ·pᵀ (M = 64 columns of d), with A = vᵀ
//     read by index from v's rows and split in registers, and B = p written
//     as [q][kv] hi and lo tiles straight from s's accumulator layout
//     (K-major: kv contiguous), as fold_dq_tf32 writes ds.
// A block (256 threads, two warpgroups, one of whose threads issues the
// loads) takes one 64-row q tile. Warpgroup t forms s of the cell's 64-row
// kv tile t (bk = 128: both warpgroups; bk = 64: warpgroup 0), so that s
// and p are formed once per cell; the two hand each other their rows'
// partial max and sum through shared memory. Each then owns half of d's
// columns of accᵀ (d >= 128; warpgroup 0 all 64 at d = 64), a 64-row tile
// at a time: the cell's element accᵀ_e from zero over the cell's kv rows,
// combined into the carry at once (acc = acc·a1 + accᵀ_e·a2 by q column,
// the scales a1 = exp(m_c - m), a2 = exp(m_e - m) of each row through
// shared memory).
// Budget at d = 256: q takes 64 KB and p as hi + lo 64 KB, so k and v
// stream through a ring of three 32 KB stages: a cell takes d / 32 stages
// of 32 columns of k of each of its kv tiles (split in place, hi over the
// raw floats), then a stage of 64 columns of v of one kv tile for each
// warpgroup's accᵀ tile (raw, read by index). Registers: the carry (64
// floats a thread at d = 256) beside one tile's element or s, and a
// partial product (32 each).
// Accumulation: the tensor cores add into their float32 accumulators with
// truncation, a bias that grows with the length of the chain: s over d =
// 256 in one chain of 32 k-steps missed the forward's 1e-5 bar against
// the plain fold at gemma2's shape (its row max off by 1.7e-5, which l
// and the split pass's acc carry whole). So a wgmma chain is at most 4
// k-steps (32 columns of d for s, 32 kv rows for accᵀ_e), from zero, and
// is added into its product with __fadd_rn; at d = 256 accᵀ_e's chains
// are one k-step each, its A registers one k-step's (kProductSteps: 255
// registers without a spill, where chains of 4 spilled).
// Association, as in the other forms: the cell's element (m_e, l_e,
// accᵀ_e) from zero, then combined into the carry with __fmul_rn /
// __fadd_rn, the carry the earlier operand; so a skipped dead cell and a
// page-permuted pool give the bits of folding its identity and of the
// contiguous pool. Named barriers: 1 + wg within a warpgroup, 3 "the rows'
// partial max are written", 4 "p, the partial sums and the scales are
// written" (both warpgroups pass both).

template <int D>
struct Tf32FwdTiles {
  static constexpr int kPanel = 64 * 128;             // 64 rows x 32 floats
  static constexpr int kQBytes = D / 32 * kPanel;     // 64 q rows x D
  static constexpr int kMT = D / 64;                  // 64-row tiles of accᵀ
  static constexpr int kOwn = D < 128 ? 1 : kMT / 2;  // ... a warpgroup owns
  static constexpr int kScoreStages = D / 32;   // stages of k a cell
  // a stage: k tile t's 32 columns at 2 t panels (hi over the raw floats,
  // then lo), or 64 columns of a v tile for warpgroup w at 2 w panels
  static constexpr int kStageBytes = 4 * kPanel;
  static constexpr int kStages = D == 256 ? 3 : 4;
  // p as hi, then lo: [64 q][128 kv], four panels each
  static constexpr int kPBytes = 8 * kPanel;
  // each warpgroup's partial row max and row sum, then the scales a1, a2
  static constexpr int kStatBytes = 6 * 64 * 4;
  static constexpr int kThreads = 256;
  static constexpr int kSmem = 1024 + kQBytes + kPBytes +
                               kStages * kStageBytes + kStatBytes +
                               8 * (2 * kStages + 1);
  // k-steps a wgmma chain of accᵀ_e (registers at d = 256, above)
  static constexpr int kProductSteps = D == 256 ? 1 : 4;
};

// Block (q head h, q block qi, 64-row q tile sub), split y; folds the KV
// blocks as fold_fwd_kernel does.
template <int D>
__global__ void __launch_bounds__(256, 1)
    fold_fwd_tf32_kernel(const __grid_constant__ TcMaps maps, FoldArgs a,
                         FoldPtrs p) {
  using G = Tf32FwdTiles<D>;
  constexpr int NS = G::kScoreStages, PN = G::kPanel;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align1024(smem_raw);
  const uint32_t q_u = smem_u32(base);
  const uint32_t p_hi = q_u + G::kQBytes, p_lo = p_hi + 4 * PN;
  const uint32_t ring_u = p_hi + G::kPBytes;
  const uint32_t stat_u = ring_u + G::kStages * G::kStageBytes;
  // the statistics: m_part[2][64], l_part[2][64], a1[64], a2[64]
  float* m_part = reinterpret_cast<float*>(base + (stat_u - q_u));
  float* l_part = m_part + 128;
  const uint32_t sc1 = stat_u + 256 * 4, sc2 = sc1 + 64 * 4;
  // mbarriers: full[kStages], empty[kStages], then the q tile's
  const uint32_t full = stat_u + G::kStatBytes;
  const uint32_t empty = full + 8 * G::kStages, qbar = empty + 8 * G::kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < G::kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 256);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int nt = a.bq / 64;   // 64-row tiles of a q block
  const int sub = blockIdx.x % nt;
  const int qi = (blockIdx.x / nt) % a.nq;
  const int h = blockIdx.x / nt / a.nq;
  const int hk = h / a.group;
  const int nsub = a.bk / 64;   // the cell's 64-row kv tiles
  const int nj = NS + G::kOwn * nsub;   // stages a cell
  const int f0 = blockIdx.y * a.bpc;
  const long long qrow0 = (long long)h * a.tq + (long long)qi * a.bq + 64 * sub;
  const int wg = threadIdx.x / 128;
  const bool loader = threadIdx.x == 128;
  // the loader's walk: live cell lf, stage lj of the cell, into ring slot
  // lstage
  int lf = f0, lj = 0, lstage = 0;
  uint32_t lphase = 0;
  auto skip_dead = [&]() {
    while (lf < f0 + a.bpc && !cell_live(a, qi, lf)) ++lf;
  };
  auto load_next = [&]() {
    const uint32_t bar = full + 8 * lstage;
    mbar_wait(empty + 8 * lstage, lphase ^ 1);
    const uint32_t st = ring_u + lstage * G::kStageBytes;
    const int phys = p.kv_map ? p.kv_map[lf] : lf;
    const int row = hk * a.tk + phys * a.bk;
    if (lj < NS) {   // columns 32 lj .. of k, kv tile t at 2 t panels
      mbar_expect_tx(bar, nsub * PN);
      for (int t = 0; t < nsub; ++t)
        tma_load_2d(st + 2 * PN * t, &maps.k, bar, 32 * lj, row + 64 * t);
    } else {   // warpgroup w's accᵀ tile j over kv tile t: 64 columns of v
      const int j = (lj - NS) / nsub, t = (lj - NS) % nsub;
      int parts = 0;
      for (int w = 0; w < 2; ++w) parts += G::kOwn * w + j < G::kMT;
      mbar_expect_tx(bar, parts * 2 * PN);
      for (int w = 0; w < 2; ++w) {
        const int mt = G::kOwn * w + j;
        if (mt >= G::kMT) continue;
        tma_load_2d(st + 2 * PN * w, &maps.v, bar, 64 * mt, row + 64 * t);
        tma_load_2d(st + 2 * PN * w + PN, &maps.v, bar, 64 * mt + 32,
                    row + 64 * t);
      }
    }
    if (++lstage == G::kStages) {
      lstage = 0;
      lphase ^= 1;
    }
    if (++lj == nj) {
      lj = 0;
      ++lf;
      skip_dead();
    }
  };
  if (loader) {
    mbar_expect_tx(qbar, G::kQBytes);
    for (int pn = 0; pn < D / 32; ++pn)
      tma_load_2d(q_u + pn * PN, &maps.q, qbar, 32 * pn, (int)qrow0);
    skip_dead();
    for (int k = 0; k < G::kStages && lf < f0 + a.bpc; ++k) load_next();
  }

  const int tid = threadIdx.x % 128, quad = tid % 4;
  float acc[G::kOwn][32];   // the carry: this warpgroup's accᵀ tiles
#pragma unroll
  for (int j = 0; j < G::kOwn; ++j)
#pragma unroll
    for (int x = 0; x < 32; ++x) acc[j][x] = 0.f;
  // the carry's (m, l) of the thread's rows, and their positions
  float m_c[2] = {kNegInf, kNegInf}, l_c[2] = {0.f, 0.f};
  long long qpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    qpos[i] = (long long)qi * a.pos_bq + 64 * sub + tile_row(tid, i);
  const float inv_cap = a.has_softcap ? recip(a.softcap) : 0.f;
  const bool scores = wg < nsub;   // this warpgroup forms s of kv tile wg
  int count = 0, stage = 0;
  uint32_t phase = 0;
  auto release = [&]() {   // the current stage is read: refill, move on
    mbar_arrive(empty + 8 * stage);
    if (++stage == G::kStages) {
      stage = 0;
      phase ^= 1;
    }
    if (loader && lf < f0 + a.bpc) load_next();   // kStages ahead
  };
  mbar_wait(qbar, 0);
  __syncwarp();
  for (int f = f0; f < f0 + a.bpc; ++f) {
    if (!cell_live(a, qi, f)) continue;
    ++count;
    // s = q·kᵀ over kv tile wg, 32 columns of d a stage
    float s[32];
#pragma unroll 1
    for (int j = 0; j < NS; ++j) {
      mbar_wait(full + 8 * stage, phase);
      __syncwarp();
      if (scores) {
        const uint32_t b = ring_u + stage * G::kStageBytes + 2 * PN * wg;
        split_tile(b, b + PN, PN, tid);
        fence_async();
        wg_sync(wg);
        float part[32];   // the stage's 4 k-steps, from zero
        tf32_mma<4, PN, false, PN>(part, q_u, 32 * j, b, b + PN, tid, true);
#pragma unroll
        for (int x = 0; x < 32; ++x)
          s[x] = j == 0 ? part[x] : __fadd_rn(s[x], part[x]);
      }
      release();
    }
    // the mask and softcapped logits; the cell's row max m_e from both
    // tiles' shares
    int2 live[2];
    float m_e[2] = {kNegInf, kNegInf};
    if (scores) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
        live[i] = live_cols(a, qpos[i], (long long)f * a.pos_bk + 64 * wg,
                            64);
      mask_logits(a, s, 2 * quad, live, inv_cap, m_e);
      row_max(m_e);
      if (quad == 0) {
#pragma unroll
        for (int i = 0; i < 2; ++i) m_part[64 * wg + tile_row(tid, i)] = m_e[i];
      }
    }
    bar_sync(3, 256);   // both tiles' partial max are written
    float a1[2], a2[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = tile_row(tid, i);
      m_e[i] = nsub > 1 ? fmaxf(m_part[r], m_part[64 + r]) : m_part[r];
      // the combine's scales: carry (m_c, l_c) the earlier operand
      const float mn = fmaxf(m_c[i], m_e[i]);
      a1[i] = expf(m_c[i] - mn);
      a2[i] = expf(m_e[i] - mn);
      m_c[i] = mn;
    }
    if (wg == 0 && quad == 0) {   // the scales by q row, for accᵀ's columns
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = tile_row(tid, i);
        asm volatile("st.shared.f32 [%0], %1;" ::"r"(sc1 + 4 * r), "f"(a1[i])
                     : "memory");
        asm volatile("st.shared.f32 [%0], %1;" ::"r"(sc2 + 4 * r), "f"(a2[i])
                     : "memory");
      }
    }
    if (scores) {
      // p = exp(s - m_e) (a masked entry is zeroed, not left to underflow:
      // in a fully masked row m_e = NEG_INF and exp(s - m_e) would be 1)
      // into the p tiles as hi and lo, kv tile wg's two panels; its row
      // sums
      float l_e[2] = {0.f, 0.f};
      const uint32_t ph = p_hi + 2 * PN * wg, pl = p_lo + 2 * PN * wg;
#pragma unroll
      for (int x = 0; x < 32; x += 2) {
        const int i = (x >> 1) & 1, c = 8 * (x >> 2) + 2 * quad;
        const float p0 =
            c >= live[i].x && c < live[i].y ? expf(s[x] - m_e[i]) : 0.f;
        const float p1 = c + 1 >= live[i].x && c + 1 < live[i].y
                             ? expf(s[x + 1] - m_e[i]) : 0.f;
        l_e[i] = __fadd_rn(__fadd_rn(l_e[i], p0), p1);
        store_split(ph + (x >> 4) * PN, pl + (x >> 4) * PN, x & 15, tid, p0,
                    p1);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l_e[i] = __fadd_rn(l_e[i], __shfl_xor_sync(0xffffffffu, l_e[i], 1));
        l_e[i] = __fadd_rn(l_e[i], __shfl_xor_sync(0xffffffffu, l_e[i], 2));
        if (quad == 0) l_part[64 * wg + tile_row(tid, i)] = l_e[i];
      }
      fence_async();
    }
    bar_sync(4, 256);   // p, the partial sums and the scales are written
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = tile_row(tid, i);
      const float l_e = nsub > 1 ? __fadd_rn(l_part[r], l_part[64 + r])
                                 : l_part[r];
      l_c[i] = __fadd_rn(__fmul_rn(l_c[i], a1[i]), __fmul_rn(l_e, a2[i]));
    }
    // this warpgroup's accᵀ tiles: the element accᵀ_e = vᵀ·pᵀ from zero
    // over the cell's kv tiles, a stage each, 8 kProductSteps kv rows a
    // chain, then acc = acc·a1 + accᵀ_e·a2, the scales by q column
#pragma unroll
    for (int j = 0; j < G::kOwn; ++j) {
      const bool own = G::kOwn * wg + j < G::kMT;
      float e[32];
      for (int t = 0; t < nsub; ++t) {
        mbar_wait(full + 8 * stage, phase);
        __syncwarp();
        if (own) {
          constexpr int KC = G::kProductSteps;
#pragma unroll
          for (int c = 0; c < 8 / KC; ++c) {
            float part[32];
            // kv rows 8 KC c .. of the tile: p's panel and k-step there
            const uint32_t off = (2 * t + KC * c / 4) * PN + 32 * (KC * c % 4);
            tf32_mma<KC, PN, true, PN, KC == 1 ? 1 : 2>(
                part, ring_u + stage * G::kStageBytes + 2 * PN * wg,
                8 * KC * c, p_hi + off, p_lo + off, tid, true);
#pragma unroll
            for (int x = 0; x < 32; ++x)
              e[x] = t == 0 && c == 0 ? part[x] : __fadd_rn(e[x], part[x]);
          }
        }
        release();
      }
      if (own) {
#pragma unroll
        for (int x = 0; x < 32; x += 2) {
          const int c = 8 * (x >> 2) + 2 * quad;   // q rows c, c + 1
          const float2 s1 = ld_f32x2(sc1 + 4 * c), s2 = ld_f32x2(sc2 + 4 * c);
          acc[j][x] = __fadd_rn(__fmul_rn(acc[j][x], s1.x),
                                __fmul_rn(e[x], s2.x));
          acc[j][x + 1] = __fadd_rn(__fmul_rn(acc[j][x + 1], s1.y),
                                    __fmul_rn(e[x + 1], s2.y));
        }
      }
    }
  }

  // the finalize's 1 / l by q row (l == 0 marks a fully masked row, or an
  // empty fold: acc is 0 there)
  __syncthreads();   // every read of the scales is done
  if (!p.c0 && wg == 0 && quad == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      asm volatile("st.shared.f32 [%0], %1;" ::"r"(sc1 + 4 * tile_row(tid, i)),
                   "f"(recip(l_c[i] == 0.f ? 1.f : l_c[i]))
                   : "memory");
  }
  __syncthreads();
  const long long crow0 =
      (((long long)h * a.nq + qi) * a.splits + blockIdx.y) * a.bq + 64 * sub;
  // entry x of tile j: d column 64 (kOwn wg + j) + tile_row(tid, i), q
  // row 8 (x >> 2) + 2 quad + (x & 1) of the block's 64
#pragma unroll
  for (int j = 0; j < G::kOwn; ++j) {
    const int mt = G::kOwn * wg + j;
    if (mt >= G::kMT) continue;
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const int col = 64 * mt + tile_row(tid, (x >> 1) & 1);
      const int r = 8 * (x >> 2) + 2 * quad + (x & 1);
      if (p.c0)   // split pass: publish the chunk's acc
        p.c2[(crow0 + r) * D + col] = acc[j][x];
      else
        static_cast<float*>(p.out0)[(qrow0 + r) * D + col] =
            acc[j][x] * ld_f32(sc1 + 4 * r);
    }
  }
  if (wg == 0 && quad == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = tile_row(tid, i);
      if (p.c0) {   // ... and its (m, l)
        p.c0[crow0 + r] = m_c[i];
        p.c1[crow0 + r] = l_c[i];
      } else if (p.m_out) {
        p.m_out[qrow0 + r] = m_c[i];
        p.l_out[qrow0 + r] = l_c[i];
      }
    }
  }
  if (!p.c0 && p.counts && sub == 0 && wg == 0 && tid == 0)
    p.counts[(long long)h * a.nq + qi] = count;
}

// -- backward dq (softmax_bwd_dq) ---------------------------------------------

template <int D>
struct DqTiles {
  static constexpr int kPanels = D / 64;
  static constexpr int kTileBytes = kPanels * kPanelBytes;  // 64 rows x D
  // dq columns a warpgroup owns: both own half of d >= 128; at d = 64 the
  // first owns all 64 (a 32-column MN-major operand has no 128-byte
  // swizzle atom)
  static constexpr int kDC = D < 128 ? 64 : D / 2;
  static constexpr int kParts = D / kDC;
  // the ring of 64-row k / v tiles: a cell (bk = 128) takes four
  static constexpr int kSlots = D == 256 ? 4 : 8;
  // p·g, then ds, as hi (two 64-column panels) and lo
  static constexpr int kPBytes = 4 * kPanelBytes;
  // two consumer warpgroups; thread 0 also issues the loads (a producer
  // warp or warpgroup would leave a thread 168 registers, and the d = 256
  // form spilled)
  static constexpr int kThreads = 256;
  static constexpr int kSmem = 1024 + 2 * kTileBytes + kPBytes +
                               kSlots * kTileBytes + 8 * (2 * kSlots + 1);
};

// Block (q head h, q block qi, 64-row q tile sub), split y; folds the KV
// blocks as attn_fold.cu's fold_dq_kernel does. The q and dO tiles stay in
// shared memory; each live cell's v tiles, then its k tiles, stream
// through the ring. Warpgroup 0 forms s = q·kᵀ and p·g (p = exp(s - m) / l,
// g = tanh' under softcap, else 1) into the panels as hi + lo; warpgroup 1
// forms dp = dO·vᵀ and overwrites the panels with ds = p·g (dp - delta);
// then each warpgroup that owns dq columns forms its columns of the cell's
// dq_e = ds·k from zero (ds as hi + lo) and folds it into its carry,
// dq = dq + scale·dq_e. Thread 0 issues the loads: before the fold, then,
// without waiting, into the v slots warpgroup 1 has released, and at each
// cell's end, waiting where it must, every tile of the next live cell (it
// would wait there anyway: warpgroup 1 releases the k slots as it starts
// the next cell).
// Named barriers: 1 + wg within a warpgroup, 3 "p·g is written", 4 "ds
// is written", 5 "the last cell's ds is read".
template <int D>
__global__ void __launch_bounds__(256, 1)
    fold_dq_tc_kernel(const __grid_constant__ TcMaps maps, FoldArgs a,
                      FoldPtrs p) {
  using G = DqTiles<D>;
  constexpr int DC = G::kDC;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_u = smem_u32(align1024(smem_raw));
  const uint32_t do_u = q_u + G::kTileBytes;
  const uint32_t g_hi = do_u + G::kTileBytes, g_lo = g_hi + 2 * kPanelBytes;
  const uint32_t ring_u = g_hi + G::kPBytes;
  // mbarriers: full[kSlots], empty[kSlots], then the q and dO tiles'
  const uint32_t full = ring_u + G::kSlots * G::kTileBytes;
  const uint32_t empty = full + 8 * G::kSlots, qbar = empty + 8 * G::kSlots;

  const int nt = a.bq / 64;   // 64-row tiles of a q block
  const int sub = blockIdx.x % nt;
  const int qi = (blockIdx.x / nt) % a.nq;
  const int h = blockIdx.x / nt / a.nq;
  const int hk = h / a.group;
  const int nsub = a.bk / 64;
  const int f0 = blockIdx.y * a.bpc;
  const long long qrow0 = (long long)h * a.tq + (long long)qi * a.bq + 64 * sub;
  if (threadIdx.x == 0) {
    for (int s = 0; s < G::kSlots; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 256);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  {  // both warpgroups consume; thread 0 also issues the loads
    const int tid = threadIdx.x % 128, quad = tid % 4;
    const bool owns = wg < G::kParts;   // owns dq columns DC wg ..
    float acc[DC / 2];
#pragma unroll
    for (int x = 0; x < DC / 2; ++x) acc[x] = 0.f;
    const float inv_cap = a.has_softcap ? recip(a.softcap) : 0.f;
    // the thread's rows: position, and the forward's m, 1 / l (l == 0
    // marks a fully masked row: 1), delta
    long long qpos[2];
    float m_r[2], il_r[2], dl_r[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const long long g = qrow0 + tile_row(tid, i);
      qpos[i] = (long long)qi * a.pos_bq + 64 * sub + tile_row(tid, i);
      m_r[i] = p.m[g];
      const float l = p.l[g];
      il_r[i] = recip(l == 0.f ? 1.f : l);
      dl_r[i] = p.delta[g];
    }
    int count = 0, slot = 0, cells = 0;
    uint32_t phase = 0;
    // tile j of the cell (its v tiles, then its k tiles): slot and parity
    auto at = [&](int j, uint32_t& ph) {
      int s = slot + j;
      ph = phase;
      if (s >= G::kSlots) {
        s -= G::kSlots;
        ph ^= 1;
      }
      return s;
    };
    // the loader's walk over the live cells' tiles: cell lf, tile lj (its
    // v tiles, then its k tiles), into ring slot lslot
    const bool loader = threadIdx.x == 0;
    int lf = f0, lj = 0, lslot = 0;
    uint32_t lphase = 0;
    auto skip_dead = [&]() {
      while (lf < f0 + a.bpc && !cell_live(a, qi, lf)) ++lf;
    };
    auto load_one = [&]() {
      mbar_wait(empty + 8 * lslot, lphase ^ 1);
      mbar_expect_tx(full + 8 * lslot, G::kTileBytes);
      const int phys = p.kv_map ? p.kv_map[lf] : lf;
      const int row = hk * a.tk + phys * a.bk + 64 * (lj % nsub);
      const uint32_t dst = ring_u + lslot * G::kTileBytes;
      for (int pn = 0; pn < G::kPanels; ++pn)
        tma_load_2d(dst + pn * kPanelBytes, lj < nsub ? &maps.v : &maps.k,
                    full + 8 * lslot, 64 * pn, row);
      if (++lslot == G::kSlots) {
        lslot = 0;
        lphase ^= 1;
      }
      if (++lj == 2 * nsub) {
        lj = 0;
        ++lf;
        skip_dead();
      }
    };
    // every tile of the cells up to `through`, waiting for their slots,
    // then those of later cells whose slots are free already
    auto pump = [&](int through) {
      while (lf < f0 + a.bpc &&
             (lf <= through || mbar_ready(empty + 8 * lslot, lphase ^ 1)))
        load_one();
    };
    if (loader) {
      mbar_expect_tx(qbar, 2 * G::kTileBytes);
      for (int pn = 0; pn < G::kPanels; ++pn) {
        tma_load_2d(q_u + pn * kPanelBytes, &maps.q, qbar, 64 * pn,
                    (int)qrow0);
        tma_load_2d(do_u + pn * kPanelBytes, &maps.dout, qbar, 64 * pn,
                    (int)qrow0);
      }
      skip_dead();
      pump(lf);
    }
    mbar_wait(qbar, 0);
    __syncwarp();
    for (int f = f0; f < f0 + a.bpc; ++f) {
      if (!cell_live(a, qi, f)) continue;
      ++count;
      // the tiles' addresses afresh each cell, so that the wgmma
      // descriptors are formed where they are used, not held in registers
      // across the fold
      uint32_t qb = q_u, db = do_u, gh = g_hi, rb = ring_u;
      asm volatile("" : "+r"(qb), "+r"(db), "+r"(gh), "+r"(rb));
      const uint32_t gl = gh + 2 * kPanelBytes;
      uint32_t ph;
      if (wg == 0) {
        if (cells > 0) bar_sync(5, 256);   // the last cell's ds is read
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          if (t >= nsub) break;
          const int ks = at(nsub + t, ph);
          mbar_wait(full + 8 * ks, ph);
          __syncwarp();
          const uint32_t kt = rb + ks * G::kTileBytes;
          float s[32];
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)
            wgmma_n64(s, kmajor_desc(qb, kk), kmajor_desc(kt, kk), kk > 0);
          wg_commit();
          wg_wait();
          keep(s);
          // p·g on the live entries; a masked entry is 0, not left to
          // underflow (a fully masked row has m = NEG_INF)
          int2 live[2];
#pragma unroll
          for (int i = 0; i < 2; ++i)
            live[i] = live_cols(a, qpos[i], (long long)f * a.pos_bk + 64 * t,
                                64);
#pragma unroll
          for (int x = 0; x < 32; x += 2) {
            const int i = (x >> 1) & 1, c = 8 * (x >> 2) + 2 * quad;
            float pg[2];
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const bool ok = c + u >= live[i].x && c + u < live[i].y;
              const float sv = logit_tc(a, s[x + u], inv_cap);
              pg[u] = ok ? expf(sv - m_r[i]) * il_r[i] : 0.f;
              if (a.has_softcap) {   // tanh' = 1 - (s / cap)^2
                const float tc = sv * inv_cap;
                pg[u] = pg[u] * __fsub_rn(1.f, __fmul_rn(tc, tc));
              }
            }
            store_pair(gh + t * kPanelBytes, gl + t * kPanelBytes, x, tid,
                       pg[0], pg[1]);
          }
        }
        bar_arrive(3, 256);   // p·g is written
        bar_sync(4, 256);     // ds is written (warpgroup 1 has read v)
        for (int t = 0; t < nsub; ++t) mbar_arrive(empty + 8 * at(t, ph));
        if (loader) pump(-1);   // the next tiles, into the v slots now free
      } else {
        if (cells > 0) bar_arrive(5, 256);
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          if (t >= nsub) break;
          const int vs = at(t, ph);
          mbar_wait(full + 8 * vs, ph);
          __syncwarp();
          const uint32_t vt = rb + vs * G::kTileBytes;
          float dp[32];
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)
            wgmma_n64(dp, kmajor_desc(db, kk), kmajor_desc(vt, kk), kk > 0);
          wg_commit();
          wg_wait();
          keep(dp);
          mbar_arrive(empty + 8 * vs);
          if (t == 0) bar_sync(3, 256);   // p·g is written
          // ds = p·g (dp - delta), over the p·g warpgroup 0 wrote
#pragma unroll
          for (int x = 0; x < 32; x += 2) {
            const int i = (x >> 1) & 1;
            const float2 pg = load_pair(gh + t * kPanelBytes,
                                        gl + t * kPanelBytes, x, tid);
            store_pair(gh + t * kPanelBytes, gl + t * kPanelBytes, x, tid,
                       __fmul_rn(pg.x, __fsub_rn(dp[x], dl_r[i])),
                       __fmul_rn(pg.y, __fsub_rn(dp[x + 1], dl_r[i])));
          }
        }
        fence_async();
        bar_arrive(4, 256);   // ds is written
        wg_sync(wg);          // and visible to this warpgroup's wgmma
      }
      if (owns) {
        // the cell's dq_e = ds·k for columns DC wg .., 64 at a time, each
        // from zero over the cell's kv rows, then dq = dq + scale·dq_e
        for (int t = 0; t < nsub; ++t) {
          const int ks = at(nsub + t, ph);
          mbar_wait(full + 8 * ks, ph);
        }
#pragma unroll
        for (int c = 0; c < DC / 64; ++c) {
          float e[32];
          wg_fence();
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            if (t < nsub) {
              const uint32_t kt = rb + at(nsub + t, ph) * G::kTileBytes;
#pragma unroll
              for (int kk = 0; kk < 4; ++kk) {
                const uint64_t bd = mnmajor_desc(kt, kk, wg * DC / 64 + c);
                wgmma_n64_mn(e, kmajor_desc(gh, 4 * t + kk), bd,
                             (t | kk) != 0);
                wgmma_n64_mn(e, kmajor_desc(gl, 4 * t + kk), bd, 1);
              }
            }
          }
          wg_commit();
          wg_wait();
          keep(e);
#pragma unroll
          for (int x = 0; x < 32; ++x)
            acc[32 * c + x] =
                __fadd_rn(acc[32 * c + x], __fmul_rn(e[x], a.scale));
        }
      }
      for (int t = 0; t < nsub; ++t)
        mbar_arrive(empty + 8 * at(nsub + t, ph));
      for (int t = 0; t < 2 * nsub; ++t)
        if (++slot == G::kSlots) {
          slot = 0;
          phase ^= 1;
        }
      ++cells;
      if (loader) {   // every tile of the next live cell is in flight
        int next = f + 1;
        while (next < f0 + a.bpc && !cell_live(a, qi, next)) ++next;
        pump(next);
      }
    }

    if (owns) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = 64 * sub + tile_row(tid, i);   // row of the q block
        const int col = DC * wg + 2 * quad;
        if (p.c0) {  // split pass: publish the chunk's dq
          float* dst =
              p.c0 + ((((long long)h * a.nq + qi) * a.splits + blockIdx.y) *
                          a.bq + r) * D + col;
#pragma unroll
          for (int j = 0; j < DC / 8; ++j)
            *reinterpret_cast<float2*>(dst + 8 * j) =
                make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
        } else {
          __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(p.out0) +
                               (qrow0 + tile_row(tid, i)) * D + col;
#pragma unroll
          for (int j = 0; j < DC / 8; ++j)
            *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
                __floats2bfloat162_rn(acc[4 * j + 2 * i],
                                      acc[4 * j + 2 * i + 1]);
        }
      }
    }
    if (!p.c0 && p.counts && sub == 0 && wg == 0 && tid == 0)
      p.counts[(long long)h * a.nq + qi] = count;
  }
}

// -- launchers ----------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, without linking libcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A tensor map of `type` with 128-byte boxes along the innermost dim
// (128-byte swizzle) over `rank` dims, innermost first; strides in bytes of
// dims 1...
bool tile_map(CUtensorMap* map, CUtensorMapDataType type, const void* base,
              int rank, const cuuint64_t* dims, const cuuint64_t* strides,
              const cuuint32_t* box) {
  const EncodeTiled enc = encode_tiled();
  const cuuint32_t unit[3] = {1, 1, 1};
  return enc != nullptr &&
         enc(map, type, rank, const_cast<void*>(base), dims, strides, box,
             unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A bf16 tensor map with 64-column boxes (128 bytes).
bool bf16_map(CUtensorMap* map, const void* base, int rank,
              const cuuint64_t* dims, const cuuint64_t* strides,
              const cuuint32_t* box) {
  return tile_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, rank, dims,
                  strides, box);
}

// (rows, d) float32 row-major as boxes of 32 columns (128 bytes) x
// box_rows rows.
bool f32_rows_map(CUtensorMap* map, const void* base, int d, long long rows,
                  int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)d * 4};
  const cuuint32_t box[2] = {32, (cuuint32_t)box_rows};
  return tile_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, base, 2, dims,
                  strides, box);
}

// (rows, d) row-major as boxes of 64 rows.
bool rows_map(CUtensorMap* map, const void* base, int d, long long rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)d * 2};
  const cuuint32_t box[2] = {64, 64};
  return bf16_map(map, base, 2, dims, strides, box);
}

// (heads, t, d) as boxes of `box_heads` heads x `box_rows` rows: one box
// is a 64-row tile of the forward's q (box_rows x box_heads = 64).
bool heads_map(CUtensorMap* map, const void* base, int d, int t, int heads,
               int box_rows, int box_heads) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)t, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)t * d * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, (cuuint32_t)box_heads};
  return bf16_map(map, base, 3, dims, strides, box);
}

template <typename K>
cudaError_t launch(K kern, dim3 grid, int threads, int smem,
                   cudaStream_t stream, const TcMaps& maps, const FoldArgs& a,
                   const FoldPtrs& p) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, threads, smem, stream>>>(maps, a, p);
  return cudaGetLastError();
}

template <int D, int NWG>
cudaError_t run_fwd(const FoldArgs& a, const FoldPtrs& p, int smem,
                    cudaStream_t st) {
  using G = FwdTiles<D, NWG>;
  if (smem != G::kSmem) return cudaErrorInvalidValue;
  TcMaps maps;
  memset(&maps, 0, sizeof maps);
  const int rows = a.bq < 64 ? a.bq : 64;
  if (encode_tiled() == nullptr) return cudaErrorNotSupported;
  if (!heads_map(&maps.q, p.q, D, a.tq, a.bh, rows, 64 / rows) ||
      !rows_map(&maps.k, p.k, D, (long long)a.bh_kv * a.tk) ||
      !rows_map(&maps.v, p.v, D, (long long)a.bh_kv * a.tk))
    return cudaErrorInvalidPitchValue;
  const int nb = (a.group * a.bq + 63) / 64 / NWG;
  return launch(fold_fwd_tc_kernel<D, NWG>,
                dim3((unsigned)(a.bh_kv * a.nq * nb), (unsigned)a.splits),
                G::kThreads, G::kSmem, st, maps, a, p);
}

template <int D>
cudaError_t run_dkv(const FoldArgs& a, const FoldPtrs& p, int smem,
                    cudaStream_t st) {
  using G = DkvTiles<D>;
  if (smem != G::kSmem) return cudaErrorInvalidValue;
  TcMaps maps;
  memset(&maps, 0, sizeof maps);
  if (encode_tiled() == nullptr) return cudaErrorNotSupported;
  const long long q_rows = (long long)a.bh * a.tq;
  const long long kv_rows = (long long)a.bh_kv * a.tk;
  if (!rows_map(&maps.q, p.q, D, q_rows) ||
      !rows_map(&maps.dout, p.dout, D, q_rows) ||
      !rows_map(&maps.k, p.k, D, kv_rows) ||
      !rows_map(&maps.v, p.v, D, kv_rows))
    return cudaErrorInvalidPitchValue;
  return launch(fold_dkv_tc_kernel<D>,
                dim3((unsigned)(a.bh_kv * a.nk * (a.bk / 64) * (D / G::kDC)),
                     (unsigned)a.splits),
                G::kThreads, G::kSmem, st, maps, a, p);
}

template <int D>
cudaError_t run_dkv_tf32(const FoldArgs& a, const FoldPtrs& p, int smem,
                         cudaStream_t st) {
  using G = Tf32DkvTiles<D>;
  if (smem != G::kSmem) return cudaErrorInvalidValue;
  TcMaps maps;
  memset(&maps, 0, sizeof maps);
  if (encode_tiled() == nullptr) return cudaErrorNotSupported;
  const long long q_rows = (long long)a.bh * a.tq;
  const long long kv_rows = (long long)a.bh_kv * a.tk;
  if (!f32_rows_map(&maps.q, p.q, D, q_rows, G::kRows) ||
      !f32_rows_map(&maps.dout, p.dout, D, q_rows, G::kRows) ||
      !f32_rows_map(&maps.k, p.k, D, kv_rows, 64) ||
      !f32_rows_map(&maps.v, p.v, D, kv_rows, 64))
    return cudaErrorInvalidPitchValue;
  return launch(fold_dkv_tf32_kernel<D>,
                dim3((unsigned)(a.bh_kv * a.nk * (a.bk / 64)),
                     (unsigned)a.splits),
                G::kThreads, G::kSmem, st, maps, a, p);
}

template <int D>
cudaError_t run_dq_tf32(const FoldArgs& a, const FoldPtrs& p, int smem,
                        cudaStream_t st) {
  using G = Tf32DqTiles<D>;
  if (smem != G::kSmem) return cudaErrorInvalidValue;
  TcMaps maps;
  memset(&maps, 0, sizeof maps);
  if (encode_tiled() == nullptr) return cudaErrorNotSupported;
  const long long q_rows = (long long)a.bh * a.tq;
  const long long kv_rows = (long long)a.bh_kv * a.tk;
  if (!f32_rows_map(&maps.q, p.q, D, q_rows, 64) ||
      !f32_rows_map(&maps.dout, p.dout, D, q_rows, 64) ||
      !f32_rows_map(&maps.k, p.k, D, kv_rows, 64) ||
      !f32_rows_map(&maps.v, p.v, D, kv_rows, 64))
    return cudaErrorInvalidPitchValue;
  return launch(fold_dq_tf32_kernel<D>,
                dim3((unsigned)(a.bh * a.nq * (a.bq / 64)),
                     (unsigned)a.splits),
                G::kThreads, G::kSmem, st, maps, a, p);
}

template <int D>
cudaError_t run_fwd_tf32(const FoldArgs& a, const FoldPtrs& p, int smem,
                         cudaStream_t st) {
  using G = Tf32FwdTiles<D>;
  if (smem != G::kSmem) return cudaErrorInvalidValue;
  TcMaps maps;
  memset(&maps, 0, sizeof maps);
  if (encode_tiled() == nullptr) return cudaErrorNotSupported;
  const long long q_rows = (long long)a.bh * a.tq;
  const long long kv_rows = (long long)a.bh_kv * a.tk;
  if (!f32_rows_map(&maps.q, p.q, D, q_rows, 64) ||
      !f32_rows_map(&maps.k, p.k, D, kv_rows, 64) ||
      !f32_rows_map(&maps.v, p.v, D, kv_rows, 64))
    return cudaErrorInvalidPitchValue;
  return launch(fold_fwd_tf32_kernel<D>,
                dim3((unsigned)(a.bh * a.nq * (a.bq / 64)),
                     (unsigned)a.splits),
                G::kThreads, G::kSmem, st, maps, a, p);
}

template <int D>
cudaError_t run_dq(const FoldArgs& a, const FoldPtrs& p, int smem,
                   cudaStream_t st) {
  using G = DqTiles<D>;
  if (smem != G::kSmem) return cudaErrorInvalidValue;
  TcMaps maps;
  memset(&maps, 0, sizeof maps);
  if (encode_tiled() == nullptr) return cudaErrorNotSupported;
  const long long q_rows = (long long)a.bh * a.tq;
  const long long kv_rows = (long long)a.bh_kv * a.tk;
  if (!rows_map(&maps.q, p.q, D, q_rows) ||
      !rows_map(&maps.dout, p.dout, D, q_rows) ||
      !rows_map(&maps.k, p.k, D, kv_rows) ||
      !rows_map(&maps.v, p.v, D, kv_rows))
    return cudaErrorInvalidPitchValue;
  return launch(fold_dq_tc_kernel<D>,
                dim3((unsigned)(a.bh * a.nq * (a.bq / 64)),
                     (unsigned)a.splits),
                G::kThreads, G::kSmem, st, maps, a, p);
}

}  // namespace

extern "C" {

// Forward fold (softmax_pair) on KVBlocks, bf16: p->c0 set, the split
// pass; else finalize into out0 (and m_out / l_out). Takes d in {64, 128,
// 256}, bk in {64, 128}, bq = 128 or bq in {8, 16, 32, 64}; two q tiles
// per block at bq = 128 and d <= 128, else one.
int attn_fold_fwd_tc(const FoldArgs* a, const FoldPtrs* p, int smem,
                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool bq_ok = a->bq == 128 || a->bq == 64 || a->bq == 32 ||
                     a->bq == 16 || a->bq == 8;
  if (!bq_ok || (a->bk != 64 && a->bk != 128)) return cudaErrorInvalidValue;
  const bool two = a->bq == 128;
  switch (a->d) {
    case 64:
      return two ? run_fwd<64, 2>(*a, *p, smem, st)
                 : run_fwd<64, 1>(*a, *p, smem, st);
    case 128:
      return two ? run_fwd<128, 2>(*a, *p, smem, st)
                 : run_fwd<128, 1>(*a, *p, smem, st);
    case 256:
      return run_fwd<256, 1>(*a, *p, smem, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// Forward fold (softmax_pair) on KVBlocks, float32 by 3xTF32
// (fold_fwd_tf32): p->c0 set, the split pass; else finalize into out0 (and
// m_out / l_out). Takes d in {64, 128, 256}, bk and bq in {64, 128}.
int attn_fold_fwd_tf32(const FoldArgs* a, const FoldPtrs* p, int smem,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((a->bq != 64 && a->bq != 128) || (a->bk != 64 && a->bk != 128))
    return cudaErrorInvalidValue;
  switch (a->d) {
    case 64:
      return run_fwd_tf32<64>(*a, *p, smem, st);
    case 128:
      return run_fwd_tf32<128>(*a, *p, smem, st);
    case 256:
      return run_fwd_tf32<256>(*a, *p, smem, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// Backward dk/dv fold on QBlocks, bf16: out0 = dk, out1 = dv, or the split
// pass into c0 (dk) and c1 (dv). Takes d in {64, 128, 256}, bk and bq in
// {64, 128}.
int attn_fold_dkv_tc(const FoldArgs* a, const FoldPtrs* p, int smem,
                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((a->bq != 64 && a->bq != 128) || (a->bk != 64 && a->bk != 128))
    return cudaErrorInvalidValue;
  switch (a->d) {
    case 64:
      return run_dkv<64>(*a, *p, smem, st);
    case 128:
      return run_dkv<128>(*a, *p, smem, st);
    case 256:
      return run_dkv<256>(*a, *p, smem, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// Backward dk/dv fold on QBlocks, float32 by 3xTF32 (fold_dkv_tf32):
// out0 = dk, out1 = dv, or the split pass into c0 (dk) and c1 (dv). Takes
// d in {64, 128, 256}, bk and bq in {64, 128}.
int attn_fold_dkv_tf32(const FoldArgs* a, const FoldPtrs* p, int smem,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((a->bq != 64 && a->bq != 128) || (a->bk != 64 && a->bk != 128))
    return cudaErrorInvalidValue;
  switch (a->d) {
    case 64:
      return run_dkv_tf32<64>(*a, *p, smem, st);
    case 128:
      return run_dkv_tf32<128>(*a, *p, smem, st);
    case 256:
      return run_dkv_tf32<256>(*a, *p, smem, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// Backward dq fold on KVBlocks, float32 by 3xTF32 (fold_dq_tf32): out0 =
// dq, or the split pass into c0. Takes d in {64, 128, 256}, bk and bq in
// {64, 128}.
int attn_fold_dq_tf32(const FoldArgs* a, const FoldPtrs* p, int smem,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((a->bq != 64 && a->bq != 128) || (a->bk != 64 && a->bk != 128))
    return cudaErrorInvalidValue;
  switch (a->d) {
    case 64:
      return run_dq_tf32<64>(*a, *p, smem, st);
    case 128:
      return run_dq_tf32<128>(*a, *p, smem, st);
    case 256:
      return run_dq_tf32<256>(*a, *p, smem, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// Backward dq fold on KVBlocks, bf16: out0 = dq, or the split pass into
// c0. Takes d in {64, 128, 256}, bk and bq in {64, 128}.
int attn_fold_dq_tc(const FoldArgs* a, const FoldPtrs* p, int smem,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((a->bq != 64 && a->bq != 128) || (a->bk != 64 && a->bk != 128))
    return cudaErrorInvalidValue;
  switch (a->d) {
    case 64:
      return run_dq<64>(*a, *p, smem, st);
    case 128:
      return run_dq<128>(*a, *p, smem, st);
    case 256:
      return run_dq<256>(*a, *p, smem, st);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* attn_tc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
