// Attention-fold kernels of the scan engine, CUDA C++ for Hopper (sm_90a).
//
// Flash attention is a FOLD of a carried-payload monoid over blocks: each
// (q-block, kv-block) cell of the attention matrix yields one macro
// element, built by an input transform from the raw q/k/v tiles, and the
// elements are combined left to right along the folded axis. One fold
// loop is written here over three specs and two layouts (the counterparts
// of the reference's KernelSpec transforms and layouts):
//   fold_fwd_kernel   softmax_pair_kernel_spec (assoc.py:330) on KVBlocks:
//                     s = q·kᵀ·scale (softcapped), the causal / window /
//                     kv_len mask with the finite NEG_INF, the element
//                     (m, l, p·v) of the cell, the online-softmax combine
//                     (m, l, acc), and at the end acc / l with an l == 0
//                     guard and optionally the (m, l) statistics
//   fold_dq_kernel    softmax_pair_bwd_dq_kernel_spec (assoc.py:443) on
//                     KVBlocks: the recomputed p = exp(s - m) / l, dp =
//                     dO·vᵀ, ds = p (dp - delta) (· tanh' under softcap),
//                     dq += scale · ds·k
//   fold_dkv_kernel   softmax_pair_bwd_dkv_kernel_spec (assoc.py:486) on
//                     QBlocks: folded over the (group x q-block) axis of a
//                     KV block, dk += scale · dsᵀ·q, dv += pᵀ·dO (the GQA
//                     head sum is the fold itself: no atomics)
//   fold_chain_*      fold_chain (schedules.py:631) and the finalize: the
//                     split-KV chain over the chunks' published payloads,
//                     left to right from the identity: a warp a row for
//                     the softmax pair, a thread a (row, column) for the
//                     sums
// Each fold kernel runs both schedules of the reference's fold
// (kernels/scan_engine/schedules.py): with one split it is fold_carry
// (pallas_call at :722, body _fold_carry_body :677 and _fold_step :650)
// and writes the finalized outputs; with more it is the split pass of
// fold_decoupled (pallas_call at :778, body _fold_totals_body :744) and
// publishes its chunk's payload to the chain buffers.
//
// Bound. A cell costs 4·bq·bk·d flops forward (q·kᵀ and p·v) and 8·bq·bk·d
// in each backward fold (dq: dO·vᵀ, q·kᵀ, ds·k; dk/dv: q·kᵀ, dO·vᵀ, dsᵀ·q,
// pᵀ·dO) against (2 bk d) elements of k and v, so at training and prefill
// shapes the fold is bound by operations (bq = 128: ~500 flops per byte
// of bf16 k/v, above the H100's ~295 at 989 TFLOP/s bf16 and 3.35 TB/s);
// a decode step (one live q row per head) is bound by reading the cache.
// This first kernel is plain SIMT: f32 products and accumulators on the
// CUDA cores (67 TFLOP/s f32 at most), the reference's own arithmetic
// (it casts every tile to f32), not the tensor cores (wgmma, TMA and fp8
// are later work). What the design does about the bound: a block keeps its
// q rows (and dO rows) in shared memory for the whole fold and each thread
// owns a register tile of the products (2 rows x 8 columns of s, 2 rows x
// d/16 columns of the payload), so each shared-memory load feeds more
// than one FMA. Tiles live in shared memory as f32 (bf16 inputs widen on
// load, exactly), rows padded by one word so no two threads of a warp hit
// one bank. The decode shape is not tuned: a block reads its kv head's
// tiles once per q head of the GQA group (the L2 usually absorbs the
// repeats) and pads the one q row to the layout's 8.
//
// Geometry. The layout's (bq, bk) cells stay the unit of liveness, of
// count_cells and of the element (m, l, acc) the combine sees, so the
// cell counts and the skipped cells are the reference's. A block takes
// BR = 32 of the bq rows (8 when bq < 32) on KVBlocks, and 32 of the bk
// rows on QBlocks (walking the q block in chunks of 32 rows); rows are
// independent in every product but the contraction, so a sub-tile of
// rows computes exactly its rows of the layout's cell. A cell's bk (<= 128)
// KV rows and d (<= 256) columns are whole in shared memory: at d = 256
// the forward takes 181 KB and dq 214 KB of the 227 KB a block may use.
//
// Association. The cell's element is computed first and then combined
// into the carry (the carry the EARLIER operand), as the reference's
// _fold_step does; the combine's products and sums are written with __fmul_rn /
// __fadd_rn so nvcc cannot contract them into FMAs. Combining the
// identity (NEG_INF, 0, 0) is then bitwise a no-op (exp(NEG_INF - m)
// underflows to exactly 0), which is why skipping a dead cell (kv_bounds)
// gives the same bits as folding it, and why a page-permuted pool read
// through kv_block_map gives the bits of the contiguous one. The dot
// products accumulate with FMAs in their own order, so kernel and plain
// version agree to rounding, not bitwise. expf and tanhf, never the fast
// intrinsics.
//
// Interface: plain C functions loaded with ctypes. Each takes the
// geometry (FoldArgs), the tensor pointers (FoldPtrs) and a dtype code
// (0 float32, 1 bfloat16), launches on the given stream, allocates
// nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_fold.cuh"   // FoldArgs, FoldPtrs, kNegInf, cell_live

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBK = 128;   // KV rows of a cell the KVBlocks kernels take
constexpr int kSub = 32;      // QBlocks: kv rows per block, q rows per chunk
constexpr int kPLD = kMaxBK + 1;
constexpr int kSLD = kSub + 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// assoc._attn_block_logits' mask at absolute (row, col).
__device__ __forceinline__ bool elem_live(const FoldArgs& a, long long row,
                                          long long col) {
  bool m = true;
  if (a.has_kv_len) m = col < a.kv_len;
  if (a.causal) m = m && col <= row;
  if (a.has_window) m = m && col > row - a.window;
  return m;
}

// The scaled, softcapped logit of a dot product.
__device__ __forceinline__ float logit(const FoldArgs& a, float dot) {
  float s = dot * a.scale;
  if (a.has_softcap) s = a.softcap * tanhf(s / a.softcap);
  return s;
}

// ds = p (dp - delta), times tanh' = 1 - (s / cap)^2 on the capped logit.
__device__ __forceinline__ float dlogit(const FoldArgs& a, float p, float dp,
                                        float delta, float s) {
  float ds = p * (dp - delta);
  if (a.has_softcap) {
    const float t = s / a.softcap;
    ds = ds * __fsub_rn(1.f, __fmul_rn(t, t));
  }
  return ds;
}

// c[i][j] += sum_{k < K} A[i*ai + k*ak] * B[j*bj + k*bk]: one thread's
// register tile of a product of two shared-memory tiles.
template <int M, int N>
__device__ __forceinline__ void mm(float (&c)[M][N], const float* A, int ai,
                                   int ak, const float* B, int bj, int bk,
                                   int K) {
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    float av[M], bv[N];
#pragma unroll
    for (int i = 0; i < M; ++i) av[i] = A[i * ai + k * ak];
#pragma unroll
    for (int j = 0; j < N; ++j) bv[j] = B[j * bj + k * bk];
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) c[i][j] = fmaf(av[i], bv[j], c[i][j]);
  }
}

template <int M, int N>
__device__ __forceinline__ void zero(float (&c)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) c[i][j] = 0.f;
}

// rows x DP f32 tile at dst (row stride ld) from rows row0.. of a (.., d)
// tensor; zero past `valid` rows and past column d.
template <int DP, typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src,
                                          long long row0, int rows, int valid,
                                          int d) {
  for (int e = threadIdx.x; e < rows * DP; e += kThreads) {
    const int r = e / DP, c = e % DP;
    float x = 0.f;
    if (r < valid && c < d) x = to_f32(src[(row0 + r) * d + c]);
    dst[r * ld + c] = x;
  }
}

// Reductions over the TX lanes of a row (TX = 16 or 32: within a warp).
template <int TX>
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = TX / 2; o > 0; o /= 2)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
template <int TX>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = TX / 2; o > 0; o /= 2)
    x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Thread tiling of the KVBlocks kernels: TY x TX threads, TM rows each
// (BR = TY * TM rows per block), SC columns of the cell's kMaxBK and DC
// of the head dim.
template <int TY, int DC>
struct Tiles {
  static constexpr int TX = kThreads / TY;
  static constexpr int TM = TY == 16 ? 2 : 1;
  static constexpr int BR = TY * TM;
  static constexpr int SC = kMaxBK / TX;
  static constexpr int DP = DC * TX;   // padded head dim
  static constexpr int LD = DP + 1;
};

// Forward fold over KV blocks (softmax_pair). Block (h, qi, sub), split y.
template <typename T, int TY, int DC>
__global__ void __launch_bounds__(kThreads, 1)
    fold_fwd_kernel(FoldArgs a, FoldPtrs p) {
  using G = Tiles<TY, DC>;
  constexpr int TX = G::TX, TM = G::TM, BR = G::BR, SC = G::SC, DP = G::DP,
                LD = G::LD;
  extern __shared__ float smem[];
  float* q_s = smem;                  // BR x LD
  float* kv_s = q_s + BR * LD;        // kMaxBK x LD: k, then v
  float* p_s = kv_s + kMaxBK * LD;    // BR x kPLD

  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int nsub = (a.bq + BR - 1) / BR;
  const int sub = blockIdx.x % nsub;
  const int qi = (blockIdx.x / nsub) % a.nq;
  const int h = blockIdx.x / nsub / a.nq;
  const int hk = h / a.group;
  const int r0 = sub * BR;
  const long long qrow = (long long)h * a.tq + (long long)qi * a.bq + r0;
  load_rows<DP>(q_s, LD, q, qrow, BR, a.bq - r0, a.d);

  float m_c[TM], l_c[TM], acc[TM][DC];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m_c[i] = kNegInf;
    l_c[i] = 0.f;
  }
  zero(acc);
  int count = 0;
  const int f0 = blockIdx.y * a.bpc;
  for (int f = f0; f < f0 + a.bpc; ++f) {
    if (!cell_live(a, qi, f)) continue;
    ++count;
    const int phys = p.kv_map ? p.kv_map[f] : f;
    const long long kvrow = (long long)hk * a.tk + (long long)phys * a.bk;
    __syncthreads();  // the last cell's readers of kv_s / p_s are done
    load_rows<DP>(kv_s, LD, k, kvrow, kMaxBK, a.bk, a.d);
    __syncthreads();
    float s[TM][SC];
    zero(s);
    mm(s, q_s + ty * LD, TY * LD, 1, kv_s + tx * LD, TX * LD, 1, a.d);
    float m_e[TM], l_e[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const long long row = (long long)qi * a.pos_bq + r0 + ty + i * TY;
      unsigned live = 0;   // bit j: entry (row, tx + j TX) is unmasked
      m_e[i] = kNegInf;
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        const int c = tx + j * TX;
        const bool ok = c < a.bk &&
                        elem_live(a, row, (long long)f * a.pos_bk + c);
        live |= (unsigned)ok << j;
        s[i][j] = ok ? logit(a, s[i][j]) : kNegInf;
        m_e[i] = fmaxf(m_e[i], s[i][j]);
      }
      m_e[i] = row_max<TX>(m_e[i]);
      l_e[i] = 0.f;
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        const int c = tx + j * TX;
        // a masked entry is zeroed, not left to underflow: in a fully
        // masked row m_e = NEG_INF and exp(s - m_e) would be 1
        const float pv = (live >> j) & 1u ? expf(s[i][j] - m_e[i]) : 0.f;
        l_e[i] = __fadd_rn(l_e[i], pv);
        p_s[(ty + i * TY) * kPLD + c] = pv;
      }
      l_e[i] = row_sum<TX>(l_e[i]);
    }
    __syncthreads();  // k is read, p is written
    load_rows<DP>(kv_s, LD, v, kvrow, kMaxBK, a.bk, a.d);
    __syncthreads();
    float acc_e[TM][DC];
    zero(acc_e);
    mm(acc_e, p_s + ty * kPLD, TY * kPLD, 1, kv_s + tx, TX, LD, a.bk);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float mn = fmaxf(m_c[i], m_e[i]);
      const float a1 = expf(m_c[i] - mn), a2 = expf(m_e[i] - mn);
      l_c[i] = __fadd_rn(__fmul_rn(l_c[i], a1), __fmul_rn(l_e[i], a2));
#pragma unroll
      for (int j = 0; j < DC; ++j)
        acc[i][j] = __fadd_rn(__fmul_rn(acc[i][j], a1),
                              __fmul_rn(acc_e[i][j], a2));
      m_c[i] = mn;
    }
  }

  const long long chain_row =
      ((long long)(h * a.nq + qi) * a.splits + blockIdx.y) * a.bq + r0;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = ty + i * TY;
    if (r0 + r >= a.bq) continue;
    if (p.c0) {  // split pass: publish the chunk's (m, l, acc)
      if (tx == 0) {
        p.c0[chain_row + r] = m_c[i];
        p.c1[chain_row + r] = l_c[i];
      }
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        const int c = tx + j * TX;
        if (c < a.d) p.c2[(chain_row + r) * a.d + c] = acc[i][j];
      }
      continue;
    }
    // l == 0 marks a fully masked row (or an empty fold): acc is 0 there
    const float safe = l_c[i] == 0.f ? 1.f : l_c[i];
    T* out = static_cast<T*>(p.out0);
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      const int c = tx + j * TX;
      if (c < a.d) store_as(out + (qrow + r) * a.d + c, acc[i][j] / safe);
    }
    if (p.m_out && tx == 0) {
      p.m_out[qrow + r] = m_c[i];
      p.l_out[qrow + r] = l_c[i];
    }
  }
  if (p.counts && sub == 0 && threadIdx.x == 0)
    p.counts[h * a.nq + qi] = count;
}

// Backward dq fold over KV blocks. Block (h, qi, sub), split y.
template <typename T, int TY, int DC>
__global__ void __launch_bounds__(kThreads, 1)
    fold_dq_kernel(FoldArgs a, FoldPtrs p) {
  using G = Tiles<TY, DC>;
  constexpr int TX = G::TX, TM = G::TM, BR = G::BR, SC = G::SC, DP = G::DP,
                LD = G::LD;
  extern __shared__ float smem[];
  float* q_s = smem;                  // BR x LD
  float* do_s = q_s + BR * LD;        // BR x LD
  float* kv_s = do_s + BR * LD;       // kMaxBK x LD: v, then k
  float* ds_s = kv_s + kMaxBK * LD;   // BR x kPLD

  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const T* dout = static_cast<const T*>(p.dout);
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int nsub = (a.bq + BR - 1) / BR;
  const int sub = blockIdx.x % nsub;
  const int qi = (blockIdx.x / nsub) % a.nq;
  const int h = blockIdx.x / nsub / a.nq;
  const int hk = h / a.group;
  const int r0 = sub * BR;
  const long long qrow = (long long)h * a.tq + (long long)qi * a.bq + r0;
  load_rows<DP>(q_s, LD, q, qrow, BR, a.bq - r0, a.d);
  load_rows<DP>(do_s, LD, dout, qrow, BR, a.bq - r0, a.d);

  // the forward's row statistics; rows past bq are dead (p = 0)
  float m_r[TM], sl_r[TM], dl_r[TM];
  bool row_ok[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = r0 + ty + i * TY;
    row_ok[i] = r < a.bq;
    const long long g = qrow + ty + i * TY;
    m_r[i] = row_ok[i] ? p.m[g] : 0.f;
    const float l = row_ok[i] ? p.l[g] : 0.f;
    sl_r[i] = l == 0.f ? 1.f : l;
    dl_r[i] = row_ok[i] ? p.delta[g] : 0.f;
  }
  float dq[TM][DC];
  zero(dq);
  int count = 0;
  const int f0 = blockIdx.y * a.bpc;
  for (int f = f0; f < f0 + a.bpc; ++f) {
    if (!cell_live(a, qi, f)) continue;
    ++count;
    const int phys = p.kv_map ? p.kv_map[f] : f;
    const long long kvrow = (long long)hk * a.tk + (long long)phys * a.bk;
    __syncthreads();
    load_rows<DP>(kv_s, LD, v, kvrow, kMaxBK, a.bk, a.d);
    __syncthreads();
    float dp[TM][SC];
    zero(dp);
    mm(dp, do_s + ty * LD, TY * LD, 1, kv_s + tx * LD, TX * LD, 1, a.d);
    __syncthreads();
    load_rows<DP>(kv_s, LD, k, kvrow, kMaxBK, a.bk, a.d);
    __syncthreads();
    float s[TM][SC];
    zero(s);
    mm(s, q_s + ty * LD, TY * LD, 1, kv_s + tx * LD, TX * LD, 1, a.d);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const long long row = (long long)qi * a.pos_bq + r0 + ty + i * TY;
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        const int c = tx + j * TX;
        const bool ok = row_ok[i] && c < a.bk &&
                        elem_live(a, row, (long long)f * a.pos_bk + c);
        const float sv = logit(a, s[i][j]);
        const float pv = (ok ? expf(sv - m_r[i]) : 0.f) / sl_r[i];
        ds_s[(ty + i * TY) * kPLD + c] = dlogit(a, pv, dp[i][j], dl_r[i], sv);
      }
    }
    __syncthreads();
    float dq_e[TM][DC];
    zero(dq_e);
    mm(dq_e, ds_s + ty * kPLD, TY * kPLD, 1, kv_s + tx, TX, LD, a.bk);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < DC; ++j)
        dq[i][j] = __fadd_rn(dq[i][j], __fmul_rn(dq_e[i][j], a.scale));
  }

  const long long chain_row =
      ((long long)(h * a.nq + qi) * a.splits + blockIdx.y) * a.bq + r0;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = ty + i * TY;
    if (!row_ok[i]) continue;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      const int c = tx + j * TX;
      if (c >= a.d) continue;
      if (p.c0)
        p.c0[(chain_row + r) * a.d + c] = dq[i][j];
      else
        store_as(static_cast<T*>(p.out0) + (qrow + r) * a.d + c, dq[i][j]);
    }
  }
  if (!p.c0 && p.counts && sub == 0 && threadIdx.x == 0)
    p.counts[h * a.nq + qi] = count;
}

// Backward dk/dv fold over the (group x q-block) axis (QBlocks). Block
// (hk, kv block j, sub of 32 kv rows), split y. 16 x 16 threads.
template <typename T, int DC>
__global__ void __launch_bounds__(kThreads, 1)
    fold_dkv_kernel(FoldArgs a, FoldPtrs p) {
  constexpr int TX = 16, TY = 16, DP = DC * TX, LD = DP + 1;
  extern __shared__ float smem[];
  float* k_s = smem;                   // kSub x LD (this block's kv rows)
  float* v_s = k_s + kSub * LD;
  float* q_s = v_s + kSub * LD;        // kSub x LD (a chunk of q rows)
  float* do_s = q_s + kSub * LD;
  float* p_s = do_s + kSub * LD;       // kSub (q) x kSLD (kv)
  float* ds_s = p_s + kSub * kSLD;
  float* st = ds_s + kSub * kSLD;      // m, safe l, delta of the chunk rows

  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const T* dout = static_cast<const T*>(p.dout);
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int nsub = (a.bk + kSub - 1) / kSub;
  const int sub = blockIdx.x % nsub;
  const int jb = (blockIdx.x / nsub) % a.nk;
  const int hk = blockIdx.x / nsub / a.nk;
  const int c0 = sub * kSub;
  const long long kvrow = (long long)hk * a.tk + (long long)jb * a.bk + c0;
  load_rows<DP>(k_s, LD, k, kvrow, kSub, a.bk - c0, a.d);
  load_rows<DP>(v_s, LD, v, kvrow, kSub, a.bk - c0, a.d);

  float dk[2][DC], dv[2][DC];
  zero(dk);
  zero(dv);
  int count = 0;
  const int f0 = blockIdx.y * a.bpc;
  for (int f = f0; f < f0 + a.bpc; ++f) {
    const int qi = f % a.nq;
    if (!cell_live(a, qi, jb)) continue;
    ++count;
    const int h = hk * a.group + f / a.nq;
    const long long qblk = (long long)h * a.tq + (long long)qi * a.bq;
    float dk_e[2][DC], dv_e[2][DC];
    zero(dk_e);
    zero(dv_e);
    for (int r0 = 0; r0 < a.bq; r0 += kSub) {
      __syncthreads();  // the last chunk's readers are done
      load_rows<DP>(q_s, LD, q, qblk + r0, kSub, a.bq - r0, a.d);
      load_rows<DP>(do_s, LD, dout, qblk + r0, kSub, a.bq - r0, a.d);
      if (threadIdx.x < kSub) {
        const int r = threadIdx.x;
        const bool ok = r0 + r < a.bq;
        const long long g = qblk + r0 + r;
        const float l = ok ? p.l[g] : 0.f;
        st[r] = ok ? p.m[g] : 0.f;
        st[kSub + r] = l == 0.f ? 1.f : l;
        st[2 * kSub + r] = ok ? p.delta[g] : 0.f;
      }
      __syncthreads();
      float s[2][2], dp[2][2];
      zero(s);
      zero(dp);
      mm(s, q_s + ty * LD, TY * LD, 1, k_s + tx * LD, TX * LD, 1, a.d);
      mm(dp, do_s + ty * LD, TY * LD, 1, v_s + tx * LD, TX * LD, 1, a.d);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = ty + i * TY;   // q row of the chunk
        const long long row = (long long)qi * a.pos_bq + r0 + r;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = tx + j * TX;   // kv row of the block
          const bool ok =
              r0 + r < a.bq && c0 + c < a.bk &&
              elem_live(a, row, (long long)jb * a.pos_bk + c0 + c);
          const float sv = logit(a, s[i][j]);
          const float pv = (ok ? expf(sv - st[r]) : 0.f) / st[kSub + r];
          p_s[r * kSLD + c] = pv;
          ds_s[r * kSLD + c] = dlogit(a, pv, dp[i][j], st[2 * kSub + r], sv);
        }
      }
      __syncthreads();
      // (kv rows x d) += (chunk rows)ᵀ products
      mm(dk_e, ds_s + ty, TY, kSLD, q_s + tx, TX, LD, kSub);
      mm(dv_e, p_s + ty, TY, kSLD, do_s + tx, TX, LD, kSub);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        dk[i][j] = __fadd_rn(dk[i][j], __fmul_rn(dk_e[i][j], a.scale));
        dv[i][j] = __fadd_rn(dv[i][j], dv_e[i][j]);
      }
  }

  const long long chain_row =
      ((long long)(hk * a.nk + jb) * a.splits + blockIdx.y) * a.bk + c0;
  const long long orow = (long long)hk * a.tk + (long long)jb * a.bk + c0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = ty + i * TY;
    if (c0 + r >= a.bk) continue;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      const int c = tx + j * TX;
      if (c >= a.d) continue;
      if (p.c0) {
        p.c0[(chain_row + r) * a.d + c] = dk[i][j];
        p.c1[(chain_row + r) * a.d + c] = dv[i][j];
      } else {
        store_as(static_cast<T*>(p.out0) + (orow + r) * a.d + c, dk[i][j]);
        store_as(static_cast<T*>(p.out1) + (orow + r) * a.d + c, dv[i][j]);
      }
    }
  }
  if (!p.c0 && p.counts && sub == 0 && threadIdx.x == 0)
    p.counts[hk * a.nk + jb] = count;
}

// The split-KV chain of the forward: (m, l, acc) chunks combined left to
// right from the identity, then acc / l (and the statistics). Chain
// buffers are (row blocks, splits, tile, dim).
//   * A warp takes a row. Its lanes cover the row's d columns V at a time
//     (V = 4: one 16-byte load a lane and split at d = 128, two at d = 256;
//     any d that is not a multiple of 4, or a base that is not 16-byte
//     aligned, takes V = 1), K column groups a lane.
//   * The splits go in groups of kChainGroup: lane j reads split j's
//     (m, l), and every lane issues the group's acc loads, and those of
//     the next group, before it folds the group.
//   * The running max is taken in split order by every lane from the
//     shuffled m's; lane j then computes split j's two weights
//     expf(m - mn) and expf(m2 - mn) once for the row, and the fold reads
//     them by shuffle. l folds beside acc in the same order.
// Bits: the weights, the fold (__fmul_rn, __fadd_rn, left to right from
// the identity) and the guarded divide are the one-thread-a-column form's
// to the bit; only who computes them moved. Bound: device-memory
// bytes, each chunk's acc read once and the output written once.
constexpr int kChainWarps = 4;   // rows a block
constexpr int kChainGroup = 8;   // splits whose loads are in flight together

// V consecutive floats through the read-only path, cached as usual: the
// split pass has just written the partials, and they are still in L2.
template <int V>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 w = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
  } else {
    v[0] = __ldg(p);
  }
}
template <int V>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[V]) {
  if constexpr (V == 4) *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else *p = v[0];
}
template <int V>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 w;
    w.x = *reinterpret_cast<unsigned*>(&lo);
    w.y = *reinterpret_cast<unsigned*>(&hi);
    *reinterpret_cast<uint2*>(p) = w;
  } else {
    *p = __float2bfloat16_rn(v[0]);
  }
}

template <typename T, int V, int K>
__global__ void __launch_bounds__(32 * kChainWarps)
fold_chain_softmax_kernel(long long rows, int splits, int tile, int d,
                          FoldPtrs p) {
  constexpr int G = kChainGroup;
  const long long row = (long long)blockIdx.x * kChainWarps + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const long long rb = row / tile;
  const int i = row % tile;
  const float* __restrict__ pm = p.c0;
  const float* __restrict__ pl = p.c1;
  const float* __restrict__ pa = p.c2;
  // split s of the row: (m, l) at (rb splits + s) tile + i, acc d times that
  const long long t0 = rb * splits * tile + i;
  struct Group {
    float m2, l2;        // lane j: split j's (m, l)
    float a[G][K][V];    // every lane: its columns of the group's acc
  };
  auto load = [&](int s0, Group& g) {
    const int s = s0 + lane;
    g.m2 = kNegInf;
    g.l2 = 0.f;
    if (lane < G && s < splits) {
      g.m2 = __ldg(pm + t0 + (long long)s * tile);
      g.l2 = __ldg(pl + t0 + (long long)s * tile);
    }
#pragma unroll
    for (int u = 0; u < G; ++u)
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int c = (k * 32 + lane) * V;
        if (s0 + u < splits && c < d)
          load_vec<V>(pa + (t0 + (long long)(s0 + u) * tile) * d + c, g.a[u][k]);
      }
  };
  float m = kNegInf, l = 0.f, acc[K][V];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[k][v] = 0.f;
  Group cur, next;
  load(0, cur);
  for (int s0 = 0; s0 < splits; s0 += G) {
    if (s0 + G < splits) load(s0 + G, next);
    // the running max in split order; lane j keeps split j's (m, mn)
    float mj = m, mnj = m;
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const float m2 = __shfl_sync(0xffffffffu, cur.m2, u);
      if (s0 + u < splits) {
        const float mn = fmaxf(m, m2);
        if (lane == u) {
          mj = m;
          mnj = mn;
        }
        m = mn;
      }
    }
    const float wa = expf(mj - mnj), wb = expf(cur.m2 - mnj);
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const float a1 = __shfl_sync(0xffffffffu, wa, u);
      const float b1 = __shfl_sync(0xffffffffu, wb, u);
      const float l2 = __shfl_sync(0xffffffffu, cur.l2, u);
      if (s0 + u < splits) {
        l = __fadd_rn(__fmul_rn(l, a1), __fmul_rn(l2, b1));
#pragma unroll
        for (int k = 0; k < K; ++k)
#pragma unroll
          for (int v = 0; v < V; ++v)
            acc[k][v] = __fadd_rn(__fmul_rn(acc[k][v], a1),
                                  __fmul_rn(cur.a[u][k][v], b1));
      }
    }
    cur = next;
  }
  const float safe = l == 0.f ? 1.f : l;
  T* out = static_cast<T*>(p.out0) + row * d;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = (k * 32 + lane) * V;
    if (c >= d) continue;
    float o[V];
#pragma unroll
    for (int v = 0; v < V; ++v) o[v] = acc[k][v] / safe;
    store_vec<V>(out + c, o);
  }
  if (p.m_out && lane == 0) {
    p.m_out[row] = m;
    p.l_out[row] = l;
  }
}

// The chain of the backward sum folds: 0 + t_0 + t_1 + ... per leaf.
template <typename T>
__global__ void fold_chain_sum_kernel(long long rows, int splits, int tile,
                                      int d, FoldPtrs p) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= rows * d) return;
  const long long row = e / d;
  const int c = e % d;
  const long long rb = row / tile;
  const int i = row % tile;
  float s0 = 0.f, s1 = 0.f;
  for (int s = 0; s < splits; ++s) {
    const long long t = ((rb * splits + s) * tile + i) * d + c;
    s0 = __fadd_rn(s0, p.c0[t]);
    if (p.c1) s1 = __fadd_rn(s1, p.c1[t]);
  }
  store_as(static_cast<T*>(p.out0) + e, s0);
  if (p.c1) store_as(static_cast<T*>(p.out1) + e, s1);
}

// -- launchers ---------------------------------------------------------------

template <typename K>
cudaError_t launch(K kern, dim3 grid, size_t smem, cudaStream_t stream,
                   const FoldArgs& a, const FoldPtrs& p) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, kThreads, smem, stream>>>(a, p);
  return cudaGetLastError();
}

template <typename T, int TY, int DC>
cudaError_t run_fwd(const FoldArgs& a, const FoldPtrs& p, cudaStream_t st) {
  using G = Tiles<TY, DC>;
  const size_t smem =
      sizeof(float) * (G::BR * G::LD + kMaxBK * G::LD + G::BR * kPLD);
  const unsigned nsub = (a.bq + G::BR - 1) / G::BR;
  return launch(fold_fwd_kernel<T, TY, DC>,
                dim3((unsigned)a.bh * a.nq * nsub, a.splits), smem, st, a, p);
}

template <typename T, int TY, int DC>
cudaError_t run_dq(const FoldArgs& a, const FoldPtrs& p, cudaStream_t st) {
  using G = Tiles<TY, DC>;
  const size_t smem =
      sizeof(float) * (2 * G::BR * G::LD + kMaxBK * G::LD + G::BR * kPLD);
  const unsigned nsub = (a.bq + G::BR - 1) / G::BR;
  return launch(fold_dq_kernel<T, TY, DC>,
                dim3((unsigned)a.bh * a.nq * nsub, a.splits), smem, st, a, p);
}

template <typename T, int DC>
cudaError_t run_dkv(const FoldArgs& a, const FoldPtrs& p, cudaStream_t st) {
  constexpr int LD = DC * 16 + 1;
  const size_t smem =
      sizeof(float) * (4 * kSub * LD + 2 * kSub * kSLD + 3 * kSub);
  const unsigned nsub = (a.bk + kSub - 1) / kSub;
  return launch(fold_dkv_kernel<T, DC>,
                dim3((unsigned)a.bh_kv * a.nk * nsub, a.splits), smem, st, a,
                p);
}

// fold_chain_softmax_kernel, a warp a row: four columns a lane where d is
// a multiple of 4 and the chain's acc and the output are 16- (8-) byte
// aligned, else one; K groups of 32 V columns cover d <= 256.
template <typename T>
cudaError_t launch_chain_softmax(long long rows, int splits, int tile, int d,
                                 const FoldPtrs& p, cudaStream_t st) {
  const unsigned blocks = (unsigned)((rows + kChainWarps - 1) / kChainWarps);
  const bool vec = d % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(p.c2) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(p.out0) % (4 * sizeof(T)) == 0;
  constexpr int kT = 32 * kChainWarps;
  if (vec && d <= 128)
    fold_chain_softmax_kernel<T, 4, 1><<<blocks, kT, 0, st>>>(rows, splits,
                                                              tile, d, p);
  else if (vec)
    fold_chain_softmax_kernel<T, 4, 2><<<blocks, kT, 0, st>>>(rows, splits,
                                                              tile, d, p);
  else
    fold_chain_softmax_kernel<T, 1, 8><<<blocks, kT, 0, st>>>(rows, splits,
                                                              tile, d, p);
  return cudaGetLastError();
}

// The register tile of the head dim: the smallest DC with DC * TX >= d.
template <typename T, int TY, template <typename, int, int> class Run>
cudaError_t by_dim(const FoldArgs& a, const FoldPtrs& p, cudaStream_t st) {
  constexpr int TX = kThreads / TY;
  if (a.d <= TX) return Run<T, TY, 1>::go(a, p, st);
  if (a.d <= 2 * TX) return Run<T, TY, 2>::go(a, p, st);
  if (a.d <= 4 * TX) return Run<T, TY, 4>::go(a, p, st);
  if (a.d <= 8 * TX) return Run<T, TY, 8>::go(a, p, st);
  if (TY == 16 && a.d <= 16 * TX) return Run<T, TY, 16>::go(a, p, st);
  return cudaErrorInvalidValue;
}

template <typename T, int TY, int DC>
struct Fwd {
  static cudaError_t go(const FoldArgs& a, const FoldPtrs& p,
                        cudaStream_t st) {
    return run_fwd<T, TY, (TY == 8 && DC > 8) ? 8 : DC>(a, p, st);
  }
};
template <typename T, int TY, int DC>
struct Dq {
  static cudaError_t go(const FoldArgs& a, const FoldPtrs& p,
                        cudaStream_t st) {
    return run_dq<T, TY, (TY == 8 && DC > 8) ? 8 : DC>(a, p, st);
  }
};
template <typename T, int TY, int DC>
struct Dkv {
  static cudaError_t go(const FoldArgs& a, const FoldPtrs& p,
                        cudaStream_t st) {
    return run_dkv<T, DC>(a, p, st);
  }
};

template <template <typename, int, int> class Run>
int dispatch(const FoldArgs* a, const FoldPtrs* p, int dtype, int ty,
             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return ty == 8 ? by_dim<float, 8, Run>(*a, *p, st)
                   : by_dim<float, 16, Run>(*a, *p, st);
  if (dtype == 1)
    return ty == 8 ? by_dim<__nv_bfloat16, 8, Run>(*a, *p, st)
                   : by_dim<__nv_bfloat16, 16, Run>(*a, *p, st);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Forward fold (softmax_pair) on KVBlocks. p->c0 set: the split pass
// (publish (m, l, acc) to c0, c1, c2); else finalize into out0 (and
// m_out / l_out with statistics). Blocks of 8 rows when bq < 32.
int attn_fold_fwd(const FoldArgs* a, const FoldPtrs* p, int dtype,
                  void* stream) {
  return dispatch<Fwd>(a, p, dtype, a->bq < 32 ? 8 : 16, stream);
}

// Backward dq fold on KVBlocks: out0 = dq, or the split pass into c0.
int attn_fold_dq(const FoldArgs* a, const FoldPtrs* p, int dtype,
                 void* stream) {
  return dispatch<Dq>(a, p, dtype, a->bq < 32 ? 8 : 16, stream);
}

// Backward dk/dv fold on QBlocks: out0 = dk, out1 = dv, or the split pass
// into c0 (dk) and c1 (dv).
int attn_fold_dkv(const FoldArgs* a, const FoldPtrs* p, int dtype,
                  void* stream) {
  return dispatch<Dkv>(a, p, dtype, 16, stream);
}

// The chain over `splits` chunks of (rows / tile) row blocks: kind 0 the
// softmax pair (c0 = m, c1 = l, c2 = acc -> out0, m_out, l_out), kind 1
// the sum of one or two leaves (c0 -> out0, c1 -> out1).
int attn_fold_chain(int kind, int dtype, long long rows, int splits, int tile,
                    int d, const FoldPtrs* p, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n = rows * d;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  if (n == 0) return cudaSuccess;
  if (kind == 0 && (dtype == 0 || dtype == 1)) {
    if (d > 256) return cudaErrorInvalidValue;
    return dtype == 0 ? launch_chain_softmax<float>(rows, splits, tile, d, *p, st)
                      : launch_chain_softmax<__nv_bfloat16>(rows, splits, tile,
                                                           d, *p, st);
  }
  if (kind == 1 && dtype == 0)
    fold_chain_sum_kernel<float><<<blocks, kThreads, 0, st>>>(
        rows, splits, tile, d, *p);
  else if (kind == 1 && dtype == 1)
    fold_chain_sum_kernel<__nv_bfloat16><<<blocks, kThreads, 0, st>>>(
        rows, splits, tile, d, *p);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

const char* attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
