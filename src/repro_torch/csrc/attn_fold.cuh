// What the attention-fold kernels share: the launch structs of the C
// interface (cuda_fold.py's FoldArgs and FoldPtrs), the finite NEG_INF and
// the cell liveness of the reference's layouts. Included by attn_fold.cu
// (the SIMT kernels) and attn_fold_tc.cu (the tensor-core forms); each
// builds into its own library.

#pragma once

#include <cuda_runtime.h>

// The geometry and mask of one fold launch (cuda_fold.py's FoldArgs).
struct FoldArgs {
  int bh, bh_kv, tq, tk, d, bq, bk, group, nq, nk;
  int splits, bpc;         // fold chunks and blocks per chunk
  int pos_bq, pos_bk;      // the spec's block sizes: block ids -> positions
  float scale, softcap;
  int has_softcap, causal, has_window, window, has_kv_len, kv_len;
  int bounds, b_causal, b_has_window, b_window, b_has_kv_len, b_kv_len;
};

// The tensors of one fold launch; NULL where absent.
struct FoldPtrs {
  const void *q, *k, *v, *dout;
  const float *m, *l, *delta;   // backward row statistics
  const int* kv_map;            // KVBlocks page map, or NULL
  void *out0, *out1;            // out / dq / (dk, dv)
  float *m_out, *l_out;         // forward statistics (with_stats)
  int* counts;                  // count_cells, or NULL
  float *c0, *c1, *c2;          // chain buffers (split pass), or NULL
};

namespace {

constexpr float kNegInf = -1e30f;

// layouts.block_live: may the (q-block qi, kv-block kj) cell hold a live
// entry? False proves every entry masked.
__device__ __forceinline__ bool cell_live(const FoldArgs& a, int qi, int kj) {
  if (!a.bounds) return true;
  const long long c0 = (long long)kj * a.bk;
  bool live = true;
  if (a.b_has_kv_len) live = c0 < a.b_kv_len;
  if (a.b_causal) live = live && c0 <= (long long)(qi + 1) * a.bq - 1;
  if (a.b_has_window)
    live = live && c0 + a.bk - 1 > (long long)qi * a.bq - a.b_window;
  return live;
}

}  // namespace
