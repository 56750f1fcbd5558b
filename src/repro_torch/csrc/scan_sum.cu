// Sum-family scan kernels of the scan engine, CUDA C++ for Hopper (sm_90a).
//
// One in-tile network, one chain and one set of schedule kernels, written
// once over a spec (a combine functor and a leaf tuple, the counterpart of
// the reference's KernelSpec) and instantiated for the three specs of the
// sum family:
//   SumSpec<T>     SUM_KERNEL            (assoc.py:202): x -> x
//   SegSumSpec<T>  SEGMENTED_SUM_KERNEL  (assoc.py:221): (value, flag); a
//                  flag on the right kills the carry, flags OR together
//   MaskSpec       mask_kernel_spec      (assoc.py:246): an int32 sum whose
//                  writeback is the fused select: inclusive - m on a kept
//                  lane, the sentinel on a dropped one
//
// What each kernel replaces (Pallas TPU kernels of the reference package,
// src/repro/kernels/scan_engine/schedules.py, run on the Rows layout):
//   carry_kernel   scan_carry, pallas_call at :335 (body _carry_body :298),
//                  with its optional running chunk totals (return_totals)
//   totals_kernel  scan_decoupled, totals pallas_call at :390
//                  (body _totals_body :361)
//   chain_kernel   exclusive_chain :248, the sequential lax.scan over the
//                  chunk totals between decoupled's two launches; it also
//                  writes offsets + totals, decoupled's running totals
//                  (schedules.py:418)
//   apply_kernel   scan_decoupled, apply pallas_call at :405
//                  (body _apply_body :371)
//   tree_kernel    scan_tree, pallas_call at :605 (body _tree_body :557,
//                  tree_scan :224, _blelloch :178)
// The reference's "fused" schedule runs as decoupled (its native form is
// gated off at schedules.py:438), so it has no kernel of its own here.
//
// Bound: device-memory bytes. A scan does one combine per element, so on
// an H100 (3.35 TB/s, 67 TFLOP/s float32 outside the tensor cores) moving
// an element in and out takes ~100x longer than combining it. The design
// therefore touches device memory once per pass: each block reads a whole
// tile with coalesced loads into shared memory, runs the in-tile network
// there, and writes each result once. carry and tree keep the running
// carry in registers while one block walks its row (read n + write n);
// decoupled reads the data twice (totals, then apply) to spread one row
// over every SM. The mask's select re-reads its element at the writeback
// (an L1/L2 hit: the tile was just loaded). The tiles are not yet
// pipelined (no cp.async or TMA), so a block waits for each tile's load.
//
// Association order. Every kernel reproduces the reference's order of
// combines exactly, so its results are bitwise equal to the reference and
// to the plain PyTorch versions in kernels/scan_engine/schedules.py,
// floats included:
//   tile_scan   = schedules.tile_scan: Hillis-Steele within 128-element
//                 segments, Hillis-Steele over the segment totals, an
//                 exclusive shift, a broadcast combine; Hillis-Steele over
//                 the whole tile when it is not a multiple of 128 longer
//                 than 128. Step k computes x[i] = x[i-k] (+) x[i], and
//                 identity (+) x[i] below k, as the reference pads its
//                 shift with the identity.
//   tree        = schedules._blelloch: up-sweep left (+) right, down-sweep
//                 (parent, parent (+) old_left), padded to a power of two
//                 with the identity; inclusive = excl (+) elems.
//   carry/chain = the carry enters every tile as the LEFT operand, and
//                 advances left to right from the identity:
//                 carry = carry (+) total.
// Floats accumulate in float32 (bf16 and f16 inputs too) and integers in
// uint32, so an overflow wraps as XLA's int32 add does instead of being
// undefined behaviour. Outputs round to the input type with the
// round-to-nearest-even intrinsics, as torch's casts do. A segmented flag
// is loaded as (flag != 0) and kept in one byte of shared memory: every
// combine yields 0/1 flags in the reference too, and a value depends on a
// flag only through != 0, so no output can tell the difference; the byte
// lets a 16384-element tile of (value, flag) pairs fit the network's two
// buffers in 160 KB.
//
// Interface: plain C functions, loaded with ctypes, each taking a spec
// code (0 sum, 1 segmented sum, 2 mask) and a dtype code. Each launches on
// the given stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;      // threads of every tile kernel
constexpr int kLanes = 128;        // the reference's lane width (LANES)
constexpr int kChainStage = 1024;  // totals staged per chain iteration

template <typename T> struct Acc { using type = float; };
template <> struct Acc<int32_t> { using type = uint32_t; };
template <> struct Acc<int16_t> { using type = uint32_t; };
template <> struct Acc<int8_t> { using type = uint32_t; };

__device__ __forceinline__ float load_acc(const float* p) { return *p; }
__device__ __forceinline__ float load_acc(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float load_acc(const __half* p) {
  return __half2float(*p);
}
__device__ __forceinline__ uint32_t load_acc(const int32_t* p) {
  return static_cast<uint32_t>(*p);
}
__device__ __forceinline__ uint32_t load_acc(const int16_t* p) {
  return static_cast<uint32_t>(static_cast<int32_t>(*p));
}
__device__ __forceinline__ uint32_t load_acc(const int8_t* p) {
  return static_cast<uint32_t>(static_cast<int32_t>(*p));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ void store(__half* p, float v) {
  *p = __float2half(v);
}
__device__ __forceinline__ void store(int32_t* p, uint32_t v) {
  *p = static_cast<int32_t>(v);
}
__device__ __forceinline__ void store(int16_t* p, uint32_t v) {
  *p = static_cast<int16_t>(v);
}
__device__ __forceinline__ void store(int8_t* p, uint32_t v) {
  *p = static_cast<int8_t>(v);
}

__host__ __device__ constexpr size_t round16(size_t bytes) {
  return (bytes + 15) & ~static_cast<size_t>(15);
}

// The tensors a tile kernel reads and writes; each spec uses its own.
struct Tensors {
  const void* x;         // values (sum, segmented sum) or the int32 mask
  const int32_t* flags;  // the segmented sum's int32 flags
  void* out;             // the emitted output, the shape of x
  int sentinel;          // the mask's output for a dropped lane
};

// Per-leaf (rows, chunks) tensors of the chain: totals, offsets or
// running totals. v holds leaf 0 in the accumulation dtype; f the
// segmented sum's int32 flag leaf. v == nullptr: not requested.
struct Leaves {
  void* v;
  int32_t* f;
};

// A spec: the element E (its leaf tuple in registers), Buf (an array of E
// in shared memory, one array per leaf), the identity and combine, how an
// element is loaded and a result emitted, and how a leaf tuple is read
// from and written to Leaves.

// SUM: one leaf, the running sum.
template <typename T>
struct SumSpec {
  using A = typename Acc<T>::type;
  struct E { A v; };
  struct Buf {
    A* v;
    __device__ E get(int i) const { return {v[i]}; }
    __device__ void set(int i, E e) const { v[i] = e.v; }
  };
  __host__ __device__ static size_t buf_bytes(int count) {
    return round16(static_cast<size_t>(count) * sizeof(A));
  }
  __device__ static Buf carve(unsigned char*& p, int count) {
    Buf b{reinterpret_cast<A*>(p)};
    p += buf_bytes(count);
    return b;
  }
  __device__ static E identity() { return {A(0)}; }
  __device__ static E combine(E l, E r) { return {l.v + r.v}; }
  __device__ static E load(const Tensors& t, int64_t i) {
    return {load_acc(static_cast<const T*>(t.x) + i)};
  }
  __device__ static void emit(const Tensors& t, int64_t i, E c) {
    store(static_cast<T*>(t.out) + i, c.v);
  }
  __device__ static E get(const Leaves& g, int64_t i) {
    return {static_cast<const A*>(g.v)[i]};
  }
  __device__ static void put(const Leaves& g, int64_t i, E e) {
    static_cast<A*>(g.v)[i] = e.v;
  }
};

// SEGMENTED SUM: (value, flag). A flag on the right restarts the value;
// flags combine as an OR of != 0.
template <typename T>
struct SegSumSpec {
  using A = typename Acc<T>::type;
  struct E { A v; uint32_t f; };
  struct Buf {
    A* v;
    uint8_t* f;
    __device__ E get(int i) const { return {v[i], f[i]}; }
    __device__ void set(int i, E e) const {
      v[i] = e.v;
      f[i] = static_cast<uint8_t>(e.f);
    }
  };
  __host__ __device__ static size_t buf_bytes(int count) {
    return round16(static_cast<size_t>(count) * sizeof(A)) +
           round16(static_cast<size_t>(count));
  }
  __device__ static Buf carve(unsigned char*& p, int count) {
    Buf b;
    b.v = reinterpret_cast<A*>(p);
    p += round16(static_cast<size_t>(count) * sizeof(A));
    b.f = reinterpret_cast<uint8_t*>(p);
    p += round16(static_cast<size_t>(count));
    return b;
  }
  __device__ static E identity() { return {A(0), 0u}; }
  __device__ static E combine(E l, E r) {
    return {r.f != 0u ? r.v : l.v + r.v, (l.f != 0u || r.f != 0u) ? 1u : 0u};
  }
  __device__ static E load(const Tensors& t, int64_t i) {
    return {load_acc(static_cast<const T*>(t.x) + i), t.flags[i] != 0 ? 1u : 0u};
  }
  __device__ static void emit(const Tensors& t, int64_t i, E c) {
    store(static_cast<T*>(t.out) + i, c.v);
  }
  __device__ static E get(const Leaves& g, int64_t i) {
    return {static_cast<const A*>(g.v)[i], static_cast<uint32_t>(g.f[i])};
  }
  __device__ static void put(const Leaves& g, int64_t i, E e) {
    static_cast<A*>(g.v)[i] = e.v;
    g.f[i] = static_cast<int32_t>(e.f);
  }
};

// MASK: the int32 sum with the fused predicate select as its writeback.
struct MaskSpec : SumSpec<int32_t> {
  __device__ static void emit(const Tensors& t, int64_t i, E c) {
    const int32_t m = static_cast<const int32_t*>(t.x)[i];
    static_cast<int32_t*>(t.out)[i] =
        m != 0 ? static_cast<int32_t>(c.v - static_cast<uint32_t>(m)) : t.sentinel;
  }
};

// In-tile inclusive scan of x[0, bn) (see "Association order" above).
// Every step reads one buffer and writes the other, with a barrier
// between steps; returns the buffer that holds the result. tx/ty hold the
// segment totals. Ends with a barrier, so the result is visible to all.
template <typename S>
__device__ typename S::Buf tile_scan(typename S::Buf x, typename S::Buf y,
                                     typename S::Buf tx, typename S::Buf ty, int bn) {
  using E = typename S::E;
  using Buf = typename S::Buf;
  const int seg = (bn > kLanes && bn % kLanes == 0) ? kLanes : bn;
  for (int k = 1; k < seg; k <<= 1) {
    for (int i = threadIdx.x; i < bn; i += blockDim.x) {
      const E left = (i % seg) >= k ? x.get(i - k) : S::identity();
      y.set(i, S::combine(left, x.get(i)));
    }
    __syncthreads();
    const Buf t = x; x = y; y = t;
  }
  if (seg == bn) return x;
  const int r = bn / seg;
  for (int q = threadIdx.x; q < r; q += blockDim.x) tx.set(q, x.get(q * seg + seg - 1));
  __syncthreads();
  for (int k = 1; k < r; k <<= 1) {
    for (int q = threadIdx.x; q < r; q += blockDim.x) {
      const E left = q >= k ? tx.get(q - k) : S::identity();
      ty.set(q, S::combine(left, tx.get(q)));
    }
    __syncthreads();
    const Buf t = tx; tx = ty; ty = t;
  }
  for (int i = threadIdx.x; i < bn; i += blockDim.x) {
    const int q = i / seg;
    const E off = q > 0 ? tx.get(q - 1) : S::identity();  // exclusive shift
    x.set(i, S::combine(off, x.get(i)));
  }
  __syncthreads();
  return x;
}

// Shared memory of one tile network: two tile buffers, two totals buffers.
template <typename S>
size_t network_bytes(int bn) {
  return 2 * S::buf_bytes(bn) + 2 * S::buf_bytes(bn / kLanes + 1);
}

template <typename S>
struct Network {
  typename S::Buf x, y, tx, ty;
  __device__ Network(unsigned char* smem, int bn) {
    unsigned char* p = smem;
    x = S::carve(p, bn);
    y = S::carve(p, bn);
    tx = S::carve(p, bn / kLanes + 1);
    ty = S::carve(p, bn / kLanes + 1);
  }
  __device__ typename S::Buf scan(int bn) { return tile_scan<S>(x, y, tx, ty, bn); }
};

template <typename S>
__device__ void load_tile(const Tensors& t, int64_t base, typename S::Buf dst, int bn) {
  for (int i = threadIdx.x; i < bn; i += blockDim.x) dst.set(i, S::load(t, base + i));
  __syncthreads();
}

// Emits left (+) (exclusive ? s shifted one step right with the identity : s).
template <typename S>
__device__ void store_tile(const Tensors& t, int64_t base, typename S::Buf s,
                           typename S::E left, int bn, int exclusive) {
  for (int i = threadIdx.x; i < bn; i += blockDim.x) {
    const typename S::E sel =
        exclusive ? (i > 0 ? s.get(i - 1) : S::identity()) : s.get(i);
    S::emit(t, base + i, S::combine(left, sel));
  }
}

// carry: one block per row walks the row's chunks in order; with running
// totals, thread 0 writes the carry after each chunk.
template <typename S>
__global__ void __launch_bounds__(kThreads)
carry_kernel(Tensors t, Leaves running, int64_t n, int bn, int exclusive) {
  extern __shared__ __align__(16) unsigned char smem[];
  Network<S> net(smem, bn);
  const int64_t base = static_cast<int64_t>(blockIdx.x) * n;
  const int64_t chunks = n / bn;
  typename S::E carry = S::identity();
  for (int64_t c = 0; c < chunks; ++c) {
    load_tile<S>(t, base + c * bn, net.x, bn);
    const typename S::Buf s = net.scan(bn);
    store_tile<S>(t, base + c * bn, s, carry, bn, exclusive);
    carry = S::combine(carry, s.get(bn - 1));
    if (running.v != nullptr && threadIdx.x == 0)
      S::put(running, static_cast<int64_t>(blockIdx.x) * chunks + c, carry);
    __syncthreads();  // the next tile overwrites s
  }
}

// totals: one block per (row, chunk) tile writes the LAST element of the
// same network, so the chain below reproduces carry's combines.
template <typename S>
__global__ void __launch_bounds__(kThreads)
totals_kernel(Tensors t, Leaves totals, int bn) {
  extern __shared__ __align__(16) unsigned char smem[];
  Network<S> net(smem, bn);
  const int64_t tile = blockIdx.x;
  load_tile<S>(t, tile * bn, net.x, bn);
  const typename S::Buf s = net.scan(bn);
  if (threadIdx.x == 0) S::put(totals, tile, s.get(bn - 1));
}

// chain: one warp per row stages totals through shared memory with
// coalesced loads and stores; lane 0 alone runs the sequential exclusive
// chain, left to right from the identity, in lax.scan's order. With
// running != nullptr the warp also writes offset (+) total, the running
// totals: the same combine of the same operands as lane 0's step, so the
// same bits, taken off lane 0's sequential path.
template <typename S>
__global__ void chain_kernel(Leaves totals, Leaves offsets, Leaves running,
                             int64_t chunks) {
  using E = typename S::E;
  __shared__ E tot[kChainStage];
  __shared__ E off[kChainStage];
  const int64_t row = static_cast<int64_t>(blockIdx.x) * chunks;
  E acc = S::identity();
  for (int64_t c0 = 0; c0 < chunks; c0 += kChainStage) {
    const int w = static_cast<int>(
        chunks - c0 < kChainStage ? chunks - c0 : kChainStage);
    for (int i = threadIdx.x; i < w; i += blockDim.x)
      tot[i] = S::get(totals, row + c0 + i);
    __syncwarp();
    if (threadIdx.x == 0) {
      // Eight totals are read ahead into registers, so each step of the
      // chain waits on its combine alone, not on a shared-memory load.
      int i = 0;
      for (; i + 8 <= w; i += 8) {
        E v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = tot[i + j];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          off[i + j] = acc;
          acc = S::combine(acc, v[j]);
        }
      }
      for (; i < w; ++i) {
        off[i] = acc;
        acc = S::combine(acc, tot[i]);
      }
    }
    __syncwarp();
    for (int i = threadIdx.x; i < w; i += blockDim.x) {
      S::put(offsets, row + c0 + i, off[i]);
      if (running.v != nullptr)
        S::put(running, row + c0 + i, S::combine(off[i], tot[i]));
    }
    __syncwarp();
  }
}

// apply: one block per (row, chunk) tile rescans and combines its offset.
template <typename S>
__global__ void __launch_bounds__(kThreads)
apply_kernel(Tensors t, Leaves offsets, int bn, int exclusive) {
  extern __shared__ __align__(16) unsigned char smem[];
  Network<S> net(smem, bn);
  const int64_t tile = blockIdx.x;
  load_tile<S>(t, tile * bn, net.x, bn);
  const typename S::Buf s = net.scan(bn);
  store_tile<S>(t, tile * bn, s, S::get(offsets, tile), bn, exclusive);
}

// tree: carry's row walk with an in-place Blelloch sweep over the tile
// padded to m (a power of two) with the identity. e keeps the elements
// for the inclusive form.
template <typename S>
__global__ void __launch_bounds__(kThreads)
tree_kernel(Tensors t, Leaves running, int64_t n, int bn, int m, int exclusive) {
  using E = typename S::E;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* p = smem;
  const typename S::Buf a = S::carve(p, m);
  const typename S::Buf e = S::carve(p, bn);
  const int64_t base = static_cast<int64_t>(blockIdx.x) * n;
  const int64_t chunks = n / bn;
  E carry = S::identity();
  for (int64_t c = 0; c < chunks; ++c) {
    const int64_t c0 = base + c * bn;
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
      const E v = i < bn ? S::load(t, c0 + i) : S::identity();
      a.set(i, v);
      if (i < bn) e.set(i, v);
    }
    __syncthreads();
    for (int d = 1; d < m; d <<= 1) {  // up-sweep: left (+) right
      for (int q = threadIdx.x; q < m / (2 * d); q += blockDim.x) {
        const int right = (q + 1) * 2 * d - 1;
        a.set(right, S::combine(a.get(right - d), a.get(right)));
      }
      __syncthreads();
    }
    const E root = a.get(m - 1);
    __syncthreads();
    if (threadIdx.x == 0) a.set(m - 1, S::identity());
    __syncthreads();
    for (int d = m >> 1; d >= 1; d >>= 1) {  // down-sweep
      for (int q = threadIdx.x; q < m / (2 * d); q += blockDim.x) {
        const int right = (q + 1) * 2 * d - 1;
        const E parent = a.get(right);
        const E old_left = a.get(right - d);
        a.set(right - d, parent);
        a.set(right, S::combine(parent, old_left));  // combine(parent, old_left)
      }
      __syncthreads();
    }
    for (int i = threadIdx.x; i < bn; i += blockDim.x) {
      const E sel = exclusive ? a.get(i) : S::combine(a.get(i), e.get(i));
      S::emit(t, c0 + i, S::combine(carry, sel));
    }
    carry = S::combine(carry, root);
    if (running.v != nullptr && threadIdx.x == 0)
      S::put(running, static_cast<int64_t>(blockIdx.x) * chunks + c, carry);
    __syncthreads();  // the next tile overwrites a and e
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename S>
int launch_carry(Tensors t, Leaves running, long long rows, long long n, int bn,
                 int exclusive, cudaStream_t stream) {
  const size_t smem = network_bytes<S>(bn);
  cudaError_t err = allow_smem(carry_kernel<S>, smem);
  if (err != cudaSuccess) return err;
  carry_kernel<S><<<static_cast<unsigned>(rows), kThreads, smem, stream>>>(
      t, running, n, bn, exclusive);
  return cudaGetLastError();
}

template <typename S>
int launch_totals(Tensors t, Leaves totals, long long rows, long long n, int bn,
                  cudaStream_t stream) {
  const size_t smem = network_bytes<S>(bn);
  cudaError_t err = allow_smem(totals_kernel<S>, smem);
  if (err != cudaSuccess) return err;
  const long long tiles = rows * (n / bn);
  totals_kernel<S><<<static_cast<unsigned>(tiles), kThreads, smem, stream>>>(
      t, totals, bn);
  return cudaGetLastError();
}

template <typename S>
int launch_chain(Leaves totals, Leaves offsets, Leaves running, long long rows,
                 long long chunks, cudaStream_t stream) {
  chain_kernel<S><<<static_cast<unsigned>(rows), 32, 0, stream>>>(
      totals, offsets, running, chunks);
  return cudaGetLastError();
}

template <typename S>
int launch_apply(Tensors t, Leaves offsets, long long rows, long long n, int bn,
                 int exclusive, cudaStream_t stream) {
  const size_t smem = network_bytes<S>(bn);
  cudaError_t err = allow_smem(apply_kernel<S>, smem);
  if (err != cudaSuccess) return err;
  const long long tiles = rows * (n / bn);
  apply_kernel<S><<<static_cast<unsigned>(tiles), kThreads, smem, stream>>>(
      t, offsets, bn, exclusive);
  return cudaGetLastError();
}

template <typename S>
int launch_tree(Tensors t, Leaves running, long long rows, long long n, int bn,
                int exclusive, cudaStream_t stream) {
  int m = 1;
  while (m < bn) m <<= 1;
  const size_t smem = S::buf_bytes(m) + S::buf_bytes(bn);
  cudaError_t err = allow_smem(tree_kernel<S>, smem);
  if (err != cudaSuccess) return err;
  tree_kernel<S><<<static_cast<unsigned>(rows), kThreads, smem, stream>>>(
      t, running, n, bn, m, exclusive);
  return cudaGetLastError();
}

}  // namespace

// spec codes, as kernels/scan_engine/cuda.py numbers them: 0 sum,
// 1 segmented sum, 2 mask. dtype codes of the values: 0 float32,
// 1 bfloat16, 2 float16, 3 int32, 4 int16, 5 int8 (the mask takes int32).
#define SCAN_DISPATCH(spec, dtype, fn, ...)                        \
  switch ((spec) * 8 + (dtype)) {                                  \
    case 0: return fn<SumSpec<float>>(__VA_ARGS__);                \
    case 1: return fn<SumSpec<__nv_bfloat16>>(__VA_ARGS__);        \
    case 2: return fn<SumSpec<__half>>(__VA_ARGS__);               \
    case 3: return fn<SumSpec<int32_t>>(__VA_ARGS__);              \
    case 4: return fn<SumSpec<int16_t>>(__VA_ARGS__);              \
    case 5: return fn<SumSpec<int8_t>>(__VA_ARGS__);               \
    case 8: return fn<SegSumSpec<float>>(__VA_ARGS__);             \
    case 9: return fn<SegSumSpec<__nv_bfloat16>>(__VA_ARGS__);     \
    case 10: return fn<SegSumSpec<__half>>(__VA_ARGS__);           \
    case 11: return fn<SegSumSpec<int32_t>>(__VA_ARGS__);          \
    case 12: return fn<SegSumSpec<int16_t>>(__VA_ARGS__);          \
    case 13: return fn<SegSumSpec<int8_t>>(__VA_ARGS__);           \
    case 19: return fn<MaskSpec>(__VA_ARGS__);                     \
    default: return cudaErrorInvalidValue;                         \
  }

extern "C" {

int scan_carry(int spec, int dtype, const void* x, const void* flags, void* out,
               void* run_v, void* run_f, long long rows, long long n, int bn,
               int exclusive, int sentinel, void* stream) {
  const Tensors t{x, static_cast<const int32_t*>(flags), out, sentinel};
  const Leaves running{run_v, static_cast<int32_t*>(run_f)};
  SCAN_DISPATCH(spec, dtype, launch_carry, t, running, rows, n, bn, exclusive,
                static_cast<cudaStream_t>(stream));
}

int scan_totals(int spec, int dtype, const void* x, const void* flags, void* tot_v,
                void* tot_f, long long rows, long long n, int bn, void* stream) {
  const Tensors t{x, static_cast<const int32_t*>(flags), nullptr, 0};
  const Leaves totals{tot_v, static_cast<int32_t*>(tot_f)};
  SCAN_DISPATCH(spec, dtype, launch_totals, t, totals, rows, n, bn,
                static_cast<cudaStream_t>(stream));
}

// The chain's dtype code is its totals' accumulation dtype: 0 float32 or
// 3 int32.
int scan_chain(int spec, int dtype, const void* tot_v, const void* tot_f,
               void* off_v, void* off_f, void* run_v, void* run_f, long long rows,
               long long chunks, void* stream) {
  if (dtype != 0 && dtype != 3) return cudaErrorInvalidValue;
  const Leaves totals{const_cast<void*>(tot_v),
                      const_cast<int32_t*>(static_cast<const int32_t*>(tot_f))};
  const Leaves offsets{off_v, static_cast<int32_t*>(off_f)};
  const Leaves running{run_v, static_cast<int32_t*>(run_f)};
  SCAN_DISPATCH(spec, dtype, launch_chain, totals, offsets, running, rows, chunks,
                static_cast<cudaStream_t>(stream));
}

int scan_apply(int spec, int dtype, const void* x, const void* flags,
               const void* off_v, const void* off_f, void* out, long long rows,
               long long n, int bn, int exclusive, int sentinel, void* stream) {
  const Tensors t{x, static_cast<const int32_t*>(flags), out, sentinel};
  const Leaves offsets{const_cast<void*>(off_v),
                       const_cast<int32_t*>(static_cast<const int32_t*>(off_f))};
  SCAN_DISPATCH(spec, dtype, launch_apply, t, offsets, rows, n, bn, exclusive,
                static_cast<cudaStream_t>(stream));
}

int scan_tree(int spec, int dtype, const void* x, const void* flags, void* out,
              void* run_v, void* run_f, long long rows, long long n, int bn,
              int exclusive, int sentinel, void* stream) {
  const Tensors t{x, static_cast<const int32_t*>(flags), out, sentinel};
  const Leaves running{run_v, static_cast<int32_t*>(run_f)};
  SCAN_DISPATCH(spec, dtype, launch_tree, t, running, rows, n, bn, exclusive,
                static_cast<cudaStream_t>(stream));
}

const char* scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
