// Sum-scan kernels of the scan engine, CUDA C++ for Hopper (sm_90a).
//
// What each kernel replaces (Pallas TPU kernels of the reference package,
// src/repro/kernels/scan_engine/schedules.py, run with SUM_KERNEL on the
// Rows layout):
//   scan_sum_carry   scan_carry, pallas_call at :335 (body _carry_body :298)
//   scan_sum_totals  scan_decoupled, totals pallas_call at :390
//                    (body _totals_body :361)
//   scan_sum_chain   exclusive_chain :248, the sequential lax.scan over the
//                    chunk totals between decoupled's two launches
//   scan_sum_apply   scan_decoupled, apply pallas_call at :405
//                    (body _apply_body :371)
//   scan_sum_tree    scan_tree, pallas_call at :605 (body _tree_body :557,
//                    tree_scan :224, _blelloch :178)
// The reference's "fused" schedule runs as decoupled (its native form is
// gated off at schedules.py:438), so it has no kernel of its own here.
//
// Bound: device-memory bytes. A prefix sum does one add per element, so
// on an H100 (3.35 TB/s, 67 TFLOP/s float32 outside the tensor cores)
// moving an element in and out takes ~100x longer than adding it. The
// design therefore touches device memory once per pass: each block reads
// a whole tile with coalesced loads into shared memory, runs the in-tile
// network there, and writes each result once. carry and tree keep the
// running total in a register while one block walks its row (read n +
// write n); decoupled reads the data twice (totals, then apply) to spread
// one row over every SM. The tiles are not yet pipelined (no cp.async or
// TMA), so a block waits for each tile's load.
//
// Association order. Every kernel reproduces the reference's order of
// additions exactly, so its results are bitwise equal to the reference
// and to the plain PyTorch versions in kernels/scan_engine/schedules.py,
// floats included:
//   tile_scan   = schedules.tile_scan: Hillis-Steele within 128-element
//                 segments, Hillis-Steele over the segment totals, an
//                 exclusive shift, a broadcast add; Hillis-Steele over the
//                 whole tile when it is not a multiple of 128 longer than
//                 128. Step k computes x[i] = x[i-k] + x[i], and 0 + x[i]
//                 below k, as the reference pads its shift with 0.
//   tree        = schedules._blelloch: up-sweep left + right, down-sweep
//                 (parent, parent + old_left), padded to a power of two
//                 with 0; inclusive = excl + elems.
//   carry/chain = the carry enters every tile as the LEFT operand, and
//                 advances left to right from 0: carry = carry + total.
// Floats accumulate in float32 (bf16 and f16 inputs too) and integers in
// uint32, so an overflow wraps as XLA's int32 add does instead of being
// undefined behaviour. Outputs round to the input type with the
// round-to-nearest-even intrinsics, as torch's casts do.
//
// Interface: plain C functions, loaded with ctypes. Each launches on the
// given stream, allocates nothing, and returns cudaGetLastError().

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

// In-tile inclusive scan of x[0, bn) (see "Association order" above).
// Every step reads one buffer and writes the other, with a barrier
// between steps; returns the buffer that holds the result. tx/ty hold the
// segment totals. Ends with a barrier, so the result is visible to all.
template <typename A>
__device__ A* tile_scan(A* x, A* y, A* tx, A* ty, int bn) {
  const int seg = (bn > kLanes && bn % kLanes == 0) ? kLanes : bn;
  for (int k = 1; k < seg; k <<= 1) {
    for (int i = threadIdx.x; i < bn; i += blockDim.x) {
      const A left = (i % seg) >= k ? x[i - k] : A(0);
      y[i] = left + x[i];
    }
    __syncthreads();
    A* t = x; x = y; y = t;
  }
  if (seg == bn) return x;
  const int r = bn / seg;
  for (int q = threadIdx.x; q < r; q += blockDim.x) tx[q] = x[q * seg + seg - 1];
  __syncthreads();
  for (int k = 1; k < r; k <<= 1) {
    for (int q = threadIdx.x; q < r; q += blockDim.x) {
      const A left = q >= k ? tx[q - k] : A(0);
      ty[q] = left + tx[q];
    }
    __syncthreads();
    A* t = tx; tx = ty; ty = t;
  }
  for (int i = threadIdx.x; i < bn; i += blockDim.x) {
    const int q = i / seg;
    const A off = q > 0 ? tx[q - 1] : A(0);  // exclusive shift of totals
    x[i] = off + x[i];
  }
  __syncthreads();
  return x;
}

// Shared memory of one tile network: two tile buffers, two totals buffers.
__host__ __device__ inline size_t network_words(int bn) {
  return 2 * static_cast<size_t>(bn) + 2 * static_cast<size_t>(bn / kLanes + 1);
}

template <typename A>
__device__ void network_buffers(unsigned char* smem, int bn, A** x, A** y,
                                A** tx, A** ty) {
  *x = reinterpret_cast<A*>(smem);
  *y = *x + bn;
  *tx = *y + bn;
  *ty = *tx + bn / kLanes + 1;
}

template <typename T, typename A>
__device__ void load_tile(const T* src, A* dst, int bn) {
  for (int i = threadIdx.x; i < bn; i += blockDim.x) dst[i] = load_acc(src + i);
  __syncthreads();
}

// Writes left + (exclusive ? s shifted one step right with 0 : s).
template <typename T, typename A>
__device__ void store_tile(T* dst, const A* s, A left, int bn, int exclusive) {
  for (int i = threadIdx.x; i < bn; i += blockDim.x) {
    const A sel = exclusive ? (i > 0 ? s[i - 1] : A(0)) : s[i];
    store(dst + i, left + sel);
  }
}

// carry: one block per row walks the row's chunks in order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
carry_kernel(const T* __restrict__ x, T* __restrict__ out, int64_t n, int bn,
             int exclusive) {
  using A = typename Acc<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  A *bx, *by, *tx, *ty;
  network_buffers(smem, bn, &bx, &by, &tx, &ty);
  const int64_t base = static_cast<int64_t>(blockIdx.x) * n;
  A carry = A(0);
  for (int64_t c0 = 0; c0 < n; c0 += bn) {
    load_tile(x + base + c0, bx, bn);
    const A* s = tile_scan(bx, by, tx, ty, bn);
    store_tile(out + base + c0, s, carry, bn, exclusive);
    carry = carry + s[bn - 1];
    __syncthreads();  // the next tile overwrites s
  }
}

// totals: one block per (row, chunk) tile writes the LAST element of the
// same network, so the chain below reproduces carry's additions.
template <typename T>
__global__ void __launch_bounds__(kThreads)
totals_kernel(const T* __restrict__ x, typename Acc<T>::type* __restrict__ totals,
              int bn) {
  using A = typename Acc<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  A *bx, *by, *tx, *ty;
  network_buffers(smem, bn, &bx, &by, &tx, &ty);
  const int64_t tile = blockIdx.x;
  load_tile(x + tile * bn, bx, bn);
  const A* s = tile_scan(bx, by, tx, ty, bn);
  if (threadIdx.x == 0) totals[tile] = s[bn - 1];
}

// chain: one warp per row stages totals through shared memory with
// coalesced loads and stores; lane 0 alone runs the sequential exclusive
// chain, left to right from 0, in lax.scan's order.
template <typename A>
__global__ void chain_kernel(const A* __restrict__ totals, A* __restrict__ offsets,
                             int64_t chunks) {
  __shared__ A buf[kChainStage];
  const A* t = totals + static_cast<int64_t>(blockIdx.x) * chunks;
  A* o = offsets + static_cast<int64_t>(blockIdx.x) * chunks;
  A acc = A(0);
  for (int64_t c0 = 0; c0 < chunks; c0 += kChainStage) {
    const int w = static_cast<int>(
        chunks - c0 < kChainStage ? chunks - c0 : kChainStage);
    for (int i = threadIdx.x; i < w; i += blockDim.x) buf[i] = t[c0 + i];
    __syncwarp();
    if (threadIdx.x == 0) {
      for (int i = 0; i < w; ++i) {
        const A v = buf[i];
        buf[i] = acc;
        acc = acc + v;
      }
    }
    __syncwarp();
    for (int i = threadIdx.x; i < w; i += blockDim.x) o[c0 + i] = buf[i];
    __syncwarp();
  }
}

// apply: one block per (row, chunk) tile rescans and adds its offset.
template <typename T>
__global__ void __launch_bounds__(kThreads)
apply_kernel(const T* __restrict__ x, const typename Acc<T>::type* __restrict__ offsets,
             T* __restrict__ out, int bn, int exclusive) {
  using A = typename Acc<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  A *bx, *by, *tx, *ty;
  network_buffers(smem, bn, &bx, &by, &tx, &ty);
  const int64_t tile = blockIdx.x;
  load_tile(x + tile * bn, bx, bn);
  const A* s = tile_scan(bx, by, tx, ty, bn);
  store_tile(out + tile * bn, s, offsets[tile], bn, exclusive);
}

// tree: carry's row walk with an in-place Blelloch sweep over the tile
// padded to m (a power of two) with 0. e keeps the elements for the
// inclusive form.
template <typename T>
__global__ void __launch_bounds__(kThreads)
tree_kernel(const T* __restrict__ x, T* __restrict__ out, int64_t n, int bn,
            int m, int exclusive) {
  using A = typename Acc<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  A* a = reinterpret_cast<A*>(smem);
  A* e = a + m;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * n;
  A carry = A(0);
  for (int64_t c0 = 0; c0 < n; c0 += bn) {
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
      const A v = i < bn ? load_acc(x + base + c0 + i) : A(0);
      a[i] = v;
      if (i < bn) e[i] = v;
    }
    __syncthreads();
    for (int d = 1; d < m; d <<= 1) {  // up-sweep: left + right
      for (int q = threadIdx.x; q < m / (2 * d); q += blockDim.x) {
        const int right = (q + 1) * 2 * d - 1;
        a[right] = a[right - d] + a[right];
      }
      __syncthreads();
    }
    const A root = a[m - 1];
    __syncthreads();
    if (threadIdx.x == 0) a[m - 1] = A(0);
    __syncthreads();
    for (int d = m >> 1; d >= 1; d >>= 1) {  // down-sweep
      for (int q = threadIdx.x; q < m / (2 * d); q += blockDim.x) {
        const int right = (q + 1) * 2 * d - 1;
        const A old_left = a[right - d];
        a[right - d] = a[right];
        a[right] = a[right] + old_left;  // combine(parent, old_left)
      }
      __syncthreads();
    }
    for (int i = threadIdx.x; i < bn; i += blockDim.x) {
      const A sel = exclusive ? a[i] : a[i] + e[i];
      store(out + base + c0 + i, carry + sel);
    }
    carry = carry + root;
    __syncthreads();  // the next tile overwrites a and e
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T>
int launch_carry(const void* x, void* out, long long rows, long long n, int bn,
                 int exclusive, cudaStream_t stream) {
  using A = typename Acc<T>::type;
  const size_t smem = network_words(bn) * sizeof(A);
  cudaError_t err = allow_smem(carry_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  carry_kernel<T><<<static_cast<unsigned>(rows), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), n, bn, exclusive);
  return cudaGetLastError();
}

template <typename T>
int launch_totals(const void* x, void* totals, long long rows, long long n, int bn,
                  cudaStream_t stream) {
  using A = typename Acc<T>::type;
  const size_t smem = network_words(bn) * sizeof(A);
  cudaError_t err = allow_smem(totals_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const long long tiles = rows * (n / bn);
  totals_kernel<T><<<static_cast<unsigned>(tiles), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<A*>(totals), bn);
  return cudaGetLastError();
}

template <typename T>
int launch_apply(const void* x, const void* offsets, void* out, long long rows,
                 long long n, int bn, int exclusive, cudaStream_t stream) {
  using A = typename Acc<T>::type;
  const size_t smem = network_words(bn) * sizeof(A);
  cudaError_t err = allow_smem(apply_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const long long tiles = rows * (n / bn);
  apply_kernel<T><<<static_cast<unsigned>(tiles), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const A*>(offsets), static_cast<T*>(out),
      bn, exclusive);
  return cudaGetLastError();
}

template <typename T>
int launch_tree(const void* x, void* out, long long rows, long long n, int bn,
                int exclusive, cudaStream_t stream) {
  using A = typename Acc<T>::type;
  int m = 1;
  while (m < bn) m <<= 1;
  const size_t smem = (static_cast<size_t>(m) + bn) * sizeof(A);
  cudaError_t err = allow_smem(tree_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  tree_kernel<T><<<static_cast<unsigned>(rows), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), n, bn, m, exclusive);
  return cudaGetLastError();
}

}  // namespace

// dtype codes, as kernels/scan_engine/cuda.py numbers them:
// 0 float32, 1 bfloat16, 2 float16, 3 int32, 4 int16, 5 int8.
#define SCAN_SUM_DISPATCH(dtype, fn, ...)                      \
  switch (dtype) {                                             \
    case 0: return fn<float>(__VA_ARGS__);                     \
    case 1: return fn<__nv_bfloat16>(__VA_ARGS__);             \
    case 2: return fn<__half>(__VA_ARGS__);                    \
    case 3: return fn<int32_t>(__VA_ARGS__);                   \
    case 4: return fn<int16_t>(__VA_ARGS__);                   \
    case 5: return fn<int8_t>(__VA_ARGS__);                    \
    default: return cudaErrorInvalidValue;                     \
  }

extern "C" {

int scan_sum_carry(const void* x, void* out, long long rows, long long n, int bn,
                   int exclusive, int dtype, void* stream) {
  SCAN_SUM_DISPATCH(dtype, launch_carry, x, out, rows, n, bn, exclusive,
                    static_cast<cudaStream_t>(stream));
}

int scan_sum_totals(const void* x, void* totals, long long rows, long long n,
                    int bn, int dtype, void* stream) {
  SCAN_SUM_DISPATCH(dtype, launch_totals, x, totals, rows, n, bn,
                    static_cast<cudaStream_t>(stream));
}

// totals/offsets are float32 (is_int == 0) or int32 (is_int == 1).
int scan_sum_chain(const void* totals, void* offsets, long long rows,
                   long long chunks, int is_int, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_int) {
    chain_kernel<uint32_t><<<static_cast<unsigned>(rows), 32, 0, s>>>(
        static_cast<const uint32_t*>(totals), static_cast<uint32_t*>(offsets), chunks);
  } else {
    chain_kernel<float><<<static_cast<unsigned>(rows), 32, 0, s>>>(
        static_cast<const float*>(totals), static_cast<float*>(offsets), chunks);
  }
  return cudaGetLastError();
}

int scan_sum_apply(const void* x, const void* offsets, void* out, long long rows,
                   long long n, int bn, int exclusive, int dtype, void* stream) {
  SCAN_SUM_DISPATCH(dtype, launch_apply, x, offsets, out, rows, n, bn, exclusive,
                    static_cast<cudaStream_t>(stream));
}

int scan_sum_tree(const void* x, void* out, long long rows, long long n, int bn,
                  int exclusive, int dtype, void* stream) {
  SCAN_SUM_DISPATCH(dtype, launch_tree, x, out, rows, n, bn, exclusive,
                    static_cast<cudaStream_t>(stream));
}

const char* scan_sum_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
