// Element-monoid scan kernels of the scan engine, CUDA C++ for Hopper
// (sm_90a).
//
// One in-tile network, one chain and one set of schedule kernels, written
// once over a spec (a combine functor and a leaf tuple, the counterpart of
// the reference's KernelSpec) and a geometry, and instantiated for the
// four element specs:
//   SumSpec<T>     SUM_KERNEL            (assoc.py:202): x -> x
//   SegSumSpec<T>  SEGMENTED_SUM_KERNEL  (assoc.py:221): (value, flag); a
//                  flag on the right kills the carry, flags OR together
//   MaskSpec       mask_kernel_spec      (assoc.py:246): an int32 sum whose
//                  writeback is the fused select: inclusive - m on a kept
//                  lane, the sentinel on a dropped one
//   AffineSpec<T>  AFFINE_KERNEL         (assoc.py:236): (a, b) pairs of
//                  h' = a h + b, combined (a1 a2, a2 b1 + b2); emits b
// on the two layouts (kChan):
//   Rows      (R, N), scanned along N. A lane is a row.
//   Channels  (B, T, D), scanned along T. A lane is a strip of `width`
//             adjacent channels (<= 32) of one batch row; each channel
//             carries its own state.
//
// What each kernel replaces (Pallas TPU kernels of the reference package,
// src/repro/kernels/scan_engine/schedules.py):
//   carry_reg_kernel
//                  scan_carry, pallas_call at :335 (body _carry_body :298),
//                  with its optional running chunk totals (return_totals),
//                  for Rows tiles of 128 r elements of the sum, segmented
//                  sum and mask: the in-tile network in registers (below)
//   carry_chan_reg_kernel
//                  the same pallas_call for the affine pair on Channels
//                  tiles of 128, 256 and 512 steps: each channel's
//                  Hillis-Steele by warp shuffles, a warp two channels,
//                  the tiles staged by cp.async (below)
//   carry_kernel   the same pallas_call for every other tile: other
//                  Channels strips, Rows tiles of other lengths, the
//                  affine pair on Rows
//   totals_kernel  scan_decoupled, totals pallas_call at :390
//                  (body _totals_body :361): the affine pair on Rows and
//                  on Channels tiles of other lengths, and the sum and the
//                  segmented sum on Channels
//   totals_reduce_kernel
//                  the same pallas_call for Rows tiles of the sum and the
//                  segmented sum (every dtype) and the mask: the network's
//                  last element built as its tree, from registers, without
//                  the scan
//   totals_chan_reduce_kernel
//                  the same pallas_call for the affine pair on Channels
//                  tiles of 128, 256 and 512 steps: each channel's
//                  balanced tree over the tile's steps, a thread four
//                  channels, without the scan (below)
//   chain_seq_kernel, chain_scan_kernel
//                  exclusive_chain :248, the sequential lax.scan over the
//                  chunk totals between decoupled's two launches; it also
//                  writes offsets + totals, decoupled's running totals
//                  (schedules.py:418). On Rows, float specs fold left to
//                  right on one thread (chain_seq_kernel: its bound is the
//                  latency of a dependent combine, ~4 cycles a chunk for a
//                  float add, not bytes), integer specs, whose uint32
//                  combines associate exactly, scan in parallel
//                  (chain_scan_kernel). chain_chan_kernel: the same chain
//                  for Channels, one thread per (batch, channel), each
//                  group of four chunks' loads in flight together
//   apply_reg_kernel, apply_chan_reg_kernel, apply_kernel
//                  scan_decoupled, apply pallas_call at :405 (body
//                  _apply_body :371): the register network on the tiles
//                  carry_reg_kernel and carry_chan_reg_kernel take (on
//                  Channels carry's walk with the chain's offsets in place
//                  of the carry), the shared-memory one on the rest
//   fused_reg_kernel, fused_chan_reg_kernel, fused_kernel
//                  scan_fused, pallas_call at :527 (body _fused_body :453):
//                  decoupled in one launch, through a look-back (below);
//                  the register network on the tiles carry_reg_kernel and
//                  carry_chan_reg_kernel take, the shared-memory one on the
//                  rest
//   tree_reg_kernel, tree_chan_reg_kernel, tree_kernel
//                  scan_tree, pallas_call at :605 (body _tree_body :557,
//                  tree_scan :224, _blelloch :178): the Blelloch sweep in
//                  registers by warp shuffles on the tiles carry_reg_kernel
//                  and carry_chan_reg_kernel take (on Channels carry's
//                  walk), in shared memory on the rest
//
// Bound: device-memory bytes. A scan does one combine per element (the
// affine one three flops), so on an H100 (3.35 TB/s, 67 TFLOP/s float32
// outside the tensor cores) moving an element in and out takes ~25-100x
// longer than combining it. The design therefore touches device memory
// once per pass, with coalesced loads, and writes each result once. carry
// and tree keep the running carry on chip while one block walks its lane
// (read n + write n); decoupled reads the data twice (totals, then apply)
// to spread one lane over every SM; fused spreads it in one pass (read n +
// write n). On Rows tiles of 128 r elements of every spec but the affine
// pair, carry, apply, fused and tree run their in-tile network in
// registers from 16-byte loads (carry_reg_kernel, apply_reg_kernel,
// fused_reg_kernel, tree_reg_kernel: a warp a 128-element segment, one
// block barrier a round of segments for carry and tree, one a tile for
// apply, two for fused, no shared-memory pass over the elements); carry
// and tree keep their next rounds' loads in flight while they scan the
// current one, apply and fused keep a whole 2048-element tile's loads in
// flight in a small block; totals_reduce_kernel keeps a warp's loads in
// flight too. The affine carry, apply and tree on Channels tiles of 128,
// 256 and 512 steps (carry_chan_reg_kernel, apply_chan_reg_kernel,
// tree_chan_reg_kernel) stage each tile's `width` adjacent channels by
// cp.async, two stages deep, and run the network (the tree's sweep) in
// registers; the affine fused on the same tiles
// (fused_chan_reg_kernel) stages its one tile so, two blocks an SM
// overlapping each other's copies; the affine totals there
// (totals_chan_reduce_kernel) build each channel's tree from registers,
// a batch of steps' loads in flight. The other launches (Channels strips,
// other tile lengths, the affine pair on Rows) read a whole tile into
// shared memory (for Channels, `width` adjacent channels per time step)
// and run the network there, not pipelined (no cp.async or TMA): a block
// waits for each tile's load.
// The mask's select re-reads its element at the writeback (an L1/L2 hit:
// the tile was just loaded) in shared-memory kernels; the register ones
// keep the loaded elements.
//
// Association order. Every kernel reproduces the reference's order of
// combines exactly, so its results are bitwise equal to the reference's
// organization and to the plain PyTorch versions in
// kernels/scan_engine/schedules.py, floats included:
//   tile_scan   = schedules.tile_scan: on Rows, Hillis-Steele within
//                 128-element segments, Hillis-Steele over the segment
//                 totals, an exclusive shift, a broadcast combine;
//                 Hillis-Steele over the whole tile when it is not a
//                 multiple of 128 longer than 128. On Channels (time is not
//                 the lane axis) Hillis-Steele over the whole tile, each
//                 channel on its own. Step k computes x[i] = x[i-k] (+)
//                 x[i], and identity (+) x[i] below k, as the reference
//                 pads its shift with the identity. The register network
//                 runs the same steps, element for element, the value from
//                 below always the left operand (warp_hs4), the identity
//                 combine done (0.0f + -0.0f is +0.0f), and the broadcast
//                 combine only when a tile has more than one segment.
//   tree        = schedules._blelloch: up-sweep left (+) right, down-sweep
//                 (parent, parent (+) old_left), padded to a power of two
//                 with the identity; inclusive = excl (+) elems. The
//                 register sweep does the same combines on the same
//                 operands, the padded slots' included, from the identity
//                 at the root (tree_reg_kernel).
//   carry/chain = the carry enters every tile as the LEFT operand, and
//                 advances left to right from the identity:
//                 carry = carry (+) total.
//   fused       = the chain's own bits: chunk j's offset is the left fold
//                 ((I (+) t0) (+) t1) ... (+) t(j-1), assembled from the
//                 nearest published inclusive prefix I_k and the
//                 aggregates after it, folded LEFT TO RIGHT:
//                 I_k (+) t(k+1) (+) ... (+) t(j-1). Every I_k published
//                 is itself that fold, so the result does not depend on
//                 which k a chunk finds (see fused_kernel).
// Floats accumulate in float32 (bf16 and f16 inputs too) and integers in
// uint32, so an overflow wraps as XLA's int32 add does instead of being
// undefined behaviour. The affine combine is written with __fmul_rn and
// __fadd_rn: nvcc would otherwise contract a2 * b1 + b2 into one fused
// multiply-add, which rounds once where the plain version's eager multiply
// and add round twice. Outputs round to the input type with the
// round-to-nearest-even intrinsics, as torch's casts do. A segmented flag
// is loaded as (flag != 0) and kept in one byte of shared memory: every
// combine yields 0/1 flags in the reference too, and a value depends on a
// flag only through != 0, so no output can tell the difference; the byte
// lets a 16384-element tile of (value, flag) pairs fit the network's two
// buffers in 160 KB.
//
// Interface: plain C functions, loaded with ctypes, each taking a spec
// code (0 sum, 1 segmented sum, 2 mask, 3 affine), a dtype code and the
// geometry. Each launches on the given stream, allocates nothing (fused's
// ticket, states and published prefixes are scratch the caller zeroes),
// and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

constexpr int kThreads = 512;      // threads of every tile kernel
constexpr int kLanes = 128;        // the reference's lane width (LANES)
constexpr int kChainStage = 1024;  // totals staged per sequential chain step
constexpr int kChainThreads = 256; // the sequential chain: a folder, 7 movers
constexpr int kChainWindow = 16;   // totals the folder holds in registers
constexpr int kScanThreads = 1024; // the parallel (integer) chain, at most
constexpr int kMaxWidth = 32;      // channels of one Channels strip

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

// Four consecutive elements as float32: one 16-byte (float) or 8-byte
// (bf16, f16) load, evict-first, when kVec (p aligned to it).
template <bool kVec>
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  if constexpr (kVec) {
    const float4 w = __ldcs(reinterpret_cast<const float4*>(p));
    v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = p[j];
  }
}
__device__ __forceinline__ float half_bits(const __nv_bfloat16*, uint32_t b) {
  return __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(b)));
}
__device__ __forceinline__ float half_bits(const __half*, uint32_t b) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(b)));
}
template <bool kVec, typename H>
__device__ __forceinline__ void load4(const H* p, float (&v)[4]) {
  if constexpr (kVec) {
    const uint2 w = __ldcs(reinterpret_cast<const uint2*>(p));
    v[0] = half_bits(p, w.x & 0xffffu); v[1] = half_bits(p, w.x >> 16);
    v[2] = half_bits(p, w.y & 0xffffu); v[3] = half_bits(p, w.y >> 16);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = load_acc(p + j);
  }
}
template <typename T>
__device__ __forceinline__ bool aligned4(const T* p) {
  return (reinterpret_cast<uintptr_t>(p) & (4 * sizeof(T) - 1)) == 0;
}

// Four consecutive integers, sign-extended to uint32: one 16-byte (int32),
// 8-byte (int16) or 4-byte (int8) evict-first load when kVec.
__device__ __forceinline__ uint32_t sext16(uint32_t b) {
  return static_cast<uint32_t>(static_cast<int32_t>(b << 16) >> 16);
}
__device__ __forceinline__ uint32_t sext8(uint32_t w, int j) {
  return static_cast<uint32_t>(static_cast<int32_t>(w << (24 - 8 * j)) >> 24);
}
template <bool kVec>
__device__ __forceinline__ void load4(const int32_t* p, uint32_t (&v)[4]) {
  if constexpr (kVec) {
    const uint4 w = __ldcs(reinterpret_cast<const uint4*>(p));
    v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = load_acc(p + j);
  }
}
template <bool kVec>
__device__ __forceinline__ void load4(const int16_t* p, uint32_t (&v)[4]) {
  if constexpr (kVec) {
    const uint2 w = __ldcs(reinterpret_cast<const uint2*>(p));
    v[0] = sext16(w.x); v[1] = sext16(w.x >> 16);
    v[2] = sext16(w.y); v[3] = sext16(w.y >> 16);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = load_acc(p + j);
  }
}
template <bool kVec>
__device__ __forceinline__ void load4(const int8_t* p, uint32_t (&v)[4]) {
  if constexpr (kVec) {
    const uint32_t w = __ldcs(reinterpret_cast<const unsigned int*>(p));
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = sext8(w, j);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = load_acc(p + j);
  }
}

// Four consecutive results, rounded to the output type as store() rounds
// them: one 16-, 8- or 4-byte store when kVec (p aligned to it).
__device__ __forceinline__ uint32_t half_of(const __nv_bfloat16*, float v) {
  return __bfloat16_as_ushort(__float2bfloat16(v));
}
__device__ __forceinline__ uint32_t half_of(const __half*, float v) {
  return __half_as_ushort(__float2half(v));
}
template <bool kVec>
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  if constexpr (kVec) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) p[j] = v[j];
  }
}
template <bool kVec, typename H>
__device__ __forceinline__ void store4(H* p, const float (&v)[4]) {
  if constexpr (kVec) {
    *reinterpret_cast<uint2*>(p) =
        make_uint2(half_of(p, v[0]) | half_of(p, v[1]) << 16,
                   half_of(p, v[2]) | half_of(p, v[3]) << 16);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) store(p + j, v[j]);
  }
}
template <bool kVec>
__device__ __forceinline__ void store4(int32_t* p, const uint32_t (&v)[4]) {
  if constexpr (kVec) {
    *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) store(p + j, v[j]);
  }
}
template <bool kVec>
__device__ __forceinline__ void store4(int16_t* p, const uint32_t (&v)[4]) {
  if constexpr (kVec) {
    *reinterpret_cast<uint2*>(p) = make_uint2((v[0] & 0xffffu) | v[1] << 16,
                                              (v[2] & 0xffffu) | v[3] << 16);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) store(p + j, v[j]);
  }
}
template <bool kVec>
__device__ __forceinline__ void store4(int8_t* p, const uint32_t (&v)[4]) {
  if constexpr (kVec) {
    *reinterpret_cast<uint32_t*>(p) = (v[0] & 0xffu) | (v[1] & 0xffu) << 8 |
                                      (v[2] & 0xffu) << 16 | v[3] << 24;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) store(p + j, v[j]);
  }
}

// A chain-leaf load; kCg reads through L2 (ld.global.cg), past an L1 that
// may hold a stale line of a prefix another block has since published.
template <bool kCg, typename T>
__device__ __forceinline__ T ld(const T* p) {
  if constexpr (kCg) return __ldcg(p);
  else return *p;
}

__host__ __device__ constexpr size_t round16(size_t bytes) {
  return (bytes + 15) & ~static_cast<size_t>(15);
}

// 32-bit patterns of an accumulator, for fused's packed state words.
__device__ __forceinline__ uint32_t to_bits(float v) { return __float_as_uint(v); }
__device__ __forceinline__ uint32_t to_bits(uint32_t v) { return v; }
template <typename A> __device__ __forceinline__ A from_bits(uint32_t b);
template <> __device__ __forceinline__ float from_bits<float>(uint32_t b) {
  return __uint_as_float(b);
}
template <> __device__ __forceinline__ uint32_t from_bits<uint32_t>(uint32_t b) {
  return b;
}

// The tensors a tile kernel reads and writes; each spec uses its own.
struct Tensors {
  const void* x;  // values (sum, segmented sum), the int32 mask, affine a
  const void* y;  // the segmented sum's int32 flags, affine b
  void* out;      // the emitted output, the shape of x
  int sentinel;   // the mask's output for a dropped lane
};

// Per-leaf chain_shape tensors: totals, offsets, running totals or fused's
// published prefixes. v holds leaf 0 in the accumulation dtype, f leaf 1
// (the segmented sum's int32 flag, affine b). v == nullptr: not requested.
struct Leaves {
  void* v;
  void* f;
};

// A spec: the element E (its leaf tuple in registers), Buf (an array of E
// in shared memory, one array per leaf), the identity and combine, how an
// element is loaded and a result emitted, and how a leaf tuple is read
// from and written to Leaves. kPack: E fits in the upper 62 bits of a
// 64-bit word beside fused's 2-bit tile state (pack/unpack).

// SUM: one leaf, the running sum.
template <typename T>
struct SumSpec {
  using In = T;
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
  // Four consecutive elements from i, and their results emitted (the
  // register network; m: the elements as loaded). kVec: one vector access
  // a leaf.
  template <bool kVec>
  __device__ static void load_run(const Tensors& t, int64_t i, E (&e)[4]) {
    A v[4];
    load4<kVec>(static_cast<const T*>(t.x) + i, v);
#pragma unroll
    for (int j = 0; j < 4; ++j) e[j].v = v[j];
  }
  template <bool kVec>
  __device__ static void emit_run(const Tensors& t, int64_t i, const E (&c)[4],
                                  const E (&)[4]) {
    A v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = c[j].v;
    store4<kVec>(static_cast<T*>(t.out) + i, v);
  }
  template <bool kCg = false>
  __device__ static E get(const Leaves& g, int64_t i) {
    return {ld<kCg>(static_cast<const A*>(g.v) + i)};
  }
  __device__ static void put(const Leaves& g, int64_t i, E e) {
    static_cast<A*>(g.v)[i] = e.v;
  }
  // uint32 sums wrap: associative bit for bit, so the chain may scan
  static constexpr bool kExact = std::is_same<A, uint32_t>::value;
  // Rows totals take totals_reduce_kernel (one value a tile, no scan)
  static constexpr bool kReduce = true;
  // Rows tiles of 128 r elements take the register network
  static constexpr bool kReg = true;
  static constexpr bool kChanReg = false;   // Channels keep the shared one
  static constexpr bool kPack = true;
  __device__ static uint64_t pack(E e) {
    return static_cast<uint64_t>(to_bits(e.v)) << 32;
  }
  __device__ static E unpack(uint64_t w) {
    return {from_bits<A>(static_cast<uint32_t>(w >> 32))};
  }
};

// SEGMENTED SUM: (value, flag). A flag on the right restarts the value;
// flags combine as an OR of != 0.
template <typename T>
struct SegSumSpec {
  using In = T;
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
    return {load_acc(static_cast<const T*>(t.x) + i),
            static_cast<const int32_t*>(t.y)[i] != 0 ? 1u : 0u};
  }
  __device__ static void emit(const Tensors& t, int64_t i, E c) {
    store(static_cast<T*>(t.out) + i, c.v);
  }
  template <bool kVec>
  __device__ static void load_run(const Tensors& t, int64_t i, E (&e)[4]) {
    A v[4];
    uint32_t f[4];
    load4<kVec>(static_cast<const T*>(t.x) + i, v);
    load4<kVec>(static_cast<const int32_t*>(t.y) + i, f);
#pragma unroll
    for (int j = 0; j < 4; ++j) e[j] = {v[j], f[j] != 0u ? 1u : 0u};
  }
  template <bool kVec>
  __device__ static void emit_run(const Tensors& t, int64_t i, const E (&c)[4],
                                  const E (&)[4]) {
    A v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = c[j].v;
    store4<kVec>(static_cast<T*>(t.out) + i, v);
  }
  template <bool kCg = false>
  __device__ static E get(const Leaves& g, int64_t i) {
    return {ld<kCg>(static_cast<const A*>(g.v) + i),
            static_cast<uint32_t>(ld<kCg>(static_cast<const int32_t*>(g.f) + i))};
  }
  __device__ static void put(const Leaves& g, int64_t i, E e) {
    static_cast<A*>(g.v)[i] = e.v;
    static_cast<int32_t*>(g.f)[i] = static_cast<int32_t>(e.f);
  }
  static constexpr bool kExact = std::is_same<A, uint32_t>::value;
  static constexpr bool kReduce = true;   // Rows totals: totals_reduce_kernel
  static constexpr bool kReg = true;
  static constexpr bool kChanReg = false;
  static constexpr bool kPack = true;  // the value, and the flag in bit 2
  __device__ static uint64_t pack(E e) {
    return (static_cast<uint64_t>(to_bits(e.v)) << 32) |
           (static_cast<uint64_t>(e.f) << 2);
  }
  __device__ static E unpack(uint64_t w) {
    return {from_bits<A>(static_cast<uint32_t>(w >> 32)),
            static_cast<uint32_t>((w >> 2) & 1u)};
  }
};

// MASK: the int32 sum with the fused predicate select as its writeback.
struct MaskSpec : SumSpec<int32_t> {
  __device__ static void emit(const Tensors& t, int64_t i, E c) {
    const int32_t m = static_cast<const int32_t*>(t.x)[i];
    static_cast<int32_t*>(t.out)[i] =
        m != 0 ? static_cast<int32_t>(c.v - static_cast<uint32_t>(m)) : t.sentinel;
  }
  template <bool kVec>
  __device__ static void emit_run(const Tensors& t, int64_t i, const E (&c)[4],
                                  const E (&m)[4]) {
    uint32_t v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = m[j].v != 0u ? c[j].v - m[j].v : static_cast<uint32_t>(t.sentinel);
    store4<kVec>(static_cast<int32_t*>(t.out) + i, v);
  }
};

// AFFINE: (a, b) in float32, the earlier element on the left; the output
// is the b leaf in T. Rounded multiply and add, never contracted.
template <typename T>
struct AffineSpec {
  using In = T;
  struct E { float a, b; };
  struct Buf {
    float* a;
    float* b;
    __device__ E get(int i) const { return {a[i], b[i]}; }
    __device__ void set(int i, E e) const {
      a[i] = e.a;
      b[i] = e.b;
    }
  };
  __host__ __device__ static size_t buf_bytes(int count) {
    return 2 * round16(static_cast<size_t>(count) * sizeof(float));
  }
  __device__ static Buf carve(unsigned char*& p, int count) {
    Buf b;
    b.a = reinterpret_cast<float*>(p);
    p += round16(static_cast<size_t>(count) * sizeof(float));
    b.b = reinterpret_cast<float*>(p);
    p += round16(static_cast<size_t>(count) * sizeof(float));
    return b;
  }
  __device__ static E identity() { return {1.0f, 0.0f}; }
  __device__ static E combine(E l, E r) {
    return {__fmul_rn(l.a, r.a), __fadd_rn(__fmul_rn(r.a, l.b), r.b)};
  }
  __device__ static E load(const Tensors& t, int64_t i) {
    return {load_acc(static_cast<const T*>(t.x) + i),
            load_acc(static_cast<const T*>(t.y) + i)};
  }
  __device__ static void emit(const Tensors& t, int64_t i, E c) {
    store(static_cast<T*>(t.out) + i, c.b);
  }
  template <bool kCg = false>
  __device__ static E get(const Leaves& g, int64_t i) {
    return {ld<kCg>(static_cast<const float*>(g.v) + i),
            ld<kCg>(static_cast<const float*>(g.f) + i)};
  }
  __device__ static void put(const Leaves& g, int64_t i, E e) {
    static_cast<float*>(g.v)[i] = e.a;
    static_cast<float*>(g.f)[i] = e.b;
  }
  static constexpr bool kExact = false;
  static constexpr bool kReduce = false;
  static constexpr bool kReg = false;   // its wrappers lay it out on Channels
  // carry, apply, fused and tree on Channels tiles of 128, 256 and 512
  // steps run in registers, and the totals there are a reduction
  static constexpr bool kChanReg = true;
  static constexpr bool kPack = false;  // 64 bits of payload
  __device__ static uint64_t pack(E) { return 0; }
  __device__ static E unpack(uint64_t) { return identity(); }
};

// Where a lane's tiles live. Rows: lane = row, positions contiguous (the
// kernels take d = width = strips = 1 as constants). Channels: lane =
// (batch row, strip s of `width` channels); position p of channel w lies
// at row * n * d + p * d + s * width + w, and its chunk-c chain entry at
// row * chunks * d + c * d + s * width + w. Inside a tile, element
// e = i * width + w holds position i of channel w. Tiles are numbered
// lane-major, and there are fewer than 2^31 of them (the wrapper checks),
// so lane and chunk indices take 32-bit arithmetic.
struct Geom {
  int64_t n;        // scanned length (N or T)
  int64_t d;        // elements between consecutive positions (1 or D)
  int64_t chunks;   // tiles per lane, n / bn
  uint32_t strips;  // strips per batch row (1 or D / width)
  int width;        // channels per strip (1 for Rows)
  int bn;           // tile length along the scan
};

// A lane's first element and first chain entry (channel 0).
template <bool kChan>
__device__ __forceinline__ int64_t data_base(const Geom& g, uint32_t lane) {
  if (!kChan) return lane * g.n;
  return (lane / g.strips) * g.n * g.d + (lane % g.strips) * g.width;
}
template <bool kChan>
__device__ __forceinline__ int64_t chain_base(const Geom& g, uint32_t lane) {
  if (!kChan) return lane * g.chunks;
  return (lane / g.strips) * g.chunks * g.d + (lane % g.strips) * g.width;
}

// Tile `tile`'s first element and chain entry (channel 0); on Rows no
// division at all: a row's tiles follow each other.
template <bool kChan>
__device__ __forceinline__ void tile_at(const Geom& g, uint32_t tile,
                                        int64_t& data, int64_t& chain) {
  if (!kChan) {
    data = static_cast<int64_t>(tile) * g.bn;
    chain = tile;
    return;
  }
  const uint32_t chunks = static_cast<uint32_t>(g.chunks);
  const uint32_t lane = tile / chunks, j = tile % chunks;
  data = data_base<true>(g, lane) + static_cast<int64_t>(j) * g.bn * g.d;
  chain = chain_base<true>(g, lane) + static_cast<int64_t>(j) * g.d;
}

template <bool kChan> __device__ __forceinline__ int width_of(const Geom& g) {
  return kChan ? g.width : 1;
}
template <bool kChan> __device__ __forceinline__ int64_t stride_of(const Geom& g) {
  return kChan ? g.d : 1;
}
// log2 of the strip width, a power of two: tile element e holds position
// e >> shift of channel e & (w - 1), with no division in the loops.
template <bool kChan> __device__ __forceinline__ int shift_of(int w) {
  return kChan ? __ffs(w) - 1 : 0;
}

// In-tile inclusive scan of x[0, bn * w) (see "Association order" above).
// Every step reads one buffer and writes the other, with a barrier
// between steps; returns the buffer that holds the result. tx/ty hold the
// segment totals of the Rows split. Ends with a barrier, so the result is
// visible to all.
template <typename S, bool kChan>
__device__ typename S::Buf tile_scan(typename S::Buf x, typename S::Buf y,
                                     typename S::Buf tx, typename S::Buf ty,
                                     int bn, int w) {
  using E = typename S::E;
  using Buf = typename S::Buf;
  if (!kChan) w = 1;  // a constant for Rows
  const int m = bn * w, ws = shift_of<kChan>(w);
  const int seg = (!kChan && bn > kLanes && bn % kLanes == 0) ? kLanes : bn;
  for (int k = 1; k < seg; k <<= 1) {
    for (int e = threadIdx.x; e < m; e += blockDim.x) {
      // the position within its segment (Channels: the whole tile)
      const int i = kChan ? e >> ws : e % seg;
      const E left = i >= k ? x.get(e - k * w) : S::identity();
      y.set(e, S::combine(left, x.get(e)));
    }
    __syncthreads();
    const Buf t = x; x = y; y = t;
  }
  if (seg == bn) return x;
  const int r = bn / seg;  // Rows only from here on: w == 1
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

// Shared memory of one tile network: two tile buffers, two totals buffers
// and one element per channel of the strip (the carry or the offset). The
// register network takes none of it: its segment totals and fused's
// look-back stack are static shared memory, at most 6 KB.
template <typename S>
size_t network_bytes(int bn, int w) {
  return 2 * S::buf_bytes(bn * w) + 2 * S::buf_bytes(bn / kLanes + 1) +
         S::buf_bytes(kMaxWidth);
}

template <typename S, bool kChan>
struct Network {
  typename S::Buf x, y, tx, ty, lane;
  int bn, w;
  __device__ Network(unsigned char* smem, int bn_, int w_) : bn(bn_), w(w_) {
    unsigned char* p = smem;
    x = S::carve(p, bn * w);
    y = S::carve(p, bn * w);
    tx = S::carve(p, bn / kLanes + 1);
    ty = S::carve(p, bn / kLanes + 1);
    lane = S::carve(p, kMaxWidth);
  }
  __device__ typename S::Buf scan() {
    return tile_scan<S, kChan>(x, y, tx, ty, bn, w);
  }
  // channel c's element at the tile's last position
  __device__ typename S::E last(const typename S::Buf& s, int c) const {
    return s.get((bn - 1) * w + c);
  }
};

template <typename S, bool kChan>
__device__ void load_tile(const Tensors& t, const Geom& g, int64_t base,
                          typename S::Buf dst, int bn, int w) {
  const int64_t d = stride_of<kChan>(g);
  const int ws = shift_of<kChan>(w);
  for (int e = threadIdx.x; e < bn * w; e += blockDim.x)
    dst.set(e, S::load(t, base + (e >> ws) * d + (e & (w - 1))));
  __syncthreads();
}

// Emits left[c] (+) (exclusive ? s shifted one step right with the
// identity : s), channel c's offset as the EARLIER operand.
template <typename S, bool kChan>
__device__ void store_tile(const Tensors& t, const Geom& g, int64_t base,
                           typename S::Buf s, typename S::Buf left, int bn,
                           int w, int exclusive) {
  const int64_t d = stride_of<kChan>(g);
  const int ws = shift_of<kChan>(w);
  const typename S::E row_left = left.get(0);  // Rows: one offset per tile
  for (int e = threadIdx.x; e < bn * w; e += blockDim.x) {
    const int i = e >> ws, c = e & (w - 1);
    const typename S::E sel =
        exclusive ? (i > 0 ? s.get(e - w) : S::identity()) : s.get(e);
    S::emit(t, base + i * d + c, S::combine(kChan ? left.get(c) : row_left, sel));
  }
}

// carry: one block per lane walks the lane's chunks in order, the carry of
// each channel in shared memory; with running totals, the carry is written
// after each chunk.
template <typename S, bool kChan>
__global__ void __launch_bounds__(kThreads)
carry_kernel(Tensors t, Leaves running, Geom g, int exclusive) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int w = width_of<kChan>(g);
  const int64_t d = stride_of<kChan>(g);
  Network<S, kChan> net(smem, g.bn, w);
  const int64_t base = data_base<kChan>(g, blockIdx.x);
  const int64_t cbase = chain_base<kChan>(g, blockIdx.x);
  for (int c = threadIdx.x; c < w; c += blockDim.x) net.lane.set(c, S::identity());
  for (int64_t j = 0; j < g.chunks; ++j) {
    const int64_t tile = base + j * g.bn * d;
    load_tile<S, kChan>(t, g, tile, net.x, g.bn, w);
    const typename S::Buf s = net.scan();
    store_tile<S, kChan>(t, g, tile, s, net.lane, g.bn, w, exclusive);
    __syncthreads();  // every read of the carry is done
    for (int c = threadIdx.x; c < w; c += blockDim.x) {
      const typename S::E carry = S::combine(net.lane.get(c), net.last(s, c));
      net.lane.set(c, carry);
      if (running.v != nullptr) S::put(running, cbase + j * d + c, carry);
    }
    __syncthreads();  // the next tile overwrites s
  }
}

// totals: one block per (lane, chunk) tile writes the LAST element of the
// same network, so the chain below reproduces carry's combines.
template <typename S, bool kChan>
__global__ void __launch_bounds__(kThreads)
totals_kernel(Tensors t, Leaves totals, Geom g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int w = width_of<kChan>(g);
  Network<S, kChan> net(smem, g.bn, w);
  int64_t tile, chain;
  tile_at<kChan>(g, blockIdx.x, tile, chain);
  load_tile<S, kChan>(t, g, tile, net.x, g.bn, w);
  const typename S::Buf s = net.scan();
  for (int c = threadIdx.x; c < w; c += blockDim.x)
    S::put(totals, chain + c, net.last(s, c));
}

// A warp shuffle of an element of any spec, word by word: from lane src,
// and from lane l ^ mask.
template <typename E>
__device__ __forceinline__ E shfl_e(E x, int src) {
  uint32_t w[sizeof(E) / 4];
  memcpy(w, &x, sizeof(E));
#pragma unroll
  for (int i = 0; i < static_cast<int>(sizeof(E) / 4); ++i)
    w[i] = __shfl_sync(0xffffffffu, w[i], src);
  memcpy(&x, w, sizeof(E));
  return x;
}

template <typename E>
__device__ __forceinline__ E shfl_xor_e(E x, int mask) {
  uint32_t w[sizeof(E) / 4];
  memcpy(w, &x, sizeof(E));
#pragma unroll
  for (int i = 0; i < static_cast<int>(sizeof(E) / 4); ++i)
    w[i] = __shfl_xor_sync(0xffffffffu, w[i], mask);
  memcpy(&x, w, sizeof(E));
  return x;
}

// totals, reduced: Rows tiles of the sum (every dtype), the segmented sum
// (every dtype) and the mask. The same totals as totals_kernel's, without
// the scan: the last element of tile_scan is a fixed tree of the tile's
// elements, so it is built directly, from registers.
//   bn > 128 and bn % 128 == 0: each 128-element segment's total t_q is
//     the balanced tree over its elements (Hillis-Steele's last element of
//     a power-of-two run never meets the identity); the tile's total is
//     the Hillis-Steele value at r - 2 over the r segment totals -- the
//     balanced tree over the 2^ceil(log2 r) slots ending at t_{r-2}, the
//     identity in the slots below t_0 -- combined with t_{r-1} on the
//     right (the broadcast combine of the last segment);
//   otherwise: the balanced tree over the 2^ceil(log2 bn) slots ending
//     at element bn - 1, identity-padded below element 0.
// An identity slot gives the network's bits: I (+) I = I, and I (+) y is
// the network's own identity combine (0.0f + -0.0f is +0.0f). The
// segmented sum does not commute (a flag on the right kills the left
// value), so every combine keeps the earlier subtree on the left: an
// xor-shuffle butterfly builds the balanced tree over the lanes in order,
// each lane of a pair combining the lower lane's subtree with the upper's
// (xor_combine); a lane's run of 4 elements (one 16-byte float or 8-byte
// half load, and for the segmented sum a 16-byte load of its flags) is its
// own subtree. A tree above 128 slots (the segment totals, or 128-slot
// groups) is built the same way once each total is moved to the lane that
// holds its slot (SlotTree). Integer sums wrap in uint32, which is
// associative and commutative bit for bit: any order gives the bits, so
// 16-byte loads (a scalar head and tail around them) and
// __reduce_add_sync; the integer segmented sum, associative but not
// commutative, takes the tree.
// Bound: device-memory bytes, read n (and n flags) and write one element a
// tile. One warp reduces a tile, tiles strided over a grid that fills the
// card; a lane issues the loads of kReduceBatch segments (8 KB a warp at
// bn 2048 of float32, 16 KB with the flags) or kReduceVecs 16-byte words
// (integer sum) before it combines any, with evict-first hints (each byte
// is read once). The 16 segments of a batch share one halving butterfly:
// 16 shuffles a word for 16 totals, not 80. No shared memory, no block
// barrier.
constexpr int kReduceThreads = 256;  // 8 warps, a tile each at a time
constexpr int kReduceBatch = 16;     // segments loaded ahead (tree)
constexpr int kReduceVecs = 16;      // integer 16-byte loads ahead

// The balanced tree over a lane's k (1, 2 or 4) slots.
template <typename S>
__device__ __forceinline__ typename S::E run_tree(const typename S::E (&v)[4],
                                                  int k) {
  return k == 4 ? S::combine(S::combine(v[0], v[1]), S::combine(v[2], v[3]))
         : k == 2 ? S::combine(v[0], v[1])
                  : v[0];
}

// Lane l's subtree combined with lane l ^ o's, in both lanes: the lower
// lane's subtree (the earlier elements) on the left.
template <typename S>
__device__ __forceinline__ typename S::E xor_combine(typename S::E v, int o,
                                                     int lane) {
  const typename S::E p = shfl_xor_e(v, o);
  return (lane & o) ? S::combine(p, v) : S::combine(v, p);
}

// The balanced tree over the first `lanes` (a power of two) lanes' values,
// in each of them.
template <typename S>
__device__ __forceinline__ typename S::E lanes_tree(typename S::E v,
                                                    int lanes, int lane) {
  for (int o = 1; o < lanes; o <<= 1) v = xor_combine<S>(v, o, lane);
  return v;
}

// One step of the batch butterfly: lanes at offset 8 / kHalf exchange
// halves of their kHalf * 2 partial totals; the lower lane keeps the lower
// half, the upper lane the upper, each combined with the partner's copy,
// the lower lane's (earlier) part on the left.
template <typename S, int kHalf>
__device__ __forceinline__ void halve(typename S::E (&a)[kReduceBatch],
                                      int lane) {
  using E = typename S::E;
  const bool up = lane & (8 / kHalf);
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const E send = up ? a[i] : a[i + kHalf];
    const E keep = up ? a[i + kHalf] : a[i];
    const E recv = shfl_xor_e(send, 8 / kHalf);
    a[i] = up ? S::combine(recv, keep) : S::combine(keep, recv);
  }
}

// The lane (and that lane + 16) where batch_tree leaves segment u's total.
__device__ __forceinline__ int batch_lane(int u) {
  return __brev(static_cast<unsigned>(u)) >> 28;
}

// The totals of a batch of 16 segments, segment u in lane batch_lane(u):
// each 4-element run's tree, then the halving butterfly at offsets 1, 2,
// 4 and 8 and a last combine at offset 16 -- the tree over each segment's
// 32 runs in order.
template <typename S>
__device__ __forceinline__ typename S::E batch_tree(
    const typename S::E (&v)[kReduceBatch][4], int lane) {
  typename S::E a[kReduceBatch];
#pragma unroll
  for (int u = 0; u < kReduceBatch; ++u) a[u] = run_tree<S>(v[u], 4);
  halve<S, 8>(a, lane);
  halve<S, 4>(a, lane);
  halve<S, 2>(a, lane);
  halve<S, 1>(a, lane);
  return xor_combine<S>(a[0], 16, lane);
}

// A window of up to 128 slots (a power of two) over the warp, in order:
// lane l holds slots [l k, l k + k) (k = 1, 2 or 4) of the first `lanes`
// lanes; a slot never set holds the identity. total() is the balanced
// tree over the window, in lane 0.
template <typename S>
struct SlotTree {
  typename S::E v[4];
  int lanes, k, first, lane;
  __device__ SlotTree(int window, int lane_)
      : lanes(window < 32 ? window : 32), k(window / lanes),
        first(lane_ * k), lane(lane_) {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = S::identity();
  }
  __device__ void set(int s, typename S::E t) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < k && s == first + j) v[j] = t;
  }
  __device__ typename S::E total() const {
    return lanes_tree<S>(run_tree<S>(v, k), lanes, lane);
  }
};

__device__ __forceinline__ int pow2_at_least(int n) {
  int m = 1;
  while (m < n) m <<= 1;
  return m;
}

// Whether the four elements from element i take vector loads: the values
// aligned to four elements and the segmented flags (where there are any)
// to 16 bytes.
template <typename S>
__device__ __forceinline__ bool runs_at(const Tensors& t, int64_t i) {
  return aligned4(static_cast<const typename S::In*>(t.x) + i) &&
         (t.y == nullptr || aligned4(static_cast<const int32_t*>(t.y) + i));
}

// A lane-divisible tile's total from element p, in lane 0: r segments,
// their totals t_0 .. t_{r-2} into the slots pad .. of the window tree,
// t_{r-1} kept apart.
template <typename S, bool kVec>
__device__ __forceinline__ typename S::E segmented_total(const Tensors& t,
                                                         int64_t p, int r,
                                                         int lane) {
  using E = typename S::E;
  const int window = pow2_at_least(r), pad = window - (r - 1);
  SlotTree<S> upper(window, lane);
  E last = S::identity();
  for (int q0 = 0; q0 < r; q0 += kReduceBatch) {
    E v[kReduceBatch][4];
#pragma unroll
    for (int u = 0; u < kReduceBatch; ++u) {
      if (q0 + u < r) {
        S::template load_run<kVec>(t, p + (q0 + u) * kLanes + 4 * lane, v[u]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) v[u][j] = S::identity();
      }
    }
    const E tt = batch_tree<S>(v, lane);
    // the segments of this batch whose slots this lane holds
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j < upper.k) {   // uniform: every lane shuffles
        const int q = upper.first + j - pad;
        const E tq = shfl_e(tt, batch_lane((q - q0) & 15));
        if (q >= q0 && q < q0 + kReduceBatch && q < r - 1) upper.set(q + pad, tq);
      }
    }
    if (r - 1 < q0 + kReduceBatch)
      last = shfl_e(tt, batch_lane((r - 1 - q0) & 15));
  }
  return S::combine(upper.total(), last);
}

// The total of the tile of bn elements from element p, in lane 0, as a
// tree of combines (see above).
template <typename S>
__device__ typename S::E tile_total_tree(const Tensors& t, int64_t p, int bn,
                                         int lane) {
  using E = typename S::E;
  if (bn > kLanes && bn % kLanes == 0) {
    const int r = bn / kLanes;
    return runs_at<S>(t, p) ? segmented_total<S, true>(t, p, r, lane)
                            : segmented_total<S, false>(t, p, r, lane);
  }
  // groups of up to 128 slots, k slots a lane over `lanes` lanes, and the
  // window tree over the groups' totals
  const int window = pow2_at_least(bn), pad = window - bn;
  const int group = window < kLanes ? window : kLanes;
  const int lanes = group < 32 ? group : 32, k = group / lanes;
  SlotTree<S> upper(window / group, lane);
  for (int g0 = 0; g0 < window; g0 += group) {  // uniform: every lane shuffles
    E v[4];
    const int e0 = g0 + lane * k - pad;  // the element of the lane's first slot
    if (lane < lanes && k == 4 && e0 >= 0) {
      if (runs_at<S>(t, p + e0)) S::template load_run<true>(t, p + e0, v);
      else S::template load_run<false>(t, p + e0, v);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = lane < lanes && j < k && e0 + j >= 0 ? S::load(t, p + e0 + j)
                                                    : S::identity();
    }
    upper.set(g0 / group, lanes_tree<S>(run_tree<S>(v, k), lanes, lane));
  }
  return upper.total();
}

// The sign-extended sum of the elements of a 16-byte word, wrapping.
template <typename T> __device__ __forceinline__ uint32_t word_sum(uint32_t w);
template <> __device__ __forceinline__ uint32_t word_sum<int32_t>(uint32_t w) {
  return w;
}
template <> __device__ __forceinline__ uint32_t word_sum<int16_t>(uint32_t w) {
  return static_cast<uint32_t>(static_cast<int32_t>(w << 16) >> 16) +
         static_cast<uint32_t>(static_cast<int32_t>(w) >> 16);
}
template <> __device__ __forceinline__ uint32_t word_sum<int8_t>(uint32_t w) {
  const int32_t s = static_cast<int32_t>(w);
  return static_cast<uint32_t>((s << 24) >> 24) +
         static_cast<uint32_t>((s << 16) >> 24) +
         static_cast<uint32_t>((s << 8) >> 24) + static_cast<uint32_t>(s >> 24);
}
template <typename T>
__device__ __forceinline__ uint32_t vec_sum(uint4 w) {
  return word_sum<T>(w.x) + word_sum<T>(w.y) + word_sum<T>(w.z) +
         word_sum<T>(w.w);
}

// An integer tile's total, in every lane: scalar loads up to the first
// 16-byte boundary and after the last, 16-byte loads between.
template <typename T>
__device__ uint32_t tile_total_int(const T* p, int bn, int lane) {
  constexpr int V = 16 / sizeof(T);
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15) /
                  static_cast<int>(sizeof(T));
  const int head = min(bn, (V - mis) % V);
  const int nvec = (bn - head) / V;
  const int tail = head + nvec * V;
  uint32_t acc = 0u;
  if (lane < head) acc += load_acc(p + lane);
  if (lane < bn - tail) acc += load_acc(p + tail + lane);
  const uint4* w = reinterpret_cast<const uint4*>(p + head);
  int i = lane;
  // whole rounds of kReduceVecs loads, unpredicated, so all are in flight
  for (; i + 32 * (kReduceVecs - 1) < nvec; i += 32 * kReduceVecs) {
    uint4 v[kReduceVecs];
#pragma unroll
    for (int u = 0; u < kReduceVecs; ++u) v[u] = __ldcs(w + i + 32 * u);
#pragma unroll
    for (int u = 0; u < kReduceVecs; ++u) acc += vec_sum<T>(v[u]);
  }
  for (; i < nvec; i += 32) acc += vec_sum<T>(__ldcs(w + i));
  return __reduce_add_sync(0xffffffffu, acc);
}

template <typename S>
__global__ void __launch_bounds__(kReduceThreads)
totals_reduce_kernel(Tensors t, Leaves totals, int64_t tiles, int bn) {
  using T = typename S::In;
  using E = typename S::E;
  constexpr int kWarps = kReduceThreads / 32;
  // the integer sum and the mask: one leaf that wraps, any order
  constexpr bool kAnyOrder =
      S::kExact && std::is_same<E, typename SumSpec<T>::E>::value;
  const int lane = threadIdx.x % 32;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t tile = static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32;
       tile < tiles; tile += stride) {
    E total;
    if constexpr (kAnyOrder)
      total.v = tile_total_int(static_cast<const T*>(t.x) + tile * bn, bn, lane);
    else
      total = tile_total_tree<S>(t, tile * bn, bn, lane);
    if (lane == 0) S::put(totals, tile, total);
  }
}

// totals, reduced, on Channels: the affine pair (kChanReg) on tiles of
// BT = 128, 256 or 512 steps. The same totals as totals_kernel's, without
// the scan: on Channels tile_scan is Hillis-Steele along time over the
// whole tile, and its last element over a power-of-two tile is the
// balanced binary tree over the tile's BT steps, which never meets the
// identity (schedules.totals_tree_plain); every combine takes the EARLIER
// subtree as its left operand.
//   * a thread owns V adjacent channels of one (batch row, chunk) tile: V =
//     4 from bases aligned to four elements with D a multiple of 4 (16-byte
//     float32 or 8-byte half loads), else 1 (scalar loads); the warp's
//     loads of a time step are coalesced across its channels, 512 (or 128)
//     bytes a leaf;
//   * it walks the tile's steps in batches of kChanReduceBatch, issuing a
//     batch's loads (evict-first: each byte is read once) before it
//     combines the batch before, builds each batch's subtree in registers
//     and merges it with the pending subtrees of equal size, a binary
//     counter over the batches; the loops unroll over the compile-time BT,
//     so every index is static and the stack lives in registers.
// Bound: device-memory bytes, read 2 n and write two words a (tile,
// channel). No shared memory, no barrier; a thread a (tile, channel
// group), the grid over every tile.
constexpr int kChanReduceThreads = 128;
constexpr int kChanReduceBatch = 8;   // steps loaded before any is combined

// Loops, not recursion: after unrolling m is a constant, and a loop over
// constants folds away.
__host__ __device__ constexpr int log2_of(int n) {
  int k = 0;
  for (; n > 1; n >>= 1) ++k;
  return k;
}
__host__ __device__ constexpr int trailing_ones(int m) {
  int k = 0;
  for (; m & 1; m >>= 1) ++k;
  return k;
}

// V consecutive elements of a leaf as float32: one vector load for V = 4.
template <int V, typename T>
__device__ __forceinline__ void load_run(const T* p, float (&v)[V]) {
  if constexpr (V == 4) load4<true>(p, v);
  else v[0] = load_acc(p);
}

template <typename T, int BT, int V>
__global__ void __launch_bounds__(kChanReduceThreads)
totals_chan_reduce_kernel(Tensors t, Leaves totals, int64_t groups,
                          int64_t items, int64_t d) {
  using S = AffineSpec<T>;
  using P = typename S::E;
  constexpr int kBatch = kChanReduceBatch, kBatches = BT / kBatch;
  constexpr int kLevels = log2_of(kBatches);   // pending subtrees at most
  static_assert(BT % kBatch == 0 && (kBatches & (kBatches - 1)) == 0,
                "a power-of-two number of batches");
  const int64_t id = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (id >= items) return;
  // tile (batch row, chunk) in row-major order: its data lie at tile BT d,
  // its chain entries at tile d
  const int64_t tile = id / groups, c = (id - tile * groups) * V;
  const T* pa = static_cast<const T*>(t.x) + tile * BT * d + c;
  const T* pb = static_cast<const T*>(t.y) + tile * BT * d + c;
  auto load = [&](int m, P (&v)[kBatch][V]) {
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      float a[V], b[V];
      load_run<V>(pa + (m * kBatch + u) * d, a);
      load_run<V>(pb + (m * kBatch + u) * d, b);
#pragma unroll
      for (int w = 0; w < V; ++w) v[u][w] = {a[w], b[w]};
    }
  };
  P stack[kLevels > 0 ? kLevels : 1][V];   // stack[j]: 2^j batches
  P cur[kBatch][V], next[kBatch][V];
  load(0, cur);
#pragma unroll
  for (int m = 0; m < kBatches; ++m) {
    if (m + 1 < kBatches) load(m + 1, next);
    // the batch's balanced subtree, into cur[0]
#pragma unroll
    for (int h = 1; h < kBatch; h <<= 1)
#pragma unroll
      for (int u = 0; u < kBatch; u += 2 * h)
#pragma unroll
        for (int w = 0; w < V; ++w) cur[u][w] = S::combine(cur[u][w], cur[u + h][w]);
    // batch m closes one subtree at each of its trailing one bits
    const int ones = trailing_ones(m);
#pragma unroll
    for (int j = 0; j < kLevels; ++j)
      if (j < ones)
#pragma unroll
        for (int w = 0; w < V; ++w) cur[0][w] = S::combine(stack[j][w], cur[0][w]);
#pragma unroll
    for (int j = 0; j < kLevels; ++j)
      if (j == ones)
#pragma unroll
        for (int w = 0; w < V; ++w) stack[j][w] = cur[0][w];
    if (m + 1 < kBatches) {
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
#pragma unroll
        for (int w = 0; w < V; ++w) cur[u][w] = next[u][w];
    }
  }
  // the last batch closed the root (kBatches - 1 is all ones)
  if constexpr (V == 4) {
    float* va = static_cast<float*>(totals.v) + tile * d + c;
    float* vb = static_cast<float*>(totals.f) + tile * d + c;
    *reinterpret_cast<float4*>(va) =
        make_float4(cur[0][0].a, cur[0][1].a, cur[0][2].a, cur[0][3].a);
    *reinterpret_cast<float4*>(vb) =
        make_float4(cur[0][0].b, cur[0][1].b, cur[0][2].b, cur[0][3].b);
  } else {
    S::put(totals, tile * d + c, cur[0][0]);
  }
}

// 16-byte shared-memory copies of a run of elements between shared memory
// and registers (dst or src 16-byte aligned): a quarter or half of the
// instructions of element-wise accesses.
template <typename E, int N>
__device__ __forceinline__ void lds_vec(E (&dst)[N], const E* src) {
  static_assert(N * sizeof(E) % 16 == 0, "whole 16-byte words");
#pragma unroll
  for (int k = 0; k < static_cast<int>(N * sizeof(E) / 16); ++k) {
    const uint4 w = reinterpret_cast<const uint4*>(src)[k];
    memcpy(reinterpret_cast<char*>(dst) + 16 * k, &w, 16);
  }
}
template <typename E, int N>
__device__ __forceinline__ void sts_vec(E* dst, const E (&src)[N]) {
  static_assert(N * sizeof(E) % 16 == 0, "whole 16-byte words");
#pragma unroll
  for (int k = 0; k < static_cast<int>(N * sizeof(E) / 16); ++k) {
    uint4 w;
    memcpy(&w, reinterpret_cast<const char*>(src) + 16 * k, 16);
    reinterpret_cast<uint4*>(dst)[k] = w;
  }
}

// chain (Rows), for specs whose combine is not associative bit for bit
// (float sums, the affine pair): one block per row. Thread 0 alone runs
// the sequential exclusive chain, left to right from the identity, in
// lax.scan's order; the block's other warps bring the totals into shared
// memory a stage ahead of it and write the offsets and running totals a
// stage behind it, so that it waits on nothing but its own combines: it
// reads the totals kChainWindow ahead into registers (past the latency of
// shared memory; the stage buffer has kChainWindow elements of slack, so
// the reads past a stage's end need no test) and moves them 16 bytes an
// instruction. It keeps the inclusive carries inc: offset j is inc[j - 1]
// (the stage's incoming carry at j = 0) and the running total j is
// inc[j], the very combine offset (+) total that made it, so the same
// bits.
template <typename S>
__device__ __forceinline__ void fold_stage(const typename S::E* t,
                                           typename S::E* inc, int w,
                                           typename S::E& acc) {
  using E = typename S::E;
  E win[kChainWindow];
  lds_vec(win, t);
  int i = 0;
  for (; i + kChainWindow <= w; i += kChainWindow) {
    E next[kChainWindow], out[kChainWindow];
    lds_vec(next, t + i + kChainWindow);
#pragma unroll
    for (int j = 0; j < kChainWindow; ++j) {
      acc = S::combine(acc, win[j]);
      out[j] = acc;
    }
    sts_vec(inc + i, out);
#pragma unroll
    for (int j = 0; j < kChainWindow; ++j) win[j] = next[j];
  }
  for (; i < w; ++i) {
    acc = S::combine(acc, t[i]);
    inc[i] = acc;
  }
}

template <typename S>
__global__ void __launch_bounds__(kChainThreads)
chain_seq_kernel(Leaves totals, Leaves offsets, Leaves running,
                 int64_t chunks) {
  using E = typename S::E;
  __shared__ __align__(16) E tot[2][kChainStage + kChainWindow];
  __shared__ __align__(16) E inc[2][kChainStage];
  __shared__ E carry_in[2];   // each stage's incoming carry
  constexpr int kMovers = kChainThreads - 32;
  const int mover = static_cast<int>(threadIdx.x) - 32;   // warps 1..
  const int64_t row = static_cast<int64_t>(blockIdx.x) * chunks;
  const int64_t stages = (chunks + kChainStage - 1) / kChainStage;
  auto width = [&](int64_t st) {
    const int64_t left = chunks - st * kChainStage;
    return static_cast<int>(left < kChainStage ? left : kChainStage);
  };
  E acc = S::identity();
  // step k: thread 0 folds stage k - 1 while the movers load stage k and
  // write stage k - 2; then the block meets
  for (int64_t k = 0; k < stages + 2; ++k) {
    if (threadIdx.x == 0 && k >= 1 && k <= stages) {
      const int b = (k - 1) & 1;
      carry_in[b] = acc;
      fold_stage<S>(tot[b], inc[b], width(k - 1), acc);
    } else if (mover >= 0) {
      if (k < stages) {
        const int w = width(k);
        const int64_t c0 = row + k * kChainStage;
        for (int i = mover; i < w; i += kMovers)
          tot[k & 1][i] = S::get(totals, c0 + i);
      }
      if (k >= 2) {
        const int b = k & 1, w = width(k - 2);
        const int64_t c0 = row + (k - 2) * kChainStage;
        for (int i = mover; i < w; i += kMovers) {
          S::put(offsets, c0 + i, i > 0 ? inc[b][i - 1] : carry_in[b]);
          if (running.v != nullptr) S::put(running, c0 + i, inc[b][i]);
        }
      }
    }
    __syncthreads();
  }
}

// A shuffle of an element, word by word.
template <typename E>
__device__ __forceinline__ E shfl_up_e(E x, int k) {
  static_assert(sizeof(E) % 4 == 0, "an element is whole 32-bit words");
  uint32_t w[sizeof(E) / 4];
  memcpy(w, &x, sizeof(E));
#pragma unroll
  for (int i = 0; i < static_cast<int>(sizeof(E) / 4); ++i)
    w[i] = __shfl_up_sync(0xffffffffu, w[i], k);
  memcpy(&x, w, sizeof(E));
  return x;
}

// Hillis-Steele across a warp's lanes, one slot a lane, steps k = 1, 2,
// 4, ... below n: lane l takes x[l - k] (+) x[l], identity (+) x[l] below
// k, the lower lane the left operand.
template <typename S>
__device__ __forceinline__ void warp_hs1(typename S::E& x, int lane, int n) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    if (d >= n) break;
    const typename S::E u = shfl_up_e(x, d);
    x = S::combine(lane >= d ? u : S::identity(), x);
  }
}

// chain (Rows), for specs whose combine is associative bit for bit (the
// integer sums and the mask, in wrapping uint32, and the integer
// segmented sum): any order of combines gives the left fold's bits, so
// one block per row scans kItems * blockDim.x totals a step (32 bytes of
// them a thread): each thread its kItems consecutive totals, a warp scan
// of the threads' totals, a scan of the warps', and the block's carry
// from the steps before. Device memory is read and written coalesced,
// element r * blockDim.x + thread, through a shared-memory buffer (one
// word of padding every 32 elements, so that a thread's run of kItems
// meets no bank conflict), and the next step's totals are loaded into
// registers while this step is scanned.
template <typename S>
__global__ void __launch_bounds__(kScanThreads)
chain_scan_kernel(Leaves totals, Leaves offsets, Leaves running,
                  int64_t chunks) {
  using E = typename S::E;
  constexpr int kItems = 32 / sizeof(E);
  __shared__ E buf[kItems * kScanThreads + kItems * kScanThreads / 32];
  __shared__ E part[2][32];   // the warps' inclusive totals, then scanned
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int n = blockDim.x, warps = n / 32;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * chunks;
  const int64_t step = static_cast<int64_t>(kItems) * n;
  auto at = [](int e) { return e + e / 32; };
  auto load = [&](int64_t g0, E (&x)[kItems]) {   // coalesced
#pragma unroll
    for (int r = 0; r < kItems; ++r) {
      const int64_t c = g0 + r * n + threadIdx.x;
      x[r] = c < chunks ? S::get(totals, row + c) : S::identity();
    }
  };
  E next[kItems];
  load(0, next);
  E carry = S::identity();
  int b = 0;
  for (int64_t g0 = 0; g0 < chunks; g0 += step) {
#pragma unroll
    for (int r = 0; r < kItems; ++r) buf[at(r * n + threadIdx.x)] = next[r];
    if (g0 + step < chunks) load(g0 + step, next);
    __syncthreads();
    E x[kItems];   // the thread's totals, then their inclusive scan
#pragma unroll
    for (int j = 0; j < kItems; ++j) x[j] = buf[at(kItems * threadIdx.x + j)];
#pragma unroll
    for (int j = 1; j < kItems; ++j) x[j] = S::combine(x[j - 1], x[j]);
    E inc = x[kItems - 1];
    warp_hs1<S>(inc, lane, 32);
    if (lane == 31) part[b][warp] = inc;
    __syncthreads();   // buf is read, part written
    if (warp == 0) {
      E w = lane < warps ? part[b][lane] : S::identity();
      warp_hs1<S>(w, lane, 32);
      part[b][lane] = w;
    }
    __syncthreads();
    // every total of the row before this thread's first
    E exc = shfl_up_e(inc, 1);
    if (lane == 0) exc = S::identity();
    const E pre = warp > 0 ? part[b][warp - 1] : S::identity();
    const E before = S::combine(carry, S::combine(pre, exc));
    carry = S::combine(carry, part[b][warps - 1]);
    b ^= 1;   // every read of this part precedes the next step's barrier
    for (int out = 0; out < (running.v != nullptr ? 2 : 1); ++out) {
      const Leaves& dst = out == 0 ? offsets : running;
#pragma unroll
      for (int j = 0; j < kItems; ++j)
        buf[at(kItems * threadIdx.x + j)] =
            out == 0 ? (j > 0 ? S::combine(before, x[j - 1]) : before)
                     : S::combine(before, x[j]);
      __syncthreads();
#pragma unroll
      for (int r = 0; r < kItems; ++r) {
        const int64_t c = g0 + r * n + threadIdx.x;
        if (c < chunks) S::put(dst, row + c, buf[at(r * n + threadIdx.x)]);
      }
      __syncthreads();   // buf is free again
    }
  }
}

// chain (Channels): the same chain for each (batch row, channel), one
// thread each, left to right from the identity, reading and writing its
// (B, chunks, D) entries with loads coalesced across channels. The thread
// walks its chunks in groups of kChainChanGroup and issues all of a
// group's loads before it folds and stores the group, so the loads are in
// flight together and no store waits on one. (The first form loaded,
// stored and combined chunk by chunk, each load behind the last store,
// since the compiler must assume the leaves alias.) At the SSD carry's
// totals, from L2, on an H100 80GB HBM3 at 700 W (tools/chain_variants.py),
// four channels a thread with 16-byte loads and stores ran slower, ~0.0103
// ms against 0.0064, and so did this kernel in groups of eight chunks,
// ~0.0097.
// Bits: offsets[c] = the fold before chunk c, running[c] = combine(that,
// totals[c]), the first form's and exclusive_chain's. Bound: device-memory
// bytes, the totals read once and the offsets (and running totals)
// written once.
constexpr int kChainChanGroup = 4;   // chunks whose loads are in flight together

template <typename S>
__global__ void chain_chan_kernel(Leaves totals, Leaves offsets, Leaves running,
                                  int64_t batch, int64_t chunks, int64_t d) {
  using E = typename S::E;
  constexpr int G = kChainChanGroup;
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= batch * d) return;
  const int64_t base = (lane / d) * chunks * d + lane % d;
  E acc = S::identity();
  for (int64_t c0 = 0; c0 < chunks; c0 += G) {
    E tot[G];
#pragma unroll
    for (int u = 0; u < G; ++u)
      if (c0 + u < chunks) tot[u] = S::get(totals, base + (c0 + u) * d);
#pragma unroll
    for (int u = 0; u < G; ++u) {
      if (c0 + u >= chunks) break;
      const int64_t at = base + (c0 + u) * d;
      S::put(offsets, at, acc);
      acc = S::combine(acc, tot[u]);
      if (running.v != nullptr) S::put(running, at, acc);
    }
  }
}

// apply: one block per (lane, chunk) tile rescans and combines its offsets.
template <typename S, bool kChan>
__global__ void __launch_bounds__(kThreads)
apply_kernel(Tensors t, Leaves offsets, Geom g, int exclusive) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int w = width_of<kChan>(g);
  Network<S, kChan> net(smem, g.bn, w);
  int64_t tile, chain;
  tile_at<kChan>(g, blockIdx.x, tile, chain);
  for (int c = threadIdx.x; c < w; c += blockDim.x)
    net.lane.set(c, S::get(offsets, chain + c));
  load_tile<S, kChan>(t, g, tile, net.x, g.bn, w);  // its barrier covers lane
  const typename S::Buf s = net.scan();
  store_tile<S, kChan>(t, g, tile, s, net.lane, g.bn, w, exclusive);
}

// fused: decoupled's totals, chain and apply in one launch, one block per
// (lane, chunk) tile, through a decoupled look-back that keeps the chain's
// association.
//
// Order. A block's tile comes from an atomic ticket, not from blockIdx, so
// every tile a block waits on belongs to a block that started earlier and
// is resident: the look-back makes progress whatever the grid size.
//
// Publication. Each tile has a 64-bit state word: none, aggregate (its
// tile total t_j) or inclusive (its prefix I_j = offset (+) t_j). A block
// publishes "aggregate" right after its tile is scanned and "inclusive"
// once its offset is known; the last tile of a lane publishes nothing,
// the first only I_0. On Rows, where a tuple fits in 32 bits (and the
// segmented flag in one more), the value rides in the same word as the
// state (S::kPack): one relaxed 64-bit store publishes both, one load
// reads both, no fence. Otherwise (the affine pair, Channels strips) the
// value goes to the agg/incl arrays first, then the state is released
// (st.release; with a fence first where several lanes wrote), and read
// with acquire loads before the values are read through L2.
//
// Look-back. Warp 0 reads the states of the 32 tiles before its own and
// finds the nearest k with "inclusive" such that every tile between k and
// its own has at least "aggregate"; with none such it waits, and when all
// 32 are "aggregate" it moves 32 tiles back (packed: up to kStackWindows
// windows, keeping their words in shared memory). Then the fold, LEFT TO
// RIGHT: offset = I_k (+) t(k+1) (+) ... (+) t(j-1): on Rows by lane 0,
// on Channels by each lane of the strip for its own channel. A textbook
// look-back sums its window right to left, which re-associates floats;
// this order is the chain's, so the offset is bitwise the chain's
// exclusive prefix whichever k was found (each I_k is that fold itself,
// by induction from I_0 = I (+) t0).
//
// Scratch (zeroed by the caller per launch): word[0] holds the ticket
// counter, word[1 + tile] the tile's state. Read n + write n.
constexpr uint32_t kNone = 0, kAggregate = 1, kInclusive = 2;
constexpr int kStackWindows = 16;

__device__ __forceinline__ uint64_t ld_acquire(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(uint64_t* p, uint64_t v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ uint64_t ld_relaxed(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(uint64_t* p, uint64_t v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" :: "l"(p), "l"(v) : "memory");
}

// The look-back of a packed Rows tile j > 0, by warp 0: returns the offset
// in lane 0 (the identity elsewhere).
template <typename S>
__device__ typename S::E lookback_packed(const uint64_t* st, int64_t j,
                                         uint64_t* stack) {
  using E = typename S::E;
  const int l = threadIdx.x;
  int64_t hi = j - 1;
  int nw = 0, first = 0;
  for (;;) {
    const int64_t idx = hi - l;
    const uint64_t word = idx >= 0 ? ld_relaxed(st + idx) : 0u;
    const uint32_t sv = static_cast<uint32_t>(word) & 3u;
    const unsigned inc = __ballot_sync(0xffffffffu, sv == kInclusive);
    const unsigned none = __ballot_sync(0xffffffffu, sv == kNone);
    if (inc != 0u) {
      first = __ffs(inc) - 1;
      if ((none & ((1u << first) - 1u)) == 0u) {
        stack[nw * 32 + l] = word;
        break;
      }
    } else if (none == 0u && nw + 1 < kStackWindows) {
      stack[nw * 32 + l] = word;  // 32 aggregates: look further back
      ++nw;
      hi -= 32;
      continue;
    }
    __nanosleep(64);
  }
  __syncwarp();
  E pre = S::identity();
  if (l == 0) {
    // I_k, then the aggregates from tile k + 1 up to tile j - 1
    pre = S::unpack(stack[nw * 32 + first]);
#pragma unroll 8
    for (int q = first - 1; q >= 0; --q)
      pre = S::combine(pre, S::unpack(stack[nw * 32 + q]));
    for (int v = nw - 1; v >= 0; --v) {
#pragma unroll 8
      for (int q = 31; q >= 0; --q)
        pre = S::combine(pre, S::unpack(stack[v * 32 + q]));
    }
  }
  return pre;
}

// The look-back of tile j > 0 with its values in the agg/incl arrays, by
// warp 0: lanes l < w return their channel's offset.
template <typename S>
__device__ typename S::E lookback_arrays(const uint64_t* st, int64_t j,
                                         Leaves agg, Leaves incl,
                                         int64_t cbase, int64_t d, int w) {
  using E = typename S::E;
  const int l = threadIdx.x;
  int64_t hi = j - 1, k;
  for (;;) {
    const int64_t idx = hi - l;
    const uint32_t sv = idx >= 0 ? static_cast<uint32_t>(ld_acquire(st + idx))
                                 : kNone;
    const unsigned inc = __ballot_sync(0xffffffffu, sv == kInclusive);
    const unsigned none = __ballot_sync(0xffffffffu, sv == kNone);
    if (inc != 0u) {
      const int first = __ffs(inc) - 1;
      if ((none & ((1u << first) - 1u)) == 0u) {
        k = hi - first;
        break;
      }
    } else if (none == 0u) {
      hi -= 32;  // 32 aggregates: look further back
      continue;
    }
    __nanosleep(64);
  }
  __syncwarp();  // the acquires above order the reads below, lane to lane
  E pre = S::identity();
  if (l < w) {
    pre = S::template get<true>(incl, cbase + k * d + l);
    int64_t i = k + 1;
    for (; i + 8 <= j; i += 8) {  // eight loads in flight per step
      E v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = S::template get<true>(agg, cbase + (i + u) * d + l);
#pragma unroll
      for (int u = 0; u < 8; ++u) pre = S::combine(pre, v[u]);
    }
    for (; i < j; ++i) pre = S::combine(pre, S::template get<true>(agg, cbase + i * d + l));
  }
  return pre;
}

template <typename S, bool kChan>
__global__ void __launch_bounds__(kThreads)
fused_kernel(Tensors t, uint64_t* state, Leaves agg, Leaves incl, Geom g,
             int exclusive) {
  using E = typename S::E;
  constexpr bool kPacked = !kChan && S::kPack;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint32_t ticket;
  __shared__ uint64_t stack[kPacked ? kStackWindows * 32 : 1];
  const int w = width_of<kChan>(g);
  const int64_t d = stride_of<kChan>(g);
  Network<S, kChan> net(smem, g.bn, w);
  if (threadIdx.x == 0) ticket = atomicAdd(reinterpret_cast<unsigned*>(state), 1u);
  __syncthreads();
  const uint32_t j = ticket % static_cast<uint32_t>(g.chunks);
  int64_t tile, chain;
  tile_at<kChan>(g, ticket, tile, chain);
  const int64_t cbase = chain - j * d;           // the lane's chain entries
  uint64_t* st = state + 1 + (ticket - j);       // and its tile states
  const bool publish = j + 1 < g.chunks;         // a successor reads it
  load_tile<S, kChan>(t, g, tile, net.x, g.bn, w);
  const typename S::Buf s = net.scan();
  if (threadIdx.x < 32) {  // w <= 32: the strip's channels are warp 0's lanes
    const int l = threadIdx.x;
    if (j > 0 && publish) {
      if constexpr (kPacked) {
        if (l == 0) st_relaxed(st + j, S::pack(net.last(s, 0)) | kAggregate);
      } else {
        if (l < w) {
          S::put(agg, cbase + j * d + l, net.last(s, l));
          if (w > 1) __threadfence();
        }
        __syncwarp();
        if (l == 0) st_release(st + j, kAggregate);
      }
    }
    E pre = S::identity();
    if (j > 0) {
      if constexpr (kPacked) pre = lookback_packed<S>(st, j, stack);
      else pre = lookback_arrays<S>(st, j, agg, incl, cbase, d, w);
    }
    if (l < w) net.lane.set(l, pre);
    if (publish) {
      if constexpr (kPacked) {
        if (l == 0)
          st_relaxed(st + j, S::pack(S::combine(pre, net.last(s, 0))) | kInclusive);
      } else {
        if (l < w) {
          S::put(incl, cbase + j * d + l, S::combine(pre, net.last(s, l)));
          if (w > 1) __threadfence();
        }
        __syncwarp();
        if (l == 0) st_release(st + j, kInclusive);
      }
    }
  }
  __syncthreads();
  store_tile<S, kChan>(t, g, tile, s, net.lane, g.bn, w, exclusive);
}

// The register network: carry, apply and fused on Rows tiles of bn = 128 r
// elements (SUM in its six dtypes, SEGSUM, MASK; kReg), and tree's
// Blelloch sweep on the same tiles (tree_reg_kernel, below). tile_scan's
// association, element for element, without shared-memory passes:
//   * a warp holds whole 128-element segments, lane l elements 4l .. 4l + 3
//     of each in registers (one 16-byte load for float32 and int32, 8
//     bytes for the 16-bit types, 4 for int8, a leaf at a time);
//     Hillis-Steele step k takes x[p - k] (+) x[p], and identity (+) x[p]
//     for p < k, counted from the segment's start: steps 1 and 2 take the
//     lane below's last one or two elements by shuffle, steps 4 .. 64
//     shuffle each register from k / 4 lanes below (warp_hs4); 23
//     shuffles a lane a segment (a 32-bit word each; the segmented pair's
//     flag is a second word), a warp's segments interleaved;
//   * each segment total (lane 31's last element) goes to shared memory;
//     after one block barrier every warp runs Hillis-Steele over the r
//     totals itself (a slot a lane up to 32 totals, four above: Upper),
//     identity-padded the same way, and takes each segment's exclusive
//     offset (the slot before it) by shuffle; the broadcast combine
//     (offset on the LEFT, segment 0 too, none at r = 1), then the carry
//     or look-back offset on the LEFT, as store_tile does, and the
//     exclusive form's neighbour by one shuffle;
//   * carry: a block of kRegWarps warps holding kCarrySegs consecutive
//     segments each walks a row in rounds of that many segments (round
//     s's offsets need only the totals up to its own: slot p of
//     Hillis-Steele depends on slots <= p and on r, which fixes the
//     steps), one barrier a round, the carry in every thread's registers,
//     and kRegAhead rounds' loads in flight in a register ring, unrolled
//     so that no register waits on a move;
//   * fused: a block a tile in ticket order, with fused_kernel's
//     look-back (lookback_packed) and publication, the aggregate (the
//     network's last element) published as soon as the totals are in; a
//     warp holds fused_segs segments, so a small block keeps a whole
//     2048-element tile in registers and an SM holds many tiles, each
//     waiting on its look-back; the segments of a longer tile past the
//     first kFusedWarps * fused_segs are read again (from L2, mostly) for
//     their output;
//   * apply: fused's block a tile without the ticket and the look-back,
//     its offset read from the chain's offsets.
// Loads and stores take vectors when the operands' bases are aligned to
// four elements (every run then is: bn and n are multiples of 128), else
// four scalar accesses a lane (kVec false), the same organization. The
// constants below were chosen by tools/network_variants.py (PERF.md).
constexpr int kRegWarps = 8;    // carry: warps of a block at most
constexpr int kCarrySegs = 2;   // carry: segments a warp holds a round
constexpr int kRegAhead = 2;    // carry: items whose loads are in flight
constexpr int kFusedWarps = 4;  // fused: warps of a block at most
constexpr int kFusedWords = 8;  // fused: 32-bit words of an element a lane
                                // holds, over its segments

// fused: segments a warp holds, 8 of a one-word element, 4 of the
// segmented (value, flag) pair
template <typename S>
__host__ __device__ constexpr int fused_segs() {
  return kFusedWords * 4 / static_cast<int>(sizeof(typename S::E));
}

// Hillis-Steele over the warp's 128 slots, lane l holding slots 4l .. 4l + 3
// in x[0 .. 3], steps k = 1, 2, 4, ... below n: slot p takes x[p - k] (+)
// x[p], identity (+) x[p] below k. Every new value of a step is computed
// from the old ones.
template <typename S>
__device__ __forceinline__ void warp_hs4(typename S::E (&x)[4], int lane,
                                         int n) {
  using E = typename S::E;
  const E id = S::identity();
  if (n > 1) {   // k = 1: slot 4l's neighbour is the lane below's slot 3
    const E u = shfl_up_e(x[3], 1);
    x[3] = S::combine(x[2], x[3]);
    x[2] = S::combine(x[1], x[2]);
    x[1] = S::combine(x[0], x[1]);
    x[0] = S::combine(lane >= 1 ? u : id, x[0]);
  }
  if (n > 2) {   // k = 2: slots 4l and 4l + 1 take the lane below's 2 and 3
    const E u2 = shfl_up_e(x[2], 1), u3 = shfl_up_e(x[3], 1);
    x[3] = S::combine(x[1], x[3]);
    x[2] = S::combine(x[0], x[2]);
    x[1] = S::combine(lane >= 1 ? u3 : id, x[1]);
    x[0] = S::combine(lane >= 1 ? u2 : id, x[0]);
  }
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {   // k = 4d: d lanes below, same slot
    if (4 * d >= n) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const E u = shfl_up_e(x[j], d);
      x[j] = S::combine(lane >= d ? u : id, x[j]);
    }
  }
}

// Hillis-Steele over a tile's r segment totals t[0, r), of which the
// first `known` are written (identity above: no slot below them reads
// them), in every warp; slot(p) is the result at p, in every lane.
template <typename S>
struct Upper {
  using E = typename S::E;
  E x[4];
  bool one;   // r <= 32: a slot a lane
  __device__ Upper(const E* t, int known, int r, int lane) : one(r <= 32) {
    if (one) {
      x[0] = lane < known ? t[lane] : S::identity();
      warp_hs1<S>(x[0], lane, r);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        x[j] = 4 * lane + j < known ? t[4 * lane + j] : S::identity();
      warp_hs4<S>(x, lane, r);
    }
  }
  __device__ E slot(int p) const {   // p warp-uniform
    if (one) return shfl_e(x[0], p);
    const int j = p & 3;
    return shfl_e(j == 0 ? x[0] : j == 1 ? x[1] : j == 2 ? x[2] : x[3], p >> 2);
  }
  // the tile's last element: the broadcast combine of the last segment
  __device__ E last(const E* t, int r) const {
    return r > 1 ? S::combine(slot(r - 2), t[r - 1]) : t[0];
  }
};

// Emits segment q of a tile from lane element i0 on: seg holds its
// in-segment scan, m the elements as loaded; left is the carry or the
// look-back offset.
template <typename S, bool kVec>
__device__ __forceinline__ void emit_segment(
    const Tensors& t, int64_t i0, const typename S::E (&m)[4],
    const typename S::E (&seg)[4], typename S::E left, const Upper<S>& up,
    const typename S::E* tot, int q, int r, int lane, int exclusive) {
  using E = typename S::E;
  E full[4];
  if (r > 1) {
    const E off = q > 0 ? up.slot(q - 1) : S::identity();
#pragma unroll
    for (int j = 0; j < 4; ++j) full[j] = S::combine(off, seg[j]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) full[j] = seg[j];
  }
  E out[4];
  if (exclusive) {
    // the element before the lane's first: the lane below's last, or for
    // lane 0 the previous segment's last (the identity at the tile start)
    E prev = S::identity();
    if (r > 1 && q > 0)
      prev = S::combine(q > 1 ? up.slot(q - 2) : S::identity(), tot[q - 1]);
    const E u = shfl_up_e(full[3], 1);
    out[0] = S::combine(left, lane >= 1 ? u : prev);
#pragma unroll
    for (int j = 1; j < 4; ++j) out[j] = S::combine(left, full[j - 1]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) out[j] = S::combine(left, full[j]);
  }
  S::template emit_run<kVec>(t, i0, out, m);
}

// The row walk of carry and tree: a block of 32 * kRegWarps threads at
// most (the bound of kThreads caps a thread at 128 registers, so that an
// SM holds two blocks), each warp holding kCarrySegs consecutive segments
// a round, walks row blockIdx.x tile after tile in rounds of the block's
// segments. Items (chunk, round) come in order, and the ring's loads run
// kRegAhead items ahead, unrolled so that no register waits on a move.
// process(m) takes the next item, m the warp's segments as loaded, and
// keeps its own (chunk, round).
template <typename S, bool kVec, typename P>
__device__ __forceinline__ void walk_row(const Tensors& t, const Geom& g,
                                         P& process) {
  using E = typename S::E;
  constexpr int K = kCarrySegs;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int r = g.bn / kLanes, per = blockDim.x / 32 * K;
  const int rounds = (r + per - 1) / per;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * g.n;
  E ring[kRegAhead + 1][K][4];
  int64_t lj = 0;
  int ls = 0;
  auto prefetch = [&](E (&dst)[K][4]) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int q = ls * per + warp * K + k;
      if (lj < g.chunks && q < r)
        S::template load_run<kVec>(t, row + lj * g.bn + q * kLanes + 4 * lane,
                                   dst[k]);
    }
    if (++ls == rounds) {
      ls = 0;
      ++lj;
    }
  };
#pragma unroll
  for (int a = 0; a < kRegAhead; ++a) prefetch(ring[a]);
  const int64_t items = g.chunks * rounds;
  for (int64_t it = 0; it < items; it += kRegAhead + 1) {
#pragma unroll
    for (int u = 0; u <= kRegAhead; ++u) {   // no register moves between items
      if (it + u < items) {
        prefetch(ring[(u + kRegAhead) % (kRegAhead + 1)]);
        process(ring[u]);
      }
    }
  }
}

template <typename S, bool kVec>
__global__ void __launch_bounds__(kThreads)
carry_reg_kernel(Tensors t, Leaves running, Geom g, int exclusive) {
  using E = typename S::E;
  constexpr int K = kCarrySegs;
  __shared__ E tot[2][kLanes];   // segment totals, by the tile's parity
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int r = g.bn / kLanes, per = blockDim.x / 32 * K;
  const int rounds = (r + per - 1) / per;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * g.n;
  E carry = S::identity();
  int64_t j = 0;
  int s = 0, par = 0;
  auto process = [&](const E (&m)[K][4]) {
    E seg[K][4];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int q = s * per + warp * K + k;
#pragma unroll
      for (int e = 0; e < 4; ++e) seg[k][e] = m[k][e];
      if (q < r) {
        warp_hs4<S>(seg[k], lane, kLanes);
        if (lane == 31) tot[par][q] = seg[k][3];
      }
    }
    __syncthreads();
    const Upper<S> up(tot[par], min(r, (s + 1) * per), r, lane);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int q = s * per + warp * K + k;
      if (q < r)
        emit_segment<S, kVec>(t, row + j * g.bn + q * kLanes + 4 * lane, m[k],
                              seg[k], carry, up, tot[par], q, r, lane,
                              exclusive);
    }
    if (++s == rounds) {
      carry = S::combine(carry, up.last(tot[par], r));
      if (running.v != nullptr && threadIdx.x == 0)
        S::put(running, static_cast<int64_t>(blockIdx.x) * g.chunks + j, carry);
      s = 0;
      ++j;
      par ^= 1;
    }
  };
  walk_row<S, kVec>(t, g, process);
}

// fused on the register network: a block a tile, in ticket order as
// fused_kernel; a warp holds fused_segs<S>() consecutive segments, so that
// a small block keeps a whole 2048-element tile in registers (more tiles
// in flight on an SM, each waiting on its look-back) and its segments'
// scans interleave. Segments past the first kFusedWarps * fused_segs<S>()
// publish their totals, then are read again (from L2, mostly) for their
// output.
template <typename S, bool kVec>
__global__ void __launch_bounds__(32 * kFusedWarps)
fused_reg_kernel(Tensors t, uint64_t* state, Geom g, int exclusive) {
  using E = typename S::E;
  constexpr int K = fused_segs<S>();
  __shared__ uint32_t ticket;
  __shared__ uint64_t stack[kStackWindows * 32];
  __shared__ E tot[kLanes];
  __shared__ E pre_s;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int warps = blockDim.x / 32, r = g.bn / kLanes;
  const int held = warps * K;   // segments held in registers
  if (threadIdx.x == 0) ticket = atomicAdd(reinterpret_cast<unsigned*>(state), 1u);
  __syncthreads();
  const uint32_t j = ticket % static_cast<uint32_t>(g.chunks);
  const int64_t tile = static_cast<int64_t>(ticket) * g.bn + 4 * lane;
  uint64_t* st = state + 1 + (ticket - j);       // the row's tile states
  const bool publish = j + 1 < g.chunks;         // a successor reads it
  E m[K][4], sg[K][4];   // the warp's segments as loaded, and scanned
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int q = warp * K + k;
    if (q < r) S::template load_run<kVec>(t, tile + q * kLanes, m[k]);
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int q = warp * K + k;
    if (q < r) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sg[k][e] = m[k][e];
      warp_hs4<S>(sg[k], lane, kLanes);
      if (lane == 31) tot[q] = sg[k][3];
    }
  }
  for (int q = held + warp; q < r; q += warps) {   // later segments
    E x[4];
    S::template load_run<kVec>(t, tile + q * kLanes, x);
    warp_hs4<S>(x, lane, kLanes);
    if (lane == 31) tot[q] = x[3];
  }
  __syncthreads();
  const Upper<S> up(tot, r, r, lane);
  if (warp == 0) {
    const E agg = up.last(tot, r);
    if (j > 0 && publish && lane == 0) st_relaxed(st + j, S::pack(agg) | kAggregate);
    const E pre = j > 0 ? lookback_packed<S>(st, j, stack) : S::identity();
    if (lane == 0) {
      if (publish) st_relaxed(st + j, S::pack(S::combine(pre, agg)) | kInclusive);
      pre_s = pre;
    }
  }
  __syncthreads();
  const E pre = pre_s;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int q = warp * K + k;
    if (q < r)
      emit_segment<S, kVec>(t, tile + q * kLanes, m[k], sg[k], pre, up, tot, q,
                            r, lane, exclusive);
  }
  for (int q = held + warp; q < r; q += warps) {   // read again
    E mq[4], x[4];
    S::template load_run<kVec>(t, tile + q * kLanes, mq);
#pragma unroll
    for (int e = 0; e < 4; ++e) x[e] = mq[e];
    warp_hs4<S>(x, lane, kLanes);
    emit_segment<S, kVec>(t, tile + q * kLanes, mq, x, pre, up, tot, q, r,
                          lane, exclusive);
  }
}

// apply on the register network: fused_reg_kernel without the ticket and
// the look-back. A block a tile (blockIdx), its offset read from the
// chain's offsets while the tile's loads are in flight; the same block
// shape, so a small block keeps a whole 2048-element tile in registers.
// Its own copy of fused's body: the two written as one held-tile object
// gave the same bits and apply's time, but fused took 3x as long.
template <typename S, bool kVec>
__global__ void __launch_bounds__(32 * kFusedWarps)
apply_reg_kernel(Tensors t, Leaves offsets, Geom g, int exclusive) {
  using E = typename S::E;
  constexpr int K = fused_segs<S>();
  __shared__ E tot[kLanes];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int warps = blockDim.x / 32, r = g.bn / kLanes;
  const int held = warps * K;   // segments held in registers
  const int64_t tile = static_cast<int64_t>(blockIdx.x) * g.bn + 4 * lane;
  E m[K][4], sg[K][4];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int q = warp * K + k;
    if (q < r) S::template load_run<kVec>(t, tile + q * kLanes, m[k]);
  }
  const E pre = S::get(offsets, blockIdx.x);   // Rows: chain entry = tile
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int q = warp * K + k;
    if (q < r) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sg[k][e] = m[k][e];
      warp_hs4<S>(sg[k], lane, kLanes);
      if (lane == 31) tot[q] = sg[k][3];
    }
  }
  for (int q = held + warp; q < r; q += warps) {   // later segments
    E x[4];
    S::template load_run<kVec>(t, tile + q * kLanes, x);
    warp_hs4<S>(x, lane, kLanes);
    if (lane == 31) tot[q] = x[3];
  }
  __syncthreads();
  const Upper<S> up(tot, r, r, lane);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int q = warp * K + k;
    if (q < r)
      emit_segment<S, kVec>(t, tile + q * kLanes, m[k], sg[k], pre, up, tot, q,
                            r, lane, exclusive);
  }
  for (int q = held + warp; q < r; q += warps) {   // read again
    E mq[4], x[4];
    S::template load_run<kVec>(t, tile + q * kLanes, mq);
#pragma unroll
    for (int e = 0; e < 4; ++e) x[e] = mq[e];
    warp_hs4<S>(x, lane, kLanes);
    emit_segment<S, kVec>(t, tile + q * kLanes, mq, x, pre, up, tot, q, r,
                          lane, exclusive);
  }
}

// tree: carry's lane walk with an in-place Blelloch sweep over the tile
// padded to m (a power of two) positions with the identity, each channel
// on its own. e keeps the elements for the inclusive form.
template <typename S, bool kChan>
__global__ void __launch_bounds__(kThreads)
tree_kernel(Tensors t, Leaves running, Geom g, int m, int exclusive) {
  using E = typename S::E;
  extern __shared__ __align__(16) unsigned char smem[];
  const int w = width_of<kChan>(g), ws = shift_of<kChan>(w);
  const int64_t d = stride_of<kChan>(g);
  const int bn = g.bn;
  unsigned char* p = smem;
  const typename S::Buf a = S::carve(p, m * w);
  const typename S::Buf e = S::carve(p, bn * w);
  const typename S::Buf carry = S::carve(p, kMaxWidth);
  const typename S::Buf root = S::carve(p, kMaxWidth);
  const int64_t base = data_base<kChan>(g, blockIdx.x);
  const int64_t cbase = chain_base<kChan>(g, blockIdx.x);
  for (int c = threadIdx.x; c < w; c += blockDim.x) carry.set(c, S::identity());
  for (int64_t j = 0; j < g.chunks; ++j) {
    const int64_t tile = base + j * bn * d;
    for (int q = threadIdx.x; q < m * w; q += blockDim.x) {
      const int i = q >> ws;
      const E v = i < bn ? S::load(t, tile + i * d + (q & (w - 1))) : S::identity();
      a.set(q, v);
      if (i < bn) e.set(q, v);
    }
    __syncthreads();
    for (int s = 1; s < m; s <<= 1) {  // up-sweep: left (+) right
      for (int q = threadIdx.x; q < (m / (2 * s)) * w; q += blockDim.x) {
        const int right = (((q >> ws) + 1) * 2 * s - 1) * w + (q & (w - 1));
        a.set(right, S::combine(a.get(right - s * w), a.get(right)));
      }
      __syncthreads();
    }
    for (int c = threadIdx.x; c < w; c += blockDim.x) {
      root.set(c, a.get((m - 1) * w + c));
      a.set((m - 1) * w + c, S::identity());
    }
    __syncthreads();
    for (int s = m >> 1; s >= 1; s >>= 1) {  // down-sweep
      for (int q = threadIdx.x; q < (m / (2 * s)) * w; q += blockDim.x) {
        const int right = (((q >> ws) + 1) * 2 * s - 1) * w + (q & (w - 1));
        const E parent = a.get(right);
        const E old_left = a.get(right - s * w);
        a.set(right - s * w, parent);
        a.set(right, S::combine(parent, old_left));  // combine(parent, old_left)
      }
      __syncthreads();
    }
    const E row_carry = carry.get(0);  // Rows: one carry per tile
    for (int q = threadIdx.x; q < bn * w; q += blockDim.x) {
      const int c = q & (w - 1);
      const E sel = exclusive ? a.get(q) : S::combine(a.get(q), e.get(q));
      S::emit(t, tile + (q >> ws) * d + c,
              S::combine(kChan ? carry.get(c) : row_carry, sel));
    }
    __syncthreads();  // every read of the carry is done
    for (int c = threadIdx.x; c < w; c += blockDim.x) {
      const E next = S::combine(carry.get(c), root.get(c));
      carry.set(c, next);
      if (running.v != nullptr) S::put(running, cbase + j * d + c, next);
    }
    __syncthreads();  // the next tile overwrites a, e and root
  }
}

// tree on the register network: Rows tiles of bn = 128 r elements (kReg
// specs), the Blelloch tree of tree_kernel bit for bit. The tile padded to
// 128 pow2(r) slots is one balanced tree whose lower 7 levels are the
// 128-element segments' trees and whose upper levels are the tree over the
// segment roots padded with identity roots (a segment of identities has
// the identity as its root, combine(I, I) = I, so those segments are never
// loaded); every combine of that upper tree over the padded slots is done.
// Slot p's exclusive value is the left fold, from the identity, of the
// totals of the left-sibling subtrees on the path from the root to p,
// largest first, so a round of segments needs only the roots to its left.
//   * a warp holds a segment, lane l slots 4l .. 4l + 3: levels 1 and 2 of
//     the up-sweep in the lane's registers, levels 3 .. 7 across lanes by
//     an xor shuffle (the right lane of a pair, (l + 1) mod 2d = 0, takes
//     combine(left, right)), the classic in-place sweep, so a lane keeps
//     only x0 (+) x1 and its own subtree value; 10 shuffles a segment a
//     32-bit word, up and down;
//   * the segment roots go to shared memory; after one block barrier every
//     warp runs the same 128-slot tree over the roots known so far
//     (RootTree), the identity in the other slots, and takes each of its
//     segments' exclusive values by shuffle; the tile's root is the
//     up-sweep's value at level log2 pow2(r) (not above it: x (+) I turns
//     -0.0 into +0.0);
//   * the down-sweep starts from the segment's exclusive value at lane 31
//     and runs back across lanes and into registers; the output is
//     carry (+) excl, or carry (+) (excl (+) x) for the inclusive form;
//   * carry_reg_kernel's walk (walk_row): a block of kRegWarps warps
//     holding kCarrySegs segments each walks a row in rounds, one barrier
//     a round, kRegAhead rounds' loads in flight, the carry in every
//     thread.

// The up-sweep over a warp's 128 slots (lane l: slots 4l .. 4l + 3 in x):
// pairs (2i, 2i + 1) give combine(even, odd), level by level. Leaves the
// in-place values of slots 4l + 1 (x0 (+) x1) in a1 and 4l + 3 in u;
// returns, in lane max(n / 4 - 1, 0), the total of slots [0, n) (n a power
// of two up to 128).
template <typename S>
__device__ __forceinline__ typename S::E tree_up(const typename S::E (&x)[4],
                                                 int lane, int n,
                                                 typename S::E& a1,
                                                 typename S::E& u) {
  using E = typename S::E;
  a1 = S::combine(x[0], x[1]);
  u = S::combine(a1, S::combine(x[2], x[3]));
  E top = n == 1 ? x[0] : n == 2 ? a1 : u;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {   // the subtree of 2d lanes ending at l
    const E v = shfl_xor_e(u, d);
    if ((lane & (2 * d - 1)) == 2 * d - 1) u = S::combine(v, u);
    if (8 * d == n) top = u;
  }
  return top;
}

// The down-sweep from `top`, the exclusive value of the 128 slots' root:
// at stride d the right lane takes combine(parent, left subtree's total),
// the left lane the parent's value; then the lane's two pairs and four
// slots. e: the exclusive values of slots 4l .. 4l + 3.
template <typename S>
__device__ __forceinline__ void tree_down(const typename S::E (&x)[4],
                                          typename S::E a1, typename S::E u,
                                          typename S::E top, int lane,
                                          typename S::E (&e)[4]) {
  using E = typename S::E;
  if (lane == 31) u = top;
#pragma unroll
  for (int d = 16; d >= 1; d >>= 1) {
    const E v = shfl_xor_e(u, d);
    const int k = (lane + 1) & (2 * d - 1);
    if (k == 0) u = S::combine(u, v);
    else if (k == d) u = v;
  }
  const E e23 = S::combine(u, a1);
  e[0] = u;
  e[1] = S::combine(u, x[0]);
  e[2] = e23;
  e[3] = S::combine(e23, x[2]);
}

// The upper tree of a tile: the Blelloch tree over the segment roots
// t[0, r) padded with the identity to `slots` = pow2(r), of which the
// first `known` are written, in every warp (4 slots a lane over 128: the
// levels above `slots` leave the exclusive values of slots below it as
// they are). root: the tree's total, in every lane (all r known).
template <typename S>
struct RootTree {
  using E = typename S::E;
  E e[4];
  E root;
  __device__ RootTree(const E* t, int known, int slots, int lane) {
    E x[4], a1, u;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      x[j] = 4 * lane + j < known ? t[4 * lane + j] : S::identity();
    root = shfl_e(tree_up<S>(x, lane, slots, a1, u),
                  slots >= 8 ? slots / 4 - 1 : 0);
    tree_down<S>(x, a1, u, S::identity(), lane, e);
  }
  __device__ E excl(int q) const {   // q warp-uniform
    const int j = q & 3;
    return shfl_e(j == 0 ? e[0] : j == 1 ? e[1] : j == 2 ? e[2] : e[3], q >> 2);
  }
};

template <typename S, bool kVec>
__global__ void __launch_bounds__(kThreads)
tree_reg_kernel(Tensors t, Leaves running, Geom g, int exclusive) {
  using E = typename S::E;
  constexpr int K = kCarrySegs;
  __shared__ E tot[2][kLanes];   // segment roots, by the tile's parity
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int r = g.bn / kLanes, per = blockDim.x / 32 * K;
  const int rounds = (r + per - 1) / per;
  const int slots = pow2_at_least(r);
  const int64_t row = static_cast<int64_t>(blockIdx.x) * g.n;
  E carry = S::identity();
  int64_t j = 0;
  int s = 0, par = 0;
  auto process = [&](const E (&m)[K][4]) {
    E a1[K], u[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int q = s * per + warp * K + k;
      if (q < r) {
        tree_up<S>(m[k], lane, kLanes, a1[k], u[k]);
        if (lane == 31) tot[par][q] = u[k];
      }
    }
    __syncthreads();
    const RootTree<S> up(tot[par], min(r, (s + 1) * per), slots, lane);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int q = s * per + warp * K + k;
      if (q < r) {
        E e[4], out[4];
        tree_down<S>(m[k], a1[k], u[k], up.excl(q), lane, e);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          out[i] = S::combine(carry, exclusive ? e[i] : S::combine(e[i], m[k][i]));
        S::template emit_run<kVec>(t, row + j * g.bn + q * kLanes + 4 * lane,
                                   out, m[k]);
      }
    }
    if (++s == rounds) {
      carry = S::combine(carry, up.root);
      if (running.v != nullptr && threadIdx.x == 0)
        S::put(running, static_cast<int64_t>(blockIdx.x) * g.chunks + j, carry);
      s = 0;
      ++j;
      par ^= 1;
    }
  };
  walk_row<S, kVec>(t, g, process);
}

// carry on Channels in registers: the affine pair's carry (kChanReg) on
// tiles of bt = 32 NS time steps (NS = 4, 8, 16: bt 128, 256, 512), the
// shapes cuda.tile_network sends here. The bits of tile_scan on Channels,
// element for element (Hillis-Steele over each channel's whole time tile,
// step k taking x[i - k] (+) x[i] and the identity combine done below k,
// every new value of a step computed from the old ones), the carry of
// each channel entering every tile as the LEFT operand and advancing
// carry = carry (+) last, as carry_kernel; no shared-memory pass of the
// network and no barrier inside it:
//   * a block takes a strip of C = width channels (cuda.chan_reg_width:
//     32 where D allows, 128-byte rows of float32, and bt C <= 8192) and
//     walks its lane's tiles in time order; a tile's a and b come into
//     shared memory as [bt][C] float32 rows, by 16-byte cp.async copies
//     (float32 from bases aligned to four elements) or by vector loads and
//     stores (the 16-bit types, other bases), coalesced across the strip's
//     channels; the 16-byte chunks of a row are swizzled (chan_word), so
//     that eight consecutive rows cover the 32 banks; two stages, the next
//     tile's copies in flight while the block scans the current one. Rows
//     of 64 bytes (16-channel strips) held the copies alone, without the
//     network, to 2.6 ms at the SSD carry; 128-byte rows take 2.0
//     (PERF.md, tools/chan_variants.py);
//   * a warp owns V = 2 adjacent channels (32 words of data a lane at bt
//     256, so that 16 warps a block keep their registers; 4 is the tool's
//     variant) and lane l holds their time steps l + 32 s, s < NS, one
//     8-byte (16-byte) shared-memory read a step: steps k < 32 take
//     x[i - k] from lane l - k by shuffle, or for l < k from slot s - 1 of
//     lane l - k + 32 (the identity at s = 0); steps k = 32 m run within
//     the lane, slot s - m; this layout, rather than steps 8 l .. 8 l + 7
//     a lane, makes the column reads conflict-free;
//   * the carry of each channel sits in every lane of its warp; the b leaf
//     of carry (+) x (or of the exclusive neighbour) goes back into the
//     stage's a rows and out with the same coalesced stores; running totals
//     and exclusive as carry_kernel's.
// Shared memory: 2 words in and 2 out an element, against carry_kernel's
// ~24 and a barrier a step; up to 128 KB a block (two stages of 8192
// pairs), one block of 512 threads an SM at bt 256.
constexpr int kChanStages = 2;   // tiles a block holds: the next in flight

// channels a lane holds in carry_chan_reg_kernel (two: 32 words of data
// at bt 256, so that a block of 16 warps keeps every thread's registers)
__host__ __device__ constexpr int chan_reg_lanes(int) { return 2; }
// its threads at most: a warp per chan_reg_lanes channels of a strip of
// up to 32 channels and 8192 tile elements (two stages of a, b: 128 KB)
__host__ __device__ constexpr int chan_reg_threads(int ns) {
  return 32 * (8192 / (32 * ns) < 32 ? 8192 / (32 * ns) : 32) /
         chan_reg_lanes(ns);
}

// channels a lane holds in fused_chan_reg_kernel (four: 64 words of data at
// bt 256, in a block of eight scan warps and the look-back warp, two
// blocks an SM), and its threads at most: the scan warps of a strip of up
// to 32 channels and 8192 tile elements (one stage of a, b: 64 KB), and
// warp 0
__host__ __device__ constexpr int fused_chan_lanes(int) { return 4; }
__host__ __device__ constexpr int fused_chan_threads(int ns) {
  return 32 + 32 * (8192 / (32 * ns) < 32 ? 8192 / (32 * ns) : 32) /
                  fused_chan_lanes(ns);
}

// Word (row i, channel c) of a staged [rows][C] float32 tile: 16-byte chunk
// c / 4 of row i lies at chunk (c / 4) ^ f(i), f(i) = (i >> (3 - lg)) &
// (C / 4 - 1), C / 4 = 2^lg chunks a row.
__device__ __forceinline__ int chan_word(int i, int c, int C, int lg) {
  const int f = (i >> (3 - lg)) & ((C >> 2) - 1);
  return i * C + (((c >> 2) ^ f) << 2) + (c & 3);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// V adjacent channels' elements at word w of a staged tile's a and b
// rows, one 8-byte (16-byte) read a leaf; and V floats written there.
template <typename S, int V>
__device__ __forceinline__ void chan_slot(typename S::E (&x)[V],
                                          const float* sa, const float* sb,
                                          int w) {
  if constexpr (V == 4) {
    const float4 a4 = *reinterpret_cast<const float4*>(sa + w);
    const float4 b4 = *reinterpret_cast<const float4*>(sb + w);
    x[0] = {a4.x, b4.x};
    x[1] = {a4.y, b4.y};
    x[2] = {a4.z, b4.z};
    x[3] = {a4.w, b4.w};
  } else {
    const float2 a2 = *reinterpret_cast<const float2*>(sa + w);
    const float2 b2 = *reinterpret_cast<const float2*>(sb + w);
    x[0] = {a2.x, b2.x};
    x[1] = {a2.y, b2.y};
  }
}
template <int V>
__device__ __forceinline__ void chan_put(float* sa, int w,
                                         const float (&o)[V]) {
  if constexpr (V == 4)
    *reinterpret_cast<float4*>(sa + w) = make_float4(o[0], o[1], o[2], o[3]);
  else
    *reinterpret_cast<float2*>(sa + w) = make_float2(o[0], o[1]);
}

// A lane's NS slots of V adjacent channels from a staged tile's a and b
// rows (word wl + 32 C s for slot s: step lane + 32 s; the swizzle repeats
// every 8 rows).
template <typename S, int NS, int V>
__device__ __forceinline__ void chan_read(typename S::E (&x)[NS][V],
                                          const float* sa, const float* sb,
                                          int wl, int C) {
#pragma unroll
  for (int s = 0; s < NS; ++s) chan_slot<S, V>(x[s], sa, sb, wl + 32 * C * s);
}

// Hillis-Steele over each channel's 32 NS steps, lane l holding steps
// l + 32 s in x[s]: steps k < 32 take x[i - k] from lane l - k, slot s (slot
// s - 1 of lane l - k + 32 for l < k, the identity at s = 0); slots from the
// top, so every shuffle reads the old value; steps k = 32 m take slot s - m
// of the same lane, the identity below m.
template <typename S, int NS, int V>
__device__ __forceinline__ void chan_scan(typename S::E (&x)[NS][V],
                                          int lane) {
  using P = typename S::E;
  const P id = S::identity();
#pragma unroll
  for (int k = 1; k < 32; k <<= 1) {
    const int src = (lane - k) & 31;
    P hi[V];
#pragma unroll
    for (int v = 0; v < V; ++v) hi[v] = shfl_e(x[NS - 1][v], src);
#pragma unroll
    for (int s = NS - 1; s >= 0; --s) {
      P lo[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        lo[v] = s > 0 ? shfl_e(x[s > 0 ? s - 1 : 0][v], src) : id;
        x[s][v] = S::combine(lane >= k ? hi[v] : lo[v], x[s][v]);
        hi[v] = lo[v];
      }
    }
  }
#pragma unroll
  for (int m = 1; m < NS; m <<= 1)
#pragma unroll
    for (int s = NS - 1; s >= 0; --s)
#pragma unroll
      for (int v = 0; v < V; ++v)
        x[s][v] = S::combine(s >= m ? x[s >= m ? s - m : 0][v] : id, x[s][v]);
}

// The outputs' b leaf into the stage's a rows (the lane's words, as
// chan_read): left (+) x, or left (+) the exclusive neighbour below (lane
// l - 1, or slot s - 1 of lane 31), each channel's left the EARLIER operand.
template <typename S, int NS, int V>
__device__ __forceinline__ void chan_emit(const typename S::E (&x)[NS][V],
                                          const typename S::E (&left)[V],
                                          float* sa, int wl, int C, int lane,
                                          int exclusive) {
  using P = typename S::E;
  const P id = S::identity();
  auto put = [&](int s, const float (&o)[V]) {
    chan_put<V>(sa, wl + 32 * C * s, o);
  };
  if (exclusive) {
    P hi[V];
#pragma unroll
    for (int v = 0; v < V; ++v) hi[v] = shfl_e(x[NS - 1][v], (lane - 1) & 31);
#pragma unroll
    for (int s = NS - 1; s >= 0; --s) {
      float o[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const P lo =
            s > 0 ? shfl_e(x[s > 0 ? s - 1 : 0][v], (lane - 1) & 31) : id;
        o[v] = S::combine(left[v], lane >= 1 ? hi[v] : lo).b;
        hi[v] = lo;
      }
      put(s, o);
    }
  } else {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      float o[V];
#pragma unroll
      for (int v = 0; v < V; ++v) o[v] = S::combine(left[v], x[s][v]).b;
      put(s, o);
    }
  }
}

// The Blelloch sweep over each channel's 32 NS steps (tree_scan's
// association, as tree_kernel runs it; bt is a power of two, so no
// padding), lane l holding steps l + 32 s in x[s]: the five lowest levels
// of the up-sweep across lanes within each slot (the right lane of each
// pair, (l + 1) mod 2d = 0, takes combine(left, right), as tree_up), so
// that lane 31 of slot s holds the root of steps 32 s .. 32 s + 31; the
// log2 NS upper levels of both sweeps over those roots in lane 31's
// registers (the root is the up-sweep's total, then the identity at the
// top); the five lowest levels of the down-sweep across lanes (the left
// lane takes the parent, the right combine(parent, old left), as
// tree_down). Leaves each step's exclusive value in x and each channel's
// root in every lane.
template <typename S, int NS, int V>
__device__ __forceinline__ void chan_tree(typename S::E (&x)[NS][V],
                                          typename S::E (&root)[V],
                                          int lane) {
  using P = typename S::E;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1)
#pragma unroll
    for (int s = 0; s < NS; ++s)
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const P left = shfl_xor_e(x[s][v], d);
        if ((lane & (2 * d - 1)) == 2 * d - 1) x[s][v] = S::combine(left, x[s][v]);
      }
#pragma unroll
  for (int v = 0; v < V; ++v) root[v] = S::identity();
  if (lane == 31) {
#pragma unroll
    for (int h = 1; h < NS; h <<= 1)
#pragma unroll
      for (int s = 2 * h - 1; s < NS; s += 2 * h)
#pragma unroll
        for (int v = 0; v < V; ++v) x[s][v] = S::combine(x[s - h][v], x[s][v]);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      root[v] = x[NS - 1][v];
      x[NS - 1][v] = S::identity();
    }
#pragma unroll
    for (int h = NS / 2; h >= 1; h >>= 1)
#pragma unroll
      for (int s = 2 * h - 1; s < NS; s += 2 * h)
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const P parent = x[s][v], old_left = x[s - h][v];
          x[s - h][v] = parent;
          x[s][v] = S::combine(parent, old_left);
        }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) root[v] = shfl_e(root[v], 31);
#pragma unroll
  for (int d = 16; d >= 1; d >>= 1) {
    const int k = (lane + 1) & (2 * d - 1);
#pragma unroll
    for (int s = 0; s < NS; ++s)
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const P other = shfl_xor_e(x[s][v], d);
        if (k == 0) x[s][v] = S::combine(x[s][v], other);
        else if (k == d) x[s][v] = other;
      }
  }
}

// The tree's outputs' b leaf into the stage's a rows (the lane's words, as
// chan_read): left (+) excl, or left (+) (excl (+) x) with x read back
// from the stage before its word is overwritten (each lane writes only
// the words it reads), each channel's left the EARLIER operand.
template <typename S, int NS, int V>
__device__ __forceinline__ void chan_tree_emit(const typename S::E (&e)[NS][V],
                                               const typename S::E (&left)[V],
                                               float* sa, const float* sb,
                                               int wl, int C, int exclusive) {
  using P = typename S::E;
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const int w = wl + 32 * C * s;
    float o[V];
    if (exclusive) {
#pragma unroll
      for (int v = 0; v < V; ++v) o[v] = S::combine(left[v], e[s][v]).b;
    } else {
      P x[V];
      chan_slot<S, V>(x, sa, sb, w);
#pragma unroll
      for (int v = 0; v < V; ++v)
        o[v] = S::combine(left[v], S::combine(e[s][v], x[v])).b;
    }
    chan_put<V>(sa, w, o);
  }
}

// The walk of carry_chan_reg_kernel, apply_chan_reg_kernel and
// tree_chan_reg_kernel: the block walks tiles [j0, j1) of strip `strip` in
// time order through the two-stage copies. before(j) is called before the
// block waits for tile j's copies, so that loads it issues are in flight
// with them (apply's offsets); tile(j, sa, sb, wl) runs the tile's
// network on the staged a and b rows (wl: the lane's first word, as
// chan_read) and leaves each output's b leaf in its word of the a rows,
// for the coalesced stores.
template <typename T, int NS, bool kVec, typename Before, typename Tile>
__device__ __forceinline__ void chan_reg_walk(const Tensors& t, const Geom& g,
                                              uint32_t strip, int64_t j0,
                                              int64_t j1, Before before,
                                              Tile tile) {
  constexpr int V = chan_reg_lanes(NS), BT = 32 * NS;
  // cp.async for float32 from aligned bases, else vector loads
  constexpr bool kAsync = kVec && std::is_same<T, float>::value;
  extern __shared__ __align__(16) float stage[];   // [stages][a, b][BT][C]
  const int C = g.width, lg = __ffs(C >> 2) - 1, words = BT * C;
  const int lane = threadIdx.x % 32, c0 = threadIdx.x / 32 * V;
  const int64_t base = data_base<true>(g, strip);
  const T* xa = static_cast<const T*>(t.x);
  const T* xb = static_cast<const T*>(t.y);
  T* out = static_cast<T*>(t.out);

  // the 16-byte chunk a thread copies in and out: chunk c of rows i0,
  // i0 + R, ..., R = threads / (C / 4) a multiple of 8 rows, over which
  // the swizzle repeats: its word steps by R C, its element by R D
  const int R = blockDim.x >> lg;
  const int i0 = threadIdx.x >> lg, c = (threadIdx.x & ((C >> 2) - 1)) << 2;
  const int w0 = chan_word(i0, c, C, lg);
  const int64_t g0 = i0 * g.d + c;
  auto load = [&](int64_t j, int st) {   // tile j (if any) into stage st
    float* sa = stage + st * 2 * words;
    int64_t src = base + j * BT * g.d + g0;
    for (int w = w0; j < j1 && w < words; w += R * C, src += R * g.d) {
      if constexpr (kAsync) {
        cp_async16(sa + w, reinterpret_cast<const float*>(xa) + src);
        cp_async16(sa + words + w, reinterpret_cast<const float*>(xb) + src);
      } else {
        float v[4];
        load4<kVec>(xa + src, v);
        *reinterpret_cast<float4*>(sa + w) = make_float4(v[0], v[1], v[2], v[3]);
        load4<kVec>(xb + src, v);
        *reinterpret_cast<float4*>(sa + words + w) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
    }
    if constexpr (kAsync) asm volatile("cp.async.commit_group;" ::: "memory");
  };
  // a lane's words: step lane + 32 s lies 32 s C words past step lane's
  // (the swizzle repeats every 8 rows)
  const int wl = chan_word(lane, c0, C, lg);

  // tiles j0 .. j0 + kChanStages - 2 ahead; a copy group per tile (an
  // empty one past the walk's end), so that group j - j0 is tile j's
#pragma unroll
  for (int s = 0; s + 1 < kChanStages; ++s) load(j0 + s, s);
  for (int64_t j = j0; j < j1; ++j) {
    const int st = static_cast<int>((j - j0) % kChanStages);
    before(j);
    if constexpr (kAsync)
      asm volatile("cp.async.wait_group %0;" ::"n"(kChanStages - 2)
                   : "memory");
    __syncthreads();   // tile j is in; stage (j - 1)'s stores are done
    load(j + kChanStages - 1, static_cast<int>((j - j0 + kChanStages - 1) %
                                               kChanStages));
    float* sa = stage + st * 2 * words;
    tile(j, sa, sa + words, wl);
    __syncthreads();   // every warp's outputs are in the stage
    int64_t dst = base + j * BT * g.d + g0;
    for (int w = w0; w < words; w += R * C, dst += R * g.d) {
      const float4 o4 = *reinterpret_cast<const float4*>(sa + w);
      const float o[4] = {o4.x, o4.y, o4.z, o4.w};
      store4<kVec>(out + dst, o);
    }
  }
}

template <typename T, int NS, bool kVec>
__global__ void __launch_bounds__(chan_reg_threads(NS), 1)
carry_chan_reg_kernel(Tensors t, Leaves running, Geom g, int exclusive) {
  using S = AffineSpec<T>;
  using P = typename S::E;
  constexpr int V = chan_reg_lanes(NS);
  const int lane = threadIdx.x % 32, c0 = threadIdx.x / 32 * V;
  const int64_t cbase = chain_base<true>(g, blockIdx.x);
  P carry[V];
#pragma unroll
  for (int v = 0; v < V; ++v) carry[v] = S::identity();
  chan_reg_walk<T, NS, kVec>(
      t, g, blockIdx.x, 0, g.chunks, [](int64_t) {},
      [&](int64_t j, float* sa, const float* sb, int wl) {
        P x[NS][V];
        chan_read<S, NS, V>(x, sa, sb, wl, g.width);
        chan_scan<S, NS, V>(x, lane);
        chan_emit<S, NS, V>(x, carry, sa, wl, g.width, lane, exclusive);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          carry[v] = S::combine(carry[v], shfl_e(x[NS - 1][v], 31));
          if (running.v != nullptr && lane == 0)
            S::put(running, cbase + j * g.d + c0 + v, carry[v]);
        }
      });
}

// apply on Channels in registers: the affine pair's apply (kChanReg) on
// the tiles carry_chan_reg_kernel takes, the shapes cuda.tile_network
// sends here. carry_chan_reg_kernel's walk, the two-stage copies and the
// network, with each tile's offsets read from the chain in place of the
// carry that advances: carry_chan_reg_kernel emits carry (+) x where carry
// is the left fold of the tiles' last elements from the identity, which
// is exactly the chain's offset (chain_chan_kernel over
// totals_chan_reduce_kernel's or totals_kernel's totals), so the outputs
// are carry's bits. Lane l of each warp reads its channels' offsets (the
// same two words for every lane of the warp) before the block waits for
// the tile's copies. A block walks `walk` consecutive tiles of one strip
// (the launcher makes it the lane's whole length unless there are too
// few strips to fill the card), so that the next tile's copies overlap
// the current scan. Bound: device-memory bytes, read 2 n and the
// offsets, write n.
template <typename T, int NS, bool kVec>
__global__ void __launch_bounds__(chan_reg_threads(NS), 1)
apply_chan_reg_kernel(Tensors t, Leaves offsets, Geom g, int walk,
                      int exclusive) {
  using S = AffineSpec<T>;
  using P = typename S::E;
  constexpr int V = chan_reg_lanes(NS);
  const int lane = threadIdx.x % 32, c0 = threadIdx.x / 32 * V;
  const uint32_t parts = static_cast<uint32_t>((g.chunks + walk - 1) / walk);
  const uint32_t strip = blockIdx.x / parts;
  const int64_t j0 = static_cast<int64_t>(blockIdx.x % parts) * walk;
  const int64_t j1 = j0 + walk < g.chunks ? j0 + walk : g.chunks;
  const int64_t cbase = chain_base<true>(g, strip);
  P left[V];
  chan_reg_walk<T, NS, kVec>(
      t, g, strip, j0, j1,
      [&](int64_t j) {
#pragma unroll
        for (int v = 0; v < V; ++v)
          left[v] = S::get(offsets, cbase + j * g.d + c0 + v);
      },
      [&](int64_t, float* sa, const float* sb, int wl) {
        P x[NS][V];
        chan_read<S, NS, V>(x, sa, sb, wl, g.width);
        chan_scan<S, NS, V>(x, lane);
        chan_emit<S, NS, V>(x, left, sa, wl, g.width, lane, exclusive);
      });
}

// tree on Channels in registers: the affine pair's tree (kChanReg) on the
// tiles carry_chan_reg_kernel takes, the shapes cuda.tile_network sends
// here. carry_chan_reg_kernel's walk (the two-stage cp.async copies, the
// swizzled stage, a warp two adjacent channels, lane l their steps l +
// 32 s, each channel on its own) with tree_kernel's Blelloch sweep as the
// network (chan_tree) and its emission and carry step: the output is
// carry (+) excl, or carry (+) (excl (+) x) for the inclusive form, the
// carry the LEFT operand, and the next carry carry (+) root, the
// up-sweep's total; running totals as tree_kernel's. The bits of
// tree_kernel and tree_plain. Bound: device-memory bytes, read 2 n and
// write n, as the carry.
template <typename T, int NS, bool kVec>
__global__ void __launch_bounds__(chan_reg_threads(NS), 1)
tree_chan_reg_kernel(Tensors t, Leaves running, Geom g, int exclusive) {
  using S = AffineSpec<T>;
  using P = typename S::E;
  constexpr int V = chan_reg_lanes(NS);
  const int lane = threadIdx.x % 32, c0 = threadIdx.x / 32 * V;
  const int64_t cbase = chain_base<true>(g, blockIdx.x);
  P carry[V];
#pragma unroll
  for (int v = 0; v < V; ++v) carry[v] = S::identity();
  chan_reg_walk<T, NS, kVec>(
      t, g, blockIdx.x, 0, g.chunks, [](int64_t) {},
      [&](int64_t j, float* sa, const float* sb, int wl) {
        P x[NS][V], root[V];
        chan_read<S, NS, V>(x, sa, sb, wl, g.width);
        chan_tree<S, NS, V>(x, root, lane);
        chan_tree_emit<S, NS, V>(x, carry, sa, sb, wl, g.width, exclusive);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          carry[v] = S::combine(carry[v], root[v]);
          if (running.v != nullptr && lane == 0)
            S::put(running, cbase + j * g.d + c0 + v, carry[v]);
        }
      });
}

// fused on Channels in registers: the affine pair's fused schedule
// (kChanReg) on the tiles carry_chan_reg_kernel takes, the shapes
// cuda.tile_network sends here. carry_chan_reg_kernel's network on one tile
// a block, fused_kernel's ticket, look-back and publication around it:
//   * a block takes one (strip, time tile) in ticket order, as fused_kernel
//     does: the strip's C = width channels (cuda.chan_reg_width: 32 at the
//     SSD carry, 128-byte rows of float32), bt = 32 NS steps;
//   * the scan warps (1 ..) copy the tile into shared memory as
//     carry_chan_reg_kernel does (swizzled 16-byte cp.async copies for
//     float32 from aligned bases, else vector loads), one stage, while warp
//     0 takes the tile's offset by the look-back over the strip's earlier
//     tiles (lookback_arrays: lane l its channel's, folded left to right
//     from the nearest inclusive prefix);
//   * the scan warps run carry_chan_reg_kernel's network (a warp four
//     adjacent channels, fused_chan_lanes, lane l steps l + 32 s;
//     chan_scan), publish the
//     tile's aggregate (each channel's last element: lane 31's last slot)
//     and release the "aggregate" state as soon as the tile is scanned, so
//     that a long lane's later tiles do not wait in a chain;
//   * then warp 0 publishes the inclusive prefix offset (+) aggregate and
//     the scan warps emit offset (+) x (the offset the LEFT operand, as
//     carry's carry; chan_emit) through the stage with the copies' layout.
// The network's bits are carry_chan_reg_kernel's and the offset the
// chain's left fold, so the outputs are carry's, decoupled's and
// fused_kernel's, signed zeros included. A block's copies, scan, look-back
// and stores follow each other, so blocks overlap one another's: the
// launch bounds ask for two an SM, where the carry's one block overlaps
// its own tiles (one fused block an SM took a third longer at the SSD
// carry; four channels a lane, eight scan warps a 32-channel strip, came
// closest to the copies' own time: PERF.md, tools/chan_variants.py).
// Named barrier 1: the scan warps alone.
template <typename T, int NS, bool kVec>
__global__ void __launch_bounds__(fused_chan_threads(NS), 2)
fused_chan_reg_kernel(Tensors t, uint64_t* state, Leaves agg, Leaves incl,
                      Geom g, int exclusive) {
  using S = AffineSpec<T>;
  using P = typename S::E;   // an (a, b) pair
  constexpr int V = fused_chan_lanes(NS), BT = 32 * NS;
  constexpr bool kAsync = kVec && std::is_same<T, float>::value;
  extern __shared__ __align__(16) float stage[];   // [a, b][BT][C]
  __shared__ uint32_t ticket;
  __shared__ P pre_s[kMaxWidth], last_s[kMaxWidth];   // offset, aggregate
  const int C = g.width, lg = __ffs(C >> 2) - 1, words = BT * C;
  const int scan_threads = blockDim.x - 32;
  if (threadIdx.x == 0)
    ticket = atomicAdd(reinterpret_cast<unsigned*>(state), 1u);
  __syncthreads();
  const uint32_t j = ticket % static_cast<uint32_t>(g.chunks);
  int64_t tile, chain;
  tile_at<true>(g, ticket, tile, chain);
  const int64_t cbase = chain - j * g.d;           // the lane's chain entries
  uint64_t* st = state + 1 + (ticket - j);         // and its tile states
  const bool publish = j + 1 < g.chunks;           // a successor reads it
  const int u = threadIdx.x - 32;                  // the scan thread
  // as carry_chan_reg_kernel's copies, over the scan threads: chunk c of
  // rows i0, i0 + R, ..., R = scan threads / (C / 4)
  const int R = scan_threads >> lg;
  const int i0 = u >> lg, c = (u & ((C >> 2) - 1)) << 2;
  const int w0 = chan_word(i0, c, C, lg);
  const int64_t g0 = i0 * g.d + c;
  const int lane = threadIdx.x % 32, c0 = (u >> 5) * V;
  P x[NS][V];
  if (threadIdx.x < 32) {
    P pre = S::identity();
    if (j > 0) pre = lookback_arrays<S>(st, j, agg, incl, cbase, g.d, C);
    if (lane < C) pre_s[lane] = pre;
  } else {
    const T* xa = static_cast<const T*>(t.x);
    const T* xb = static_cast<const T*>(t.y);
    int64_t src = tile + g0;
    for (int w = w0; w < words; w += R * C, src += R * g.d) {
      if constexpr (kAsync) {
        cp_async16(stage + w, reinterpret_cast<const float*>(xa) + src);
        cp_async16(stage + words + w,
                   reinterpret_cast<const float*>(xb) + src);
      } else {
        float v[4];
        load4<kVec>(xa + src, v);
        *reinterpret_cast<float4*>(stage + w) =
            make_float4(v[0], v[1], v[2], v[3]);
        load4<kVec>(xb + src, v);
        *reinterpret_cast<float4*>(stage + words + w) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
    }
    if constexpr (kAsync)
      asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" :::
                   "memory");
    asm volatile("bar.sync 1, %0;" ::"r"(scan_threads) : "memory");
    const int wl = chan_word(lane, c0, C, lg);
    chan_read<S, NS, V>(x, stage, stage + words, wl, C);
    chan_scan<S, NS, V>(x, lane);
    // the aggregate: each channel's last element, lane 31's last slot
    if (lane == 31) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        last_s[c0 + v] = x[NS - 1][v];
        if (j > 0 && publish)
          S::put(agg, cbase + j * g.d + c0 + v, x[NS - 1][v]);
      }
      if (j > 0 && publish) __threadfence();
    }
    asm volatile("bar.sync 1, %0;" ::"r"(scan_threads) : "memory");
    if (u == 0 && j > 0 && publish) st_release(st + j, kAggregate);
  }
  __syncthreads();   // the offsets and the aggregates are in
  if (threadIdx.x < 32) {   // the inclusive prefix offset (+) aggregate
    if (publish) {
      if (lane < C) {
        S::put(incl, cbase + j * g.d + lane,
               S::combine(pre_s[lane], last_s[lane]));
        if (C > 1) __threadfence();
      }
      __syncwarp();
      if (lane == 0) st_release(st + j, kInclusive);
    }
  } else {
    P left[V];
#pragma unroll
    for (int v = 0; v < V; ++v) left[v] = pre_s[c0 + v];
    chan_emit<S, NS, V>(x, left, stage, chan_word(lane, c0, C, lg), C, lane,
                        exclusive);
    asm volatile("bar.sync 1, %0;" ::"r"(scan_threads) : "memory");
    T* out = static_cast<T*>(t.out);
    int64_t dst = tile + g0;
    for (int w = w0; w < words; w += R * C, dst += R * g.d) {
      const float4 o4 = *reinterpret_cast<const float4*>(stage + w);
      const float o[4] = {o4.x, o4.y, o4.z, o4.w};
      store4<kVec>(out + dst, o);
    }
  }
}

// Opts in to more than 48 KB of shared memory, static included (fused
// adds up to 4 KB of its own).
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes + 8 * 1024 <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// The geometry of the C interface: Rows (chan 0) pass (rows, n, 1, 1);
// Channels (chan 1) pass (B, T, D, width).
Geom make_geom(int chan, long long n, long long d, int width, int bn) {
  if (!chan) return Geom{n, 1, n / bn, 1, 1, bn};
  return Geom{n, d, n / bn, static_cast<uint32_t>(d / width), width, bn};
}

long long lanes_of(int chan, long long b, long long d, int width) {
  return chan ? b * (d / width) : b;
}

// The register network's operands: bases aligned to four elements (the
// segmented flags to four int32) take vector accesses.
template <typename S>
bool runs_aligned(const Tensors& t) {
  constexpr uintptr_t v = 4 * sizeof(typename S::In) - 1;
  return (reinterpret_cast<uintptr_t>(t.x) & v) == 0 &&
         (reinterpret_cast<uintptr_t>(t.out) & v) == 0 &&
         (t.y == nullptr || (reinterpret_cast<uintptr_t>(t.y) & 15) == 0);
}

// A block of the register network: a warp per `segs` segments of the
// tile, at most `warps` warps.
int reg_threads(int bn, int segs, int warps) {
  const int need = (bn / kLanes + segs - 1) / segs;
  return 32 * (need < warps ? need : warps);
}

// Bases (x, y and out; a null out counts as aligned) aligned to four
// elements: the Channels register kernels take vector accesses
// (cp.async for float32).
template <typename T>
bool chan_vec(const Tensors& t) {
  constexpr uintptr_t v4 = 4 * sizeof(T) - 1;
  return ((reinterpret_cast<uintptr_t>(t.x) | reinterpret_cast<uintptr_t>(t.y) |
           reinterpret_cast<uintptr_t>(t.out)) & v4) == 0;
}

// The card's SMs, for the launchers that size their grids by it.
cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return err;
}

// The strips carry_chan_reg_kernel, apply_chan_reg_kernel and
// tree_chan_reg_kernel take on tiles of 32 NS steps: `width` channels, a multiple of 4 that divides D,
// at most a block's (32 over bt 256); their stages' shared memory.
template <int NS>
bool chan_reg_takes(long long d, int width) {
  return width % 4 == 0 &&
         32 * width / chan_reg_lanes(NS) <= chan_reg_threads(NS) &&
         d % width == 0;
}
template <int NS>
size_t chan_reg_smem(int width) {
  return kChanStages * 2 * sizeof(float) * 32 * NS * width;
}

// carry_chan_reg_kernel (kTree: tree_chan_reg_kernel) over the strips
// chan_reg_takes; refuses any other.
template <typename T, int NS, bool kTree = false>
int launch_chan_reg(Tensors t, Leaves running, long long b, long long n,
                    long long d, int width, int exclusive,
                    cudaStream_t stream) {
  constexpr int V = chan_reg_lanes(NS);
  if (!chan_reg_takes<NS>(d, width)) return cudaErrorInvalidValue;
  const Geom g = make_geom(true, n, d, width, 32 * NS);
  const size_t smem = chan_reg_smem<NS>(width);
  void (*kern)(Tensors, Leaves, Geom, int);
  if constexpr (kTree)
    kern = chan_vec<T>(t) ? tree_chan_reg_kernel<T, NS, true>
                          : tree_chan_reg_kernel<T, NS, false>;
  else
    kern = chan_vec<T>(t) ? carry_chan_reg_kernel<T, NS, true>
                          : carry_chan_reg_kernel<T, NS, false>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<static_cast<unsigned>(lanes_of(true, b, d, width)), 32 * width / V,
         smem, stream>>>(t, running, g, exclusive);
  return cudaGetLastError();
}

// apply_chan_reg_kernel over the strips chan_reg_takes (refuses any
// other). A block walks a strip's whole length, unless the strips are
// fewer than kChanFill blocks an SM: then each strip's walk is cut into
// as many parts as make up that many blocks.
constexpr int kChanFill = 4;

template <typename T, int NS>
int launch_apply_chan_reg(Tensors t, Leaves offsets, long long b, long long n,
                          long long d, int width, int exclusive,
                          cudaStream_t stream) {
  constexpr int V = chan_reg_lanes(NS);
  if (!chan_reg_takes<NS>(d, width)) return cudaErrorInvalidValue;
  const Geom g = make_geom(true, n, d, width, 32 * NS);
  const size_t smem = chan_reg_smem<NS>(width);
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const long long lanes = lanes_of(true, b, d, width);
  long long parts = (static_cast<long long>(kChanFill) * sms + lanes - 1) / lanes;
  if (parts > g.chunks) parts = g.chunks;
  if (parts < 1) parts = 1;
  const long long walk = (g.chunks + parts - 1) / parts;
  const long long blocks = lanes * ((g.chunks + walk - 1) / walk);
  auto kern = chan_vec<T>(t) ? apply_chan_reg_kernel<T, NS, true>
                             : apply_chan_reg_kernel<T, NS, false>;
  err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<static_cast<unsigned>(blocks), 32 * width / V, smem, stream>>>(
      t, offsets, g, static_cast<int>(walk), exclusive);
  return cudaGetLastError();
}

// totals_chan_reduce_kernel over (b, n, d) with tiles of BT steps: four
// channels a thread where D and the bases allow 16-byte (8-byte) loads,
// else one.
template <typename T, int BT>
int launch_totals_chan_reduce(Tensors t, Leaves totals, long long b,
                              long long n, long long d, cudaStream_t stream) {
  const bool vec = d % 4 == 0 && chan_vec<T>(t);
  const long long groups = vec ? d / 4 : d;
  const long long items = b * (n / BT) * groups;
  const unsigned blocks = static_cast<unsigned>(
      (items + kChanReduceThreads - 1) / kChanReduceThreads);
  if (vec)
    totals_chan_reduce_kernel<T, BT, 4><<<blocks, kChanReduceThreads, 0,
                                          stream>>>(t, totals, groups, items, d);
  else
    totals_chan_reduce_kernel<T, BT, 1><<<blocks, kChanReduceThreads, 0,
                                          stream>>>(t, totals, groups, items, d);
  return cudaGetLastError();
}

// fused_chan_reg_kernel over Channels strips of `width` channels (a
// multiple of 4, at most 32) and tiles of 32 NS steps; refuses any other.
template <typename T, int NS>
int launch_fused_chan_reg(Tensors t, uint64_t* state, Leaves agg, Leaves incl,
                          long long b, long long n, long long d, int width,
                          int exclusive, cudaStream_t stream) {
  constexpr int V = fused_chan_lanes(NS);
  if (width % 4 != 0 || 32 + 32 * width / V > fused_chan_threads(NS) ||
      width * 32 * NS > 8192 || d % width != 0)
    return cudaErrorInvalidValue;
  const Geom g = make_geom(true, n, d, width, 32 * NS);
  const size_t smem = 2 * sizeof(float) * 32 * NS * width;
  const bool vec = chan_vec<T>(t);
  auto kern = vec ? fused_chan_reg_kernel<T, NS, true>
                  : fused_chan_reg_kernel<T, NS, false>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const long long tiles = lanes_of(true, b, d, width) * (n / (32 * NS));
  kern<<<static_cast<unsigned>(tiles), 32 + 32 * width / V, smem, stream>>>(
      t, state, agg, incl, g, exclusive);
  return cudaGetLastError();
}

// net: the in-tile network the wrapper chose by shape (cuda.tile_network):
// 1 the register network, for Rows tiles of 128 r elements of a kReg spec
// and Channels tiles of 128, 256 or 512 steps of a kChanReg spec (carry,
// apply, fused and tree; anything else is refused); 0 the network in shared memory (tile_scan, or tree_kernel's
// sweep).
template <typename S, bool kChan>
int launch_carry(Tensors t, Leaves running, long long b, long long n,
                 long long d, int width, int bn, int exclusive, int net,
                 cudaStream_t stream) {
  if (net) {
    if constexpr (!kChan && S::kReg) {
      if (bn % kLanes != 0) return cudaErrorInvalidValue;
      const Geom g = make_geom(false, n, 1, 1, bn);
      if (runs_aligned<S>(t))
        carry_reg_kernel<S, true><<<static_cast<unsigned>(b),
                                    reg_threads(bn, kCarrySegs, kRegWarps), 0,
                                    stream>>>(t, running, g, exclusive);
      else
        carry_reg_kernel<S, false><<<static_cast<unsigned>(b),
                                     reg_threads(bn, kCarrySegs, kRegWarps), 0,
                                     stream>>>(t, running, g, exclusive);
      return cudaGetLastError();
    } else if constexpr (kChan && S::kChanReg) {
      switch (bn) {
        case 128:
          return launch_chan_reg<typename S::In, 4>(t, running, b, n, d, width,
                                                    exclusive, stream);
        case 256:
          return launch_chan_reg<typename S::In, 8>(t, running, b, n, d, width,
                                                    exclusive, stream);
        case 512:
          return launch_chan_reg<typename S::In, 16>(t, running, b, n, d,
                                                     width, exclusive, stream);
        default:
          return cudaErrorInvalidValue;
      }
    } else {
      return cudaErrorInvalidValue;
    }
  }
  const Geom g = make_geom(kChan, n, d, width, bn);
  const size_t smem = network_bytes<S>(bn, g.width);
  cudaError_t err = allow_smem(carry_kernel<S, kChan>, smem);
  if (err != cudaSuccess) return err;
  carry_kernel<S, kChan><<<static_cast<unsigned>(lanes_of(kChan, b, d, width)),
                           kThreads, smem, stream>>>(t, running, g, exclusive);
  return cudaGetLastError();
}

// A grid of as many blocks as the card holds at once (each warp strides
// over the tiles), fewer where there are fewer tiles.
template <typename S>
int launch_totals_reduce(const Tensors& t, Leaves totals, long long tiles,
                         int bn, cudaStream_t stream) {
  static int per_sm = 0;  // resident blocks per SM, once per instantiation
  cudaError_t err = cudaSuccess;
  if (per_sm == 0)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, totals_reduce_kernel<S>, kReduceThreads, 0);
  int sms = 0;
  if (err == cudaSuccess) err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const long long warps = kReduceThreads / 32;
  const long long need = (tiles + warps - 1) / warps;
  const long long fill = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  totals_reduce_kernel<S><<<static_cast<unsigned>(need < fill ? need : fill),
                            kReduceThreads, 0, stream>>>(t, totals, tiles, bn);
  return cudaGetLastError();
}

// net (cuda.tile_network's choice for "totals"): 1 the reduction without
// the scan, totals_reduce_kernel for Rows tiles of the sum, the segmented
// sum and the mask (kReduce) and totals_chan_reduce_kernel for Channels tiles of 128, 256
// or 512 steps of the affine pair (kChanReg); anything else is refused.
// 0 the network's totals_kernel.
template <typename S, bool kChan>
int launch_totals(Tensors t, Leaves totals, long long b, long long n,
                  long long d, int width, int bn, int net,
                  cudaStream_t stream) {
  if (net) {
    if constexpr (!kChan && S::kReduce) {
      return launch_totals_reduce<S>(t, totals, b * (n / bn), bn, stream);
    } else if constexpr (kChan && S::kChanReg) {
      using T = typename S::In;
      switch (bn) {
        case 128:
          return launch_totals_chan_reduce<T, 128>(t, totals, b, n, d, stream);
        case 256:
          return launch_totals_chan_reduce<T, 256>(t, totals, b, n, d, stream);
        case 512:
          return launch_totals_chan_reduce<T, 512>(t, totals, b, n, d, stream);
        default:
          return cudaErrorInvalidValue;
      }
    } else {
      return cudaErrorInvalidValue;
    }
  }
  const Geom g = make_geom(kChan, n, d, width, bn);
  const size_t smem = network_bytes<S>(bn, g.width);
  cudaError_t err = allow_smem(totals_kernel<S, kChan>, smem);
  if (err != cudaSuccess) return err;
  const long long tiles = lanes_of(kChan, b, d, width) * (n / bn);
  totals_kernel<S, kChan><<<static_cast<unsigned>(tiles), kThreads, smem,
                            stream>>>(t, totals, g);
  return cudaGetLastError();
}

template <typename S, bool kChan>
int launch_chain(Leaves totals, Leaves offsets, Leaves running, long long b,
                 long long chunks, long long d, cudaStream_t stream) {
  if (kChan) {
    const long long lanes = b * d;
    chain_chan_kernel<S><<<static_cast<unsigned>((lanes + 127) / 128), 128, 0,
                           stream>>>(totals, offsets, running, b, chunks, d);
  } else if constexpr (S::kExact) {
    // whole warps, enough to give each thread 32 bytes of totals a step
    constexpr long long items = 32 / sizeof(typename S::E);
    const long long per = (chunks + items - 1) / items;
    const int threads = static_cast<int>(
        per >= kScanThreads ? kScanThreads : (per + 31) / 32 * 32);
    chain_scan_kernel<S><<<static_cast<unsigned>(b), threads, 0, stream>>>(
        totals, offsets, running, chunks);
  } else {
    chain_seq_kernel<S><<<static_cast<unsigned>(b), kChainThreads, 0,
                          stream>>>(totals, offsets, running, chunks);
  }
  return cudaGetLastError();
}

template <typename S, bool kChan>
int launch_apply(Tensors t, Leaves offsets, long long b, long long n,
                 long long d, int width, int bn, int exclusive, int net,
                 cudaStream_t stream) {
  if (net) {
    if constexpr (!kChan && S::kReg) {
      if (bn % kLanes != 0) return cudaErrorInvalidValue;
      const Geom g = make_geom(false, n, 1, 1, bn);
      const unsigned tiles = static_cast<unsigned>(b * (n / bn));
      const int threads = reg_threads(bn, fused_segs<S>(), kFusedWarps);
      if (runs_aligned<S>(t))
        apply_reg_kernel<S, true><<<tiles, threads, 0, stream>>>(t, offsets, g,
                                                                 exclusive);
      else
        apply_reg_kernel<S, false><<<tiles, threads, 0, stream>>>(t, offsets, g,
                                                                  exclusive);
      return cudaGetLastError();
    } else if constexpr (kChan && S::kChanReg) {
      using T = typename S::In;
      switch (bn) {
        case 128:
          return launch_apply_chan_reg<T, 4>(t, offsets, b, n, d, width,
                                             exclusive, stream);
        case 256:
          return launch_apply_chan_reg<T, 8>(t, offsets, b, n, d, width,
                                             exclusive, stream);
        case 512:
          return launch_apply_chan_reg<T, 16>(t, offsets, b, n, d, width,
                                              exclusive, stream);
        default:
          return cudaErrorInvalidValue;
      }
    } else {
      return cudaErrorInvalidValue;
    }
  }
  const Geom g = make_geom(kChan, n, d, width, bn);
  const size_t smem = network_bytes<S>(bn, g.width);
  cudaError_t err = allow_smem(apply_kernel<S, kChan>, smem);
  if (err != cudaSuccess) return err;
  const long long tiles = lanes_of(kChan, b, d, width) * (n / bn);
  apply_kernel<S, kChan><<<static_cast<unsigned>(tiles), kThreads, smem,
                           stream>>>(t, offsets, g, exclusive);
  return cudaGetLastError();
}

template <typename S, bool kChan>
int launch_fused(Tensors t, uint64_t* state, Leaves agg, Leaves incl,
                 long long b, long long n, long long d, int width, int bn,
                 int exclusive, int net, cudaStream_t stream) {
  if (net) {
    if constexpr (!kChan && S::kReg) {
      if (bn % kLanes != 0) return cudaErrorInvalidValue;
      const Geom g = make_geom(false, n, 1, 1, bn);
      const unsigned tiles = static_cast<unsigned>(b * (n / bn));
      const int threads = reg_threads(bn, fused_segs<S>(), kFusedWarps);
      if (runs_aligned<S>(t))
        fused_reg_kernel<S, true><<<tiles, threads, 0, stream>>>(t, state, g,
                                                                 exclusive);
      else
        fused_reg_kernel<S, false><<<tiles, threads, 0, stream>>>(t, state, g,
                                                                  exclusive);
      return cudaGetLastError();
    } else if constexpr (kChan && S::kChanReg) {
      using T = typename S::In;
      switch (bn) {
        case 128:
          return launch_fused_chan_reg<T, 4>(t, state, agg, incl, b, n, d,
                                             width, exclusive, stream);
        case 256:
          return launch_fused_chan_reg<T, 8>(t, state, agg, incl, b, n, d,
                                             width, exclusive, stream);
        case 512:
          return launch_fused_chan_reg<T, 16>(t, state, agg, incl, b, n, d,
                                              width, exclusive, stream);
        default:
          return cudaErrorInvalidValue;
      }
    } else {
      return cudaErrorInvalidValue;
    }
  }
  const Geom g = make_geom(kChan, n, d, width, bn);
  const size_t smem = network_bytes<S>(bn, g.width);
  cudaError_t err = allow_smem(fused_kernel<S, kChan>, smem);
  if (err != cudaSuccess) return err;
  const long long tiles = lanes_of(kChan, b, d, width) * (n / bn);
  fused_kernel<S, kChan><<<static_cast<unsigned>(tiles), kThreads, smem,
                           stream>>>(t, state, agg, incl, g, exclusive);
  return cudaGetLastError();
}

template <typename S, bool kChan>
int launch_tree(Tensors t, Leaves running, long long b, long long n,
                long long d, int width, int bn, int exclusive, int net,
                cudaStream_t stream) {
  if (net) {
    if constexpr (!kChan && S::kReg) {
      if (bn % kLanes != 0) return cudaErrorInvalidValue;
      const Geom g = make_geom(false, n, 1, 1, bn);
      if (runs_aligned<S>(t))
        tree_reg_kernel<S, true><<<static_cast<unsigned>(b),
                                   reg_threads(bn, kCarrySegs, kRegWarps), 0,
                                   stream>>>(t, running, g, exclusive);
      else
        tree_reg_kernel<S, false><<<static_cast<unsigned>(b),
                                    reg_threads(bn, kCarrySegs, kRegWarps), 0,
                                    stream>>>(t, running, g, exclusive);
      return cudaGetLastError();
    } else if constexpr (kChan && S::kChanReg) {
      using T = typename S::In;
      switch (bn) {
        case 128:
          return launch_chan_reg<T, 4, true>(t, running, b, n, d, width,
                                             exclusive, stream);
        case 256:
          return launch_chan_reg<T, 8, true>(t, running, b, n, d, width,
                                             exclusive, stream);
        case 512:
          return launch_chan_reg<T, 16, true>(t, running, b, n, d, width,
                                              exclusive, stream);
        default:
          return cudaErrorInvalidValue;
      }
    } else {
      return cudaErrorInvalidValue;
    }
  }
  const Geom g = make_geom(kChan, n, d, width, bn);
  int m = 1;
  while (m < bn) m <<= 1;
  const size_t smem = S::buf_bytes(m * g.width) + S::buf_bytes(bn * g.width) +
                      2 * S::buf_bytes(kMaxWidth);
  cudaError_t err = allow_smem(tree_kernel<S, kChan>, smem);
  if (err != cudaSuccess) return err;
  tree_kernel<S, kChan><<<static_cast<unsigned>(lanes_of(kChan, b, d, width)),
                          kThreads, smem, stream>>>(t, running, g, m, exclusive);
  return cudaGetLastError();
}

}  // namespace

// spec codes, as kernels/scan_engine/cuda.py numbers them: 0 sum,
// 1 segmented sum, 2 mask, 3 affine. dtype codes of the values: 0 float32,
// 1 bfloat16, 2 float16, 3 int32, 4 int16, 5 int8 (the mask takes int32,
// the affine spec the three float types). chan: 0 Rows, 1 Channels.
#define SCAN_SPECS(fn, CH, ...)                                       \
  case 0: return fn<SumSpec<float>, CH>(__VA_ARGS__);                 \
  case 1: return fn<SumSpec<__nv_bfloat16>, CH>(__VA_ARGS__);         \
  case 2: return fn<SumSpec<__half>, CH>(__VA_ARGS__);                \
  case 3: return fn<SumSpec<int32_t>, CH>(__VA_ARGS__);               \
  case 4: return fn<SumSpec<int16_t>, CH>(__VA_ARGS__);               \
  case 5: return fn<SumSpec<int8_t>, CH>(__VA_ARGS__);                \
  case 8: return fn<SegSumSpec<float>, CH>(__VA_ARGS__);              \
  case 9: return fn<SegSumSpec<__nv_bfloat16>, CH>(__VA_ARGS__);      \
  case 10: return fn<SegSumSpec<__half>, CH>(__VA_ARGS__);            \
  case 11: return fn<SegSumSpec<int32_t>, CH>(__VA_ARGS__);           \
  case 12: return fn<SegSumSpec<int16_t>, CH>(__VA_ARGS__);           \
  case 13: return fn<SegSumSpec<int8_t>, CH>(__VA_ARGS__);            \
  case 19: return fn<MaskSpec, CH>(__VA_ARGS__);                      \
  case 24: return fn<AffineSpec<float>, CH>(__VA_ARGS__);             \
  case 25: return fn<AffineSpec<__nv_bfloat16>, CH>(__VA_ARGS__);     \
  case 26: return fn<AffineSpec<__half>, CH>(__VA_ARGS__);            \
  default: return cudaErrorInvalidValue;

#define SCAN_DISPATCH(chan, spec, dtype, fn, ...)                     \
  if (chan) {                                                         \
    switch ((spec) * 8 + (dtype)) { SCAN_SPECS(fn, true, __VA_ARGS__) } \
  }                                                                   \
  switch ((spec) * 8 + (dtype)) { SCAN_SPECS(fn, false, __VA_ARGS__) }

extern "C" {

// net (carry, apply, fused, tree): 1 the register network (Rows tiles of
// 128 r elements, no affine; the affine pair on Channels tiles of 128, 256
// or 512 steps), 0 the shared-memory network. net (totals): 1 the reduction (see launch_totals), 0 the
// network's totals_kernel.
int scan_carry(int spec, int dtype, int chan, const void* x, const void* y,
               void* out, void* run_v, void* run_f, long long b, long long n,
               long long d, int width, int bn, int exclusive, int sentinel,
               int net, void* stream) {
  const Tensors t{x, y, out, sentinel};
  const Leaves running{run_v, run_f};
  SCAN_DISPATCH(chan, spec, dtype, launch_carry, t, running, b, n, d, width,
                bn, exclusive, net, static_cast<cudaStream_t>(stream));
}

int scan_totals(int spec, int dtype, int chan, const void* x, const void* y,
                void* tot_v, void* tot_f, long long b, long long n,
                long long d, int width, int bn, int net, void* stream) {
  const Tensors t{x, y, nullptr, 0};
  const Leaves totals{tot_v, tot_f};
  SCAN_DISPATCH(chan, spec, dtype, launch_totals, t, totals, b, n, d, width,
                bn, net, static_cast<cudaStream_t>(stream));
}

// The chain's dtype code is its totals' accumulation dtype: 0 float32 or
// 3 int32. Rows chains are (b, chunks), Channels chains (b, chunks, d).
int scan_chain(int spec, int dtype, int chan, const void* tot_v,
               const void* tot_f, void* off_v, void* off_f, void* run_v,
               void* run_f, long long b, long long chunks, long long d,
               void* stream) {
  if (dtype != 0 && dtype != 3) return cudaErrorInvalidValue;
  const Leaves totals{const_cast<void*>(tot_v), const_cast<void*>(tot_f)};
  const Leaves offsets{off_v, off_f};
  const Leaves running{run_v, run_f};
  SCAN_DISPATCH(chan, spec, dtype, launch_chain, totals, offsets, running, b,
                chunks, d, static_cast<cudaStream_t>(stream));
}

int scan_apply(int spec, int dtype, int chan, const void* x, const void* y,
               const void* off_v, const void* off_f, void* out, long long b,
               long long n, long long d, int width, int bn, int exclusive,
               int sentinel, int net, void* stream) {
  const Tensors t{x, y, out, sentinel};
  const Leaves offsets{const_cast<void*>(off_v), const_cast<void*>(off_f)};
  SCAN_DISPATCH(chan, spec, dtype, launch_apply, t, offsets, b, n, d, width,
                bn, exclusive, net, static_cast<cudaStream_t>(stream));
}

// state: 1 + tiles zeroed 64-bit words; agg/inc: chain_shape leaves (not
// read or written where the state words carry the values).
int scan_fused(int spec, int dtype, int chan, const void* x, const void* y,
               void* out, void* state, void* agg_v, void* agg_f, void* inc_v,
               void* inc_f, long long b, long long n, long long d, int width,
               int bn, int exclusive, int sentinel, int net, void* stream) {
  const Tensors t{x, y, out, sentinel};
  const Leaves agg{agg_v, agg_f};
  const Leaves incl{inc_v, inc_f};
  SCAN_DISPATCH(chan, spec, dtype, launch_fused, t,
                static_cast<uint64_t*>(state), agg, incl, b, n, d, width, bn,
                exclusive, net, static_cast<cudaStream_t>(stream));
}

int scan_tree(int spec, int dtype, int chan, const void* x, const void* y,
              void* out, void* run_v, void* run_f, long long b, long long n,
              long long d, int width, int bn, int exclusive, int sentinel,
              int net, void* stream) {
  const Tensors t{x, y, out, sentinel};
  const Leaves running{run_v, run_f};
  SCAN_DISPATCH(chan, spec, dtype, launch_tree, t, running, b, n, d, width,
                bn, exclusive, net, static_cast<cudaStream_t>(stream));
}

const char* scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
