#!/usr/bin/env python3
"""Time forms of the affine chain on Channels against each other at the
SSD carry's totals, on one card, in one process (card only).

    PYTHONPATH=src python3 tools/chain_variants.py

The chain turns (B, chunks, D) chunk totals (a, b) into their exclusive
scan along the chunks, left to right from (1, 0), with the affine
combine (a1 a2, a2 b1 + b2) rounded twice. The forms here differ only
in how threads take channels and chunks and in their load and store
paths; each is a small kernel of its own in one source built with
``nvcc`` (seconds, beside the minutes of ``csrc/scan_sum.cu``):

  first        a thread a channel, load -> store chunk by chunk (the
               chain's first form)
  first_rs     the same with __restrict__ pointers
  v1           a thread a channel, each group of four chunks' loads
               before the group's fold (``chain_chan_kernel``'s
               organization)
  v1_g8        the same in groups of eight chunks
  v2, v4       two or four adjacent channels a thread (8- or 16-byte
               accesses), all chunks' loads before the fold
  v4_ldg       v4 through the read-only path
  v4_stcs      v4 with evict-first stores (a diagnostic: the offsets
               are read by apply right after)
  port         ``chain_chan_kernel`` through ``cuda.chain``

Each is held bitwise against ``first`` and ``exclusive_chain``, then
timed by CUDA events around one call and from CUDA graph replays (20
calls a graph), in turns over three rounds, at (1, 4, 458752), the
chunks zamba2-7b's SSD carry gives at a 131,072-token prefill, and at
(1, 16, 458752).
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels.scan_engine import cuda, monoids, schedules

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

struct P { float a, b; };
__device__ __forceinline__ P comb(P l, P r) {
  return {__fmul_rn(l.a, r.a), __fadd_rn(__fmul_rn(r.a, l.b), r.b)};
}

template <bool kRestrict>
__global__ void first(const float* ta, const float* tb, float* oa, float* ob,
                      int64_t b, int64_t chunks, int64_t d) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= b * d) return;
  const int64_t base = (lane / d) * chunks * d + lane % d;
  const float* __restrict__ ra = ta;
  const float* __restrict__ rb = tb;
  P acc = {1.f, 0.f};
  for (int64_t c = 0; c < chunks; ++c) {
    const P t = kRestrict ? P{ra[base + c * d], rb[base + c * d]}
                          : P{ta[base + c * d], tb[base + c * d]};
    oa[base + c * d] = acc.a;
    ob[base + c * d] = acc.b;
    acc = comb(acc, t);
  }
}

template <int V> struct Vec;
template <> struct Vec<1> { using T = float; };
template <> struct Vec<2> { using T = float2; };
template <> struct Vec<4> { using T = float4; };

template <int V, int L>   // L: 0 plain, 1 __ldg, 2 __ldg + __stcs
__device__ __forceinline__ void ld(const float* p, float (&v)[V]) {
  using T = typename Vec<V>::T;
  const T w = L ? __ldg(reinterpret_cast<const T*>(p))
                : *reinterpret_cast<const T*>(p);
  const float* f = reinterpret_cast<const float*>(&w);
#pragma unroll
  for (int i = 0; i < V; ++i) v[i] = f[i];
}
template <int V, int L>
__device__ __forceinline__ void st(float* p, const float (&v)[V]) {
  using T = typename Vec<V>::T;
  T w;
  float* f = reinterpret_cast<float*>(&w);
#pragma unroll
  for (int i = 0; i < V; ++i) f[i] = v[i];
  if (L == 2) __stcs(reinterpret_cast<T*>(p), w);
  else *reinterpret_cast<T*>(p) = w;
}

template <int V, int G, int L>
__global__ void batched(const float* __restrict__ ta,
                        const float* __restrict__ tb, float* oa, float* ob,
                        int64_t b, int64_t chunks, int64_t d) {
  const int64_t groups = d / V;
  const int64_t id = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (id >= b * groups) return;
  const int64_t row = id / groups;
  const int64_t base = row * chunks * d + (id - row * groups) * V;
  float aa[V], ab[V];
#pragma unroll
  for (int w = 0; w < V; ++w) { aa[w] = 1.f; ab[w] = 0.f; }
  for (int64_t c0 = 0; c0 < chunks; c0 += G) {
    float xa[G][V], xb[G][V];
#pragma unroll
    for (int u = 0; u < G; ++u) {
      if (c0 + u >= chunks) break;
      ld<V, L>(ta + base + (c0 + u) * d, xa[u]);
      ld<V, L>(tb + base + (c0 + u) * d, xb[u]);
    }
#pragma unroll
    for (int u = 0; u < G; ++u) {
      if (c0 + u >= chunks) break;
      st<V, L>(oa + base + (c0 + u) * d, aa);
      st<V, L>(ob + base + (c0 + u) * d, ab);
#pragma unroll
      for (int w = 0; w < V; ++w) {
        const P n = comb({aa[w], ab[w]}, {xa[u][w], xb[u][w]});
        aa[w] = n.a;
        ab[w] = n.b;
      }
    }
  }
}

extern "C" int run(int form, int threads, const float* ta, const float* tb,
                   float* oa, float* ob, long long b, long long chunks,
                   long long d, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long per = form == 3 ? 2 : form >= 4 && form <= 6 ? 4 : 1;
  const long long items = b * d / per;
  const unsigned blocks = (unsigned)((items + threads - 1) / threads);
  switch (form) {
    case 0: first<false><<<blocks, threads, 0, st>>>(ta, tb, oa, ob, b, chunks, d); break;
    case 1: first<true><<<blocks, threads, 0, st>>>(ta, tb, oa, ob, b, chunks, d); break;
    case 2: batched<1, 4, 0><<<blocks, threads, 0, st>>>(ta, tb, oa, ob, b, chunks, d); break;
    case 3: batched<2, 4, 0><<<blocks, threads, 0, st>>>(ta, tb, oa, ob, b, chunks, d); break;
    case 4: batched<4, 4, 0><<<blocks, threads, 0, st>>>(ta, tb, oa, ob, b, chunks, d); break;
    case 5: batched<4, 4, 1><<<blocks, threads, 0, st>>>(ta, tb, oa, ob, b, chunks, d); break;
    case 6: batched<4, 4, 2><<<blocks, threads, 0, st>>>(ta, tb, oa, ob, b, chunks, d); break;
    case 7: batched<1, 8, 0><<<blocks, threads, 0, st>>>(ta, tb, oa, ob, b, chunks, d); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
"""

FORMS = ("first", "first_rs", "v1", "v2", "v4", "v4_ldg", "v4_stcs",
         "v1_g8")
SHAPES = ((1, 4, 458752), (1, 16, 458752))


def time_ms(fn, reps=9):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn, calls=20, reps=5):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return time_ms(graph.replay, reps) / calls


def main() -> int:
    if not torch.cuda.is_available():
        print("chain_variants: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    build = cuda.BUILD_DIR / "variants"
    build.mkdir(parents=True, exist_ok=True)
    src = build / "chain_variants.cu"
    src.write_text(SOURCE)
    so, _ = cuda.compile_library(src, build)
    lib = ctypes.CDLL(str(so))
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.run.argtypes = (i, i, p, p, p, p, ll, ll, ll, p)
    lib.run.restype = ctypes.c_int
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for shape in SHAPES:
        ta = 0.5 + torch.rand(shape, device=dev, generator=gen)
        tb = torch.randn(shape, device=dev, generator=gen)
        want = schedules.exclusive_chain(monoids.AFFINE, (ta, tb))

        def call(form, threads=128):
            oa, ob = torch.empty_like(ta), torch.empty_like(tb)
            err = lib.run(form, threads, ta.data_ptr(), tb.data_ptr(),
                          oa.data_ptr(), ob.data_ptr(), shape[0], shape[1],
                          shape[2], torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"form {FORMS[form]}: error {err}")
            return oa, ob

        for f in range(len(FORMS)):
            got = call(f)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                if not torch.equal(g.view(torch.int32), w.view(torch.int32)):
                    print(f"{FORMS[f]} != exclusive_chain at {shape}",
                          file=sys.stderr)
                    return 1
        # the kernel chip_smoke times, through the port's wrapper
        port = (lambda: cuda.chain(monoids.AFFINE, (ta, tb))[0])
        events = {name: [] for name in FORMS + ("port",)}
        replays = {name: [] for name in FORMS + ("port",)}
        for _ in range(3):
            for f, name in enumerate(FORMS):
                events[name].append(time_ms(lambda: call(f)))
                replays[name].append(graph_ms(lambda: call(f)))
            events["port"].append(time_ms(port))
            replays["port"].append(graph_ms(port))
        print(f"affine chain at {shape}, 128 threads a block (bound "
              f"{4 * ta.numel() * 4 / 3.35e12 * 1e3:.4f} ms at 3.35 TB/s): "
              "graph replay ms a call, three rounds; one call's events")
        for name in FORMS + ("port",):
            print(f"  {name:9s} replay "
                  + " / ".join(f"{x:.4f}" for x in replays[name])
                  + "; events "
                  + " / ".join(f"{x:.4f}" for x in events[name]))
        for threads in (256, 512):
            print(f"  v4_ldg at {threads} threads a block: replay "
                  f"{graph_ms(lambda: call(5, threads)):.4f} ms; first "
                  f"{graph_ms(lambda: call(0, threads)):.4f} ms")
        del ta, tb, want
    return 0


if __name__ == "__main__":
    sys.exit(main())
