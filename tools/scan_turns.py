#!/usr/bin/env python3
"""Time the scan kernels of this checkout's ``csrc/scan_sum.cu`` (and,
given a second file, the softmax chain of its ``csrc/attn_fold.cu``)
against another build of the same file (for example the previous
commit's), on one card, in one process, in turns.

    mkdir -p build/other
    git show HEAD~1:src/repro_torch/csrc/scan_sum.cu > build/other/scan_sum.cu
    git show HEAD~1:src/repro_torch/csrc/attn_fold.cu > build/other/attn_fold.cu
    git show HEAD~1:src/repro_torch/csrc/attn_fold.cuh > build/other/attn_fold.cuh
    PYTHONPATH=src python3 tools/scan_turns.py build/other/scan_sum.cu \
        [build/other/attn_fold.cu]

The sources are compiled with ``nvcc`` in parallel (the other ones into
``build/other/``). Each pair of libraries shares its C interface, so the
wrappers of ``repro_torch.kernels.scan_engine.cuda`` and ``cuda_fold``
launch either: the tool swaps the loaded library between calls. Each row
runs at chip_smoke's shape, the other build on the network its row names
(the shared-memory network where it has no register form of the kernel):
the affine carry, apply, fused and tree at zamba2-7b's SSD carry (1,
1024, 458752) float32 with time tiles of 256 and the affine chain over
its (1, 4, 458752) totals, the segmented sum's totals at Q1's (4,
59144192) float32 with sparse flags and tiles of 2048, the sum's totals
at one column of 2^28 float32, and the softmax pair's split-KV chain with
its finalize at (g) phi3-medium-14b decode (160 x 8 rows, 16 splits, d
128, bf16 out) and (f) gemma2-9b's local layer (16 x 8192 rows, 16
splits, d 256, bf16 out and the statistics), on random partials. The two
builds' outputs are held bitwise equal first; then each row is one call
between CUDA events, median of 9, in turns: other, this, this, other;
the chains also from CUDA graph replays (20 calls a graph, median of 5
replays), in the same turns.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from repro_torch.core.scan import assoc
from repro_torch.kernels.scan_engine import (Channels, KVBlocks, Rows, cuda,
                                             cuda_fold, monoids)

SSD = (1, 1024, 458752)
Q1 = (4, 59144192)
N_SUM = 1 << 28
# the split-KV chains' layouts: (g) 4 x 40 q heads of 128 against 10 kv
# heads, one query padded to 8 rows; (f) local, 16 q / 8 kv heads of 256
# at T 8192, q blocks of 128
DECODE = KVBlocks(bh=160, bh_kv=40, tq=8, tk=131072, d=128, bq=8, bk=128,
                  group=4, splits=16)
LOCAL = KVBlocks(bh=16, bh_kv=8, tq=8192, tk=8192, d=256, bq=128, bk=128,
                 group=2, splits=16, out_dims=(256, 1, 1))


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
    """One call's device time from a CUDA graph of ``calls`` calls."""
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


def load(mod, source: Path, build_dir: Path) -> ctypes.CDLL:
    """The library of ``source``, bound as ``mod.build`` (``cuda`` or
    ``cuda_fold``) binds ``mod.SOURCE`` built into ``mod.BUILD_DIR``."""
    saved = mod.SOURCE, mod.BUILD_DIR, mod._lib
    mod.SOURCE, mod.BUILD_DIR, mod._lib = source, build_dir, None
    try:
        return mod.build()
    finally:
        mod.SOURCE, mod.BUILD_DIR, mod._lib = saved


def same_bits(a, b):
    if isinstance(a, torch.Tensor):
        view = {4: torch.int32, 2: torch.int16}[a.element_size()]
        return a.dtype == b.dtype and torch.equal(a.view(view), b.view(view))
    return all(same_bits(x, y) for x, y in zip(a, b))


def main() -> int:
    if len(sys.argv) not in (2, 3):
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("scan_turns: no CUDA device", file=sys.stderr)
        return 1
    other_src = Path(sys.argv[1]).resolve()
    other_fold = Path(sys.argv[2]).resolve() if len(sys.argv) == 3 else None
    other_dir = cuda.BUILD_DIR / "other"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    builds = [(cuda.SOURCE, cuda.BUILD_DIR), (other_src, other_dir)]
    if other_fold:
        builds += [(cuda_fold.SOURCE, cuda_fold.BUILD_DIR),
                   (other_fold, other_dir)]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builds)) as pool:
        for job in [pool.submit(cuda.compile_library, *b) for b in builds]:
            job.result()
    print(f"build: {time.perf_counter() - t0:.1f} s ({len(builds)} in "
          "parallel)")
    # module -> (the other build, this build)
    libs = {cuda: (load(cuda, other_src, other_dir), cuda.build())}
    if other_fold:
        libs[cuda_fold] = (load(cuda_fold, other_fold, other_dir),
                           cuda_fold.build())

    dev = torch.device("cuda")
    aff, seg, sm = monoids.AFFINE, monoids.SEGMENTED_SUM, monoids.SUM
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    a = 0.5 + 0.5 * torch.rand(SSD, device=dev, generator=gen)
    b = 0.1 * torch.randn(SSD, device=dev, generator=gen)
    lay_s = Channels(*SSD, 256, 512)
    tot = cuda.totals(aff, (a, b), lay_s)
    offs, _ = cuda.chain(aff, tot)
    sv = torch.randn(Q1, device=dev, generator=gen)
    sf = (torch.rand(Q1, device=dev, generator=gen) < 1e-6).to(torch.int32)
    lay1 = Rows(*Q1, Q1[0], 2048)
    xa = torch.randn((1, N_SUM), device=dev, generator=gen)
    lay_a = Rows(1, N_SUM, 1, 2048)
    # (name, module, call with the network to run, the other build's
    # network, graph replays too)
    rows = [
        ("affine carry", cuda, lambda net: cuda.carry(
            aff, (a, b), lay_s, network=net)[0], None, False),
        ("affine apply", cuda, lambda net: cuda.apply(
            aff, (a, b), offs, lay_s, network=net), None, False),
        ("affine fused", cuda, lambda net: cuda.fused(
            aff, (a, b), lay_s, network=net), None, False),
        ("affine tree", cuda, lambda net: cuda.tree(
            aff, (a, b), lay_s, network=net)[0], None, False),
        ("affine chain", cuda, lambda net: cuda.chain(aff, tot)[0], None,
         True),
        ("segsum totals", cuda, lambda net: cuda.totals(
            seg, (sv, sf), lay1, network=net), None, False),
        ("sum totals", cuda, lambda net: cuda.totals(
            sm, (xa,), lay_a, network=net), None, False),
    ]
    if other_fold:
        def partials(lay):
            m = 2 * torch.randn(lay.chain_shape_for(0), device=dev,
                                generator=gen)
            l = 0.5 + 1.5 * torch.rand(lay.chain_shape_for(1), device=dev,
                                       generator=gen)
            return (m, l, torch.randn(lay.chain_shape_for(2), device=dev,
                                      generator=gen))
        bf16, f32 = torch.bfloat16, torch.float32
        spec_g = assoc.softmax_pair_kernel_spec(scale=DECODE.d ** -0.5)
        spec_f = assoc.softmax_pair_kernel_spec(scale=LOCAL.d ** -0.5,
                                                with_stats=True)
        tot_g, tot_f = partials(DECODE), partials(LOCAL)
        rows += [
            ("fold_chain (g)", cuda_fold, lambda net: cuda_fold.chain(
                spec_g, tot_g, DECODE, (bf16,)), None, True),
            ("fold_chain (f) local", cuda_fold, lambda net: cuda_fold.chain(
                spec_f, tot_f, LOCAL, (bf16, f32, f32)), None, True),
        ]
    for name, mod, run, other_net, graph in rows:
        other, this = libs[mod]
        mod._lib = other
        want = run(other_net)
        mod._lib = this
        got = run(None)
        torch.cuda.synchronize()
        if not same_bits(got, want):
            print(f"{name}: this build != the other build", file=sys.stderr)
            return 1
        del got, want
        turns, replays = [], []
        for lib in (other, this, this, other):
            mod._lib = lib
            net = other_net if lib is other else None
            turns.append(time_ms(lambda: run(net)))
            if graph:
                replays.append(graph_ms(lambda: run(net)))
        mod._lib = this
        line = (f"{name:20s}: this {turns[1]:.4f} / {turns[2]:.4f} ms, "
                f"other ({other_net or 'its route'}) {turns[0]:.4f} / "
                f"{turns[3]:.4f} ms")
        if graph:
            line += (f"; graph replay this {replays[1]:.4f} / "
                     f"{replays[2]:.4f} ms, other {replays[0]:.4f} / "
                     f"{replays[3]:.4f} ms")
        print(line + "; bitwise equal")
    return 0


if __name__ == "__main__":
    sys.exit(main())
