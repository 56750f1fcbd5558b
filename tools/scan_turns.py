#!/usr/bin/env python3
"""Time the scan kernels of this checkout's ``csrc/scan_sum.cu`` against
another build of the same file (for example the previous commit's), on
one card, in one process, in turns.

    mkdir -p build/other
    git show HEAD~1:src/repro_torch/csrc/scan_sum.cu > build/other/scan_sum.cu
    PYTHONPATH=src python3 tools/scan_turns.py build/other/scan_sum.cu

Both sources are compiled with ``nvcc`` in parallel (the other one into
``build/other/``). The two libraries share the C interface, so the
wrappers of ``repro_torch.kernels.scan_engine.cuda`` launch either: the
tool swaps the loaded library between calls. Each row runs at
chip_smoke's shape, the other build on the network its row names (the
shared-memory network where it has no register form of the kernel):
the affine carry, apply, fused and tree at zamba2-7b's SSD carry (1,
1024, 458752) float32 with time tiles of 256, the segmented sum's totals
at Q1's (4, 59144192) float32 with sparse flags and tiles of 2048, and
the sum's totals at one column of 2^28 float32. The two builds' outputs
are held bitwise equal first; then each row is one call between CUDA
events, median of 9, in turns: other, this, this, other.
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

from repro_torch.kernels.scan_engine import Channels, Rows, cuda, monoids

SSD = (1, 1024, 458752)
Q1 = (4, 59144192)
N_SUM = 1 << 28


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


def load(source: Path, build_dir: Path) -> ctypes.CDLL:
    """The library of ``source``, with the argument types ``cuda.build``
    sets (it builds and loads ``cuda.SOURCE`` into ``cuda.BUILD_DIR``)."""
    saved = cuda.SOURCE, cuda.BUILD_DIR, cuda._lib
    cuda.SOURCE, cuda.BUILD_DIR, cuda._lib = source, build_dir, None
    try:
        return cuda.build()
    finally:
        cuda.SOURCE, cuda.BUILD_DIR, cuda._lib = saved


def same_bits(a, b):
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a.view(torch.int32),
                                                   b.view(torch.int32))
    return all(same_bits(x, y) for x, y in zip(a, b))


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("scan_turns: no CUDA device", file=sys.stderr)
        return 1
    other_src = Path(sys.argv[1]).resolve()
    other_dir = cuda.BUILD_DIR / "other"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        jobs = [pool.submit(cuda.compile_library, cuda.SOURCE,
                            cuda.BUILD_DIR),
                pool.submit(cuda.compile_library, other_src, other_dir)]
        for job in jobs:
            job.result()
    print(f"build: {time.perf_counter() - t0:.1f} s (in parallel)")
    other = load(other_src, other_dir)
    this = cuda.build()

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
    # (name, call with the network to run, the other build's network)
    rows = [
        ("affine carry", lambda net: cuda.carry(aff, (a, b), lay_s,
                                                network=net)[0], None),
        ("affine apply", lambda net: cuda.apply(aff, (a, b), offs, lay_s,
                                                network=net), None),
        ("affine fused", lambda net: cuda.fused(aff, (a, b), lay_s,
                                                network=net), None),
        ("affine tree", lambda net: cuda.tree(aff, (a, b), lay_s,
                                              network=net)[0], "shared"),
        ("segsum totals", lambda net: cuda.totals(seg, (sv, sf), lay1,
                                                  network=net), "shared"),
        ("sum totals", lambda net: cuda.totals(sm, (xa,), lay_a,
                                               network=net), None),
    ]
    for name, run, other_net in rows:
        cuda._lib = other
        want = run(other_net)
        cuda._lib = this
        got = run(None)
        torch.cuda.synchronize()
        if not same_bits(got, want):
            print(f"{name}: this build != the other build", file=sys.stderr)
            return 1
        del got, want
        turns = []
        for lib in (other, this, this, other):
            cuda._lib = lib
            turns.append(time_ms(lambda: run(other_net if lib is other
                                             else None)))
        cuda._lib = this
        print(f"{name:14s}: this {turns[1]:.3f} / {turns[2]:.3f} ms, other "
              f"({other_net or 'its route'}) {turns[0]:.3f} / "
              f"{turns[3]:.3f} ms; bitwise equal")
    return 0


if __name__ == "__main__":
    sys.exit(main())
