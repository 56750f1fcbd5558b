#!/usr/bin/env python3
"""Time the affine carry and fused on ``Channels`` in registers
(``carry_chan_reg_kernel``, ``fused_chan_reg_kernel``) against variants
of their own source and the shared-memory ``carry_kernel``, on one card,
in one process.

    PYTHONPATH=src python3 tools/chan_variants.py [--bt32]

``--bt32`` times the carry on tiles of 32 steps instead, at a 4096-token
prefill's SSD carry of zamba2-7b, (1, 32, 458752) float32: the kept
design (a thread a channel, blocks of up to 128 threads), blocks of up
to 256, and the warp network over the staged tile (``chan_reg_walk`` at
one slot a lane, the form the other tiles run) at one and at four blocks
an SM by its launch bounds, beside the shared ``carry_kernel``; each
held bitwise against ``carry_plain`` (outputs and running totals,
inclusive and exclusive) at the full shape first, then timed in turns
(each variant, then again in reverse order), CUDA-event medians of 20
calls and a CUDA graph replay of 20 calls.

Each variant is ``csrc/scan_sum.cu`` with a few text edits (the carry's
ring depth, the channels a lane of the carry and of the fused holds, one
fused block an SM instead of two, and a marked diagnostic: the copies in
and out without the network). All are compiled with ``nvcc``
together into ``build/variants/chan_<name>/``, then run at chip_smoke's
SSD carry shape, (1, 1024, 458752) float32 with time tiles of 256, over
strips of 8, 16 and 32 channels (the strip width is free: only the time
tile fixes the association), each one call between CUDA events (median
of 10), in turns (each variant, then again in reverse order), the carry
and then the fused. Each (variant, width) is held bitwise against
``carry_plain`` at a smaller shape first, the carry's outputs and running
totals and the fused's outputs (but the diagnostic's), and the
shared-memory ``carry_kernel`` is timed at the same shape on the first
variant's build.
"""

from __future__ import annotations

import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from repro_torch.kernels.scan_engine import Channels, cuda, monoids, schedules

VARIANTS = {
    "base": [],
    "stages3": [("constexpr int kChanStages = 2;",
                 "constexpr int kChanStages = 3;")],
    # four channels a lane (16-byte shared-memory reads, 64 words of data
    # at bt 256)
    "lanes4": [("__host__ __device__ constexpr int chan_reg_lanes(int) "
                "{ return 2; }",
                "__host__ __device__ constexpr int chan_reg_lanes(int) "
                "{ return 4; }")],
    # fused_chan_reg_kernel with two channels a lane (sixteen scan warps
    # a 32-channel strip), and at one block an SM (launch bounds that let
    # ptxas use more registers)
    "fused_lanes2": [("__host__ __device__ constexpr int fused_chan_lanes(int) "
                      "{ return 4; }",
                      "__host__ __device__ constexpr int fused_chan_lanes(int) "
                      "{ return 2; }")],
    "fused1": [("__global__ void __launch_bounds__(fused_chan_threads(NS), 2)",
                "__global__ void __launch_bounds__(fused_chan_threads(NS), 1)")],
    # a diagnostic: the same copies in and out, no network (out = b): what
    # this access pattern alone takes
    "copyonly": [("for (int k = 1; k < 32; k <<= 1) {",
                  "for (int k = 32; k < 32; k <<= 1) {"),
                 ("for (int m = 1; m < NS; m <<= 1)",
                  "for (int m = NS; m < NS; m <<= 1)"),
                 ("o[v] = S::combine(left[v], x[s][v]).b;",
                  "o[v] = x[s][v].b;")],
}
DIAGNOSTIC = ("copyonly",)
# the warp network at one slot a lane: the carry's walk, the form of the
# other tiles, in place of a thread a channel
_WARP32 = [("  if constexpr (NS == 1) {\n    // channel ch",
            "  if constexpr (false) {\n    // channel ch"),
           ("if constexpr (NS == 1 && !kTree) {", "if constexpr (false) {")]
VARIANTS_BT32 = {
    "thread128": [],
    "thread256": [("constexpr int kChanCarryThreads = 128;",
                   "constexpr int kChanCarryThreads = 256;")],
    "warp": _WARP32,
    "warp4": _WARP32 + [
        ("__global__ void __launch_bounds__(chan_reg_threads(NS), 1)\n"
         "carry_chan_reg_kernel(",
         "__global__ void __launch_bounds__(chan_reg_threads(NS), "
         "NS == 1 ? 4 : 1)\ncarry_chan_reg_kernel(")],
}
SSD32 = (1, 32, 458752)
WIDTHS = (32, 16, 8)
SSD = (1, 1024, 458752)


def time_ms(fn, reps=10):
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


def same(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def graph_ms(fn, calls=20):
    """One call's time from a CUDA graph replay of ``calls`` calls."""
    fn()
    torch.cuda.synchronize()
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def build_variants(variants, tag):
    """Each variant's source under ``build/variants/<tag>_<name>/``, all
    compiled together; prints the time and returns (dirs, logs)."""
    source = cuda.SOURCE.read_text()
    dirs = {}
    for name, edits in variants.items():
        text = source
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"variant {name}: {old!r} not in the source")
            text = text.replace(old, new)
        d = cuda.BUILD_DIR / "variants" / f"{tag}_{name}"
        d.mkdir(parents=True, exist_ok=True)
        (d / "scan_sum.cu").write_text(text)
        dirs[name] = d
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(dirs)) as pool:
        logs = [fut.result()[1] for fut in
                [pool.submit(cuda.compile_library, d / "scan_sum.cu", d)
                 for d in dirs.values()]]
    print(f"built {len(dirs)} variants in {time.perf_counter() - t0:.1f} s")
    return dirs, logs


def use(d):
    """Load the library built in ``d`` in place of the package's."""
    cuda._lib = None
    cuda.SOURCE, cuda.BUILD_DIR = d / "scan_sum.cu", d
    cuda.build()


def main_bt32() -> int:
    dirs, logs = build_variants(VARIANTS_BT32, "chan32")
    for name, log in zip(dirs, logs):   # the float32 NS = 1 kernels' reports
        lines = log.splitlines()
        at = [i for i, line in enumerate(lines) if "Compiling" in line
              and "carry_chan_reg_kernelIfLi1ELb1" in line]
        report = [line.strip() for line in lines[at[0] + 1:at[0] + 4]
                  if "spill" in line or "Used" in line] if at else []
        print(f"  {name}: carry_chan_reg_kernel<f32, 1, vec>: {report}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    a = 0.5 + 0.5 * torch.rand(SSD32, device=dev, generator=gen)
    b = 0.1 * torch.randn(SSD32, device=dev, generator=gen)
    lay = Channels(*SSD32, 32, 512)
    aff = monoids.AFFINE
    want = {ex: schedules.carry_plain((a, b), aff, lay, ex, True)
            for ex in (False, True)}
    nbytes = 12 * a.numel()
    print(f"bound {nbytes / 3.35e12 * 1e3:.4f} ms ({nbytes} bytes at 3.35 "
          "TB/s)")
    times = {name: [] for name in ["shared"] + list(dirs)}
    for name in list(dirs) + list(reversed(list(dirs))):
        use(dirs[name])
        for ex in (False, True):
            (got,), run = cuda.carry(aff, (a, b), lay, ex, True,
                                     network="register")
            (w,), w_run = want[ex]
            if not (same(got, w) and all(same(x, y)
                                         for x, y in zip(run, w_run))):
                raise SystemExit(f"variant {name}: differs from carry_plain "
                                 f"(exclusive {ex})")
        fn = (lambda: cuda.carry(aff, (a, b), lay, network="register"))
        times[name].append((time_ms(fn, 20), graph_ms(fn)))
        if name == list(dirs)[0]:
            sh = (lambda: cuda.carry(aff, (a, b), lay, network="shared"))
            times["shared"].append((time_ms(sh, 20), graph_ms(sh)))
    for name, ts in times.items():
        print(f"{name:10s} " + "  ".join(
            f"{ev:.4f} ms (graph {gr:.4f})" for ev, gr in ts))
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chan_variants: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    if "--bt32" in sys.argv[1:]:
        return main_bt32()
    dirs, logs = build_variants(VARIANTS, "chan")
    for name, log in zip(dirs, logs):   # the float32 bt 256 kernels' reports
        lines = log.splitlines()
        for kernel in ("carry_chan_reg_kernel", "fused_chan_reg_kernel"):
            at = [i for i, line in enumerate(lines) if "Compiling" in line
                  and f"{kernel}IfLi8ELb1" in line]
            report = [line.strip() for line in lines[at[0] + 1:at[0] + 4]
                      if "spill" in line or "Used" in line] if at else []
            print(f"  {name}: {kernel}<f32, 8, vec>: {report}")

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    a = 0.5 + 0.5 * torch.rand(SSD, device=dev, generator=gen)
    b = 0.1 * torch.randn(SSD, device=dev, generator=gen)
    lay = Channels(*SSD, 256, 512)
    small = (a[:, :, :4096].contiguous(), b[:, :, :4096].contiguous())
    lay_small = Channels(1, 1024, 4096, 256, 4096)
    (want,), w_run = schedules.carry_plain(small, monoids.AFFINE, lay_small,
                                           return_totals=True)
    aff = monoids.AFFINE
    width_of = cuda.chan_reg_width
    shared = time_ms(lambda: cuda.carry(monoids.AFFINE, (a, b), lay,
                                        network="shared"))
    print(f"shared-memory carry_kernel ({cuda.channel_width(lay)}-channel "
          f"strips): {shared:.3f} ms")
    # the same bytes as rows of 28672 channels (112 KB apart, not 1.8 MB):
    # how much the row stride alone costs the register carry
    for shape in ((4, 1024, 114688), (1, 16384, 28672)):
        other = Channels(*shape, 256, 512)
        a2, b2 = a.view(shape), b.view(shape)
        print(f"register carry at {shape} (the same bytes, rows "
              f"{shape[2] * 4 // 1024} KB apart): "
              f"{time_ms(lambda: cuda.carry(monoids.AFFINE, (a2, b2), other)):.3f}"
              " ms")
    print(f"register carry at {SSD}: "
          f"{time_ms(lambda: cuda.carry(monoids.AFFINE, (a, b), lay)):.3f} ms")
    for name in list(dirs) + list(reversed(list(dirs))):
        use(dirs[name])
        row = []
        for w in WIDTHS:
            cuda.chan_reg_width = lambda layout, w=w: w
            try:
                (got,), run = cuda.carry(monoids.AFFINE, small, lay_small,
                                         return_totals=True,
                                         network="register")
            except RuntimeError:   # a strip the variant's blocks refuse
                row.append(f"w{w} refused")
                continue
            (fo,) = cuda.fused(aff, small, lay_small, network="register")
            if name not in DIAGNOSTIC and not (
                    same(got, want) and same(fo, want)
                    and all(same(x, y) for x, y in zip(run, w_run))):
                raise SystemExit(f"variant {name} width {w}: differs from "
                                 "carry_plain")
            carry_ms = time_ms(lambda: cuda.carry(aff, (a, b), lay,
                                                  network="register"))
            fused_ms = time_ms(lambda: cuda.fused(aff, (a, b), lay,
                                                  network="register"))
            row.append(f"w{w} carry {carry_ms:.3f} fused {fused_ms:.3f}")
        cuda.chan_reg_width = width_of
        print(f"{name:15s} " + "  ".join(row) + " ms"
              + (" (diagnostic: bits not checked)" if name in DIAGNOSTIC
                 else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
