#!/usr/bin/env python3
"""Time carry and fused on ``Rows`` under variants of the register network,
on one card, in one process.

    PYTHONPATH=src python3 tools/network_variants.py

Each variant is ``csrc/scan_sum.cu`` with a few text edits of the
register network's constants: carry's block (``kRegWarps`` warps holding
``kCarrySegs`` segments each a round: 8 x 2, 16 x 1) and loads in flight
(``kRegAhead`` items ahead: 2 or 1), fused's segments a warp
(``kFusedWords``, the 32-bit words of an element a lane holds over them:
4, 8 or 16, so 4, 8 or 16 segments of the sum and half as many of the
segmented pair; at block_n 2048, 4, 2 or 1 warps of the sum);
the look-back's stack (``kStackWindows`` 32 windows of 32 tiles, not 16);
two diagnostics, wrong bits and timed only, to show what the look-back
costs: ``nolookback``, whose fused tiles skip it (their offsets the
identity), and ``nofold``, whose tiles wait as before but take the
inclusive prefix they find as their offset, without folding the
aggregates after it; and
``shared``, the same library with every launch sent to the shared-memory
network that carry and fused ran before (what
``cuda.tile_network`` chooses is replaced for it). All are compiled with
``nvcc`` together, into ``build/variants/<name>/``, then timed in turns
(each variant, then again in reverse order) at chip_smoke's shapes: (a)
fused over one (1, 2^28) float32 row, (b) carry over (8192, 32768)
float32, the row groups' carry of the segmented sum and of the mask
(228 x 2^18) and an int32 one-hot's carry (256 x 2^21: the join's
partition has 256 rows), the mask's fused at (1, 59990016) and the
segmented sum's at (4, 2^24), all at block_n 2048, each one call between
CUDA events (median of 20), beside ``torch.cumsum`` where it computes the
same function. Every variant's
outputs are checked bitwise against the plain versions first.
"""

from __future__ import annotations

import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from repro_torch.kernels.scan_engine import Rows, cuda, monoids, schedules


def knobs(**values):
    """Text edits setting the register network's constants."""
    default = {"kRegWarps": 8, "kCarrySegs": 2, "kRegAhead": 2,
               "kFusedWords": 8}
    return [(f"constexpr int {k} = {default[k]};", f"constexpr int {k} = {v};")
            for k, v in values.items()]


VARIANTS = {
    "register": [],
    "shared": [],
    "carry16x1": knobs(kRegWarps=16, kCarrySegs=1),
    "carry8x2a1": knobs(kRegAhead=1),
    "fused4words": knobs(kFusedWords=4),
    "fused16words": knobs(kFusedWords=16),
    "stack32": [("constexpr int kStackWindows = 16;",
                 "constexpr int kStackWindows = 32;")],
    # diagnostics, their bits not checked: fused_reg_kernel without its
    # look-back (every tile's offset the identity), and with the look-back's
    # waits but without its fold (the offset is the inclusive prefix found)
    "nolookback": [("const E pre = j > 0 ? lookback_packed<S>(st, j, stack) "
                    ": S::identity();", "const E pre = S::identity();")],
    "nofold": [("      pre = S::combine(pre, S::unpack(stack[nw * 32 + q]));",
                "      ;"),
               ("        pre = S::combine(pre, S::unpack(stack[v * 32 + q]));",
                "        ;")],
}
DIAGNOSTIC = {"nolookback", "nofold"}


def time_ms(fn, reps=20):
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


def same_bits(a, b):
    view = {4: torch.int32, 2: torch.int16, 1: torch.int8}[a.element_size()]
    return a.dtype == b.dtype and torch.equal(a.view(view), b.view(view))


def main() -> int:
    if not torch.cuda.is_available():
        print("network_variants: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    source = cuda.SOURCE.read_text()
    dirs = {}
    for name, edits in VARIANTS.items():
        text = source
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"variant {name}: {old!r} not in the source")
            text = text.replace(old, new)
        d = cuda.BUILD_DIR / "variants" / ("register" if name == "shared"
                                           else name)
        d.mkdir(parents=True, exist_ok=True)
        (d / "scan_sum.cu").write_text(text)
        dirs[name] = d
    t0 = time.perf_counter()
    builds = sorted(set(dirs.values()))
    with ThreadPoolExecutor(len(builds)) as pool:
        logs = dict(zip(builds, pool.map(
            lambda d: cuda.compile_library(d / "scan_sum.cu", d)[1], builds)))
    print(f"built {len(builds)} variants in {time.perf_counter() - t0:.1f} s")
    for d in builds:   # registers of the register network's kernels, spills
        regs, spills, kernel = {}, [], None
        for line in logs[d].splitlines():
            if "Compiling entry function" in line:
                found = re.search(r"(carry|fused)_reg_kernelI(.+?)ELb([01])",
                                  line)
                kernel = found and f"{found[1]}<{found[2]}, {found[3]}>"
            elif kernel and "spill stores" in line:
                found = re.search(r"(\d+) bytes stack frame, (\d+) bytes "
                                  r"spill stores", line)
                if found and (int(found[1]) or int(found[2])):
                    spills.append(f"{kernel}: {line.strip()}")
            elif kernel and "Used" in line:
                used = int(line.split("Used")[1].split("registers")[0])
                name = kernel.split("<")[0]
                regs[name] = max(regs.get(name, 0), used)
                kernel = None
        if logs[d]:   # a cached build prints no report
            print(f"  ptxas {d.name}: at most {regs} registers; stack or "
                  f"spills in {len(spills)} kernels")
            for line in spills:
                print(f"    {line}")

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    SUM, SEG = monoids.SUM, monoids.SEGMENTED_SUM
    xa = torch.randn((1, 1 << 28), device=dev, generator=gen)
    xb = torch.randn((8192, 32768), device=dev, generator=gen)
    rg = (228, 1 << 18)
    v = torch.randn(rg, device=dev, generator=gen)
    f = (torch.rand(rg, device=dev, generator=gen) < 0.25).to(torch.int32)
    m = (torch.rand(rg, device=dev, generator=gen) < 0.3).to(torch.int32)
    hot = torch.randint(0, 256, (1 << 21,), device=dev, generator=gen)
    onehot = (hot[None, :] == torch.arange(256, device=dev)[:, None]).to(
        torch.int32)
    del hot
    v4 = torch.randn((4, 1 << 24), device=dev, generator=gen)
    f4 = (torch.rand((4, 1 << 24), device=dev, generator=gen) < 0.001).to(
        torch.int32)
    t6 = 59990016
    m6 = (torch.rand((1, t6), device=dev, generator=gen) < 0.02).to(
        torch.int32)
    cases = [  # (name, kernel, spec, operands, layout, library)
        ("(a) fused", cuda.fused, SUM, (xa,), Rows(1, 1 << 28, 1, 2048),
         lambda: torch.cumsum(xa, 1)),
        ("(b) carry", cuda.carry, SUM, (xb,), Rows(8192, 32768, 1, 2048),
         lambda: torch.cumsum(xb, 1)),
        ("segsum carry", cuda.carry, SEG, (v, f), Rows(*rg, 1, 2048), None),
        ("mask carry", cuda.carry, monoids.mask(rg[1]), (m,),
         Rows(*rg, 1, 2048), None),
        ("one-hot carry", cuda.carry, SUM, (onehot,),
         Rows(256, 1 << 21, 1, 2048), lambda: torch.cumsum(onehot, 1)),
        ("mask fused", cuda.fused, monoids.mask(t6), (m6,), Rows(1, t6, 1, 2048),
         None),
        ("segsum fused", cuda.fused, SEG, (v4, f4), Rows(4, 1 << 24, 1, 2048),
         None),
    ]
    plain = {"carry": schedules.carry_plain, "fused": schedules.fused_plain}
    want = {}
    for name, fn, spec, ops, lay, _ in cases:
        want[name] = plain[fn.__name__](ops, spec, lay)[0]
    print("library (torch.cumsum): " + "  ".join(
        f"{name} {time_ms(lib):.4f}" for name, *_, lib in cases if lib) + " ms")
    tile_network = cuda.tile_network
    order = list(dirs) + list(reversed(list(dirs)))
    for vname in order:
        cuda._lib = None
        cuda.SOURCE, cuda.BUILD_DIR = dirs[vname] / "scan_sum.cu", dirs[vname]
        cuda.tile_network = (lambda spec, lay: "shared") if vname == "shared" \
            else tile_network
        cuda.build()
        row = []
        for name, fn, spec, ops, lay, _ in cases:
            out = fn(spec, ops, lay)
            out = out[0][0] if fn is cuda.carry else out[0]
            if vname not in DIAGNOSTIC and not same_bits(out, want[name]):
                raise SystemExit(f"variant {vname}: {name} differs from the "
                                 "plain version")
            row.append(f"{name} {time_ms(lambda: fn(spec, ops, lay)):.4f}")
        print(f"{vname:9s} " + "  ".join(row) + " ms"
              + (" (diagnostic: bits not checked)" if vname in DIAGNOSTIC
                 else ""))
    cuda.tile_network = tile_network
    return 0


if __name__ == "__main__":
    sys.exit(main())
