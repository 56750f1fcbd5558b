#!/usr/bin/env python3
"""Time carry, apply, fused and tree on ``Rows`` under variants of the
register network, on one card, in one process.

    PYTHONPATH=src python3 tools/network_variants.py

Each variant is ``csrc/scan_sum.cu`` with a few text edits of the
register network's constants: carry's block (``kRegWarps`` warps holding
``kCarrySegs`` segments each a round: 8 x 2, 16 x 1) and loads in flight
(``kRegAhead`` items ahead: 2 or 1), which tree's walk shares, fused's
segments a warp (``kFusedWords``, the 32-bit words of an element a lane
holds over them: 4, 8 or 16, so 4, 8 or 16 segments of the sum and half
as many of the segmented pair; at block_n 2048, 4, 2 or 1 warps of the
sum), which apply's block shares;
the look-back's stack (``kStackWindows`` 32 windows of 32 tiles, not 16);
two diagnostics, wrong bits and timed only, to show what the look-back
costs: ``nolookback``, whose fused tiles skip it (their offsets the
identity), and ``nofold``, whose tiles wait as before but take the
inclusive prefix they find as their offset, without folding the
aggregates after it; and
``shared``, the same library with every launch sent to the shared-memory
network that carry, apply, fused and tree ran before (what
``cuda.tile_network`` chooses is replaced for it). All are compiled with
``nvcc`` together, into ``build/variants/<name>/``, then timed in turns
(each variant, then again in reverse order) at chip_smoke's shapes: (a)
fused over one (1, 2^28) float32 row, (b) carry over (8192, 32768)
float32, the row groups' carry of the segmented sum and of the mask
(228 x 2^18) and an int32 one-hot's carry (256 x 2^21: the join's
partition has 256 rows), the mask's fused at (1, 59990016) and the
segmented sum's at (4, 2^24), decoupled's apply (given the plain chain's
offsets) at (a), the mask's and the segmented sum's columns, all at
block_n 2048, and tree over (b) at block_n 8192 and 2048 and over the row
groups' segmented sum and mask at 8192, each one call between CUDA events
(median of 20), beside ``torch.cumsum`` where it computes the same
function. Every variant's outputs are checked bitwise against the plain
versions first.
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
                found = re.search(
                    r"(carry|apply|fused|tree)_reg_kernelI(.+?)ELb([01])", line)
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
    t8 = Rows(8192, 32768, 1, 8192)
    lay_a = Rows(1, 1 << 28, 1, 2048)
    lay6 = Rows(1, t6, 1, 2048)
    lay4 = Rows(4, 1 << 24, 1, 2048)
    mspec = monoids.mask(t6)
    # the chain's offsets of decoupled's apply, from the plain versions
    off_a = schedules.exclusive_chain(SUM, schedules.totals_plain(
        (xa,), SUM, lay_a))
    off6 = schedules.exclusive_chain(mspec, schedules.totals_plain(
        (m6,), mspec, lay6))
    off4 = schedules.exclusive_chain(SEG, schedules.totals_plain(
        (v4, f4), SEG, lay4))

    def first(out):
        return out[0][0] if isinstance(out[0], tuple) else out[0]

    cases = [  # (name, kernel launch, plain version, library)
        ("(a) fused", lambda: cuda.fused(SUM, (xa,), lay_a),
         lambda: schedules.fused_plain((xa,), SUM, lay_a),
         lambda: torch.cumsum(xa, 1)),
        ("(b) carry", lambda: cuda.carry(SUM, (xb,), Rows(8192, 32768, 1, 2048)),
         lambda: schedules.carry_plain((xb,), SUM, Rows(8192, 32768, 1, 2048)),
         lambda: torch.cumsum(xb, 1)),
        ("segsum carry", lambda: cuda.carry(SEG, (v, f), Rows(*rg, 1, 2048)),
         lambda: schedules.carry_plain((v, f), SEG, Rows(*rg, 1, 2048)), None),
        ("mask carry", lambda: cuda.carry(monoids.mask(rg[1]), (m,),
                                          Rows(*rg, 1, 2048)),
         lambda: schedules.carry_plain((m,), monoids.mask(rg[1]),
                                       Rows(*rg, 1, 2048)), None),
        ("one-hot carry", lambda: cuda.carry(SUM, (onehot,),
                                             Rows(256, 1 << 21, 1, 2048)),
         lambda: schedules.carry_plain((onehot,), SUM,
                                       Rows(256, 1 << 21, 1, 2048)),
         lambda: torch.cumsum(onehot, 1)),
        ("mask fused", lambda: cuda.fused(mspec, (m6,), lay6),
         lambda: schedules.fused_plain((m6,), mspec, lay6), None),
        ("segsum fused", lambda: cuda.fused(SEG, (v4, f4), lay4),
         lambda: schedules.fused_plain((v4, f4), SEG, lay4), None),
        ("(a) apply", lambda: cuda.apply(SUM, (xa,), off_a, lay_a),
         lambda: schedules.apply_plain((xa,), off_a, SUM, lay_a), None),
        ("mask apply", lambda: cuda.apply(mspec, (m6,), off6, lay6),
         lambda: schedules.apply_plain((m6,), off6, mspec, lay6), None),
        ("segsum apply", lambda: cuda.apply(SEG, (v4, f4), off4, lay4),
         lambda: schedules.apply_plain((v4, f4), off4, SEG, lay4), None),
        ("(b) tree 8192", lambda: cuda.tree(SUM, (xb,), t8),
         lambda: schedules.tree_plain((xb,), SUM, t8), None),
        ("(b) tree 2048", lambda: cuda.tree(SUM, (xb,), Rows(8192, 32768, 1,
                                                             2048)),
         lambda: schedules.tree_plain((xb,), SUM, Rows(8192, 32768, 1, 2048)),
         None),
        ("segsum tree", lambda: cuda.tree(SEG, (v, f), Rows(*rg, 1, 8192)),
         lambda: schedules.tree_plain((v, f), SEG, Rows(*rg, 1, 8192)), None),
        ("mask tree", lambda: cuda.tree(monoids.mask(rg[1]), (m,),
                                        Rows(*rg, 1, 8192)),
         lambda: schedules.tree_plain((m,), monoids.mask(rg[1]),
                                      Rows(*rg, 1, 8192)), None),
    ]
    want = {name: first(plain()) for name, _, plain, _ in cases}
    print("library (torch.cumsum): " + "  ".join(
        f"{name} {time_ms(lib):.4f}" for name, *_, lib in cases if lib) + " ms")
    tile_network = cuda.tile_network
    order = list(dirs) + list(reversed(list(dirs)))
    for vname in order:
        cuda._lib = None
        cuda.SOURCE, cuda.BUILD_DIR = dirs[vname] / "scan_sum.cu", dirs[vname]
        cuda.tile_network = (lambda spec, lay, kernel: "shared") \
            if vname == "shared" else tile_network
        cuda.build()
        row = []
        for name, run, _, _ in cases:
            if vname not in DIAGNOSTIC and not same_bits(first(run()),
                                                         want[name]):
                raise SystemExit(f"variant {vname}: {name} differs from the "
                                 "plain version")
            row.append(f"{name} {time_ms(run):.4f}")
        print(f"{vname:9s} " + "  ".join(row) + " ms"
              + (" (diagnostic: bits not checked)" if vname in DIAGNOSTIC
                 else ""))
    cuda.tile_network = tile_network
    return 0


if __name__ == "__main__":
    sys.exit(main())
