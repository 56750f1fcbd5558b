#!/usr/bin/env python3
"""Time ``totals_reduce_kernel`` against variants of its own source, on
one card, in one process.

    PYTHONPATH=src python3 tools/totals_variants.py

Each variant is ``csrc/scan_sum.cu`` with a few text edits (the launch's
block size, the load hint, the integer loop's depth), and "network" is
the unedited source launched with ``network="shared"``: the network's
``totals_kernel`` for the same launches, which is what the sum and the
mask ran before the reduction. All are compiled with ``nvcc`` together,
into ``build/variants/<name>/``, then timed in turns (each variant, then
again in reverse order) at chip_smoke's totals shapes: (1, 2^28) float32,
bfloat16, int32 and int8 at block_n 2048, and the (1, 59990016) int32
mask at block_n 2048, each one call between CUDA events (median of 30),
beside one PyTorch call of the same per-chunk sum. Every variant's
totals are checked bitwise against ``totals_plain`` first.
"""

from __future__ import annotations

import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from repro_torch.kernels.scan_engine import Rows, cuda, monoids, schedules

VARIANTS = {
    "reduce": [],
    "network": [],
    "ldg": [("__ldcs(", "__ldg(")],
    "threads128": [("constexpr int kReduceThreads = 256;",
                    "constexpr int kReduceThreads = 128;")],
    "threads512": [("constexpr int kReduceThreads = 256;",
                    "constexpr int kReduceThreads = 512;")],
    "vecs8": [("constexpr int kReduceVecs = 16;",
               "constexpr int kReduceVecs = 8;")],
}


def time_ms(fn, reps=30):
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


def main() -> int:
    if not torch.cuda.is_available():
        print("totals_variants: no CUDA device", file=sys.stderr)
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
        d = cuda.BUILD_DIR / "variants" / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "scan_sum.cu").write_text(text)
        dirs[name] = d
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(dirs)) as pool:
        for fut in [pool.submit(cuda.compile_library, d / "scan_sum.cu", d)
                    for d in dirs.values()]:
            fut.result()
    print(f"built {len(dirs)} variants in {time.perf_counter() - t0:.1f} s")

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    n, t = 1 << 28, 59990016
    x = torch.randn((1, n), device=dev, generator=gen)
    xi = torch.randint(-100, 100, (1, n), device=dev, generator=gen,
                       dtype=torch.int32)
    m = torch.randint(0, 2, (1, t), device=dev, generator=gen,
                      dtype=torch.int32)
    rows, rows_m = Rows(1, n, 1, 2048), Rows(1, t, 1, 2048)
    cases = [("f32", monoids.SUM, x, rows),
             ("bf16", monoids.SUM, (x * 10).to(torch.bfloat16), rows),
             ("int32", monoids.SUM, xi, rows),
             ("int8", monoids.SUM, xi.to(torch.int8), rows),
             ("mask", monoids.mask(t), m, rows_m)]
    want = {c: schedules.totals_plain((o,), s, lay)[0]
            for c, s, o, lay in cases}
    print("library (one per-chunk sum): " + "  ".join(
        f"{c} {time_ms(lambda: o.view(1, -1, 2048).sum(-1, dtype=want[c].dtype)):.4f}"
        for c, _, o, _ in cases) + " ms")
    for name in list(dirs) + list(reversed(list(dirs))):
        cuda._lib = None
        cuda.SOURCE, cuda.BUILD_DIR = dirs[name] / "scan_sum.cu", dirs[name]
        cuda.build()
        row = []
        net = "shared" if name == "network" else None
        for c, spec, o, lay in cases:
            (got,) = cuda.totals(spec, (o,), lay, network=net)
            if not torch.equal(got.view(torch.int32),
                               want[c].view(torch.int32)):
                raise SystemExit(f"variant {name}: {c} totals differ from "
                                 "totals_plain")
            row.append(f"{c} {time_ms(lambda: cuda.totals(spec, (o,), lay, network=net)):.4f}")
        print(f"{name:10s} " + "  ".join(row) + " ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
