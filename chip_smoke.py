#!/usr/bin/env python3
"""Drive the PyTorch port's prefix-sum main path on one CUDA card.

    python3 chip_smoke.py [--seed N]

Phases, each of which passes or raises (the script exits non-zero on the
first failure and prints no result):

  1. environment and build: the card's name and power limit, torch/CUDA/
     nvcc versions, and the build of ``src/repro_torch/csrc/scan_sum.cu``
     with ``nvcc`` for ``sm_90a`` (its seconds and ptxas report);
  2. every kernel against its plain PyTorch version on the card, bitwise:
     the four schedules x {inclusive, exclusive} x {f32, bf16, int32} on
     (3, 517), (64, 2^18) and (1, 2^24) with block_n 512, 2048, 8192 and
     16384 (the largest tile the kernels take);
  3. the main path through ``repro_torch.core.scan.cumsum`` at a column
     store's size — (a) one column of 2^28 float32 (auto: kernel, fused,
     which runs decoupled), (b) a (8192, 32768) float32 batch through
     algorithm="kernel" (schedule auto: carry), (c) the batch with
     schedule="tree", block_n=8192 — and its
     backward at (1, 2^24); the kernel launch counters are zeroed before
     and read after, and every kernel of the path must have launched.
     Then the outputs are checked: carry == decoupled == fused bitwise on
     (a), tree and the batch within a stated tolerance of a float64
     ``torch.cumsum``, a 2^28 int32 column exact under all four
     schedules, and the gradient bitwise equal to the plain
     flip(cumsum(flip(g)));
  4. times (CUDA events, median after warm-up) of each schedule on (a)
     and (b), and of each kernel at its main-path shape, beside the
     device-memory bound and ``torch.cumsum`` (a yardstick only: the port
     never calls it).

The line before the last is one JSON object with a row per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# Device-memory rate (bytes/s) and float32 non-tensor-core peak (ops/s)
# of the H100 variants, from NVIDIA's data sheets.
MEM_RATE = {"H100 PCIe": 2.0e12, "H100 NVL": 3.9e12, "H100": 3.35e12}
F32_RATE = {"H100 PCIe": 51e12, "H100 NVL": 60e12, "H100": 67e12}

SCHEDULES = ("carry", "decoupled", "fused", "tree")
USES = {"carry": ("carry",), "decoupled": ("totals", "chain", "apply"),
        "fused": ("totals", "chain", "apply"), "tree": ("tree",)}
REPLACES = {
    "carry": "src/repro/kernels/scan_engine/schedules.py:335",
    "totals": "src/repro/kernels/scan_engine/schedules.py:390",
    "chain": "src/repro/kernels/scan_engine/schedules.py:248",
    "apply": "src/repro/kernels/scan_engine/schedules.py:405",
    "tree": "src/repro/kernels/scan_engine/schedules.py:605",
}
# Tolerance of a float32 prefix sum against float64, relative to the
# largest prefix magnitude: rounding walks ~sqrt(n) half-ulps along the
# carry chain, ~1e-5 of the range at these sizes; 1e-4 leaves a 10x margin.
REL_TOL = 1e-4


class SmokeFailure(AssertionError):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def rate(table, name):
    for key, value in table.items():
        if key in name:
            return value
    raise SmokeFailure(f"no data-sheet rate for {name!r}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    import torch.nn.functional as F

    from repro_torch.core.scan import api, policy
    from repro_torch.kernels.scan_engine import Rows, cuda, monoids, schedules

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    bw, f32_peak = rate(MEM_RATE, name), rate(F32_RATE, name)
    SUM = monoids.SUM

    def sync():
        torch.cuda.synchronize(dev)

    def normals(shape, dtype=torch.float32):
        return torch.randn(shape, device=dev, generator=gen).to(dtype)

    def bits(t):
        return t.view({4: torch.int32, 2: torch.int16,
                       1: torch.int8}[t.element_size()])

    def same_bits(a, b):
        return a.shape == b.shape and a.dtype == b.dtype and \
            torch.equal(bits(a), bits(b))

    def time_ms(fn, reps, warmup=1):
        for _ in range(warmup):
            fn()
        sync()
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

    def bound_ms(nbytes, adds):
        t_bytes, t_ops = nbytes / bw * 1e3, adds / f32_peak * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                             "operations")

    # -- 1. environment and build ------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  SMs "
          f"{torch.cuda.get_device_properties(dev).multi_processor_count}")
    nvcc = subprocess.run([cuda._nvcc(), "--version"], capture_output=True,
                          text=True, check=True)
    print("nvcc:", nvcc.stdout.strip().splitlines()[-1])
    t0 = time.perf_counter()
    cuda.build()
    print(f"build: {time.perf_counter() - t0:.1f} s for "
          f"{os.path.relpath(cuda.SOURCE, ROOT)}")
    for line in cuda.build_log.splitlines():
        if "Used" in line:
            print("  ptxas:", line.split("ptxas info    :")[-1].strip())

    # -- 2. every kernel vs its plain version, bitwise ---------------------
    plain = {"carry": schedules.carry_plain, "tree": schedules.tree_plain}

    def plain_decoupled(ops_, spec, lay, exclusive):
        offs = schedules.exclusive_chain(
            spec, schedules.totals_plain(ops_, spec, lay))
        return schedules.apply_plain(ops_, offs, spec, lay, exclusive)

    plain["decoupled"] = plain["fused"] = plain_decoupled
    kernel = {"carry": schedules.scan_carry,
              "decoupled": schedules.scan_decoupled,
              "fused": schedules.scan_fused, "tree": schedules.scan_tree}
    n_checks = 0
    for rows, n in ((3, 517), (64, 1 << 18), (1, 1 << 24)):
        # the blocks ops.cumsum tiles with: min(block_n, round_up(n, 128))
        for bn in sorted({min(b, -(-n // 128) * 128)
                          for b in (512, 2048, 8192, 16384)}):
            pad = (-n) % bn
            for dtype in (torch.float32, torch.bfloat16, torch.int32):
                if dtype == torch.int32:
                    x = torch.randint(-9, 9, (rows, n), device=dev,
                                      generator=gen, dtype=dtype)
                else:
                    x = normals((rows, n), dtype)
                x = F.pad(x, (0, pad)).contiguous()
                lay = Rows(rows, n + pad, 1, bn)
                for s in SCHEDULES:
                    for exclusive in (False, True):
                        cuda.reset_launches()
                        (got,) = kernel[s]((x,), SUM, lay,
                                           exclusive=exclusive)
                        sync()
                        grown = [k for k in USES[s] if cuda.LAUNCHES[k]]
                        check(grown == list(USES[s]),
                              f"{s} launched {cuda.LAUNCHES}")
                        (want,) = plain[s]((x,), SUM, lay, exclusive)
                        check(same_bits(got, want),
                              f"kernel != plain: {s} excl={exclusive} "
                              f"{dtype} ({rows}, {n}) bn={bn}")
                        n_checks += 1
            print(f"kernel == plain bitwise: ({rows}, {n}) bn={bn} "
                  f"x 3 dtypes x 4 schedules x 2 modes")
    print(f"phase 2: {n_checks} kernel-vs-plain checks, all bitwise equal")

    # -- 3. the main path, with launch counts ------------------------------
    na = 1 << 28
    xa = normals((na,))
    xb = normals((8192, 32768))
    ng = 1 << 24
    xg = normals((1, ng)).requires_grad_()
    g = normals((1, ng))
    sms = policy.cores_of(xa)
    sched_g = schedules.resolve_schedule("auto", 1, ng, 2048, sms)
    choice_a = policy.choose(na, 4, batch=1, cores=sms)
    choice_b = policy.choose(32768, 4, batch=8192, cores=sms)
    print(f"policy (a) (2^28,): {choice_a.algorithm}/{choice_a.schedule} "
          f"— {choice_a.reason}")
    print(f"policy (b) (8192, 32768): {choice_b.algorithm}/"
          f"{choice_b.schedule} — {choice_b.reason}")
    check((choice_a.algorithm, choice_a.schedule) == ("kernel", "fused"),
          "(a) should be kernel/fused")
    # choose() sizes the data by one row (n * itemsize, as the reference
    # does), so auto sends the 1 GiB batch to the library's horizontal
    # network; the batch is driven through the kernel route below, where
    # the schedule rule picks carry.
    check(choice_b.schedule == "carry", "(b) schedule should be carry")

    sync()
    cuda.reset_launches()
    ya = api.cumsum(xa)
    yb = api.cumsum(xb, algorithm="kernel")
    yc = api.cumsum(xb, algorithm="kernel", schedule="tree", block_n=8192)
    yg = api.cumsum(xg)
    fwd = dict(cuda.LAUNCHES)
    (dx,) = torch.autograd.grad(yg, xg, g)
    sync()
    launches = dict(cuda.LAUNCHES)
    print(f"main-path launches: {launches} (before the backward: {fwd})")
    for k in launches:
        check(launches[k] > 0, f"kernel {k} never launched on the main path")
    for k in USES[sched_g]:
        check(launches[k] > fwd[k], f"backward did not launch {k}")

    def close_to_f64(y, x, what, axis=-1):
        ref = torch.cumsum(x.double(), dim=axis)
        check(y.shape == x.shape and y.dtype == x.dtype, f"{what}: shape")
        check(bool(torch.isfinite(y).all()), f"{what}: non-finite output")
        err = (y.double() - ref).abs().max().item()
        tol = REL_TOL * ref.abs().max().item()
        check(err <= tol, f"{what}: max err {err} > tol {tol}")
        return err

    err_a = close_to_f64(ya, xa, "(a) fused")
    err_b = close_to_f64(yb, xb, "(b) carry")
    err_c = close_to_f64(yc, xb, "(c) tree")
    del yb, yc
    outs = {s: api.cumsum(xa, algorithm="kernel", schedule=s)
            for s in ("carry", "decoupled")}
    check(same_bits(outs["carry"], ya) and same_bits(outs["decoupled"], ya),
          "(a) carry / decoupled / fused not bitwise equal")
    del outs
    yt = api.cumsum(xa, algorithm="kernel", schedule="tree")
    err_t = close_to_f64(yt, xa, "(a) tree")
    del yt, ya
    print(f"(a) carry == decoupled == fused bitwise; max |err| vs float64 "
          f"(tolerance {REL_TOL} x max|prefix|): fused {err_a:.4g}, "
          f"tree {err_t:.4g}; (b) carry {err_b:.4g}; (c) tree {err_c:.4g}")

    xi = torch.randint(-4, 5, (na,), device=dev, generator=gen,
                       dtype=torch.int32)
    ref_i = torch.cumsum(xi.long(), 0)
    for s in SCHEDULES:
        yi = api.cumsum(xi, algorithm="kernel", schedule=s)
        check(yi.dtype == torch.int32 and torch.equal(yi.long(), ref_i),
              f"int32 2^28 column not exact under {s}")
    del xi, ref_i, yi
    print("int32 2^28 column: all four schedules == torch.cumsum(int64)")

    lay_g = Rows(1, ng, 1, 2048)
    (want,) = plain[sched_g]((torch.flip(g, (1,)),), SUM, lay_g, False)
    check(same_bits(dx, torch.flip(want, (1,))),
          "grad != plain flip(cumsum(flip(g)))")
    print(f"backward (1, 2^24), {sched_g}: grad == plain "
          "flip(cumsum(flip(g))) bitwise")
    del xg, g, dx, want, yg

    # -- 4. times ----------------------------------------------------------
    nb = xb.numel()
    lib_a = time_ms(lambda: torch.cumsum(xa, 0), 5)
    lib_b = time_ms(lambda: torch.cumsum(xb, 1), 5)
    for tag, x, n_el, lib, reps in (("(a) 2^28", xa, na, lib_a, 3),
                                    ("(b) 8192x32768", xb, nb, lib_b, 5)):
        for s in SCHEDULES:
            ms = time_ms(lambda: api.cumsum(x, algorithm="kernel",
                                            schedule=s), reps)
            traffic = 12 * n_el if s in ("decoupled", "fused") else 8 * n_el
            print(f"time {tag} {s:9s}: {ms:9.3f} ms  "
                  f"{8 * n_el / ms / 1e6:7.1f} GB/s  bound "
                  f"{traffic / bw * 1e3:.3f} ms ({traffic / 2**30:.0f} GiB)"
                  f"  torch.cumsum {lib:.3f} ms")
    ms = time_ms(lambda: api.cumsum(xb), 3)
    print(f"time (b) 8192x32768 auto -> {choice_b.algorithm}: {ms:9.3f} ms "
          "(the reference's per-row size rule)")

    # per kernel, at the shape the main path gave it
    lay_a = Rows(1, na, 1, 2048)
    xa2 = xa.view(1, na)
    lay_b = Rows(8192, 32768, 8, 2048)
    lay_c = Rows(8192, 32768, 8, 8192)
    tot = cuda.totals(xa2, lay_a)
    offs = cuda.chain(tot)
    n_chunks = tot.numel()
    rows = []

    def kernel_row(kname, run, run_plain, nbytes, adds, reps, library):
        got = run()
        want = run_plain()
        sync()
        check(same_bits(got, want), f"{kname}: kernel != plain at the "
              "main-path shape")
        err = (got.double() - want.double()).abs().max().item()
        del got, want
        ms = time_ms(run, reps)
        plain_ms = time_ms(run_plain, 1, warmup=0)
        lib_ms = None if library is None else time_ms(library, reps)
        b_ms, b_by = bound_ms(nbytes, adds)
        rows.append({
            "name": kname, "route": "cuda",
            "source": "src/repro_torch/csrc/scan_sum.cu",
            "replaces": REPLACES[kname], "launches": launches[kname],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms})
        print(f"kernel {kname:6s}: {ms:9.3f} ms  plain {plain_ms:9.3f} ms  "
              f"bound {b_ms:.4f} ms ({b_by})  library "
              f"{'-' if lib_ms is None else f'{lib_ms:.3f} ms'}")

    kernel_row("carry", lambda: cuda.carry(xb, lay_b, False),
               lambda: schedules.carry_plain((xb,), SUM, lay_b)[0],
               8 * nb, nb, 5, lambda: torch.cumsum(xb, 1))
    kernel_row("totals", lambda: cuda.totals(xa2, lay_a),
               lambda: schedules.totals_plain((xa2,), SUM, lay_a)[0],
               4 * na + 4 * n_chunks, na, 5,
               lambda: xa2.view(1, n_chunks, 2048).sum(-1))
    kernel_row("chain", lambda: cuda.chain(tot),
               lambda: schedules.exclusive_chain(SUM, (tot,))[0],
               8 * n_chunks, n_chunks, 5, None)
    kernel_row("apply", lambda: cuda.apply(xa2, offs, lay_a, False),
               lambda: schedules.apply_plain((xa2,), (offs,), SUM,
                                             lay_a)[0],
               8 * na + 4 * n_chunks, na, 5, None)
    kernel_row("tree", lambda: cuda.tree(xb, lay_c, False),
               lambda: schedules.tree_plain((xb,), SUM, lay_c)[0],
               8 * nb, nb, 5, lambda: torch.cumsum(xb, 1))

    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
