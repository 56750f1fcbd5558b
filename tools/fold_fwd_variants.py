#!/usr/bin/env python3
"""Hold ``fold_fwd_tf32`` (the float32 flash forward as 3xTF32 on the
tensor cores) and variants of its wgmma accumulation chains against the
plain fold and against float64, and time them, on one card, in one
process.

    PYTHONPATH=src python3 tools/fold_fwd_variants.py

The tensor cores truncate as they add into their float32 accumulators, so
the length of a wgmma chain moves the forward's error. Each variant is
``csrc/attn_fold_tc.cu`` with a few text edits:

  base    the source: chains of at most four k-steps added in float32
          (one k-step in the d = 256 p·v product, for registers)
  chain   one chain over all of d for s, one over the cell's kv rows for
          p·v (the kernel's first form)
  steps1  one k-step a chain in both products, at every d
  steps4  four k-steps a chain in p·v at d = 256 too

All are compiled together into ``build/variants/fwd_<name>/`` (the ptxas
report of each instantiation printed: registers, spills), then run at
chip_smoke's float32 (h) and (f) global shapes with seeded normal inputs:
the carry fold against the plain fold (max |err| of out, m and l, and
whether each meets the forward bar, atol 1e-5 and rtol 1e-5), the split
pass's chunk (m, l) against the plain split pass, its chunk payloads
(m, l, acc) of two heads against float64 beside the plain version's, and
each variant's time (CUDA events, median of 3, in turns: each variant,
then again in reverse order), beside the SIMT ``fold_fwd`` launched by
name.
"""

from __future__ import annotations

import ctypes
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from repro_torch.kernels.flash_attention import ref
from repro_torch.kernels.flash_attention.flash_attention import forward_fold
from repro_torch.kernels.scan_engine import cuda, cuda_fold, schedules

S_CHAINS = '''        float part[32];   // the stage's 4 k-steps, from zero
        tf32_mma<4, PN, false, PN>(part, q_u, 32 * j, b, b + PN, tid, true);
#pragma unroll
        for (int x = 0; x < 32; ++x)
          s[x] = j == 0 ? part[x] : __fadd_rn(s[x], part[x]);'''
S_ONE = '''        tf32_mma<4, PN, false, PN>(s, q_u, 32 * j, b, b + PN, tid, j == 0);'''
S_STEP = '''#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          float part[32];   // one k-step, from zero
          tf32_mma<1, PN, false, PN, 1>(part, q_u, 32 * j + 8 * kk,
                                        b + 32 * kk, b + PN + 32 * kk, tid,
                                        true);
#pragma unroll
          for (int x = 0; x < 32; ++x)
            s[x] = j == 0 && kk == 0 ? part[x] : __fadd_rn(s[x], part[x]);
        }'''
P_CHAINS = '''          constexpr int KC = G::kProductSteps;
#pragma unroll
          for (int c = 0; c < 8 / KC; ++c) {
            float part[32];
            // kv rows 8 KC c .. of the tile: p's panel and k-step there
            const uint32_t off = (2 * t + KC * c / 4) * PN + 32 * (KC * c % 4);
            tf32_mma<KC, PN, true, PN, KC == 1 ? 1 : 2>(
                part, ring_u + stage * G::kStageBytes + 2 * PN * wg,
                8 * KC * c, p_hi + off, p_lo + off, tid, true);
#pragma unroll
            for (int x = 0; x < 32; ++x)
              e[x] = t == 0 && c == 0 ? part[x] : __fadd_rn(e[x], part[x]);
          }'''
P_ONE = '''          tf32_mma<8, PN, true, PN>(
              e, ring_u + stage * G::kStageBytes + 2 * PN * wg, 0,
              p_hi + 2 * PN * t, p_lo + 2 * PN * t, tid, t == 0);'''
STEPS = "  static constexpr int kProductSteps = D == 256 ? 1 : 4;"
VARIANTS = {
    "base": [],
    "chain": [(S_CHAINS, S_ONE), (P_CHAINS, P_ONE)],
    "steps1": [(S_CHAINS, S_STEP),
               (STEPS, "  static constexpr int kProductSteps = 1;")],
    "steps4": [(STEPS, "  static constexpr int kProductSteps = 4;")],
}
FWD_TOL = 1e-5   # tests/test_flash_engine.py:99
# (name, q heads, kv heads, T, d, softcap): chip_smoke's (h) and (f) global
SHAPES = (("(h)", 40, 10, 4096, 128, None), ("(f)", 16, 8, 8192, 256, 50.0))


def time_ms(fn, reps=3):
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


def errs(got, want):
    """Per leaf: (max |got - want|, within the forward bar)."""
    out = []
    for a, b in zip(got, want):
        d = (a.double() - b.double()).abs()
        ok = bool((d <= FWD_TOL + FWD_TOL * b.double().abs()).all())
        out.append(f"{d.max().item():.3g}{'' if ok else ' (over)'}")
    return "(" + ", ".join(out) + ")"


def main() -> int:
    if not torch.cuda.is_available():
        print("fold_fwd_variants: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    source = cuda_fold.TC_SOURCE.read_text()
    dirs = {}
    for name, edits in VARIANTS.items():
        text = source
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"variant {name}: {old[:60]!r}... not in "
                                 "the source")
            text = text.replace(old, new)
        d = cuda.BUILD_DIR / "variants" / f"fwd_{name}"
        d.mkdir(parents=True, exist_ok=True)
        (d / "attn_fold_tc.cu").write_text(text)
        for h in cuda_fold.TC_SOURCE.parent.glob("*.cuh"):
            (d / h.name).write_text(h.read_text())
        dirs[name] = d
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(dirs) + 1) as pool:
        simt = pool.submit(cuda_fold.build)
        built = [pool.submit(cuda.compile_library, d / "attn_fold_tc.cu", d)
                 for d in dirs.values()]
        libs = {}
        for name, fut in zip(dirs, built):
            so, log = fut.result()
            lib = ctypes.CDLL(str(so))
            cuda_fold._bind(lib, ("attn_fold_fwd_tf32",),
                            "attn_tc_error_string")
            libs[name] = lib
            entry, report = None, []
            for line in log.splitlines():
                if "Compiling entry function" in line:
                    found = re.search(r"fold_fwd_tf32_kernelILi(\d+)E", line)
                    entry = found and found[1]
                elif entry and "spill stores" in line:
                    spill = line.strip().split(", ")[1]
                elif entry and "Used" in line:
                    used = line.split("Used")[1].split(",")[0].strip()
                    report.append(f"<{entry}> {used}, {spill}")
                    entry = None
            print(f"  {name}: fold_fwd_tf32 " + "; ".join(report))
        simt.result()
    print(f"built {len(dirs)} variants in {time.perf_counter() - t0:.1f} s")

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for tag, hq, hkv, t, d, cap in SHAPES:
        q, k, v = (torch.randn(s, device=dev, generator=gen)
                   for s in ((hq, t, d), (hkv, t, d), (hkv, t, d)))
        kw = dict(group=hq // hkv, scale=d ** -0.5, causal=True, softcap=cap)
        spec, lay = forward_fold(q.shape, k.shape, return_stats=True, **kw)
        spec_s, lay_s = forward_fold(q.shape, k.shape, return_stats=True,
                                     schedule="decoupled", **kw)
        two = (q[:2], k[:1], v[:1])
        spec_2, lay_2 = forward_fold(two[0].shape, two[1].shape,
                                     return_stats=True, schedule="decoupled",
                                     **dict(kw, group=2))
        want = schedules.fold_carry_plain((q, k, v), spec, lay)
        w_tot = schedules.fold_totals_plain((q, k, v), spec_s, lay_s)
        # rounded to float32: a fully masked chunk's m is NEG_INF there
        f64 = tuple(w.float() for w in ref.split_payload_ref(
            *(x.double() for x in two), spec_2, lay_2))
        print(f"{tag} {hq}x{t}x{d}: the plain split payload (m, l, acc) of "
              f"two heads vs float64 "
              f"{errs(schedules.fold_totals_plain(two, spec_2, lay_2), f64)}")
        simt_out = cuda_fold.fold(spec, (q, k, v), lay, form="fold_fwd")[0]
        print(f"{tag} SIMT fold_fwd: carry vs plain (out, m, l) "
              f"{errs(simt_out, want)}")
        del simt_out
        for name, lib in libs.items():
            cuda_fold._lib_tc = lib
            got = cuda_fold.fold(spec, (q, k, v), lay)[0]
            tot = cuda_fold.fold_totals(spec_s, (q, k, v), lay_s)
            tot2 = cuda_fold.fold_totals(spec_2, two, lay_2)
            print(f"{tag} {name}: carry vs plain (out, m, l) "
                  f"{errs(got, want)}; split (m, l) vs plain "
                  f"{errs(tot[:2], w_tot[:2])}; split payload of two heads "
                  f"vs float64 {errs(tot2, f64)}")
            del got, tot, tot2
        times = {name: [] for name in libs}
        simt_ms = time_ms(lambda: cuda_fold.fold(spec, (q, k, v), lay,
                                                 form="fold_fwd"))
        for name in list(libs) + list(reversed(list(libs))):
            cuda_fold._lib_tc = libs[name]
            times[name].append(time_ms(
                lambda: cuda_fold.fold(spec, (q, k, v), lay)))
        print(f"{tag} ms: " + "; ".join(
            f"{n} " + " / ".join(f"{x:.3f}" for x in ts)
            for n, ts in times.items()) + f"; SIMT fold_fwd {simt_ms:.3f}")
        del q, k, v, want, w_tot, f64
        torch.cuda.empty_cache()
    cuda_fold._lib_tc = None
    return 0


if __name__ == "__main__":
    sys.exit(main())
