#!/usr/bin/env python3
"""What ``torch.profiler`` records of the port's kernels, and after what.

    PYTHONPATH=src python3 tools/profiler_window.py

Card only. Builds (or loads from ``build/``) the scan and fold kernel
libraries, then takes profiler windows (CPU + CUDA activities, as
chip_smoke.py takes them) in one process, in this order, each around one
call and each printed as the CUDA events it recorded, their device time
and names:

  1. a bf16 flash forward at phi3-medium-14b's 4096-token prefill
     (fold_fwd_tc), a SIMT fold (fold_fwd, d 112, zamba2-7b's head dim), a
     scan kernel (the affine carry) and a torch matmul, in a process that
     has captured no CUDA graph;
  2. the same four after a CUDA graph of a torch matmul was captured and
     replayed (chip_smoke.py's ``graph_ms`` captures graphs of its kernels
     from phase 5 on, before phase 7's window that records nothing);
  3. the same four after a graph of a fold kernel was captured and
     replayed;
  4. windows whose call launches a kernel for the first time in the
     process (its module or function loaded lazily inside the window):
     the flash forward with autograd (its statistics' kernel), then again;
     chip_smoke.py phase 7's (h) window as it was taken (a spin kernel,
     ``torch.cuda._sleep``, run for the first time, then the forward),
     then again; each window also prints the host events of lazy loading
     it recorded.

The output says whether a window's loss follows graph capture, our
ctypes launches, or a kernel loaded lazily inside the window.
"""

from __future__ import annotations

import subprocess
import sys

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.scan_engine import Channels, cuda, cuda_fold, monoids


def recorded(prof):
    """(CUDA events, device ms, top names) of a finished window."""
    kern = {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        kern[ev.key[:40]] = kern.get(ev.key[:40], 0) + us
    top = sorted(kern.items(), key=lambda kv: -kv[1])[:3]
    return len(kern), sum(kern.values()) / 1e3, top


def window(label, fn):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n, ms, top = recorded(prof)
    loads = sorted({ev.key for ev in prof.key_averages()
                    if "Loading" in ev.key})
    print(f"  {label:34s}: {n} CUDA event kinds, device {ms:.3f} ms; "
          + ", ".join(f"{k} {v / 1e3:.3f}" for k, v in top)
          + (f"; lazy loading in the window: {loads}" if loads else ""),
          flush=True)


def graph_of(fn):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    g.replay()
    torch.cuda.synchronize()


def main() -> int:
    if not torch.cuda.is_available():
        print("profiler_window: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], f"torch {torch.__version__}")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    cuda.build()
    cuda_fold.build()
    cuda_fold.build_tc()
    q = torch.randn(1, 40, 4096, 128, device=dev, generator=g).bfloat16()
    kv = torch.randn(1, 10, 4096, 128, device=dev, generator=g).bfloat16()
    qz = torch.randn(1, 32, 4096, 112, device=dev, generator=g).bfloat16()
    a = torch.rand(1, 32, 458752, device=dev, generator=g)
    b = torch.randn(1, 32, 458752, device=dev, generator=g)
    lay = Channels(1, 32, 458752, 32, 512)
    m = torch.randn(4096, 4096, device=dev, generator=g)
    calls = {
        "flash bf16 (fold_fwd_tc)": lambda: fa_ops.flash_attention(q, kv, kv),
        "flash bf16 d 112 (fold_fwd)": lambda: fa_ops.flash_attention(
            qz, qz, qz),
        "affine carry (scan_sum.cu)": lambda: cuda.carry(
            monoids.AFFINE, (a, b), lay),
        "torch matmul": lambda: m @ m,
    }
    for fn in calls.values():   # every kernel loaded and run once
        fn()
    print("1. no CUDA graph captured yet")
    for label, fn in calls.items():
        window(label, fn)
    graph_of(lambda: m @ m)
    print("2. after a CUDA graph of a torch matmul")
    for label, fn in calls.items():
        window(label, fn)
    graph_of(calls["flash bf16 (fold_fwd_tc)"])
    print("3. after a CUDA graph of a fold kernel")
    for label, fn in calls.items():
        window(label, fn)
    print("4. a kernel's first launch in the process inside the window")
    qg = q.clone().requires_grad_()

    def spin_then_flash():   # chip_smoke.py phase 7's (h) window
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        fa_ops.flash_attention(qg, kv, kv)

    window("flash with autograd, first", lambda: fa_ops.flash_attention(
        qg, kv, kv))
    window("flash with autograd, again", lambda: fa_ops.flash_attention(
        qg, kv, kv))
    window("spin (first) + flash", spin_then_flash)
    window("spin (again) + flash", spin_then_flash)
    window("flash bf16 (fold_fwd_tc), last", calls["flash bf16 (fold_fwd_tc)"])
    print("launches:", {k: v for k, v in cuda_fold.LAUNCHES.items() if v})
    return 0


if __name__ == "__main__":
    sys.exit(main())
