#!/usr/bin/env python3
"""Run one attention case of the port's card tests many times, on the card
and through the CPU plain versions, and compare the bits from run to run.

    PYTHONPATH=src python3 tools/torch_fold_repeat.py [--reps 500]
        [--case causal_gqa2] [--schedule carry] [--poison]

The case is one of ``tests/test_torch_cuda_kernels.py``'s ``ATTN_CASES``,
with the same float32 inputs (numpy's generator seeded by the case
name). Each repeat runs ``flash_attention`` forward and backward (output,
dq, dk, dv). Prints, per output: how many repeats differ in any bit from the first
one, on the card and on the CPU; whether the CPU plain version gives other
bits under 1, 2 and 4 threads or from operands that start 4 bytes off
their usual alignment; and the card-vs-CPU margin, the largest
|got - want| / (atol + rtol |want|) over the elements (above 1 fails the
test's bar), over every pair of repeats; and a digest of each side's first
bits, to compare across processes. ``--poison`` fills the card's
cached free memory with NaN before each card repeat, so that an output
element no kernel writes, or a read of memory no one wrote, shows as other
bits (without it a repeat reuses the last repeat's blocks, which hold the
same values).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402

# tests/test_torch_cuda_kernels.py's ATTN_CASES:
# (name, B, Hkv, group, Tq, Tk, D, causal, window, softcap, bq, bk)
CASES = {
    "causal_gqa2": (1, 2, 2, 256, 256, 32, True, None, None, 128, 128),
    "window_cap": (1, 2, 4, 256, 256, 16, True, 96, 20.0, 128, 64),
    "ragged_noncausal": (1, 1, 1, 200, 300, 16, False, None, None, 128, 128),
    "d256_softcap": (1, 2, 2, 256, 256, 256, True, 160, 50.0, 128, 128),
    "decode_d128": (2, 2, 4, 1, 1000, 128, False, None, None, 128, 128),
}
# (atol, rtol) of the forward and of the gradients in float32
TOL = ((1e-5, 1e-5), (1e-4, 1e-4))
NAMES = ("out", "dq", "dk", "dv")


def inputs(name):
    B, Hkv, g, Tq, Tk, D = CASES[name][:6]
    rng = np.random.default_rng(sum(map(ord, name)))
    return tuple(torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)) for s in ((B, Hkv * g, Tq, D),
                                         (B, Hkv, Tk, D), (B, Hkv, Tk, D),
                                         (B, Hkv * g, Tq, D)))


def poison(device):
    """Leave NaN in the caching allocator's free blocks of the sizes a
    small call allocates."""
    junk = [torch.full((n // 4,), float("nan"), device=device)
            for n in (512, 4096, 32768, 131072, 1 << 20, 4 << 20)
            for _ in range(32)]
    del junk


def run(q, k, v, go, device, kw, offset=False, dirty=False):
    if dirty:
        poison(device)
    ts = []
    for t in (q, k, v):
        if offset:   # the same values, 4 bytes past the allocator's alignment
            buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=device)
            t = buf[1:].view(t.shape).copy_(t)
        ts.append(t.to(device).requires_grad_())
    out = fa_ops.flash_attention(*ts, **kw)
    grads = torch.autograd.grad(out, ts, go.to(device))
    return [x.detach().cpu() for x in (out,) + grads]


def bits(t):
    return t.view(torch.int32) if t.element_size() == 4 else t.view(
        torch.int16)


def same(a, b):
    return torch.equal(bits(a), bits(b))


def distinct(runs, i):
    """Output i of each run, one copy of each bit pattern."""
    seen = []
    for r in runs:
        if not any(same(r[i], s) for s in seen):
            seen.append(r[i])
    return seen


def digest(t):
    return hashlib.sha1(bits(t).numpy().tobytes()).hexdigest()[:12]


def margin(got, want, tol):
    atol, rtol = tol
    d = (got.double() - want.double()).abs()
    return (d / (atol + rtol * want.double().abs())).max().item()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=500)
    ap.add_argument("--case", default="causal_gqa2", choices=sorted(CASES))
    ap.add_argument("--schedule", default="carry")
    ap.add_argument("--poison", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    q, k, v, go = inputs(args.case)
    *_, D, causal, window, softcap, bq, bk = CASES[args.case]
    kw = dict(scale=D ** -0.5, causal=causal, window=window, softcap=softcap,
              block_q=bq, block_k=bk, schedule=args.schedule)
    threads = torch.get_num_threads()
    card = [run(q, k, v, go, "cuda", kw, dirty=args.poison)
            for _ in range(args.reps)]
    cpu = [run(q, k, v, go, "cpu", kw) for _ in range(args.reps)]
    by_threads = {}
    for n in (1, 2, 4):
        torch.set_num_threads(n)
        by_threads[n] = run(q, k, v, go, "cpu", kw)
    torch.set_num_threads(threads)
    shifted = run(q, k, v, go, "cpu", kw, offset=True)
    card_shifted = run(q, k, v, go, "cuda", kw, offset=True)
    report = {"case": args.case, "schedule": args.schedule,
              "dtype": "float32", "reps": args.reps, "poison": args.poison,
              "cpu_threads": threads,
              "device": torch.cuda.get_device_name(0)}
    for i, name in enumerate(NAMES):
        tol = TOL[0] if i == 0 else TOL[1]
        margins = [margin(c, p, tol) for c in distinct(card, i)
                   for p in distinct(cpu, i)]
        report[name] = {
            "card_reps_differing": sum(not same(c[i], card[0][i])
                                       for c in card),
            "cpu_reps_differing": sum(not same(p[i], cpu[0][i]) for p in cpu),
            "cpu_threads_differing": [n for n, r in by_threads.items()
                                      if not same(r[i], cpu[0][i])],
            "cpu_offset_differs": not same(shifted[i], cpu[0][i]),
            "card_offset_differs": not same(card_shifted[i], card[0][i]),
            "card_distinct": len(distinct(card, i)),
            "cpu_distinct": len(distinct(cpu, i)),
            "margin_min": min(margins), "margin_max": max(margins),
            "max_abs_diff": (card[0][i].double()
                             - cpu[0][i].double()).abs().max().item(),
            "card_digest": digest(card[0][i]),
            "cpu_digest": digest(cpu[0][i]),
        }
    print(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
