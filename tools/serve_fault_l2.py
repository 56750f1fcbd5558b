#!/usr/bin/env python3
"""How far one faulty kernel call moves zamba2-7b's prefill logits, beside
the bound ``chip_smoke.py`` holds them to (``SERVE_L2_BOUND``).

    PYTHONPATH=src python3 tools/serve_fault_l2.py            # the card
    PYTHONPATH=src python3 tools/serve_fault_l2.py --device cpu --smoke \\
        --tokens 512                                           # rehearsal

Builds zamba2-7b in bf16 from ``--seed`` (full width and all 81 layers on
the card; ``--smoke``: the SMOKE widths with all 81 layers) and prefills
one prompt of ``--tokens`` (default chip_smoke's 4096) through the kernel
routes (``attn_impl="flash"``, ``ssm_impl="kernel"``; on the CPU the
kernels' plain versions), then on the plain routes (dense attention, the
chunked SSD), as chip_smoke.py's serve phase does. It prints the relative
L2 error of the last position's logits, kernel routes against plain
routes, for the prefill as it is and with a fault planted in one kernel
call, made at ``scan_engine.scan``:

  - ``fold_no_causal``: the first shared-attention fold without its
    causal mask (every query sees every key);
  - ``carry_no_decay``: the first Mamba2 layer's SSD chunk carry with
    ``a = 1`` (the state never decays);
  - ``carry_no_decay_last``: the same in the last Mamba2 layer.

Each reading is printed beside the bound, over or under it. Exits 1 if
the clean prefill reads over the bound.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke  # noqa: E402  (the serve phase's constants)
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import scan_engine  # noqa: E402
from repro_torch.kernels.flash_attention.flash_attention import \
    forward_fold  # noqa: E402
from repro_torch.models import lm  # noqa: E402


def fold_no_causal(operands, spec, layout):
    """The fold's (spec, layout) with the causal mask taken off."""
    at = spec.attn
    if layout.splits != 1:
        raise SystemExit(f"the fold runs {layout.splits} KV splits: the "
                         "fault is planted in the carry fold only")
    return (operands,) + forward_fold(
        operands[0].shape, operands[1].shape, group=layout.group,
        scale=at.scale, causal=False, window=at.window, softcap=at.softcap,
        kv_len=at.kv_len, block_q=at.block_q, block_k=at.block_k,
        return_stats=at.with_stats)


def carry_no_decay(operands, spec, layout):
    a, b = operands
    return (torch.ones_like(a), b), spec, layout


def prefill_with_fault(model, tokens, cfg, max_len, fault, nth):
    """The kernel-route prefill's last logits, the ``nth`` call of the
    kind ``fault`` changes (fold or affine carry; -1: the last) changed."""
    real_scan = scan_engine.scan
    kind = "fold" if fault is fold_no_causal else "affine"
    calls = []

    def count(operands, spec, layout, **kw):
        key = "fold" if spec.attn is not None else spec.name
        calls.append(key)
        return real_scan(operands, spec, layout, **kw)

    def plant(operands, spec, layout, **kw):
        key = "fold" if spec.attn is not None else spec.name
        seen.append(key)
        if key == kind and seen.count(kind) == target:
            operands, spec, layout = fault(operands, spec, layout)
        return real_scan(operands, spec, layout, **kw)

    seen = []
    target = nth
    try:
        if nth < 0:          # count the kind's calls first
            scan_engine.scan = count
            with torch.no_grad():
                lm.prefill(model, tokens, cfg, max_len, attn_impl="flash",
                           ssm_impl="kernel")
            target = calls.count(kind) + 1 + nth
        scan_engine.scan = plant
        with torch.no_grad():
            logits, _ = lm.prefill(model, tokens, cfg, max_len,
                                   attn_impl="flash", ssm_impl="kernel")
    finally:
        scan_engine.scan = real_scan
    if seen.count(kind) < target:
        raise SystemExit(f"{fault.__name__}: only {seen.count(kind)} "
                         f"{kind} calls in the prefill")
    return logits


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="the SMOKE widths, with all 81 layers")
    ap.add_argument("--tokens", type=int, default=chip_smoke.SERVE_PROMPTS[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    dev = torch.device(args.device)
    cfg = configs.get_config("zamba2-7b")
    if args.smoke:
        cfg = dataclasses.replace(configs.get_smoke_config("zamba2-7b"),
                                  num_layers=cfg.num_layers,
                                  max_seq_len=cfg.max_seq_len)
    page = chip_smoke.SERVE_PAGE
    max_len = -(-(args.tokens + 256) // page) * page
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    with torch.no_grad():
        model = lm.init_lm(cfg, generator=gen, device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (1, args.tokens), device=dev,
                           generator=gen)
    with torch.no_grad():
        plain, _ = lm.prefill(model, tokens, cfg, max_len,
                              ssm_impl="chunked")
        kernel, _ = lm.prefill(model, tokens, cfg, max_len,
                               attn_impl="flash", ssm_impl="kernel")

    def l2(got):
        return ((got - plain).float().norm() / plain.float().norm()).item()

    bound = chip_smoke.SERVE_L2_BOUND
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"zamba2-7b {'SMOKE widths, ' if args.smoke else ''}"
          f"{cfg.num_layers} layers, d_model {cfg.d_model}, bf16, seed "
          f"{args.seed}, one prompt of {args.tokens} tokens, cache "
          f"{max_len}, on {where}; bound {bound}")
    clean = l2(kernel)
    print(f"  clean prefill: relative L2 {clean:.5g} "
          f"({clean / bound:.3g}x the bound)")
    for fault, nth, name in ((fold_no_causal, 1, "fold_no_causal"),
                             (carry_no_decay, 1, "carry_no_decay"),
                             (carry_no_decay, -1, "carry_no_decay_last")):
        e = l2(prefill_with_fault(model, tokens, cfg, max_len, fault, nth))
        print(f"  {name}: relative L2 {e:.5g} "
              f"({'over' if e > bound else 'under'} the bound, "
              f"{e / bound:.3g}x)")
    return 0 if clean <= bound else 1


if __name__ == "__main__":
    sys.exit(main())
