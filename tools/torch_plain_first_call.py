#!/usr/bin/env python3
"""Run the CPU plain version of one float32 attention case once in a fresh
process, with each PyTorch operation it calls evaluated twice, and report
the operations whose two evaluations differ in any bit.

    PYTHONPATH=src python3 tools/torch_plain_first_call.py

Run it in many fresh processes (a shell loop): an operation that returns
other bits on its first call in a process shows here, by name, with its
largest difference and its shape (since ``repro_torch.core.scan.assoc``
absorbs MKL's first vector-math call when it is imported, none should).
The case is ``causal_gqa2`` with the
inputs of ``tools/torch_fold_repeat.py`` (and
``tests/test_torch_cuda_kernels.py``).
"""

from __future__ import annotations

import functools
import hashlib
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from torch_fold_repeat import CASES, inputs  # noqa: E402

from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402

OPS = ("matmul", "exp", "amax", "sum", "where", "maximum", "tanh")
found = []


def twice(name, fn):
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        first = fn(*args, **kwargs)
        again = fn(*args, **kwargs)
        if isinstance(first, torch.Tensor) and not torch.equal(first, again):
            found.append({
                "op": name, "shape": list(first.shape),
                "max_diff": (first.double() - again.double()).abs().max()
                .item()})
        return first
    return wrapped


def main() -> int:
    q, k, v, go = inputs("causal_gqa2")
    *_, D, causal, window, softcap, bq, bk = CASES["causal_gqa2"]
    kw = dict(scale=D ** -0.5, causal=causal, window=window, softcap=softcap,
              block_q=bq, block_k=bk, schedule="carry")
    for name in OPS:
        setattr(torch, name, twice(name, getattr(torch, name)))
    ts = [t.requires_grad_() for t in (q, k, v)]
    out = fa_ops.flash_attention(*ts, **kw)
    grads = torch.autograd.grad(out, ts, go)
    print(json.dumps({
        "threads": torch.get_num_threads(), "differing": found,
        "digests": [hashlib.sha1(t.detach().numpy().tobytes()).hexdigest()
                    [:12] for t in (out,) + grads]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
