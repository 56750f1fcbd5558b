"""Gradient compression with error feedback.

int8 blockwise-scaled quantization of gradients, with an error-feedback
accumulator so the quantization error is re-injected next step
(Karimireddy et al. 2019). Quantization is blockwise over the flattened
leaf (block 256): each block carries one f32 scale = max|g|/127 — 4.03
bits/elem effective vs 32. Rounding is half to even, as the reference's.

The reference's ``compressed_psum`` (an int8 psum inside ``shard_map``)
is a collective: it waits for the ``torch.distributed`` slice.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.optim.adamw import tree_map

Pytree = Any

_BLOCK = 256


def init_error_feedback(grads_like: Pytree) -> Pytree:
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads_like)


def _pad_len(n: int) -> int:
    return (-n) % _BLOCK


def compress_grads(grads: Pytree, error: Pytree):
    """(grads + error) -> (tree of (q int8, scales f32), new error);
    per leaf."""

    def one(g, e):
        g = g.to(torch.float32) + e
        flat = g.reshape(-1)
        fp = F.pad(flat, (0, _pad_len(flat.shape[0]))).reshape(-1, _BLOCK)
        scale = torch.amax(torch.abs(fp), dim=1, keepdim=True) / 127.0
        scale = torch.clamp_min(scale, 1e-12)
        q = torch.clamp(torch.round(fp / scale), -127, 127).to(torch.int8)
        deq = (q.to(torch.float32) * scale).reshape(-1)[: flat.shape[0]]
        return (q, scale.squeeze(-1)), g - deq.reshape(g.shape)

    pairs = tree_map(one, grads, error)
    return (tree_map(lambda p: p[0], pairs),
            tree_map(lambda p: p[1], pairs))


def decompress_grads(compressed: Pytree, shapes: Pytree) -> Pytree:
    """Inverse of ``compress_grads`` given the original leaves (anything
    with a ``shape``)."""

    def one(qe, like):
        q, scale = qe
        deq = q.to(torch.float32) * scale[:, None]
        flat = deq.reshape(-1)[: math.prod(like.shape)]
        return flat.reshape(tuple(like.shape))

    return tree_map(one, compressed, shapes)


