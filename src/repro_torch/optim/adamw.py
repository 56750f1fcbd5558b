"""AdamW with float32 master weights over bf16 compute params.

Trees are nested dicts of tensors (a flat ``name -> tensor`` dict of an
``LM``'s parameters among them); the state mirrors the parameter tree.
``mu`` / ``nu`` are float32, and ``master`` is a float32 copy of every
parameter that never aliases it, a float32 parameter's too. Unlike
``torch.optim.AdamW``, weight decay applies only to parameters of
``decay_min_ndim`` dimensions or more, and a bf16 parameter is the
rounding of its float32 master. Nothing is updated in place: the old
parameters and state stay valid beside the new ones (the trainer's NaN
guard rolls back to them).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch

Pytree = Any


class AdamWState(NamedTuple):
    step: torch.Tensor         # () int32
    mu: Pytree                 # f32, like params
    nu: Pytree                 # f32, like params
    master: Pytree             # f32 master copy


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # decay only matrices (ndim >= 2); norms/biases are excluded, matching
    # standard LM practice.
    decay_min_ndim: int = 2


def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts of one structure."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in tree for x in tree_leaves(tree[k])]
    return [tree]


def adamw_init(params: Pytree) -> AdamWState:
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else "cpu"
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        mu=tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                          device=x.device), params),
        nu=tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                          device=x.device), params),
        master=tree_map(lambda x: x.detach().to(torch.float32, copy=True),
                        params),
    )


def global_norm(tree: Pytree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.to(torch.float32)))
              for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def adamw_update(
    grads: Pytree,
    state: AdamWState,
    params: Pytree,
    cfg: AdamWConfig = AdamWConfig(),
    lr=None,
) -> tuple[Pytree, AdamWState, dict]:
    """One AdamW step. Returns (new_params, new_state, metrics).

    The reference's arithmetic in its order: the global-norm clip, the
    bias corrections ``1 - b^step``, the moments, the decoupled decay, and
    the new parameter as its master's rounding. Leaf by leaf, so that only
    one leaf's float32 gradient is alive beside the states at a time."""
    with torch.no_grad():
        step = state.step + 1
        lr_t = cfg.lr if lr is None else lr
        gnorm = global_norm(grads)
        scale = torch.minimum(torch.ones_like(gnorm),
                              cfg.grad_clip / (gnorm + 1e-12))
        stepf = step.to(torch.float32)
        b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, device=step.device), stepf)
        b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, device=step.device), stepf)

        def one(g, m, v, w, p):
            g = g.to(torch.float32) * scale
            m = cfg.b1 * m + (1 - cfg.b1) * g
            v = cfg.b2 * v + (1 - cfg.b2) * g * g
            delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
            if w.dim() >= cfg.decay_min_ndim:
                delta = delta + cfg.weight_decay * w
            w = w - lr_t * delta
            return m, v, w, w.to(p.dtype, copy=True)

        out = tree_map(one, grads, state.mu, state.nu, state.master, params)

        def part(i):
            return tree_map(lambda t: t[i], out) if isinstance(out, dict) \
                else out[i]
        new_state = AdamWState(step=step, mu=part(0), nu=part(1),
                               master=part(2))
        metrics = {"grad_norm": gnorm,
                   "lr": torch.as_tensor(lr_t, dtype=torch.float32)}
    return part(3), new_state, metrics
