"""The train step: loss -> grads -> AdamW.

Parameters are a tree in the reference's layout (``init_params``: nested
dicts of tensors, each block leaf stacked across periods, so the
optimizer's decay by a leaf's dimensions is the reference's). The loss
runs through ``torch.func.functional_call`` on a parameterless skeleton of
the model (built on the ``meta`` device), its parameters views of the
tree's leaves (``convert.flat_params``), so
the step is a function of its inputs, as the reference's is:
``step(params, opt_state, batch, step_idx) -> (new_params, new_state,
metrics)`` leaves ``params`` and ``opt_state`` valid, and the trainer's
NaN guard rolls back to them. The old and new parameters and states are
alive together until the caller drops the old ones.

  * Gradient **accumulation** over microbatches: the batch split along
    its first axis, a float32 accumulator, one optimizer apply.
  * **Remat** (activation checkpointing): each period of the model under
    ``torch.utils.checkpoint``; the backward recomputes its forward.
  * ``attn_impl="flash"`` trains on the engine's fold kernels (forward and
    backward), ``ssm_impl="kernel"`` on its affine scan (forward, and the
    backward as one more scan): peers of the plain routes.

The reference's mesh shardings of the step (``shardings_for``) wait for
the ``torch.distributed`` slice (ROADMAP Queue 1 item 8), its
encoder-decoder loss for ``models/encdec.py`` (item 7).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch
from torch import nn

from repro_torch.models import convert
from repro_torch.models import lm as lm_mod
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.optim.schedule import cosine_schedule

Pytree = Any


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    microbatches: int = 1
    remat: bool = True
    # None = auto (dense<=4k, blockwise); "flash" trains on the engine's
    # fold kernels, forward and backward.
    attn_impl: Optional[str] = None
    attn_schedule: str = "auto"       # flash fold organization
    # None = auto (chunked reference when training); "kernel" trains SSM
    # layers on the engine's affine kernel, forward and backward.
    ssm_impl: Optional[str] = None
    unroll_layers: bool = False       # the reference's dry run; no effect
    loss_chunk: int = 512
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    grad_clip: float = 1.0
    weight_decay: float = 0.1
    compress_cross_pod: bool = False


def _encdec_waits(cfg: ModelConfig):
    raise NotImplementedError(
        f"{cfg.name} is an encoder-decoder: its loss and init wait for "
        "models/encdec.py (ROADMAP Queue 1 item 7)")


def loss_fn_for(cfg: ModelConfig) -> Callable:
    if cfg.is_encdec:
        _encdec_waits(cfg)
    return lm_mod.lm_loss


def init_params(cfg: ModelConfig, *, generator=None,
                device="cuda") -> dict:
    """A randomly initialized model's parameters, drawn from ``generator``
    on ``device``, in the reference's tree layout
    (``convert.params_tree``: each block leaf stacked across periods)."""
    if cfg.is_encdec:
        _encdec_waits(cfg)
    with torch.no_grad():
        model = lm_mod.init_lm(cfg, generator=generator, device=device)
        return convert.params_tree(model, cfg)


class _LossAndGrad(nn.Module):
    """The loss of a model skeleton and its gradients with respect to
    ``leaves``, whose views ``functional_call`` puts in place of its
    parameters. The backward runs inside the call, where the remat's
    recomputation still finds those views in the skeleton."""

    def __init__(self, cfg: ModelConfig, loss_fn: Callable):
        super().__init__()
        self.cfg = cfg
        self.loss_fn = loss_fn
        self.model = lm_mod.LM(cfg, device="meta")

    def forward(self, batch, leaves, **kw):
        loss, metrics = self.loss_fn(self.model, batch, self.cfg, **kw)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, leaves)]
        return (loss.detach(),
                {k: v.detach() for k, v in metrics.items()}, grads)


def _value_and_grad(module, params, batch, tcfg: TrainStepConfig):
    """(loss, metrics, grads in ``params``' tree layout)."""
    tree = adamw.tree_map(lambda p: p.detach().requires_grad_(True), params)
    leaves = adamw.tree_leaves(tree)
    flat = convert.flat_params(tree)
    loss, metrics, grads = torch.func.functional_call(
        module, {f"model.{k}": v for k, v in flat.items()},
        (batch, leaves),
        dict(remat=tcfg.remat, loss_chunk=tcfg.loss_chunk,
             attn_impl=tcfg.attn_impl, attn_schedule=tcfg.attn_schedule,
             ssm_impl=tcfg.ssm_impl, unroll=tcfg.unroll_layers))
    it = iter(grads)
    return loss, metrics, adamw.tree_map(lambda _: next(it), tree)


def _accumulate_grads(module, params, batch, tcfg: TrainStepConfig):
    """Microbatched value-and-grad with a float32 accumulator."""
    m = tcfg.microbatches
    if m <= 1:
        return _value_and_grad(module, params, batch, tcfg)

    def micro(x, i):
        B = x.shape[0]
        return x.reshape((m, B // m) + tuple(x.shape[1:]))[i]

    gacc = lacc = macc = None
    for i in range(m):
        mb = {k: micro(v, i) for k, v in batch.items()}
        loss, metrics, grads = _value_and_grad(module, params, mb, tcfg)
        if gacc is None:
            gacc = adamw.tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            lacc = torch.zeros((), dtype=torch.float32, device=loss.device)
            macc = {k: torch.zeros((), dtype=torch.float32,
                                   device=v.device)
                    for k, v in metrics.items()}
        gacc = adamw.tree_map(lambda a, g: a + g.to(torch.float32) / m,
                              gacc, grads)
        del grads
        macc = {k: a + metrics[k] / m for k, a in macc.items()}
        lacc = lacc + loss / m
    return lacc, macc, gacc


def make_train_step(
    cfg: ModelConfig,
    tcfg: TrainStepConfig = TrainStepConfig(),
    adamw_cfg: Optional[adamw.AdamWConfig] = None,
):
    """Returns ``step(params, opt_state, batch, step_idx) -> (new_params,
    new_state, metrics)``."""
    acfg = adamw_cfg or adamw.AdamWConfig(
        lr=tcfg.peak_lr, grad_clip=tcfg.grad_clip,
        weight_decay=tcfg.weight_decay)
    module = _LossAndGrad(cfg, loss_fn_for(cfg))

    def step(params, opt_state, batch, step_idx):
        loss, metrics, grads = _accumulate_grads(module, params, batch, tcfg)
        lr = cosine_schedule(
            step_idx, peak_lr=tcfg.peak_lr, warmup_steps=tcfg.warmup_steps,
            total_steps=tcfg.total_steps).to(loss.device)
        new_params, new_state, opt_metrics = adamw.adamw_update(
            grads, opt_state, params, acfg, lr=lr)
        metrics = dict(metrics, **opt_metrics, loss=loss)
        return new_params, new_state, metrics

    return step
