"""Causal LM: init / forward / loss / decode for every decoder-only arch.

The PyTorch counterpart of the reference's ``models/lm.py``. The layers
of ``cfg.layer_pattern`` repeat ``periods = num_layers / len(pattern)``
times. Where the reference stacks each pattern position's parameters
across periods and runs one ``lax.scan`` over them, the port holds an
``nn.ModuleList`` of periods (each an ``nn.ModuleDict`` named
``p{pos}_{kind}`` in pattern order) and loops over it, in the same order.
Decode caches keep the reference's layout: one tree per pattern position
whose leaves stack the periods on axis 0.

The cross-entropy loss is computed in SEQUENCE CHUNKS so the (B, S, V)
logits tensor is never materialized: an online logsumexp over chunks.
``remat=True`` checkpoints each period's body (the reference's remat of
its layer-scan body): the backward runs the period's forward again.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch.dist import shard
from repro_torch.models import blocks as blk
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers.embedding import (Embedding, embed_tokens,
                                                 init_lm_head, lm_logits)
from repro_torch.models.layers.frontend import Frontend, apply_frontend
from repro_torch.models.layers.norms import Norm, apply_norm


def _periods(cfg: ModelConfig) -> int:
    periods, rem = cfg.pattern_periods
    if rem:
        raise ValueError(
            f"layer_pattern {cfg.layer_pattern} must tile num_layers="
            f"{cfg.num_layers} exactly")
    return periods


def _names(cfg: ModelConfig):
    return [f"p{pos}_{kind}" for pos, kind in enumerate(cfg.layer_pattern)]


class LM(nn.Module):
    """The decoder-only LM: ``embed`` (+ ``lm_head`` when untied),
    ``final_norm``, the zamba2 ``shared`` block, the ``frontend`` adapter
    and ``blocks[period][p{pos}_{kind}]``."""

    def __init__(self, cfg: ModelConfig, *, generator=None, device="cuda"):
        super().__init__()
        self.cfg = cfg
        kw = dict(generator=generator, device=device)
        periods = _periods(cfg)
        self.embed = Embedding(cfg, **kw)
        if not cfg.tie_embeddings:
            self.lm_head = init_lm_head(cfg, **kw)
        self.final_norm = Norm(cfg, device=device)
        self.shared = (blk.SharedBlock(cfg, **kw)
                       if "shared_attn" in cfg.layer_pattern else None)
        if cfg.frontend_tokens:
            self.frontend = Frontend(cfg, **kw)
        self.blocks = nn.ModuleList(
            nn.ModuleDict({name: blk.Block(cfg, kind, **kw) for name, kind
                           in zip(_names(cfg), cfg.layer_pattern)})
            for _ in range(periods))


def init_lm(cfg: ModelConfig, *, generator=None, device="cuda") -> LM:
    """A randomly initialized LM on ``device``, drawn from ``generator``."""
    return LM(cfg, generator=generator, device=device)


def tree_map(fn, *trees):
    """``fn`` over the tensors of nested dicts of one structure."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device="cuda") -> dict:
    """Stacked (periods-leading) decode caches, one tree per pattern
    position."""
    periods = _periods(cfg)
    return {name: tree_map(
        lambda x: x[None].expand((periods,) + x.shape).clone(),
        blk.init_block_cache(cfg, kind, batch, max_len, device=device))
        for name, kind in zip(_names(cfg), cfg.layer_pattern)}


def _run_period(params, cfg, p, x, x0, positions, cache, cache_len,
                attn_impl, attn_schedule, ssm_impl):
    """One period's blocks: (x, aux, {name: new cache slice})."""
    aux = blk.zero_aux(x.device)
    new_caches = {}
    for name, kind in zip(_names(cfg), cfg.layer_pattern):
        c = None if cache is None else tree_map(lambda t: t[p], cache[name])
        x, a, new_c = blk.apply_block(
            params.blocks[p][name], x, cfg, kind, shared=params.shared,
            x0=x0, positions=positions, cache=c, cache_len=cache_len,
            attn_impl=attn_impl, attn_schedule=attn_schedule,
            ssm_impl=ssm_impl)
        aux = {k: aux[k] + a[k] for k in aux}
        new_caches[name] = new_c
    return x, aux, new_caches


def forward(
    params: LM,
    tokens: torch.Tensor,
    cfg: ModelConfig,
    *,
    embeds: Optional[torch.Tensor] = None,
    positions: Optional[torch.Tensor] = None,
    cache: Optional[dict] = None,
    cache_len=None,
    attn_impl: Optional[str] = None,
    attn_schedule: str = "auto",
    ssm_impl: Optional[str] = None,
    remat: bool = False,
    unroll: bool = False,
):
    """tokens (B, S) [+ frontend embeds (B, F, E)] -> (hidden, aux, cache).

    Returns final-norm hidden states — callers pick ``lm_logits`` (full) or
    the chunked loss below. With ``cache`` (decode), S is the new-token
    count and ``cache_len`` the count of valid cache entries — a scalar,
    or a PER-ROW (B,) tensor (each row gets its own positions and masking
    extent). ``ssm_impl`` overrides the SSM layers' scan route.
    ``remat=True`` runs each period under ``torch.utils.checkpoint``
    (non-reentrant): its activations are not kept, and the backward
    recomputes them. ``unroll`` has no effect here: it shapes the
    reference's compiled layer scan for its dry run, and the port's loop
    over periods is unrolled already.
    """
    x = embed_tokens(params, tokens, cfg)
    if embeds is not None:
        fe = apply_frontend(params.frontend, embeds, cfg)
        x = torch.cat([fe, x], dim=1)
    B, S, _ = x.shape
    if positions is None:
        steps = torch.arange(S, device=x.device)
        if isinstance(cache_len, torch.Tensor) and cache_len.ndim == 1:
            positions = cache_len[:, None] + steps[None]     # (B, S)
        else:
            positions = (0 if cache_len is None else cache_len) + steps
    x = shard(x, "batch", "seq", "embed")

    x0 = x
    aux = blk.zero_aux(x.device)
    new_caches = []
    for p in range(len(params.blocks)):
        args = (params, cfg, p, x, x0, positions, cache, cache_len,
                attn_impl, attn_schedule, ssm_impl)
        if remat:
            x, a, new_c = torch.utils.checkpoint.checkpoint(
                _run_period, *args, use_reentrant=False)
        else:
            x, a, new_c = _run_period(*args)
        aux = {k: aux[k] + a[k] for k in aux}
        new_caches.append(new_c)
    x = apply_norm(params.final_norm, x, cfg)
    new_cache = None
    if cache is not None:
        new_cache = tree_map(lambda *ts: torch.stack(ts), *new_caches)
    return x, aux, new_cache


# ---------------------------------------------------------------------------
# loss (chunked over sequence so B x S x V never materializes)
# ---------------------------------------------------------------------------


def chunked_ce_loss(params, hidden, labels, mask, cfg: ModelConfig,
                    chunk: int = 512):
    """Mean CE over valid tokens; logits produced chunk by chunk."""
    B, S, D = hidden.shape
    chunk = min(chunk, S)
    total = hidden.new_zeros((), dtype=torch.float32)
    count = hidden.new_zeros((), dtype=torch.float32)
    for lo in range(0, S, chunk):
        logits = lm_logits(params, hidden[:, lo:lo + chunk], cfg)
        lse = torch.logsumexp(logits, dim=-1)
        lab = labels[:, lo:lo + chunk].long()
        gold = torch.gather(logits, -1, lab[..., None])[..., 0]
        m = mask[:, lo:lo + chunk].float()
        total = total + ((lse - gold) * m).sum()
        count = count + m.sum()
    return total / count.clamp_min(1.0)


def lm_loss(params, batch: dict, cfg: ModelConfig, *, remat: bool = False,
            loss_chunk: int = 512, attn_impl: Optional[str] = None,
            attn_schedule: str = "auto", ssm_impl: Optional[str] = None,
            unroll: bool = False):
    """batch: tokens (B,S) int, labels (B,S) int, mask (B,S) float,
    optional embeds (B,F,E). Returns (loss, metrics). ``remat`` and
    ``unroll`` as in ``forward``."""
    hidden, aux, _ = forward(
        params, batch["tokens"], cfg, embeds=batch.get("embeds"),
        attn_impl=attn_impl, attn_schedule=attn_schedule, ssm_impl=ssm_impl,
        remat=remat, unroll=unroll)
    embeds = batch.get("embeds")
    F = embeds.shape[1] if embeds is not None else 0
    ce = chunked_ce_loss(params, hidden[:, F:], batch["labels"],
                         batch["mask"], cfg, chunk=loss_chunk)
    loss = (ce + cfg.router_aux_coef * aux["load_balance_loss"]
            + cfg.router_z_coef * aux["router_z_loss"])
    return loss, {"ce": ce, "loss": loss, **aux}


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def decode_step(params, tokens, cache, cache_len, cfg: ModelConfig,
                ssm_impl: Optional[str] = None):
    """One decode step: tokens (B, 1) + cache -> (logits (B, V), cache).

    ``cache_len`` may be a scalar (homogeneous pool) or a (B,) tensor of
    per-row lengths (a heterogeneous pool).
    """
    hidden, _, new_cache = forward(params, tokens, cfg, cache=cache,
                                   cache_len=cache_len, ssm_impl=ssm_impl)
    logits = lm_logits(params, hidden[:, -1:], cfg)[:, 0]
    return logits, new_cache


def prefill(params, tokens, cfg: ModelConfig, max_len: int,
            embeds: Optional[torch.Tensor] = None,
            attn_impl: Optional[str] = None, attn_schedule: str = "auto",
            ssm_impl: Optional[str] = None):
    """Run the prompt through the model, returning (logits_last, cache).

    The KV/state caches are filled by running forward in decode mode with
    cache_len=0 over the whole prompt.
    """
    B, S = tokens.shape
    dev = tokens.device
    cache = init_cache(cfg, B, max_len, device=dev)
    hidden, _, cache = forward(
        params, tokens, cfg, embeds=embeds, cache=cache,
        cache_len=torch.zeros((), dtype=torch.int32, device=dev),
        attn_impl=attn_impl, attn_schedule=attn_schedule, ssm_impl=ssm_impl)
    logits = lm_logits(params, hidden[:, -1:], cfg)[:, 0]
    return logits, cache
