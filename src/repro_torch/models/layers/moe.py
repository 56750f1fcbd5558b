"""Mixture-of-Experts FFN with prefix-sum (scan-offset) dispatch.

The PyTorch counterpart of the reference's ``models/layers/moe.py``: the
paper's §1 database use case embedded in an LM. Partitioning tokens by
expert is a radix-partitioning step whose write offsets come from an
exclusive prefix sum over the expert histogram — the relational stable
partition (``repro_torch.relational.partition``), experts playing the
role of radix buckets:

    counts[e]  = histogram of routed tokens            (paper: histogram)
    offsets[e] = exclusive_scan(counts)                (paper: prefix sum)
    rank[t]    = running per-expert count before t     (segmented scan)
    dest[t]    = offsets[expert[t]] + rank[t]          (paper: new index)

Tokens scatter into per-expert capacity buffers at ``dest``, the expert
FFNs run as a batched einsum, and results scatter back weighted by the
router probabilities. Tokens whose rank exceeds capacity are dropped;
their residual path passes through unchanged. Dispatch runs per data
shard (one shard without a mesh): where the reference ``jax.vmap``s the
partition plan over shards, the port runs it shard by shard, with the
same integers.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.dist import shard
from repro_torch.dist.sharding import current_mesh
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers.common import (activation, compute_dtype,
                                              dense_init)
from repro_torch.relational.partition import partition_plan


class MoEAux(NamedTuple):
    load_balance_loss: torch.Tensor
    router_z_loss: torch.Tensor
    dropped_fraction: torch.Tensor


class MoE(nn.Module):
    """float32 ``router`` (D, E) and the expert stacks ``w_gate`` /
    ``w_up`` (E, D, F) and ``w_down`` (E, F, D)."""

    def __init__(self, cfg: ModelConfig, *, generator=None, device="cuda"):
        super().__init__()
        self.cfg = cfg
        dt = compute_dtype(cfg)
        d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
        kw = dict(generator=generator, device=device)
        self.router = dense_init((d, e), d, torch.float32, **kw)
        self.w_gate = dense_init((e, d, f), d, dt, **kw)
        self.w_up = dense_init((e, d, f), d, dt, **kw)
        self.w_down = dense_init((e, f, d), f, dt, **kw)

    def forward(self, x):
        return apply_moe(self, x, self.cfg)


def _capacity(tokens: int, cfg: ModelConfig) -> int:
    cap = int(tokens * cfg.top_k * cfg.capacity_factor / cfg.num_experts)
    return max(8, -(-cap // 8) * 8)  # round up to 8 for tiling


def _data_shards() -> int:
    """Data-parallel shard count under the installed mesh (1 otherwise)."""
    mesh = current_mesh()
    if mesh is None:
        return 1
    n = 1
    for ax in ("pod", "data"):
        n *= mesh.shape.get(ax, 1)
    return n


def dispatch_slots(flat_ids: torch.Tensor, num_experts: int, capacity: int):
    """(keep, slot) for (G, TL·K) expert choices: each shard's partition
    plan ranks its tokens within their experts; a token keeps its slot
    ``expert · C + rank`` while its rank is under the capacity C, and
    drops to the overflow slot ``E · C`` otherwise."""
    ranks = torch.stack([partition_plan(ids, num_experts).ranks
                         for ids in flat_ids])
    keep = ranks < capacity
    slot = torch.where(keep, flat_ids * capacity + ranks,
                       num_experts * capacity)
    return keep, slot


def apply_moe(params: MoE, x: torch.Tensor, cfg: ModelConfig):
    """x (B, S, D) -> (y, MoEAux). Routing in float32, dispatch per data
    shard (each shard its own capacity C / shards)."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.top_k
    T = B * S
    G = _data_shards()
    if B % G:
        G = 1                       # undivisible batch: global dispatch
    TL = T // G                     # tokens per data shard
    xt = shard(x.reshape(G, TL, D), "batch", None, "embed")

    # --- routing (per shard) ---
    logits = torch.einsum("gtd,de->gte", xt.float(), params.router)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = torch.topk(probs, K, dim=-1)   # (G, TL, K)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)

    # --- prefix-sum partitioning per shard (paper's offsets use case) ---
    flat_ids = expert_ids.reshape(G, TL * K).to(torch.int32)
    C = _capacity(TL, cfg)
    keep, slot = dispatch_slots(flat_ids, E, C)

    # --- scatter tokens into per-shard expert buffers ---
    x_rep = xt.repeat_interleave(K, dim=1)         # (G, TL*K, D)
    buf = xt.new_zeros((G, E * C + 1, D))
    g_idx = torch.arange(G, device=x.device)[:, None]
    buf[g_idx, slot.long()] = x_rep
    buf = shard(buf[:, : E * C].reshape(G, E, C, D),
                "batch", "experts", "capacity", "embed")

    # --- expert FFNs (parallel over shards and experts) ---
    act = activation(cfg.act)
    up = torch.einsum("gecd,edf->gecf", buf, params.w_up)
    if cfg.gated_mlp:
        h = act(torch.einsum("gecd,edf->gecf", buf, params.w_gate)) * up
    else:
        h = act(up)
    h = shard(h, "batch", "experts", "capacity", "mlp")
    out_buf = torch.einsum("gecf,efd->gecd", h, params.w_down)

    # --- gather back + combine with router weights ---
    flat_out = torch.cat([out_buf.reshape(G, E * C, D),
                          out_buf.new_zeros((G, 1, D))], dim=1)
    y_rep = flat_out[g_idx, slot.long()]            # (G, TL*K, D)
    w = gate_vals.reshape(G, TL * K) * keep.float()
    y = (y_rep.float() * w[..., None]).reshape(G, TL, K, D).sum(2)
    y = shard(y.to(x.dtype).reshape(B, S, D), "batch", "seq", "embed")

    # --- aux losses (Switch-style load balance + router z-loss) ---
    frac_tokens = F.one_hot(expert_ids, E).float().mean(dim=(0, 1, 2))
    frac_probs = probs.mean(dim=(0, 1))
    lb = E * (frac_tokens * frac_probs).sum()
    z = torch.logsumexp(logits, dim=-1).square().mean()
    dropped = 1.0 - keep.float().mean()
    return y, MoEAux(lb, z, dropped)
