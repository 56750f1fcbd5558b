"""Per-kind residual blocks and their caches.

The PyTorch counterpart of the reference's ``models/blocks.py``. Block
kinds (``ModelConfig.layer_pattern``):

  global       pre-norm GQA attention (full causal) + pre-norm MLP
  local        same with sliding-window attention (+ local rope theta)
  moe          pre-norm attention + pre-norm MoE FFN (scan-offset dispatch)
  mamba        pre-norm Mamba2 (SSD blocked scan)
  mlstm        pre-norm mLSTM block (chunkwise scan, own up/down proj)
  slstm        pre-norm sLSTM + pre-norm gated FFN (pf = 4/3)
  shared_attn  zamba2-style: concat(x, x0) -> per-layer in-proj -> SHARED
               attention+MLP block -> per-layer out-proj, residual to x

Every ``apply_block`` returns ``(x, aux, cache)`` where ``aux`` is a dict
of scalar float32 auxiliaries (the MoE losses; zeros elsewhere).
Attention blocks pass ``attn_impl`` / ``attn_schedule`` down to
``apply_attention`` unchanged.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import xlstm
from repro_torch.models.layers.attention import (Attention, apply_attention,
                                                 init_kv_cache)
from repro_torch.models.layers.common import Weight, compute_dtype, dense_init
from repro_torch.models.layers.mlp import MLP, apply_mlp
from repro_torch.models.layers.moe import MoE, apply_moe
from repro_torch.models.layers.norms import Norm, apply_norm
from repro_torch.models.layers.ssm import SSM, apply_ssm, init_ssm_cache

ATTN_KINDS = ("global", "local", "moe", "shared_attn")


def zero_aux(device="cuda") -> dict:
    z = torch.zeros((), dtype=torch.float32, device=device)
    return {"load_balance_loss": z, "router_z_loss": z,
            "dropped_fraction": z}


class Block(nn.Module):
    """One layer of kind ``kind``: its submodules carry the reference's
    parameter names (``norm1``, ``attn``, ``mlp``, ``ssm``, ...)."""

    def __init__(self, cfg: ModelConfig, kind: str, *, generator=None,
                 device="cuda"):
        super().__init__()
        self.kind = kind
        kw = dict(generator=generator, device=device)
        if kind in ("global", "local", "moe"):
            self.norm1 = Norm(cfg, device=device)
            self.attn = Attention(cfg, **kw)
            self.norm2 = Norm(cfg, device=device)
            if kind == "moe":
                self.moe = MoE(cfg, **kw)
            else:
                self.mlp = MLP(cfg, **kw)
                if cfg.post_block_norm:
                    self.post_norm1 = Norm(cfg, device=device)
                    self.post_norm2 = Norm(cfg, device=device)
        elif kind == "mamba":
            self.norm1 = Norm(cfg, device=device)
            self.ssm = SSM(cfg, **kw)
        elif kind == "mlstm":
            self.norm1 = Norm(cfg, device=device)
            self.mlstm = xlstm.MLSTM(cfg, **kw)
        elif kind == "slstm":
            self.norm1 = Norm(cfg, device=device)
            self.slstm = xlstm.SLSTM(cfg, **kw)
            self.norm2 = Norm(cfg, device=device)
            self.mlp = MLP(cfg, d_ff=4 * cfg.d_model // 3, **kw)
        elif kind == "shared_attn":
            d, dt = cfg.d_model, compute_dtype(cfg)
            self.norm1 = Norm(cfg, 2 * d, device=device)
            self.shared_proj_in = Weight(dense_init((2 * d, d), 2 * d, dt,
                                                    **kw))
            self.shared_proj_out = Weight(dense_init((d, d), d, dt, **kw))
        else:
            raise ValueError(f"unknown block kind {kind!r}")


class SharedBlock(nn.Module):
    """The zamba2 SHARED attention+MLP block (one copy for the model)."""

    def __init__(self, cfg: ModelConfig, *, generator=None, device="cuda"):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.norm1 = Norm(cfg, device=device)
        self.attn = Attention(cfg, **kw)
        self.norm2 = Norm(cfg, device=device)
        self.mlp = MLP(cfg, **kw)


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     *, device="cuda"):
    if kind in ATTN_KINDS:
        window_kind = "local" if kind == "local" else None
        return {"kv": init_kv_cache(cfg, batch, max_len, window_kind,
                                    device=device)}
    if kind == "mamba":
        return {"ssm": init_ssm_cache(cfg, batch, device=device)}
    if kind == "mlstm":
        return {"mlstm": xlstm.init_mlstm_cache(cfg, batch, device=device)}
    if kind == "slstm":
        return {"slstm": xlstm.init_slstm_cache(cfg, batch, device=device)}
    raise ValueError(f"unknown block kind {kind!r}")


def _attn_mlp_core(params, x, cfg, *, kind, positions, cache, cache_len,
                   attn_impl, ffn, attn_schedule="auto"):
    """Shared wiring for attention blocks; ``ffn`` runs the second half."""
    post = cfg.post_block_norm
    h = apply_norm(params.norm1, x, cfg)
    attn_out, new_kv = apply_attention(
        params.attn, h, cfg, kind=("local" if kind == "local" else "global"),
        positions=positions, cache=None if cache is None else cache["kv"],
        cache_len=cache_len, impl=attn_impl, schedule=attn_schedule)
    if post:
        attn_out = apply_norm(params.post_norm1, attn_out, cfg)
    x = x + attn_out
    h = apply_norm(params.norm2, x, cfg)
    ffn_out, aux = ffn(h)
    if post:
        ffn_out = apply_norm(params.post_norm2, ffn_out, cfg)
    x = x + ffn_out
    new_cache = None if cache is None else {"kv": new_kv}
    return x, aux, new_cache


def apply_block(
    params: Block,
    x,
    cfg: ModelConfig,
    kind: str,
    *,
    shared: Optional[SharedBlock] = None,
    x0=None,
    positions=None,
    cache: Optional[dict] = None,
    cache_len=None,
    attn_impl: Optional[str] = None,
    attn_schedule: str = "auto",
    ssm_impl: Optional[str] = None,
):
    zero = lambda: zero_aux(x.device)  # noqa: E731
    if kind in ("global", "local"):
        return _attn_mlp_core(
            params, x, cfg, kind=kind, positions=positions, cache=cache,
            cache_len=cache_len, attn_impl=attn_impl,
            attn_schedule=attn_schedule,
            ffn=lambda h: (apply_mlp(params.mlp, h, cfg), zero()))

    if kind == "moe":
        def ffn(h):
            y, moe_aux = apply_moe(params.moe, h, cfg)
            return y, dict(load_balance_loss=moe_aux.load_balance_loss,
                           router_z_loss=moe_aux.router_z_loss,
                           dropped_fraction=moe_aux.dropped_fraction)
        return _attn_mlp_core(
            params, x, cfg, kind=kind, positions=positions, cache=cache,
            cache_len=cache_len, attn_impl=attn_impl,
            attn_schedule=attn_schedule, ffn=ffn)

    if kind == "mamba":
        h = apply_norm(params.norm1, x, cfg)
        y, new_ssm = apply_ssm(
            params.ssm, h, cfg, cache=None if cache is None else cache["ssm"],
            impl=ssm_impl or "auto")
        new_cache = None if cache is None else {"ssm": new_ssm}
        return x + y, zero(), new_cache

    if kind == "mlstm":
        h = apply_norm(params.norm1, x, cfg)
        y, new_m = xlstm.apply_mlstm(
            params.mlstm, h, cfg,
            cache=None if cache is None else cache["mlstm"])
        new_cache = None if cache is None else {"mlstm": new_m}
        return x + y, zero(), new_cache

    if kind == "slstm":
        h = apply_norm(params.norm1, x, cfg)
        y, new_s = xlstm.apply_slstm(
            params.slstm, h, cfg,
            cache=None if cache is None else cache["slstm"])
        x = x + y
        h = apply_norm(params.norm2, x, cfg)
        x = x + apply_mlp(params.mlp, h, cfg)
        new_cache = None if cache is None else {"slstm": new_s}
        return x, zero(), new_cache

    if kind == "shared_attn":
        if shared is None or x0 is None:
            raise ValueError("a shared_attn block needs the shared block "
                             "and the embeddings x0")
        cat = torch.cat([x, x0], dim=-1)
        h = apply_norm(params.norm1, cat, cfg)
        h = h @ params.shared_proj_in.w
        h, aux, new_cache = _attn_mlp_core(
            shared, h, cfg, kind="global", positions=positions, cache=cache,
            cache_len=cache_len, attn_impl=attn_impl,
            attn_schedule=attn_schedule,
            ffn=lambda hh: (apply_mlp(shared.mlp, hh, cfg), zero()))
        y = h @ params.shared_proj_out.w
        return x + y, aux, new_cache

    raise ValueError(f"unknown block kind {kind!r}")
