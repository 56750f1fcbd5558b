"""Attention: GQA + RoPE + sliding windows + softcap + qk-norm + KV cache.

The PyTorch counterpart of the reference's ``models/layers/attention.py``,
with every route it has: dense, blockwise (the online-softmax loop),
banded (a local layer's in-window band) and flash (the scan engine's
softmax-pair fold: ``kernels.flash_attention``, the CUDA fold kernels for
CUDA tensors and their plain versions on the CPU); the local layers' ring
buffer; the full-cache and padded-cache flash prefills; the per-row
``cache_len`` append; the paged gather and scatter (``serve.paging``);
and cross-attention.

All routes share the zeroed-probability masking convention: a fully
masked row emits exactly 0 (``kernels.flash_attention.ref``). That is
what keeps paged decode bitwise equal to the contiguous cache: dead
positions of a gathered view hold finite null-page data whose
probabilities are exactly 0.

Where the reference decides on a traced ``cache_len`` with
``jax.lax.cond`` (the padded-cache flash prefill runs only from an empty
cache), the port tests ``cache_len`` on the host, with the same meaning.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.dist import shard
from repro_torch.kernels.flash_attention import (banded_ref, blockwise_ref,
                                                 flash_attention,
                                                 masked_softmax)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers.common import compute_dtype, const, dense_init
from repro_torch.models.layers.norms import rms_norm_headwise
from repro_torch.models.layers.rope import apply_rope


class Attention(nn.Module):
    """``wq`` (D, H·hd), ``wk`` / ``wv`` (D, Hkv·hd), ``wo`` (H·hd, D) and,
    with qk-norm, float32 ``q_norm`` / ``k_norm`` (hd,)."""

    def __init__(self, cfg: ModelConfig, *, generator=None, device="cuda"):
        super().__init__()
        self.cfg = cfg
        dt = compute_dtype(cfg)
        d, h, hk, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
            cfg.head_dim
        kw = dict(generator=generator, device=device)
        self.wq = dense_init((d, h * hd), d, dt, **kw)
        self.wk = dense_init((d, hk * hd), d, dt, **kw)
        self.wv = dense_init((d, hk * hd), d, dt, **kw)
        self.wo = dense_init((h * hd, d), h * hd, dt, **kw)
        if cfg.qk_norm:
            self.q_norm = const(1.0, (hd,), device)
            self.k_norm = const(1.0, (hd,), device)

    def forward(self, x, **kw):
        return apply_attention(self, x, self.cfg, **kw)


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  window_kind: "str | None" = None, *, device="cuda"):
    """Empty cache for one attention layer. Local (sliding-window) layers
    allocate only ``window`` slots."""
    dt = compute_dtype(cfg)
    slots = max_len
    if window_kind == "local" and cfg.sliding_window:
        slots = min(max_len, cfg.sliding_window)
    shape = (batch, cfg.num_kv_heads, slots, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def _project(params, x, cfg: ModelConfig):
    B, S, _ = x.shape
    h, hk, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ params.wq).reshape(B, S, h, hd)
    k = (x @ params.wk).reshape(B, S, hk, hd)
    v = (x @ params.wv).reshape(B, S, hk, hd)
    if cfg.qk_norm:
        q = rms_norm_headwise(params.q_norm, q, cfg.norm_eps)
        k = rms_norm_headwise(params.k_norm, k, cfg.norm_eps)
    return q, k, v


def _theta(cfg: ModelConfig, kind: str) -> float:
    if kind == "local" and cfg.rope_theta_local is not None:
        return cfg.rope_theta_local
    return cfg.rope_theta


def _dense_attn(q, k, v, *, scale, causal, window, softcap, q_pos, k_pos,
                kv_len):
    """q (B,H,Sq,hd), k/v (B,Hkv,Sk,hd); GQA via head reshape.

    ``q_pos`` (Sq,) or (B,Sq), ``k_pos`` (Sk,) or (B,Sk), ``kv_len``
    scalar or (B,): per-row positions and extents mask co-resident
    sequences of different lengths independently.
    """
    B, H, Sq, hd = q.shape
    Hkv = k.shape[1]
    g = H // Hkv
    qf = q.reshape(B, Hkv, g, Sq, hd).float()
    s = torch.einsum("bkgqd,bksd->bkgqs", qf, k.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    dev = q.device
    q_pos = torch.as_tensor(q_pos, device=dev)
    k_pos = torch.as_tensor(k_pos, device=dev)
    kv_len = torch.as_tensor(kv_len, device=dev)
    qp = q_pos if q_pos.ndim == 2 else q_pos[None]        # (B|1, Sq)
    kp = k_pos if k_pos.ndim == 2 else k_pos[None]        # (B|1, Sk)
    kv = kv_len.reshape(-1, 1, 1)                         # (B|1, 1, 1)
    mask = (kp[:, None, :] < kv) & (kp[:, None, :] >= 0)
    if causal:
        mask = mask & (kp[:, None, :] <= qp[:, :, None])
    if window is not None:
        mask = mask & (kp[:, None, :] > qp[:, :, None] - window)
    p = masked_softmax(s, mask[:, None, None])
    out = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    return out.reshape(B, H, Sq, hd).to(q.dtype)


def _write_rows(cache, new, write_at):
    """``cache`` (B, Hkv, slots, hd) with each row's ``new`` (B, Hkv, S, hd)
    written from its ``write_at`` (B,) on (a start clamped so the segment
    fits, as ``dynamic_update_slice`` clamps it)."""
    B, _, slots, _ = cache.shape
    S = new.shape[2]
    start = write_at.clamp(0, slots - S)
    pos = start[:, None] + torch.arange(S, device=cache.device)[None]
    rows = torch.arange(B, device=cache.device)[:, None]
    out = cache.clone()
    out[rows, :, pos] = new.transpose(1, 2).to(cache.dtype)
    return out


def apply_attention(
    params,
    x,
    cfg: ModelConfig,
    *,
    kind: str = "global",
    positions: Optional[torch.Tensor] = None,
    cache: Optional[dict] = None,
    cache_len=None,
    impl: Optional[str] = None,
    schedule: str = "auto",
    causal: bool = True,
):
    """Self-attention over (B, S, D).

    Training/prefill: ``cache=None``; decode: pass the layer cache and the
    number of valid entries ``cache_len`` (an int, a 0-d tensor or a (B,)
    tensor of per-row lengths) — new K/V are written at ``cache_len``
    (modulo window for local layers) and attention spans the cache.
    Returns (out, new_cache). ``schedule`` picks the flash-engine fold
    organization when the flash route runs (carry|decoupled|auto).
    """
    B, S, _ = x.shape
    dev = x.device
    window = cfg.sliding_window if kind == "local" else None
    scale = cfg.query_scale if cfg.query_scale is not None \
        else cfg.head_dim ** -0.5
    if positions is None:
        positions = torch.arange(S, device=dev)
    positions = torch.as_tensor(positions, device=dev)
    # Per-row positions (B, S): lift to (B, 1, S) so the angle table
    # broadcasts over heads; 1-D positions keep the original shapes.
    rope_pos = positions[:, None, :] if positions.ndim == 2 else positions

    q, k, v = _project(params, x, cfg)
    theta = _theta(cfg, kind)
    q = apply_rope(q.transpose(1, 2), rope_pos, theta).transpose(1, 2)
    k = apply_rope(k.transpose(1, 2), rope_pos, theta).transpose(1, 2)
    q = shard(q, "batch", "seq", "heads", None)
    k = shard(k, "batch", "seq", "kv_heads", None)
    v = shard(v, "batch", "seq", "kv_heads", None)
    qh = q.transpose(1, 2)  # (B, H, S, hd)
    kh = k.transpose(1, 2)
    vh = v.transpose(1, 2)

    paged_pools = None
    if cache is not None and "k_pages" in cache:
        # Paged KV (serve/paging.py): the layer cache is a page POOL plus
        # a per-row page table. Gather the per-row contiguous view and run
        # the append path on it — the gathered live positions hold exactly
        # the contiguous layout's values and the dead ones finite null-page
        # data that the zeroed-probability mask turns into exact-zero
        # contributions, so decode stays BITWISE identical to the
        # contiguous cache. The written token is scattered back after.
        from repro_torch.serve import paging as _paging
        if S != 1:
            raise ValueError(
                f"paged KV cache supports single-token decode only "
                f"(prefill stages contiguously); got S={S}")
        pt_full = cache["pt"]
        ps = cache["k_pages"].shape[2]
        pt = pt_full
        if window is not None:
            # A windowed layer's ring rides the FIRST ring // ps entries
            # of the shared page-table row (ring slot s lives in logical
            # page s // ps), so the clamped gather reproduces the
            # contiguous ring buffer exactly.
            ring = min(int(window), pt_full.shape[1] * ps)
            pt = pt_full[:, : ring // ps]
        paged_pools = (cache["k_pages"], cache["v_pages"], pt_full, pt,
                       _paging)
        cache = {
            "k": _paging.gather_pages(cache["k_pages"], pt),
            "v": _paging.gather_pages(cache["v_pages"], pt),
        }

    new_cache = cache
    if cache is not None and window is not None and S >= cache["k"].shape[2]:
        # Prefill covering the whole ring (S >= window slots): attention
        # from the in-segment keys directly (window-masked), and the ring
        # refilled with the last `slots` keys. Valid only from an empty
        # cache (the serve engine prefills so).
        slots = cache["k"].shape[2]
        if window < S and S % min(512, S) == 0:
            # banded: only the in-window KV band of each query block (the
            # reference first repeats K/V to full heads for its tensor
            # sharding; banded_ref maps the query heads' groups itself)
            out = banded_ref(
                qh, kh, vh, scale=scale, window=window,
                softcap=cfg.attn_softcap, block_q=min(512, S),
                block_k=min(512, S))
        else:
            out = _dense_attn(
                qh, kh, vh, scale=scale, causal=causal, window=window,
                softcap=cfg.attn_softcap, q_pos=positions, k_pos=positions,
                kv_len=positions[-1] + 1,
            )
        roll = (torch.as_tensor(cache_len, device=dev) + S) % slots
        ktail = kh[:, :, -slots:]
        vtail = vh[:, :, -slots:]
        idx = (torch.arange(slots, device=dev) - roll) % slots
        new_cache = {"k": ktail[:, :, idx], "v": vtail[:, :, idx]}
    elif (cache is not None and window is None and S == cache["k"].shape[2]
          and S > 4096):
        # Full-cache prefill of a GLOBAL layer at long S: the online-softmax
        # fold, and the cache written directly. ``impl="flash"`` lands on
        # the scan-engine kernel; otherwise the blockwise loop.
        H, Hkv = cfg.num_heads, cfg.num_kv_heads
        if impl == "flash":
            out = flash_attention(
                qh, kh, vh, scale=scale, causal=causal,
                softcap=cfg.attn_softcap, schedule=schedule)
        else:
            out = blockwise_ref(
                qh.reshape(B * H, S, cfg.head_dim),
                kh.reshape(B * Hkv, S, cfg.head_dim),
                vh.reshape(B * Hkv, S, cfg.head_dim),
                group=H // Hkv, scale=scale, causal=causal,
                softcap=cfg.attn_softcap, block_k=1024,
            ).reshape(B, H, S, cfg.head_dim)
        new_cache = {"k": kh, "v": vh}
    elif cache is not None:
        slots = cache["k"].shape[2]
        cache_len = torch.as_tensor(cache_len, device=dev)
        per_row = cache_len.ndim == 1                  # (B,) lengths
        # Ring-buffer write for windowed layers, append otherwise; with
        # per-row lengths each row writes at ITS own position and masks
        # against ITS own extent.
        write_at = (cache_len % slots) if window is not None else cache_len
        rows_at = write_at if per_row else write_at.expand(B)
        kc = _write_rows(cache["k"], kh, rows_at)
        vc = _write_rows(cache["v"], vh, rows_at)
        new_cache = {"k": kc, "v": vc}
        k_slot = torch.arange(slots, device=dev)
        if window is not None:
            # absolute positions of the ring slots
            total = cache_len + S
            if per_row:
                wrap = (k_slot[None] - (total[:, None] % slots)) % slots
                k_pos = total[:, None] - slots + wrap       # (B, slots)
            else:
                wrap = (k_slot - (total % slots)) % slots
                k_pos = total - slots + wrap
        else:
            k_pos = k_slot

        if (impl == "flash" and window is None and S > 1
                and int(cache_len) == 0):
            # Prefill of a GLOBAL layer into a PADDED cache from an EMPTY
            # cache: attend the S live keys directly on the engine fold
            # (dead slots are never read). A mid-stream call keeps the
            # dense path's cached keys.
            out = flash_attention(
                qh, kh, vh, scale=scale, causal=causal,
                softcap=cfg.attn_softcap, schedule=schedule)
        else:
            out = _dense_attn(
                qh, kc, vc, scale=scale, causal=causal, window=window,
                softcap=cfg.attn_softcap, q_pos=positions,
                k_pos=k_pos, kv_len=cache_len + S,
            )
        if paged_pools is not None:
            # The gathered view was a scratch copy: persist only the newly
            # written token into its page, through the (possibly
            # ring-clamped) table; inactive rows land in the null page.
            pool_k, pool_v, pt_full, pt, _paging = paged_pools
            new_cache = {
                "k_pages": _paging.scatter_token(
                    pool_k, kh[:, :, 0, :], pt, rows_at),
                "v_pages": _paging.scatter_token(
                    pool_v, vh[:, :, 0, :], pt, rows_at),
                "pt": pt_full,
            }
    else:
        if impl is None:
            if window is not None and window < S:
                impl = "banded"
            else:
                impl = "dense" if S <= 2048 else "blockwise"
        if impl == "banded":
            out = banded_ref(
                qh, kh, vh, scale=scale, window=window,
                softcap=cfg.attn_softcap, block_q=min(512, S),
                block_k=min(512, S),
            )
        elif impl == "dense":
            out = _dense_attn(
                qh, kh, vh, scale=scale, causal=causal, window=window,
                softcap=cfg.attn_softcap, q_pos=positions,
                k_pos=positions, kv_len=positions[-1] + 1,
            )
        elif impl == "blockwise":
            H, Hkv = cfg.num_heads, cfg.num_kv_heads
            out = blockwise_ref(
                qh.reshape(B * H, S, cfg.head_dim),
                kh.reshape(B * Hkv, S, cfg.head_dim),
                vh.reshape(B * Hkv, S, cfg.head_dim),
                group=H // Hkv, scale=scale, causal=causal, window=window,
                softcap=cfg.attn_softcap, block_k=1024,
            ).reshape(B, H, S, cfg.head_dim)
        elif impl == "flash":
            out = flash_attention(
                qh, kh, vh, scale=scale, causal=causal, window=window,
                softcap=cfg.attn_softcap, schedule=schedule,
            )
        else:
            raise ValueError(f"unknown attention impl {impl!r}")

    out = out.transpose(1, 2).reshape(B, S, cfg.num_heads * cfg.head_dim)
    y = out @ params.wo
    return shard(y, "batch", "seq", "embed"), new_cache


# --- cross attention (seamless decoder) -----------------------------------


def apply_cross_attention(params, x, memory, cfg: ModelConfig):
    """x (B,S,D) attends into encoder memory (B,Sm,D); not causal, no rope.
    ``params`` is an ``Attention``."""
    B, S, _ = x.shape
    Sm = memory.shape[1]
    h, hk, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ params.wq).reshape(B, S, h, hd)
    k = (memory @ params.wk).reshape(B, Sm, hk, hd)
    v = (memory @ params.wv).reshape(B, Sm, hk, hd)
    if cfg.qk_norm:
        q = rms_norm_headwise(params.q_norm, q, cfg.norm_eps)
        k = rms_norm_headwise(params.k_norm, k, cfg.norm_eps)
    scale = cfg.query_scale if cfg.query_scale is not None else hd ** -0.5
    dev = x.device
    out = _dense_attn(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        scale=scale, causal=False, window=None, softcap=cfg.attn_softcap,
        q_pos=torch.arange(S, device=dev), k_pos=torch.arange(Sm, device=dev),
        kv_len=Sm,
    )
    out = out.transpose(1, 2).reshape(B, S, h * hd)
    y = out @ params.wo
    return shard(y, "batch", "seq", "embed")
