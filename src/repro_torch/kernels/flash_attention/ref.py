"""Oracles for flash attention.

The PyTorch counterpart of the reference's ``kernels/flash_attention/
ref.py``:

``mha_ref``       — dense softmax attention (ground truth, O(T²) memory).
``blockwise_ref`` — a loop over KV blocks with the online-softmax monoid:
                    autodiff-able, O(T·block) memory; states the kernel's
                    fold structure in plain PyTorch.
``banded_ref``    — sliding-window attention touching only the in-window
                    KV band of each query block.
``split_payload_ref``
                  — the decoupled forward's split pass, densely: each
                    chunk's (m, l, acc) of every row (no counterpart in
                    the reference; the float32 tensor-core forward's
                    chunk payloads are held to it in float64).

Fully-masked rows (q positions past ``kv_len + window``) emit EXACTLY 0
with zero gradients: probabilities are zeroed at masked columns and the
normalizer divide is guarded (``masked_softmax``), the convention every
attention implementation of the port shares with the kernels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.scan.assoc import NEG_INF, _attn_block_logits


def _mask(rows, cols, kv_len, causal, window):
    m = cols < kv_len
    if causal:
        m = m & (cols <= rows)
    if window is not None:
        m = m & (cols > rows - window)
    return m


def masked_softmax(s, mask):
    """The repo-wide zeroed-probability softmax over the last axis.

    Masked logits see ``NEG_INF`` for the row max, masked probabilities
    are EXACTLY 0 (bitwise-neutral for live rows, where the exp already
    underflows to 0), and the guarded divide sends fully-masked rows to
    0 instead of a uniform average.
    """
    s = torch.where(mask, s, NEG_INF)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = torch.sum(p, dim=-1, keepdim=True)
    return p / torch.where(l == 0.0, 1.0, l)


def mha_ref(
    q, k, v, *, group=1, scale, causal=True, window=None, softcap=None,
    kv_len=None,
):
    """Dense attention over (BH, Tq, d) / (BHkv, Tk, d)."""
    _, Tq, _ = q.shape
    _, Tk, _ = k.shape
    kv_len = Tk if kv_len is None else kv_len
    k = torch.repeat_interleave(k, group, dim=0)
    v = torch.repeat_interleave(v, group, dim=0)
    s = torch.einsum("hqd,hkd->hqk", q.float(), k.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    rows = torch.arange(Tq, device=q.device)[:, None]
    cols = torch.arange(Tk, device=q.device)[None, :]
    p = masked_softmax(s, _mask(rows, cols, kv_len, causal, window)[None])
    return torch.einsum("hqk,hkd->hqd", p, v.float()).to(q.dtype)


def blockwise_ref(
    q, k, v, *, group=1, scale, causal=True, window=None, softcap=None,
    kv_len=None, block_k=512,
):
    """Online-softmax attention as an explicit loop over KV blocks (the
    reference's ``lax.scan``)."""
    BH, Tq, d = q.shape
    _, Tk, _ = k.shape
    kv_len = Tk if kv_len is None else kv_len
    if Tk % block_k:
        pad = -Tk % block_k
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
        Tk = Tk + pad
    qf = q.float()
    rows = torch.arange(Tq, device=q.device)[:, None]
    m_prev = torch.full((BH, Tq, 1), NEG_INF, device=q.device)
    l_prev = torch.zeros((BH, Tq, 1), device=q.device)
    acc = torch.zeros((BH, Tq, d), device=q.device)
    for kj in range(Tk // block_k):
        blk = slice(kj * block_k, (kj + 1) * block_k)
        kr = torch.repeat_interleave(k[:, blk], group, dim=0).float()
        vr = torch.repeat_interleave(v[:, blk], group, dim=0).float()
        s = torch.einsum("hqd,hkd->hqk", qf, kr) * scale
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        cols = kj * block_k + torch.arange(block_k, device=q.device)[None, :]
        mask = _mask(rows, cols, kv_len, causal, window)[None]
        s = torch.where(mask, s, NEG_INF)
        m_cur = torch.amax(s, dim=-1, keepdim=True)
        m_new = torch.maximum(m_prev, m_cur)
        alpha = torch.exp(m_prev - m_new)
        p = torch.where(mask, torch.exp(s - m_new), 0.0)
        l_prev = l_prev * alpha + torch.sum(p, dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("hqk,hkd->hqd", p, vr)
        m_prev = m_new
    safe = torch.where(l_prev == 0.0, 1.0, l_prev)
    return (acc / safe).to(q.dtype)


def banded_ref(
    q, k, v, *, scale, window, softcap=None, kv_len=None,
    block_q=512, block_k=512,
):
    """Sliding-window attention touching ONLY the in-window KV band.

    For a local (windowed) layer the live band of a query block is just
    ``window + bq`` wide: each query block attends the ``nband`` KV
    blocks ending at its own, sliced from a front-padded copy (a loop
    over query blocks where the reference has ``lax.scan``). Causality
    is implied (the band ends at the query block's last row).

    LAYOUT: q (B, H, Tq, d), k/v (B, Hkv, Tk, d) — batch and head axes
    stay separate, as in the reference.
    """
    B, H, Tq, d = q.shape
    _, Hkv, Tk, _ = k.shape
    g = H // Hkv
    kv_len = Tk if kv_len is None else kv_len
    bq = bk = min(block_q, block_k)  # equal blocks: static band indexing
    if Tq % bq:
        raise ValueError(f"Tq={Tq} must divide block {bq}")
    nq = Tq // bq
    nband = min((window - 1) // bk + 2, nq)
    L = nband * bk
    front = (nband - 1) * bk
    kp = F.pad(k, (0, 0, front, 0))
    vp = F.pad(v, (0, 0, front, 0))
    outs = []
    for i in range(nq):
        qs = i * bq
        # the band of block i: padded rows [i*bq, i*bq + L), i.e. the
        # original rows [qs + bq - L, qs + bq)
        ki = kp[:, :, qs:qs + L].float()
        vi = vp[:, :, qs:qs + L].float()
        qi = q[:, :, qs:qs + bq].reshape(B, Hkv, g, bq, d).float()
        s = torch.einsum("bhgqd,bhkd->bhgqk", qi, ki) * scale
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        rows = qs + torch.arange(bq, device=q.device)[:, None]
        cols = qs + bq - L + torch.arange(L, device=q.device)[None, :]
        m = ((cols >= 0) & (cols < kv_len) & (cols <= rows)
             & (cols > rows - window))
        p = masked_softmax(s, m)
        out = torch.einsum("bhgqk,bhkd->bhgqd", p, vi)
        outs.append(out.reshape(B, H, bq, d).to(q.dtype))
    return torch.cat(outs, dim=2)


def split_payload_ref(q, k, v, spec, layout):
    """The payload the split pass of the decoupled forward fold publishes
    (``schedules.fold_totals_plain`` of ``spec`` on the ``KVBlocks``
    ``layout``), computed densely in the inputs' dtype: the logits of
    every row against the whole sequence through the spec's own mask
    statement (``_attn_block_logits``), then each chunk's row max m, its
    row sum l of exp(s - m) and its value products acc, masked entries 0.
    q is (BH, Tq, d), k and v (BHkv, Tk, d) with BH = BHkv · group. Returns
    (m, l, acc) shaped as ``layout.chain_shape_for``: float64 inputs give
    the chunks' payloads without the float32 rounding of a product."""
    at = spec.attn
    k, v = (t.repeat_interleave(layout.group, 0) for t in (k, v))
    s, mask = _attn_block_logits(
        q, k, (0, 0, 0), scale=at.scale, causal=at.causal, window=at.window,
        softcap=at.softcap, kv_len=at.kv_len, block_q=layout.tq,
        block_k=layout.tk)
    s = torch.where(mask, s, NEG_INF)
    width = layout.blocks_per_chunk * layout.bk
    leaves = ([], [], [])
    for c in range(layout.splits):
        cols = slice(c * width, (c + 1) * width)
        m = s[..., cols].amax(-1, keepdim=True)
        p = torch.where(mask[..., cols], torch.exp(s[..., cols] - m), 0.0)
        for leaf, x in zip(leaves, (m, p.sum(-1, keepdim=True),
                                    p @ v[:, cols])):
            leaf.append(x)
    return tuple(
        torch.stack(x, 1).view(layout.bh, layout.splits, layout.nq,
                               layout.bq, -1)
        .transpose(1, 2).reshape(layout.chain_shape_for(i))
        for i, x in enumerate(leaves))
