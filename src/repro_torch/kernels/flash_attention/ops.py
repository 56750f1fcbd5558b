"""Public wrapper for engine-backed flash attention.

The PyTorch counterpart of the reference's ``kernels/flash_attention/
ops.py``. Accepts standard (B, H, T, D) layouts, handles GQA head
mapping, pads sequence lengths to block multiples (mask-correct via
``kv_len``) and resolves ``schedule="auto"`` through
``policy.choose_attention_schedule`` (carry for row-saturated shapes,
split-KV decoupled for long-KV decode/scoring), with the card's SM count
as its core count on CUDA.

``flash_attention`` is differentiable through a ``torch.autograd.
Function``: when a gradient is needed the forward reruns the fold with
``return_stats=True`` to save the ``(m, l)`` row statistics, and the
backward derives ``delta = rowsum(dO ⊙ O)`` in f32 and runs the two
backward engine folds (dq over KV blocks, dk/dv over the transposed
q-major layout) under the SAME resolved schedule and causal-aware KV
bounds as the forward.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.scan import policy
from repro_torch.core.scan.assoc import NEG_INF
from repro_torch.kernels.flash_attention.flash_attention import (
    default_kv_split_target, flash_attention_bwd_kernel,
    flash_attention_kernel)

SCHEDULES = ("carry", "decoupled")
RESOLVABLE = SCHEDULES + ("auto",)


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _tiles(Tq: int, Tk: int, block_q: int, block_k: int):
    """The (bq, bk, nq) tiling the kernel will ACTUALLY use — the single
    source of truth shared by the impl and the schedule resolver, so the
    policy's chunks-per-core test never drifts from the real grid."""
    bq = min(block_q, _round_up(Tq, 8))
    bk = min(block_k, _round_up(Tk, 128))
    return bq, bk, max(-(-Tq // bq), 1)


def _decoupled_padding(Tk: int, bk: int, kv_splits: "int | None"):
    """(pad_k, splits) for the split-KV fold: pad the KV axis up to a
    multiple of ``splits`` blocks so the chunk count is always achieved.
    Without this, a prime block count (500k context -> 3907 blocks) has
    no divisor <= target and the split-KV launch would degenerate to one
    serial chunk; the masked tail (``kv_len``) makes identity padding
    free."""
    nk = _round_up(Tk, bk) // bk
    target = kv_splits if kv_splits is not None \
        else default_kv_split_target()
    splits = max(1, min(int(target), nk))
    return _round_up(nk, splits) * bk - Tk, splits


class FlashConfig(NamedTuple):
    """Static configuration shared by the forward and backward of the
    autograd function (``schedule`` arrives RESOLVED)."""

    scale: float
    causal: bool
    window: Optional[int]
    softcap: Optional[float]
    block_q: int
    block_k: int
    schedule: str
    kv_splits: Optional[int]
    use_kv_bounds: bool


def _padding(Tq: int, Tk: int, cfg: FlashConfig):
    """(bq, bk, pad_q, pad_k, kv_splits) for this shape and schedule."""
    bq, bk, _ = _tiles(Tq, Tk, cfg.block_q, cfg.block_k)
    pad_q = (-Tq) % bq
    if cfg.schedule == "decoupled":
        pad_k, kv_splits = _decoupled_padding(Tk, bk, cfg.kv_splits)
    else:
        pad_k, kv_splits = (-Tk) % bk, cfg.kv_splits
    return bq, bk, pad_q, pad_k, kv_splits


def _flatten_pad(q, k, v, pad_q, pad_k):
    B, Hq, Tq, D = q.shape
    _, Hkv, Tk, _ = k.shape
    qf = q.reshape(B * Hq, Tq, D)
    kf = k.reshape(B * Hkv, Tk, D)
    vf = v.reshape(B * Hkv, Tk, D)
    if pad_q:
        qf = F.pad(qf, (0, 0, 0, pad_q))
    if pad_k:
        kf = F.pad(kf, (0, 0, 0, pad_k))
        vf = F.pad(vf, (0, 0, 0, pad_k))
    return qf.contiguous(), kf.contiguous(), vf.contiguous()


def kernel_inputs(q, k, v, cfg: FlashConfig):
    """``((qf, kf, vf), keywords)``: the flattened, padded (B·H, T, D)
    operands and the ``flash_attention_kernel`` /
    ``flash_attention_bwd_kernel`` keywords of a (B, H, T, D) call under
    ``cfg``: the tiling, padding and split count that ``flash_attention``
    runs."""
    _, Hq, Tq, _ = q.shape
    _, Hkv, Tk, _ = k.shape
    bq, bk, pad_q, pad_k, kv_splits = _padding(Tq, Tk, cfg)
    return _flatten_pad(q, k, v, pad_q, pad_k), dict(
        group=Hq // Hkv, scale=cfg.scale, causal=cfg.causal,
        window=cfg.window, softcap=cfg.softcap, kv_len=Tk, block_q=bq,
        block_k=bk, schedule=cfg.schedule, kv_splits=kv_splits,
        use_kv_bounds=cfg.use_kv_bounds)


def _impl(q, k, v, cfg: FlashConfig):
    B, Hq, Tq, D = q.shape
    ops, kw = kernel_inputs(q, k, v, cfg)
    out = flash_attention_kernel(*ops, **kw)
    return out[:, :Tq].reshape(B, Hq, Tq, D)


def _impl_stats(q, k, v, cfg: FlashConfig):
    B, Hq, Tq, D = q.shape
    ops, kw = kernel_inputs(q, k, v, cfg)
    out, m, l = flash_attention_kernel(*ops, return_stats=True, **kw)
    return (out[:, :Tq].reshape(B, Hq, Tq, D),
            m[:, :Tq].reshape(B, Hq, Tq, 1),
            l[:, :Tq].reshape(B, Hq, Tq, 1))


def _impl_bwd(q, k, v, out, m, l, g, cfg: FlashConfig):
    B, Hq, Tq, D = q.shape
    _, Hkv, Tk, _ = k.shape
    (qf, kf, vf), kw = kernel_inputs(q, k, v, cfg)
    pad_q = qf.shape[1] - Tq
    # The small precompute fold: delta = rowsum(dO ⊙ O), one f32 scalar
    # per query row — the shared term of the softmax VJP.
    delta = torch.sum(g.float() * out.float(), dim=-1, keepdim=True)

    def qrow(x, fill):
        x = x.reshape(B * Hq, Tq, x.shape[-1])
        if pad_q:
            x = F.pad(x, (0, 0, 0, pad_q), value=fill)
        return x.contiguous()

    # Padded q rows carry dO = 0 and delta = 0, so every term they feed
    # vanishes — PROVIDED their recomputed p is finite: m pads to +1e30
    # (not the NEG_INF identity, under which exp(s - m) on the padded
    # rows' causally-live columns would overflow to inf and poison the
    # dk/dv sums with inf·0 NaNs), making p underflow to exactly 0.
    dq, dk, dv = flash_attention_bwd_kernel(
        qf, kf, vf, qrow(g, 0), qrow(m, -NEG_INF), qrow(l, 0),
        qrow(delta, 0), **kw)
    return (dq[:, :Tq].reshape(B, Hq, Tq, D).to(q.dtype),
            dk[:, :Tk].reshape(B, Hkv, Tk, D).to(k.dtype),
            dv[:, :Tk].reshape(B, Hkv, Tk, D).to(v.dtype))


class _FlashAttention(torch.autograd.Function):
    """Forward with the (m, l) statistics; backward as the two engine
    folds, under the forward's resolved schedule and bounds."""

    @staticmethod
    def forward(ctx, q, k, v, cfg):
        out, m, l = _impl_stats(q, k, v, cfg)
        ctx.save_for_backward(q, k, v, out, m, l)
        ctx.cfg = cfg
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, m, l = ctx.saved_tensors
        dq, dk, dv = _impl_bwd(q, k, v, out, m, l, g, ctx.cfg)
        return dq, dk, dv, None


def resolved_attention_schedule(
    q_shape, kv_len: int, block_q: int = 128, block_k: int = 128,
    schedule: str = "auto", cores: int = policy.NUM_CORES,
) -> str:
    """The fold schedule a (B, H, Tq, D) attention will actually run.

    Mirrors ``flash_attention``'s tiling: the carry grid parallelizes
    (B·H, q-blocks) rows, so the policy's batch is the number of
    independent fold chains and its chunk length the real KV block.
    ``cores``: the SMs (or CPU cores) a launch spreads over. The
    backward folds inherit the forward's resolution.
    """
    if schedule not in RESOLVABLE:
        raise ValueError(
            f"unknown attention schedule {schedule!r}; one of {RESOLVABLE}")
    if schedule != "auto":
        return schedule
    B, Hq, Tq, _ = q_shape
    _, bk, nq = _tiles(Tq, kv_len, block_q, block_k)
    return policy.choose_attention_schedule(
        B * Hq * nq, kv_len, cores=cores, block_elems=bk)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: "float | None" = None,
    causal: bool = True,
    window: "int | None" = None,
    softcap: "float | None" = None,
    block_q: int = 128,
    block_k: int = 128,
    schedule: str = "auto",
    kv_splits: "int | None" = None,
    use_kv_bounds: bool = True,
) -> torch.Tensor:
    """Flash attention over (B, H, T, D) tensors with GQA kv heads, on
    the tensors' device.

    ``schedule`` picks the fold organization (carry|decoupled|auto — see
    ``core/scan/policy.choose_attention_schedule``, with the card's SM
    count as its cores on CUDA). Differentiable: ``torch.autograd`` runs
    the flash backward as engine folds (same schedule, same KV bounds).
    ``use_kv_bounds=False`` disables the causal-aware cell skipping
    (bitwise-identical results either way — the knob exists for the
    parity tests and for hardware A/B measurement).
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    schedule = resolved_attention_schedule(
        q.shape, k.shape[2], block_q, block_k, schedule, policy.cores_of(q))
    cfg = FlashConfig(
        scale=float(scale), causal=causal, window=window, softcap=softcap,
        block_q=block_q, block_k=block_k, schedule=schedule,
        kv_splits=kv_splits, use_kv_bounds=use_kv_bounds)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, cfg)
    return _impl(q, k, v, cfg)
