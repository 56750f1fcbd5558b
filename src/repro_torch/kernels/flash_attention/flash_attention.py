"""Flash attention = the SOFTMAX_PAIR registration of the scan engine.

The PyTorch counterpart of the reference's ``kernels/flash_attention/
flash_attention.py``. The KV-block loop of flash attention is an
inclusive FOLD over KV blocks of the monoid
``(m, s) ⊕ (m', s') = (max(m,m'), s·e^{m-max} + s'·e^{m'-max})`` with the
weighted-value accumulator carried alongside. This module is the
registration: it states the attention GEOMETRY (``scan_engine.KVBlocks``
— GQA head grouping, per-leaf payload dims) and the OPERATOR
(``assoc.softmax_pair_kernel_spec`` — the q·kᵀ input transform with
causal/window/softcap/length masking, the payload combine, the ``acc/l``
finalize); the engine's fold schedules run it on the tensors' device
(the CUDA kernels of ``csrc/attn_fold.cu`` for CUDA tensors, their plain
versions on the CPU):

  ``schedule="carry"``      the classic flash forward — KV sequential,
                            the payload carried on chip.
  ``schedule="decoupled"``  split-KV / flash-decoding — KV chunks
                            parallel, partial payloads combined by a
                            chain kernel (long-KV decode/scoring).

The backward runs as two more engine folds: dq over ``KVBlocks`` and
dk/dv over the transposed ``QBlocks``, against the backward specs in
``assoc`` (recomputed logits, no materialized attention matrix). Both
directions honor the causal-aware KV extent (``use_kv_bounds``): cells
that are provably fully masked are skipped, bitwise-free.
"""

from __future__ import annotations

import torch

from repro_torch.core.scan import policy
from repro_torch.core.scan.assoc import (NEG_INF,
                                         softmax_pair_bwd_dkv_kernel_spec,
                                         softmax_pair_bwd_dq_kernel_spec,
                                         softmax_pair_kernel_spec)
from repro_torch.kernels import scan_engine

__all__ = ["NEG_INF", "default_kv_split_target", "flash_attention_bwd_kernel",
           "flash_attention_kernel", "pick_kv_splits"]


def default_kv_split_target() -> int:
    """Default split-KV chunk-count target: 2 · ``policy.NUM_CORES`` =
    16, the reference's value, on every device (on an H100 16 chunks of
    each (head, q-block) row already give thousands of blocks at decode
    shapes). Single source of truth for ``pick_kv_splits`` and the ops
    wrapper's KV padding."""
    return 2 * policy.NUM_CORES


def pick_kv_splits(num_k_blocks: int, target: "int | None" = None) -> int:
    """KV chunk count for the decoupled fold: the largest divisor of the
    block count not exceeding ``target`` (default
    ``default_kv_split_target()``).

    Degenerates toward 1 when the block count has no small divisor
    (prime counts) — the public ``ops`` wrapper avoids that by padding
    the KV axis to a multiple of the target chunk count (the masked tail
    makes the padding free)."""
    if target is None:
        target = default_kv_split_target()
    target = max(1, min(int(target), num_k_blocks))
    for splits in range(target, 0, -1):
        if num_k_blocks % splits == 0:
            return splits
    return 1


def _check_shapes(q, k, v, group, block_q, block_k):
    BH, Tq, d = q.shape
    BHkv, Tk, dk = k.shape
    if d != dk or v.shape != k.shape or BH != BHkv * group:
        raise ValueError(
            f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} "
            f"do not fit group={group}")
    if Tq % block_q or Tk % block_k:
        raise ValueError(f"({Tq},{Tk}) not divisible by ({block_q},{block_k})")
    return BH, BHkv, Tq, Tk, d


def _block_map(kv_block_map, k):
    if kv_block_map is None:
        return None
    return torch.as_tensor(kv_block_map, dtype=torch.int32, device=k.device)


def forward_fold(
    q_shape, k_shape, *, group: int = 1, scale: float, causal: bool = True,
    window: "int | None" = None, softcap: "float | None" = None,
    kv_len: "int | None" = None, block_q: int = 128, block_k: int = 128,
    schedule: str = "carry", kv_splits: "int | None" = None,
    return_stats: bool = False, use_kv_bounds: bool = True,
    kv_block_map=None,
):
    """``(spec, layout)`` of the forward fold that ``flash_attention_kernel``
    runs for (BH, Tq, d) queries against (BHkv, Tk, d) keys, with the same
    keywords; ``kv_block_map`` as an int tensor (or None)."""
    BH, Tq, d = q_shape
    BHkv, Tk, _ = k_shape
    kv_len = Tk if kv_len is None else kv_len
    splits = 1
    if schedule != "carry":
        splits = pick_kv_splits(Tk // block_k, kv_splits)
    layout = scan_engine.KVBlocks(
        bh=BH, bh_kv=BHkv, tq=Tq, tk=Tk, d=d, bq=block_q, bk=block_k,
        group=group, splits=splits, leaf_dims=(1, 1, d),
        out_dims=(d, 1, 1) if return_stats else (d,),
        kv_bounds=(causal, window, kv_len) if use_kv_bounds else None,
        kv_block_map=kv_block_map)
    spec = softmax_pair_kernel_spec(
        scale=scale, causal=causal, window=window, softcap=softcap,
        kv_len=kv_len, block_q=block_q, block_k=block_k,
        with_stats=return_stats)
    return spec, layout


def backward_folds(
    q_shape, k_shape, *, group: int = 1, scale: float, causal: bool = True,
    window: "int | None" = None, softcap: "float | None" = None,
    kv_len: "int | None" = None, block_q: int = 128, block_k: int = 128,
    schedule: str = "carry", kv_splits: "int | None" = None,
    use_kv_bounds: bool = True,
):
    """``((dq spec, layout), (dkv spec, layout))``: the two folds that
    ``flash_attention_bwd_kernel`` runs, with the same keywords."""
    BH, Tq, d = q_shape
    BHkv, Tk, _ = k_shape
    kv_len = Tk if kv_len is None else kv_len
    bounds = (causal, window, kv_len) if use_kv_bounds else None
    mask_cfg = dict(scale=scale, causal=causal, window=window,
                    softcap=softcap, kv_len=kv_len, block_q=block_q,
                    block_k=block_k)
    geo = dict(bh=BH, bh_kv=BHkv, tq=Tq, tk=Tk, d=d, bq=block_q, bk=block_k,
               group=group, kv_bounds=bounds)
    dq_splits = dkv_splits = 1
    if schedule != "carry":
        dq_splits = pick_kv_splits(Tk // block_k, kv_splits)
        dkv_splits = pick_kv_splits(group * (Tq // block_q), kv_splits)
    dq_layout = scan_engine.KVBlocks(
        splits=dq_splits, leaf_dims=(d,), out_dims=(d,),
        op_kinds=("q", "kv", "kv", "q", "qstat", "qstat", "qstat"), **geo)
    dkv_layout = scan_engine.QBlocks(
        splits=dkv_splits, leaf_dims=(d, d), out_dims=(d, d), **geo)
    return ((softmax_pair_bwd_dq_kernel_spec(**mask_cfg), dq_layout),
            (softmax_pair_bwd_dkv_kernel_spec(**mask_cfg), dkv_layout))


def flash_attention_kernel(
    q: torch.Tensor,  # (BH, Tq, d)
    k: torch.Tensor,  # (BHkv, Tk, d)
    v: torch.Tensor,  # (BHkv, Tk, d)
    *,
    group: int = 1,       # heads per kv head (GQA)
    scale: float,
    causal: bool = True,
    window: "int | None" = None,
    softcap: "float | None" = None,
    kv_len: "int | None" = None,
    block_q: int = 128,
    block_k: int = 128,
    schedule: str = "carry",
    kv_splits: "int | None" = None,
    return_stats: bool = False,
    use_kv_bounds: bool = True,
    count_cells: bool = False,
    kv_block_map=None,
):
    """Attention over flattened (batch·heads) leading axes.

    ``q`` has BH = B·H_q rows; ``k``/``v`` have B·H_kv; ``group`` maps
    each q head to its kv head (``h // group``: no materialized repeat).
    ``schedule`` picks the fold organization; ``kv_splits`` overrides the
    decoupled chunk count (default: the largest divisor of the KV block
    count up to ``default_kv_split_target()``).

    ``return_stats=True`` returns ``(out, m, l)`` — the folded row max
    and normalizer (each (BH, Tq, 1) f32), the backward's residuals.
    ``use_kv_bounds`` gates the causal-aware KV extent (skip cells that
    are provably fully masked — bitwise-identical output);
    ``count_cells=True`` (carry schedule) additionally returns the
    per-(head, q-block) executed-cell counts.

    ``kv_block_map`` (a sequence or int tensor of ``Tk / block_k``
    physical block ids) routes logical KV block ``j`` to physical block
    ``kv_block_map[j]`` of k/v (a paged pool): masks and bounds stay
    keyed on LOGICAL positions, so the output is bitwise identical to
    running on the contiguously-laid-out cache.
    """
    _check_shapes(q, k, v, group, block_q, block_k)
    spec, layout = forward_fold(
        q.shape, k.shape, group=group, scale=scale, causal=causal,
        window=window, softcap=softcap, kv_len=kv_len, block_q=block_q,
        block_k=block_k, schedule=schedule, kv_splits=kv_splits,
        return_stats=return_stats, use_kv_bounds=use_kv_bounds,
        kv_block_map=_block_map(kv_block_map, k))
    res = scan_engine.scan(
        (q.contiguous(), k.contiguous(), v.contiguous()), spec, layout,
        schedule=schedule, count_cells=count_cells)
    if count_cells:
        res, counts = res
        return (tuple(res) if return_stats else res[0]), counts
    return tuple(res) if return_stats else res[0]


def flash_attention_bwd_kernel(
    q: torch.Tensor,      # (BH, Tq, d)
    k: torch.Tensor,      # (BHkv, Tk, d)
    v: torch.Tensor,      # (BHkv, Tk, d)
    do: torch.Tensor,     # (BH, Tq, d) — output cotangent
    m: torch.Tensor,      # (BH, Tq, 1) f32 — forward row max
    l: torch.Tensor,      # (BH, Tq, 1) f32 — forward row normalizer
    delta: torch.Tensor,  # (BH, Tq, 1) f32 — rowsum(dO ⊙ O) precompute
    *,
    group: int = 1,
    scale: float,
    causal: bool = True,
    window: "int | None" = None,
    softcap: "float | None" = None,
    kv_len: "int | None" = None,
    block_q: int = 128,
    block_k: int = 128,
    schedule: str = "carry",
    kv_splits: "int | None" = None,
    use_kv_bounds: bool = True,
):
    """Flash backward as two engine folds: ``(dq, dk, dv)``.

    dq folds over KV blocks in the forward's ``KVBlocks`` layout; dk/dv
    fold over the transposed ``QBlocks`` (group × q-block) axis so the
    GQA head summation is the fold itself. Both are plain SUM monoids
    whose transforms recompute the logits tile — nothing T×T is ever
    materialized. ``schedule="decoupled"`` runs each fold's axis in
    parallel chunks stitched by the chain (split-KV for dq, split-Q for
    dk/dv).
    """
    BH, BHkv, Tq, Tk, d = _check_shapes(q, k, v, group, block_q, block_k)
    if do.shape != q.shape or m.shape != (BH, Tq, 1):
        raise ValueError(
            f"do {tuple(do.shape)} / m {tuple(m.shape)} do not fit q "
            f"{tuple(q.shape)}")
    (dq_spec, dq_layout), (dkv_spec, dkv_layout) = backward_folds(
        q.shape, k.shape, group=group, scale=scale, causal=causal,
        window=window, softcap=softcap, kv_len=kv_len, block_q=block_q,
        block_k=block_k, schedule=schedule, kv_splits=kv_splits,
        use_kv_bounds=use_kv_bounds)
    ops = tuple(t.contiguous() for t in (q, k, v, do, m, l, delta))
    dq, = scan_engine.scan(ops, dq_spec, dq_layout, schedule=schedule)
    dk, dv = scan_engine.scan(ops, dkv_spec, dkv_layout, schedule=schedule)
    return dq, dk, dv
