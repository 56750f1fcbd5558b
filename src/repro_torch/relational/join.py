"""Partitioned equi-join with prefix-sum build and probe offsets.

The PyTorch counterpart of the reference's ``relational/join.py``. The
radix-join structure (Manegold/Boncz; Satish et al. are the paper's
citation for the same prefix-sum pattern on GPUs):

  build  the right (build) side is brought to sorted order by LSD radix
         passes — each pass a stable prefix-sum partition
         (``relational.sort`` over ``relational.partition``).
  probe  each left row binary-searches its key's run in the sorted build
         side; its match COUNT feeds an exclusive prefix sum that assigns
         every (left, right) output pair a unique slot — the paper's "new
         index values" once more, now over the result set.

Output is fixed-size: index pairs padded with -1 plus the live pair
count. Capacity policy (``max_matches``):

  * ``"auto"`` (default) — SPILL-SAFE: size the output to the histogram
    product upper bound Σ_b |L_b|·|R_b| over hashed buckets of the key
    domain (``estimate_max_matches``, a host-side histogram: CUDA keys'
    bucket counts are copied to the host). The bound dominates the true
    match count for every key distribution, so no pair is ever dropped.
  * ``None`` — exact: materialize the true count.
  * ``int`` — a fixed cap; pairs beyond it are dropped but ``count``
    still reports the true total.

Keys of every dtype join in the order-preserving signed embedding of
``relational.sort`` (a total order, so the binary search stays valid with
NaN build keys; unsigned 32/64-bit types have no ``searchsorted``).
Floats: signed zeros collapse (-0.0 matches +0.0), NaN probe rows match
nothing, build NaNs park at the top of the domain.

The reference switches its offsets and slot ids to int64 under
``jax_enable_x64``. The port has no such switch and does what the
reference does with x64 off: int32 offsets, and every overflow of them
raises ``OverflowError``. The probe-offset scan is an integer sum, so it
runs through the kernel cumsum on a CUDA tensor and the library's
blocked scan on the CPU, with the same bits (see
``core.scan.segmented``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import scan as scanlib
from repro_torch.relational.sort import _sortable_bits, radix_sort

_INT32_MAX = 2 ** 31 - 1


class JoinResult(NamedTuple):
    """Matching row-index pairs of an inner equi-join.

    Attributes:
      left_index: (M,) int32 row into the left table, -1 past ``count``.
      right_index: (M,) int32 row into the right table, -1 past ``count``.
      count: () int32 number of live pairs (may exceed M if the cap was
        too small; pairs beyond the cap are dropped).
    """

    left_index: torch.Tensor
    right_index: torch.Tensor
    count: torch.Tensor


def _canonical_zero(keys: torch.Tensor) -> torch.Tensor:
    """-0.0 -> +0.0, so equal keys share one bit pattern."""
    return torch.where(keys == 0, torch.zeros_like(keys), keys)


def _radix_buckets(keys: torch.Tensor, bits: int) -> torch.Tensor:
    """``bits``-wide histogram bucket of each key (int64).

    Equal keys land in the same bucket by construction — the only
    property the upper bound needs. Signed zeros are canonicalized
    exactly like the match path, and the key goes through a Fibonacci
    multiplicative hash before the bucket is taken, so stride-aligned
    key families spread across buckets. The hash is the reference's
    unsigned one, computed in int64 (a wrapping multiply keeps the low
    bits exact).
    """
    if keys.is_floating_point():
        s, _ = _sortable_bits(_canonical_zero(keys))
        keys = s ^ torch.iinfo(s.dtype).min  # the unsigned embedding's bits
    if keys.element_size() == 8:
        h = keys.to(torch.int64) * -7046029254386353131  # 0x9E3779B97F4A7C15
        return (h >> (64 - bits)) & ((1 << bits) - 1)
    u = keys.to(torch.int64) & 0xFFFFFFFF
    return ((u * 2654435761) & 0xFFFFFFFF) >> (32 - bits)


def estimate_max_matches(left_keys: torch.Tensor, right_keys: torch.Tensor,
                         *, bits: int = 16) -> int:
    """Histogram-product upper bound on the inner-join output size.

    Bucket both key columns and sum ``count_left[b] * count_right[b]`` —
    keys can only match inside a shared bucket, so the product bound
    dominates the true match count (equality when every bucket holds one
    distinct key). The partitioned-join sizing rule (Manegold/Boncz): the
    same histogram that drives the radix partition prices the output
    buffer. A host-side int (the capacity is a shape).
    """
    if left_keys.shape[0] == 0 or right_keys.shape[0] == 0:
        return 0
    nb = 1 << bits
    cl = torch.bincount(_radix_buckets(left_keys, bits), minlength=nb)
    cr = torch.bincount(_radix_buckets(right_keys, bits), minlength=nb)
    return int(np.sum(cl.cpu().numpy().astype(np.int64)
                      * cr.cpu().numpy().astype(np.int64)))


def hash_join(left_keys: torch.Tensor, right_keys: torch.Tensor, *,
              max_matches: "int | str | None" = "auto") -> JoinResult:
    """Inner equi-join of two (L,) / (R,) key columns.

    Pairs are emitted grouped by left row (left rows in input order;
    within a row, right matches in build-side sorted order). See the
    module doc for the ``max_matches`` capacity policy; the default
    ``"auto"`` bound is spill-safe (never drops a pair).
    """
    if left_keys.dtype != right_keys.dtype:
        raise TypeError(
            f"hash_join key dtypes must match: {left_keys.dtype} vs "
            f"{right_keys.dtype}")
    dev = left_keys.device
    if max_matches == "auto":
        bound = estimate_max_matches(left_keys, right_keys)
        if bound > _INT32_MAX:
            raise OverflowError(
                f"join upper bound {bound} exceeds int32 pair offsets")
        max_matches = bound
    L, R = left_keys.shape[0], right_keys.shape[0]
    if L == 0 or R == 0:
        M = 0 if max_matches is None else int(max_matches)
        pad = torch.full((M,), -1, dtype=torch.int32, device=dev)
        return JoinResult(pad, pad, torch.zeros((), dtype=torch.int32,
                                                device=dev))

    lnan = None
    if left_keys.is_floating_point():
        lnan = torch.isnan(left_keys)
        rnan = torch.isnan(right_keys)
        left_keys = _canonical_zero(left_keys)
        right_keys = _canonical_zero(right_keys)
    lk, _ = _sortable_bits(left_keys)
    rk, _ = _sortable_bits(right_keys)
    if lnan is not None:
        # park build NaNs at the domain top, past every real key (no
        # non-NaN key maps there); NaN probes are suppressed below
        rk = torch.where(rnan, torch.iinfo(rk.dtype).max, rk)

    # Build: partition the right side to sorted order (radix passes).
    rk, rperm = radix_sort(
        rk, torch.arange(R, dtype=torch.int32, device=dev))
    lo = torch.searchsorted(rk, lk, side="left").to(torch.int32)
    hi = torch.searchsorted(rk, lk, side="right").to(torch.int32)
    if lnan is not None:
        hi = torch.where(lnan, lo, hi)  # NaN probes match nothing

    # Probe offsets: exclusive prefix sum of per-row match counts in
    # int32; an overflowing join raises instead of wrapping.
    m = hi - lo
    off = scanlib.cumsum(m, exclusive=True,
                         algorithm="kernel" if m.is_cuda else "blocked")
    total = off[-1] + m[-1]

    if max_matches is None:
        # Exact recount in int64: int32 accumulation wraps mod 2^32, so
        # both negative AND positive-wrapped totals are caught.
        exact = int(m.sum(dtype=torch.int64))
        if exact != int(total):
            raise OverflowError("join result exceeds int32 pair offsets")
        M = exact
    else:
        M = int(max_matches)
    if M == 0:
        pad = torch.zeros((0,), dtype=torch.int32, device=dev)
        return JoinResult(pad, pad, total)
    if M > _INT32_MAX:
        raise OverflowError(f"join capacity {M} exceeds int32 slot ids")

    # Expand: output slot p belongs to the last left row whose offset is
    # <= p (right-bisect skips rows with zero matches), at match number
    # p - off[row] within that row's [lo, hi) run.
    p = torch.arange(M, dtype=torch.int32, device=dev)
    li = torch.clamp(
        torch.searchsorted(off, p, side="right").to(torch.int32) - 1,
        0, L - 1)
    j = p - off[li.long()]
    rs = torch.clamp(lo[li.long()] + j, 0, R - 1)
    valid = p < total
    lidx = torch.where(valid, li, -1)
    ridx = torch.where(valid, rperm[rs.long()], -1)
    return JoinResult(lidx, ridx, total)
