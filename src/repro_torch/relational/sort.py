"""LSD radix sort composed from stable prefix-sum partition passes.

The PyTorch counterpart of the reference's ``relational/sort.py``. Each
pass partitions by one radix digit of a sortable bit-transform of the
keys (the classic Satish et al. GPU radix sort the paper cites as a
prefix-sum consumer); stability of ``relational.partition`` makes the
multi-pass composition correct. Supports bool, signed/unsigned ints and
IEEE floats (half types sort through their exact float32 embedding).
NaN placement differs from ``torch.sort``: positive-sign NaNs sort after
+inf, negative-sign NaNs before -inf (total order over the bit
patterns), whereas ``torch.sort`` moves every NaN to the end.

The reference embeds keys into unsigned bits ``u``. Torch's unsigned
32- and 64-bit types support few operations (no ``searchsorted``, no
indexing on some devices), so the port carries an order-preserving
SIGNED embedding ``s`` instead: ``s = u`` for types of at most 16 bits,
and ``s = u`` with its top bit flipped, read as a signed int32/int64,
for 32- and 64-bit types. ``_digits`` recovers exactly the reference's
radix digits of ``u`` from ``s``, so every pass, and the sort, are the
reference's.
"""

from __future__ import annotations

import torch

from repro_torch.relational.partition import apply_plan, partition_plan

_UNSIGNED = {torch.uint8: 8, torch.uint16: 16, torch.uint32: 32,
             torch.uint64: 64}
_SIGNED = {torch.int8: 8, torch.int16: 16, torch.int32: 32, torch.int64: 64}
_SIGNED_OF_WIDTH = {32: torch.int32, 64: torch.int64}


def _sortable_bits(keys: torch.Tensor) -> tuple[torch.Tensor, int]:
    """Monotone embedding of ``keys`` into signed integers: s(a) < s(b)
    iff a sorts before b. Returns (int32/int64 tensor, significant bit
    count of the reference's unsigned embedding)."""
    dt = keys.dtype
    if dt == torch.bool:
        return keys.to(torch.int32), 1
    if dt in _UNSIGNED:
        bits = _UNSIGNED[dt]
        if bits <= 16:
            return keys.to(torch.int32), bits
        # u - 2^(bits-1): the top bit flipped, read as signed
        sdt = _SIGNED_OF_WIDTH[bits]
        return keys.view(sdt) ^ torch.iinfo(sdt).min, bits
    if dt in _SIGNED:
        bits = _SIGNED[dt]
        if bits <= 16:  # bias into [0, 2^bits)
            return keys.to(torch.int32) - torch.iinfo(dt).min, bits
        return keys, bits  # u = the sign bit flipped: s is the key itself
    if dt.is_floating_point:
        if dt.itemsize < 4:
            keys = keys.to(torch.float32)  # exact, monotone embedding
        bits = keys.element_size() * 8
        sdt = _SIGNED_OF_WIDTH[bits]
        b = keys.view(sdt)
        # IEEE trick: negatives flip every bit below the sign (reverses
        # their order), non-negatives keep theirs.
        return torch.where(b < 0, b ^ torch.iinfo(sdt).max, b), bits
    raise TypeError(f"radix_sort: unsupported key dtype {dt}")


def _digits(s: torch.Tensor, bits: int, shift: int, nb: int) -> torch.Tensor:
    """Radix digit ``(u >> shift) & (nb - 1)`` of the reference's
    unsigned embedding ``u``, from the signed embedding ``s``."""
    if bits >= 32:
        s = s ^ torch.iinfo(s.dtype).min  # back to u's bit pattern
    # An arithmetic shift fills the top with sign bits; the mask keeps
    # only bits below ``bits``, so it reads as the logical shift.
    return ((s >> shift) & (nb - 1)).to(torch.int32)


def radix_sort(keys: torch.Tensor, *payload: torch.Tensor,
               radix_bits: int = 8):
    """Stable ascending sort of (T,) ``keys``; ``payload`` tensors (T, ...)
    are reordered alongside. Returns sorted keys, or the
    ``(keys, *payload)`` tuple when payload is given.

    Peak memory per pass: the one-hot and its running counts,
    2 · T · 2^radix_bits · 4 bytes (8 GiB at T = 2^22, radix_bits 8).
    """
    if keys.ndim != 1:
        raise ValueError(f"radix_sort expects 1D keys, got {tuple(keys.shape)}")
    arrays = (keys,) + payload
    if keys.shape[0] > 1:
        s, bits = _sortable_bits(keys)
        for shift in range(0, bits, radix_bits):
            nb = 1 << min(radix_bits, bits - shift)
            plan = partition_plan(_digits(s, bits, shift, nb), nb)
            (s,) = apply_plan(plan, s)
            arrays = apply_plan(plan, *arrays)
    return arrays[0] if not payload else arrays


def argsort(keys: torch.Tensor, radix_bits: int = 8) -> torch.Tensor:
    """Stable permutation sorting ``keys`` (ties keep input order)."""
    perm = torch.arange(keys.shape[0], dtype=torch.int32, device=keys.device)
    if keys.shape[0] <= 1:
        return perm
    return radix_sort(keys, perm, radix_bits=radix_bits)[1]
