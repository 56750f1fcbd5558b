"""Stream compaction (filter): predicate -> mask cumsum -> gather.

The PyTorch counterpart of the reference's ``relational/compact.py``.
Every surviving element's new index is the exclusive prefix sum of the
keep-mask — a scan over ``repro_torch.core.scan`` (library route) or the
fused mask-compact kernels of ``repro_torch.kernels.compact`` (the scan
engine's mask registration: predicate select fused into the writeback,
under whichever schedule the policy picks).

``algorithm="auto"`` takes the kernel route for a CUDA tensor, where the
reference takes it on a TPU, and the library route elsewhere. Outputs
are fixed-size: ``filter_compact`` returns a ``size``-length buffer plus
the live count, with dropped positions holding ``fill_value``.
"""

from __future__ import annotations

import torch

from repro_torch.core import scan as scanlib

_ALGORITHMS = ("auto", "ref", "kernel")


def _resolve(algorithm: str, x: torch.Tensor) -> str:
    if algorithm not in _ALGORITHMS:
        raise ValueError(
            f"unknown algorithm {algorithm!r}; one of {_ALGORITHMS}")
    if algorithm == "auto":
        # The fused kernel runs on the card; on the CPU it would run the
        # plain version of each kernel, so the library scan is the default.
        return "kernel" if x.is_cuda else "ref"
    return algorithm


def mask_ranks(mask: torch.Tensor, *, algorithm: str = "auto"
               ) -> torch.Tensor:
    """Exclusive prefix sum of a (T,) keep-mask: each position's compacted
    rank (defined for dropped positions too — the running survivor count).
    """
    m = (mask != 0).to(torch.int32)
    if m.shape[0] == 0:
        return m
    if _resolve(algorithm, m) == "kernel":
        from repro_torch.kernels.scan_blocked import ops as sb_ops
        # schedule="auto": the policy's grid rule (a single long mask row
        # lands on the parallel-sequence schedules).
        return sb_ops.cumsum(m, exclusive=True)
    return scanlib.cumsum(m, exclusive=True, algorithm="blocked")


def compact_indices(mask: torch.Tensor, *, algorithm: str = "auto"
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Scatter destinations for a (T,) keep-mask.

    Returns ``(dest, count)``: ``dest[i]`` is the compacted write index
    where ``mask[i]`` holds and the sentinel ``T`` where it doesn't;
    ``count`` is the number of survivors. Both come from one mask scan.
    """
    m = mask != 0
    T = m.shape[0]
    if T == 0:
        return (torch.zeros((0,), dtype=torch.int32, device=m.device),
                torch.zeros((), dtype=torch.int32, device=m.device))
    if _resolve(algorithm, m) == "kernel":
        from repro_torch.kernels.compact import ops as kc_ops
        return kc_ops.mask_compact(m)
    ranks = mask_ranks(m, algorithm="ref")
    count = ranks[-1] + m[-1].to(torch.int32)
    return torch.where(m, ranks, T).to(torch.int32), count


def filter_compact(values: torch.Tensor, mask: torch.Tensor, *,
                   size: "int | None" = None, fill_value=0,
                   algorithm: str = "auto"
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Keep ``values`` rows where ``mask`` holds, packed to the front.

    ``values`` is (T, ...) with a (T,) ``mask``. Returns ``(out, count)``
    where ``out`` has leading length ``size`` (default T): the first
    ``count`` rows are the survivors in input order (bit-identical to
    ``values[mask]``), the rest hold ``fill_value``. Survivors ranked
    beyond ``size`` are dropped (``count`` still reports the true total).
    """
    if values.shape[:1] != mask.shape:
        raise ValueError(f"values leading axis {tuple(values.shape[:1])} != "
                         f"mask {tuple(mask.shape)}")
    T = mask.shape[0]
    cap = T if size is None else int(size)
    dest, count = compact_indices(mask, algorithm=algorithm)
    # Park dropped elements (sentinel T) and over-capacity survivors at
    # index `cap` — min(cap, T) catches the sentinel when cap > T too.
    # Several rows may land there, in any order: the slot is sliced off,
    # and every survivor's slot is its own.
    dest = torch.where(dest >= min(cap, T), cap, dest)
    buf = torch.full((cap + 1,) + tuple(values.shape[1:]), fill_value,
                     dtype=values.dtype, device=values.device)
    buf[dest.long()] = values
    return buf[:cap], count
