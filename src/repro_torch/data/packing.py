"""Sequence packing via exclusive prefix-sum offsets.

Documents of ragged lengths are packed into fixed-length rows, and every
document's destination offset is the running total of the lengths that
precede it in its row. The segment ids of the packed attention mask come
from the scan API (an inclusive cumsum of begin-flags).
"""

from __future__ import annotations

import torch

from repro_torch.core import scan as scanlib


def packing_offsets(lengths: torch.Tensor, row_len: int):
    """Greedy next-fit assignment of documents into rows of ``row_len``.

    Returns (row_idx, col_idx) per document, int32 on ``lengths``' device:
    document d goes to row ``row_idx[d]`` starting at column
    ``col_idx[d]``; a document that would overflow its row opens the next
    one. Documents longer than ``row_len`` must be pre-split by the
    caller. Next-fit is a sequential recurrence (a row opens where the
    running column would pass ``row_len``), not a monoid: it runs as the
    reference's step, one document after another, on the host.

    Zero-length documents never advance the packing state (no phantom row
    opens) and are given the current cursor as a placeholder — callers
    mask token writes by ``length > 0`` (``pack_documents`` does).
    """
    row = col = 0
    rows, cols = [], []
    for ln in lengths.to(torch.int32).tolist():
        overflow = ln > 0 and col + ln > row_len
        if overflow:
            row += 1
        start = 0 if overflow else col
        rows.append(row)
        cols.append(start)
        col = start + ln
    dev = lengths.device
    return (torch.tensor(rows, dtype=torch.int32, device=dev),
            torch.tensor(cols, dtype=torch.int32, device=dev))


def pack_documents(docs: torch.Tensor, lengths: torch.Tensor, row_len: int,
                   num_rows: int, pad_id: int = 0):
    """Scatter ragged documents (docs: (D, max_doc_len)) into packed rows.

    Returns (tokens (num_rows, row_len), segment_ids (num_rows, row_len)).
    segment_ids are 1-based per row, 0 = padding; they feed block-diagonal
    attention masks. Uses the offsets of ``packing_offsets``.
    """
    D, max_len = docs.shape
    dev = docs.device
    rows, cols = packing_offsets(lengths, row_len)
    lengths = lengths.to(dev)

    # Flatten destination: row * row_len + col + [0..len) per token.
    tok_pos = torch.arange(max_len, device=dev)[None, :]     # (1, max_len)
    valid = tok_pos < lengths[:, None]                       # (D, max_len)
    dest = rows.to(dev)[:, None].long() * row_len + cols.to(dev)[:, None] \
        + tok_pos
    park = num_rows * row_len
    dest = torch.where(valid, dest, park).reshape(-1)        # park invalid

    flat = torch.full((park + 1,), pad_id, dtype=docs.dtype, device=dev)
    flat[dest] = docs.reshape(-1)
    tokens = flat[:-1].reshape(num_rows, row_len)

    seg = torch.zeros((park + 1,), dtype=torch.int32, device=dev)
    ids = (torch.arange(D, device=dev, dtype=torch.int32) + 1)[:, None]
    seg[dest] = (ids.expand(D, max_len) * valid.to(torch.int32)).reshape(-1)
    segment_ids = seg[:-1].reshape(num_rows, row_len)
    return tokens, segment_ids


def segment_starts_to_ids(starts: torch.Tensor) -> torch.Tensor:
    """Begin-flags -> 1-based segment ids via inclusive cumsum (scan API).

    Flags are clamped to 0/1 first: a slot where several documents
    "start" because zero-length entries collapsed onto it (a scatter-add
    producing a flag of 2+) still begins exactly ONE segment — without
    the clamp the cumsum would skip ids, emitting phantom segments.
    """
    flags = (starts != 0).to(torch.int32)
    return scanlib.cumsum(flags, axis=-1, algorithm="blocked")
