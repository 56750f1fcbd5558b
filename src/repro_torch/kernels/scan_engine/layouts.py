"""Tile geometry the scan schedules are written against.

The PyTorch counterpart of the reference's ``kernels/scan_engine/
layouts.py``, with the one layout this slice needs:

  Rows  (R, N) tensors scanned along the last axis in (bb, bn) tiles;
        rows are the paper's threads. Used by the sum registration.

``Channels`` (the affine/SSM time axis) and the attention layouts come
with the slices that port those registrations.
"""

from __future__ import annotations

import dataclasses


def _check_divisible(shape, block, what):
    for s, b in zip(shape, block):
        if s % b:
            raise ValueError(
                f"{what} shape {shape} not divisible by block {block}")


@dataclasses.dataclass(frozen=True)
class Rows:
    """2D (rows, n) tensors, scan along axis 1, tiles (bb, bn)."""

    rows: int
    n: int
    bb: int
    bn: int

    def __post_init__(self):
        _check_divisible((self.rows, self.n), (self.bb, self.bn), "Rows")

    @property
    def shape(self):
        return (self.rows, self.n)

    @property
    def grid(self):
        return (self.rows // self.bb, self.n // self.bn)

    @property
    def num_seq_blocks(self):
        return self.n // self.bn

    @property
    def chain_shape(self):
        """Shape of the per-chunk totals/offsets: (rows, chunks)."""
        return (self.rows, self.num_seq_blocks)
