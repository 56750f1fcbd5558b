"""Tile geometry the scan schedules are written against.

The PyTorch counterpart of the reference's ``kernels/scan_engine/
layouts.py``, with the two layouts of the element monoids:

  Rows      (R, N) tensors scanned along the last axis in (bb, bn) tiles;
            rows are the paper's threads. Used by the sum, segmented-sum
            and compact-mask registrations.
  Channels  (B, T, D) tensors scanned along the TIME axis (axis 1) in
            (1, bt, bd) tiles; channels are independent lanes (the
            paper's §3.2 vertical SIMD) with one carried state each. Used
            by the affine/SSM registration.

Both expose the chunk axis as axis 1 of their per-chunk arrays
(``chain_shape``) and of their ``tile_shape`` view, whose axis 2 is the
position inside a tile: the plain versions of the kernels are written
once against that view. The attention layouts come with the slice that
ports the attention fold.
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
    def block_shape(self):
        return (self.bb, self.bn)

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

    @property
    def tile_shape(self):
        """(rows, chunks, bn): the data with one tile's positions on
        axis 2, the lane axis."""
        return (self.rows, self.num_seq_blocks, self.bn)


@dataclasses.dataclass(frozen=True)
class Channels:
    """3D (B, T, D) tensors, scan along axis 1 (time), tiles (1, bt, bd);
    the carry is one state per channel."""

    b: int
    t: int
    d: int
    bt: int
    bd: int

    def __post_init__(self):
        _check_divisible((self.t, self.d), (self.bt, self.bd), "Channels")

    @property
    def shape(self):
        return (self.b, self.t, self.d)

    @property
    def block_shape(self):
        return (1, self.bt, self.bd)

    @property
    def grid(self):
        return (self.b, self.d // self.bd, self.t // self.bt)

    @property
    def num_seq_blocks(self):
        return self.t // self.bt

    @property
    def chain_shape(self):
        """Shape of the per-chunk totals/offsets: (B, chunks, D)."""
        return (self.b, self.num_seq_blocks, self.d)

    @property
    def tile_shape(self):
        """(B, chunks, bt, D): one tile's time steps on axis 2, channels
        last (not the scanned axis)."""
        return (self.b, self.num_seq_blocks, self.bt, self.d)
