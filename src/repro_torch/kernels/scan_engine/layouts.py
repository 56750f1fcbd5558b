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
once against that view.

The attention fold layouts are plain geometry (the kernels compute their
own offsets from it):

  KVBlocks  q (BH, Tq, d) against k/v (BHkv, Tk, d), folded along KV
            blocks; GQA maps q head ``h`` to kv head ``h // group``.
            Monoid leaves are per-q-block payload carries with per-leaf
            trailing dims (``leaf_dims``), outputs are the fold. Used by
            the flash forward and the backward dq fold.
  QBlocks   the TRANSPOSED fold for the backward dk/dv: one row per (kv
            head, KV block), folded along the (group × q-block) axis, so
            GQA head summation is the fold itself.

They optionally carry ``kv_bounds`` — the per-q-block KV extent (causal,
window, kv_len): the fold schedules skip cells whose mask is provably
all-dead, which with the zeroed-probability convention is bitwise
invisible — and ``kv_block_map``, a runtime int32 tensor routing logical
KV block ``j`` to physical block ``kv_block_map[j]`` (a paged pool).
"""

from __future__ import annotations

import dataclasses

import torch


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


def block_live(qi, kj, *, bq, bk, causal, window, kv_len):
    """Whether the (q-block ``qi``, kv-block ``kj``) mask has ANY live
    entry — the per-q-block KV extent in predicate form.

    Conservative in the safe direction: a False is a proof that every
    (row, col) pair in the cell is masked (each conjunct is a necessary
    condition for liveness over the block's row/col ranges), so skipping
    the cell is exact; a rare True on a fully-masked cell merely folds
    in the monoid identity. Works on python ints (analytic cell counts)
    and integer tensors (the plain fold versions) alike.
    """
    live = True
    if kv_len is not None:
        live = kj * bk < kv_len
    if causal:
        live = live & (kj * bk <= (qi + 1) * bq - 1)
    if window is not None:
        live = live & ((kj + 1) * bk - 1 > qi * bq - window)
    return live


def _active_cell_count(nq, nk, *, bq, bk, bounds):
    causal, window, kv_len = bounds
    return sum(
        bool(block_live(qi, kj, bq=bq, bk=bk, causal=causal,
                        window=window, kv_len=kv_len))
        for qi in range(nq) for kj in range(nk))


@dataclasses.dataclass(frozen=True)
class _AttnFold:
    """Shared geometry of the attention fold layouts (KVBlocks/QBlocks).

    ``op_kinds`` names each operand's addressing — ``"q"`` (q-major
    (bh, tq, d) tiles), ``"kv"`` (kv-major (bh_kv, tk, d) tiles with the
    GQA ``h // group`` association), ``"qstat"`` (q-major per-row
    statistics, trailing dim 1) — so the backward folds feed
    ``(q, k, v, do, m, l, delta)`` through the same layouts.
    ``out_dims`` gives per-output trailing dims (stats outputs are
    dim-1); ``kv_bounds = (causal, window, kv_len)`` enables the
    per-q-block KV extent (``fold_active``).

    The plain fold versions walk the fold axis one position ``f`` at a
    time with every grid row at once: ``op_tiles(operands, f)`` gives
    each operand's tiles with two leading batch axes (``batch_shape``)
    and ``block_ids(f)`` the matching ``(head, q_block, kv_block)``
    integer tensors.
    """

    bh: int              # flattened B·H_q query rows
    bh_kv: int           # flattened B·H_kv rows; bh == bh_kv * group
    tq: int
    tk: int
    d: int
    bq: int
    bk: int
    group: int = 1
    splits: int = 1      # fold-axis chunks for the decoupled schedule
    leaf_dims: "tuple | None" = None   # per-leaf trailing dims
    op_kinds: tuple = ("q", "kv", "kv")
    out_dims: "tuple | None" = None    # per-output trailing dims; all d
    kv_bounds: "tuple | None" = None   # (causal, window, kv_len) extent
    # Page indirection: logical KV block j reads physical block
    # kv_block_map[j] (an int32 tensor on the operands' device). None =
    # identity addressing. Masks and bounds stay keyed on LOGICAL ids.
    kv_block_map: "torch.Tensor | None" = dataclasses.field(
        default=None, compare=False)

    def __post_init__(self):
        name = type(self).__name__
        _check_divisible((self.tq, self.tk), (self.bq, self.bk), name)
        if self.bh != self.bh_kv * self.group:
            raise ValueError(
                f"bh={self.bh} != bh_kv={self.bh_kv} * group={self.group}")
        if self.kv_block_map is not None and \
                self.kv_block_map.numel() != self.nk:
            raise ValueError(
                f"kv_block_map has {self.kv_block_map.numel()} entries for "
                f"{self.nk} logical KV blocks")
        if self.splits < 1 or self.num_seq_blocks % self.splits:
            raise ValueError(
                f"splits={self.splits} must divide {self.num_seq_blocks} "
                f"{name} fold blocks")
        bad = set(self.op_kinds) - {"q", "kv", "qstat"}
        if bad:
            raise ValueError(f"unknown op kinds {sorted(bad)}")

    # -- geometry --------------------------------------------------------
    @property
    def nq(self):
        return self.tq // self.bq

    @property
    def nk(self):
        return self.tk // self.bk

    @property
    def blocks_per_chunk(self):
        return self.num_seq_blocks // self.splits

    @property
    def split_grid(self):
        return self.grid[:-1] + (self.splits, self.blocks_per_chunk)

    def out_dim(self, i: int) -> int:
        return self.d if self.out_dims is None else self.out_dims[i]

    def op_block_shape(self, kind):
        """One grid cell's tile of an operand of this kind."""
        if kind == "q":
            return (1, self.bq, self.d)
        if kind == "qstat":
            return (1, self.bq, 1)
        return (1, self.bk, self.d)

    def check_ops(self, n_ops):
        if n_ops != len(self.op_kinds):
            raise ValueError(
                f"{type(self).__name__} expects {len(self.op_kinds)} "
                f"operands ({self.op_kinds}), got {n_ops}")

    # -- causal-aware KV extent ------------------------------------------
    def fold_active(self, ids):
        """Liveness of the cell(s) at ids ``(h, qi, kj)`` — ``None`` when
        no bounds are configured (always run)."""
        if self.kv_bounds is None:
            return None
        causal, window, kv_len = self.kv_bounds
        if not causal and window is None and kv_len is None:
            # no live constraint: block_live would be the constant True
            return None
        _, qi, kj = ids
        return block_live(qi, kj, bq=self.bq, bk=self.bk, causal=causal,
                          window=window, kv_len=kv_len)

    def _live_plane_cells(self) -> int:
        """Live cells of the (q-block, kv-block) plane under bounds."""
        if self.kv_bounds is None:
            return self.nq * self.nk
        return _active_cell_count(self.nq, self.nk, bq=self.bq,
                                  bk=self.bk, bounds=self.kv_bounds)

    def physical_block(self, j: int) -> int:
        """The physical KV block that logical block ``j`` reads."""
        if self.kv_block_map is None:
            return j
        return int(self.kv_block_map[j])

    def unchain_out(self, x):
        """(rows, tile, dim) or (batch_shape..., tile, dim) fold result ->
        the output's (heads, T, dim)."""
        return x.reshape(self.out_shape_for(0)[:2] + (x.shape[-1],))


@dataclasses.dataclass(frozen=True)
class KVBlocks(_AttnFold):
    """Attention fold geometry for carried-payload (transform) monoids.

    q ``(bh, tq, d)`` attends k/v ``(bh_kv, tk, d)``; the folded axis is
    the KV-block axis and the monoid leaves are per-q-block PAYLOAD
    carries — ``(bq, leaf_dims[i])`` tiles (flash attention: the
    ``(m, l)`` pair at dim 1 plus the weighted-value accumulator at dim
    ``d``).

    Two grids serve the two fold schedules:

      carry      ``(bh, nq, nk)``: one (head, q-block) row per block of
                 the kernel, the KV blocks a sequential accumulate,
                 output written once at the end.
      decoupled  ``(bh, nq, splits, nk/splits)``: split-KV /
                 flash-decoding. KV chunks are parallel; within a chunk
                 the same sequential accumulate, publishing one payload
                 triple per chunk; a combine chain + finalize stitches
                 the chunks back together.
    """

    @property
    def shape(self):
        return (self.bh, self.tq, self.d)

    @property
    def num_seq_blocks(self):
        return self.nk          # the fold walks KV blocks

    @property
    def grid(self):
        return (self.bh, self.nq, self.nk)

    @property
    def batch_shape(self):
        return (self.bh, self.nq)

    @property
    def tile_rows(self):
        return self.bq

    def leaf_dim(self, leaf: int) -> int:
        dims = self.leaf_dims if self.leaf_dims is not None \
            else (1, 1, self.d)
        return dims[leaf]

    def out_shape_for(self, i: int):
        return (self.bh, self.tq, self.out_dim(i))

    def chain_shape_for(self, leaf: int):
        return (self.bh * self.nq, self.splits, self.bq,
                self.leaf_dim(leaf))

    def active_cells(self) -> int:
        """Analytic count of live grid cells under ``kv_bounds`` (full
        grid when bounds are off) — per flattened head row."""
        return self._live_plane_cells()

    @property
    def count_shape(self):
        return (self.bh, self.nq)

    # -- plain-fold views ------------------------------------------------
    def block_ids(self, f: int, device=None):
        h = torch.arange(self.bh, device=device)[:, None]
        qi = torch.arange(self.nq, device=device)[None, :]
        kj = torch.tensor(f, device=device)
        return (h, qi, kj)

    def op_tiles(self, operands, f: int):
        """Each operand's tiles at fold position ``f`` (KV block ``f``):
        q-kind (bh, nq, bq, dim); kv-kind (bh, 1, bk, d), the kv head of
        each q head through the GQA map and the page map."""
        j = self.physical_block(f)
        heads = torch.arange(self.bh, device=operands[0].device) \
            // self.group
        tiles = []
        for o, kind in zip(operands, self.op_kinds):
            if kind == "kv":
                t = o[:, j * self.bk:(j + 1) * self.bk].index_select(0, heads)
                tiles.append(t.unsqueeze(1))
            else:
                tiles.append(o.reshape(self.bh, self.nq, self.bq,
                                       o.shape[-1]))
        return tuple(tiles)


@dataclasses.dataclass(frozen=True)
class QBlocks(_AttnFold):
    """Transposed attention fold geometry: the backward dk/dv layout.

    One grid row per (kv head, KV block); the folded axis walks the
    (group × q-block) product — every q head that addresses this KV head
    under GQA plus every q block, so the head summation IS the fold.
    Monoid leaves are per-KV-block accumulators of shape
    ``(bk, leaf_dims[i])`` (flash backward: the dk and dv tiles), and
    outputs land kv-major at ``(bh_kv, tk, out_dim)``. Fold position
    ``f`` addresses q head ``h_kv·group + f // nq`` and q block
    ``f % nq``; ``kv_bounds`` applies the same per-(q-block, kv-block)
    liveness predicate as ``KVBlocks``.
    """

    op_kinds: tuple = ("q", "kv", "kv", "q", "qstat", "qstat", "qstat")

    @property
    def shape(self):
        return (self.bh_kv, self.tk, self.d)

    @property
    def num_seq_blocks(self):
        return self.group * self.nq    # the fold walks (group, q) blocks

    @property
    def grid(self):
        return (self.bh_kv, self.nk, self.num_seq_blocks)

    @property
    def batch_shape(self):
        return (self.bh_kv, self.nk)

    @property
    def tile_rows(self):
        return self.bk

    def leaf_dim(self, leaf: int) -> int:
        return self.d if self.leaf_dims is None else self.leaf_dims[leaf]

    def out_shape_for(self, i: int):
        return (self.bh_kv, self.tk, self.out_dim(i))

    def chain_shape_for(self, leaf: int):
        return (self.bh_kv * self.nk, self.splits, self.bk,
                self.leaf_dim(leaf))

    def active_cells(self) -> int:
        """Live fold cells per flattened kv-head row (every q head of
        the group walks the same (qi, kj) liveness plane)."""
        return self.group * self._live_plane_cells()

    @property
    def count_shape(self):
        return (self.bh_kv, self.nk)

    # -- plain-fold views ------------------------------------------------
    def block_ids(self, f: int, device=None):
        h = torch.arange(self.bh_kv, device=device)[:, None] * self.group \
            + f // self.nq
        qi = torch.tensor(f % self.nq, device=device)
        kj = torch.arange(self.nk, device=device)[None, :]
        return (h, qi, kj)

    def op_tiles(self, operands, f: int):
        """Each operand's tiles at fold position ``f``: kv-kind (bh_kv,
        nk, bk, d); q-kind (bh_kv, 1, bq, dim) of q head
        ``h_kv·group + f // nq`` and q block ``f % nq``."""
        qi = f % self.nq
        heads = torch.arange(self.bh_kv, device=operands[0].device) \
            * self.group + f // self.nq
        tiles = []
        for o, kind in zip(operands, self.op_kinds):
            if kind == "kv":
                tiles.append(o.reshape(self.bh_kv, self.nk, self.bk,
                                       self.d))
            else:
                t = o[:, qi * self.bq:(qi + 1) * self.bq].index_select(
                    0, heads)
                tiles.append(t.unsqueeze(1))
        return tuple(tiles)
