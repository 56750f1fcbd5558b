"""The four schedules of the scan engine, and the plain version of every kernel.

The PyTorch counterpart of the reference's ``kernels/scan_engine/
schedules.py``. Prefix-scan performance is decided by how the
sub-procedures are ORGANIZED, not by the operator, so each schedule is
written once over a ``KernelSpec`` and a layout (``Rows`` or
``Channels``):

  carry      single-pass accumulate: one block per row (or channel
             strip) walks its chunks, the running carry on chip.
             read n + write n.
  decoupled  reduce-then-scan: a parallel totals pass, a sequential
             exclusive chain over the chunk totals, a parallel apply pass
             that rescans each chunk and adds its offset. read 2n +
             write n — the price of spreading ONE row over the card.
  fused      decoupled in one launch: each chunk scans its tile once,
             takes its predecessors' published prefix through a
             look-back, republishes, and writes. read n + write n.
             ``return_totals`` runs decoupled, as in the reference.
  tree       carry's walk with the work-efficient Blelloch sweep as the
             in-tile network (the paper's §3.3). read n + write n.

Carried-payload monoids (``spec.transform``: flash attention's forward
and its two backward folds) run the FOLD forms on the ``KVBlocks`` /
``QBlocks`` layouts: ``fold_carry`` (one grid row per block, the fold
axis a sequential accumulate) and ``fold_decoupled`` (split-KV: chunks of
the fold axis in parallel, each publishing its partial payload, then
``fold_chain`` and the finalize).

A schedule launches the CUDA kernels of ``cuda.py`` (element specs) or
``cuda_fold.py`` (the attention fold) when its operands lie on a CUDA
device, and runs the plain PyTorch versions below when they lie on the
CPU. There is no fallback between the two: a CUDA tensor goes through a
kernel or raises.

The plain versions keep the reference's association order exactly, so
they are bitwise equal to the reference and to the kernels, floats
included: carry, decoupled and fused share one in-tile network and one
left-to-right chain, so they are bitwise equal to each other on any
data; tree associates differently inside a tile and agrees with them
bitwise on exact data and to rounding error otherwise. The fold versions
keep the reference's order of combines, but their dot products (torch
matmuls) and the kernels' (FMA loops) associate differently, so folds
agree with the reference and the kernels to rounding error; kernel
against kernel they are bitwise where the reference's tests are (bounds
on and off, the page map).
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.scan import policy
from repro_torch.core.scan.assoc import KernelSpec
from repro_torch.kernels.scan_engine import cuda, cuda_fold
from repro_torch.obs import trace

LANES = 128

SCHEDULES = ("carry", "decoupled", "fused", "tree")
RESOLVABLE = SCHEDULES + ("auto",)


def resolve_schedule(schedule: str, batch: int, n: int, block_elems: int,
                     cores: int = policy.NUM_CORES) -> str:
    """'auto' -> the policy's four-way rule; else validate.

    ``block_elems`` is the chunk length the kernel will actually tile the
    scanned axis with; ``cores`` the SMs (or CPU cores) a launch spreads
    over.
    """
    if schedule not in RESOLVABLE:
        raise ValueError(
            f"unknown schedule {schedule!r}; one of {RESOLVABLE}")
    if schedule == "auto":
        return policy.choose_schedule(batch, n, cores,
                                      block_elems=block_elems)
    return schedule


# ---------------------------------------------------------------------------
# Plain in-tile networks (over one axis; the other axes are independent)
# ---------------------------------------------------------------------------


def _shift(x, k, fill, axis=-1):
    """Shift ``x`` right by ``k`` along ``axis``, filling with the
    identity."""
    axis %= x.dim()
    head = list(x.shape)
    head[axis] = k
    return torch.cat([torch.full(head, fill, dtype=x.dtype, device=x.device),
                      x.narrow(axis, 0, x.shape[axis] - k)], dim=axis)


def shift_one(spec: KernelSpec, leaves, axis=-1):
    """Exclusive shift: one step right, identity-filled (all leaves)."""
    return tuple(_shift(x, 1, f, axis) for x, f in zip(leaves, spec.fills))


def log_scan(spec: KernelSpec, leaves, axis=-1):
    """Hillis–Steele log-step inclusive scan of monoid leaves (§3.1)."""
    n = leaves[0].shape[axis]
    k = 1
    while k < n:
        shifted = tuple(_shift(x, k, f, axis)
                        for x, f in zip(leaves, spec.fills))
        leaves = spec.combine(shifted, leaves)
        k *= 2
    return leaves


def tile_scan(spec: KernelSpec, leaves, axis=-1):
    """In-tile inclusive scan; two-level split on lane-divisible tiles.

    When the scanned axis is the LAST (lane) axis and a multiple of 128
    longer than 128: scan within each 128-lane segment, exclusive-scan
    the segment totals, broadcast-combine ("scan the vector in register,
    broadcast the last element"). Any other axis — the time axis of
    ``Channels`` — takes the plain Hillis–Steele network.
    """
    x0 = leaves[0]
    axis %= x0.dim()
    n = x0.shape[axis]
    if axis == x0.dim() - 1 and n > LANES and n % LANES == 0:
        r = n // LANES
        ts = tuple(x.reshape(x.shape[:-1] + (r, LANES)) for x in leaves)
        ts = log_scan(spec, ts)
        tot = tuple(t[..., LANES - 1] for t in ts)      # per-segment totals
        off = shift_one(spec, log_scan(spec, tot))      # exclusive
        ts = spec.combine(tuple(o[..., None] for o in off), ts)
        return tuple(t.reshape(x.shape) for t, x in zip(ts, leaves))
    return log_scan(spec, leaves, axis)


def _blelloch(spec: KernelSpec, leaves, axis):
    """Recursive pairwise Blelloch sweep; power-of-two length required.

    Up-sweep: ``combine(evens, odds)`` (left argument earlier), recursing
    on the half-length pair totals. Down-sweep: each even slot takes its
    parent's exclusive prefix and each odd slot ``combine(parent,
    old_left)``. Returns ``(exclusive_scan, root_total)``, the total with
    a size-1 ``axis``.
    """
    m = leaves[0].shape[axis]
    if m == 1:
        ident = tuple(torch.full_like(x, f) for x, f in zip(leaves, spec.fills))
        return ident, leaves
    lead = (slice(None),) * axis
    evens = tuple(x[lead + (slice(0, None, 2),)] for x in leaves)
    odds = tuple(x[lead + (slice(1, None, 2),)] for x in leaves)
    parent_excl, total = _blelloch(spec, spec.combine(evens, odds), axis)
    right = spec.combine(parent_excl, evens)   # combine(parent, old_left)

    def merge(left, rt):
        shape = list(left.shape)
        shape[axis] = m
        return torch.stack([left, rt], dim=axis + 1).reshape(shape)

    excl = tuple(merge(l, r) for l, r in zip(parent_excl, right))
    return excl, total


def tree_scan(spec: KernelSpec, leaves, axis=-1):
    """Work-efficient in-tile EXCLUSIVE scan (§3.3 balanced tree).

    Pads ``axis`` to a power of two with the identity, runs the Blelloch
    sweep, and returns ``(exclusive_scan, total)``.
    """
    axis %= leaves[0].dim()
    n = leaves[0].shape[axis]
    m = 1
    while m < n:
        m *= 2
    if m != n:
        def pad(x, f):
            shape = list(x.shape)
            shape[axis] = m - n
            return torch.cat([x, torch.full(shape, f, dtype=x.dtype,
                                            device=x.device)], dim=axis)
        leaves = tuple(pad(x, f) for x, f in zip(leaves, spec.fills))
    excl, total = _blelloch(spec, leaves, axis)
    return tuple(x.narrow(axis, 0, n) for x in excl), total


def exclusive_chain(spec: KernelSpec, totals):
    """Sequential exclusive scan of chunk totals along the chunk axis
    (axis 1 of ``layout.chain_shape``) — the plain version of the
    ``chain`` kernel.

    Left to right from the identity, applying ``combine`` in exactly the
    carry schedule's order: what makes decoupled bit-identical to carry.
    """
    carry = tuple(torch.full_like(t[:, 0], f)
                  for t, f in zip(totals, spec.fills))
    offs = []
    for j in range(totals[0].shape[1]):
        offs.append(carry)
        carry = spec.combine(carry, tuple(t[:, j] for t in totals))
    if not offs:
        return tuple(torch.empty_like(t) for t in totals)
    return tuple(torch.stack([o[i] for o in offs], dim=1)
                 for i in range(len(totals)))


# ---------------------------------------------------------------------------
# Plain versions of the kernels
# ---------------------------------------------------------------------------

# Axis of a tile's positions in ``layout.tile_shape`` (axis 1 is the chunk).
_POS = 2


def _tiles(spec, operands, layout):
    """Operands in ``layout.tile_shape`` in the accumulation dtypes."""
    dts = spec.elem_dtypes(tuple(o.dtype for o in operands))
    return tuple(o.reshape(layout.tile_shape).to(dt)
                 for o, dt in zip(operands, dts))


def _emit(spec, operands, layout, elems, combined):
    """The outputs: ``spec.emit`` (the mask's fused select) or the
    emitted leaves, cast to the output dtypes."""
    dts = spec.out_dtypes(tuple(o.dtype for o in operands))
    if spec.emit is not None:
        outs = spec.emit(elems, combined)
    else:
        outs = tuple(combined[i] for i in spec.out_leaves)
    return tuple(o.reshape(layout.shape).to(dt) for o, dt in zip(outs, dts))


def _select(spec, scanned, exclusive):
    return shift_one(spec, scanned, _POS) if exclusive else scanned


def _last(leaves):
    """Each tile's last position: a ``chain_shape`` tensor per leaf."""
    return tuple(s.select(_POS, -1) for s in leaves)


def _offset(spec, offsets, sel):
    """combine(offset, sel) with the offset as the EARLIER operand."""
    return spec.combine(tuple(o.unsqueeze(_POS) for o in offsets), sel)


def _with_totals(outs, running, return_totals):
    return (outs, running) if return_totals else outs


def totals_plain(operands, spec, layout):
    """Plain ``totals``: the last element of each tile's network."""
    return _last(tile_scan(spec, _tiles(spec, operands, layout), _POS))


def _window_tree(spec, leaves, axis, slots):
    """The balanced tree over ``slots`` (a power of two) slots along
    ``axis``: the identity in the first, the leaves in the rest. Over the
    2^ceil(log2 n) slots ending at position n - 1 it is the last element
    of ``log_scan`` without the scan (an identity slot gives the network's
    bits: I ⊕ I = I, and I ⊕ y is the network's own identity combine).
    Returns the leaves with ``axis`` removed."""
    axis %= leaves[0].dim()
    pad = slots - leaves[0].shape[axis]
    if pad:
        head = list(leaves[0].shape)
        head[axis] = pad
        leaves = tuple(torch.cat([torch.full(head, f, dtype=x.dtype,
                                             device=x.device), x], axis)
                       for x, f in zip(leaves, spec.fills))
    while leaves[0].shape[axis] > 1:
        pairs = tuple(x.unflatten(axis, (-1, 2)) for x in leaves)
        leaves = spec.combine(tuple(p.select(axis + 1, 0) for p in pairs),
                              tuple(p.select(axis + 1, 1) for p in pairs))
    return tuple(x.squeeze(axis) for x in leaves)


def _pow2_at_least(n):
    return 1 << (n - 1).bit_length()


def totals_tree_plain(operands, spec, layout):
    """``totals_plain``'s bits without the scan: the tree of combines that
    makes the last element of ``tile_scan``, the association the CUDA
    ``totals_reduce_kernel`` builds. On a lane-divisible tile (the last
    axis, a multiple of 128 longer than 128): each 128-segment's total,
    then the Hillis–Steele value at r − 2 over the r segment totals (the
    tree over the 2^ceil(log2 r) slots ending at segment r − 2), ⊕ the
    last segment's total; otherwise the tree over the 2^ceil(log2 n)
    slots ending at the tile's last element. Tests use it; the schedules
    never do."""
    elems = _tiles(spec, operands, layout)
    n = elems[0].shape[_POS]
    if _POS == elems[0].dim() - 1 and n > LANES and n % LANES == 0:
        r = n // LANES
        segs = tuple(x.unflatten(_POS, (r, LANES)) for x in elems)
        tot = _window_tree(spec, segs, -1, LANES)
        head = _window_tree(spec, tuple(t[..., :-1] for t in tot), -1,
                            _pow2_at_least(r))
        return spec.combine(head, tuple(t[..., -1] for t in tot))
    return _window_tree(spec, elems, _POS, _pow2_at_least(n))


def _lanes_up(spec, leaves, d):
    """Each leaf (..., lanes, regs) shifted d lanes up, the identity in
    the d lanes at the bottom: ``__shfl_up_sync`` with the padding."""
    return tuple(_shift(x, d, f, axis=-2) for x, f in zip(leaves, spec.fills))


def _warp_hs4(spec, x, n):
    """Hillis–Steele over a warp's 128 slots (..., 32 lanes, 4 registers),
    lane l holding slots 4l .. 4l + 3, steps k = 1, 2, 4, ... below n:
    the CUDA ``warp_hs4``. Steps 1 and 2 take the lane below's last one or
    two registers, steps 4d the same register d lanes below."""
    def cat(a, b):
        return tuple(torch.cat([p, q], -1) for p, q in zip(a, b))
    if n > 1:
        x = spec.combine(cat(_lanes_up(spec, tuple(v[..., 3:] for v in x), 1),
                             tuple(v[..., :3] for v in x)), x)
    if n > 2:
        x = spec.combine(cat(_lanes_up(spec, tuple(v[..., 2:] for v in x), 1),
                             tuple(v[..., :2] for v in x)), x)
    d = 1
    while d < 32 and 4 * d < n:
        x = spec.combine(_lanes_up(spec, x, d), x)
        d *= 2
    return x


def _upper(spec, tot, known, r):
    """The CUDA ``Upper``: Hillis–Steele over a tile's r segment totals
    (..., r), of which the first ``known`` are in (the rest identity), a
    slot a lane up to 32 totals and four a lane above. Returns the slots
    (..., r)."""
    slots = 32 if r <= 32 else 128
    pad = tuple(torch.cat([t[..., :known], torch.full(
        t.shape[:-1] + (slots - known,), f, dtype=t.dtype,
        device=t.device)], -1) for t, f in zip(tot, spec.fills))
    if r <= 32:
        x = tuple(p[..., None] for p in pad)        # (..., 32 lanes, 1)
        d = 1
        while d < r:
            x = spec.combine(_lanes_up(spec, x, d), x)
            d *= 2
    else:
        x = _warp_hs4(spec, tuple(p.unflatten(-1, (32, 4)) for p in pad), r)
    return tuple(v.flatten(-2)[..., :r] for v in x)


def tile_scan_warps(spec, leaves, exclusive=False, round_segs=16):
    """``tile_scan`` over the last axis (a multiple of 128) as the CUDA
    register network organizes it (``carry_reg_kernel``,
    ``fused_reg_kernel``): segments as (segment, lane, register), the
    in-segment Hillis–Steele by shifts across lanes (``_warp_hs4``), the
    segment totals' Hillis–Steele in rounds of ``round_segs`` segments (a
    block's warps times the segments each holds), each round seeing only
    the totals up to its own, the broadcast combine with the segment's
    exclusive offset on the left (none for one segment), and the exclusive
    form's neighbour from the lane below or the previous segment. Returns the inclusive network, or its exclusive shift.
    Tests use it; the schedules never do."""
    n = leaves[0].shape[-1]
    r = n // LANES
    seg = _warp_hs4(spec, tuple(x.unflatten(-1, (r, 32, 4)) for x in leaves),
                    LANES)
    tot = tuple(v[..., 31, 3] for v in seg)                      # (..., r)
    offs, prevs = [], []
    for s in range(-(-r // round_segs)):
        up = _upper(spec, tot, min(r, (s + 1) * round_segs), r)
        ident = tuple(torch.full_like(u[..., 0], f)
                      for u, f in zip(up, spec.fills))
        for q in range(s * round_segs, min(r, (s + 1) * round_segs)):
            offs.append(tuple(u[..., q - 1] for u in up) if q else ident)
            prevs.append(spec.combine(
                tuple(u[..., q - 2] for u in up) if q > 1 else ident,
                tuple(t[..., q - 1] for t in tot)) if q and r > 1 else ident)

    def per_segment(xs):    # (..., r, 1, 1) per leaf
        return tuple(torch.stack([x[i] for x in xs], -1)[..., None, None]
                     for i in range(len(leaves)))
    full = spec.combine(per_segment(offs), seg) if r > 1 else seg
    if exclusive:   # lane l's first takes lane l - 1's last, lane 0 prev
        below = tuple(torch.cat([p, v[..., :-1, 3:]], -2)
                      for p, v in zip(per_segment(prevs), full))
        full = tuple(torch.cat([b, v[..., :3]], -1)
                     for b, v in zip(below, full))
    return tuple(v.flatten(-3) for v in full)


_LANE = torch.arange(32)


def _where(mask, a, b):
    return tuple(torch.where(mask, p, q) for p, q in zip(a, b))


def tile_scan_chan_warps(spec, leaves, exclusive=False):
    """``tile_scan`` of ``Channels`` tiles (time on axis -2, channels
    last) as the CUDA ``carry_chan_reg_kernel`` organizes a channel's
    tile of bt steps: (..., slots, lanes, channels) with lanes = min(bt,
    32), lane l holding steps l + 32·slot. Hillis–Steele step k < lanes
    takes step i − k from lane l − k of the same slot, or for l < k from
    the slot below (the lanes rotated by k: ``__shfl_sync`` from (l − k)
    mod 32), the identity in slot 0; step k = lanes·m takes slot − m of
    the same lane, the identity below m. Returns the inclusive network,
    or its exclusive shift (lane l − 1's value, lane 0 the slot below's
    last lane). Tests use it; the schedules never do."""
    bt = leaves[0].shape[-2]
    lanes = min(bt, 32)
    x = tuple(v.unflatten(-2, (bt // lanes, lanes)) for v in leaves)
    lane = torch.arange(lanes)[:, None]

    def below(xs, k):   # step i − k, k < lanes
        rot = tuple(torch.roll(v, k, -2) for v in xs)
        prev = tuple(torch.cat([torch.full_like(r[..., :1, :, :], f),
                                r[..., :-1, :, :]], -3)
                     for r, f in zip(rot, spec.fills))
        return _where(lane >= k, rot, prev)

    k = 1
    while k < lanes:
        x = spec.combine(below(x, k), x)
        k *= 2
    m = 1
    while m < bt // lanes:
        x = spec.combine(tuple(torch.cat([torch.full_like(v[..., :m, :, :], f),
                                          v[..., :-m, :, :]], -3)
                               for v, f in zip(x, spec.fills)), x)
        m *= 2
    if exclusive:
        x = below(x, 1)
    return tuple(v.flatten(-3, -2) for v in x)


def _lanes_xor(leaves, d):
    """Each leaf (..., 32 lanes) read from lane l ^ d: ``__shfl_xor_sync``."""
    return tuple(x.index_select(-1, _LANE ^ d) for x in leaves)


def _tree_up(spec, x, n):
    """The CUDA ``tree_up`` on leaves (..., 32 lanes, 4 registers), lane l
    holding slots 4l .. 4l + 3 of 128: the Blelloch up-sweep, levels 1 and
    2 in the lane, then across lanes (the right lane of each pair takes
    ``combine(left, right)``). Returns the in-place values of slots 4l + 1
    and 4l + 3 (``a1``, ``u``: (..., 32) per leaf) and the total of slots
    [0, n) (n a power of two up to 128)."""
    xs = [tuple(v[..., j] for v in x) for j in range(4)]
    a1 = spec.combine(xs[0], xs[1])
    u = spec.combine(a1, spec.combine(xs[2], xs[3]))
    top = xs[0] if n == 1 else a1 if n == 2 else u
    d = 1
    while d < 32:
        u = _where((_LANE & (2 * d - 1)) == 2 * d - 1,
                   spec.combine(_lanes_xor(u, d), u), u)
        if 8 * d == n:
            top = u
        d *= 2
    root = tuple(t[..., n // 4 - 1 if n >= 8 else 0] for t in top)
    return a1, u, root


def _tree_down(spec, x, a1, u, top):
    """The CUDA ``tree_down``: from ``top`` (the exclusive value of the 128
    slots' root, one per leading index) at lane 31, each right lane takes
    ``combine(parent, left total)`` and each left lane the parent's value,
    stride 16 down to 1; then the lane's pairs and slots. Returns the
    exclusive values (..., 32, 4) per leaf."""
    u = _where(_LANE == 31, tuple(t[..., None] for t in top), u)
    d = 16
    while d >= 1:
        v = _lanes_xor(u, d)
        k = (_LANE + 1) & (2 * d - 1)
        u = _where(k == 0, spec.combine(u, v), _where(k == d, v, u))
        d //= 2
    x0, x2 = (tuple(v[..., j] for v in x) for j in (0, 2))
    e23 = spec.combine(u, a1)
    e = (u, spec.combine(u, x0), e23, spec.combine(e23, x2))
    return tuple(torch.stack([ej[i] for ej in e], -1) for i in range(len(x)))


def tree_scan_warps(spec, leaves, round_segs=16):
    """``tree_scan`` over the last axis (a multiple of 128) as the CUDA
    ``tree_reg_kernel`` organizes it: the tile padded to 128·pow2(r) slots
    is one Blelloch tree whose lower levels are the 128-element segments'
    trees, a segment as (lane, register) with the levels above the lane by
    shifts across lanes (``_tree_up`` / ``_tree_down``), and whose upper
    levels are the tree over the segment roots padded with identity roots
    to pow2(r) slots, run in rounds of ``round_segs`` segments (a block's
    warps times the segments each holds), each round seeing only the roots
    up to its own. Returns ``(exclusive scan, total)`` as ``tree_scan``
    does. Tests use it; the schedules never do."""
    n = leaves[0].shape[-1]
    r = n // LANES
    segs = tuple(x.unflatten(-1, (r, 32, 4)) for x in leaves)
    a1, u, _ = _tree_up(spec, segs, LANES)
    roots = tuple(v[..., 31] for v in u)                     # (..., r)
    slots = _pow2_at_least(r)
    ident = tuple(torch.full_like(t[..., 0], f)
                  for t, f in zip(roots, spec.fills))
    tops = []
    for s in range(-(-r // round_segs)):
        known = min(r, (s + 1) * round_segs)
        xs = tuple(torch.cat([t[..., :known], torch.full(
            t.shape[:-1] + (LANES - known,), f, dtype=t.dtype,
            device=t.device)], -1).unflatten(-1, (32, 4))
            for t, f in zip(roots, spec.fills))
        ra1, ru, total = _tree_up(spec, xs, slots)
        excl = _tree_down(spec, xs, ra1, ru, ident)
        tops += [tuple(e.flatten(-2)[..., q] for e in excl)
                 for q in range(s * round_segs, known)]
    top = tuple(torch.stack([t[i] for t in tops], -1)
                for i in range(len(leaves)))                 # (..., r)
    excl = _tree_down(spec, segs, a1, u, top)
    return (tuple(e.flatten(-3) for e in excl),
            tuple(t[..., None] for t in total))


def tree_scan_chan_warps(spec, leaves):
    """``tree_scan`` of ``Channels`` tiles along time (axis -2, channels
    last; bt = 32·NS steps, a multiple of 32) as the CUDA
    ``tree_chan_reg_kernel`` organizes a channel's tile: (..., NS slots,
    32 lanes, channels), lane l holding steps l + 32·slot. The five lowest
    levels of the up-sweep across lanes within each slot (the right lane
    of a pair takes ``combine(left, right)``), the upper levels of both
    sweeps over lane 31's slot roots (the root is the up-sweep's total,
    then the identity at the top), the five lowest levels of the
    down-sweep across lanes (the left lane takes the parent, the right
    ``combine(parent, old left)``). Returns ``(exclusive scan, total)`` as
    ``tree_scan(spec, leaves, -2)`` does. Tests use it; the schedules never
    do."""
    bt = leaves[0].shape[-2]
    ns = bt // 32
    x = tuple(v.unflatten(-2, (ns, 32)) for v in leaves)
    lane = torch.arange(32)[:, None]

    def lanes_xor(xs, d):
        return tuple(v.index_select(-2, _LANE ^ d) for v in xs)

    d = 1
    while d < 32:
        x = _where((lane & (2 * d - 1)) == 2 * d - 1,
                   spec.combine(lanes_xor(x, d), x), x)
        d *= 2
    roots = [tuple(v[..., s, 31, :] for v in x) for s in range(ns)]
    h = 1
    while h < ns:
        for s in range(2 * h - 1, ns, 2 * h):
            roots[s] = spec.combine(roots[s - h], roots[s])
        h *= 2
    total = roots[-1]
    roots[-1] = tuple(torch.full_like(t, f) for t, f in zip(total, spec.fills))
    h = ns // 2
    while h >= 1:
        for s in range(2 * h - 1, ns, 2 * h):
            parent, old_left = roots[s], roots[s - h]
            roots[s - h], roots[s] = parent, spec.combine(parent, old_left)
        h //= 2
    top = tuple(torch.stack([r[i] for r in roots], -2)[..., None, :]
                for i in range(len(leaves)))                 # (..., ns, 1, D)
    x = _where(lane == 31, top, x)
    d = 16
    while d >= 1:
        other = lanes_xor(x, d)
        k = (torch.arange(32)[:, None] + 1) & (2 * d - 1)
        x = _where(k == 0, spec.combine(x, other), _where(k == d, other, x))
        d //= 2
    return (tuple(v.flatten(-3, -2) for v in x),
            tuple(t.unsqueeze(-2) for t in total))


def apply_plain(operands, offsets, spec, layout, exclusive=False):
    """Plain ``apply``: rescan each tile and combine its chunk offset."""
    elems = _tiles(spec, operands, layout)
    sel = _select(spec, tile_scan(spec, elems, _POS), exclusive)
    return _emit(spec, operands, layout, elems, _offset(spec, offsets, sel))


def decoupled_plain(operands, spec, layout, exclusive=False,
                    return_totals=False):
    """Plain decoupled: totals, the exclusive chain, apply. The running
    chunk totals are ``offsets ⊕ totals`` — carry's per-chunk carries."""
    totals = totals_plain(operands, spec, layout)
    offsets = exclusive_chain(spec, totals)
    outs = apply_plain(operands, offsets, spec, layout, exclusive)
    return _with_totals(outs, spec.combine(offsets, totals), return_totals)


def carry_plain(operands, spec, layout, exclusive=False, return_totals=False):
    """Plain ``carry``: each tile's network, combined with the running
    carry of the tiles before it (carry = carry ⊕ last, from the
    identity, left to right). ``return_totals`` adds the running chunk
    totals (the carry after each chunk) per element leaf."""
    elems = _tiles(spec, operands, layout)
    scanned = tile_scan(spec, elems, _POS)
    lasts = _last(scanned)
    carries = exclusive_chain(spec, lasts)
    sel = _select(spec, scanned, exclusive)
    outs = _emit(spec, operands, layout, elems, _offset(spec, carries, sel))
    return _with_totals(outs, spec.combine(carries, lasts), return_totals)


def fused_plain(operands, spec, layout, exclusive=False, return_totals=False):
    """Plain ``fused``: the single-launch chained scan, chunk by chunk in
    ``_fused_body``'s order. Each chunk scans its tile, takes the
    inclusive prefix its predecessor published (the identity for chunk
    0), publishes ``combine(prefix, total)`` for its successor and emits
    ``combine(prefix, sel)``. ``return_totals`` runs decoupled, as the
    reference routes it."""
    if return_totals or layout.num_seq_blocks == 0:
        return decoupled_plain(operands, spec, layout, exclusive,
                               return_totals)
    elems = _tiles(spec, operands, layout)
    scanned = tile_scan(spec, elems, _POS)
    sel = _select(spec, scanned, exclusive)
    lasts = _last(scanned)
    prefix = tuple(torch.full_like(t[:, 0], f)
                   for t, f in zip(lasts, spec.fills))
    chunks = []
    for j in range(layout.num_seq_blocks):
        chunks.append(spec.combine(tuple(p.unsqueeze(1) for p in prefix),
                                   tuple(s[:, j] for s in sel)))
        prefix = spec.combine(prefix, tuple(t[:, j] for t in lasts))
    combined = tuple(torch.stack([c[i] for c in chunks], dim=1)
                     for i in range(spec.n_leaves))
    return _emit(spec, operands, layout, elems, combined)


def tree_plain(operands, spec, layout, exclusive=False, return_totals=False):
    """Plain ``tree``: the Blelloch network per tile; the carry advances
    by each tile's root."""
    elems = _tiles(spec, operands, layout)
    excl, total = tree_scan(spec, elems, _POS)
    sel = excl if exclusive else spec.combine(excl, elems)
    roots = tuple(t.select(_POS, 0) for t in total)
    carries = exclusive_chain(spec, roots)
    outs = _emit(spec, operands, layout, elems, _offset(spec, carries, sel))
    return _with_totals(outs, spec.combine(carries, roots), return_totals)


PLAIN = {"carry": carry_plain, "decoupled": decoupled_plain,
         "fused": fused_plain, "tree": tree_plain}


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------


def _on_cuda(operands) -> bool:
    return any(o.is_cuda for o in operands)


def fused_native_available() -> bool:
    """Whether the single-launch fused kernel can run here: False off
    CUDA; on a CUDA device, whether the kernel library is there (built
    now, or found built, from ``csrc/scan_sum.cu``)."""
    if not torch.cuda.is_available():
        return False
    try:
        cuda.build()
    except RuntimeError:
        return False
    return True


def scan_carry(operands, spec, layout, *, exclusive=False,
               return_totals=False):
    if _on_cuda(operands):
        outs, running = cuda.carry(spec, operands, layout, exclusive,
                                   return_totals)
        return _with_totals(outs, running, return_totals)
    return carry_plain(operands, spec, layout, exclusive, return_totals)


def scan_decoupled(operands, spec, layout, *, exclusive=False,
                   return_totals=False):
    if _on_cuda(operands):
        offsets, running = cuda.chain(spec, cuda.totals(spec, operands, layout),
                                      return_totals)
        outs = cuda.apply(spec, operands, offsets, layout, exclusive)
        return _with_totals(outs, running, return_totals)
    return decoupled_plain(operands, spec, layout, exclusive, return_totals)


def scan_fused(operands, spec, layout, *, exclusive=False,
               return_totals=False):
    """Single-launch decoupled: one kernel whose chunks chain their
    prefixes through a look-back (read n + write n). ``return_totals``
    runs the two-launch decoupled form, as the reference routes it: the
    running totals come from decoupled's chain."""
    if return_totals:
        return scan_decoupled(operands, spec, layout, exclusive=exclusive,
                              return_totals=True)
    if _on_cuda(operands):
        return cuda.fused(spec, operands, layout, exclusive)
    return fused_plain(operands, spec, layout, exclusive)


def scan_tree(operands, spec, layout, *, exclusive=False,
              return_totals=False):
    if _on_cuda(operands):
        outs, running = cuda.tree(spec, operands, layout, exclusive,
                                  return_totals)
        return _with_totals(outs, running, return_totals)
    return tree_plain(operands, spec, layout, exclusive, return_totals)


# ---------------------------------------------------------------------------
# Carried-payload fold schedules (spec.transform monoids)
# ---------------------------------------------------------------------------


def fold_chain(spec: KernelSpec, totals, axis: int = 1):
    """Sequential INCLUSIVE fold of chunk elements along ``axis`` — the
    plain version of the ``fold_chain`` kernel (without its finalize).

    Left to right from the monoid identity — the same association order
    as the fold-carry chain, so the decoupled fold re-associates only at
    chunk boundaries.
    """
    carry = tuple(torch.full_like(t.select(axis, 0), f)
                  for t, f in zip(totals, spec.fills))
    for c in range(totals[0].shape[axis]):
        carry = spec.combine(carry, tuple(t.select(axis, c) for t in totals))
    return carry


def _fold_dtypes(spec, operands):
    dts = tuple(o.dtype for o in operands)
    return spec.elem_dtypes(dts), spec.out_dtypes(dts)


def _fold_identity(spec, layout, elem_dts, device):
    """The identity payload carries, one (batch_shape, tile_rows, leaf_dim)
    tensor per leaf."""
    return tuple(
        torch.full(layout.batch_shape + (layout.tile_rows,
                                         layout.leaf_dim(i)),
                   f, dtype=dt, device=device)
        for i, (f, dt) in enumerate(zip(spec.fills, elem_dts)))


def _fold_step(spec, layout, operands, carry, elem_dts, f):
    """One fold position for every grid row at once — transform,
    combine (the carry is the EARLIER operand), gated on the layout's
    KV-extent liveness when bounds are on. Returns the new carry and the
    liveness (``None`` without bounds): a skipped cell keeps its carry,
    which is bitwise equal to folding in the monoid identity its
    fully-masked transform would have produced."""
    device = operands[0].device
    ids = layout.block_ids(f, device)
    elem = spec.transform(layout.op_tiles(operands, f), ids)
    elem = tuple(e.to(dt) for e, dt in zip(elem, elem_dts))
    new = spec.combine(carry, elem)
    active = layout.fold_active(ids)
    if active is None:
        return new, None
    active = torch.as_tensor(active, device=device).expand(
        layout.batch_shape)[..., None, None]
    return tuple(torch.where(active, n, c) for n, c in zip(new, carry)), \
        active


def _fold_outputs(spec, layout, final, out_dts):
    outs = spec.finalize(final)
    return tuple(layout.unchain_out(o).to(dt) for o, dt in zip(outs, out_dts))


def fold_carry_plain(operands, spec, layout, count_cells=False):
    """Plain ``fold_carry``: every grid row's carry walks the fold axis
    left to right from the identity, vectorized over the rows (the
    (head, q-block) pairs of ``KVBlocks``, the (kv head, KV block) pairs
    of ``QBlocks``). Returns the outputs, and with ``count_cells`` the
    int32 ``layout.count_shape`` counts of the cells that ran."""
    layout.check_ops(len(operands))
    elem_dts, out_dts = _fold_dtypes(spec, operands)
    device = operands[0].device
    carry = _fold_identity(spec, layout, elem_dts, device)
    counts = torch.zeros(layout.batch_shape, dtype=torch.int32, device=device)
    for f in range(layout.num_seq_blocks):
        carry, active = _fold_step(spec, layout, operands, carry, elem_dts, f)
        counts += 1 if active is None else active[..., 0, 0].to(torch.int32)
    outs = _fold_outputs(spec, layout, carry, out_dts)
    return (outs, counts) if count_cells else outs


def fold_totals_plain(operands, spec, layout):
    """Plain split-fold pass: each of ``layout.splits`` chunks of the fold
    axis folds its blocks from the identity; returns one
    ``layout.chain_shape_for(leaf)`` tensor per leaf."""
    layout.check_ops(len(operands))
    elem_dts, _ = _fold_dtypes(spec, operands)
    device = operands[0].device
    parts = []
    for c in range(layout.splits):
        carry = _fold_identity(spec, layout, elem_dts, device)
        for s in range(layout.blocks_per_chunk):
            carry, _ = _fold_step(spec, layout, operands, carry, elem_dts,
                                  c * layout.blocks_per_chunk + s)
        parts.append(carry)
    return tuple(
        torch.stack([p[i] for p in parts], dim=2).reshape(
            layout.chain_shape_for(i))
        for i in range(spec.n_leaves))


def fold_finalize_plain(spec, layout, totals, out_dts):
    """Plain ``fold_chain`` kernel: the inclusive chain over the chunk
    axis, then the spec's finalize, cast to the output dtypes."""
    return _fold_outputs(spec, layout, fold_chain(spec, totals), out_dts)


def fold_decoupled_plain(operands, spec, layout):
    """Plain ``fold_decoupled``: the split-fold pass, the chain, the
    finalize."""
    _, out_dts = _fold_dtypes(spec, operands)
    return fold_finalize_plain(spec, layout,
                               fold_totals_plain(operands, spec, layout),
                               out_dts)


def fold_carry(operands, spec, layout, *, count_cells=False):
    """Single-pass accumulate of a carried-payload monoid (flash fwd).

    ``count_cells=True`` appends an int32 ``layout.count_shape`` tensor
    counting the fold cells that actually executed per grid row — the
    instrumentation behind the causal-bound "runs ~half the cells"
    assertion.
    """
    if _on_cuda(operands):
        outs, counts = cuda_fold.fold(spec, operands, layout, count_cells)
        return (outs, counts) if count_cells else outs
    return fold_carry_plain(operands, spec, layout, count_cells)


def fold_decoupled(operands, spec, layout):
    """Split-KV fold: parallel chunk accumulates + a combine chain.

    The flash-decoding organization: one launch runs the fold-carry body
    over each of ``layout.splits`` chunks of the fold axis in parallel,
    publishing one payload element per chunk; the chain kernel stitches
    the chunks left to right (the carry chain's association at chunk
    granularity) and finalizes.
    """
    if _on_cuda(operands):
        totals = cuda_fold.fold_totals(spec, operands, layout)
        return cuda_fold.chain(spec, totals, layout,
                               _fold_dtypes(spec, operands)[1])
    return fold_decoupled_plain(operands, spec, layout)


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------


def _launch_event(operands, spec: KernelSpec, layout, schedule: str,
                  return_totals: bool) -> None:
    """Record a ``kernel.launch`` trace event with the reference's fields:
    monoid, schedule, grid, one tile's bytes (``vmem_block_bytes_est``,
    the shared-memory working set here) and the schedule's device-memory
    traffic (read/write bytes). Costs one attribute check when tracing is
    disabled."""
    if not trace.enabled():
        return
    in_bytes = sum(o.numel() * o.element_size() for o in operands)
    if spec.transform is not None:
        _fold_launch_event(operands, spec, layout, schedule, in_bytes)
        return
    tile_bytes = sum(math.prod(layout.block_shape) * o.element_size()
                     for o in operands)
    out_dts = spec.out_dtypes(tuple(o.dtype for o in operands))
    out_bytes = sum(math.prod(layout.shape) * dt.itemsize for dt in out_dts)
    # decoupled's totals pass re-reads the data; fused reads it once,
    # unless return_totals sends it to decoupled.
    two_pass = schedule == "decoupled" or (schedule == "fused"
                                           and return_totals)
    trace.instant(
        "kernel.launch", monoid=spec.name, schedule=schedule, fold=False,
        grid=list(layout.grid), vmem_block_bytes_est=tile_bytes,
        hbm_read_bytes_est=2 * in_bytes if two_pass else in_bytes,
        hbm_write_bytes_est=out_bytes)


def _fold_launch_event(operands, spec, layout, schedule, in_bytes):
    """The fold branch of ``_launch_event``: the split grid for the
    decoupled fold, one cell's operand tiles, the data read once and the
    outputs written once."""
    split = schedule not in ("carry", "tree")
    tile_bytes = sum(math.prod(layout.op_block_shape(kind)) * o.element_size()
                     for kind, o in zip(layout.op_kinds, operands))
    _, out_dts = _fold_dtypes(spec, operands)
    out_bytes = sum(math.prod(layout.out_shape_for(i)) * dt.itemsize
                    for i, dt in enumerate(out_dts))
    trace.instant(
        "kernel.launch", monoid=spec.name, schedule=schedule, fold=True,
        grid=list(layout.split_grid if split else layout.grid),
        vmem_block_bytes_est=tile_bytes, hbm_read_bytes_est=in_bytes,
        hbm_write_bytes_est=out_bytes)


def scan(operands, spec: KernelSpec, layout, *, schedule: str = "carry",
         exclusive: bool = False, return_totals: bool = False,
         count_cells: bool = False):
    """Run ``spec``'s monoid scan over ``operands`` under one schedule.

    Returns a tuple of output tensors (every registration here emits
    one). ``return_totals=True`` additionally returns the running
    chunk-totals chain (one ``layout.chain_shape`` tensor per element
    leaf, combined through chunk ``j``), bitwise equal under every
    schedule, so callers derive row aggregates in O(rows · chunks)
    instead of re-reducing the data.

    Carried-payload monoids (``spec.transform``) run the fold forms of
    the schedules; ``fused`` maps to the decoupled fold there (a fold has
    no per-element writeback to chain a prefix into) and ``tree`` to the
    carry fold (a fold consumes one macro element per block — there is no
    in-block element axis for the tree sweep to reorganize).
    ``count_cells=True`` (carry fold only) additionally returns the
    executed-cell counts — the causal-bound instrumentation.
    """
    if schedule not in SCHEDULES:
        raise ValueError(
            f"unknown schedule {schedule!r}; one of {SCHEDULES}")
    if exclusive and not spec.supports_exclusive:
        raise ValueError(
            f"monoid {spec.name!r} does not support exclusive mode")
    if count_cells and (spec.transform is None or schedule != "carry"):
        raise ValueError("count_cells instruments the carry fold only")
    _launch_event(operands, spec, layout, schedule, return_totals)
    if spec.transform is not None:
        if return_totals:
            raise ValueError(
                "return_totals is meaningless for carried-payload "
                "monoids: the output IS the fold")
        if schedule in ("carry", "tree"):
            return fold_carry(tuple(operands), spec, layout,
                              count_cells=count_cells)
        return fold_decoupled(tuple(operands), spec, layout)
    fn = {"carry": scan_carry, "decoupled": scan_decoupled,
          "fused": scan_fused, "tree": scan_tree}[schedule]
    return fn(tuple(operands), spec, layout, exclusive=exclusive,
              return_totals=return_totals)
