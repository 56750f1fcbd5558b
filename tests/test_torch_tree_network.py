"""``tree_scan_warps``: the Blelloch tree as the CUDA register kernel
organizes it.

``tree_reg_kernel`` (``csrc/scan_sum.cu``) runs ``tree_scan`` on ``Rows``
tiles of 128·r elements in registers: the tile padded to 128·pow2(r)
slots is one balanced tree, whose lower seven levels are each 128-element
segment's tree (a warp a segment, lane l holding slots 4l .. 4l + 3: two
levels in the lane, five across lanes by shuffles) and whose upper levels
are the tree over the segment roots, padded with identity roots to
pow2(r) slots and run in rounds of segments, each round seeing only the
roots up to its own. ``schedules.tree_scan_warps`` states that
organization in torch ops. Its exclusive scan and its total must be
bitwise equal to the port's ``tree_scan`` and to the reference's, signed
zeros at every segment and tile start included (x ⊕ I turns -0.0 into
+0.0, so a total taken one level too high shows). XLA's CPU runtime
flushes subnormals, so the comparison with the reference runs torch in
flush mode on one thread, as ``test_torch_totals_tree.py`` does. The
reference runs op by op, not under ``jax.jit``: XLA's algebraic
simplifier folds the down-sweep's first combine, identity ⊕ x with a
constant identity, into x, which keeps a -0.0 that the combine as written
turns into +0.0. ``tree_chan_reg_kernel`` runs the affine pair's
``tree_scan`` on ``Channels`` tiles of 128, 256 and 512 steps in carry's
register walk: lane l holds steps l + 32 s of a channel, the five lowest
levels of both sweeps run across lanes within each slot, the upper levels
over lane 31's slot roots in its registers; ``tree_scan_chan_warps``
states that organization, held bitwise against ``tree_scan`` and the
reference's. The kernels themselves are held against ``tree_plain`` on
the card in ``tests/test_torch_cuda_kernels.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_totals_data import affine_channels, operands, same_bits
from repro.kernels.scan_engine import monoids as jax_monoids
from repro.kernels.scan_engine import schedules as jax_schedules
from repro_torch.kernels import scan_engine
from repro_torch.kernels.scan_engine import monoids, schedules

KINDS = ("float32", "bfloat16", "int32", "segsum", "mask")
BLOCKS = (128, 256, 2048, 2176, 8192, 16384)
CASES = [(k, bn) for k in KINDS for bn in BLOCKS]
IDS = [f"{k}-bn{bn}" for k, bn in CASES]


def _leaves(kind, bn, seed):
    """(spec, jax spec, accumulation-dtype leaves) of two rows of two
    tiles, as (4, bn) tiles: adversarial values (the first tile all -0.0,
    a signed zero at every other tile start and -0.0 at every segment
    start, subnormals, cancelling pairs), segmented flags that are
    negative or not 0/1."""
    n = 2 * bn
    x = operands("float32" if kind == "segsum" else kind, 2, n, bn, seed)
    if x.dtype.is_floating_point:
        starts = torch.zeros(n, dtype=torch.bool)
        starts[::128] = True
        starts[::bn] = False
        x[:, starts] = -0.0
    if kind == "segsum":
        rng = np.random.default_rng(seed + 1)
        f = np.where(rng.random((2, n)) < 0.03, rng.choice([-3, 1, 2], (2, n)),
                     0).astype(np.int32)
        f[:, ::bn] = 0           # a tile starting with -0.0 and no flag
        ops = (x, torch.from_numpy(f))
        spec, jspec = monoids.SEGMENTED_SUM, jax_monoids.SEGMENTED_SUM
    elif kind == "mask":
        ops = (x,)
        spec, jspec = monoids.mask(n), jax_monoids.mask(n)
    else:
        ops = (x,)
        spec, jspec = monoids.SUM, jax_monoids.SUM
    lay = scan_engine.Rows(2, n, 1, bn)
    tiles = schedules._tiles(spec, ops, lay)
    return spec, jspec, tuple(t.reshape(-1, bn) for t in tiles)


def _all_same(got, want):
    return len(got) == len(want) and all(same_bits(g, w)
                                         for g, w in zip(got, want))


@pytest.mark.parametrize("kind,bn", CASES, ids=IDS)
def test_tree_scan_warps_bitwise_vs_tree_scan(kind, bn):
    spec, _, leaves = _leaves(kind, bn, 90)
    excl, total = schedules.tree_scan_warps(spec, leaves)
    w_excl, w_total = schedules.tree_scan(spec, leaves)
    assert _all_same(excl, w_excl)
    assert _all_same(total, w_total)


@pytest.mark.parametrize("round_segs", (1, 3, 8, 128))
@pytest.mark.parametrize("bn", (2176, 16384))
def test_tree_scan_warps_rounds_give_the_same_bits(bn, round_segs):
    """A round sees only the roots up to its own segments: rounds of any
    number of segments give the bits of one round over all of them."""
    for kind in ("float32", "segsum"):
        spec, _, leaves = _leaves(kind, bn, 91)
        got = schedules.tree_scan_warps(spec, leaves, round_segs=round_segs)
        want = schedules.tree_scan(spec, leaves)
        assert _all_same(got[0], want[0]) and _all_same(got[1], want[1]), kind


@pytest.fixture
def flush_denormals():
    """torch's CPU ops in XLA's CPU mode: subnormals read and written as
    zero, on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)
    torch.set_num_threads(threads)


@pytest.mark.parametrize("kind,bn", CASES, ids=IDS)
def test_tree_scan_warps_bitwise_vs_reference(kind, bn, flush_denormals):
    spec, jspec, leaves = _leaves(kind, bn, 92)
    jl = tuple(jnp.asarray(t.numpy()) for t in leaves)
    w_excl, w_total = jax_schedules.tree_scan(jspec, jl, axis=1)
    w_excl = tuple(torch.from_numpy(np.array(w)) for w in w_excl)
    w_total = tuple(torch.from_numpy(np.array(w)) for w in w_total)
    excl, total = schedules.tree_scan_warps(spec, leaves)
    assert _all_same(excl, w_excl) and _all_same(total, w_total)
    excl, total = schedules.tree_scan(spec, leaves)
    assert _all_same(excl, w_excl) and _all_same(total, w_total)


def test_reference_jit_folds_the_identity_combine():
    """Why the reference runs op by op: under ``jax.jit`` XLA rewrites
    0.0 + x as x, so -0.0 stays -0.0; the add itself gives +0.0."""
    x = jnp.asarray(np.array([-0.0], np.float32))
    add = lambda v: jnp.full_like(v, 0.0) + v    # noqa: E731
    assert np.signbit(np.asarray(jax.jit(add)(x)))[0]
    assert not np.signbit(np.asarray(add(x)))[0]


@pytest.mark.parametrize("kind", KINDS)
def test_tree_scan_warps_gives_tree_plain(kind):
    """The emulation's exclusive scan and totals, put through tree's
    carry chain and emission, give ``tree_plain``'s outputs and running
    totals, inclusive and exclusive."""
    bn = 2176
    spec, _, _ = _leaves(kind, bn, 93)
    n = 2 * bn
    x = operands("float32" if kind == "segsum" else kind, 2, n, bn, 93)
    ops = (x,) if kind != "segsum" else (x, (torch.arange(n) % 301 == 7)
                                         .to(torch.int32).expand(2, n))
    lay = scan_engine.Rows(2, n, 1, bn)
    elems = schedules._tiles(spec, ops, lay)
    flat = tuple(t.reshape(-1, bn) for t in elems)
    excl, total = schedules.tree_scan_warps(spec, flat)
    excl = tuple(e.reshape(elems[0].shape) for e in excl)
    roots = tuple(t.reshape(2, -1) for t in total)
    carries = schedules.exclusive_chain(spec, roots)
    for exclusive in ((False, True) if spec.supports_exclusive else (False,)):
        sel = excl if exclusive else spec.combine(excl, elems)
        outs = schedules._emit(spec, ops, lay, elems,
                               schedules._offset(spec, carries, sel))
        w_outs, w_run = schedules.tree_plain(ops, spec, lay, exclusive,
                                             return_totals=True)
        assert _all_same(outs, w_outs), exclusive
        assert _all_same(spec.combine(carries, roots), w_run), exclusive


# The affine tree on Channels tiles of 128, 256 and 512 steps, as the CUDA
# tree_chan_reg_kernel organizes it (schedules.tree_scan_chan_warps: lane
# l holding steps l + 32 s, the five lowest levels across lanes, the upper
# levels over lane 31's slot roots), on gates with negative values and
# ±0.0 and offsets with -0.0 at every tile start (normal), or exact-valued
# gates and offsets (exact).
CHAN_TILES = (128, 256, 512)


def _chan_tiles(bt, exact, seed, chunks=3):
    ops = affine_channels(bt, seed, exact=exact, shape=(2, chunks * bt, 6))
    lay = scan_engine.Channels(2, chunks * bt, 6, bt, 6)
    return ops, lay, schedules._tiles(monoids.AFFINE, ops, lay)


@pytest.mark.parametrize("exact", (False, True), ids=("normal", "exact"))
@pytest.mark.parametrize("bt", CHAN_TILES)
def test_tree_scan_chan_warps_bitwise_vs_tree_scan(bt, exact):
    _, _, tiles = _chan_tiles(bt, exact, 3 * bt + exact)
    excl, total = schedules.tree_scan_chan_warps(monoids.AFFINE, tiles)
    w_excl, w_total = schedules.tree_scan(monoids.AFFINE, tiles, 2)
    assert _all_same(excl, w_excl)
    assert _all_same(total, w_total)


@pytest.mark.parametrize("exact", (False, True), ids=("normal", "exact"))
@pytest.mark.parametrize("bt", CHAN_TILES)
def test_tree_scan_chan_warps_bitwise_vs_reference(bt, exact,
                                                   flush_denormals):
    """The reference's ``tree_scan`` along time (axis 2 of the (B,
    chunks, bt, D) tiles), op by op: under ``jax.jit`` XLA contracts the
    affine combine into an FMA and folds 0.0 + x into x. Op by op, with
    subnormals flushed as XLA's CPU does, the bits agree on normal data
    too, which is more than the reference's own affine tolerance
    (rtol = atol = 2e-4, ``tests/test_kernels.py``) asks; exact data agree
    in any mode."""
    _, _, tiles = _chan_tiles(bt, exact, 5 * bt + exact)
    jl = tuple(jnp.asarray(t.numpy()) for t in tiles)
    w_excl, w_total = jax_schedules.tree_scan(jax_monoids.AFFINE, jl, axis=2)
    w_excl = tuple(torch.from_numpy(np.array(w)) for w in w_excl)
    w_total = tuple(torch.from_numpy(np.array(w)) for w in w_total)
    excl, total = schedules.tree_scan_chan_warps(monoids.AFFINE, tiles)
    for got, want in zip(excl + total, w_excl + w_total):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4,
                                   atol=2e-4)
    assert _all_same(excl, w_excl) and _all_same(total, w_total)


@pytest.mark.parametrize("exclusive", (False, True))
@pytest.mark.parametrize("bt", CHAN_TILES)
def test_tree_chan_network_gives_tree_plain(bt, exclusive):
    """The emulation's exclusive scan and totals, put through tree's carry
    (the carry the LEFT operand, carry = carry ⊕ root) and emission, give
    ``tree_plain``'s outputs and running totals over lanes of four
    tiles."""
    aff = monoids.AFFINE
    ops, lay, tiles = _chan_tiles(bt, False, 7 * bt, chunks=4)
    excl, total = schedules.tree_scan_chan_warps(aff, tiles)
    roots = tuple(t.select(2, 0) for t in total)
    carries = schedules.exclusive_chain(aff, roots)
    sel = excl if exclusive else aff.combine(excl, tiles)
    outs = schedules._emit(aff, ops, lay, tiles,
                           schedules._offset(aff, carries, sel))
    w_outs, w_run = schedules.tree_plain(ops, aff, lay, exclusive,
                                         return_totals=True)
    assert _all_same(outs, w_outs)
    assert _all_same(aff.combine(carries, roots), w_run)
