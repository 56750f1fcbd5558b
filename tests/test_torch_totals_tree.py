"""``totals_tree_plain``: decoupled's chunk totals without the scan.

The CUDA ``totals_reduce_kernel`` (Rows tiles of the sum and the
segmented sum in every dtype and of the compact mask) builds each tile's
total as the tree of combines that makes the last element of the in-tile
network, without running the network. ``totals_tree_plain`` is that
association in torch ops. It must be bitwise equal to ``totals_plain``
(the network's last element) and to the reference's: the last element of
the reference's ``tile_scan`` over the same tiles, which is what its
``_totals_body`` writes. NaNs compare as NaN.

XLA's CPU runtime flushes subnormal floats to zero (inputs and results),
so the comparison with the reference runs the port's plain version with
torch's flush mode on (``torch.set_flush_denormal``, one thread: the mode
is per thread); the comparison with ``totals_plain`` keeps IEEE
subnormals, as the card does. The same holds for the affine pair on
``Channels`` tiles of 128, 256 and 512 steps, whose totals the CUDA
``totals_chan_reduce_kernel`` builds as each channel's balanced tree over
its steps. The kernels themselves are held against both plain versions on
the card in ``tests/test_torch_cuda_kernels.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_totals_data import (BLOCKS, KINDS, TORCH_DTYPES, affine_channels,
                                operands, same_bits)
from repro.kernels.scan_engine import monoids as jax_monoids
from repro.kernels.scan_engine import schedules as jax_schedules
from repro_torch.kernels import scan_engine
from repro_torch.kernels.scan_engine import monoids, schedules

CASES = [(k, bn) for k in KINDS for bn in BLOCKS]
IDS = [f"{k}-bn{bn}" for k, bn in CASES]


def _case(kind, bn, seed):
    """(operand, spec, layout): two rows of three tiles."""
    n = 3 * bn
    x = operands(kind, 2, n, bn, seed)
    spec = monoids.mask(n) if kind == "mask" else monoids.SUM
    return x, spec, scan_engine.Rows(2, n, 1, bn)


@pytest.mark.parametrize("kind,bn", CASES, ids=IDS)
def test_totals_tree_plain_bitwise_vs_totals_plain(kind, bn):
    x, spec, lay = _case(kind, bn, 70)
    (got,) = schedules.totals_tree_plain((x,), spec, lay)
    (want,) = schedules.totals_plain((x,), spec, lay)
    assert tuple(got.shape) == lay.chain_shape
    assert same_bits(got, want)


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


def _reference_totals(x, kind, bn):
    """The last element of the reference's ``tile_scan`` of every tile,
    in the accumulation dtype (as ``_scan_block`` casts it)."""
    jspec = jax_monoids.mask(x.shape[1]) if kind == "mask" \
        else jax_monoids.SUM
    acc = torch.float32 if x.dtype.is_floating_point else torch.int32
    tiles = jnp.asarray(x.to(acc).reshape(-1, bn).numpy())
    last = jax.jit(lambda t: jax_schedules.tile_scan(
        jspec, (t,), axis=1)[0][:, -1])(tiles)
    return torch.from_numpy(np.asarray(last)).reshape(x.shape[0], -1)


@pytest.mark.parametrize("kind,bn", CASES, ids=IDS)
def test_totals_tree_plain_bitwise_vs_reference(kind, bn, flush_denormals):
    x, spec, lay = _case(kind, bn, 71)
    want = _reference_totals(x, kind, bn)
    (got,) = schedules.totals_tree_plain((x,), spec, lay)
    assert got.dtype == want.dtype
    assert same_bits(got, want)
    (net,) = schedules.totals_plain((x,), spec, lay)
    assert same_bits(net, want)


def test_reference_totals_flush_subnormals():
    """Why the reference comparison flushes: XLA's CPU runtime reads a
    subnormal operand as zero."""
    tiny = np.full((1, 2), 1e-40, np.float32)
    assert float(jax.jit(lambda t: t[0, 0] + t[0, 1])(tiny)) == 0.0
    assert float(torch.from_numpy(tiny).sum()) != 0.0


# Other element specs and the Channels layout: the same tree of the
# network's last element (a whole-tile Hillis–Steele along time there).
OTHER = [
    ("segsum-rows", monoids.SEGMENTED_SUM, lambda: scan_engine.Rows(3, 1536, 1, 384)),
    ("segsum-rows-ragged", monoids.SEGMENTED_SUM, lambda: scan_engine.Rows(2, 600, 1, 200)),
    ("affine-channels", monoids.AFFINE, lambda: scan_engine.Channels(2, 384, 8, 96, 8)),
    ("sum-channels", monoids.SUM, lambda: scan_engine.Channels(2, 512, 4, 256, 4)),
]


@pytest.mark.parametrize("name,spec,layout", OTHER, ids=[o[0] for o in OTHER])
def test_totals_tree_plain_other_specs_and_channels(name, spec, layout):
    lay = layout()
    rng = np.random.default_rng(72)
    x = torch.from_numpy(rng.standard_normal(lay.shape).astype(np.float32))
    x[..., ::7] = -0.0
    if spec is monoids.SEGMENTED_SUM:
        ops = (x, torch.from_numpy(
            (rng.random(lay.shape) < 0.05).astype(np.int32)))
    elif spec is monoids.AFFINE:
        ops = (torch.from_numpy(
            rng.uniform(0.5, 1.0, lay.shape).astype(np.float32)), x)
    else:
        ops = (x,)
    got = schedules.totals_tree_plain(ops, spec, lay)
    want = schedules.totals_plain(ops, spec, lay)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == lay.chain_shape
        assert same_bits(g, w)


# The affine pair on Channels at the tiles of the CUDA reduction
# (totals_chan_reduce_kernel): the last element of a whole-tile
# Hillis–Steele along time over a power-of-two tile is each channel's
# balanced tree over its steps, the earlier subtree on the left.
CHAN_TILES = (128, 256, 512)


def _affine_case(bt, exact):
    ops = affine_channels(bt, 5 * bt + exact, exact=exact,
                          shape=(2, 3 * bt, 6))
    return ops, scan_engine.Channels(2, 3 * bt, 6, bt, 6)


@pytest.mark.parametrize("exact", (False, True), ids=("normal", "exact"))
@pytest.mark.parametrize("bt", CHAN_TILES)
def test_totals_tree_plain_affine_channels(bt, exact):
    """Gates with negative values and ±0.0, offsets with −0.0 at every tile
    start: the tree's totals are the network's last elements bit for
    bit, both leaves."""
    ops, lay = _affine_case(bt, exact)
    got = schedules.totals_tree_plain(ops, monoids.AFFINE, lay)
    want = schedules.totals_plain(ops, monoids.AFFINE, lay)
    assert len(got) == 2
    for g, w in zip(got, want):
        assert tuple(g.shape) == lay.chain_shape
        assert same_bits(g, w)


@pytest.mark.parametrize("exact", (False, True), ids=("normal", "exact"))
@pytest.mark.parametrize("bt", CHAN_TILES)
def test_totals_tree_plain_affine_channels_vs_reference(bt, exact,
                                                        flush_denormals):
    """The reference's totals: the last step of its ``tile_scan`` along
    time (axis 2 of the (B, chunks, bt, D) tiles), run op by op — under
    ``jax.jit`` XLA contracts the affine combine into an FMA and folds
    0.0 + x into x. The products of up to 512 gates in [0.5, 1) reach
    subnormals, which XLA's CPU flushes: the port's side runs flushed too
    (see ``flush_denormals``)."""
    ops, lay = _affine_case(bt, exact)
    tiles = schedules._tiles(monoids.AFFINE, ops, lay)
    scanned = jax_schedules.tile_scan(
        jax_monoids.AFFINE, tuple(jnp.asarray(t.numpy()) for t in tiles),
        axis=2)
    want = tuple(torch.from_numpy(np.array(s[:, :, -1])) for s in scanned)
    got = schedules.totals_tree_plain(ops, monoids.AFFINE, lay)
    net = schedules.totals_plain(ops, monoids.AFFINE, lay)
    for g, n, w in zip(got, net, want):
        assert same_bits(g, w)
        assert same_bits(n, w)


def test_totals_kinds_cover_every_reduced_dtype():
    """The kinds swept here are the dtypes the CUDA reduction takes."""
    from repro_torch.kernels.scan_engine import cuda
    assert {TORCH_DTYPES[k] for k in KINDS} == set(cuda.DTYPE_CODES)


# The segmented sum on Rows, which totals_reduce_kernel builds too: every
# dtype the kernel takes, tiles of one segment short of 256, three
# segments, the main path's 2048, a ragged 17 segments and the largest
# tile, flags sparse, dense, and on every tile's first and last element
# (non-unit and negative flags among them). A flag on the right kills the
# left value, so the tree keeps the earlier subtree on the left.
SEG_KINDS = KINDS[:6]
SEG_BLOCKS = (200, 384, 2048, 2176, 16384)
SEG_FLAGS = ("sparse", "dense", "ends")
SEG_CASES = [(k, bn, f) for k in SEG_KINDS for bn in SEG_BLOCKS
             for f in SEG_FLAGS]
SEG_IDS = [f"segsum-{k}-bn{bn}-{f}" for k, bn, f in SEG_CASES]


def _segsum_case(kind, bn, flags, seed):
    """((values, flags), spec, layout): two rows of three tiles."""
    n = 3 * bn
    x = operands(kind, 2, n, bn, seed)
    rng = np.random.default_rng(seed + 1)
    if flags == "sparse":
        f = np.where(rng.random((2, n)) < 0.01,
                     rng.choice([1, -3, 2], (2, n)), 0)
    elif flags == "dense":
        f = np.where(rng.random((2, n)) < 0.5,
                     rng.choice([1, -3, 2], (2, n)), 0)
    else:
        f = np.zeros((2, n), np.int64)
        f[:, ::bn] = 1
        f[:, bn - 1::bn] = -7
        f[1, bn] = 0              # one tile flagged at its end alone
    ops = (x, torch.from_numpy(f.astype(np.int32)))
    return ops, monoids.SEGMENTED_SUM, scan_engine.Rows(2, n, 1, bn)


@pytest.mark.parametrize("kind,bn,flags", SEG_CASES, ids=SEG_IDS)
def test_totals_tree_plain_segsum_bitwise_vs_totals_plain(kind, bn, flags):
    ops, spec, lay = _segsum_case(kind, bn, flags, 74)
    got = schedules.totals_tree_plain(ops, spec, lay)
    want = schedules.totals_plain(ops, spec, lay)
    assert len(got) == 2
    for g, w in zip(got, want):
        assert tuple(g.shape) == lay.chain_shape
        assert same_bits(g, w)


@pytest.mark.parametrize("kind,bn,flags", SEG_CASES, ids=SEG_IDS)
def test_totals_tree_plain_segsum_bitwise_vs_reference(kind, bn, flags,
                                                        flush_denormals):
    """The last element of the reference's ``tile_scan`` of every tile,
    both leaves, in the accumulation dtypes."""
    ops, spec, lay = _segsum_case(kind, bn, flags, 75)
    tiles = tuple(t.reshape(-1, bn)
                  for t in schedules._tiles(spec, ops, lay))
    last = jax.jit(lambda v, f: tuple(s[:, -1] for s in jax_schedules.tile_scan(
        jax_monoids.SEGMENTED_SUM, (v, f), axis=1)))(
            *(jnp.asarray(t.numpy()) for t in tiles))
    want = tuple(torch.from_numpy(np.array(w)).reshape(lay.chain_shape)
                 for w in last)
    got = schedules.totals_tree_plain(ops, spec, lay)
    net = schedules.totals_plain(ops, spec, lay)
    for g, n_, w in zip(got, net, want):
        assert g.dtype == w.dtype
        assert same_bits(g, w)
        assert same_bits(n_, w)
