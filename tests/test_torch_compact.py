"""The port's mask-compact scan held against the JAX reference.

The same numpy masks go through the reference's
``repro.kernels.compact.ops.mask_compact`` (Pallas in interpret mode, as
its own tests run it on the CPU) and the port's (the plain PyTorch
version of each kernel on a CPU tensor). Destinations, survivor counts
and the running chunk-totals chain they come from are integers, so every
comparison is BITWISE. Re-runs the mask cases of
``tests/test_scan_engine.py`` and the compaction-kernel cases of
``tests/test_relational.py``; the CUDA kernels are held against these
plain versions in ``tests/test_torch_cuda_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import scan_engine as jax_engine
from repro.kernels.compact import ops as jax_kc
from repro.kernels.scan_engine import monoids as jax_monoids
from repro_torch.kernels import scan_engine
from repro_torch.kernels.compact import mask_compact, mask_compact_kernel
from repro_torch.kernels.scan_engine import monoids, schedules

SCHEDULES = ("carry", "decoupled", "fused")
SCHEDULES4 = SCHEDULES + ("tree",)


def _mask(seed, shape, p=0.5, dtype=np.int32):
    m = (np.random.default_rng(seed).random(shape) < p).astype(dtype)
    return jnp.asarray(m), torch.from_numpy(m)


def _equal(got, want):
    assert tuple(got.shape) == tuple(want.shape)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("schedule", SCHEDULES4)
def test_mask_compact_bitwise_vs_reference(schedule):
    mj, mt = _mask(3, (3, 4096))
    wd, wc = jax_kc.mask_compact(mj, interpret=True, schedule=schedule,
                                 block_n=512)
    gd, gc = mask_compact(mt, schedule=schedule, block_n=512)
    _equal(gd, wd)
    _equal(gc, wc)


def test_parity_mask():
    """carry == decoupled == fused, and the numpy ground truth."""
    _, mt = _mask(3, (3, 4096))
    outs = [mask_compact(mt, schedule=s, block_n=512) for s in SCHEDULES]
    for d, c in outs[1:]:
        assert torch.equal(d, outs[0][0]) and torch.equal(c, outs[0][1])
    mn = mt.numpy()
    excl = np.cumsum(mn, -1) - mn
    np.testing.assert_array_equal(outs[0][0].numpy(),
                                  np.where(mn != 0, excl, 4096))
    np.testing.assert_array_equal(outs[0][1].numpy(), mn.sum(-1))


def test_parity4_mask_exact():
    _, mt = _mask(23, (3, 4096))
    outs = [mask_compact(mt, schedule=s, block_n=512) for s in SCHEDULES4]
    for d, c in outs[1:]:
        assert torch.equal(d, outs[0][0]) and torch.equal(c, outs[0][1])


def test_mask_compact_counts_from_totals_chain():
    """Counts derived from the totals chain == a full reduction and the
    reference, for every schedule, ragged lengths and float masks
    included (fractional values keep: ``!= 0`` before the int cast)."""
    rng = np.random.default_rng(10)
    for shape in ((2, 517), (4, 4096), (1, 128)):
        m = (rng.random(shape) < 0.3).astype(np.float32)
        m[m != 0] = 0.5
        for s in SCHEDULES4:
            gd, gc = mask_compact(torch.from_numpy(m), schedule=s,
                                  block_n=256)
            np.testing.assert_array_equal(gc.numpy(), (m != 0).sum(-1))
            wd, wc = jax_kc.mask_compact(jnp.asarray(m), interpret=True,
                                         schedule=s, block_n=256)
            _equal(gd, wd)
            _equal(gc, wc)


@pytest.mark.parametrize("schedule", SCHEDULES4)
def test_mask_running_totals_bitwise_vs_reference(schedule):
    """The engine's ``return_totals`` chain for the mask spec."""
    mj, mt = _mask(9, (3, 2048))
    (wd,), (wt,) = jax_engine.scan(
        (mj,), jax_monoids.mask(2048), jax_engine.Rows(3, 2048, 1, 256),
        schedule=schedule, interpret=True, return_totals=True)
    (gd,), (gt,) = scan_engine.scan(
        (mt,), monoids.mask(2048), scan_engine.Rows(3, 2048, 1, 256),
        schedule=schedule, return_totals=True)
    _equal(gd, wd)
    _equal(gt, wt)
    np.testing.assert_array_equal(gt[:, -1].numpy(), mt.numpy().sum(-1))


def test_mask_emit_in_tile_plain_versions():
    """The fused select on the plain kernels: decoupled's totals, chain
    and apply agree with carry's and tree's outputs and running totals."""
    _, mt = _mask(11, (2, 1024))
    lay = scan_engine.Rows(2, 1024, 1, 128)
    spec = monoids.mask(1024)
    runs = [schedules.PLAIN[s]((mt,), spec, lay, return_totals=True)
            for s in SCHEDULES4]
    for outs, tot in runs[1:]:
        assert torch.equal(outs[0], runs[0][0][0])
        assert torch.equal(tot[0], runs[0][1][0])


def test_mask_compact_rank3_and_ragged_vs_reference():
    mj, mt = _mask(12, (2, 3, 300), p=0.4, dtype=bool)
    wd, wc = jax_kc.mask_compact(mj, interpret=True)
    gd, gc = mask_compact(mt)
    _equal(gd, wd)
    _equal(gc, wc)
    assert int(gd.max()) == 300  # the sentinel is the caller's n


def test_mask_compact_kernel_back_compat():
    mj, mt = _mask(13, (4, 1024))
    for s in SCHEDULES4:
        wd, wc = jax_kc.mask_compact_kernel(mj, block_b=2, block_n=256,
                                            interpret=True, schedule=s)
        gd, gc = mask_compact_kernel(mt, block_b=2, block_n=256, schedule=s)
        _equal(gd, wd)
        _equal(gc, wc)
    with pytest.raises(ValueError):
        mask_compact_kernel(torch.ones(4))


@pytest.mark.parametrize("shape", [(0, 5), (2, 0), (0,)])
def test_mask_compact_empty(shape):
    dest, counts = mask_compact(torch.zeros(shape, dtype=torch.bool))
    assert dest.shape == shape and counts.shape == shape[:-1]
    assert dest.dtype == counts.dtype == torch.int32
