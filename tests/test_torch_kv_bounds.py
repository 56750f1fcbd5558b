"""Causal-aware KV bounds and the page map in the port, against the
reference.

The port's attention fold layouts (``KVBlocks`` forward/dq, ``QBlocks``
dk/dv) carry the reference's optional per-q-block KV extent
``(causal, window, kv_len)``; the fold schedules skip cells whose mask
is provably all-dead. With the zeroed-probability convention a skipped
cell's element is the monoid identity, so:

  * forward outputs and dq/dk/dv are BITWISE identical bound-on vs
    bound-off, under both fold schedules;
  * the executed-cell counts (``count_cells``) equal the reference's
    bit for bit, and the analytic ``active_cells``;
  * the liveness predicate is the reference's and conservative;
  * a page-permuted KV pool read through ``kv_block_map`` is bitwise the
    contiguous pool (tests/test_serve_paging.py:371).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import scan_engine as jengine
from repro.kernels.flash_attention.flash_attention import (
    flash_attention_kernel as j_kernel)
from repro_torch.core.scan.assoc import softmax_pair_kernel_spec
from repro_torch.kernels import scan_engine
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention_bwd_kernel, flash_attention_kernel)

SCHEDULES = ("carry", "decoupled")
FOLD_TOL = 1e-5   # tests/test_flash_engine.py:99

BOUND_CONFIGS = [
    # (name, Tq, Tk, D, causal, window, kv_len, bq, bk)
    ("causal", 256, 256, 16, True, None, None, 64, 64),
    ("causal_window", 256, 256, 16, True, 96, None, 64, 64),
    ("causal_short_kv", 256, 256, 16, True, None, 160, 64, 64),
    ("window_all_masked_tail", 256, 256, 16, True, 32, 64, 64, 64),
    ("noncausal", 128, 256, 16, False, None, 200, 64, 64),
]
IDS = [c[0] for c in BOUND_CONFIGS]


def _qkv(seed, Tq, Tk, D, H=2):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 for s in ((H, Tq, D), (H, Tk, D), (H, Tk, D)))


def _kw(cfg, schedule):
    _, _, _, D, causal, window, kv_len, bq, bk = cfg
    return dict(scale=D ** -0.5, causal=causal, window=window,
                kv_len=kv_len, block_q=bq, block_k=bk, schedule=schedule)


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("cfg", BOUND_CONFIGS, ids=IDS)
def test_forward_bitwise_bound_on_off(cfg, schedule):
    q, k, v = _qkv(sum(map(ord, cfg[0])), *cfg[1:4])
    kw = _kw(cfg, schedule)
    on = flash_attention_kernel(q, k, v, use_kv_bounds=True, **kw)
    off = flash_attention_kernel(q, k, v, use_kv_bounds=False, **kw)
    assert torch.equal(on, off), f"{cfg[0]}/{schedule} diverged"
    want = j_kernel(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                    interpret=True, **kw)
    np.testing.assert_allclose(on.numpy(), np.asarray(want), rtol=FOLD_TOL,
                               atol=FOLD_TOL)


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("cfg", BOUND_CONFIGS, ids=IDS)
def test_backward_bitwise_bound_on_off(cfg, schedule):
    q, k, v = _qkv(sum(map(ord, cfg[0])) + 1, *cfg[1:4])
    kw = _kw(cfg, schedule)
    out, m, l = flash_attention_kernel(q, k, v, return_stats=True, **kw)
    g = torch.from_numpy(np.random.default_rng(5).standard_normal(
        tuple(out.shape)).astype(np.float32))
    delta = (g * out).sum(-1, keepdim=True)
    grads = {b: flash_attention_bwd_kernel(q, k, v, g, m, l, delta,
                                           use_kv_bounds=b, **kw)
             for b in (True, False)}
    for leaf, (a, b) in enumerate(zip(grads[True], grads[False])):
        assert torch.equal(a, b), f"{cfg[0]}/{schedule} leaf {leaf}"


@pytest.mark.parametrize("cfg", BOUND_CONFIGS, ids=IDS)
def test_count_cells_match_reference(cfg):
    """The executed-cell counts are the reference's, bit for bit, and the
    analytic count; the instrumented output is the plain one."""
    name, Tq, Tk, D, causal, window, kv_len, bq, bk = cfg
    q, k, v = _qkv(3, Tq, Tk, D)
    kw = _kw(cfg, "carry")
    out, counts = flash_attention_kernel(q, k, v, count_cells=True, **kw)
    _, jcounts = j_kernel(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                          count_cells=True, interpret=True, **kw)
    assert counts.dtype == torch.int32
    assert np.array_equal(counts.numpy(), np.asarray(jcounts))
    lay = scan_engine.KVBlocks(
        bh=2, bh_kv=2, tq=Tq, tk=Tk, d=D, bq=bq, bk=bk,
        kv_bounds=(causal, window, Tk if kv_len is None else kv_len))
    assert int(counts.sum()) == 2 * lay.active_cells()
    assert torch.equal(out, flash_attention_kernel(q, k, v, **kw))


def test_causal_prefill_cell_count_instrumented():
    """Causal prefill executes ~half the cells."""
    q, k, v = _qkv(0, 1024, 1024, 16)
    _, counts = flash_attention_kernel(q, k, v, scale=0.25, causal=True,
                                       count_cells=True)
    nq = 1024 // 128
    assert tuple(counts.shape) == (2, nq)
    assert int(counts.sum()) == 2 * nq * (nq + 1) // 2


def test_bounds_off_counts_full_grid():
    q, k, v = _qkv(1, 256, 256, 16)
    _, counts = flash_attention_kernel(
        q, k, v, scale=0.25, causal=True, block_q=64, block_k=64,
        use_kv_bounds=False, count_cells=True)
    assert int(counts.sum()) == 2 * 4 * 4


def test_qblocks_active_cells_match_kvblocks_and_reference():
    for window, kv_len in [(None, None), (96, None), (None, 160)]:
        bounds = (True, window, kv_len if kv_len is not None else 256)
        geo = dict(bh=4, bh_kv=2, tq=256, tk=256, d=16, bq=64, bk=64,
                   group=2, kv_bounds=bounds)
        kv = scan_engine.KVBlocks(**geo)
        qb = scan_engine.QBlocks(**geo)
        assert qb.active_cells() == 2 * kv.active_cells()
        assert kv.active_cells() == jengine.KVBlocks(**geo).active_cells()
        assert qb.active_cells() == jengine.QBlocks(**geo).active_cells()
        assert kv.split_grid == jengine.KVBlocks(**geo).split_grid
        assert qb.grid == jengine.QBlocks(**geo).grid


@pytest.mark.parametrize("window,kv_len,causal", [
    (None, 256, True), (96, 256, True), (None, 160, True),
    (32, 64, True), (None, 200, False), (64, 100, True)])
def test_block_live_is_conservative(window, kv_len, causal):
    """Whenever the predicate says DEAD every entry of the cell is masked;
    without a window it is exact; it is the reference's predicate."""
    Tq = Tk = 256
    bq = bk = 64
    rows = np.arange(Tq)[:, None]
    cols = np.arange(Tk)[None, :]
    mask = np.broadcast_to(cols < kv_len, (Tq, Tk))
    if causal:
        mask = mask & (cols <= rows)
    if window is not None:
        mask = mask & (cols > rows - window)
    kw = dict(bq=bq, bk=bk, causal=causal, window=window, kv_len=kv_len)
    for qi in range(Tq // bq):
        for kj in range(Tk // bk):
            cell = mask[qi * bq:(qi + 1) * bq, kj * bk:(kj + 1) * bk]
            live = scan_engine.block_live(qi, kj, **kw)
            assert bool(live) == bool(jengine.block_live(qi, kj, **kw))
            if not live:
                assert not cell.any(), (qi, kj)
            elif window is None:
                assert cell.any(), (qi, kj)
    # the tensor form the plain folds use agrees with the int form
    qi = torch.arange(Tq // bq)[:, None]
    kj = torch.arange(Tk // bk)[None, :]
    grid = torch.as_tensor(scan_engine.block_live(qi, kj, **kw)).expand(
        Tq // bq, Tk // bk)
    for i in range(Tq // bq):
        for j in range(Tk // bk):
            assert bool(grid[i, j]) == bool(
                scan_engine.block_live(i, j, **kw))


def test_degenerate_bounds_count_full_grid():
    """kv_bounds=(False, None, None) has no live constraint: fold_active
    reports "no bound" and count_cells sees the full grid."""
    lay = scan_engine.KVBlocks(bh=2, bh_kv=2, tq=128, tk=128, d=16,
                               bq=64, bk=64, kv_bounds=(False, None, None))
    assert lay.fold_active((0, 0, 0)) is None
    assert lay.active_cells() == 4
    q, k, v = _qkv(11, 128, 128, 16)
    spec = softmax_pair_kernel_spec(scale=0.25, causal=False, block_q=64,
                                    block_k=64)
    (out,), counts = scan_engine.scan((q, k, v), spec, lay, schedule="carry",
                                      count_cells=True)
    assert int(counts.sum()) == 2 * 4


def test_flash_attention_grad_bitwise_with_bounds_knob():
    """End to end through the public wrapper and its autograd function:
    gradients with the bounds knob on and off are bitwise identical."""
    rng = np.random.default_rng(5)
    B, Hq, Hkv, T, D = 1, 4, 2, 256, 16
    base = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Hq, T, D), (B, Hkv, T, D), (B, Hkv, T, D))]

    def grads(use_bounds):
        ts = [torch.from_numpy(x).requires_grad_() for x in base]
        out = ops.flash_attention(*ts, causal=True, window=96,
                                  use_kv_bounds=use_bounds)
        return torch.autograd.grad((out ** 2).sum(), ts)

    for a, b in zip(grads(True), grads(False)):
        assert torch.equal(a, b)


def test_kv_block_map_validation():
    with pytest.raises(ValueError):
        scan_engine.KVBlocks(bh=2, bh_kv=2, tq=64, tk=128, d=32, bq=32,
                             bk=32, kv_block_map=torch.tensor([0, 1]))


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_kv_block_map_bitwise_on_permuted_pool(schedule):
    """A block-permuted physical KV pool and its map == the contiguous
    layout, bitwise (masks and bounds are keyed on logical positions),
    and the reference's map gives the same output."""
    rng = np.random.default_rng(0)
    BH, BHkv, Tq, Tk, d, bq, bk = 4, 2, 64, 128, 32, 32, 32
    q = rng.standard_normal((BH, Tq, d)).astype(np.float32)
    k = rng.standard_normal((BHkv, Tk, d)).astype(np.float32)
    v = rng.standard_normal((BHkv, Tk, d)).astype(np.float32)
    nk = Tk // bk
    perm = rng.permutation(nk)             # logical block j lives at perm[j]
    inv = np.empty(nk, np.int64)
    inv[perm] = np.arange(nk)
    kp = k.reshape(BHkv, nk, bk, d)[:, inv].reshape(BHkv, Tk, d)
    vp = v.reshape(BHkv, nk, bk, d)[:, inv].reshape(BHkv, Tk, d)
    for causal, kv_len in ((True, None), (False, 100)):
        kw = dict(group=2, scale=0.125, causal=causal, kv_len=kv_len,
                  block_q=bq, block_k=bk, schedule=schedule)
        want = flash_attention_kernel(
            *(torch.from_numpy(x) for x in (q, k, v)), **kw)
        got = flash_attention_kernel(
            *(torch.from_numpy(x) for x in (q, kp, vp)),
            kv_block_map=tuple(perm.tolist()), **kw)
        got_t = flash_attention_kernel(
            *(torch.from_numpy(x) for x in (q, kp, vp)),
            kv_block_map=torch.from_numpy(perm), **kw)
        assert torch.equal(got, want) and torch.equal(got_t, want)
        jgot = j_kernel(*(jnp.asarray(x) for x in (q, kp, vp)),
                        kv_block_map=tuple(perm.tolist()), interpret=True,
                        **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(jgot),
                                   rtol=FOLD_TOL, atol=FOLD_TOL)
