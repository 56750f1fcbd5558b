"""The port's flash attention forward held against the JAX reference.

The same numpy inputs go through ``repro.kernels.flash_attention`` (the
engine's Pallas fold in interpret mode, as the reference's own tests run
it on the CPU) and through ``repro_torch.kernels.flash_attention`` (the
plain PyTorch version of each fold kernel on CPU tensors), over the
reference's 8-config grid (``tests/test_flash_engine.py::CONFIGS``) under
both fold schedules.

Tolerances are the reference tests' own: 1e-5 between two statements of
one fold (its cross-schedule bar, tests/test_flash_engine.py:99; the two
packages' exp and dot products round differently, so not bitwise),
2e-3 against dense attention (:80), 5e-2 for bfloat16 (:136). Integer
decisions (split counts, padding, schedules) must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.scan import assoc as jassoc
from repro.kernels.flash_attention import ops as jops
from repro.kernels.flash_attention import ref as jref
from repro.kernels.flash_attention.flash_attention import (
    flash_attention_kernel as j_kernel)
from repro.kernels.flash_attention.flash_attention import (
    pick_kv_splits as j_pick_kv_splits)
from repro_torch.core.scan import assoc
from repro_torch.kernels import scan_engine
from repro_torch.kernels.flash_attention import ops, ref
from repro_torch.kernels.flash_attention.flash_attention import (
    default_kv_split_target, flash_attention_kernel, pick_kv_splits)

SCHEDULES = ("carry", "decoupled")
FOLD_TOL = 1e-5     # tests/test_flash_engine.py:99
DENSE_TOL = 2e-3    # tests/test_flash_engine.py:80
BF16_TOL = 5e-2     # tests/test_flash_engine.py:136

CONFIGS = [
    # (name, B, Hkv, group, Tq, Tk, D, causal, window, softcap, bq, bk)
    ("causal", 2, 2, 1, 256, 256, 32, True, None, None, 128, 128),
    ("noncausal", 1, 2, 1, 256, 256, 32, False, None, None, 128, 128),
    ("window", 1, 2, 1, 256, 256, 32, True, 64, None, 64, 128),
    ("softcap", 1, 1, 1, 256, 256, 32, True, None, 30.0, 128, 128),
    ("gqa2", 2, 2, 2, 256, 256, 32, True, None, None, 128, 128),
    ("gqa4_window_cap", 1, 2, 4, 256, 256, 16, True, 96, 20.0, 128, 64),
    ("ragged_kv", 1, 2, 1, 300, 300, 32, True, None, None, 128, 128),
    ("ragged_kv_noncausal", 1, 1, 1, 200, 300, 16, False, None, None,
     128, 128),
]
IDS = [c[0] for c in CONFIGS]


def _qkv(seed, B, Hq, Hkv, Tq, Tk, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Hq, Tq, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, Tk, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, Tk, D)).astype(np.float32))


def _t(*xs, dtype=torch.float32):
    return tuple(torch.from_numpy(x).to(dtype) for x in xs)


def _j(*xs, dtype=jnp.float32):
    return tuple(jnp.asarray(x, dtype) for x in xs)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _cfg_inputs(cfg):
    name, B, Hkv, g, Tq, Tk, D, causal, window, softcap, bq, bk = cfg
    q, k, v = _qkv(sum(map(ord, name)), B, Hkv * g, Hkv, Tq, Tk, D)
    kw = dict(scale=D ** -0.5, causal=causal, window=window,
              softcap=softcap, block_q=bq, block_k=bk)
    return (q, k, v), kw


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("cfg", CONFIGS, ids=IDS)
def test_forward_matches_reference(cfg, schedule):
    (q, k, v), kw = _cfg_inputs(cfg)
    got = ops.flash_attention(*_t(q, k, v), schedule=schedule, **kw)
    want = jops.flash_attention(*_j(q, k, v), schedule=schedule,
                                interpret=True, **kw)
    assert got.shape == tuple(want.shape) and got.dtype == torch.float32
    _close(got, want, FOLD_TOL)


@pytest.mark.parametrize("cfg", CONFIGS, ids=IDS)
def test_cross_schedule_parity_and_dense(cfg):
    """carry vs decoupled within the reference's bar; both against the
    port's dense oracle within its dense tolerance."""
    (q, k, v), kw = _cfg_inputs(cfg)
    tq, tk, tv = _t(q, k, v)
    outs = [ops.flash_attention(tq, tk, tv, schedule=s, **kw)
            for s in SCHEDULES]
    _close(outs[0], outs[1], FOLD_TOL)
    B, Hq, Tq, D = tq.shape
    Hkv = tk.shape[1]
    dense = ref.mha_ref(
        tq.reshape(B * Hq, Tq, D), tk.reshape(B * Hkv, -1, D),
        tv.reshape(B * Hkv, -1, D), group=Hq // Hkv, scale=kw["scale"],
        causal=kw["causal"], window=kw["window"],
        softcap=kw["softcap"]).reshape(B, Hq, Tq, D)
    _close(outs[0], dense, DENSE_TOL)


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_all_masked_rows(schedule):
    """Rows whose whole KV band is masked (q past kv_len + window) emit
    exactly 0, as in the reference."""
    q, k, v = (x[0] for x in _qkv(17, 2, 2, 2, 256, 256, 16))
    kw = dict(scale=0.25, causal=True, window=32, kv_len=64, block_q=64,
              block_k=64, schedule=schedule)
    got = flash_attention_kernel(*_t(q, k, v), **kw)
    want = j_kernel(*_j(q, k, v), interpret=True, **kw)
    assert not bool(torch.isnan(got).any())
    assert bool((got[:, 96:] == 0).all())
    _close(got, want, FOLD_TOL)


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_bf16(schedule):
    q, k, v = _qkv(13, 1, 2, 2, 128, 128, 32)
    got = ops.flash_attention(*_t(q, k, v, dtype=torch.bfloat16),
                              scale=32 ** -0.5, schedule=schedule)
    want = jops.flash_attention(*_j(q, k, v, dtype=jnp.bfloat16),
                                scale=32 ** -0.5, schedule=schedule,
                                interpret=True)
    assert got.dtype == torch.bfloat16
    _close(got, want, BF16_TOL)


@pytest.mark.parametrize("splits", [1, 2, 4, 8])
def test_split_invariance(splits):
    """The decoupled fold does not depend on the chunk count; it agrees
    with the reference at every count."""
    q, k, v = _qkv(7, 1, 2, 1, 128, 1024, 16)
    kw = dict(scale=0.25, causal=True, schedule="decoupled",
              kv_splits=splits, block_k=128)
    got = ops.flash_attention(*_t(q, k, v), **kw)
    _close(got, jops.flash_attention(*_j(q, k, v), interpret=True, **kw),
           FOLD_TOL)
    _close(got, ops.flash_attention(*_t(q, k, v), scale=0.25,
                                    schedule="carry"), FOLD_TOL)


def test_pick_kv_splits_matches_reference():
    assert default_kv_split_target() == 16
    for nk in range(1, 70):
        for target in (None, 1, 3, 4, 8, 16, 64):
            assert pick_kv_splits(nk, target) == j_pick_kv_splits(nk, target)
    assert pick_kv_splits(12, 8) == 6
    assert pick_kv_splits(7, 4) == 1


@pytest.mark.parametrize("bk", [64, 128])
def test_decoupled_padding_matches_reference(bk):
    """Prime and awkward KV block counts pad to a multiple of the split
    target, exactly as the reference pads them."""
    for nk in (1, 2, 7, 13, 17, 31, 64, 3907):
        for tail in (0, 1, bk // 2):
            Tk = nk * bk - tail
            for splits in (None, 4, 16):
                assert ops._decoupled_padding(Tk, bk, splits) == \
                    jops._decoupled_padding(Tk, bk, splits)
                assert ops._tiles(Tk, Tk, 128, bk) == \
                    jops._tiles(Tk, Tk, 128, bk)
    pad_k, splits = ops._decoupled_padding(17 * 128, 128, 16)
    assert splits == 16 and (17 * 128 + pad_k) // 128 % 16 == 0


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("cfg", CONFIGS + [
    ("decode", 2, 2, 4, 1, 1000, 16, False, None, None, 128, 128)],
    ids=IDS + ["decode"])
def test_kernel_inputs_match_reference(cfg, schedule):
    """The operands and keywords ``flash_attention`` hands its kernels
    (``ops.kernel_inputs``) are the reference's: its ``_padding``,
    ``_flatten_pad`` and ``_kernel_kwargs``, bitwise."""
    (q, k, v), kw = _cfg_inputs(cfg)
    fields = dict(scale=kw["scale"], causal=kw["causal"],
                  window=kw["window"], softcap=kw["softcap"],
                  block_q=kw["block_q"], block_k=kw["block_k"],
                  schedule=schedule, kv_splits=None, use_kv_bounds=True)
    got_ops, got_kw = ops.kernel_inputs(*_t(q, k, v),
                                        ops.FlashConfig(**fields))
    jcfg = jops.FlashConfig(interpret=True, **fields)
    B, Hq, Tq, _ = q.shape
    _, Hkv, Tk, _ = k.shape
    bq, bk, pad_q, pad_k, kv_splits = jops._padding(Tq, Tk, jcfg)
    want_ops = jops._flatten_pad(*_j(q, k, v), pad_q, pad_k)
    want_kw = jops._kernel_kwargs(jcfg, Tk, bq, bk, kv_splits, Hq // Hkv)
    del want_kw["interpret"]
    assert got_kw == want_kw
    for a, b in zip(got_ops, want_ops):
        assert a.is_contiguous() and a.shape == b.shape
        np.testing.assert_array_equal(_np(a), _np(b))


def test_decoupled_pads_prime_kv_block_counts():
    q, k, v = _qkv(23, 1, 2, 1, 128, 17 * 128, 16)
    kw = dict(scale=0.25, causal=False, schedule="decoupled", kv_splits=16,
              block_k=128)
    got = ops.flash_attention(*_t(q, k, v), **kw)
    _close(got, jops.flash_attention(*_j(q, k, v), interpret=True, **kw),
           FOLD_TOL)


ORACLE_CASES = [
    # (name, group, T, D, causal, window, softcap, kv_len)
    ("causal", 1, 192, 16, True, None, None, None),
    ("gqa_window_cap", 2, 192, 16, True, 48, 20.0, None),
    ("noncausal_kvlen", 2, 160, 8, False, None, None, 100),
]


@pytest.mark.parametrize("case", ORACLE_CASES, ids=[c[0] for c in
                                                    ORACLE_CASES])
def test_oracles_match_reference(case):
    name, g, T, D, causal, window, softcap, kv_len = case
    q, k, v = _qkv(31, 1, 2 * g, 2, T, T, D)
    flat = (q.reshape(2 * g, T, D), k.reshape(2, T, D), v.reshape(2, T, D))
    kw = dict(group=g, scale=D ** -0.5, causal=causal, window=window,
              softcap=softcap, kv_len=kv_len)
    _close(ref.mha_ref(*_t(*flat), **kw), jref.mha_ref(*_j(*flat), **kw),
           FOLD_TOL)
    _close(ref.blockwise_ref(*_t(*flat), block_k=64, **kw),
           jref.blockwise_ref(*_j(*flat), block_k=64, **kw), FOLD_TOL)
    if causal and window is not None:
        bkw = dict(scale=D ** -0.5, window=window, softcap=softcap,
                   kv_len=kv_len, block_q=64, block_k=64)
        _close(ref.banded_ref(*_t(q, k, v), **bkw),
               jref.banded_ref(*_j(q, k, v), **bkw), FOLD_TOL)


def test_masked_softmax_matches_reference():
    rng = np.random.default_rng(2)
    s = rng.standard_normal((3, 8, 40)).astype(np.float32)
    mask = rng.random((3, 8, 40)) < 0.6
    mask[1, 3] = False                       # a fully masked row
    got = ref.masked_softmax(torch.from_numpy(s), torch.from_numpy(mask))
    want = jref.masked_softmax(jnp.asarray(s), jnp.asarray(mask))
    _close(got, want, FOLD_TOL)
    assert bool((got[1, 3] == 0).all())


def test_blockwise_ref_matches_engine():
    q, k, v = _qkv(5, 1, 2, 2, 192, 192, 16)
    eng = ops.flash_attention(*_t(q, k, v), scale=0.25, schedule="carry")
    blk = ref.blockwise_ref(*_t(q.reshape(2, 192, 16), k.reshape(2, 192, 16),
                                v.reshape(2, 192, 16)),
                            scale=0.25, block_k=64).reshape(1, 2, 192, 16)
    _close(eng, blk, FOLD_TOL)


# ---------------------------------------------------------------------------
# registration surface and the engine's fold dispatch
# ---------------------------------------------------------------------------


def test_softmax_pair_spec_surface():
    spec = assoc.softmax_pair_kernel_spec(scale=1.0)
    assert isinstance(spec, assoc.KernelSpec)
    assert spec.n_leaves == 3
    assert spec.transform is not None and spec.finalize is not None
    assert not spec.supports_exclusive
    assert spec.fills == jassoc.softmax_pair_kernel_spec(scale=1.0).fills
    assert assoc.NEG_INF == jassoc.NEG_INF
    assert assoc.get("softmax_pair") is assoc.SOFTMAX_PAIR


def test_softmax_pair_monoid_matches_reference():
    rng = np.random.default_rng(4)
    a = (rng.standard_normal(16).astype(np.float32),
         rng.random(16).astype(np.float32))
    b = (rng.standard_normal(16).astype(np.float32),
         rng.random(16).astype(np.float32))
    got = assoc.SOFTMAX_PAIR.combine(_t(*a), _t(*b))
    want = jassoc.SOFTMAX_PAIR.combine(_j(*a), _j(*b))
    for x, y in zip(got, want):
        _close(x, y, FOLD_TOL)
    ident = assoc.SOFTMAX_PAIR.identity_like(_t(*a))
    assert bool(torch.isneginf(ident[0]).all()) and not ident[1].any()


def test_engine_rejects_bad_fold_requests():
    spec = assoc.softmax_pair_kernel_spec(scale=1.0)
    lay = scan_engine.KVBlocks(bh=2, bh_kv=2, tq=128, tk=128, d=16,
                               bq=128, bk=128)
    x = torch.ones((2, 128, 16))
    with pytest.raises(ValueError):
        scan_engine.scan((x, x, x), spec, lay, schedule="carry",
                         exclusive=True)
    with pytest.raises(ValueError):
        scan_engine.scan((x, x, x), spec, lay, schedule="carry",
                         return_totals=True)
    with pytest.raises(ValueError):
        scan_engine.scan((x, x, x), spec, lay, schedule="decoupled",
                         count_cells=True)
    with pytest.raises(ValueError):
        scan_engine.KVBlocks(bh=3, bh_kv=2, tq=128, tk=128, d=16,
                             bq=128, bk=128)  # bh != bh_kv * group
    with pytest.raises(ValueError):
        scan_engine.KVBlocks(bh=2, bh_kv=2, tq=128, tk=512, d=16,
                             bq=128, bk=128, splits=3)  # 3 !| 4 blocks


def test_fused_and_tree_map_to_the_fold_schedules():
    """A fold has no fused or tree form: fused runs the decoupled fold,
    tree the carry fold, bit for bit."""
    q, k, v = (x[0] for x in _qkv(9, 1, 2, 2, 128, 256, 16))
    tq, tk, tv = _t(q, k, v)
    spec = assoc.softmax_pair_kernel_spec(scale=0.25, kv_len=256)
    lay = scan_engine.KVBlocks(bh=2, bh_kv=2, tq=128, tk=256, d=16,
                               bq=64, bk=128, splits=2, leaf_dims=(1, 1, 16))
    runs = {s: scan_engine.scan((tq, tk, tv), spec, lay, schedule=s)[0]
            for s in ("carry", "decoupled", "fused", "tree")}
    assert torch.equal(runs["fused"], runs["decoupled"])
    assert torch.equal(runs["tree"], runs["carry"])


@pytest.mark.parametrize("cores", [8, 132])
def test_resolved_attention_schedule_matches_reference(cores):
    for shape, kv in (((1, 8, 1, 64), 1 << 16), ((8, 16, 4096, 64), 4096),
                      ((4, 40, 1, 128), 131072), ((1, 16, 8192, 256), 8192),
                      ((1, 40, 4096, 128), 4096), ((2, 4, 300, 32), 300)):
        got = ops.resolved_attention_schedule(shape, kv, cores=cores)
        if cores == 8:
            assert got == jops.resolved_attention_schedule(shape, kv)
        bq, bk, nq = ops._tiles(shape[2], kv, 128, 128)
        assert got == jops.policy.choose_attention_schedule(
            shape[0] * shape[1] * nq, kv, cores, block_elems=bk)
    for s in ("carry", "decoupled"):
        assert ops.resolved_attention_schedule((1, 8, 1, 64), 64,
                                               schedule=s) == s
    with pytest.raises(ValueError):
        ops.resolved_attention_schedule((1, 8, 1, 64), 64, schedule="fused")
