"""The port's paged KV cache (``repro_torch.serve.paging``).

The cases of tests/test_serve_paging.py that need no engine — the
allocator, the page table, the prefix registry and the refcounts — re-run
on the port (its allocation scans on the CPU here); the allocator's page
ids, defrag plans and the device views held against the reference's,
bitwise; and paged decode bitwise equal to contiguous decode on the
zamba2 SMOKE config (a shared attention block between Mamba2 layers) and
the gemma2 SMOKE config (whose local layers' rings ride the pages): two
requests prefilled alone, then 6 greedy steps together.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.obs.metrics import Registry as JRegistry
from repro.serve import paging as jpaging
from repro_torch import configs
from repro_torch.models import lm
from repro_torch.obs.metrics import Registry
from repro_torch.serve import decode
from repro_torch.serve import (PageAllocator, PageTable, PrefixRegistry,
                               gather_pages, gather_prefix,
                               paged_layer_names, pages_for, scatter_prefix,
                               scatter_token, validate_paged_support)


def alloc_of(num_pages, page_size, **kw):
    return PageAllocator(num_pages, page_size, device="cpu", **kw)


# ---------------------------------------------------------------------------
# allocator / page-table properties (tests/test_serve_paging.py:76-164)
# ---------------------------------------------------------------------------


def test_allocator_never_double_allocates():
    rng = np.random.default_rng(0)
    alloc = alloc_of(33, 8)
    held = []
    seen = set()
    for _ in range(200):
        if held and rng.random() < 0.45:
            pages = held.pop(int(rng.integers(len(held))))
            alloc.release(pages)
            seen.difference_update(pages.tolist())
            continue
        got = alloc.alloc([int(rng.integers(1, 4))])
        if got is None:
            assert alloc.free_count < 3    # only refuses when short
            continue
        (pages,) = got
        assert 0 not in pages.tolist()     # null page never handed out
        assert not (seen & set(pages.tolist())), "double allocation"
        seen.update(pages.tolist())
        held.append(pages)
    assert alloc.in_use == len(seen)


def test_allocator_roundtrip_and_batch_offsets():
    alloc = alloc_of(10, 4)                # 9 allocatable
    got = alloc.alloc([2, 3, 1])           # batched: one prefix-sum plan
    assert got is not None and [len(g) for g in got] == [2, 3, 1]
    flat = np.concatenate(got)
    assert len(set(flat.tolist())) == 6    # disjoint across the batch
    assert alloc.free_count == 3
    alloc.release(got[1])
    assert alloc.free_count == 6
    again = alloc.alloc([6])
    assert again is not None and alloc.free_count == 0


def test_allocator_exhaustion_is_explicit_and_all_or_nothing():
    alloc = alloc_of(6, 4)                 # 5 allocatable
    assert alloc.alloc([3]) is not None
    before = alloc.free_count
    assert alloc.alloc([1, 2]) is None     # 3 > 2 free: refuse the BATCH
    assert alloc.free_count == before      # nothing partially handed out
    assert alloc.stats is None             # counter path is engine-side


def test_allocator_rejects_null_free_and_double_free():
    alloc = alloc_of(8, 4)
    (pages,) = alloc.alloc([2])
    alloc.release(pages)
    with pytest.raises(ValueError):
        alloc.release(pages)               # double free
    with pytest.raises(ValueError):
        alloc.release(np.array([0]))       # null page is pinned
    with pytest.raises(ValueError):
        alloc_of(1, 4)                     # nothing left after null page


def test_defrag_plan_is_stable_partition():
    alloc = alloc_of(9, 4)
    a = alloc.alloc([3])[0]
    b = alloc.alloc([3])[0]
    alloc.release(a)                       # holes at a's positions
    dest = alloc.defrag_plan()
    assert dest[0] == 0                    # null page pinned by stability
    live_new = sorted(int(dest[p]) for p in b.tolist())
    assert live_new == list(range(1, 4))
    moved = alloc.apply_defrag(dest)
    assert moved == int((dest[b] != b).sum())
    assert alloc.free_count == 5
    assert alloc.fragmentation() == 0.0    # one contiguous free extent


def test_page_table_assign_release_remap():
    pt = PageTable(2, 4)
    pt.assign(0, np.array([5, 7]))
    pt.assign(0, np.array([2]))
    assert pt.pages_of(0).tolist() == [5, 7, 2]
    perm = np.arange(10)
    perm[[5, 7, 2]] = [1, 2, 3]
    pt.remap(perm)
    assert pt.pages_of(0).tolist() == [1, 2, 3]
    assert pt.release(0).tolist() == [1, 2, 3]
    assert pt.pages_of(0).size == 0 and int(pt.table[0].sum()) == 0
    with pytest.raises(ValueError):
        pt.assign(1, np.arange(1, 6))      # 5 > pages_per_seq
    assert pt.device("cpu").dtype == torch.int32


def test_pages_for_covers_next_write():
    assert pages_for(0, 8) == 1            # the first decode write
    assert pages_for(7, 8) == 1
    assert pages_for(8, 8) == 2            # position 8 needs page 1
    assert pages_for(17, 8) == 3


# ---------------------------------------------------------------------------
# refcounts and the prefix registry (tests/test_serve_paging.py:404-502)
# ---------------------------------------------------------------------------


def test_alloc_zero_total_is_noop():
    a = alloc_of(8, 4)
    out = a.alloc([0, 0, 0])
    assert [v.size for v in out] == [0, 0, 0]
    assert a.free_count == 7 and a.in_use == 0
    out = a.alloc([0, 2, 0, 1])
    assert [v.size for v in out] == [0, 2, 0, 1]
    with pytest.raises(ValueError):
        a.alloc([-1, 1])


def test_double_allocation_raises_runtime_error():
    a = alloc_of(6, 4)
    (pages,) = a.alloc([2])
    a.free[pages] = True                  # simulated bookkeeping corruption
    with pytest.raises(RuntimeError, match="double allocation"):
        a.alloc([4])


def test_fragmentation_pinned_at_occupancy_extremes():
    a = alloc_of(10, 4)
    assert a.fragmentation() == 0.0       # 9 contiguous free pages
    (pages,) = a.alloc([9])
    assert a.free_count == 0 and a.fragmentation() == 1.0
    a.release(pages[4:5])
    assert a.free_count == 1 and a.fragmentation() == 0.0
    a.release(pages[6:8])
    assert a.fragmentation() == pytest.approx(1.0 - 2.0 / 3.0)
    a.release(np.concatenate([pages[:4], pages[5:6], pages[8:]]))
    assert a.free_count == 9 and a.fragmentation() == 0.0
    assert a.longest_free_run() == 9


def test_retain_release_refcount_lifecycle():
    a = alloc_of(8, 4)
    (pages,) = a.alloc([2])
    assert (a.refcount[pages] == 1).all()
    a.retain(pages)
    assert (a.refcount[pages] == 2).all()
    a.release(pages)
    assert (a.refcount[pages] == 1).all() and a.in_use == 2
    a.release(pages)
    assert a.in_use == 0 and a.free[pages].all()
    with pytest.raises(ValueError, match="double free"):
        a.release(pages)
    with pytest.raises(ValueError, match="retain of free"):
        a.retain(pages)
    with pytest.raises(ValueError, match="null page"):
        a.retain(np.array([0]))
    before = a.epoch[int(pages[0])]
    a.alloc([2])
    assert a.epoch[int(pages[0])] == before + 1


def test_prefix_registry_lru_and_weak_staleness():
    a = alloc_of(16, 4)
    prompt = np.arange(10, dtype=np.int32)         # 2 full pages + partial
    (pages,) = a.alloc([pages_for(10, 4)])
    small = PrefixRegistry(a, page_size=4, capacity=2)
    small.register(prompt, pages)
    assert len(small) == 2 and len(small.strong_pages()) == 1
    assert a.refcount[pages[0]] == 1               # evicted -> released
    assert a.refcount[pages[1]] == 2               # surviving strong pin
    assert a.refcount[pages[2]] == 1               # partial is weak: no ref
    assert small.match(prompt) == []               # chain broken at page 0
    small.clear()
    assert a.refcount[pages[1]] == 1
    reg = PrefixRegistry(a, page_size=4, capacity=8)
    reg.register(prompt, pages)
    assert (a.refcount[pages[:2]] == 2).all()
    assert reg.match(prompt) == list(pages[:3])
    a.release(pages)
    assert a.free[pages[2]] and not a.free[pages[:2]].any()
    a.alloc([1])                                   # reused (epoch bump)
    assert reg.match(prompt) == list(pages[:2])    # stale weak tail dropped
    reg.clear()
    assert a.in_use == 1


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------


def test_allocator_plans_match_reference_bitwise():
    """The same alloc / release / defrag traffic gives the same page ids,
    refcounts, epochs, gauges and defrag plans on both."""
    rng = np.random.default_rng(3)
    mj, mt = JRegistry(), Registry()
    ref = jpaging.PageAllocator(40, 8, metrics=mj)
    got = alloc_of(40, 8, metrics=mt)
    held = []
    for step in range(40):
        if held and rng.random() < 0.4:
            pages = held.pop(int(rng.integers(len(held))))
            ref.release(pages)
            got.release(pages)
        elif step % 17 == 16:
            plan = ref.defrag_plan()
            assert np.array_equal(got.defrag_plan(), plan)
            assert got.apply_defrag(plan) == ref.apply_defrag(plan)
            held = [plan[p] for p in held]
        else:
            counts = rng.integers(0, 4, int(rng.integers(1, 4))).tolist()
            want, out = ref.alloc(counts), got.alloc(counts)
            assert (want is None) == (out is None)
            if want is not None:
                for w, o in zip(want, out):
                    assert np.array_equal(w, o)
                held += [w for w in want if w.size]
        for field in ("free", "refcount", "epoch"):
            assert np.array_equal(getattr(got, field), getattr(ref, field))
        for g in ("in_use", "free", "fragmentation"):
            assert mt.gauge(f"serve.pages.{g}").value == \
                mj.gauge(f"serve.pages.{g}").value


def test_device_views_match_reference_bitwise():
    rng = np.random.default_rng(4)
    pool = rng.standard_normal((7, 2, 4, 3)).astype(np.float32)
    table = np.array([[3, 1, 0], [5, 6, 2]], np.int32)
    assert np.array_equal(
        gather_pages(torch.from_numpy(pool), torch.from_numpy(table)).numpy(),
        np.asarray(jpaging.gather_pages(jnp.asarray(pool),
                                        jnp.asarray(table))))
    vals = rng.standard_normal((2, 2, 3)).astype(np.float32)
    at = np.array([5, 9], np.int32)
    got = scatter_token(torch.from_numpy(pool), torch.from_numpy(vals),
                        torch.from_numpy(table), torch.from_numpy(at))
    want = jpaging.scatter_token(jnp.asarray(pool), jnp.asarray(vals),
                                 jnp.asarray(table), jnp.asarray(at))
    assert np.array_equal(got.numpy(), np.asarray(want))
    pools = rng.standard_normal((3, 7, 2, 4, 3)).astype(np.float32)
    row = rng.standard_normal((3, 1, 2, 16, 3)).astype(np.float32)
    for pages, start in ((np.array([4, 2]), 1), (np.array([6, 1, 3]), 0),
                         (np.array([], np.int64), 2)):
        got = scatter_prefix(torch.from_numpy(pools), torch.from_numpy(row),
                             pages, start)
        want = jpaging.scatter_prefix(jnp.asarray(pools), jnp.asarray(row),
                                      pages, start)
        assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(
        gather_prefix(torch.from_numpy(pools),
                      torch.from_numpy(table)).numpy(),
        np.asarray(jpaging.gather_prefix(jnp.asarray(pools),
                                         jnp.asarray(table))))


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
@pytest.mark.parametrize("max_len,page_size", [(64, 8), (64, 24), (60, 8)])
def test_paged_support_matches_reference(arch, max_len, page_size):
    cfg, jcfg = configs.get_smoke_config(arch), \
        jconfigs.get_smoke_config(arch)
    assert paged_layer_names(cfg) == jpaging.paged_layer_names(jcfg)
    try:
        jpaging.validate_paged_support(jcfg, max_len, page_size)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            validate_paged_support(cfg, max_len, page_size)
        assert str(got.value) == str(e)
    else:
        validate_paged_support(cfg, max_len, page_size)


# ---------------------------------------------------------------------------
# paged decode == contiguous decode, bitwise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["zamba2-7b", "gemma2-9b"])
def test_paged_decode_bitwise_equals_contiguous(arch):
    """Two requests (40 and 13 tokens: gemma2's first fills and wraps its
    local layers' 32-slot rings) prefilled alone, then 6 greedy steps of
    both with per-row lengths: tokens and logits bitwise equal through
    the contiguous cache and through the pages."""
    cfg = dataclasses.replace(configs.get_smoke_config(arch),
                              dtype="float32")
    g = torch.Generator().manual_seed(5)
    model = lm.init_lm(cfg, generator=g, device="cpu")
    lens = torch.tensor([40, 13])
    prompts = [torch.randint(0, cfg.vocab_size, (int(n),), generator=g)
               for n in lens]
    max_len, ps, steps = 64, 8, 6
    with torch.no_grad():
        pre = decode.prefill_each(model, cfg, prompts, max_len)
        first = torch.cat([lg.argmax(-1) for lg, _ in pre])
        caches = [c for _, c in pre]
        contig = decode.contiguous_cache(caches)
        paged, alloc, table = decode.paged_cache(cfg, caches, lens,
                                                 max_len, ps, steps)
        assert alloc.in_use == sum(pages_for(int(n) + steps, ps)
                                   for n in lens)
        assert (table.counts > 0).all()
        t_c, l_c = decode.greedy_decode(model, cfg, contig, lens, first,
                                        steps)
        t_p, l_p = decode.greedy_decode(model, cfg, paged, lens, first, steps)
    assert torch.equal(t_c, t_p)
    assert torch.equal(l_c.view(torch.int32), l_p.view(torch.int32))
    assert bool(torch.isfinite(l_c).all())
