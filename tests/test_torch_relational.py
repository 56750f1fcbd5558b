"""The port's relational operators held against the JAX reference.

Re-runs the cases of ``tests/test_relational.py`` against
``repro_torch.relational``: each operator against its ground truth
(boolean-mask indexing, ``np.sort``/stable ``np.argsort``, numpy segment
folds, the nested-loop join) and, on fixed seeded inputs, against the
reference's own output — bitwise on integers and on the kernel routes
(the plain version of each kernel on the CPU), within the reference
tests' tolerance for float sums on the library route.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro import relational as jrel
from repro.relational import sort as jax_sort
from repro_torch import relational as rel
from repro_torch.core.scan import policy
from repro_torch.relational import groupby, sort

KEY_DTYPES = ("int32", "int16", "uint8", "uint32", "float32", "float16",
              "bool")


def _draw_keys(rng, dtype, n):
    if dtype == "bool":
        return rng.integers(0, 2, n).astype(bool)
    dt = np.dtype(dtype)
    if dt.kind == "f":
        return (rng.standard_normal(n) * 100).astype(dt)
    info = np.iinfo(dt)
    return rng.integers(info.min, int(info.max) + 1, n).astype(dt)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _bitwise(got, want):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape and g.dtype == w.dtype, (g.dtype, w.dtype)
    if g.dtype.kind == "f":
        g, w = g.view(f"u{g.itemsize}"), w.view(f"u{w.itemsize}")
    np.testing.assert_array_equal(g, w)


def _pairs(res):
    c = int(res.count)
    return sorted(zip(_np(res.left_index)[:c].tolist(),
                      _np(res.right_index)[:c].tolist()))


# ---------------------------------------------------------------------------
# filter / stream compaction
# ---------------------------------------------------------------------------


@given(st.lists(st.booleans(), min_size=0, max_size=300))
@settings(max_examples=30, deadline=None)
def test_filter_compact_matches_boolean_mask(mask):
    mask = np.asarray(mask, bool)
    T = len(mask)
    values = np.arange(10, 10 + T, dtype=np.int32)
    out, count = rel.filter_compact(_t(values), _t(mask))
    want = values[mask]
    assert int(count) == len(want)
    assert out.shape == (T,)
    np.testing.assert_array_equal(_np(out)[: len(want)], want)
    np.testing.assert_array_equal(_np(out)[len(want):], 0)


@pytest.mark.parametrize("algorithm", ["ref", "kernel"])
@pytest.mark.parametrize("n,sel", [(1, 0.5), (127, 0.3), (400, 0.8),
                                   (2500, 0.5)])
def test_compact_indices_bitwise_vs_reference(n, sel, algorithm):
    mask = np.random.default_rng(n).random(n) < sel
    wd, wc = jrel.compact_indices(jnp.asarray(mask), algorithm=algorithm,
                                  interpret=True)
    gd, gc = rel.compact_indices(_t(mask), algorithm=algorithm)
    _bitwise(gd, wd)
    _bitwise(gc, wc)
    wr = jrel.mask_ranks(jnp.asarray(mask), algorithm=algorithm,
                         interpret=True)
    _bitwise(rel.mask_ranks(_t(mask), algorithm=algorithm), wr)


@pytest.mark.parametrize("predicate", ["empty", "all_true", "all_false"])
def test_filter_compact_predicate_edges(predicate):
    T = 0 if predicate == "empty" else 64
    mask = torch.full((T,), predicate == "all_true", dtype=torch.bool)
    values = torch.arange(T, dtype=torch.int32)
    for algorithm in ("ref", "kernel"):
        out, count = rel.filter_compact(values, mask, algorithm=algorithm)
        want = values.numpy()[mask.numpy()]
        assert int(count) == len(want), (predicate, algorithm)
        np.testing.assert_array_equal(out.numpy()[: len(want)], want)


@given(st.integers(1, 400), st.floats(0.0, 1.0))
@settings(max_examples=10, deadline=None)
def test_compact_kernel_matches_ref(n, sel):
    """The mask-compact kernel route (plain versions here) == the
    library scan route."""
    mask = _t(np.random.default_rng(n).random(n) < sel)
    dest_r, count_r = rel.compact_indices(mask, algorithm="ref")
    dest_k, count_k = rel.compact_indices(mask, algorithm="kernel")
    assert torch.equal(dest_k, dest_r)
    assert int(count_k) == int(count_r)


def test_filter_compact_capacity_and_fill():
    values = torch.arange(8, dtype=torch.int32)
    mask = torch.tensor([1, 0, 1, 1, 0, 1, 1, 1], dtype=torch.bool)
    out, count = rel.filter_compact(values, mask, size=3, fill_value=-7)
    assert int(count) == 6  # true survivor count, beyond the cap
    assert out.tolist() == [0, 2, 3]
    out2, _ = rel.filter_compact(values, mask, size=8, fill_value=-7)
    assert out2.tolist()[6:] == [-7, -7]


def test_filter_compact_size_exceeds_input():
    """size > T must not leak dropped values through the T sentinel."""
    values = torch.tensor([1, 2, 3], dtype=torch.int32)
    mask = torch.tensor([True, False, False])
    out, count = rel.filter_compact(values, mask, size=5)
    assert int(count) == 1
    assert out.tolist() == [1, 0, 0, 0, 0]


def test_filter_compact_survivors_deterministic_with_parked_rows():
    """Every dropped row is parked at index ``cap`` (duplicate scatter
    indices, written in any order); the slot is sliced off, so the
    survivors must be exactly ``values[mask]``, run after run."""
    rng = np.random.default_rng(14)
    values = rng.standard_normal((3000, 4)).astype(np.float32)
    mask = rng.random(3000) < 0.1
    want = values[mask]
    for algorithm in ("ref", "kernel"):
        for _ in range(3):
            out, count = rel.filter_compact(_t(values), _t(mask),
                                            fill_value=-1.0,
                                            algorithm=algorithm)
            assert int(count) == len(want)
            _bitwise(out[:len(want)], want)
            assert bool((out[len(want):] == -1.0).all())
    jout, _ = jrel.filter_compact(jnp.asarray(values), jnp.asarray(mask),
                                  fill_value=-1.0)
    _bitwise(out, jout)


def test_mask_compact_kernel_zero_sized_batch():
    from repro_torch.kernels.compact import mask_compact
    dest, counts = mask_compact(torch.zeros((0, 5), dtype=torch.bool))
    assert dest.shape == (0, 5) and counts.shape == (0,)


def test_filter_compact_2d_rows():
    rng = np.random.default_rng(3)
    values = rng.standard_normal((20, 5)).astype(np.float32)
    mask = rng.random(20) < 0.5
    out, count = rel.filter_compact(_t(values), _t(mask))
    np.testing.assert_array_equal(out.numpy()[: int(count)], values[mask])


# ---------------------------------------------------------------------------
# partition
# ---------------------------------------------------------------------------


@given(st.lists(st.integers(0, 6), min_size=0, max_size=200))
@settings(max_examples=20, deadline=None)
def test_radix_partition_stable(ids):
    ids = np.asarray(ids, np.int32)
    payload = np.arange(len(ids), dtype=np.int32)
    plan, part_ids, part_payload = rel.radix_partition(_t(ids), 7,
                                                       _t(payload))
    if len(ids) == 0:
        assert part_ids.shape == (0,)
        return
    order = np.argsort(ids, kind="stable")
    np.testing.assert_array_equal(part_ids.numpy(), ids[order])
    np.testing.assert_array_equal(part_payload.numpy(), payload[order])
    np.testing.assert_array_equal(plan.counts.numpy(),
                                  np.bincount(ids, minlength=7))


def test_partition_plan_bitwise_vs_reference():
    ids = np.random.default_rng(4).integers(0, 9, 500).astype(np.int32)
    want = jrel.partition_plan(jnp.asarray(ids), 9)
    got = rel.partition_plan(_t(ids), 9)
    for g, w in zip(got, want):
        _bitwise(g, w)


# ---------------------------------------------------------------------------
# sort
# ---------------------------------------------------------------------------


@given(st.sampled_from(KEY_DTYPES), st.integers(0, 300))
@settings(max_examples=24, deadline=None)
def test_radix_sort_matches_numpy_sort(dtype, n):
    keys = _draw_keys(np.random.default_rng(n + 1), dtype, n)
    got = rel.radix_sort(_t(keys))
    assert got.dtype == _t(keys).dtype
    np.testing.assert_array_equal(got.numpy(), np.sort(keys))


@pytest.mark.parametrize("dtype", KEY_DTYPES)
def test_radix_digits_and_sort_bitwise_vs_reference(dtype):
    """The signed embedding yields the reference's radix digits, bit for
    bit, for every pass; the sorted keys and argsort match too."""
    keys = _draw_keys(np.random.default_rng(5), dtype, 257)
    u, bits = jax_sort._sortable_bits(jnp.asarray(keys))
    s, tbits = sort._sortable_bits(_t(keys))
    assert tbits == bits
    for shift in range(0, bits, 8):
        nb = 1 << min(8, bits - shift)
        want = ((u >> shift) & (nb - 1)).astype(jnp.int32)
        _bitwise(sort._digits(s, bits, shift, nb), want)
    _bitwise(rel.radix_sort(_t(keys)), jrel.radix_sort(jnp.asarray(keys)))
    _bitwise(rel.argsort(_t(keys)), jrel.argsort(jnp.asarray(keys)))


def test_sortable_bits_64bit_and_order():
    """64-bit keys (no x64 in the reference run) against numpy."""
    rng = np.random.default_rng(6)
    for keys in (rng.integers(-2 ** 62, 2 ** 62, 300),
                 rng.standard_normal(300) * 1e200,
                 rng.integers(0, 2 ** 63, 300).astype(np.uint64)):
        got = rel.radix_sort(_t(keys))
        np.testing.assert_array_equal(got.numpy(), np.sort(keys))


@given(st.integers(0, 200))
@settings(max_examples=20, deadline=None)
def test_argsort_stable(n):
    keys = np.random.default_rng(n).integers(0, 8, n).astype(np.int32)
    perm = rel.argsort(_t(keys))
    np.testing.assert_array_equal(perm.numpy(),
                                  np.argsort(keys, kind="stable"))


def test_radix_sort_payload_reordered():
    keys = torch.tensor([5, 1, 4, 1, 3], dtype=torch.int32)
    payload = torch.tensor([[0, 0], [1, 1], [2, 2], [3, 3], [4, 4]],
                           dtype=torch.float32)
    sk, sp = rel.radix_sort(keys, payload)
    assert sk.tolist() == [1, 1, 3, 4, 5]
    assert sp[:, 0].tolist() == [1, 3, 4, 2, 0]


def test_radix_sort_duplicates_and_extremes():
    keys = np.asarray([0, -(2 ** 31), 2 ** 31 - 1, 0, -1, 1, -(2 ** 31)],
                      np.int32)
    np.testing.assert_array_equal(rel.radix_sort(_t(keys)).numpy(),
                                  np.sort(keys))
    fkeys = np.asarray([0.0, -0.0, np.inf, -np.inf, 1e-38, -1e38],
                       np.float32)
    got = rel.radix_sort(_t(fkeys))
    _bitwise(got, jrel.radix_sort(jnp.asarray(fkeys)))
    np.testing.assert_array_equal(got.numpy(), np.sort(fkeys))


# ---------------------------------------------------------------------------
# group-by
# ---------------------------------------------------------------------------


@given(st.lists(st.integers(0, 5), min_size=0, max_size=200))
@settings(max_examples=20, deadline=None)
def test_group_by_sum_matches_segment_sum(ids):
    G = 6
    ids = np.asarray(ids, np.int32)
    values = np.random.default_rng(len(ids)).integers(
        -50, 50, len(ids)).astype(np.int32)
    got = rel.group_by(_t(ids), _t(values), G, "sum")
    want = np.zeros(G, np.int32)
    np.add.at(want, ids, values)
    _bitwise(got, want)


def test_group_by_float_sum_close():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 4, 100).astype(np.int32)
    values = rng.standard_normal(100).astype(np.float32)
    got = rel.group_by(_t(ids), _t(values), 4, "sum")
    want = jax.ops.segment_sum(jnp.asarray(values), jnp.asarray(ids),
                               num_segments=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    # the library route is the reference's association exactly
    _bitwise(got, jrel.group_by(jnp.asarray(ids), jnp.asarray(values), 4,
                                "sum"))


@pytest.mark.parametrize("agg", ["max", "min", "count", "mean", "prod"])
def test_group_by_aggs_vs_numpy_and_reference(agg):
    rng = np.random.default_rng(1)
    G = 5
    ids = rng.integers(0, G, 80).astype(np.int32)
    values = rng.integers(-100, 100, 80).astype(np.int32)
    if agg == "prod":
        values = rng.integers(-3, 4, 80).astype(np.int32)
    got = rel.group_by(_t(ids), _t(values), G, agg)
    _bitwise(got, jrel.group_by(jnp.asarray(ids), jnp.asarray(values), G,
                                agg))
    got = got.numpy()
    for g in range(G):
        vals = values[ids == g]
        if agg == "count":
            assert got[g] == len(vals)
        elif len(vals) == 0:
            ident = {"max": np.iinfo(np.int32).min, "prod": 1,
                     "min": np.iinfo(np.int32).max, "mean": 0.0}[agg]
            assert got[g] == ident
        elif agg == "mean":
            np.testing.assert_allclose(got[g], vals.mean(), rtol=1e-6)
        else:
            assert got[g] == {"max": vals.max, "min": vals.min,
                              "prod": vals.prod}[agg]()


def test_group_by_vector_values():
    ids = torch.tensor([0, 1, 0, 2], dtype=torch.int32)
    values = torch.tensor([[1, 2], [3, 4], [5, 6], [7, 8]], dtype=torch.int32)
    got = rel.group_by(ids, values, 3, "sum")
    assert got.tolist() == [[6, 8], [3, 4], [7, 8]]


def test_group_by_kernel_path_bitwise_vs_reference():
    """The segmented-sum kernel route (long runs on a CUDA tensor; forced
    here, running the plain kernels): bitwise equal to the reference's
    kernel route, integer, float-mean and vector values alike."""
    rng = np.random.default_rng(7)
    G, T = 9, 4096
    ids = rng.integers(0, G, T).astype(np.int32)
    vals_i = rng.integers(-50, 50, T).astype(np.int32)
    vals_f = rng.standard_normal(T).astype(np.float32)
    vals_v = rng.integers(-9, 9, (T, 3)).astype(np.int32)
    for vals, agg in ((vals_i, "sum"), (vals_f, "mean"), (vals_f, "sum"),
                      (vals_v, "sum")):
        got = rel.group_by(_t(ids), _t(vals), G, agg, algorithm="kernel")
        want = jrel.group_by(jnp.asarray(ids), jnp.asarray(vals), G, agg,
                             algorithm="kernel")
        _bitwise(got, want)
    seg = np.zeros(G, np.int64)
    np.add.at(seg, ids, vals_i)
    np.testing.assert_array_equal(
        rel.group_by(_t(ids), _t(vals_i), G, "sum",
                     algorithm="kernel").numpy(), seg)


def test_group_by_auto_gate_is_policy_thresholded():
    """On the CPU auto stays on the library scan; for a CUDA tensor the
    gate follows ``policy.choose`` (kernel only past the block budget)."""
    small = policy.VMEM_BLOCK_BUDGET // 4 // 2  # f32 elems, half budget
    big = policy.VMEM_BLOCK_BUDGET // 4 * 2
    sa = groupby._seg_algorithm
    assert sa("ref", "sum", big, 4, True) == "ref"
    assert sa("kernel", "sum", small, 4) == "kernel"
    assert sa("auto", "sum", big, 4, True) == "kernel"
    assert sa("auto", "sum", small, 4, True) == "ref"
    assert sa("auto", "sum", big, 4) == "ref"  # a CPU tensor
    assert sa("auto", "max", big, 4, True) == "ref"  # non-sum monoid
    with pytest.raises(ValueError):
        sa("bogus", "sum", big, 4)


@given(st.lists(st.integers(-20, 20), min_size=0, max_size=150))
@settings(max_examples=20, deadline=None)
def test_group_by_sorted_runs(raw):
    keys = np.sort(np.asarray(raw, np.int32))
    values = np.random.default_rng(len(keys)).integers(
        0, 10, len(keys)).astype(np.int32)
    uniq, aggs, count = rel.group_by_sorted(_t(keys), _t(values), "sum")
    n = int(count)
    if len(keys) == 0:
        assert n == 0
        return
    uref, inv = np.unique(keys, return_inverse=True)
    aref = np.zeros(len(uref), np.int64)
    np.add.at(aref, inv, values)
    assert n == len(uref)
    np.testing.assert_array_equal(uniq.numpy()[:n], uref)
    np.testing.assert_array_equal(aggs.numpy()[:n].astype(np.int64), aref)


@pytest.mark.parametrize("agg", ["sum", "count", "mean", "max"])
def test_group_by_sorted_bitwise_vs_reference(agg):
    rng = np.random.default_rng(8)
    keys = np.sort(rng.integers(-5, 5, 60)).astype(np.int32)
    values = rng.integers(-9, 9, 60).astype(np.int32)
    got = rel.group_by_sorted(_t(keys), _t(values), agg)
    want = jrel.group_by_sorted(jnp.asarray(keys), jnp.asarray(values), agg)
    for g, w in zip(got, want):
        _bitwise(g, w)


def test_group_by_count_shape_with_vector_values():
    full = rel.group_by(torch.tensor([0, 2], dtype=torch.int32),
                        torch.ones((2, 3)), 4, "count")
    empty = rel.group_by(torch.zeros((0,), dtype=torch.int32),
                         torch.ones((0, 3)), 4, "count")
    assert full.shape == empty.shape == (4,)
    assert full.tolist() == [1, 0, 1, 0]


# ---------------------------------------------------------------------------
# join
# ---------------------------------------------------------------------------


@given(st.lists(st.integers(0, 8), min_size=0, max_size=60),
       st.lists(st.integers(0, 8), min_size=0, max_size=60))
@settings(max_examples=15, deadline=None)
def test_hash_join_matches_nested_loop(lk, rk):
    res = rel.hash_join(torch.tensor(lk, dtype=torch.int32),
                        torch.tensor(rk, dtype=torch.int32))
    want = sorted((i, j) for i, a in enumerate(lk)
                  for j, b in enumerate(rk) if a == b)
    assert _pairs(res) == want
    assert (res.left_index.numpy()[int(res.count):] == -1).all()


@pytest.mark.parametrize("dtype", ["int32", "int16", "uint32", "float32"])
def test_hash_join_bitwise_vs_reference(dtype):
    """Pairs, their order, the bound and the count are the reference's."""
    rng = np.random.default_rng(9)
    lk = rng.integers(0, 40, 300).astype(dtype)
    rk = rng.integers(0, 40, 200).astype(dtype)
    assert rel.estimate_max_matches(_t(lk), _t(rk)) == \
        jrel.estimate_max_matches(jnp.asarray(lk), jnp.asarray(rk))
    for mm in ("auto", None, 50):
        got = rel.hash_join(_t(lk), _t(rk), max_matches=mm)
        want = jrel.hash_join(jnp.asarray(lk), jnp.asarray(rk),
                              max_matches=mm)
        for g, w in zip(got, want):
            _bitwise(g, w)


def test_hash_join_capped():
    lk = torch.tensor([1, 2, 3, 2], dtype=torch.int32)
    rk = torch.tensor([2, 2, 9], dtype=torch.int32)
    res = rel.hash_join(lk, rk, max_matches=16)
    assert int(res.count) == 4
    assert _pairs(res) == [(1, 0), (1, 1), (3, 0), (3, 1)]
    res2 = rel.hash_join(lk, rk, max_matches=2)
    assert int(res2.count) == 4
    assert res2.left_index.shape == (2,)


def test_hash_join_overflow_guard():
    """A join whose pair count wraps int32 must raise, not silently
    return garbage — under the default bound and the exact path."""
    keys = torch.zeros((66_000,), dtype=torch.int32)  # 66000^2 wraps
    with pytest.raises(OverflowError):
        rel.hash_join(keys, keys)
    with pytest.raises(OverflowError):
        rel.hash_join(keys, keys, max_matches=None)


def test_hash_join_auto_capacity_is_spill_safe():
    rng = np.random.default_rng(11)
    lk = rng.integers(0, 4, 300).astype(np.int32)
    rk = rng.integers(0, 6, 200).astype(np.int32)
    bound = rel.estimate_max_matches(_t(lk), _t(rk))
    res = rel.hash_join(_t(lk), _t(rk))
    c = int(res.count)
    assert res.left_index.shape[0] == bound >= c
    want = sorted((i, j) for i, a in enumerate(lk)
                  for j, b in enumerate(rk) if a == b)
    assert _pairs(res) == want
    assert (res.left_index.numpy()[c:] == -1).all()
    res_small = rel.hash_join(_t(lk), _t(rk), max_matches=5)
    assert int(res_small.count) == len(want)
    assert res_small.left_index.shape == (5,)


def test_estimate_max_matches_float_and_empty():
    assert rel.estimate_max_matches(torch.zeros((0,), dtype=torch.int32),
                                    torch.zeros((3,), dtype=torch.int32)) == 0
    lk = np.asarray([0.5, -1.25, 3.0, 0.5, -0.0], np.float32)
    rk = np.asarray([3.0, 0.5, 0.5, 0.0], np.float32)
    bound = rel.estimate_max_matches(_t(lk), _t(rk))
    assert bound == jrel.estimate_max_matches(jnp.asarray(lk),
                                              jnp.asarray(rk))
    assert bound >= int(rel.hash_join(_t(lk), _t(rk)).count) == 6


def test_hash_join_float_keys():
    lk = torch.tensor([0.5, -1.25, 3.0])
    rk = torch.tensor([3.0, 0.5, 0.5])
    assert _pairs(rel.hash_join(lk, rk)) == [(0, 1), (0, 2), (2, 0)]


def test_hash_join_rejects_mixed_key_dtypes():
    with pytest.raises(TypeError):
        rel.hash_join(torch.tensor([1.0, 2.0]),
                      torch.tensor([1, 2], dtype=torch.int32))


def test_hash_join_float_nan_and_signed_zero():
    """NaN keys match nothing (even a build NaN that radix-orders before
    -inf must not corrupt the search for real keys); -0.0 matches +0.0."""
    neg_nan = np.frombuffer(np.uint32(0xFFC00000).tobytes(), np.float32)[0]
    lk = np.asarray([-1.0, 0.5, 2.0, np.nan, 0.0], np.float32)
    rk = np.asarray([neg_nan, -1.0, 0.5, 2.0, -0.0], np.float32)
    res = rel.hash_join(_t(lk), _t(rk))
    assert _pairs(res) == [(0, 1), (1, 2), (2, 3), (4, 4)]
    want = jrel.hash_join(jnp.asarray(lk), jnp.asarray(rk))
    for g, w in zip(res, want):
        _bitwise(g, w)


def test_relational_exports_match_reference():
    assert sorted(rel.__all__) == sorted(jrel.__all__)
