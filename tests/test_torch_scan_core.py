"""The port's library scan algorithms and API routing vs the reference.

The same numpy inputs go through ``repro.core.scan`` (JAX, CPU) and
``repro_torch.core.scan`` (PyTorch, CPU). The sequential oracle, the
horizontal network, the vertical (V1, V2) and tree algorithms, the
blocked scan and the two-pass organizations keep the reference's order
of operations, so sums, max, min and prod agree bitwise; the affine
monoid (a product and a multiply-add per step) is held to the reference
tests' float tolerance where the reference runs it inside a compiled
``lax.scan`` (XLA's CPU compiler contracts ``a2 * b1 + b2`` into an FMA
there), and bitwise where it runs op by op (the tree; the vertical scan
under ``jax.disable_jit``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import scan as jscan
from repro_torch.core import scan as tscan
from repro_torch.core.scan import api, policy

OPS = ("sum", "max", "min", "prod")


def _data(op, n, seed=0):
    rng = np.random.default_rng(seed)
    if op == "prod":
        return rng.uniform(0.5, 1.5, n).astype(np.float32)
    return rng.standard_normal(n).astype(np.float32)


def _assert_bitwise(got, want):
    got = got.numpy()
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got.view(np.uint32) if got.dtype ==
                                  np.float32 else got,
                                  want.view(np.uint32) if want.dtype ==
                                  np.float32 else want)


@pytest.mark.parametrize("exclusive", [False, True])
@pytest.mark.parametrize("op", OPS)
def test_scan_ref_bitwise(op, exclusive):
    x = _data(op, 100)
    want = jscan.scan_ref(jnp.asarray(x), op, exclusive=exclusive)
    got = tscan.scan_ref(torch.from_numpy(x), op, exclusive=exclusive)
    _assert_bitwise(got, want)


def test_scan_ref_reverse_and_axis():
    x = _data("sum", 60, seed=1).reshape(6, 10)
    for axis in (0, 1):
        want = jscan.scan_ref(jnp.asarray(x), "sum", axis=axis, reverse=True)
        got = tscan.scan_ref(torch.from_numpy(x), "sum", axis=axis,
                             reverse=True)
        _assert_bitwise(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_cumsum_ref_dtypes(dtype):
    x = np.random.default_rng(2).integers(-5, 5, 257)
    xj = jnp.asarray(x, getattr(jnp, dtype))
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        getattr(torch, dtype))
    want = jscan.cumsum_ref(xj)
    got = tscan.cumsum_ref(xt)
    assert got.dtype == xt.dtype
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("n", [1, 7, 100, 1024])
@pytest.mark.parametrize("op", OPS)
def test_horizontal_bitwise(op, n):
    x = _data(op, n, seed=n)
    for exclusive in (False, True):
        want = jscan.scan_horizontal(jnp.asarray(x), op, exclusive=exclusive)
        got = tscan.scan_horizontal(torch.from_numpy(x), op,
                                    exclusive=exclusive)
        _assert_bitwise(got, want)


@pytest.mark.parametrize("block_size", [1, 32, 100, 4096])
@pytest.mark.parametrize("op", OPS)
def test_blocked_bitwise(op, block_size):
    x = _data(op, 515, seed=3)
    for exclusive in (False, True):
        want = jscan.scan_blocked(jnp.asarray(x), op, block_size=block_size,
                                  exclusive=exclusive)
        got = tscan.scan_blocked(torch.from_numpy(x), op,
                                 block_size=block_size, exclusive=exclusive)
        _assert_bitwise(got, want)


def test_blocked_ref_inner_and_2d_axes():
    x = _data("sum", 6 * 33, seed=4).reshape(6, 33)
    for axis in (0, 1, -1):
        want = jscan.scan_blocked(jnp.asarray(x), "sum", axis=axis,
                                  block_size=8, inner="ref")
        got = tscan.scan_blocked(torch.from_numpy(x), "sum", axis=axis,
                                 block_size=8, inner="ref")
        _assert_bitwise(got, want)


@pytest.mark.parametrize("variant", [1, 2])
@pytest.mark.parametrize("dilation", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("op", OPS)
def test_two_pass_bitwise(op, variant, dilation):
    x = _data(op, 515, seed=9)
    want = jscan.scan_two_pass(jnp.asarray(x), op, num_partitions=5,
                               variant=variant, dilation=dilation)
    got = tscan.scan_two_pass(torch.from_numpy(x), op, num_partitions=5,
                              variant=variant, dilation=dilation)
    _assert_bitwise(got, want)


@pytest.mark.parametrize("parts,dilation", [(1, 1.0), (4, 0.0), (8, 0.37),
                                            (5, 1.0)])
def test_partition_sizes_match(parts, dilation):
    assert tscan.partition_sizes(1000, parts, dilation) == \
        jscan.partition_sizes(1000, parts, dilation)


@pytest.mark.parametrize("algo", ["ref", "horizontal", "blocked"])
def test_affine_monoid(algo):
    rng = np.random.default_rng(3)
    a = rng.uniform(0.8, 1.0, 200).astype(np.float32)
    b = rng.standard_normal(200).astype(np.float32)
    kw = {"block_size": 32} if algo == "blocked" else {}
    want = jscan.scan((jnp.asarray(a), jnp.asarray(b)), "affine",
                      algorithm=algo, **kw)
    got = tscan.scan((torch.from_numpy(a), torch.from_numpy(b)), "affine",
                     algorithm=algo, **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


def test_fold_is_tree_shaped_like_reference():
    x = _data("sum", 37, seed=5)
    want = jscan.SUM.fold(jnp.asarray(x))
    got = tscan.SUM.fold(torch.from_numpy(x))
    _assert_bitwise(got, want)
    with pytest.raises(ValueError):
        tscan.SUM.fold(torch.zeros(0))


# ---------------------------------------------------------------------------
# api.scan routing
# ---------------------------------------------------------------------------


ALGOS = ("ref", "horizontal", "vertical", "tree", "blocked", "two_pass",
         "kernel")


@pytest.mark.parametrize("algo", ALGOS + ("auto",))
@pytest.mark.parametrize("exclusive", [False, True])
@pytest.mark.parametrize("n", [0, 1])
def test_degenerate_lengths_match_reference(algo, exclusive, n):
    x = np.random.default_rng(7).standard_normal((3, n)).astype(np.float32)
    want = jscan.scan(jnp.asarray(x), "sum", axis=-1,
                      algorithm="ref" if algo == "auto" else algo,
                      exclusive=exclusive)
    got = tscan.scan(torch.from_numpy(x), "sum", axis=-1, algorithm=algo,
                     exclusive=exclusive)
    assert got.shape == x.shape and got.dtype == torch.float32
    _assert_bitwise(got, want)


@pytest.mark.parametrize("algo", ALGOS)
def test_api_routes_match_reference(algo):
    x = np.random.default_rng(8).standard_normal((6, 257)).astype(np.float32)
    kw = {"interpret": True} if algo == "kernel" else {}
    for exclusive in (False, True):
        want = jscan.scan(jnp.asarray(x), "sum", axis=1, algorithm=algo,
                          exclusive=exclusive, **kw)
        got = tscan.scan(torch.from_numpy(x), "sum", axis=1, algorithm=algo,
                         exclusive=exclusive)
        _assert_bitwise(got, want)


def test_auto_routes_like_reference(monkeypatch):
    """'auto' picks the reference's algorithm: horizontal while the data
    fits the fast-memory budget, the kernel (with the policy's schedule)
    beyond it. The budget is shrunk so the kernel branch runs at a test
    size."""
    small = np.random.default_rng(9).standard_normal(1000).astype(np.float32)
    got = tscan.cumsum(torch.from_numpy(small))
    _assert_bitwise(got, jscan.scan_horizontal(jnp.asarray(small), "sum"))

    seen = {}
    real = api.policy.choose

    def spy(*a, **k):
        seen["choice"] = real(*a, **k)
        return seen["choice"]

    monkeypatch.setattr(policy, "VMEM_BLOCK_BUDGET", 1024)
    monkeypatch.setattr(api.policy, "choose", spy)
    x = np.random.default_rng(10).standard_normal(8 * 2048).astype(
        np.float32)
    got = tscan.cumsum(torch.from_numpy(x))
    assert seen["choice"].algorithm == "kernel"
    assert seen["choice"].schedule == "fused"
    want = jscan.scan(jnp.asarray(x), "sum", algorithm="kernel",
                      interpret=True, schedule="fused")
    _assert_bitwise(got, want)


def test_unknown_algorithm_and_monoid():
    with pytest.raises(ValueError):
        tscan.scan(torch.ones(8), "sum", algorithm="bogus")
    with pytest.raises(ValueError):
        tscan.scan(torch.ones(8), "bogus")


# ---------------------------------------------------------------------------
# The paper's vertical (§3.2) and tree (§3.3) algorithms: the cases of
# tests/test_scan_core.py for them (ALGOS :11, :23-68, :232-256), port
# against reference
# ---------------------------------------------------------------------------


ORACLES = ("vertical", "tree")


def _assert_tree_bitwise(got, want):
    for g, w in zip(got, want):
        _assert_bitwise(g.contiguous(), np.ascontiguousarray(w))


@pytest.mark.parametrize("n", [1, 2, 7, 16, 100, 1024, 4100])
@pytest.mark.parametrize("algo", ORACLES)
def test_oracle_cumsum_bitwise(algo, n):
    """test_cumsum_matches_numpy and test_exclusive: float32 sums, the
    reference's association, so the same bits."""
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    for exclusive in (False, True):
        want = jscan.scan(jnp.asarray(x), "sum", algorithm=algo,
                          exclusive=exclusive)
        got = tscan.scan(torch.from_numpy(x), "sum", algorithm=algo,
                         exclusive=exclusive)
        _assert_bitwise(got, want)


@pytest.mark.parametrize("dtype", ["int32", "float32", "bfloat16"])
@pytest.mark.parametrize("algo", ORACLES)
def test_oracle_dtypes_bitwise(algo, dtype):
    """test_dtypes: integer-valued data in each dtype, bitwise."""
    x = np.random.default_rng(0).integers(-5, 5, 257)
    xj = jnp.asarray(x, getattr(jnp, dtype))
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        getattr(torch, dtype))
    want = jscan.scan(xj, "sum", algorithm=algo)
    got = tscan.scan(xt, "sum", algorithm=algo)
    assert got.dtype == xt.dtype
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("axis", [0, 1, -1])
@pytest.mark.parametrize("algo", ORACLES)
def test_oracle_axes_2d_bitwise(algo, axis):
    x = np.random.default_rng(1).standard_normal((6, 33)).astype(np.float32)
    want = jscan.scan(jnp.asarray(x), "sum", axis=axis, algorithm=algo)
    got = tscan.scan(torch.from_numpy(x), "sum", axis=axis, algorithm=algo)
    _assert_bitwise(got.contiguous(), want)


@pytest.mark.parametrize("op", ["max", "min", "prod"])
@pytest.mark.parametrize("algo", ORACLES)
def test_oracle_other_monoids_bitwise(algo, op):
    """test_other_monoids (tree; vertical added): max, min, prod."""
    x = np.random.default_rng(2).uniform(0.5, 1.5, 100).astype(np.float32)
    for exclusive in (False, True):
        want = jscan.scan(jnp.asarray(x), op, algorithm=algo,
                          exclusive=exclusive)
        got = tscan.scan(torch.from_numpy(x), op, algorithm=algo,
                         exclusive=exclusive)
        _assert_bitwise(got, want)


@pytest.mark.parametrize("lanes", [1, 5, 16, 600])
@pytest.mark.parametrize("variant", [1, 2])
def test_vertical_variants_and_lanes_bitwise(variant, lanes):
    """V1 and V2 at lane counts that divide n and that do not (identity
    padding), more lanes than elements included, on 2-D data along both
    axes."""
    x = np.random.default_rng(3).standard_normal((5, 515)).astype(np.float32)
    for axis, exclusive in ((0, True), (1, False)):
        want = jscan.scan_vertical(jnp.asarray(x), "sum", axis=axis,
                                   lanes=lanes, variant=variant,
                                   exclusive=exclusive)
        got = tscan.scan_vertical(torch.from_numpy(x), "sum", axis=axis,
                                  lanes=lanes, variant=variant,
                                  exclusive=exclusive)
        _assert_bitwise(got.contiguous(), want)
    with pytest.raises(ValueError, match="variant"):
        tscan.scan_vertical(torch.ones(8), variant=3)


def _affine_data(n):
    rng = np.random.default_rng(n)
    return (rng.uniform(0.5, 1.5, n).astype(np.float32),
            rng.standard_normal(n).astype(np.float32))


@pytest.mark.parametrize("exclusive", [False, True])
@pytest.mark.parametrize("n", [3, 5, 37, 100, 130])
@pytest.mark.parametrize("algo", ORACLES)
def test_oracle_affine_non_commutative(algo, n, exclusive):
    """test_tree_oracle_affine_non_commutative (vertical added): within
    the reference test's tolerance of the reference and of the
    sequential oracle; bitwise against the reference run op by op (the
    tree always is; the vertical scan's lax.scan under disable_jit, where
    XLA contracts no multiply-add)."""
    a, b = _affine_data(n)
    ta_, tb_ = torch.from_numpy(a), torch.from_numpy(b)
    got = tscan.scan((ta_, tb_), "affine", algorithm=algo,
                     exclusive=exclusive)
    want = jscan.scan((jnp.asarray(a), jnp.asarray(b)), "affine",
                      algorithm=algo, exclusive=exclusive)
    ref = tscan.scan_ref((ta_, tb_), "affine", exclusive=exclusive)
    for g, w, r in zip(got, want, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=2e-4,
                                   atol=1e-4)
    if algo == "vertical":
        with jax.disable_jit():
            want = jscan.scan((jnp.asarray(a), jnp.asarray(b)), "affine",
                              algorithm=algo, exclusive=exclusive)
    _assert_tree_bitwise(got, want)


@pytest.mark.parametrize("n", [3, 37, 130])
@pytest.mark.parametrize("algo", ORACLES)
def test_oracle_segmented_non_commutative(algo, n):
    """test_tree_oracle_segmented_non_commutative (vertical added):
    integer-valued values and float flags, bitwise."""
    rng = np.random.default_rng(n)
    vals = rng.integers(-4, 5, n).astype(np.float32)
    flags = (rng.random(n) < 0.3).astype(np.float32)
    want = jscan.scan((jnp.asarray(flags), jnp.asarray(vals)),
                      jscan.assoc.segmented(jscan.assoc.get("sum")),
                      algorithm=algo)
    got = tscan.scan((torch.from_numpy(flags), torch.from_numpy(vals)),
                     tscan.assoc.segmented(tscan.assoc.get("sum")),
                     algorithm=algo)
    _assert_tree_bitwise(got, want)


@pytest.mark.parametrize("algo", ORACLES)
def test_oracle_matrix_affine(algo):
    """MATRIX_AFFINE through both algorithms: a per-step decay broadcast
    over a (2, 3) matrix update, against the reference (bitwise op by
    op) and the sequential oracle."""
    rng = np.random.default_rng(11)
    a = rng.uniform(0.5, 1.5, (19, 1, 1)).astype(np.float32)
    B = rng.standard_normal((19, 2, 3)).astype(np.float32)
    a_full = np.ascontiguousarray(np.broadcast_to(a, B.shape))
    for exclusive in (False, True):
        got = tscan.scan((torch.from_numpy(a_full), torch.from_numpy(B)),
                         "matrix_affine", axis=0, algorithm=algo,
                         exclusive=exclusive)
        with jax.disable_jit():
            want = jscan.scan((jnp.asarray(a_full), jnp.asarray(B)),
                              "matrix_affine", axis=0, algorithm=algo,
                              exclusive=exclusive)
        _assert_tree_bitwise(got, want)
        ref = tscan.scan_ref((torch.from_numpy(a_full), torch.from_numpy(B)),
                             "matrix_affine", axis=0, exclusive=exclusive)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=2e-4,
                                       atol=1e-4)


@pytest.mark.parametrize("exclusive", [False, True])
@pytest.mark.parametrize("algo", ORACLES)
def test_oracle_degenerate_multi_leaf(algo, exclusive):
    """test_degenerate_lengths_multi_leaf: the affine pair over an empty
    axis keeps its shape."""
    e = torch.zeros((2, 0))
    out_a, out_b = tscan.scan((e, e), "affine", axis=-1, algorithm=algo,
                              exclusive=exclusive)
    assert out_a.shape == (2, 0) and out_b.shape == (2, 0)


def test_oracles_leave_their_input_alone():
    """The tree's in-place sweeps work on a copy of the input."""
    x = torch.arange(16, dtype=torch.float32)
    keep = x.clone()
    for algo in ORACLES:
        tscan.scan(x, "sum", algorithm=algo)
        tscan.scan(x[None], "sum", axis=1, algorithm=algo)
        assert torch.equal(x, keep), algo
