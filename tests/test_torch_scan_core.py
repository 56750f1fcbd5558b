"""The port's library scan algorithms and API routing vs the reference.

The same numpy inputs go through ``repro.core.scan`` (JAX, CPU) and
``repro_torch.core.scan`` (PyTorch, CPU). The sequential oracle, the
horizontal network, the blocked scan and the two-pass organizations keep
the reference's order of operations, so sums, max, min and prod agree
bitwise; the affine monoid (a product and a multiply-add per step) is
held to the reference tests' float tolerance.
"""

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


ALGOS = ("ref", "horizontal", "blocked", "two_pass", "kernel")


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


@pytest.mark.parametrize("algo", ["vertical", "tree"])
def test_unported_oracles_raise(algo):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tscan.scan(torch.ones(8), "sum", algorithm=algo)


def test_unknown_algorithm_and_monoid():
    with pytest.raises(ValueError):
        tscan.scan(torch.ones(8), "sum", algorithm="bogus")
    with pytest.raises(ValueError):
        tscan.scan(torch.ones(8), "bogus")
