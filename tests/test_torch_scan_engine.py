"""The port's scan engine held against the JAX reference, bit for bit.

The same numpy inputs go through ``repro.kernels.scan_blocked.ops.cumsum``
(Pallas in interpret mode, as the reference's own tests run it on the
CPU) and through ``repro_torch.kernels.scan_blocked.ops.cumsum`` (the
plain PyTorch version of each kernel on a CPU tensor). The port keeps
the reference's association order, so every schedule, dtype and mode
must agree BITWISE, floats included.

The CUDA kernels are held against these plain versions in
``tests/test_torch_cuda_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import scan_engine as jax_engine
from repro.kernels.scan_blocked import ops as jax_ops
from repro.kernels.scan_engine import monoids as jax_monoids
from repro_torch.kernels import scan_engine
from repro_torch.kernels.scan_blocked import ops
from repro_torch.kernels.scan_engine import monoids, schedules

SCHEDULES4 = ("carry", "decoupled", "fused", "tree")
DTYPES = ("float32", "bfloat16", "int32")

# (id, shape, axis, extra kwargs): the reference tests' shapes.
CASES = [
    ("2x4096_bn512", (2, 4096), -1, {"block_n": 512}),
    ("1x128", (1, 128), -1, {}),
    ("3x517", (3, 517), -1, {}),
    ("8x4096", (8, 4096), -1, {}),
    ("axis0", (5, 300), 0, {}),
    ("3d", (2, 3, 640), -1, {}),
]


def _inputs(shape, dtype, seed=0):
    """The same data for both packages: (jax array, torch tensor)."""
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        x = rng.integers(-9, 9, shape).astype(np.int32)
    else:
        x = rng.standard_normal(shape).astype(np.float32)
    xj = jnp.asarray(x, getattr(jnp, dtype))
    xt = torch.from_numpy(
        np.array(xj.astype(jnp.float32)) if dtype == "bfloat16"
        else np.array(xj)).to(getattr(torch, dtype))
    return xj, xt


def _bits(a):
    """Bit pattern of a jax array or torch tensor (bf16 widened
    losslessly to f32)."""
    if isinstance(a, torch.Tensor):
        a = a.float() if a.dtype == torch.bfloat16 else a
        a = a.numpy()
    else:
        a = np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16
                       else a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _assert_bitwise(got, want):
    assert got.shape == tuple(want.shape)
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("schedule", SCHEDULES4)
@pytest.mark.parametrize("exclusive", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_cumsum_bitwise_vs_reference(case, dtype, exclusive, schedule):
    _, shape, axis, kw = case
    xj, xt = _inputs(shape, dtype)
    want = jax_ops.cumsum(xj, axis=axis, exclusive=exclusive, interpret=True,
                          schedule=schedule, **kw)
    got = ops.cumsum(xt, axis=axis, exclusive=exclusive, schedule=schedule,
                     **kw)
    assert got.dtype == xt.dtype
    _assert_bitwise(got, want)


@pytest.mark.parametrize("exclusive", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_carry_decoupled_fused_bitwise_inside_port(dtype, exclusive):
    _, xt = _inputs((2, 4096), dtype, seed=3)
    outs = [ops.cumsum(xt, exclusive=exclusive, schedule=s, block_n=512)
            for s in ("carry", "decoupled", "fused")]
    for o in outs[1:]:
        _assert_bitwise(o, outs[0])


@pytest.mark.parametrize("exclusive", [False, True])
def test_tree_exact_data_bitwise_with_carry(exclusive):
    """On integer-valued floats the tree's association is exact."""
    rng = np.random.default_rng(20)
    x = torch.from_numpy(rng.integers(-9, 9, (2, 4096)).astype(np.float32))
    tree = ops.cumsum(x, exclusive=exclusive, schedule="tree", block_n=512)
    carry = ops.cumsum(x, exclusive=exclusive, schedule="carry", block_n=512)
    _assert_bitwise(tree, carry)


def test_tree_non_pow2_tile_vs_reference():
    """A 96-long tile exercises the identity pad to 128 inside the
    Blelloch network, and the whole-tile Hillis–Steele path of the
    carry network (96 is not a multiple of 128)."""
    xj, xt = _inputs((2, 480), "float32", seed=25)
    jlay = jax_engine.Rows(2, 480, 1, 96)
    tlay = scan_engine.Rows(2, 480, 1, 96)
    for s in SCHEDULES4:
        (want,) = jax_engine.scan((xj,), jax_monoids.SUM, jlay, schedule=s,
                                  interpret=True)
        (got,) = scan_engine.scan((xt,), monoids.SUM, tlay, schedule=s)
        _assert_bitwise(got, want)


def test_in_tile_networks_vs_reference():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 1024)).astype(np.float32)
    (want,) = jax_engine.tile_scan(jax_monoids.SUM, (jnp.asarray(x),), 1)
    (got,) = schedules.tile_scan(monoids.SUM, (torch.from_numpy(x),))
    _assert_bitwise(got, want)
    (jex,), (jtot,) = jax_engine.tree_scan(jax_monoids.SUM,
                                           (jnp.asarray(x[:, :1000]),), 1)
    (tex,), (ttot,) = schedules.tree_scan(monoids.SUM,
                                          (torch.from_numpy(x[:, :1000]),))
    _assert_bitwise(tex, jex)
    _assert_bitwise(ttot, jtot)
    t = rng.standard_normal((2, 9)).astype(np.float32)
    (want,) = jax_engine.exclusive_chain(jax_monoids.SUM, (jnp.asarray(t),))
    (got,) = schedules.exclusive_chain(monoids.SUM, (torch.from_numpy(t),))
    _assert_bitwise(got, want)


def test_back_compat_2d_entry_points():
    xj, xt = _inputs((8, 4096), "float32", seed=6)
    _assert_bitwise(ops.scan_blocked_kernel(xt, block_n=512),
                    jax_ops.scan_blocked_kernel(xj, block_n=512,
                                                interpret=True))
    _assert_bitwise(ops.scan_blocked_decoupled(xt, exclusive=True),
                    jax_ops.scan_blocked_decoupled(xj, exclusive=True,
                                                   interpret=True))


@pytest.mark.parametrize("shape", [(2, 0), (0, 5), (0,)])
def test_empty_returns_input(shape):
    x = torch.zeros(shape)
    for s in SCHEDULES4:
        assert ops.cumsum(x, schedule=s).shape == shape
        assert ops.cumsum(x, exclusive=True, schedule=s).shape == shape


def test_engine_rejects_bad_schedule_and_geometry():
    x = torch.ones((2, 256))
    lay = scan_engine.Rows(2, 256, 2, 128)
    with pytest.raises(ValueError):
        scan_engine.scan((x,), monoids.SUM, lay, schedule="bogus")
    with pytest.raises(ValueError):
        scan_engine.Rows(2, 300, 2, 128)  # not divisible by the block
    with pytest.raises(ValueError):
        ops.cumsum(x, schedule="bogus")


def test_auto_schedule_follows_policy():
    """'auto' resolves through the policy with the CPU's default cores:
    one long row spreads (fused), many rows keep the carry chain."""
    x = torch.zeros((1, 8 * 2048))
    assert scan_engine.resolve_schedule("auto", 1, x.shape[1], 2048) == \
        "fused"
    assert scan_engine.resolve_schedule("auto", 8, 4096, 2048) == "carry"
    assert scan_engine.resolve_schedule("tree", 1, 10, 128) == "tree"


@pytest.mark.parametrize("exclusive", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cumsum_ref_oracle_vs_reference(dtype, exclusive):
    """The kernel family's plain oracle (``torch.cumsum`` in the widened
    dtype) agrees with the reference's (``jnp.cumsum``) to the reference
    tests' tolerance — the two libraries' cumsums associate differently
    — and with the engine's output."""
    from repro.kernels.scan_blocked import ref as jax_ref
    from repro_torch.kernels.scan_blocked import ref

    xj, xt = _inputs((3, 517), dtype, seed=8)
    got = ref.cumsum_ref(xt, exclusive=exclusive)
    want = jax_ref.cumsum_ref(xj, exclusive=exclusive)
    assert got.dtype == xt.dtype
    tol = {"float32": 1e-4, "bfloat16": 0.15, "int32": 0}[dtype]
    np.testing.assert_allclose(got.double().numpy(),
                               np.asarray(want.astype(jnp.float32),
                                          np.float64),
                               rtol=tol, atol=tol)
    eng = ops.cumsum(xt, exclusive=exclusive)
    np.testing.assert_allclose(eng.double().numpy(), got.double().numpy(),
                               rtol=tol, atol=tol)
