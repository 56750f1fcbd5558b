"""The port's segmented-sum scan held against the JAX reference.

The same numpy inputs go through the reference (``repro``: Pallas in
interpret mode, as its own tests run it on the CPU) and the port
(``repro_torch``: the plain PyTorch version of each kernel on a CPU
tensor). The port keeps the reference's association order, so the
SEGMENTED_SUM engine under all four schedules, its running totals, its
gradients and ``dispatch_offsets`` must agree BITWISE, floats included.
Re-runs the segmented cases of ``tests/test_scan_engine.py`` and
``tests/test_scan_backward.py`` and the dispatch cases of
``tests/test_segmented_moe.py``. The CUDA kernels are held against these
plain versions in ``tests/test_torch_cuda_kernels.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core.scan import assoc as jax_assoc
from repro.core.scan import reference as jax_reference
from repro.core.scan import segmented as jax_segmented
from repro.kernels import scan_engine as jax_engine
from repro.kernels.scan_engine import monoids as jax_monoids
from repro.kernels.segscan import ops as jax_seg
from repro.kernels.segscan import ref as jax_seg_ref
from repro_torch.core import scan as tscan
from repro_torch.core.scan import assoc, reference, segmented
from repro_torch.kernels import scan_engine
from repro_torch.kernels.scan_engine import monoids, schedules
from repro_torch.kernels.segscan import ops, ref

SCHEDULES = ("carry", "decoupled", "fused")
SCHEDULES4 = SCHEDULES + ("tree",)
DTYPES = ("float32", "bfloat16", "int32")


def _values(rng, shape, dtype):
    """(jax array, torch tensor) of the same values in ``dtype``."""
    if dtype == "int32":
        x = rng.integers(-9, 9, shape).astype(np.int32)
    else:
        x = rng.standard_normal(shape).astype(np.float32)
    xj = jnp.asarray(x, getattr(jnp, dtype))
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32)) if dtype ==
                          "bfloat16" else np.array(xj)).to(getattr(torch,
                                                                   dtype))
    return xj, xt


def _flags(rng, shape, p=0.02):
    f = (rng.random(shape) < p).astype(np.int32)
    return jnp.asarray(f), torch.from_numpy(f)


def _bits(a):
    if isinstance(a, torch.Tensor):
        a = (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    else:
        a = np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16
                       else a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _assert_bitwise(got, want):
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_array_equal(_bits(got), _bits(want))


# ---------------------------------------------------------------------------
# the engine: four schedules x dtypes, bitwise vs the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("schedule", SCHEDULES4)
@pytest.mark.parametrize("dtype", DTYPES)
def test_segmented_cumsum_bitwise_vs_reference(dtype, schedule):
    rng = np.random.default_rng(1)
    vj, vt = _values(rng, (2, 4096), dtype)
    fj, ft = _flags(rng, (2, 4096))
    want = jax_seg.segmented_cumsum(vj, fj, interpret=True,
                                    schedule=schedule, block_n=512)
    got = ops.segmented_cumsum(vt, ft, schedule=schedule, block_n=512)
    assert got.dtype == vt.dtype
    _assert_bitwise(got, want)


@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_parity_segmented(dtype):
    """carry == decoupled == fused bitwise, and close to the oracle."""
    rng = np.random.default_rng(1)
    vj, vt = _values(rng, (2, 4096), dtype)
    fj, ft = _flags(rng, (2, 4096))
    outs = [ops.segmented_cumsum(vt, ft, schedule=s, block_n=512)
            for s in SCHEDULES]
    for o in outs[1:]:
        _assert_bitwise(o, outs[0])
    want = jax_reference.segmented_scan_ref(vj.astype(jnp.float32), fj)
    np.testing.assert_allclose(outs[0].double().numpy(),
                               np.asarray(want, np.float64),
                               rtol=1e-4, atol=1e-4)


def test_parity4_segmented_exact():
    rng = np.random.default_rng(21)
    v = torch.from_numpy(rng.integers(-9, 9, (2, 4096)).astype(np.float32))
    _, f = _flags(rng, (2, 4096))
    outs = [ops.segmented_cumsum(v, f, schedule=s, block_n=512)
            for s in SCHEDULES4]
    for o in outs[1:]:
        _assert_bitwise(o, outs[0])


def test_segmented_messy_flags_match_reference():
    """Fractional, negative and leading nonzero flags are boundaries too:
    the wrapper normalizes with ``!= 0``, not a truncating cast or a max."""
    v = np.ones((8,), np.float32)
    for flags in (np.asarray([0, 0, 0.5, 0, 0.5, 0, 0, 0], np.float32),
                  np.asarray([0, 0, -1, 0, -3, 0, 0, 0], np.int32),
                  np.asarray([-2, 0, 0, 0.25, 0, 0, 0, 7], np.float32)):
        want = jax_seg.segmented_cumsum(jnp.asarray(v), jnp.asarray(flags),
                                        interpret=True)
        for s in SCHEDULES4:
            got = ops.segmented_cumsum(torch.from_numpy(v),
                                       torch.from_numpy(flags), schedule=s)
            _assert_bitwise(got, want)
        ref_t = reference.segmented_scan_ref(torch.from_numpy(v),
                                             torch.from_numpy(flags))
        _assert_bitwise(ref_t, jax_reference.segmented_scan_ref(
            jnp.asarray(v), jnp.asarray(flags)))
    got = ops.segmented_cumsum(torch.ones(8), torch.tensor(
        [0, 0, -1, 0, -3, 0, 0, 0], dtype=torch.int32))
    assert got.tolist() == [1, 2, 1, 2, 1, 2, 3, 4]


@pytest.mark.parametrize("schedule", SCHEDULES4)
def test_segsum_running_totals_bitwise_vs_reference(schedule):
    """``return_totals``: both leaves of the (value, flag) chain."""
    rng = np.random.default_rng(5)
    vj, vt = _values(rng, (3, 2048), "float32")
    fj, ft = _flags(rng, (3, 2048), p=0.005)
    (want,), wtot = jax_engine.scan(
        (vj, fj), jax_monoids.SEGMENTED_SUM, jax_engine.Rows(3, 2048, 1, 256),
        schedule=schedule, interpret=True, return_totals=True)
    (got,), gtot = scan_engine.scan(
        (vt, ft), monoids.SEGMENTED_SUM, scan_engine.Rows(3, 2048, 1, 256),
        schedule=schedule, return_totals=True)
    _assert_bitwise(got, want)
    assert len(gtot) == len(wtot) == 2
    for g, w in zip(gtot, wtot):
        assert g.dtype == getattr(torch, str(w.dtype))
        _assert_bitwise(g, w)


def test_segsum_in_tile_networks_vs_reference():
    rng = np.random.default_rng(6)
    v = rng.standard_normal((3, 1024)).astype(np.float32)
    f = (rng.random((3, 1024)) < 0.05).astype(np.int32)
    jl = (jnp.asarray(v), jnp.asarray(f))
    tl = (torch.from_numpy(v), torch.from_numpy(f))
    for w, g in zip(jax_engine.tile_scan(jax_monoids.SEGMENTED_SUM, jl, 1),
                    schedules.tile_scan(monoids.SEGMENTED_SUM, tl)):
        _assert_bitwise(g, w)
    (jex, jtot) = jax_engine.tree_scan(jax_monoids.SEGMENTED_SUM,
                                       tuple(x[:, :1000] for x in jl), 1)
    (tex, ttot) = schedules.tree_scan(monoids.SEGMENTED_SUM,
                                      tuple(x[:, :1000] for x in tl))
    for g, w in zip(tex + ttot, jex + jtot):
        _assert_bitwise(g, w)
    for w, g in zip(
            jax_engine.exclusive_chain(jax_monoids.SEGMENTED_SUM,
                                       tuple(x[:, :9] for x in jl)),
            schedules.exclusive_chain(monoids.SEGMENTED_SUM,
                                      tuple(x[:, :9] for x in tl))):
        _assert_bitwise(g, w)


def test_back_compat_2d_entry_points():
    rng = np.random.default_rng(7)
    vj, vt = _values(rng, (8, 4096), "float32")
    fj, ft = _flags(rng, (8, 4096))
    _assert_bitwise(ops.segscan_kernel(vt, ft, block_n=512),
                    jax_seg.segscan_kernel(vj, fj, block_n=512,
                                           interpret=True))
    _assert_bitwise(ops.segscan_decoupled(vt, ft),
                    jax_seg.segscan_decoupled(vj, fj, interpret=True))


@pytest.mark.parametrize("shape", [(2, 0), (0, 5), (0,)])
def test_empty_returns_input(shape):
    v = torch.zeros(shape)
    for s in SCHEDULES4:
        assert ops.segmented_cumsum(v, torch.zeros(shape),
                                    schedule=s).shape == shape


def test_segmented_cumsum_ref_oracle_vs_reference():
    rng = np.random.default_rng(8)
    for dtype in DTYPES:
        vj, vt = _values(rng, (3, 517), dtype)
        fj, ft = _flags(rng, (3, 517), p=0.05)
        _assert_bitwise(ref.segmented_cumsum_ref(vt, ft),
                        jax_seg_ref.segmented_cumsum_ref(vj, fj))


def test_rank3_and_axis_route_vs_reference():
    """Any rank through the wrapper; any axis through
    ``core.scan.segmented_scan(algorithm="kernel")``."""
    rng = np.random.default_rng(9)
    vj, vt = _values(rng, (2, 3, 640), "float32")
    fj, ft = _flags(rng, (2, 3, 640), p=0.05)
    _assert_bitwise(ops.segmented_cumsum(vt, ft),
                    jax_seg.segmented_cumsum(vj, fj, interpret=True))
    for axis in (0, 1, -1):
        got = segmented.segmented_scan(vt, ft, axis=axis, algorithm="kernel")
        want = jax_segmented.segmented_scan(vj, fj, axis=axis,
                                            algorithm="kernel")
        _assert_bitwise(got, want)


@pytest.mark.parametrize("op", ["sum", "max", "min", "prod"])
def test_segmented_scan_library_route_vs_reference(op):
    rng = np.random.default_rng(10)
    x = rng.integers(-3, 4, (4, 40)).astype(np.int32)
    f = (rng.random((4, 40)) < 0.2).astype(np.int32)
    want = jax_segmented.segmented_scan(jnp.asarray(x), jnp.asarray(f), op=op,
                                        axis=1)
    got = segmented.segmented_scan(torch.from_numpy(x), torch.from_numpy(f),
                                   op=op, axis=1)
    _assert_bitwise(got, want)
    with pytest.raises(ValueError):
        segmented.segmented_scan(torch.from_numpy(x), torch.from_numpy(f),
                                 op="max", algorithm="kernel")


def test_library_monoids_carry_kernel_specs():
    assert assoc.SUM.kernel_spec is assoc.SUM_KERNEL
    assert assoc.segmented(assoc.SUM).kernel_spec \
        is assoc.SEGMENTED_SUM_KERNEL
    assert assoc.segmented(assoc.MAX).kernel_spec is None
    assert assoc.get(assoc.segmented(assoc.SUM)).name == "segmented_sum"
    assert monoids.SEGMENTED_SUM.fills == jax_monoids.SEGMENTED_SUM.fills
    assert monoids.SEGMENTED_SUM.name == jax_monoids.SEGMENTED_SUM.name
    with pytest.raises(ValueError):
        scan_engine.scan((torch.ones(1, 128), torch.zeros(1, 128)),
                         monoids.mask(128), scan_engine.Rows(1, 128, 1, 128),
                         exclusive=True)


# ---------------------------------------------------------------------------
# gradients: the flipped segmented scan with flags shifted left
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 256), (3, 1024), (2, 4096)])
def test_segmented_grad_matches_reference(shape, dtype):
    rng = np.random.default_rng(31)
    v = rng.standard_normal(shape).astype(np.float32)
    f = (rng.random(shape) < 0.05).astype(np.int32)
    w = rng.standard_normal(shape).astype(np.float32)
    vj = jnp.asarray(v, getattr(jnp, dtype))

    def loss_jax(v):
        out = jax_seg.segmented_cumsum(v, jnp.asarray(f), interpret=True)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(w))

    want = jax.grad(loss_jax)(vj)
    vt = torch.from_numpy(np.array(vj.astype(jnp.float32))).to(
        getattr(torch, dtype)).requires_grad_()
    out = ops.segmented_cumsum(vt, torch.from_numpy(f))
    (g,) = torch.autograd.grad(torch.sum(out.float() * torch.from_numpy(w)),
                               vt)
    assert g.dtype == vt.dtype
    _assert_bitwise(g, want)


def test_segmented_grad_flag_boundaries():
    """Gradients must not leak across segment boundaries; the flags get
    no gradient."""
    f = torch.tensor([0, 0, 0, 1, 0, 0, 1, 0], dtype=torch.float32)
    for i, want in ((5, [0, 0, 0, 1, 1, 1, 0, 0]),
                    (2, [1, 1, 1, 0, 0, 0, 0, 0])):
        v = torch.zeros(8, requires_grad=True)
        ff = f.clone().requires_grad_()
        (gv, gf) = torch.autograd.grad(ops.segmented_cumsum(v, ff)[i],
                                       (v, ff), allow_unused=True)
        assert gv.tolist() == want
        assert gf is None


# ---------------------------------------------------------------------------
# dispatch offsets (the paper's §1 partitioning step)
# ---------------------------------------------------------------------------


@given(st.lists(st.integers(0, 7), min_size=1, max_size=200))
@settings(max_examples=15, deadline=None)
def test_dispatch_plan_bitwise_vs_reference(ids):
    E = 8
    ids = np.asarray(ids, np.int32)
    want = jax_segmented.dispatch_offsets(jnp.asarray(ids), E)
    got = segmented.dispatch_offsets(torch.from_numpy(ids), E)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        _assert_bitwise(g, w)
    # the invariants of the reference's own test
    dest = got.dest.numpy()
    assert sorted(dest.tolist()) == list(range(len(ids)))
    np.testing.assert_array_equal(got.counts.numpy(),
                                  np.bincount(ids, minlength=E))
    for e in range(E):
        tok = dest[ids == e]
        assert sorted(tok.tolist()) == tok.tolist()


def test_packed_segment_ids():
    lengths = np.asarray([3, 2, 4], np.int32)
    got = segmented.packed_segment_ids(torch.from_numpy(lengths), total=9)
    want = jax_segmented.packed_segment_ids(jnp.asarray(lengths), total=9)
    _assert_bitwise(got, want)
    assert got.tolist() == [0, 0, 0, 1, 1, 2, 2, 2, 2]


def test_dispatch_offsets_int32_guard():
    """Offsets stay int32; totals at/after 2^31 raise (the reference
    with x64 off, which the port mirrors)."""
    assert not jax.config.jax_enable_x64
    assert segmented._offsets_dtype(10) == torch.int32
    assert segmented._offsets_dtype(2 ** 31 - 1) == torch.int32
    with pytest.raises(OverflowError):
        segmented._offsets_dtype(2 ** 31)
    with pytest.raises(OverflowError):
        jax_segmented._offsets_dtype(2 ** 31)
    plan = segmented.dispatch_offsets(torch.tensor([1, 0, 1]), 2)
    assert plan.offsets.dtype == plan.dest.dtype == torch.int32
    for bad in ([0, 2], [-1, 0]):
        with pytest.raises(ValueError, match="bucket ids"):
            segmented.dispatch_offsets(torch.tensor(bad), 2)


def test_exports_match_reference():
    for name in ("DispatchPlan", "dispatch_offsets", "packed_segment_ids",
                 "segmented_scan", "segmented_scan_ref"):
        assert name in tscan.__all__
    assert jax_assoc.segmented(jax_assoc.SUM).name == \
        assoc.segmented(assoc.SUM).name
