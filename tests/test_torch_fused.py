"""The single-launch ``fused`` schedule's plain version, on both layouts.

``fused_plain`` walks the chunks in the order of the reference's
``_fused_body``: scan the tile, take the predecessor's published
inclusive prefix, publish ``combine(prefix, total)``, emit
``combine(prefix, sel)``. That is decoupled's chain in the same
association, so it must be bitwise equal to ``decoupled_plain`` for every
element spec (sum, segmented sum, mask, affine), on ``Rows`` and on
``Channels``, and to the reference's ``scan_fused`` (which runs the
two-launch decoupled form in interpret mode). The affine combine is
compared on exact data against the reference: XLA's CPU compiler
contracts ``a2 * b1 + b2`` into a fused multiply-add, the port does not
(see ``tests/test_torch_ssm_scan.py``).

The CUDA ``fused`` kernel is held against ``fused_plain`` and the
decoupled kernels in ``tests/test_torch_cuda_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import scan_engine as jax_engine
from repro.kernels.scan_engine import monoids as jax_monoids
from repro.kernels.scan_engine import schedules as jax_schedules
from repro_torch.core.scan import assoc
from repro_torch.kernels import scan_engine
from repro_torch.kernels.scan_engine import monoids, schedules
from repro_torch.obs import trace

ROWS = ("rows", lambda: (scan_engine.Rows(3, 4096, 1, 512),
                         jax_engine.Rows(3, 4096, 1, 512)))
CHANNELS = ("channels", lambda: (scan_engine.Channels(2, 512, 48, 64, 16),
                                 jax_engine.Channels(2, 512, 48, 64, 16)))
LAYOUTS = (ROWS, CHANNELS)


def _operands(spec_name, shape, dtype, seed, exact=False):
    """numpy operands of one spec: values (and flags or b), or a mask."""
    rng = np.random.default_rng(seed)

    def values():
        if dtype == "int32" or exact:
            v = rng.integers(-9, 9, shape)
            return v.astype(np.int32 if dtype == "int32" else np.float32)
        return rng.standard_normal(shape).astype(np.float32)

    if spec_name == "sum":
        return (values(),)
    if spec_name == "segsum":
        flags = np.where(rng.random(shape) < 0.03,
                         rng.choice([-3, 1, 2], shape), 0).astype(np.int32)
        return (values(), flags)
    if spec_name == "mask":
        return ((rng.random(shape) < 0.4).astype(np.int32),)
    if exact:
        a = rng.choice([-1.0, 1.0], shape).astype(np.float32)
        b = rng.integers(-3, 4, shape).astype(np.float32)
    else:
        a = rng.uniform(0.7, 1.0, shape).astype(np.float32)
        b = rng.standard_normal(shape).astype(np.float32)
    return (a, b)


def _specs(spec_name, n):
    if spec_name == "sum":
        return monoids.SUM, jax_monoids.SUM
    if spec_name == "segsum":
        return monoids.SEGMENTED_SUM, jax_monoids.SEGMENTED_SUM
    if spec_name == "mask":
        return monoids.mask(n), jax_monoids.mask(n)
    return monoids.AFFINE, jax_monoids.AFFINE


def _torch(ops, dtype):
    """numpy operands as torch tensors; float values in ``dtype``."""
    out = []
    for o in ops:
        t = torch.from_numpy(o)
        if o.dtype == np.float32 and dtype == "bfloat16":
            t = t.to(torch.bfloat16)
        out.append(t)
    return tuple(out)


def _jax(ops, dtype):
    return tuple(jnp.asarray(o, jnp.bfloat16) if o.dtype == np.float32
                 and dtype == "bfloat16" else jnp.asarray(o) for o in ops)


def _bits(x):
    if isinstance(x, torch.Tensor):
        a = (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    else:
        a = np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16
                       else x)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _same(xs, ys):
    assert len(xs) == len(ys)
    for x, y in zip(xs, ys):
        assert tuple(x.shape) == tuple(y.shape)
        np.testing.assert_array_equal(_bits(x), _bits(y))


CASES = [("sum", "float32"), ("sum", "bfloat16"), ("sum", "int32"),
         ("segsum", "float32"), ("segsum", "int32"), ("mask", "int32"),
         ("affine", "float32"), ("affine", "bfloat16")]


# (spec, dtype, exclusive): the mask spec has no exclusive mode
MODES = [c + (e,) for c in CASES for e in (False, True)
         if not (e and c[0] == "mask")]


@pytest.mark.parametrize("layout", LAYOUTS, ids=[l[0] for l in LAYOUTS])
@pytest.mark.parametrize("mode", MODES, ids=[
    f"{s}-{d}-{'excl' if e else 'incl'}" for s, d, e in MODES])
def test_fused_plain_bitwise_equals_decoupled_plain(mode, layout):
    spec_name, dtype, exclusive = mode
    lay, _ = layout[1]()
    spec, _ = _specs(spec_name, lay.shape[-1])
    ops = _torch(_operands(spec_name, lay.shape, dtype, 40), dtype)
    fused = schedules.fused_plain(ops, spec, lay, exclusive)
    _same(fused, schedules.decoupled_plain(ops, spec, lay, exclusive))
    _same(fused, schedules.carry_plain(ops, spec, lay, exclusive))
    _same(fused, scan_engine.scan(ops, spec, lay, schedule="fused",
                                  exclusive=exclusive))


@pytest.mark.parametrize("layout", LAYOUTS, ids=[l[0] for l in LAYOUTS])
@pytest.mark.parametrize("case", CASES, ids=["-".join(c) for c in CASES])
def test_fused_plain_bitwise_vs_reference_scan_fused(case, layout):
    """The reference's ``scan_fused`` (interpret mode: the two-launch
    decoupled form) on the same inputs; the affine spec on exact data."""
    spec_name, dtype = case
    lay, jlay = layout[1]()
    spec, jspec = _specs(spec_name, lay.shape[-1])
    np_ops = _operands(spec_name, lay.shape, dtype, 41,
                       exact=spec_name == "affine")
    got = schedules.fused_plain(_torch(np_ops, dtype), spec, lay)
    want = jax_schedules.scan_fused(_jax(np_ops, dtype), jspec, jlay,
                                    interpret=True)
    _same(got, want)


@pytest.mark.parametrize("layout", LAYOUTS, ids=[l[0] for l in LAYOUTS])
@pytest.mark.parametrize("spec_name", ["sum", "segsum", "mask", "affine"])
def test_fused_return_totals_runs_decoupled(spec_name, layout):
    """``return_totals`` under fused takes decoupled's route: outputs and
    running totals bitwise equal to decoupled's and to the reference's."""
    lay, jlay = layout[1]()
    spec, jspec = _specs(spec_name, lay.shape[-1])
    np_ops = _operands(spec_name, lay.shape, "float32", 42, exact=True)
    ops = _torch(np_ops, "float32")
    outs, tot = scan_engine.scan(ops, spec, lay, schedule="fused",
                                 return_totals=True)
    d_outs, d_tot = schedules.decoupled_plain(ops, spec, lay,
                                              return_totals=True)
    _same(outs, d_outs)
    _same(tot, d_tot)
    assert all(tuple(t.shape) == lay.chain_shape for t in tot)
    j_outs, j_tot = jax_engine.scan(_jax(np_ops, "float32"), jspec, jlay,
                                    schedule="fused", interpret=True,
                                    return_totals=True)
    _same(outs, j_outs)
    _same(tot, j_tot)


@pytest.mark.parametrize("bn", [96, 128, 640])
def test_fused_plain_ragged_tiles(bn):
    """Tiles that are not a multiple of 128 (whole-tile Hillis–Steele)
    and that are (the two-level split), and a single chunk."""
    rng = np.random.default_rng(43)
    n = bn * 5
    x = torch.from_numpy(rng.standard_normal((2, n)).astype(np.float32))
    lay = scan_engine.Rows(2, n, 1, bn)
    fused = schedules.fused_plain((x,), monoids.SUM, lay)
    _same(fused, schedules.decoupled_plain((x,), monoids.SUM, lay))
    one = scan_engine.Rows(2, n, 1, n)
    _same(schedules.fused_plain((x,), monoids.SUM, one),
          schedules.carry_plain((x,), monoids.SUM, one))


def test_channels_layout_matches_reference():
    for args in ((2, 512, 48, 64, 16), (1, 1024, 458752, 256, 512)):
        lay, jlay = scan_engine.Channels(*args), jax_engine.Channels(*args)
        assert lay.shape == jlay.shape
        assert lay.grid == jlay.grid
        assert lay.num_seq_blocks == jlay.num_seq_blocks
        assert lay.chain_shape == jlay.chain_shape
    assert scan_engine.Channels(2, 512, 48, 64, 16).tile_shape == \
        (2, 8, 64, 48)
    with pytest.raises(ValueError):
        scan_engine.Channels(1, 100, 48, 64, 16)
    with pytest.raises(ValueError):
        scan_engine.Channels(1, 128, 40, 64, 16)


def test_affine_kernel_spec_matches_reference():
    jspec = jax_monoids.AFFINE
    spec = monoids.AFFINE
    assert spec is assoc.AFFINE_KERNEL and assoc.AFFINE.kernel_spec is spec
    assert (spec.name, spec.fills, spec.out_leaves) == \
        (jspec.name, jspec.fills, jspec.out_leaves)
    assert spec.elem_dtypes((torch.bfloat16, torch.float16)) == \
        (torch.float32, torch.float32)
    assert spec.out_dtypes((torch.float32, torch.bfloat16)) == \
        (torch.bfloat16,)
    a, b = torch.tensor([2.0, 3.0]), torch.tensor([5.0, 7.0])
    c, d = torch.tensor([4.0, 0.5]), torch.tensor([1.0, -1.0])
    got = spec.combine((a, b), (c, d))       # earlier element on the left
    assert torch.equal(got[0], a * c) and torch.equal(got[1], c * b + d)


def test_time_axis_networks_vs_reference():
    """The in-tile networks along a non-lane axis (Channels' time axis):
    plain Hillis–Steele even on lane-divisible lengths, and the Blelloch
    sweep, bitwise equal to the reference's on exact data."""
    rng = np.random.default_rng(44)
    a = rng.choice([-1.0, 1.0], (256, 24)).astype(np.float32)
    b = rng.integers(-3, 4, (256, 24)).astype(np.float32)
    spec, jspec = monoids.AFFINE, jax_monoids.AFFINE
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    _same(schedules.tile_scan(spec, (ta, tb), 0),
          jax_engine.tile_scan(jspec, (ja, jb), 0))
    (tex, ttot) = schedules.tree_scan(spec, (ta[:200], tb[:200]), 0)
    (jex, jtot) = jax_engine.tree_scan(jspec, (ja[:200], jb[:200]), 0)
    _same(tex, jex)
    _same(ttot, jtot)
    x = rng.standard_normal((3, 256)).astype(np.float32)
    # axis 0 of (256, 3) is not the lane axis: no two-level split
    _same(schedules.tile_scan(monoids.SUM, (torch.from_numpy(x.T.copy()),),
                              0),
          jax_engine.tile_scan(jax_monoids.SUM, (jnp.asarray(x.T.copy()),),
                               0))
    _same(schedules.shift_one(spec, (ta, tb), 0),
          jax_schedules.shift_one(jspec, (ja, jb), 0))


@pytest.mark.parametrize("schedule,return_totals,reads",
                         [("carry", False, 1), ("decoupled", False, 2),
                          ("fused", False, 1), ("fused", True, 2),
                          ("tree", False, 1)])
@pytest.mark.parametrize("layout", LAYOUTS, ids=[l[0] for l in LAYOUTS])
def test_launch_event_traffic(layout, schedule, return_totals, reads):
    """``kernel.launch`` on both layouts: the grid, one tile's bytes, and
    the traffic model — native fused reads the data once, decoupled (and
    fused with running totals, which runs decoupled) twice."""
    lay, jlay = layout[1]()
    ops = _torch(_operands("sum", lay.shape, "float32", 45), "float32")
    tracer = trace.enable()
    try:
        tracer.clear()
        scan_engine.scan(ops, monoids.SUM, lay, schedule=schedule,
                         return_totals=return_totals)
        (ev,) = [e["args"] for e in tracer.events()
                 if e["name"] == "kernel.launch"]
    finally:
        trace.disable()
    nbytes = ops[0].numel() * 4
    assert ev["monoid"] == "sum" and ev["schedule"] == schedule
    assert ev["grid"] == list(jlay.grid)
    assert ev["hbm_read_bytes_est"] == reads * nbytes
    assert ev["hbm_write_bytes_est"] == nbytes
    tile = 1
    for s in jlay.data_spec().block_shape:
        tile *= s
    assert ev["vmem_block_bytes_est"] == 4 * tile
