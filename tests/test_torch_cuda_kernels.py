"""The CUDA kernels of ``csrc/scan_sum.cu``, ``csrc/attn_fold.cu`` and
``csrc/attn_fold_tc.cu`` against their plain versions.

This file imports no JAX, so it runs on the machine with the card too:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda_kernels.py

Without a CUDA device the card tests skip (``cuda_device`` fixture) and
only the wrapper checks that need no card run. On the card every kernel
— sum, segmented sum, mask and affine, under the four schedules, on the
``Rows`` and ``Channels`` layouts — must be bitwise equal to its plain
PyTorch version (run here on CPU copies of the same inputs), the fused
kernel must be one launch and bitwise equal to the decoupled kernels on
grids far larger than the card holds at once, a gradient must launch the
kernels, and the relational operators' kernel routes must equal their
CPU results. The attention fold kernels (fold_fwd, fold_dq, fold_dkv,
and the chain of each spec) must agree with their plain versions within
the reference tests' float32 tolerances (1e-5 forward and 1e-4
gradients, tests/test_flash_engine.py:99 and
tests/test_flash_backward.py:102: the dot products associate
differently); in bfloat16 both sides take the same bf16 inputs and
compute in float32, so they differ by the last rounding to bf16: atol
1e-3, rtol two bf16 ulps (2^-6). They must be bitwise equal to
themselves: bounds on and off, a page-permuted pool through
``kv_block_map``, repeated runs. The tensor-core forms (fold_fwd_tc,
fold_dq_tc, fold_dkv_tc: bf16 operands, p and ds as bf16 hi + lo before
their products, float32 accumulators) meet the same bf16 bar over head
dims 64, 128 and 256, KV blocks of 64 and 128 rows, masks, GQA groups,
both schedules and packed decode tiles, and the same bitwise invariants;
the float32 forward, dq and dk/dv forms (fold_fwd_tf32, fold_dq_tf32,
fold_dkv_tf32: three TF32 products a product) meet the float32 forward
and gradient bars at head dims 64, 128 and 256 against the plain folds
and the SIMT kernels launched by name, with the same bitwise
invariants. The chain over chunk totals (a
folding thread for float specs, a parallel scan for integer ones) must
give ``exclusive_chain``'s bits. The sum's and the mask's Rows totals
(``totals_reduce_kernel``, the network's last element built as its tree)
must give ``totals_plain``'s and ``totals_tree_plain``'s bits on
adversarial data, at any block size and base alignment, and so must
carry, apply, fused and tree on ``Rows`` (``carry_reg_kernel``,
``apply_reg_kernel``, ``fused_reg_kernel`` and ``tree_reg_kernel`` on
tiles of 128·r elements, the shared-memory kernels on others): outputs
and running totals bitwise equal to ``carry_plain``, ``apply_plain``,
``fused_plain`` and ``tree_plain``, decoupled == carry == fused, with the
profiler's kernel names showing which network each shape launches; the
affine carry, fused, totals and apply on ``Channels`` tiles of 128, 256
and 512 steps (``carry_chan_reg_kernel``, ``fused_chan_reg_kernel``,
``totals_chan_reduce_kernel``, ``apply_chan_reg_kernel``) likewise, and
equal to the shared-memory kernels launched by name.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import _torch_totals_data as totals_data
from repro_torch import relational as rel
from repro_torch.kernels import scan_engine
from repro_torch.core.scan import assoc
from repro_torch.kernels.compact import ops as kc_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention_bwd_kernel, flash_attention_kernel)
from repro_torch.kernels.scan_blocked import ops
from repro_torch.kernels.scan_engine import cuda, cuda_fold, monoids
from repro_torch.kernels.segscan import ops as seg_ops

SCHEDULES4 = ("carry", "decoupled", "fused", "tree")
DTYPES = (torch.float32, torch.bfloat16, torch.int32)


def _same_bits(a, b):
    view = {4: torch.int32, 2: torch.int16}[a.element_size()]
    return a.dtype == b.dtype and a.shape == b.shape and \
        torch.equal(a.view(view), b.view(view))


def test_cuda_wrappers_refuse_cpu_tensors():
    """A wrapper never falls back: a CPU tensor is refused before any
    build or launch."""
    x = torch.ones((2, 256))
    f = torch.zeros((2, 256), dtype=torch.int32)
    lay = scan_engine.Rows(2, 256, 1, 128)
    before = dict(cuda.LAUNCHES)
    for spec, opnds in ((monoids.SUM, (x,)),
                        (monoids.SEGMENTED_SUM, (x, f)),
                        (monoids.mask(256), (f,))):
        offs = tuple(torch.zeros((2, 2), dtype=o.dtype) for o in opnds)
        for call in (lambda: cuda.carry(spec, opnds, lay),
                     lambda: cuda.totals(spec, opnds, lay),
                     lambda: cuda.chain(spec, offs),
                     lambda: cuda.apply(spec, opnds, offs, lay),
                     lambda: cuda.tree(spec, opnds, lay)):
            with pytest.raises(ValueError, match="CUDA tensors"):
                call()
    assert cuda.LAUNCHES == before


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    # an empty build directory, so no library built earlier is reused
    monkeypatch.setattr(cuda, "_lib", None)
    monkeypatch.setattr(cuda, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda.build()


def test_build_dir_is_ignored_by_git():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, ".gitignore")) as f:
        assert "build/" in f.read().split()
    assert str(cuda.BUILD_DIR) == os.path.join(root, "build")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "False here) and nvcc to build csrc/scan_sum.cu")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("schedule", SCHEDULES4)
def test_cuda_kernels_bitwise_vs_plain(cuda_device, schedule, dtype):
    rng = np.random.default_rng(7)
    shape = (3, 4 * 2048 + 517)
    if dtype == torch.int32:
        xt = torch.from_numpy(rng.integers(-9, 9, shape).astype(np.int32))
    else:
        xt = torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(dtype)
    x = xt.to(cuda_device)
    for exclusive in (False, True):
        for bn in (512, 2048, 8192, 16384):
            cuda.reset_launches()
            got = ops.cumsum(x, exclusive=exclusive, schedule=schedule,
                             block_n=bn)
            torch.cuda.synchronize()
            assert sum(cuda.LAUNCHES.values()) > 0
            want = ops.cumsum(xt, exclusive=exclusive, schedule=schedule,
                              block_n=bn)
            assert _same_bits(got.cpu(), want), (exclusive, bn)


def test_cuda_backward_runs_kernels(cuda_device):
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((2, 3000)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((2, 3000)).astype(np.float32))
    xc = x.to(cuda_device).requires_grad_()
    out = ops.cumsum(xc, schedule="decoupled")
    cuda.reset_launches()
    (dx,) = torch.autograd.grad(out, xc, g.to(cuda_device))
    assert cuda.LAUNCHES["totals"] == cuda.LAUNCHES["apply"] == 1
    assert sum(cuda.LAUNCHES.values()) == 3
    want = torch.flip(ops.cumsum(torch.flip(g, (1,)), schedule="decoupled"),
                      (1,))
    assert _same_bits(dx.cpu(), want)


def test_cuda_refuses_unsupported_dtype(cuda_device):
    x = torch.ones((2, 256), dtype=torch.float64, device=cuda_device)
    with pytest.raises(TypeError, match="no CUDA scan kernel"):
        ops.cumsum(x)


def _seg_inputs(rng, shape, dtype):
    if dtype == torch.int32:
        v = torch.from_numpy(rng.integers(-9, 9, shape).astype(np.int32))
    else:
        v = torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(dtype)
    f = torch.from_numpy((rng.random(shape) < 0.02).astype(np.int32))
    return v, f


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("schedule", SCHEDULES4)
def test_cuda_segsum_bitwise_vs_plain(cuda_device, schedule, dtype):
    rng = np.random.default_rng(9)
    v, f = _seg_inputs(rng, (3, 4 * 2048 + 517), dtype)
    for bn in (512, 2048, 8192, 16384):
        cuda.reset_launches()
        got = seg_ops.segmented_cumsum(v.to(cuda_device), f.to(cuda_device),
                                       schedule=schedule, block_n=bn)
        torch.cuda.synchronize()
        assert sum(cuda.LAUNCHES[k] for k in cuda.LAUNCHES
                   if k.startswith("segsum_")) > 0
        want = seg_ops.segmented_cumsum(v, f, schedule=schedule, block_n=bn)
        assert _same_bits(got.cpu(), want), bn


@pytest.mark.parametrize("schedule", SCHEDULES4)
def test_cuda_mask_compact_bitwise_vs_plain(cuda_device, schedule):
    rng = np.random.default_rng(10)
    m = torch.from_numpy(rng.random((3, 4 * 2048 + 517)) < 0.4)
    for bn in (512, 2048, 16384):
        cuda.reset_launches()
        dest, counts = kc_ops.mask_compact(m.to(cuda_device),
                                           schedule=schedule, block_n=bn)
        torch.cuda.synchronize()
        assert sum(cuda.LAUNCHES[k] for k in cuda.LAUNCHES
                   if k.startswith("mask_")) > 0
        want_d, want_c = kc_ops.mask_compact(m, schedule=schedule,
                                             block_n=bn)
        assert torch.equal(dest.cpu(), want_d) and \
            torch.equal(counts.cpu(), want_c), bn


@pytest.mark.parametrize("schedule", SCHEDULES4)
def test_cuda_running_totals_bitwise_vs_plain(cuda_device, schedule):
    """``return_totals`` under every schedule, segmented pair included."""
    rng = np.random.default_rng(11)
    v, f = _seg_inputs(rng, (4, 4096), torch.float32)
    lay = scan_engine.Rows(4, 4096, 1, 512)
    for spec, opnds in ((monoids.SEGMENTED_SUM, (v, f)),
                        (monoids.mask(4096), (f,)),
                        (monoids.SUM, (v,))):
        gpu = tuple(o.to(cuda_device) for o in opnds)
        (out,), tot = scan_engine.scan(gpu, spec, lay, schedule=schedule,
                                       return_totals=True)
        (w_out,), w_tot = scan_engine.scan(opnds, spec, lay,
                                           schedule=schedule,
                                           return_totals=True)
        assert _same_bits(out.cpu(), w_out), spec.name
        for a, b in zip(tot, w_tot):
            assert _same_bits(a.cpu(), b), spec.name


def test_cuda_segsum_messy_flags_and_backward(cuda_device):
    v = torch.ones((8,), device=cuda_device)
    for flags in (torch.tensor([0, 0, 0.5, 0, 0.5, 0, 0, 0]),
                  torch.tensor([0, 0, -1, 0, -3, 0, 0, 0], dtype=torch.int32),
                  torch.tensor([1, 0, -1, 0, 0, 0, 0, 2], dtype=torch.int32)):
        got = seg_ops.segmented_cumsum(v, flags.to(cuda_device))
        want = seg_ops.segmented_cumsum(v.cpu(), flags)
        assert torch.equal(got.cpu(), want)
    rng = np.random.default_rng(12)
    x, f = _seg_inputs(rng, (2, 3000), torch.float32)
    g = torch.from_numpy(rng.standard_normal((2, 3000)).astype(np.float32))
    xc = x.to(cuda_device).requires_grad_()
    out = seg_ops.segmented_cumsum(xc, f.to(cuda_device), schedule="carry")
    cuda.reset_launches()
    (dx,) = torch.autograd.grad(out, xc, g.to(cuda_device))
    assert cuda.LAUNCHES["segsum_carry"] == 1
    xt = x.clone().requires_grad_()
    out_t = seg_ops.segmented_cumsum(xt, f, schedule="carry")
    (want,) = torch.autograd.grad(out_t, xt, g)
    assert _same_bits(dx.cpu(), want)


def test_cuda_relational_kernel_routes_match_cpu(cuda_device):
    rng = np.random.default_rng(13)
    T, G = 5000, 7
    ids = torch.from_numpy(rng.integers(0, G, T).astype(np.int32))
    vals = torch.from_numpy(rng.integers(-50, 50, (T, 3)).astype(np.int32))
    mask = torch.from_numpy(rng.random(T) < 0.3)
    cuda.reset_launches()
    out, count = rel.filter_compact(vals.to(cuda_device),
                                    mask.to(cuda_device))
    assert sum(n for k, n in cuda.LAUNCHES.items()
               if k.startswith("mask_")) > 0
    want, want_c = rel.filter_compact(vals, mask)
    assert int(count) == int(want_c)
    assert torch.equal(out.cpu()[:int(count)], want[:int(want_c)])
    for agg in ("sum", "mean"):
        got = rel.group_by(ids.to(cuda_device), vals.to(cuda_device), G, agg,
                           algorithm="kernel")
        want = rel.group_by(ids, vals, G, agg, algorithm="kernel")
        assert _same_bits(got.cpu(), want), agg
    lk = torch.from_numpy(rng.integers(0, 50, 300).astype(np.int32))
    rk = torch.from_numpy(rng.integers(0, 50, 200).astype(np.int32))
    got = rel.hash_join(lk.to(cuda_device), rk.to(cuda_device))
    want = rel.hash_join(lk, rk)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


# ---------------------------------------------------------------------------
# fused (the single-launch look-back kernel) and the affine spec
# ---------------------------------------------------------------------------


def _spec_operands(rng, spec_name, shape, dtype):
    """CPU operands of one spec in ``dtype`` (the mask: int32 0/1)."""
    if spec_name == "mask":
        return (torch.from_numpy((rng.random(shape) < 0.4).astype(np.int32)),)
    if spec_name == "affine":
        a = rng.uniform(0.7, 1.0, shape).astype(np.float32)
        b = rng.standard_normal(shape).astype(np.float32)
        return tuple(torch.from_numpy(v).to(dtype) for v in (a, b))
    if dtype == torch.int32:
        v = torch.from_numpy(rng.integers(-9, 9, shape).astype(np.int32))
    else:
        v = torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(dtype)
    if spec_name == "segsum":
        f = np.where(rng.random(shape) < 0.02, rng.choice([-3, 1, 2], shape),
                     0).astype(np.int32)
        return (v, torch.from_numpy(f))
    return (v,)


def _spec(spec_name, n):
    return {"sum": monoids.SUM, "segsum": monoids.SEGMENTED_SUM,
            "affine": monoids.AFFINE}.get(spec_name) or monoids.mask(n)


FUSED_CASES = [("sum", torch.float32), ("sum", torch.bfloat16),
               ("sum", torch.int32), ("segsum", torch.float32),
               ("mask", torch.int32), ("affine", torch.float32),
               ("affine", torch.bfloat16)]
# Rows with far more tiles than the card holds at once (132 SMs x a few
# blocks), a ragged tile, and Channels with 16- and 32-channel strips.
FUSED_LAYOUTS = [
    ("rows_16k_tiles", scan_engine.Rows(2, 1 << 22, 1, 512)),
    ("rows_96", scan_engine.Rows(3, 96 * 40, 1, 96)),
    ("channels_w16", scan_engine.Channels(2, 4096, 48, 64, 16)),
    ("channels_bt256", scan_engine.Channels(1, 8192, 1024, 256, 512)),
]


@pytest.mark.parametrize("layout", FUSED_LAYOUTS, ids=[c[0] for c in
                                                       FUSED_LAYOUTS])
@pytest.mark.parametrize("case", FUSED_CASES,
                         ids=[f"{s}-{str(d)[6:]}" for s, d in FUSED_CASES])
def test_cuda_fused_bitwise_vs_decoupled_and_plain(cuda_device, case, layout):
    """One launch of the look-back kernel, bitwise equal to the decoupled
    kernels and to ``fused_plain``, inclusive and exclusive, and the same
    bits on a repeated launch (a race would show as nondeterminism)."""
    spec_name, dtype = case
    lay = layout[1]
    spec = _spec(spec_name, lay.shape[-1])
    rng = np.random.default_rng(14)
    cpu = _spec_operands(rng, spec_name, lay.shape, dtype)
    gpu = tuple(o.to(cuda_device) for o in cpu)
    for exclusive in ((False, True) if spec.supports_exclusive
                      else (False,)):
        cuda.reset_launches()
        (got,) = scan_engine.scan(gpu, spec, lay, schedule="fused",
                                  exclusive=exclusive)
        torch.cuda.synchronize()
        assert cuda.LAUNCHES[cuda.kernel_name(spec.name, "fused")] == 1
        assert sum(cuda.LAUNCHES.values()) == 1
        (again,) = scan_engine.scan(gpu, spec, lay, schedule="fused",
                                    exclusive=exclusive)
        (dec,) = scan_engine.scan(gpu, spec, lay, schedule="decoupled",
                                  exclusive=exclusive)
        assert _same_bits(got, again) and _same_bits(got, dec), exclusive
        (want,) = scan_engine.schedules.fused_plain(cpu, spec, lay,
                                                    exclusive)
        assert _same_bits(got.cpu(), want), exclusive


# The chain over chunk totals: float specs fold on one thread (the
# sequential form), integer specs scan in parallel (their uint32 combines
# associate exactly); both must give exclusive_chain's bits.
CHAIN_CASES = [
    # (name, spec, totals dtype, (rows, chunks), running totals)
    ("sum_f32_long_row", "sum", torch.float32, (1, 131072), True),
    ("sum_f32_rows", "sum", torch.float32, (3, 5000), False),
    ("sum_f32_short_row", "sum", torch.float32, (2, 700), True),
    ("sum_i32_wraps", "sum", torch.int32, (2, 70000), True),
    ("mask_running", "mask", torch.int32, (1, 29292), True),
    ("segsum_f32_pair", "segsum", torch.float32, (4, 28879), True),
    ("segsum_i32_pair", "segsum", torch.int32, (3, 9000), True),
]


def _chain_totals(rng, spec_name, dtype, shape):
    """Chunk totals as a chain sees them: float32 sums, int32 sums near
    the int32 range (their running sums wrap), 0/1-heavy mask counts,
    and segmented pairs whose flags are any nonzero int32."""
    if spec_name == "mask":
        return (torch.from_numpy(rng.integers(0, 2049, shape)
                                 .astype(np.int32)),)
    if dtype == torch.int32:
        v = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31 - 1, shape,
                                          dtype=np.int64).astype(np.int32))
    else:
        v = torch.from_numpy(
            (rng.standard_normal(shape) * 100).astype(np.float32))
    if spec_name == "segsum":
        f = np.where(rng.random(shape) < 0.01, rng.choice([-3, 1, 2], shape),
                     0).astype(np.int32)
        return (v, torch.from_numpy(f))
    return (v,)


@pytest.mark.parametrize("case", CHAIN_CASES, ids=[c[0] for c in CHAIN_CASES])
def test_cuda_chain_bitwise_vs_exclusive_chain(cuda_device, case):
    """The chain kernel's offsets and running totals against the plain
    ``exclusive_chain`` (and offset ⊕ total) bitwise, one launch, and the
    same bits on a repeated launch."""
    name, spec_name, dtype, shape, with_running = case
    spec = _spec(spec_name, shape[1])
    rng = np.random.default_rng(sum(map(ord, name)))
    cpu = _chain_totals(rng, spec_name, dtype, shape)
    gpu = tuple(t.to(cuda_device) for t in cpu)
    cuda.reset_launches()
    offs, run = cuda.chain(spec, gpu, with_running)
    torch.cuda.synchronize()
    assert cuda.LAUNCHES[cuda.kernel_name(spec.name, "chain")] == 1
    assert sum(cuda.LAUNCHES.values()) == 1
    want = scan_engine.schedules.exclusive_chain(spec, cpu)
    for a, b in zip(offs, want):
        assert _same_bits(a.cpu(), b), name
    if with_running:
        for a, b in zip(run, spec.combine(want, cpu)):
            assert _same_bits(a.cpu(), b.to(a.dtype)), name
    again, _ = cuda.chain(spec, gpu, with_running)
    for a, b in zip(offs, again):
        assert _same_bits(a, b), name


@pytest.mark.parametrize("bn", totals_data.BLOCKS)
@pytest.mark.parametrize("kind", totals_data.KINDS)
def test_cuda_totals_reduce_bitwise_vs_plain(cuda_device, kind, bn):
    """``totals_reduce_kernel`` (Rows totals of the sum and the mask)
    against ``totals_plain`` and ``totals_tree_plain`` bitwise (NaN as
    NaN) on adversarial data — signed zeros at tile starts, subnormals,
    cancelling pairs, infinities — from an aligned base and from a base
    one element off (a view into a larger buffer), one launch each."""
    n = 3 * bn
    cpu = totals_data.operands(kind, 2, n, bn, 73)
    spec = monoids.mask(n) if kind == "mask" else monoids.SUM
    lay = scan_engine.Rows(2, n, 1, bn)
    (want,) = scan_engine.schedules.totals_plain((cpu,), spec, lay)
    (tree,) = scan_engine.schedules.totals_tree_plain((cpu,), spec, lay)
    assert totals_data.same_bits(tree, want)
    for offset in (0, 1):
        buf = torch.empty(cpu.numel() + offset, dtype=cpu.dtype,
                          device=cuda_device)
        x = buf[offset:].view(cpu.shape)
        x.copy_(cpu)
        assert x.is_contiguous()
        cuda.reset_launches()
        (got,) = cuda.totals(spec, (x,), lay)
        torch.cuda.synchronize()
        assert cuda.LAUNCHES == {**{k: 0 for k in cuda.LAUNCHES},
                                 cuda.kernel_name(spec.name, "totals"): 1}
        assert totals_data.same_bits(got.cpu(), want), f"offset {offset}"


def _kernel_names(fn):
    """The CUDA kernels one call of fn launches, by the profiler. The scan
    library is built and loaded before the window opens (a build inside
    it left the profiler recording nothing for the rest of the process),
    and the window opens with a fill kernel of its own, left out of the
    names (the profiler has missed the first launch of its window). A
    window that recorded no kernel of fn (CUPTI dropped its records: none
    at all, or the fill kernel alone) is profiled again, three times at
    most, the launch counters put back first, so that they show one call
    of fn."""
    from torch.profiler import ProfilerActivity, profile
    cuda.build()
    opener = torch.zeros(1, device="cuda")
    counts = dict(cuda.LAUNCHES)
    for _ in range(3):
        cuda.LAUNCHES.update(counts)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            opener.fill_(1.0)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        names = {e.key for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and "Fill" not in e.key and "fill" not in e.key}
        if names:
            break
    return names


def test_cuda_totals_launch_reduce_kernel_for_sum_and_mask(cuda_device):
    """SUM (every dtype), SEGSUM and MASK on Rows launch
    ``totals_reduce_kernel`` and never the network's ``totals_kernel``;
    AFFINE on Channels tiles of 256 steps launches
    ``totals_chan_reduce_kernel``; AFFINE on Rows and on Channels tiles of
    64 steps, and SUM on Channels launch ``totals_kernel``. The launch
    counters keep their keys."""
    rows = scan_engine.Rows(2, 4096, 1, 2048)
    chan = scan_engine.Channels(2, 1024, 8, 256, 8)
    chan64 = scan_engine.Channels(2, 1024, 8, 64, 8)
    ones = torch.ones(rows.shape, device=cuda_device)
    flags = torch.zeros(rows.shape, dtype=torch.int32, device=cuda_device)
    calls = [(monoids.SUM, (ones.to(dt),), rows, "totals_reduce_kernel")
             for dt in cuda.DTYPE_CODES]
    calls += [
        (monoids.mask(4096), (flags,), rows, "totals_reduce_kernel"),
        (monoids.SEGMENTED_SUM, (ones, flags), rows, "totals_reduce_kernel"),
        (monoids.SUM, (torch.ones(chan.shape, device=cuda_device),), chan,
         "totals_kernel"),
        (monoids.AFFINE, (torch.ones(chan.shape, device=cuda_device),) * 2,
         chan, "totals_chan_reduce_kernel"),
        (monoids.AFFINE, (torch.ones(chan.shape, device=cuda_device),) * 2,
         chan64, "totals_kernel"),
        (monoids.AFFINE, (ones, ones), rows, "totals_kernel"),
    ]
    spec_type = {"sum": "SumSpec", "mask": "MaskSpec",
                 "segsum": "SegSumSpec", "affine": "AffineSpec"}
    for spec, ops, lay, kernel in calls:
        cuda.reset_launches()
        names = _kernel_names(lambda: cuda.totals(spec, ops, lay))
        assert cuda.LAUNCHES[cuda.kernel_name(spec.name, "totals")] == 1
        hits = [k for k in names if "totals" in k]
        assert len(hits) == 1 and kernel + "<" in hits[0], (
            spec.name, ops[0].dtype, type(lay).__name__, names)
        # totals_chan_reduce_kernel takes the affine pair alone, by dtype,
        # tile and channels a thread
        inst = (f"<float, {lay.bt}, 4>"
                if kernel == "totals_chan_reduce_kernel"
                else spec_type[spec.name])
        assert inst in hits[0], hits


# carry and fused on Rows: the register network (carry_reg_kernel,
# fused_reg_kernel) on tiles of 128·r elements, the shared-memory network
# on the rest of totals_data.BLOCKS.
REG_KINDS = totals_data.KINDS[:6] + ("segsum", "mask")


def _reg_operands(kind, n, bn, seed):
    """(spec, CPU operands) of two rows: adversarial values (signed zeros
    at tile starts, subnormals, cancelling pairs, infinities); segmented
    flags that are negative or not 0/1."""
    if kind == "segsum":
        v = totals_data.operands("float32", 2, n, bn, seed)
        rng = np.random.default_rng(seed + 1)
        f = np.where(rng.random((2, n)) < 0.03, rng.choice([-3, 1, 2], (2, n)),
                     0).astype(np.int32)
        return monoids.SEGMENTED_SUM, (v, torch.from_numpy(f))
    spec = monoids.mask(n) if kind == "mask" else monoids.SUM
    return spec, (totals_data.operands(kind, 2, n, bn, seed),)


@pytest.mark.parametrize("bn", totals_data.BLOCKS)
@pytest.mark.parametrize("kind", REG_KINDS)
def test_cuda_carry_fused_rows_bitwise_vs_plain(cuda_device, kind, bn):
    """carry (outputs and running totals) and fused, one launch each,
    bitwise against ``carry_plain`` / ``fused_plain`` (NaN as NaN),
    carry == decoupled == fused, inclusive and exclusive, from aligned
    bases and from bases one element off (views into larger buffers)."""
    n = 3 * bn
    spec, cpu = _reg_operands(kind, n, bn, 74)
    lay = scan_engine.Rows(2, n, 1, bn)
    same = totals_data.same_bits
    for offset in (0, 1):
        gpu = []
        for o in cpu:
            buf = torch.empty(o.numel() + offset, dtype=o.dtype,
                              device=cuda_device)
            gpu.append(buf[offset:].view(o.shape))
            gpu[-1].copy_(o)
        gpu = tuple(gpu)
        for exclusive in ((False, True) if spec.supports_exclusive
                          else (False,)):
            what = (offset, exclusive)
            cuda.reset_launches()
            (got,), run = cuda.carry(spec, gpu, lay, exclusive, True)
            (fo,) = cuda.fused(spec, gpu, lay, exclusive)
            torch.cuda.synchronize()
            assert cuda.LAUNCHES == {**{k: 0 for k in cuda.LAUNCHES},
                                     cuda.kernel_name(spec.name, "carry"): 1,
                                     cuda.kernel_name(spec.name, "fused"): 1}
            (want,), w_run = scan_engine.schedules.carry_plain(
                cpu, spec, lay, exclusive, return_totals=True)
            assert same(got.cpu(), want), what
            for a, b in zip(run, w_run):
                assert same(a.cpu(), b), what
            (w_fused,) = scan_engine.schedules.fused_plain(cpu, spec, lay,
                                                           exclusive)
            assert same(fo.cpu(), w_fused), what
            (dec,) = scan_engine.scan(gpu, spec, lay, schedule="decoupled",
                                      exclusive=exclusive)
            assert same(dec, got) and same(fo, got), what


def test_cuda_carry_fused_network_by_shape(cuda_device):
    """By the profiler's kernel names: carry and fused on Rows tiles of
    128·r elements launch the register network for the sum (every dtype),
    the segmented sum and the mask, at block_n 128 to 16384; other tile
    lengths, the affine pair on Rows and Channels launch the
    shared-memory network, but the affine carry and fused on Channels
    tiles of 256 steps, which launch ``carry_chan_reg_kernel`` and
    ``fused_chan_reg_kernel``. ``cuda.tile_network`` names the same
    choice, and the launch counters keep their keys."""
    ones = torch.ones((2, 32768), device=cuda_device)
    flags = torch.zeros((2, 32768), dtype=torch.int32, device=cuda_device)
    chan = scan_engine.Channels(2, 1024, 8, 256, 8)
    ones_c = torch.ones(chan.shape, device=cuda_device)
    calls = [(monoids.SUM, (ones.to(dt),), scan_engine.Rows(2, 32768, 1, bn))
             for dt in cuda.DTYPE_CODES for bn in (128, 2048, 16384)]
    calls += [
        (monoids.SEGMENTED_SUM, (ones, flags), scan_engine.Rows(2, 32768, 1, 2048)),
        (monoids.SEGMENTED_SUM, (ones, flags), scan_engine.Rows(2, 32768, 1, 16384)),
        (monoids.mask(32768), (flags,), scan_engine.Rows(2, 32768, 1, 2048)),
        (monoids.SUM, (ones[:, :600],), scan_engine.Rows(2, 600, 1, 200)),
        (monoids.SEGMENTED_SUM, (ones[:, :600], flags[:, :600]),
         scan_engine.Rows(2, 600, 1, 200)),
        (monoids.AFFINE, (ones[:, :512], ones[:, :512]),
         scan_engine.Rows(2, 512, 1, 256)),
        (monoids.SUM, (ones_c,), chan),
        (monoids.AFFINE, (ones_c, ones_c), chan),
    ]
    for spec, ops_, lay in calls:
        ops_ = tuple(o.contiguous() for o in ops_)
        for kernel in ("carry", "fused"):
            reg = cuda.tile_network(spec, lay, kernel) == "register"
            fn = getattr(cuda, kernel)
            cuda.reset_launches()
            names = _kernel_names(lambda: fn(spec, ops_, lay))
            assert cuda.LAUNCHES[cuda.kernel_name(spec.name, kernel)] == 1
            hits = [k for k in names if kernel in k]
            chan = isinstance(lay, scan_engine.Channels)
            want = (f"{kernel}_kernel<" if not reg else
                    f"{kernel}_chan_reg_kernel<" if chan else
                    f"{kernel}_reg_kernel<")
            assert len(hits) == 1 and want in hits[0], (
                spec.name, ops_[0].dtype, lay, names)


@pytest.mark.parametrize("bn", totals_data.BLOCKS)
@pytest.mark.parametrize("kind", REG_KINDS)
def test_cuda_apply_tree_rows_bitwise_vs_plain(cuda_device, kind, bn):
    """apply (given the plain chain's offsets) and tree (outputs and
    running totals), one launch each, bitwise against ``apply_plain`` /
    ``tree_plain`` (NaN as NaN), and decoupled == carry == fused ==
    apply, inclusive and exclusive, from aligned bases and from bases one
    element off, with -0.0 at every segment start besides the tile
    starts' signed zeros."""
    n = 3 * bn
    spec, cpu = _reg_operands(kind, n, bn, 75)
    if cpu[0].dtype.is_floating_point:
        seg = torch.zeros(n, dtype=torch.bool)
        seg[::128] = True
        seg[::bn] = False
        cpu[0][:, seg] = -0.0
    lay = scan_engine.Rows(2, n, 1, bn)
    sched = scan_engine.schedules
    same = totals_data.same_bits
    offsets = sched.exclusive_chain(spec, sched.totals_plain(cpu, spec, lay))
    offs = tuple(o.to(cuda_device) for o in offsets)
    for offset in (0, 1):
        gpu = []
        for o in cpu:
            buf = torch.empty(o.numel() + offset, dtype=o.dtype,
                              device=cuda_device)
            gpu.append(buf[offset:].view(o.shape))
            gpu[-1].copy_(o)
        gpu = tuple(gpu)
        for exclusive in ((False, True) if spec.supports_exclusive
                          else (False,)):
            what = (offset, exclusive)
            cuda.reset_launches()
            (ap,) = cuda.apply(spec, gpu, offs, lay, exclusive)
            (tr,), run = cuda.tree(spec, gpu, lay, exclusive, True)
            torch.cuda.synchronize()
            assert cuda.LAUNCHES == {**{k: 0 for k in cuda.LAUNCHES},
                                     cuda.kernel_name(spec.name, "apply"): 1,
                                     cuda.kernel_name(spec.name, "tree"): 1}
            (want,) = sched.apply_plain(cpu, offsets, spec, lay, exclusive)
            assert same(ap.cpu(), want), what
            (w_tree,), w_run = sched.tree_plain(cpu, spec, lay, exclusive,
                                                return_totals=True)
            assert same(tr.cpu(), w_tree), what
            for a, b in zip(run, w_run):
                assert same(a.cpu(), b), what
            (dec,) = scan_engine.scan(gpu, spec, lay, schedule="decoupled",
                                      exclusive=exclusive)
            (car,), _ = cuda.carry(spec, gpu, lay, exclusive)
            (fo,) = cuda.fused(spec, gpu, lay, exclusive)
            assert same(dec, ap) and same(car, ap) and same(fo, ap), what


def test_cuda_apply_tree_network_by_shape(cuda_device):
    """By the profiler's kernel names: apply and tree on Rows tiles of
    128·r elements launch ``apply_reg_kernel`` / ``tree_reg_kernel`` for
    the sum (every dtype), the segmented sum and the mask, at block_n 128
    to 16384; the affine apply on Channels tiles of 256 steps launches
    ``apply_chan_reg_kernel`` and its tree ``tree_chan_reg_kernel``; other
    tile lengths, the affine pair on Rows and the sum on Channels launch
    ``apply_kernel`` / ``tree_kernel``. ``cuda.tile_network`` names the same choice, and
    the launch counters keep their keys."""
    ones = torch.ones((2, 32768), device=cuda_device)
    flags = torch.zeros((2, 32768), dtype=torch.int32, device=cuda_device)
    chan = scan_engine.Channels(2, 1024, 8, 256, 8)
    ones_c = torch.ones(chan.shape, device=cuda_device)
    calls = [(monoids.SUM, (ones.to(dt),), scan_engine.Rows(2, 32768, 1, bn))
             for dt in cuda.DTYPE_CODES for bn in (128, 2048, 16384)]
    calls += [
        (monoids.SEGMENTED_SUM, (ones, flags), scan_engine.Rows(2, 32768, 1, 2048)),
        (monoids.SEGMENTED_SUM, (ones, flags), scan_engine.Rows(2, 32768, 1, 16384)),
        (monoids.mask(32768), (flags,), scan_engine.Rows(2, 32768, 1, 2048)),
        (monoids.mask(32768), (flags,), scan_engine.Rows(2, 32768, 1, 8192)),
        (monoids.SUM, (ones[:, :600],), scan_engine.Rows(2, 600, 1, 200)),
        (monoids.SEGMENTED_SUM, (ones[:, :600], flags[:, :600]),
         scan_engine.Rows(2, 600, 1, 200)),
        (monoids.AFFINE, (ones[:, :512], ones[:, :512]),
         scan_engine.Rows(2, 512, 1, 256)),
        (monoids.SUM, (ones_c,), chan),
        (monoids.AFFINE, (ones_c, ones_c), chan),
    ]
    for spec, ops_, lay in calls:
        ops_ = tuple(o.contiguous() for o in ops_)
        offs, _ = cuda.chain(spec, cuda.totals(spec, ops_, lay))
        for kernel, fn in (("apply", lambda: cuda.apply(spec, ops_, offs, lay)),
                           ("tree", lambda: cuda.tree(spec, ops_, lay))):
            reg = cuda.tile_network(spec, lay, kernel) == "register"
            cuda.reset_launches()
            names = _kernel_names(fn)
            assert cuda.LAUNCHES[cuda.kernel_name(spec.name, kernel)] == 1
            hits = [k for k in names if kernel in k]
            chan_reg = "_chan" if isinstance(lay, scan_engine.Channels) else ""
            want = (f"{kernel}{chan_reg}_reg_kernel<" if reg
                    else f"{kernel}_kernel<")
            assert len(hits) == 1 and want in hits[0], (
                spec.name, ops_[0].dtype, lay, names)


@pytest.mark.parametrize("spec_name,dtype", [
    ("sum", torch.float32), ("sum", torch.int32), ("mask", torch.int32),
    ("segsum", torch.float32)], ids=["sum-f32", "sum-i32", "mask",
                                     "segsum-f32"])
def test_cuda_long_row_carry_decoupled_fused_bitwise(cuda_device, spec_name,
                                                     dtype):
    """A long row of small tiles (16,384 chunks: sixteen chain stages):
    carry, decoupled (totals, chain, apply) and fused give the same bits,
    and decoupled the plain version's."""
    lay = scan_engine.Rows(1, 1 << 21, 1, 128)
    spec = _spec(spec_name, lay.shape[-1])
    rng = np.random.default_rng(15)
    cpu = _spec_operands(rng, spec_name, lay.shape, dtype)
    gpu = tuple(o.to(cuda_device) for o in cpu)
    got = {s: scan_engine.scan(gpu, spec, lay, schedule=s)[0]
           for s in ("carry", "decoupled", "fused")}
    assert _same_bits(got["decoupled"], got["carry"])
    assert _same_bits(got["fused"], got["carry"])
    (want,) = scan_engine.schedules.scan_decoupled(cpu, spec, lay)
    assert _same_bits(got["decoupled"].cpu(), want)


AFFINE_SHAPES = [(1, 1024, 512), (2, 1000, 48), (3, 300, 4096)]


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16,
                                   torch.float16), ids=str)
@pytest.mark.parametrize("schedule", SCHEDULES4)
def test_cuda_affine_bitwise_vs_plain(cuda_device, schedule, dtype):
    """``ssm_scan`` through the affine kernels under every schedule, tile
    lengths from 64 to 8192 (the longest an affine tile may be), bitwise
    equal to the plain versions on CPU copies."""
    from repro_torch.kernels.ssm_scan import ops as ssm_ops

    rng = np.random.default_rng(15)
    for shape in AFFINE_SHAPES:
        a, b = _spec_operands(rng, "affine", shape, dtype)
        for bt in (64, 256, 8192):
            cuda.reset_launches()
            got = ssm_ops.ssm_scan(a.to(cuda_device), b.to(cuda_device),
                                   block_t=bt, schedule=schedule)
            torch.cuda.synchronize()
            assert sum(n for k, n in cuda.LAUNCHES.items()
                       if k.startswith("affine_")) > 0
            want = ssm_ops.ssm_scan(a, b, block_t=bt, schedule=schedule)
            assert _same_bits(got.cpu(), want), (shape, bt)


@pytest.mark.parametrize("schedule", SCHEDULES4)
def test_cuda_affine_running_totals_and_kernels(cuda_device, schedule):
    """The affine kernels one by one on Channels, running totals
    included, against their plain versions."""
    rng = np.random.default_rng(16)
    lay = scan_engine.Channels(2, 2048, 96, 128, 96)
    cpu = _spec_operands(rng, "affine", lay.shape, torch.float32)
    gpu = tuple(o.to(cuda_device) for o in cpu)
    outs, tot = scan_engine.scan(gpu, monoids.AFFINE, lay, schedule=schedule,
                                 return_totals=True)
    w_outs, w_tot = scan_engine.scan(cpu, monoids.AFFINE, lay,
                                     schedule=schedule, return_totals=True)
    assert _same_bits(outs[0].cpu(), w_outs[0])
    for x, y in zip(tot, w_tot):
        assert _same_bits(x.cpu(), y)
    tots = cuda.totals(monoids.AFFINE, gpu, lay)
    plain_t = scan_engine.schedules.totals_plain(cpu, monoids.AFFINE, lay)
    offs, run = cuda.chain(monoids.AFFINE, tots, True)
    plain_o = scan_engine.exclusive_chain(monoids.AFFINE, plain_t)
    for x, y in zip(tots + offs, plain_t + plain_o):
        assert _same_bits(x.cpu(), y)
    (out,) = cuda.apply(monoids.AFFINE, gpu, offs, lay, exclusive=True)
    (w_out,) = scan_engine.schedules.apply_plain(cpu, plain_o,
                                                 monoids.AFFINE, lay, True)
    assert _same_bits(out.cpu(), w_out)


def _chan_operands(rng, shape, bt, dtype):
    """Affine (a, b) on Channels: gates in [0.7, 1] with negative gates,
    -0.0 and +0.0 gates scattered; offsets with -0.0 at every tile start
    and scattered, so that the identity combine's +0.0 shows."""
    a = rng.uniform(0.7, 1.0, shape).astype(np.float32)
    a[rng.random(shape) < 0.05] *= -1
    a[rng.random(shape) < 0.01] = -0.0
    a[rng.random(shape) < 0.01] = 0.0
    b = rng.standard_normal(shape).astype(np.float32)
    b[rng.random(shape) < 0.05] = -0.0
    b[:, ::bt] = -0.0
    return tuple(torch.from_numpy(v).to(dtype) for v in (a, b))


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16,
                                   torch.float16), ids=str)
@pytest.mark.parametrize("bt", cuda.CHAN_REG_TILES)
def test_cuda_affine_carry_channels_register_bitwise(cuda_device, bt, dtype):
    """The affine carry on Channels tiles of 128, 256 and 512 steps runs
    ``carry_chan_reg_kernel`` (by the profiler's names) and gives
    ``carry_plain``'s outputs and running totals bit for bit, inclusive
    and exclusive, from aligned bases and from bases one element off,
    over strips of 4 to 32 channels; decoupled == carry == fused."""
    rng = np.random.default_rng(bt)
    sched = scan_engine.schedules
    same = totals_data.same_bits
    for shape in ((2, 4 * bt, 48), (1, 2 * bt, 4), (1, 3 * bt, 96)):
        lay = scan_engine.Channels(*shape, bt, shape[2])
        assert cuda.tile_network(monoids.AFFINE, lay, "carry") == "register"
        cpu = _chan_operands(rng, shape, bt, dtype)
        for offset in (0, 1):
            gpu = []
            for o in cpu:
                buf = torch.empty(o.numel() + offset, dtype=o.dtype,
                                  device=cuda_device)
                gpu.append(buf[offset:].view(o.shape))
                gpu[-1].copy_(o)
            gpu = tuple(gpu)
            for exclusive in (False, True):
                what = (shape, offset, exclusive)
                cuda.reset_launches()
                (got,), run = cuda.carry(monoids.AFFINE, gpu, lay, exclusive,
                                         True)
                torch.cuda.synchronize()
                assert cuda.LAUNCHES["affine_carry"] == 1
                (want,), w_run = sched.carry_plain(cpu, monoids.AFFINE, lay,
                                                   exclusive, True)
                assert same(got.cpu(), want), what
                for x, y in zip(run, w_run):
                    assert same(x.cpu(), y), what
                (nrt,), _ = cuda.carry(monoids.AFFINE, gpu, lay, exclusive)
                (dec,) = scan_engine.scan(gpu, monoids.AFFINE, lay,
                                          schedule="decoupled",
                                          exclusive=exclusive)
                (fo,) = cuda.fused(monoids.AFFINE, gpu, lay, exclusive)
                assert same(nrt, got) and same(dec, got) and same(fo, got), \
                    what
        names = _kernel_names(lambda: cuda.carry(monoids.AFFINE, gpu, lay))
        assert any("carry_chan_reg_kernel<" in k for k in names), names


def test_cuda_affine_carry_channels_networks_agree(cuda_device):
    """At the SSD carry's tiling (256 steps, 16-channel strips) the register
    and the shared-memory carry give the same bits, outputs and running
    totals."""
    rng = np.random.default_rng(21)
    lay = scan_engine.Channels(1, 1024, 2048, 256, 2048)
    gpu = tuple(t.to(cuda_device) for t in _chan_operands(
        rng, lay.shape, 256, torch.float32))
    reg = cuda.carry(monoids.AFFINE, gpu, lay, False, True)
    shared = cuda.carry(monoids.AFFINE, gpu, lay, False, True,
                        network="shared")
    for x, y in zip((reg[0][0],) + reg[1], (shared[0][0],) + shared[1]):
        assert _same_bits(x, y)


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16,
                                   torch.float16), ids=str)
@pytest.mark.parametrize("bt", cuda.CHAN_REG_TILES)
def test_cuda_affine_fused_channels_register_bitwise(cuda_device, bt, dtype):
    """The affine fused on Channels tiles of 128, 256 and 512 steps runs
    ``fused_chan_reg_kernel`` (one launch, and by the profiler's names)
    and gives ``fused_plain``'s bits, inclusive and exclusive, from
    aligned bases and from bases one element off, over strips of 4 to 32
    channels and lanes of 2 to 16 tiles; it equals the carry
    (``carry_chan_reg_kernel``), decoupled and the shared-memory
    ``fused_kernel`` launched by name (``network="shared"``), each launch
    counted."""
    rng = np.random.default_rng(bt + 7)
    sched = scan_engine.schedules
    same = totals_data.same_bits
    aff = monoids.AFFINE
    for shape in ((2, 4 * bt, 48), (1, 2 * bt, 4), (1, 16 * bt, 96)):
        lay = scan_engine.Channels(*shape, bt, shape[2])
        assert cuda.tile_network(aff, lay, "fused") == "register"
        cpu = _chan_operands(rng, shape, bt, dtype)
        for offset in (0, 1):
            gpu = []
            for o in cpu:
                buf = torch.empty(o.numel() + offset, dtype=o.dtype,
                                  device=cuda_device)
                gpu.append(buf[offset:].view(o.shape))
                gpu[-1].copy_(o)
            gpu = tuple(gpu)
            for exclusive in (False, True):
                what = (shape, offset, exclusive)
                cuda.reset_launches()
                (got,) = cuda.fused(aff, gpu, lay, exclusive)
                torch.cuda.synchronize()
                assert cuda.LAUNCHES["affine_fused"] == 1
                assert sum(cuda.LAUNCHES.values()) == 1
                (want,) = sched.fused_plain(cpu, aff, lay, exclusive)
                assert same(got.cpu(), want), what
                cuda.reset_launches()
                (shared,) = cuda.fused(aff, gpu, lay, exclusive,
                                       network="shared")
                (carry,), _ = cuda.carry(aff, gpu, lay, exclusive)
                (dec,) = scan_engine.scan(gpu, aff, lay, schedule="decoupled",
                                          exclusive=exclusive)
                torch.cuda.synchronize()
                assert {k: v for k, v in cuda.LAUNCHES.items() if v} == {
                    "affine_fused": 1, "affine_carry": 1, "affine_totals": 1,
                    "affine_chain": 1, "affine_apply": 1}
                assert same(shared, got) and same(carry, got) and \
                    same(dec, got), what
    names = _kernel_names(lambda: cuda.fused(aff, gpu, lay))
    assert any("fused_chan_reg_kernel<" in k for k in names), names
    names = _kernel_names(lambda: cuda.fused(aff, gpu, lay,
                                             network="shared"))
    assert any("::fused_kernel<" in k for k in names), names


def test_cuda_affine_fused_channels_networks_agree(cuda_device):
    """At the SSD carry's tiling (256 steps; 32-channel strips for the
    register fused, 16 for the shared one) the register and the
    shared-memory fused give the carry's bits, over lanes of four
    tiles."""
    rng = np.random.default_rng(23)
    lay = scan_engine.Channels(1, 1024, 2048, 256, 2048)
    gpu = tuple(t.to(cuda_device) for t in _chan_operands(
        rng, lay.shape, 256, torch.float32))
    assert cuda.chan_reg_width(lay) == 32 and cuda.channel_width(lay) == 16
    (reg,) = cuda.fused(monoids.AFFINE, gpu, lay)
    (shared,) = cuda.fused(monoids.AFFINE, gpu, lay, network="shared")
    (carry,), _ = cuda.carry(monoids.AFFINE, gpu, lay)
    assert _same_bits(reg, shared) and _same_bits(reg, carry)


def _offset_copy(t, offset, device):
    """A copy of CPU tensor t on the card whose base lies ``offset``
    elements past an aligned allocation."""
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=device)
    view = buf[offset:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16,
                                   torch.float16), ids=str)
@pytest.mark.parametrize("bt", cuda.CHAN_REG_TILES)
def test_cuda_affine_totals_apply_channels_register_bitwise(cuda_device, bt,
                                                            dtype):
    """decoupled's affine totals and apply on Channels tiles of 128, 256
    and 512 steps run ``totals_chan_reduce_kernel`` and
    ``apply_chan_reg_kernel`` (by the profiler's names): the totals
    bitwise ``totals_plain``, ``totals_tree_plain`` and the shared
    ``totals_kernel`` (``network="shared"``), the chain's offsets
    ``exclusive_chain``'s, the outputs ``apply_plain``'s and the shared
    ``apply_kernel``'s, inclusive and exclusive, from aligned bases and
    bases one element off, over strips of 4 to 32 channels, D = 7 (the
    reduction's scalar loads; the apply stays shared) and one strip of 32
    tiles (its walk split so the grid fills the card); decoupled == carry
    == fused."""
    rng = np.random.default_rng(bt + 11)
    sched = scan_engine.schedules
    same = totals_data.same_bits
    aff = monoids.AFFINE
    for shape in ((2, 4 * bt, 48), (1, 2 * bt, 4), (1, 3 * bt, 96),
                  (2, 2 * bt, 7), (1, 32 * bt, 32)):
        lay = scan_engine.Channels(*shape, bt, shape[2])
        assert cuda.tile_network(aff, lay, "totals") == "register"
        reg_apply = cuda.tile_network(aff, lay, "apply") == "register"
        assert reg_apply == (shape[2] != 7)
        cpu = _chan_operands(rng, shape, bt, dtype)
        w_tot = sched.totals_plain(cpu, aff, lay)
        tree = sched.totals_tree_plain(cpu, aff, lay)
        w_off = scan_engine.exclusive_chain(aff, w_tot)
        assert all(same(x, y) for x, y in zip(tree, w_tot))
        for offset in (0, 1):
            gpu = tuple(_offset_copy(o, offset, cuda_device) for o in cpu)
            what = (shape, offset)
            cuda.reset_launches()
            tot = cuda.totals(aff, gpu, lay)
            torch.cuda.synchronize()
            assert cuda.LAUNCHES["affine_totals"] == 1
            shared_tot = cuda.totals(aff, gpu, lay, network="shared")
            for x, y, z in zip(tot, w_tot, shared_tot):
                assert same(x.cpu(), y) and same(x, z), what
            offs, _ = cuda.chain(aff, tot)
            for x, y in zip(offs, w_off):
                assert same(x.cpu(), y), what
            for exclusive in (False, True):
                what = (shape, offset, exclusive)
                cuda.reset_launches()
                (got,) = cuda.apply(aff, gpu, offs, lay, exclusive)
                torch.cuda.synchronize()
                assert cuda.LAUNCHES["affine_apply"] == 1
                (want,) = sched.apply_plain(cpu, w_off, aff, lay, exclusive)
                assert same(got.cpu(), want), what
                (shared,) = cuda.apply(aff, gpu, offs, lay, exclusive,
                                       network="shared")
                (dec,) = scan_engine.scan(gpu, aff, lay, schedule="decoupled",
                                          exclusive=exclusive)
                (carry,), _ = cuda.carry(aff, gpu, lay, exclusive)
                (fo,) = cuda.fused(aff, gpu, lay, exclusive)
                assert same(shared, got) and same(dec, got) and \
                    same(carry, got) and same(fo, got), what
        names = _kernel_names(lambda: scan_engine.scan(
            gpu, aff, lay, schedule="decoupled"))
        assert any("totals_chan_reduce_kernel<" in k for k in names), names
        want = "apply_chan_reg_kernel<" if reg_apply else "::apply_kernel<"
        assert any(want in k for k in names), names


def test_cuda_affine_totals_apply_channels_networks_agree(cuda_device):
    """At the SSD carry's tiling (256 steps; 32-channel strips for the
    register apply, 16 for the shared one) the reduced and the network's
    totals, and the register and the shared-memory apply, give the same
    bits, and decoupled gives the carry's and the fused's, over lanes of
    four tiles."""
    rng = np.random.default_rng(25)
    aff = monoids.AFFINE
    lay = scan_engine.Channels(1, 1024, 2048, 256, 2048)
    gpu = tuple(t.to(cuda_device) for t in _chan_operands(
        rng, lay.shape, 256, torch.float32))
    tot = cuda.totals(aff, gpu, lay)
    shared_tot = cuda.totals(aff, gpu, lay, network="shared")
    assert all(_same_bits(x, y) for x, y in zip(tot, shared_tot))
    offs, _ = cuda.chain(aff, tot)
    for exclusive in (False, True):
        (reg,) = cuda.apply(aff, gpu, offs, lay, exclusive)
        (shared,) = cuda.apply(aff, gpu, offs, lay, exclusive,
                               network="shared")
        (carry,), _ = cuda.carry(aff, gpu, lay, exclusive)
        (fo,) = cuda.fused(aff, gpu, lay, exclusive)
        assert _same_bits(reg, shared) and _same_bits(reg, carry) and \
            _same_bits(reg, fo)


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16,
                                   torch.float16), ids=str)
@pytest.mark.parametrize("bt", cuda.CHAN_REG_TILES)
def test_cuda_affine_tree_channels_register_bitwise(cuda_device, bt, dtype):
    """The affine tree on Channels tiles of 128, 256 and 512 steps runs
    ``tree_chan_reg_kernel`` and gives ``tree_plain``'s outputs and
    running totals bit for bit, and the shared ``tree_kernel``'s
    (``network="shared"``), inclusive and exclusive, from aligned bases
    and bases one element off, over strips whose ``chan_reg_width`` is 4,
    8, 16 and (but at bt 512) 32 channels."""
    rng = np.random.default_rng(bt + 26)
    sched = scan_engine.schedules
    same = totals_data.same_bits
    aff = monoids.AFFINE
    widths = set()
    for shape in ((1, 2 * bt, 4), (2, 3 * bt, 24), (2, 4 * bt, 48),
                  (1, 3 * bt, 96)):
        lay = scan_engine.Channels(*shape, bt, shape[2])
        assert cuda.tile_network(aff, lay, "tree") == "register"
        widths.add(cuda.chan_reg_width(lay))
        cpu = _chan_operands(rng, shape, bt, dtype)
        for offset in (0, 1):
            gpu = tuple(_offset_copy(o, offset, cuda_device) for o in cpu)
            for exclusive in (False, True):
                what = (shape, offset, exclusive)
                cuda.reset_launches()
                (got,), run = cuda.tree(aff, gpu, lay, exclusive, True)
                torch.cuda.synchronize()
                assert cuda.LAUNCHES["affine_tree"] == 1
                (want,), w_run = sched.tree_plain(cpu, aff, lay, exclusive,
                                                  True)
                assert same(got.cpu(), want), what
                for x, y in zip(run, w_run):
                    assert same(x.cpu(), y), what
                (sh,), sh_run = cuda.tree(aff, gpu, lay, exclusive, True,
                                          network="shared")
                assert same(sh, got), what
                for x, y in zip(sh_run, run):
                    assert same(x, y), what
    # strips of 32 channels where the tile's 32 bt elements fit in
    # CHAN_REG_TILE (bt 128 and 256), of 16 at bt 512
    assert widths == {w for w in (4, 8, 16, 32)
                      if w * bt <= cuda.CHAN_REG_TILE}
    names = _kernel_names(lambda: cuda.tree(aff, gpu, lay))
    assert any("tree_chan_reg_kernel<" in k for k in names), names


def test_cuda_affine_tree_channels_networks_agree(cuda_device):
    """At the SSD carry's tiling (256 steps; 32-channel strips for the
    register tree, 16 for the shared one) the two trees give the same
    bits, outputs and running totals, over lanes of four tiles."""
    rng = np.random.default_rng(26)
    lay = scan_engine.Channels(1, 1024, 2048, 256, 2048)
    gpu = tuple(t.to(cuda_device) for t in _chan_operands(
        rng, lay.shape, 256, torch.float32))
    for exclusive in (False, True):
        reg = cuda.tree(monoids.AFFINE, gpu, lay, exclusive, True)
        shared = cuda.tree(monoids.AFFINE, gpu, lay, exclusive, True,
                           network="shared")
        for x, y in zip((reg[0][0],) + reg[1], (shared[0][0],) + shared[1]):
            assert _same_bits(x, y)


def test_cuda_tree_launch_chan_reg_kernel_for_affine_channels(cuda_device):
    """By the profiler's names: the affine tree on Channels tiles of 128,
    256 and 512 steps over strips of a multiple of four channels launches
    ``tree_chan_reg_kernel`` (by dtype, slots a lane and vector form);
    tiles of 64 steps and strips of two channels launch the shared
    ``tree_kernel``, as ``network="shared"`` does at any shape. The launch
    counter keeps its key."""
    calls = []
    for bt in cuda.CHAN_REG_TILES:
        for dt in (torch.float32, torch.bfloat16):
            lay = scan_engine.Channels(1, 2 * bt, 8, bt, 8)
            ops = (torch.ones(lay.shape, dtype=dt, device=cuda_device),) * 2
            calls.append((ops, lay, None,
                          f"tree_chan_reg_kernel<{_CT[dt]}, {bt // 32}, "))
            calls.append((ops, lay, "shared", "tree_kernel<"))
    for lay in (scan_engine.Channels(1, 512, 8, 64, 8),
                scan_engine.Channels(1, 512, 2, 256, 2)):
        ops = (torch.ones(lay.shape, device=cuda_device),) * 2
        calls.append((ops, lay, None, "tree_kernel<"))
    for ops, lay, network, want in calls:
        cuda.reset_launches()
        names = _kernel_names(lambda: cuda.tree(monoids.AFFINE, ops, lay,
                                                network=network))
        assert cuda.LAUNCHES["affine_tree"] == 1
        hits = [k for k in names if "tree" in k]
        assert len(hits) == 1 and want in hits[0], (lay, network, names)
        assert ("tree_chan_reg_kernel<" in hits[0]) == (
            (network or cuda.tile_network(monoids.AFFINE, lay, "tree"))
            == "register")


# dtype names in the profiler's kernel names
_CT = {torch.float32: "float", torch.bfloat16: "__nv_bfloat16",
       torch.float16: "__half"}


def _segsum_flags(rng, kind, n, bn):
    if kind == "sparse":
        f = np.where(rng.random((2, n)) < 0.01, rng.choice([1, -3, 2], (2, n)),
                     0)
    elif kind == "dense":
        f = np.where(rng.random((2, n)) < 0.5, rng.choice([1, -3, 2], (2, n)),
                     0)
    else:
        f = np.zeros((2, n), np.int64)
        f[:, ::bn] = 1
        f[:, bn - 1::bn] = -7
    return torch.from_numpy(f.astype(np.int32))


# The segmented sum's reduced totals: Q1's tile, ragged, lane-divisible
# and the largest tiles, and a few short ones; a tile of one element is
# left out, since its total is the element itself with its flag as given
# (the plain version keeps -3 where every kernel keeps flag != 0, which no
# output can tell apart).
SEG_TOTALS_BLOCKS = (2, 3, 64, 127, 128, 129, 200, 256, 384, 640, 2048,
                     2176, 16384)


@pytest.mark.parametrize("flags", ("sparse", "dense", "ends"))
@pytest.mark.parametrize("bn", SEG_TOTALS_BLOCKS)
@pytest.mark.parametrize("kind", totals_data.KINDS[:6])
def test_cuda_segsum_totals_reduce_bitwise_vs_plain(cuda_device, kind, bn,
                                                    flags):
    """The segmented sum's Rows totals (``totals_reduce_kernel``) against
    ``totals_plain``, ``totals_tree_plain`` and the network's
    ``totals_kernel`` (``network="shared"``) bitwise, both leaves, every
    value dtype, flags sparse, dense and on every tile's first and last
    element, from aligned bases and from bases one element off."""
    n = 3 * bn
    rng = np.random.default_rng(bn + 29)
    cpu = (totals_data.operands(kind, 2, n, bn, bn + 30),
           _segsum_flags(rng, flags, n, bn))
    spec = monoids.SEGMENTED_SUM
    lay = scan_engine.Rows(2, n, 1, bn)
    assert cuda.tile_network(spec, lay, "totals") == "register"
    want = scan_engine.schedules.totals_plain(cpu, spec, lay)
    tree = scan_engine.schedules.totals_tree_plain(cpu, spec, lay)
    assert all(totals_data.same_bits(x, y) for x, y in zip(tree, want))
    for offset in (0, 1):
        gpu = tuple(_offset_copy(o, offset, cuda_device) for o in cpu)
        cuda.reset_launches()
        got = cuda.totals(spec, gpu, lay)
        torch.cuda.synchronize()
        assert cuda.LAUNCHES == {**{k: 0 for k in cuda.LAUNCHES},
                                 "segsum_totals": 1}
        shared = cuda.totals(spec, gpu, lay, network="shared")
        for x, y, z in zip(got, want, shared):
            assert totals_data.same_bits(x.cpu(), y), (offset, x.dtype)
            assert totals_data.same_bits(x, z), (offset, x.dtype)


def test_cuda_totals_launch_reduce_kernel_for_segsum(cuda_device):
    """By the profiler's names: the segmented sum's totals on Rows launch
    ``totals_reduce_kernel`` for every value dtype at tiles of 128·r
    elements and of other lengths, and ``network="shared"`` the
    network's ``totals_kernel``; on Channels they stay on
    ``totals_kernel``. The launch counter keeps its key."""
    spec = monoids.SEGMENTED_SUM
    calls = []
    for dt in cuda.DTYPE_CODES:
        for lay in (scan_engine.Rows(2, 4096, 1, 2048),
                    scan_engine.Rows(2, 600, 1, 200)):
            ops = (torch.ones(lay.shape, dtype=dt, device=cuda_device),
                   torch.zeros(lay.shape, dtype=torch.int32,
                               device=cuda_device))
            calls.append((ops, lay, None, "totals_reduce_kernel<"))
            calls.append((ops, lay, "shared", "totals_kernel<"))
    chan = scan_engine.Channels(2, 1024, 8, 256, 8)
    calls.append(((torch.ones(chan.shape, device=cuda_device),
                   torch.zeros(chan.shape, dtype=torch.int32,
                               device=cuda_device)), chan, None,
                  "totals_kernel<"))
    for ops, lay, network, want in calls:
        cuda.reset_launches()
        names = _kernel_names(lambda: cuda.totals(spec, ops, lay,
                                                  network=network))
        assert cuda.LAUNCHES["segsum_totals"] == 1
        hits = [k for k in names if "totals" in k]
        assert len(hits) == 1 and want in hits[0] and \
            "SegSumSpec" in hits[0], (ops[0].dtype, lay, network, names)


def test_cuda_ssm_backward_runs_kernels(cuda_device):
    from repro_torch.kernels.ssm_scan import ops as ssm_ops

    rng = np.random.default_rng(17)
    a, b = _spec_operands(rng, "affine", (2, 1500, 64), torch.float32)
    g = torch.from_numpy(rng.standard_normal((2, 1500, 64)).astype(
        np.float32))
    grads = []
    for dev in (cuda_device, torch.device("cpu")):
        ta = a.to(dev).requires_grad_()
        tb = b.to(dev).requires_grad_()
        h = ssm_ops.ssm_scan(ta, tb, schedule="fused", block_t=128)
        cuda.reset_launches()
        grads.append(torch.autograd.grad(h, (ta, tb), g.to(dev)))
        if dev.type == "cuda":
            assert cuda.LAUNCHES["affine_fused"] == 1
    for x, y in zip(*grads):
        assert _same_bits(x.cpu(), y)


def test_cuda_fused_and_affine_refuse_cpu_and_bad_operands():
    x = torch.ones((2, 256))
    lay = scan_engine.Rows(2, 256, 1, 128)
    clay = scan_engine.Channels(1, 256, 32, 128, 32)
    a = torch.ones((1, 256, 32))
    before = dict(cuda.LAUNCHES)
    for call in (lambda: cuda.fused(monoids.SUM, (x,), lay),
                 lambda: cuda.fused(monoids.AFFINE, (a, a), clay),
                 lambda: cuda.carry(monoids.AFFINE, (a, a), clay),
                 lambda: cuda.chain(monoids.AFFINE, (a, a))):
        with pytest.raises(ValueError, match="CUDA tensors"):
            call()
    assert cuda.LAUNCHES == before
    assert cuda.channel_width(scan_engine.Channels(1, 1024, 458752, 256,
                                                   512)) == 16
    assert cuda.channel_width(scan_engine.Channels(1, 512, 48, 64, 16)) == 16
    assert cuda.channel_width(scan_engine.Channels(1, 8192, 40, 8192,
                                                   40)) == 1


def test_cuda_affine_refuses_unsupported(cuda_device):
    lay = scan_engine.Channels(1, 256, 32, 128, 32)
    a = torch.ones((1, 256, 32), device=cuda_device)
    with pytest.raises(TypeError, match="no CUDA scan kernel"):
        cuda.carry(monoids.AFFINE, (a.int(), a.int()), lay)
    with pytest.raises(ValueError, match="second operand"):
        cuda.carry(monoids.AFFINE, (a, a.half()), lay)
    big = scan_engine.Channels(1, 16384, 32, 16384, 32)
    ab = torch.ones((1, 16384, 32), device=cuda_device)
    with pytest.raises(ValueError, match="block 16384"):
        cuda.fused(monoids.AFFINE, (ab, ab), big)


# ---------------------------------------------------------------------------
# The attention fold kernels (csrc/attn_fold.cu)
# ---------------------------------------------------------------------------

ATTN_CASES = [
    # (name, B, Hkv, group, Tq, Tk, D, causal, window, softcap, bq, bk)
    ("causal_gqa2", 1, 2, 2, 256, 256, 32, True, None, None, 128, 128),
    ("window_cap", 1, 2, 4, 256, 256, 16, True, 96, 20.0, 128, 64),
    ("ragged_noncausal", 1, 1, 1, 200, 300, 16, False, None, None, 128,
     128),
    ("d256_softcap", 1, 2, 2, 256, 256, 256, True, 160, 50.0, 128, 128),
    ("decode_d128", 2, 2, 4, 1, 1000, 128, False, None, None, 128, 128),
    # bf16 reaches the tensor-core forms here (fold_dq_tc among them)
    ("d64_gqa2_window_cap", 1, 2, 2, 256, 256, 64, True, 64, 30.0, 128,
     128),
    ("d128_gqa4_bq64_ragged_cap", 1, 2, 4, 200, 300, 128, False, None, 20.0,
     64, 64),
    ("d256_gqa2_window_cap", 1, 1, 2, 256, 384, 256, True, 96, 50.0, 128,
     128),
]
# (atol, rtol) of the forward and of the gradients, per dtype
ATTN_TOL = {torch.float32: ((1e-5, 1e-5), (1e-4, 1e-4)),
            torch.bfloat16: ((1e-3, 2 ** -6), (1e-3, 2 ** -6))}


def _attn_inputs(case, dtype):
    name, B, Hkv, g, Tq, Tk, D = case[:7]
    rng = np.random.default_rng(sum(map(ord, name)))
    return tuple(torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(dtype) for s in ((B, Hkv * g, Tq, D),
                                         (B, Hkv, Tk, D), (B, Hkv, Tk, D),
                                         (B, Hkv * g, Tq, D)))


def _allclose(got, want, tol):
    atol, rtol = tol
    return torch.allclose(got.float().cpu(), want.float().cpu(), rtol=rtol,
                          atol=atol)


def test_fold_wrappers_refuse_cpu_and_unsupported_operands():
    """The fold wrappers never fall back: a CPU tensor, float16 or a head
    dim past 256 is refused before any build or launch."""
    spec = assoc.softmax_pair_kernel_spec(scale=0.25)
    lay = scan_engine.KVBlocks(bh=2, bh_kv=2, tq=128, tk=128, d=16, bq=128,
                               bk=128)
    x = torch.ones((2, 128, 16))
    before = dict(cuda_fold.LAUNCHES)
    for call in (lambda: cuda_fold.fold(spec, (x, x, x), lay),
                 lambda: cuda_fold.fold_totals(spec, (x, x, x), lay)):
        with pytest.raises(ValueError, match="CUDA tensors"):
            call()
    tot = tuple(torch.zeros(lay.chain_shape_for(i)) for i in range(3))
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_fold.chain(spec, tot, lay, (torch.float32,))
    with pytest.raises(NotImplementedError):
        cuda_fold.fold(monoids.SUM, (x,), lay)
    qb = scan_engine.QBlocks(bh=2, bh_kv=2, tq=128, tk=128, d=16, bq=128,
                             bk=128)
    with pytest.raises(ValueError, match="KVBlocks"):
        cuda_fold.fold(spec, (x,) * 7, qb)
    assert cuda_fold.LAUNCHES == before


def test_fold_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(cuda_fold, "_lib", None)
    monkeypatch.setattr(cuda_fold, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_fold.build()


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16), ids=str)
@pytest.mark.parametrize("schedule", ("carry", "decoupled"))
@pytest.mark.parametrize("case", ATTN_CASES, ids=[c[0] for c in ATTN_CASES])
def test_cuda_flash_attention_vs_plain(cuda_device, case, schedule, dtype):
    """Forward and gradients through the kernels (launch counts per
    schedule) against the plain versions on CPU copies."""
    q, k, v, go = _attn_inputs(case, dtype)
    _, _, _, _, _, _, D, causal, window, softcap, bq, bk = case
    kw = dict(scale=D ** -0.5, causal=causal, window=window,
              softcap=softcap, block_q=bq, block_k=bk, schedule=schedule)
    res = []
    for device in ("cpu", cuda_device):
        ts = [t.to(device).requires_grad_() for t in (q, k, v)]
        cuda_fold.reset_launches()
        out = fa_ops.flash_attention(*ts, **kw)
        grads = torch.autograd.grad(out, ts, go.to(device))
        res.append((out.detach(),) + grads)
    torch.cuda.synchronize()
    split = int(schedule == "decoupled")
    tbq, tbk, _ = fa_ops._tiles(q.shape[2], k.shape[2], bq, bk)
    want = dict.fromkeys(cuda_fold.KERNELS, 0)
    for kernel in ("fold_fwd", "fold_dq", "fold_dkv"):
        want[cuda_fold.fold_form(kernel, dtype, D, tbq, tbk)] += 1
    want.update(fold_chain=split, fold_chain_sum=2 * split)
    assert cuda_fold.LAUNCHES == want
    fwd_tol, grad_tol = ATTN_TOL[dtype]
    assert res[1][0].dtype == dtype and res[1][0].is_cuda
    assert _allclose(res[1][0], res[0][0], fwd_tol)
    for a, b in zip(res[1][1:], res[0][1:]):
        assert a.dtype == dtype
        assert _allclose(a, b, grad_tol)


@pytest.mark.parametrize("schedule", ("carry", "decoupled"))
def test_cuda_flash_attention_repeats_bitwise(cuda_device, schedule):
    """The float32 causal_gqa2 case, forward and gradients, 50 times on
    freshly allocated outputs whose memory held NaN: every repeat gives
    the first one's bits, within the 1e-5 / 1e-4 bars of the CPU plain
    version (an output element left unwritten, or a read of memory no one
    wrote, would show as other bits)."""
    q, k, v, go = _attn_inputs(ATTN_CASES[0], torch.float32)
    _, _, _, _, _, _, D, causal, window, softcap, bq, bk = ATTN_CASES[0]
    kw = dict(scale=D ** -0.5, causal=causal, window=window,
              softcap=softcap, block_q=bq, block_k=bk, schedule=schedule)

    def run(device):
        ts = [t.to(device).requires_grad_() for t in (q, k, v)]
        out = fa_ops.flash_attention(*ts, **kw)
        return (out.detach(),) + torch.autograd.grad(out, ts, go.to(device))

    want = run("cpu")
    first = None
    for _ in range(50):
        junk = [torch.full((n,), float("nan"), device=cuda_device)
                for n in (1 << 10, 1 << 13, 1 << 15, 1 << 18)
                for _ in range(8)]
        del junk
        got = [t.cpu() for t in run(cuda_device)]
        first = first or got
        for a, b in zip(got, first):
            assert _same_bits(a, b)
    for i, (a, b) in enumerate(zip(first, want)):
        assert _allclose(a, b, ATTN_TOL[torch.float32][int(i > 0)])


@pytest.mark.parametrize("schedule", ("carry", "decoupled"))
def test_cuda_fold_bitwise_invariants(cuda_device, schedule):
    """Bounds on and off, a page-permuted pool through kv_block_map and a
    repeated run give the same bits; count_cells equals the plain
    version's."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(cuda_device) for s in ((4, 256, 64), (2, 512, 64),
                                          (2, 512, 64)))
    kw = dict(group=2, scale=0.125, causal=True, window=96, kv_len=400,
              block_q=64, block_k=128, schedule=schedule)
    on = flash_attention_kernel(q, k, v, **kw)
    assert torch.equal(on, flash_attention_kernel(q, k, v, **kw))
    assert torch.equal(on, flash_attention_kernel(q, k, v,
                                                  use_kv_bounds=False, **kw))
    perm = torch.from_numpy(rng.permutation(4))
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(4)
    kp = k.view(2, 4, 128, 64)[:, inv.to(cuda_device)].reshape(2, 512, 64)
    vp = v.view(2, 4, 128, 64)[:, inv.to(cuda_device)].reshape(2, 512, 64)
    assert torch.equal(on, flash_attention_kernel(
        q, kp, vp, kv_block_map=perm.tolist(), **kw))
    out, m, l = flash_attention_kernel(q, k, v, return_stats=True, **kw)
    g = torch.from_numpy(rng.standard_normal((4, 256, 64)).astype(
        np.float32)).to(cuda_device)
    delta = (g * out).sum(-1, keepdim=True)
    bwd = dict(kw, kv_len=400)
    on_g = flash_attention_bwd_kernel(q, k, v, g, m, l, delta, **bwd)
    off_g = flash_attention_bwd_kernel(q, k, v, g, m, l, delta,
                                       use_kv_bounds=False, **bwd)
    for a, b in zip(on_g, off_g):
        assert torch.equal(a, b)
    if schedule == "carry":
        _, counts = flash_attention_kernel(q, k, v, count_cells=True, **kw)
        _, want = flash_attention_kernel(q.cpu(), k.cpu(), v.cpu(),
                                         count_cells=True, **kw)
        assert torch.equal(counts.cpu(), want)


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16), ids=str)
@pytest.mark.parametrize("spec_name", ("softmax_pair", "softmax_bwd_dq",
                                       "softmax_bwd_dkv"))
def test_cuda_fold_chain_vs_plain(cuda_device, spec_name, dtype):
    """The split pass and the chain of each spec against the plain
    versions (``fold_totals_plain``, ``fold_finalize_plain``) on the same
    inputs; each chain counted under its own kernel."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        backward_folds, forward_fold)
    from repro_torch.kernels.scan_engine import schedules
    case = ATTN_CASES[1]
    q, k, v, go = (t.to(cuda_device).to(dtype)
                   for t in _attn_inputs(case, torch.float32))
    _, _, _, g, _, _, D, causal, window, softcap, bq, bk = case
    q, k, v, go = (t.flatten(0, 1).contiguous() for t in (q, k, v, go))
    kw = dict(group=g, scale=D ** -0.5, causal=causal, window=window,
              softcap=softcap, block_q=bq, block_k=bk, schedule="decoupled")
    out, m, l = flash_attention_kernel(q, k, v, return_stats=True, **kw)
    delta = (go.float() * out.float()).sum(-1, keepdim=True)
    if spec_name == "softmax_pair":
        ops_ = (q, k, v)
        spec, lay = forward_fold(q.shape, k.shape, return_stats=True, **kw)
        out_dts = (dtype, torch.float32, torch.float32)
    else:
        ops_ = (q, k, v, go, m, l, delta)
        dq, dkv = backward_folds(q.shape, k.shape, **kw)
        spec, lay = dq if spec_name == "softmax_bwd_dq" else dkv
        out_dts = (dtype,) * len(lay.out_dims)
    assert lay.splits > 1
    tot = cuda_fold.fold_totals(spec, ops_, lay)
    want_tot = schedules.fold_totals_plain(tuple(t.cpu() for t in ops_),
                                           spec, lay)
    for a, b in zip(tot, want_tot):
        assert _allclose(a, b, ATTN_TOL[torch.float32][1])
    cuda_fold.reset_launches()
    got = cuda_fold.chain(spec, tot, lay, out_dts)
    torch.cuda.synchronize()
    kernel = "fold_chain" if spec_name == "softmax_pair" else "fold_chain_sum"
    assert cuda_fold.LAUNCHES[kernel] == 1
    assert sum(cuda_fold.LAUNCHES.values()) == 1
    want = schedules.fold_finalize_plain(spec, lay, tuple(
        t.cpu() for t in tot), out_dts)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert _allclose(a, b, ATTN_TOL[dtype][1])


def test_cuda_fold_fully_masked_rows(cuda_device):
    rng = np.random.default_rng(17)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 256, 16)).astype(
        np.float32)).to(cuda_device) for _ in range(3))
    kw = dict(scale=0.25, causal=True, window=32, kv_len=64, block_q=64,
              block_k=64)
    for schedule in ("carry", "decoupled"):
        out, m, l = flash_attention_kernel(q, k, v, return_stats=True,
                                           schedule=schedule, **kw)
        g = torch.zeros_like(out)
        g[:, 96:] = 1.0
        delta = (g * out).sum(-1, keepdim=True)
        grads = flash_attention_bwd_kernel(q, k, v, g, m, l, delta,
                                           schedule=schedule, **kw)
        assert not bool(out[:, 96:].any())
        for t in grads:
            assert bool(torch.isfinite(t).all()) and not bool(t.any())


def test_cuda_fold_refuses_float16(cuda_device):
    x = torch.ones((1, 2, 128, 32), dtype=torch.float16, device=cuda_device)
    with pytest.raises(TypeError, match="no CUDA fold kernel"):
        fa_ops.flash_attention(x, x, x)


# ---------------------------------------------------------------------------
# The tensor-core forms (csrc/attn_fold_tc.cu)
# ---------------------------------------------------------------------------

BF16_TOL = (1e-3, 2 ** -6)
TC_CASES = [
    # (name, Hkv, group, Tq, Tk, D, causal, window, kv_len, softcap, bq, bk)
    ("d64_bk64_causal", 2, 1, 256, 256, 64, True, None, None, None, 128,
     64),
    ("d128_gqa2_kv_tail", 2, 2, 256, 384, 128, True, None, 300, None, 128,
     128),
    ("d256_window_softcap", 1, 2, 256, 256, 256, True, 96, None, 50.0, 128,
     128),
    ("d128_gqa4_bq64_bk64_cap", 1, 4, 192, 256, 128, False, None, 250,
     30.0, 64, 64),
    ("d64_gqa2_window", 2, 2, 256, 256, 64, True, 64, None, None, 128, 128),
    ("d256_bk64_kv_tail", 1, 1, 128, 320, 256, True, None, 290, None, 128,
     64),
    # decode: the q rows of a GQA group packed into one 64-row tile
    ("decode_d128_gqa4", 2, 4, 8, 1024, 128, False, None, 1000, None, 8,
     128),
    ("decode_d256_gqa2_bq16", 1, 2, 16, 512, 256, False, None, 500, 50.0,
     16, 64),
    ("decode_d64_gqa8_two_tiles", 1, 8, 16, 256, 64, False, None, None,
     None, 16, 128),
]


def _tc_inputs(case):
    name, hkv, g, tq, tk, d = case[:6]
    rng = np.random.default_rng(sum(map(ord, name)))
    return tuple(torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(torch.bfloat16) for s in (
            (hkv * g, tq, d), (hkv, tk, d), (hkv, tk, d), (hkv * g, tq, d)))


def _tc_fold(spec, ops_, lay, schedule, out_dts):
    """The kernel's carry fold, or its split pass (held to the plain
    split pass) and chain."""
    from repro_torch.kernels.scan_engine import schedules
    if schedule == "carry":
        return cuda_fold.fold(spec, ops_, lay)[0]
    tot = cuda_fold.fold_totals(spec, ops_, lay)
    want = schedules.fold_totals_plain(tuple(t.cpu() for t in ops_), spec,
                                       lay)
    for a, b in zip(tot, want):
        assert _allclose(a, b, BF16_TOL)
    return cuda_fold.chain(spec, tot, lay, out_dts)


@pytest.mark.parametrize("schedule", ("carry", "decoupled"))
@pytest.mark.parametrize("case", TC_CASES, ids=[c[0] for c in TC_CASES])
def test_cuda_tc_folds_vs_plain(cuda_device, case, schedule):
    """fold_fwd_tc (and fold_dq_tc and fold_dkv_tc where the q block is
    one or two 64-row tiles) against the plain folds on the same bf16
    inputs, within atol 1e-3, rtol 2^-6; each launch counted under its
    form."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        backward_folds, forward_fold)
    from repro_torch.kernels.scan_engine import schedules
    name, hkv, g, tq, tk, d, causal, window, kv_len, cap, bq, bk = case
    q, k, v, do = _tc_inputs(case)
    kw = dict(group=g, scale=d ** -0.5, causal=causal, window=window,
              softcap=cap, kv_len=kv_len, block_q=bq, block_k=bk,
              schedule=schedule)
    spec, lay = forward_fold(q.shape, k.shape, return_stats=True, **kw)
    assert lay.splits > 1 or schedule == "carry"
    dts = (torch.bfloat16, torch.float32, torch.float32)
    cuda_fold.reset_launches()
    got = _tc_fold(spec, tuple(t.to(cuda_device) for t in (q, k, v)), lay,
                   schedule, dts)
    torch.cuda.synchronize()
    assert cuda_fold.LAUNCHES["fold_fwd_tc"] == 1
    assert cuda_fold.LAUNCHES["fold_fwd"] == 0
    want = schedules.fold_carry_plain((q, k, v), spec, lay)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert _allclose(a, b, BF16_TOL)
    out, m, l = want
    delta = (do.float() * out.float()).sum(-1, keepdim=True)
    ops_b = (q, k, v, do, m, l, delta)
    for kernel, (sp, ly) in zip(("fold_dq", "fold_dkv"),
                                backward_folds(q.shape, k.shape, **kw)):
        form = cuda_fold.fold_form(kernel, torch.bfloat16, d, bq, bk)
        assert (form == kernel + "_tc") == (bq >= 64)
        cuda_fold.reset_launches()
        got = _tc_fold(sp, tuple(t.to(cuda_device) for t in ops_b), ly,
                       schedule, (torch.bfloat16,) * len(ly.out_dims))
        torch.cuda.synchronize()
        assert cuda_fold.LAUNCHES[form] == 1
        for a, b in zip(got, schedules.fold_carry_plain(ops_b, sp, ly)):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert _allclose(a, b, BF16_TOL)


@pytest.mark.parametrize("schedule", ("carry", "decoupled"))
def test_cuda_tc_fold_bitwise_invariants(cuda_device, schedule):
    """The tensor-core forms give the same bits with bounds on and off,
    through a page-permuted pool (kv_block_map, also for a packed decode
    tile and for the dq fold) and on a repeated run, forward and
    backward; count_cells equals the plain version's."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        backward_folds)
    rng = np.random.default_rng(5)

    def bf16(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(torch.bfloat16).to(cuda_device)

    q, k, v = bf16(4, 256, 128), bf16(2, 512, 128), bf16(2, 512, 128)
    kw = dict(group=2, scale=128 ** -0.5, causal=True, window=96,
              kv_len=400, block_q=64, block_k=128, schedule=schedule)
    cuda_fold.reset_launches()
    on = flash_attention_kernel(q, k, v, **kw)
    assert cuda_fold.LAUNCHES["fold_fwd_tc"] == 1
    assert torch.equal(on, flash_attention_kernel(q, k, v, **kw))
    assert torch.equal(on, flash_attention_kernel(q, k, v,
                                                  use_kv_bounds=False, **kw))
    perm = torch.from_numpy(rng.permutation(4))
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(4)

    def permuted(t, pages, rows):
        return t.view(t.shape[0], pages, rows, t.shape[2])[
            :, inv.to(cuda_device)].reshape(t.shape)

    assert torch.equal(on, flash_attention_kernel(
        q, permuted(k, 4, 128), permuted(v, 4, 128),
        kv_block_map=perm.tolist(), **kw))
    out, m, l = flash_attention_kernel(q, k, v, return_stats=True, **kw)
    g = bf16(4, 256, 128)
    delta = (g.float() * out.float()).sum(-1, keepdim=True)
    cuda_fold.reset_launches()
    on_g = flash_attention_bwd_kernel(q, k, v, g, m, l, delta, **kw)
    assert cuda_fold.LAUNCHES["fold_dkv_tc"] == 1
    assert cuda_fold.LAUNCHES["fold_dq_tc"] == 1
    assert cuda_fold.LAUNCHES["fold_dq"] == 0
    off_g = flash_attention_bwd_kernel(q, k, v, g, m, l, delta,
                                       use_kv_bounds=False, **kw)
    again = flash_attention_bwd_kernel(q, k, v, g, m, l, delta, **kw)
    for a, b, c in zip(on_g, off_g, again):
        assert torch.equal(a, b) and torch.equal(a, c)
    # the dq fold through a page-permuted pool (its KVBlocks layout takes
    # kv_block_map as the forward's does)
    (sq, lq), _ = backward_folds(q.shape, k.shape, **kw)
    lq_p = dataclasses.replace(lq, kv_block_map=perm.to(torch.int32).to(
        cuda_device))
    ops_b = (q, k, v, g, m, l, delta)
    ops_p = (q, permuted(k, 4, 128), permuted(v, 4, 128), g, m, l, delta)
    cuda_fold.reset_launches()
    if schedule == "carry":
        dq_p = cuda_fold.fold(sq, ops_p, lq_p)[0][0]
        assert torch.equal(dq_p, cuda_fold.fold(sq, ops_b, lq)[0][0])
    else:
        tot_p = cuda_fold.fold_totals(sq, ops_p, lq_p)
        assert torch.equal(tot_p[0], cuda_fold.fold_totals(sq, ops_b, lq)[0])
    assert cuda_fold.LAUNCHES["fold_dq_tc"] == 2
    assert torch.equal(on_g[0], flash_attention_bwd_kernel(
        q, k, v, g, m, l, delta, **kw)[0])
    if schedule == "carry":
        _, counts = flash_attention_kernel(q, k, v, count_cells=True, **kw)
        _, want = flash_attention_kernel(q.cpu(), k.cpu(), v.cpu(),
                                         count_cells=True, **kw)
        assert torch.equal(counts.cpu(), want)
    # decode: four heads' rows packed into one tile, a permuted cache
    qd, kd, vd = bf16(8, 8, 128), bf16(2, 1024, 128), bf16(2, 1024, 128)
    perm = torch.from_numpy(rng.permutation(8))
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(8)
    dk = dict(group=4, scale=128 ** -0.5, causal=False, kv_len=1000,
              block_q=8, block_k=128, schedule=schedule)
    cuda_fold.reset_launches()
    od = flash_attention_kernel(qd, kd, vd, **dk)
    assert cuda_fold.LAUNCHES["fold_fwd_tc"] == 1
    assert torch.equal(od, flash_attention_kernel(
        qd, permuted(kd, 8, 128), permuted(vd, 8, 128),
        kv_block_map=perm.tolist(), **dk))


def test_cuda_tc_fully_masked_rows(cuda_device):
    """Rows past kv_len + window: output exactly 0 and zero gradients
    from the tensor-core forms, under both schedules."""
    rng = np.random.default_rng(23)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 256, 64)).astype(
        np.float32)).to(torch.bfloat16).to(cuda_device) for _ in range(3))
    kw = dict(scale=0.125, causal=True, window=32, kv_len=64, block_q=64,
              block_k=64)
    for schedule in ("carry", "decoupled"):
        cuda_fold.reset_launches()
        out, m, l = flash_attention_kernel(q, k, v, return_stats=True,
                                           schedule=schedule, **kw)
        g = torch.zeros_like(out)
        g[:, 96:] = 1.0
        delta = (g.float() * out.float()).sum(-1, keepdim=True)
        grads = flash_attention_bwd_kernel(q, k, v, g, m, l, delta,
                                           schedule=schedule, **kw)
        assert cuda_fold.LAUNCHES["fold_fwd_tc"] == 1
        assert cuda_fold.LAUNCHES["fold_dq_tc"] == 1
        assert cuda_fold.LAUNCHES["fold_dkv_tc"] == 1
        assert not bool(out[:, 96:].any()) and bool(out[:, :96].any())
        for t in grads:
            assert bool(torch.isfinite(t).all()) and not bool(t.any())


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16), ids=str)
def test_cuda_fold_forms_by_dtype(cuda_device, dtype):
    """float32 runs the 3xTF32 forward, dq and dk/dv forms, bfloat16 the
    bf16 tensor-core forms, at the same d = 128 shape; no SIMT kernel
    runs; float16 is refused."""
    x = torch.ones((1, 2, 256, 128), dtype=dtype, device=cuda_device)
    cuda_fold.reset_launches()
    out = fa_ops.flash_attention(*(t.requires_grad_() for t in
                                   (x.clone(), x.clone(), x.clone())))
    out.sum().backward()
    torch.cuda.synchronize()
    tc = dtype == torch.bfloat16
    assert cuda_fold.LAUNCHES["fold_fwd_tc"] == int(tc)
    assert cuda_fold.LAUNCHES["fold_dkv_tc"] == int(tc)
    assert cuda_fold.LAUNCHES["fold_dq_tc"] == int(tc)
    assert cuda_fold.LAUNCHES["fold_fwd_tf32"] == int(not tc)
    assert cuda_fold.LAUNCHES["fold_fwd"] == 0
    assert cuda_fold.LAUNCHES["fold_dkv_tf32"] == int(not tc)
    assert cuda_fold.LAUNCHES["fold_dkv"] == 0
    assert cuda_fold.LAUNCHES["fold_dq_tf32"] == int(not tc)
    assert cuda_fold.LAUNCHES["fold_dq"] == 0
    with pytest.raises(TypeError, match="no CUDA fold kernel"):
        fa_ops.flash_attention(x.half(), x.half(), x.half())


# ---------------------------------------------------------------------------
# fold_dq_tf32, fold_dkv_tf32: float32 dq and dk/dv on the tensor cores
# (csrc/attn_fold_tc.cu)
# ---------------------------------------------------------------------------

TF32_CASES = [
    # (name, Hkv, group, Tq, Tk, D, causal, window, kv_len, softcap, bq, bk)
    ("d128_gqa4_causal", 2, 4, 512, 512, 128, True, None, None, None, 128,
     128),
    ("d128_bq64_bk64_window_cap", 2, 2, 384, 384, 128, True, 96, None, 30.0,
     64, 64),
    ("d128_noncausal_kv_tail", 1, 2, 256, 384, 128, False, None, 300, None,
     128, 128),
    ("d64_gqa3_bk64_window", 1, 3, 256, 256, 64, True, 64, None, None, 128,
     64),
    ("d64_bq64_cap_kv_tail", 2, 1, 192, 384, 64, True, None, 290, 50.0, 64,
     128),
    # d = 256: dk / dv streams a chunk in eight stages and accumulates
    # without a cell element; dq's k and v in eight stages a kv tile and
    # two dqᵀ tiles a warpgroup
    ("d256_gqa2_causal_cap", 1, 2, 256, 256, 256, True, None, None, 50.0,
     128, 128),
    ("d256_bq64_bk64_window_kv_tail", 2, 1, 192, 320, 256, True, 96, 290,
     None, 64, 64),
]


def _tf32_inputs(case):
    """(q, k, v, dO, m, l, delta) in float32 on the card, the statistics
    from the forward kernel, and the keywords of the case."""
    name, hkv, g, tq, tk, d, causal, window, kv_len, softcap, bq, bk = case
    rng = np.random.default_rng(sum(map(ord, name)))
    q, k, v, go = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).cuda() for s in ((hkv * g, tq, d), (hkv, tk, d),
                                      (hkv, tk, d), (hkv * g, tq, d)))
    kw = dict(group=g, scale=d ** -0.5, causal=causal, window=window,
              kv_len=kv_len, softcap=softcap, block_q=bq, block_k=bk)
    out, m, l = flash_attention_kernel(q, k, v, return_stats=True, **kw)
    delta = (go * out).sum(-1, keepdim=True)
    return (q, k, v, go, m, l, delta), kw


def _tf32_vs_plain(kernel, case, schedule):
    """The 3xTF32 form of ``kernel`` ("fold_dq" or "fold_dkv") against the
    plain fold on CPU copies of the same float32 inputs, within the
    reference tests' gradient bar, one launch and none of the SIMT
    kernel: the carry fold, or the split pass (held to the plain split
    pass) and its chain."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        backward_folds)
    from repro_torch.kernels.scan_engine import schedules
    ops_, kw = _tf32_inputs(case)
    form = kernel + "_tf32"
    assert cuda_fold.fold_form(kernel, torch.float32, case[5], case[10],
                               case[11]) == form
    shapes = (ops_[0].shape, ops_[1].shape)
    folds = backward_folds(*shapes, schedule=schedule, **kw)
    spec, lay = folds[kernel == "fold_dkv"]
    cpu = tuple(t.cpu() for t in ops_)
    grad_tol = ATTN_TOL[torch.float32][1]
    out_dts = (torch.float32,) * len(lay.out_dims)
    cuda_fold.reset_launches()
    if schedule == "carry":
        got = cuda_fold.fold(spec, ops_, lay)[0]
        want = schedules.fold_carry_plain(cpu, spec, lay)
    else:
        tot = cuda_fold.fold_totals(spec, ops_, lay)
        w_tot = schedules.fold_totals_plain(cpu, spec, lay)
        for a, b in zip(tot, w_tot):
            assert _allclose(a, b, grad_tol)
        got = cuda_fold.chain(spec, tot, lay, out_dts)
        want = schedules.fold_finalize_plain(spec, lay, w_tot, out_dts)
    torch.cuda.synchronize()
    assert cuda_fold.LAUNCHES[form] == 1
    assert cuda_fold.LAUNCHES[kernel] == 0
    assert len(got) == len(want) == len(out_dts)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        assert _allclose(a, b, grad_tol), (a.cpu() - b).abs().max().item()


@pytest.mark.parametrize("schedule", ("carry", "decoupled"))
@pytest.mark.parametrize("case", TF32_CASES, ids=[c[0] for c in TF32_CASES])
def test_cuda_tf32_dkv_vs_plain(cuda_device, case, schedule):
    """fold_dkv_tf32 (the float32 dk/dv fold at d 64, 128 and 256, bq and
    bk 64 or 128) against the plain fold within the reference tests'
    gradient bar (atol 1e-4, rtol 1e-4), under the carry fold and the
    split pass."""
    _tf32_vs_plain("fold_dkv", case, schedule)


@pytest.mark.parametrize("schedule", ("carry", "decoupled"))
@pytest.mark.parametrize("case", TF32_CASES, ids=[c[0] for c in TF32_CASES])
def test_cuda_tf32_dq_vs_plain(cuda_device, case, schedule):
    """fold_dq_tf32 (the float32 dq fold at d 64, 128 and 256, bq and bk
    64 or 128) against the plain fold within the same bar, under the
    carry fold and the split pass."""
    _tf32_vs_plain("fold_dq", case, schedule)


@pytest.mark.parametrize("schedule", ("carry", "decoupled"))
def test_cuda_tf32_dkv_bitwise_invariants(cuda_device, schedule):
    """fold_dkv_tf32 with bounds on and off, and repeated on outputs whose
    memory held NaN, gives the same bits (the backward takes no page map:
    ``kv_block_map`` is the forward's), and its cell counts are the
    plain fold's."""
    ops_, kw = _tf32_inputs(TF32_CASES[1])
    kw = dict(kw, schedule=schedule)
    cuda_fold.reset_launches()
    on = flash_attention_bwd_kernel(*ops_, **kw)
    assert cuda_fold.LAUNCHES["fold_dkv_tf32"] == 1
    off = flash_attention_bwd_kernel(*ops_, use_kv_bounds=False, **kw)
    for _ in range(10):
        junk = [torch.full((n,), float("nan"), device=cuda_device)
                for n in (1 << 12, 1 << 16, 1 << 20) for _ in range(4)]
        del junk
        again = flash_attention_bwd_kernel(*ops_, **kw)
        for a, b in zip(on, again):
            assert _same_bits(a, b)
    for a, b in zip(on, off):
        assert _same_bits(a, b)


def test_cuda_tf32_dkv_against_simt(cuda_device):
    """At one shape the 3xTF32 form and the SIMT kernel (launched by name)
    agree within the float32 gradient bar, and each counts its own
    launch."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        backward_folds)
    ops_, kw = _tf32_inputs(TF32_CASES[0])
    _, (spec, lay) = backward_folds(ops_[0].shape, ops_[1].shape, **kw)
    cuda_fold.reset_launches()
    tf32 = cuda_fold.fold(spec, ops_, lay)[0]
    simt = cuda_fold.fold(spec, ops_, lay, form="fold_dkv")[0]
    assert cuda_fold.LAUNCHES["fold_dkv_tf32"] == 1
    assert cuda_fold.LAUNCHES["fold_dkv"] == 1
    for a, b in zip(tf32, simt):
        assert _allclose(a, b, ATTN_TOL[torch.float32][1])
    with pytest.raises(TypeError, match="does not take"):
        cuda_fold.fold(spec, ops_, lay, form="fold_dkv_tc")


# one case of each head dim: d 64, 128 and 256
TF32_BY_D = [TF32_CASES[3], TF32_CASES[1], TF32_CASES[6]]


@pytest.mark.parametrize("schedule", ("carry", "decoupled"))
@pytest.mark.parametrize("case", TF32_BY_D, ids=[c[0] for c in TF32_BY_D])
def test_cuda_tf32_bitwise_invariants_by_d(cuda_device, case, schedule):
    """fold_dq_tf32 and fold_dkv_tf32 give the same bits with bounds on
    and off and on repeats over outputs whose memory held NaN, and the dq
    fold through a page-permuted pool (kv_block_map) gives the contiguous
    pool's bits, at each head dim."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        backward_folds)
    ops_, kw = _tf32_inputs(case)
    kw = dict(kw, schedule=schedule)
    cuda_fold.reset_launches()
    on = flash_attention_bwd_kernel(*ops_, **kw)
    assert cuda_fold.LAUNCHES["fold_dq_tf32"] == 1
    assert cuda_fold.LAUNCHES["fold_dkv_tf32"] == 1
    assert cuda_fold.LAUNCHES["fold_dq"] == cuda_fold.LAUNCHES["fold_dkv"] == 0
    off = flash_attention_bwd_kernel(*ops_, use_kv_bounds=False, **kw)
    for a, b in zip(on, off):
        assert _same_bits(a, b)
    for _ in range(3):
        junk = [torch.full((n,), float("nan"), device=cuda_device)
                for n in (1 << 12, 1 << 16, 1 << 20) for _ in range(4)]
        del junk
        again = flash_attention_bwd_kernel(*ops_, **kw)
        for a, b in zip(on, again):
            assert _same_bits(a, b)
    q, k, v = ops_[:3]
    bk = kw["block_k"]
    pages = k.shape[1] // bk
    rng = np.random.default_rng(pages)
    perm = torch.from_numpy(rng.permutation(pages))
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(pages)

    def permuted(t):
        return t.view(t.shape[0], pages, bk, t.shape[2])[
            :, inv.to(cuda_device)].reshape(t.shape)

    (sq, lq), _ = backward_folds(q.shape, k.shape, **kw)
    lq_p = dataclasses.replace(lq, kv_block_map=perm.to(torch.int32).to(
        cuda_device))
    ops_p = (q, permuted(k), permuted(v)) + tuple(ops_[3:])
    if schedule == "carry":
        assert _same_bits(cuda_fold.fold(sq, ops_p, lq_p)[0][0],
                          cuda_fold.fold(sq, ops_, lq)[0][0])
    else:
        assert _same_bits(cuda_fold.fold_totals(sq, ops_p, lq_p)[0],
                          cuda_fold.fold_totals(sq, ops_, lq)[0])


TF32_VS_SIMT = [("fold_dq", c) for c in TF32_BY_D] + [
    ("fold_dkv", TF32_BY_D[2])]


@pytest.mark.parametrize("kernel,case", TF32_VS_SIMT,
                         ids=[f"{k}-{c[0]}" for k, c in TF32_VS_SIMT])
def test_cuda_tf32_against_simt_by_d(cuda_device, kernel, case):
    """The 3xTF32 form and the SIMT kernel launched by name agree within
    the float32 gradient bar, each counting its own launch: dq at d 64,
    128 and 256, dk/dv at d 256."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        backward_folds)
    ops_, kw = _tf32_inputs(case)
    folds = backward_folds(ops_[0].shape, ops_[1].shape, **kw)
    spec, lay = folds[kernel == "fold_dkv"]
    cuda_fold.reset_launches()
    tf32 = cuda_fold.fold(spec, ops_, lay)[0]
    simt = cuda_fold.fold(spec, ops_, lay, form=kernel)[0]
    assert cuda_fold.LAUNCHES[kernel + "_tf32"] == 1
    assert cuda_fold.LAUNCHES[kernel] == 1
    for a, b in zip(tf32, simt):
        assert _allclose(a, b, ATTN_TOL[torch.float32][1])
    with pytest.raises(TypeError, match="does not take"):
        cuda_fold.fold(spec, ops_, lay, form=kernel + "_tc")


def _tf32_fwd_inputs(case):
    """(q, k, v) in float32 on the card and the forward's keywords of a
    ``TF32_CASES`` case."""
    name, hkv, g, tq, tk, d, causal, window, kv_len, softcap, bq, bk = case
    rng = np.random.default_rng(sum(map(ord, name)) + 3)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).cuda() for s in ((hkv * g, tq, d), (hkv, tk, d),
                                      (hkv, tk, d)))
    kw = dict(group=g, scale=d ** -0.5, causal=causal, window=window,
              kv_len=kv_len, softcap=softcap, block_q=bq, block_k=bk)
    return (q, k, v), kw


@pytest.mark.parametrize("schedule", ("carry", "decoupled"))
@pytest.mark.parametrize("case", TF32_CASES, ids=[c[0] for c in TF32_CASES])
def test_cuda_tf32_fwd_vs_plain(cuda_device, case, schedule):
    """fold_fwd_tf32 (the float32 forward fold at d 64, 128 and 256, bq
    and bk 64 or 128) against the plain fold on CPU copies of the same
    inputs within the reference tests' forward bar (atol 1e-5, rtol
    1e-5): out, m and l under the carry fold, and the split pass with its
    chain against the plain decoupled fold, the chunks' (m, l) against
    the plain split pass; one launch and none of the SIMT forward. (The
    chunks' acc, unnormalized and relative to each chunk's max, is held to
    a float64 statement below: against the plain float32 products it
    would measure their rounding as well.)"""
    from repro_torch.kernels.flash_attention.flash_attention import (
        forward_fold)
    from repro_torch.kernels.scan_engine import schedules
    ops_, kw = _tf32_fwd_inputs(case)
    assert cuda_fold.fold_form("fold_fwd", torch.float32, case[5], case[10],
                               case[11]) == "fold_fwd_tf32"
    spec, lay = forward_fold(ops_[0].shape, ops_[1].shape, schedule=schedule,
                             return_stats=True, **kw)
    cpu = tuple(t.cpu() for t in ops_)
    fwd_tol = ATTN_TOL[torch.float32][0]
    out_dts = (torch.float32,) * 3
    cuda_fold.reset_launches()
    if schedule == "carry":
        got = cuda_fold.fold(spec, ops_, lay)[0]
        want = schedules.fold_carry_plain(cpu, spec, lay)
    else:
        tot = cuda_fold.fold_totals(spec, ops_, lay)
        w_tot = schedules.fold_totals_plain(cpu, spec, lay)
        for a, b in zip(tot[:2], w_tot[:2]):
            assert _allclose(a, b, fwd_tol)
        got = cuda_fold.chain(spec, tot, lay, out_dts)
        want = schedules.fold_finalize_plain(spec, lay, w_tot, out_dts)
    torch.cuda.synchronize()
    assert cuda_fold.LAUNCHES["fold_fwd_tf32"] == 1
    assert cuda_fold.LAUNCHES["fold_fwd"] == 0
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and bool(torch.isfinite(a).all())
        assert _allclose(a, b, fwd_tol), (a.cpu() - b).abs().max().item()


@pytest.mark.parametrize("schedule", ("carry", "decoupled"))
@pytest.mark.parametrize("case", TF32_BY_D, ids=[c[0] for c in TF32_BY_D])
def test_cuda_tf32_fwd_bitwise_invariants_by_d(cuda_device, case, schedule):
    """fold_fwd_tf32 gives the same bits (out, m, l) with bounds on and
    off, on repeats over outputs whose memory held NaN, and through a
    page-permuted pool (kv_block_map), at each head dim; its cell counts
    are the plain fold's."""
    (q, k, v), kw = _tf32_fwd_inputs(case)
    kw = dict(kw, schedule=schedule)
    cuda_fold.reset_launches()
    on = flash_attention_kernel(q, k, v, return_stats=True, **kw)
    assert cuda_fold.LAUNCHES["fold_fwd_tf32"] == 1
    assert cuda_fold.LAUNCHES["fold_fwd"] == 0
    off = flash_attention_kernel(q, k, v, return_stats=True,
                                 use_kv_bounds=False, **kw)
    for a, b in zip(on, off):
        assert _same_bits(a, b)
    for _ in range(3):
        junk = [torch.full((n,), float("nan"), device=cuda_device)
                for n in (1 << 12, 1 << 16, 1 << 20) for _ in range(4)]
        del junk
        again = flash_attention_kernel(q, k, v, return_stats=True, **kw)
        for a, b in zip(on, again):
            assert _same_bits(a, b)
    bk = kw["block_k"]
    pages = k.shape[1] // bk
    rng = np.random.default_rng(pages + 1)
    perm = torch.from_numpy(rng.permutation(pages))
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(pages)

    def permuted(t):
        return t.view(t.shape[0], pages, bk, t.shape[2])[
            :, inv.to(cuda_device)].reshape(t.shape)

    paged = flash_attention_kernel(q, permuted(k), permuted(v),
                                   kv_block_map=perm.tolist(),
                                   return_stats=True, **kw)
    for a, b in zip(on, paged):
        assert _same_bits(a, b)
    if schedule == "carry":
        _, counts = flash_attention_kernel(q, k, v, count_cells=True, **kw)
        _, want = flash_attention_kernel(q.cpu(), k.cpu(), v.cpu(),
                                         count_cells=True, **kw)
        assert torch.equal(counts.cpu(), want)


@pytest.mark.parametrize("case", TF32_BY_D, ids=[c[0] for c in TF32_BY_D])
def test_cuda_tf32_fwd_against_simt_by_d(cuda_device, case):
    """fold_fwd_tf32 and the SIMT forward launched by name agree within
    the float32 forward bar (out, m, l), each counting its own launch, at
    d 64, 128 and 256; the bf16 form refuses float32 operands."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        forward_fold)
    ops_, kw = _tf32_fwd_inputs(case)
    spec, lay = forward_fold(ops_[0].shape, ops_[1].shape, return_stats=True,
                             **kw)
    cuda_fold.reset_launches()
    tf32 = cuda_fold.fold(spec, ops_, lay)[0]
    simt = cuda_fold.fold(spec, ops_, lay, form="fold_fwd")[0]
    assert cuda_fold.LAUNCHES["fold_fwd_tf32"] == 1
    assert cuda_fold.LAUNCHES["fold_fwd"] == 1
    for a, b in zip(tf32, simt):
        assert _allclose(a, b, ATTN_TOL[torch.float32][0])
    with pytest.raises(TypeError, match="does not take"):
        cuda_fold.fold(spec, ops_, lay, form="fold_fwd_tc")


@pytest.mark.parametrize("case", TF32_CASES, ids=[c[0] for c in TF32_CASES])
def test_cuda_tf32_fwd_split_payload_vs_float64(cuda_device, case):
    """fold_fwd_tf32's split pass publishes each chunk's (m, l, acc)
    within the forward bar (atol 1e-5, rtol 1e-5) of the same payload in
    float64, acc included."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        forward_fold)
    ops_, kw = _tf32_fwd_inputs(case)
    spec, lay = forward_fold(ops_[0].shape, ops_[1].shape,
                             schedule="decoupled", return_stats=True, **kw)
    cuda_fold.reset_launches()
    tot = cuda_fold.fold_totals(spec, ops_, lay)
    torch.cuda.synchronize()
    assert cuda_fold.LAUNCHES["fold_fwd_tf32"] == 1
    want = fa_ref.split_payload_ref(*(t.cpu().double() for t in ops_), spec,
                                    lay)
    for a, b in zip(tot, want):
        assert _allclose(a.double(), b, ATTN_TOL[torch.float32][0]), \
            (a.cpu().double() - b).abs().max().item()


# The two chains rebuilt for the card: the affine pair's chain on
# Channels (chain_chan_kernel: a thread a channel, each group of four
# chunks' loads issued before the group is folded and stored) and the
# softmax pair's split-KV chain with its finalize
# (fold_chain_softmax_kernel: a warp a row, four columns a lane where d
# and the bases allow, the weights once a row). Each is held bitwise
# against its plain version run on the card and against a torch
# transcript of its first form's loop (chunk by chunk; a thread a (row,
# column)), whose bits it keeps.

# (name, (B, chunks, D), base one element off, running totals): one, four,
# nine and seventeen chunks (groups of four: a ragged one, one full, two
# full and a ragged one, four full and one more)
AFFINE_CHAIN_CASES = [
    ("ssd_like", (1, 4, 4096), False, False),
    ("d_not_4", (2, 9, 30), False, True),
    ("d7_one_chunk", (3, 1, 7), False, True),
    ("nine_chunks", (2, 9, 1024), False, True),
    ("seventeen_chunks_off", (1, 17, 512), True, True),
    ("one_chunk_off", (2, 1, 64), True, False),
]


def _affine_chain_first_form(a, b):
    """The chain's first form, a thread a (batch, channel): offsets[c] =
    acc, then acc = acc ⊕ totals[c] (a1 a2, a2 b1 + b2) from (1, 0), chunk
    by chunk; running[c] = acc."""
    acc_a, acc_b = torch.ones_like(a[:, 0]), torch.zeros_like(b[:, 0])
    oa, ob, ra, rb = (torch.empty_like(a) for _ in range(4))
    for c in range(a.shape[1]):
        oa[:, c], ob[:, c] = acc_a, acc_b
        acc_a, acc_b = acc_a * a[:, c], a[:, c] * acc_b + b[:, c]
        ra[:, c], rb[:, c] = acc_a, acc_b
    return (oa, ob), (ra, rb)


@pytest.mark.parametrize("case", AFFINE_CHAIN_CASES,
                         ids=[c[0] for c in AFFINE_CHAIN_CASES])
def test_cuda_affine_chain_channels_bitwise(cuda_device, case):
    """chain_chan_kernel against ``exclusive_chain`` on the card and the
    first form's loop, offsets and running totals bitwise, one launch,
    the same bits again; zeros, signed zeros and subnormals among the
    totals."""
    name, shape, off, with_running = case
    rng = np.random.default_rng(sum(map(ord, name)))
    a = rng.uniform(0.5, 1.5, shape).astype(np.float32)
    b = rng.standard_normal(shape).astype(np.float32)
    a.flat[::13] = 0.0
    b.flat[::7] = -0.0
    b.flat[::11] = 1e-39
    tot = []
    for v in (a, b):
        t = torch.from_numpy(v).to(cuda_device)
        if off:   # a base one element past the allocation's alignment
            t = torch.empty(t.numel() + 1, device=cuda_device)[1:].view(
                shape).copy_(t)
        tot.append(t)
    tot = tuple(tot)
    cuda.reset_launches()
    offs, run = cuda.chain(monoids.AFFINE, tot, with_running)
    torch.cuda.synchronize()
    assert cuda.LAUNCHES["affine_chain"] == 1
    assert sum(cuda.LAUNCHES.values()) == 1
    plain = scan_engine.schedules.exclusive_chain(monoids.AFFINE, tot)
    first, first_run = _affine_chain_first_form(*tot)
    for x, y, z in zip(offs, plain, first):
        assert _same_bits(x, y) and _same_bits(x, z), name
    if with_running:
        for x, y, z in zip(run, monoids.AFFINE.combine(plain, tot),
                           first_run):
            assert _same_bits(x, y) and _same_bits(x, z), name
    again, _ = cuda.chain(monoids.AFFINE, tot)
    for x, y in zip(offs, again):
        assert _same_bits(x, y), name


# (name, row blocks, bq, d, splits, output dtype, statistics)
FOLD_CHAIN_CASES = [
    ("decode_d128", 20, 8, 128, 16, torch.bfloat16, False),
    ("d256_f32_stats", 6, 16, 256, 16, torch.float32, True),
    ("d7_three_splits", 5, 8, 7, 3, torch.float32, True),
    ("d130_seventeen", 4, 8, 130, 17, torch.bfloat16, True),
    ("d36_one_split", 7, 8, 36, 1, torch.float32, False),
    ("d64_seventeen_bf16", 3, 16, 64, 17, torch.bfloat16, True),
    ("d100_nine", 4, 8, 100, 9, torch.float32, True),
]


def _softmax_chain_first_form(m2, l2, a2, lay, out_dts):
    """The chain's first form, a thread a (row, column): from (NEG_INF, 0,
    0), mn = max(m, m2), the weights exp(m - mn) and exp(m2 - mn), l and
    acc folded with them split by split, then acc / l (l == 0 guarded)
    and the row's (m, l)."""
    m = torch.full_like(m2[:, 0], assoc.NEG_INF)
    l, acc = torch.zeros_like(l2[:, 0]), torch.zeros_like(a2[:, 0])
    for s in range(m2.shape[1]):
        mn = torch.maximum(m, m2[:, s])
        a1, b1 = torch.exp(m - mn), torch.exp(m2[:, s] - mn)
        l = l * a1 + l2[:, s] * b1
        acc = acc * a1 + a2[:, s] * b1
        m = mn
    out = acc / torch.where(l == 0.0, 1.0, l)
    outs = (out, m, l)[:len(out_dts)]
    return tuple(lay.unchain_out(o).to(dt) for o, dt in zip(outs, out_dts))


@pytest.mark.parametrize("case", FOLD_CHAIN_CASES,
                         ids=[c[0] for c in FOLD_CHAIN_CASES])
def test_cuda_fold_chain_softmax_bitwise(cuda_device, case):
    """fold_chain_softmax_kernel against ``fold_finalize_plain`` on the
    card and the first form's loop, bitwise: outputs and statistics, one
    launch, the same bits again; masked chunks (NEG_INF, 0, 0) and fully
    masked rows among the partials, d a multiple of 4 or not, one to
    seventeen splits, and an output one element off 16-byte alignment."""
    name, blocks, bq, d, splits, out_dt, stats = case
    lay = scan_engine.KVBlocks(bh=blocks, bh_kv=blocks, tq=bq, tk=16 * splits,
                               d=d, bq=bq, bk=16, splits=splits,
                               out_dims=(d, 1, 1) if stats else None)
    spec = assoc.softmax_pair_kernel_spec(scale=0.25, with_stats=stats)
    rng = np.random.default_rng(sum(map(ord, name)))
    shp = lay.chain_shape_for(0)
    m2 = (4 * rng.standard_normal(shp)).astype(np.float32)
    l2 = rng.uniform(0.5, 3.0, shp).astype(np.float32)
    a2 = rng.standard_normal(lay.chain_shape_for(2)).astype(np.float32)
    masked = rng.random(shp[:3]) < 0.25
    masked[0] = True   # every chunk of row block 0 masked: l == 0, out 0
    m2[masked] = assoc.NEG_INF
    l2[masked] = 0.0
    a2[masked] = 0.0
    tot = tuple(torch.from_numpy(v).to(cuda_device) for v in (m2, l2, a2))
    out_dts = (out_dt, torch.float32, torch.float32) if stats else (out_dt,)
    cuda_fold.reset_launches()
    got = cuda_fold.chain(spec, tot, lay, out_dts)
    torch.cuda.synchronize()
    assert cuda_fold.LAUNCHES["fold_chain"] == 1
    assert sum(cuda_fold.LAUNCHES.values()) == 1
    plain = scan_engine.schedules.fold_finalize_plain(spec, lay, tot, out_dts)
    first = _softmax_chain_first_form(*tot, lay, out_dts)
    assert len(got) == len(plain) == len(out_dts)
    for x, y, z in zip(got, plain, first):
        assert _same_bits(x, y) and _same_bits(x, z), name
    assert not got[0][0].any()   # head 0: every chunk masked
    again = cuda_fold.chain(spec, tot, lay, out_dts)
    for x, y in zip(got, again):
        assert _same_bits(x, y), name


def test_cuda_fold_chain_softmax_unaligned_output(cuda_device, monkeypatch):
    """An output base off 16-byte alignment takes the one-column-a-lane
    form with the same bits as the aligned four-column one."""
    lay = scan_engine.KVBlocks(bh=4, bh_kv=4, tq=8, tk=64, d=128, bq=8,
                               bk=16, splits=4)
    spec = assoc.softmax_pair_kernel_spec(scale=0.25)
    rng = np.random.default_rng(27)
    tot = tuple(torch.from_numpy(rng.uniform(0.5, 2.0, lay.chain_shape_for(i))
                                 .astype(np.float32)).to(cuda_device)
                for i in range(3))
    (want,) = cuda_fold.chain(spec, tot, lay, (torch.float32,))
    real_empty = torch.empty

    def shifted(shape, **kw):   # the output one element past alignment
        n = int(np.prod(shape))
        return real_empty(n + 1, **kw)[1:].view(shape)
    monkeypatch.setattr(torch, "empty", shifted)
    (got,) = cuda_fold.chain(spec, tot, lay, (torch.float32,))
    monkeypatch.setattr(torch, "empty", real_empty)
    assert got.data_ptr() % 16 != 0
    assert _same_bits(got, want)
