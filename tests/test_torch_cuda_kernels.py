"""The CUDA kernels of ``csrc/scan_sum.cu`` against their plain versions.

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
CPU results.
"""

import os

import numpy as np
import pytest
import torch

from repro_torch import relational as rel
from repro_torch.kernels import scan_engine
from repro_torch.kernels.compact import ops as kc_ops
from repro_torch.kernels.scan_blocked import ops
from repro_torch.kernels.scan_engine import cuda, monoids
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
