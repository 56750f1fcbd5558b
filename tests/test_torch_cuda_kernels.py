"""The CUDA kernels of ``csrc/scan_sum.cu`` against their plain versions.

This file imports no JAX, so it runs on the machine with the card too:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda_kernels.py

Without a CUDA device the card tests skip (``cuda_device`` fixture) and
only the wrapper checks that need no card run. On the card every kernel
— sum, segmented sum and mask, under the four schedules — must be
bitwise equal to its plain PyTorch version (run here on CPU copies of
the same inputs), a gradient must launch the kernels, and the relational
operators' kernel routes must equal their CPU results.
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
