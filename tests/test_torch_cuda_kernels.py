"""The CUDA kernels of ``csrc/scan_sum.cu`` against their plain versions.

This file imports no JAX, so it runs on the machine with the card too:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda_kernels.py

Without a CUDA device the card tests skip (``cuda_device`` fixture) and
only the wrapper checks that need no card run. On the card every kernel
must be bitwise equal to its plain PyTorch version (run here on CPU
copies of the same inputs), and a gradient must launch the kernels.
"""

import os

import numpy as np
import pytest
import torch

from repro_torch.kernels import scan_engine
from repro_torch.kernels.scan_blocked import ops
from repro_torch.kernels.scan_engine import cuda

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
    lay = scan_engine.Rows(2, 256, 1, 128)
    before = dict(cuda.LAUNCHES)
    for call in (lambda: cuda.carry(x, lay, False),
                 lambda: cuda.totals(x, lay),
                 lambda: cuda.chain(torch.ones((2, 2))),
                 lambda: cuda.apply(x, torch.ones((2, 2)), lay, False),
                 lambda: cuda.tree(x, lay, False)):
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
    want = torch.flip(ops.cumsum(torch.flip(g, (1,)), schedule="decoupled"),
                      (1,))
    assert _same_bits(dx.cpu(), want)


def test_cuda_refuses_unsupported_dtype(cuda_device):
    x = torch.ones((2, 256), dtype=torch.float64, device=cuda_device)
    with pytest.raises(TypeError, match="no CUDA scan kernel"):
        ops.cumsum(x)
