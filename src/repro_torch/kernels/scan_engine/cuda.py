"""Build, bind and launch the sum-scan CUDA kernels (``csrc/scan_sum.cu``).

The kernels are compiled at first use with ``nvcc`` for ``sm_90a`` into
``build/`` at the repository root — a shared library with a plain C
interface, loaded with ``ctypes`` — and cached there under a hash of the
source and flags. A missing ``nvcc`` or a failed build raises with the
compiler's output.

Each wrapper below takes CUDA tensors only: it checks device, dtype, 2-D
contiguity and the ``Rows`` geometry, raises on anything the kernel does
not take, allocates the outputs with ``torch.empty``, launches on
PyTorch's current stream, raises if the launch returns an error, and
adds one to its entry of ``LAUNCHES``. The plain PyTorch version of each
kernel lives beside its schedule in ``schedules.py``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from repro_torch.core.scan.assoc import accum_dtype

_PKG = Path(__file__).resolve().parents[2]
SOURCE = _PKG / "csrc" / "scan_sum.cu"
BUILD_DIR = _PKG.parents[1] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Kernel launches since the last ``reset_launches()``, by kernel.
LAUNCHES = {"carry": 0, "totals": 0, "chain": 0, "apply": 0, "tree": 0}

# dtype codes of the C interface (see the dispatch in scan_sum.cu).
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
               torch.int32: 3, torch.int16: 4, torch.int8: 5}

# Longest tile: the tree kernel's (pow2 + copy) buffers of 16384 4-byte
# words take 128 KB of the 227 KB a block may use.
MAX_BLOCK_N = 16384

_lib = None
build_log = ""  # the compiler's output of the last build in this process


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the scan kernels are "
        f"compiled from {SOURCE} at first use on a machine with the CUDA "
        "toolkit")


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"scan_sum_{digest}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
            capture_output=True, text=True)
        build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (exit {proc.returncode}) on {SOURCE}:\n"
                f"{build_log}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    signatures = {
        "scan_sum_carry": (p, p, ll, ll, i, i, i, p),
        "scan_sum_totals": (p, p, ll, ll, i, i, p),
        "scan_sum_chain": (p, p, ll, ll, i, p),
        "scan_sum_apply": (p, p, p, ll, ll, i, i, i, p),
        "scan_sum_tree": (p, p, ll, ll, i, i, i, p),
    }
    for name, args in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.scan_sum_error_string.argtypes = (ctypes.c_int,)
    lib.scan_sum_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def _check(x: torch.Tensor, layout) -> None:
    if not x.is_cuda:
        raise ValueError(
            f"the CUDA scan kernels take CUDA tensors, got {x.device}")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(
            f"no CUDA scan kernel for {x.dtype}; supported: "
            f"{sorted(str(d) for d in DTYPE_CODES)}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError("the CUDA scan kernels take contiguous 2-D tensors, "
                         f"got shape {tuple(x.shape)} strides {x.stride()}")
    if tuple(x.shape) != layout.shape:
        raise ValueError(f"tensor shape {tuple(x.shape)} != layout "
                         f"{layout.shape}")
    if not 1 <= layout.bn <= MAX_BLOCK_N:
        raise ValueError(
            f"block_n {layout.bn} outside [1, {MAX_BLOCK_N}]")
    if layout.rows * layout.num_seq_blocks >= 2 ** 31:
        raise ValueError(f"{layout.rows} x {layout.num_seq_blocks} tiles "
                         "exceed one launch grid")


def _launch(name: str, fn, x: torch.Tensor, *args) -> None:
    with torch.cuda.device(x.device):
        err = fn(*args, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        msg = build().scan_sum_error_string(err).decode()
        raise RuntimeError(f"scan_sum_{name} launch failed: {msg} ({err})")
    LAUNCHES[name] += 1


def carry(x: torch.Tensor, layout, exclusive: bool) -> torch.Tensor:
    """Carry schedule: one block per row, running total in a register."""
    _check(x, layout)
    out = torch.empty_like(x)
    if x.numel():
        _launch("carry", build().scan_sum_carry, x, x.data_ptr(),
                out.data_ptr(), layout.rows, layout.n, layout.bn,
                int(exclusive), DTYPE_CODES[x.dtype])
    return out


def totals(x: torch.Tensor, layout) -> torch.Tensor:
    """Per-chunk totals (rows, chunks) in the accumulation dtype."""
    _check(x, layout)
    out = torch.empty(layout.chain_shape, dtype=accum_dtype(x.dtype),
                      device=x.device)
    if x.numel():
        _launch("totals", build().scan_sum_totals, x, x.data_ptr(),
                out.data_ptr(), layout.rows, layout.n, layout.bn,
                DTYPE_CODES[x.dtype])
    return out


def chain(totals: torch.Tensor) -> torch.Tensor:
    """Sequential exclusive chain over (rows, chunks) float32/int32
    totals, left to right from 0."""
    if not totals.is_cuda:
        raise ValueError(
            f"the CUDA scan kernels take CUDA tensors, got {totals.device}")
    if totals.dtype not in (torch.float32, torch.int32):
        raise TypeError(f"chain takes float32/int32 totals, got "
                        f"{totals.dtype}")
    if totals.dim() != 2 or not totals.is_contiguous():
        raise ValueError("chain takes contiguous 2-D totals")
    out = torch.empty_like(totals)
    if totals.numel():
        _launch("chain", build().scan_sum_chain, totals, totals.data_ptr(),
                out.data_ptr(), totals.shape[0], totals.shape[1],
                int(totals.dtype == torch.int32))
    return out


def apply(x: torch.Tensor, offsets: torch.Tensor, layout,
          exclusive: bool) -> torch.Tensor:
    """Rescan every (row, chunk) tile and add its chunk offset."""
    _check(x, layout)
    if (tuple(offsets.shape) != layout.chain_shape
            or offsets.dtype != accum_dtype(x.dtype)
            or offsets.device != x.device or not offsets.is_contiguous()):
        raise ValueError(
            f"offsets {tuple(offsets.shape)} {offsets.dtype} on "
            f"{offsets.device} do not match the chain "
            f"{layout.chain_shape} {accum_dtype(x.dtype)} on {x.device}")
    out = torch.empty_like(x)
    if x.numel():
        _launch("apply", build().scan_sum_apply, x, x.data_ptr(),
                offsets.data_ptr(), out.data_ptr(), layout.rows, layout.n,
                layout.bn, int(exclusive), DTYPE_CODES[x.dtype])
    return out


def tree(x: torch.Tensor, layout, exclusive: bool) -> torch.Tensor:
    """Tree schedule: carry's row walk, Blelloch sweep inside each tile."""
    _check(x, layout)
    out = torch.empty_like(x)
    if x.numel():
        _launch("tree", build().scan_sum_tree, x, x.data_ptr(),
                out.data_ptr(), layout.rows, layout.n, layout.bn,
                int(exclusive), DTYPE_CODES[x.dtype])
    return out
