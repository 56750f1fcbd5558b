"""Build, bind and launch the sum-family scan kernels (``csrc/scan_sum.cu``).

The kernels are compiled at first use with ``nvcc`` for ``sm_90a`` into
``build/`` at the repository root — a shared library with a plain C
interface, loaded with ``ctypes`` — and cached there under a hash of the
source and flags. A missing ``nvcc`` or a failed build raises with the
compiler's output.

One set of kernels (carry, totals, chain, apply, tree) is written once
over a spec and instantiated for the three specs with a CUDA kernel: the
sum, the segmented sum (values and int32 flags) and the compact mask
(int32 mask, int32 destinations). Each wrapper below takes the spec and
its operands as the engine passes them, checks device, dtype, 2-D
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

_PKG = Path(__file__).resolve().parents[2]
SOURCE = _PKG / "csrc" / "scan_sum.cu"
BUILD_DIR = _PKG.parents[1] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Spec codes of the C interface, by KernelSpec name.
SPEC_CODES = {"sum": 0, "segsum": 1, "mask": 2}
KERNELS = ("carry", "totals", "chain", "apply", "tree")


def kernel_name(spec_name: str, kernel: str) -> str:
    """The launch counter's key: ``carry`` for the sum, ``segsum_carry``
    and ``mask_carry`` for the others."""
    return kernel if spec_name == "sum" else f"{spec_name}_{kernel}"


# Kernel launches since the last ``reset_launches()``, by kernel.
LAUNCHES = {kernel_name(s, k): 0 for s in SPEC_CODES for k in KERNELS}

# dtype codes of the values (see the dispatch in scan_sum.cu).
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
               torch.int32: 3, torch.int16: 4, torch.int8: 5}

# Longest tile: the network's two buffers of 16384 (value, flag) pairs
# take 160 KB, the tree's of 16384 float32 words 128 KB, of the 227 KB a
# block may use.
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
        "scan_carry": (i, i, p, p, p, p, p, ll, ll, i, i, i, p),
        "scan_totals": (i, i, p, p, p, p, ll, ll, i, p),
        "scan_chain": (i, i, p, p, p, p, p, p, ll, ll, p),
        "scan_apply": (i, i, p, p, p, p, p, ll, ll, i, i, i, p),
        "scan_tree": (i, i, p, p, p, p, p, ll, ll, i, i, i, p),
    }
    for name, args in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.scan_error_string.argtypes = (ctypes.c_int,)
    lib.scan_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def _on_cuda(t: torch.Tensor) -> None:
    if not t.is_cuda:
        raise ValueError(
            f"the CUDA scan kernels take CUDA tensors, got {t.device}")


def _operands(spec, operands, layout):
    """(spec code, values, flags or None) after the checks."""
    if spec.name not in SPEC_CODES:
        raise NotImplementedError(
            f"no CUDA kernel for the {spec.name!r} spec yet (ROADMAP "
            "Queue 2)")
    x = operands[0]
    _on_cuda(x)
    if x.dtype not in DTYPE_CODES or (spec.name == "mask"
                                      and x.dtype != torch.int32):
        takes = (["torch.int32"] if spec.name == "mask"
                 else sorted(str(d) for d in DTYPE_CODES))
        raise TypeError(f"no CUDA scan kernel for {x.dtype} ({spec.name} "
                        f"spec); supported: {takes}")
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
    flags = None
    if spec.name == "segsum":
        flags = operands[1]
        if (flags.device != x.device or flags.dtype != torch.int32
                or flags.shape != x.shape or not flags.is_contiguous()):
            raise ValueError(
                f"segmented flags must be contiguous int32 of shape "
                f"{tuple(x.shape)} on {x.device}, got {flags.dtype} "
                f"{tuple(flags.shape)} on {flags.device}")
    return SPEC_CODES[spec.name], x, flags


def _leaf_dtypes(spec, x):
    """Accumulation dtype of each element leaf (the chain's dtypes); the
    segmented flags are int32."""
    return spec.elem_dtypes((x.dtype, torch.int32))


def _new_leaves(spec, x, shape):
    return tuple(torch.empty(shape, dtype=dt, device=x.device)
                 for dt in _leaf_dtypes(spec, x))


def _ptrs(leaves):
    """(leaf 0, leaf 1) data pointers; None (NULL) where absent."""
    if leaves is None:
        return None, None
    return (leaves[0].data_ptr(),
            leaves[1].data_ptr() if len(leaves) > 1 else None)


def _launch(spec, kernel: str, fn, device, *args) -> None:
    name = kernel_name(spec.name, kernel)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        msg = build().scan_error_string(err).decode()
        raise RuntimeError(f"scan kernel {name} launch failed: {msg} ({err})")
    LAUNCHES[name] += 1


def _out(spec, x, layout):
    dt = spec.out_dtypes((x.dtype, torch.int32))[0]
    return torch.empty(layout.shape, dtype=dt, device=x.device)


def carry(spec, operands, layout, exclusive=False, return_totals=False):
    """Carry schedule: one block per row, the running carry in registers.
    Returns ``(outputs, running totals or None)``."""
    code, x, flags = _operands(spec, operands, layout)
    out = _out(spec, x, layout)
    running = (_new_leaves(spec, x, layout.chain_shape)
               if return_totals else None)
    if x.numel():
        _launch(spec, "carry", build().scan_carry, x.device, code,
                DTYPE_CODES[x.dtype], x.data_ptr(),
                None if flags is None else flags.data_ptr(), out.data_ptr(),
                *_ptrs(running), layout.rows, layout.n, layout.bn,
                int(exclusive), spec.sentinel or 0)
    return (out,), running


def totals(spec, operands, layout):
    """Per-chunk totals (rows, chunks), one tensor per element leaf in
    its accumulation dtype."""
    code, x, flags = _operands(spec, operands, layout)
    tot = _new_leaves(spec, x, layout.chain_shape)
    if x.numel():
        _launch(spec, "totals", build().scan_totals, x.device, code,
                DTYPE_CODES[x.dtype], x.data_ptr(),
                None if flags is None else flags.data_ptr(), *_ptrs(tot),
                layout.rows, layout.n, layout.bn)
    return tot


def chain(spec, totals, return_running=False):
    """Sequential exclusive chain over (rows, chunks) totals, left to right
    from the identity. Returns ``(offsets, running totals or None)``; the
    running totals are offset ⊕ total, the carry after each chunk."""
    if spec.name not in SPEC_CODES:
        raise NotImplementedError(
            f"no CUDA kernel for the {spec.name!r} spec yet")
    n_leaves = 2 if spec.name == "segsum" else 1
    if len(totals) != n_leaves:
        raise ValueError(f"{spec.name} chain takes {n_leaves} leaves")
    t0 = totals[0]
    _on_cuda(t0)
    want = (t0.dtype,) + ((torch.int32,) if n_leaves == 2 else ())
    if t0.dtype not in (torch.float32, torch.int32) or (
            spec.name == "mask" and t0.dtype != torch.int32):
        raise TypeError(f"chain takes float32/int32 totals, got {t0.dtype}")
    for t, dt in zip(totals, want):
        if (t.device != t0.device or t.dtype != dt or t.dim() != 2
                or t.shape != t0.shape or not t.is_contiguous()):
            raise ValueError(
                f"chain takes contiguous 2-D totals of one shape with "
                f"dtypes {want}")
    offsets = tuple(torch.empty_like(t) for t in totals)
    running = (tuple(torch.empty_like(t) for t in totals)
               if return_running else None)
    if t0.numel():
        _launch(spec, "chain", build().scan_chain, t0.device,
                SPEC_CODES[spec.name], DTYPE_CODES[t0.dtype], *_ptrs(totals),
                *_ptrs(offsets), *_ptrs(running), t0.shape[0], t0.shape[1])
    return offsets, running


def apply(spec, operands, offsets, layout, exclusive=False):
    """Rescan every (row, chunk) tile and combine its chunk offset;
    returns the outputs."""
    code, x, flags = _operands(spec, operands, layout)
    want = _leaf_dtypes(spec, x)
    if len(offsets) != len(want) or any(
            tuple(o.shape) != layout.chain_shape or o.dtype != dt
            or o.device != x.device or not o.is_contiguous()
            for o, dt in zip(offsets, want)):
        raise ValueError(
            f"offsets {[(tuple(o.shape), o.dtype, str(o.device)) for o in offsets]}"
            f" do not match the chain {layout.chain_shape} {want} on "
            f"{x.device}")
    out = _out(spec, x, layout)
    if x.numel():
        _launch(spec, "apply", build().scan_apply, x.device, code,
                DTYPE_CODES[x.dtype], x.data_ptr(),
                None if flags is None else flags.data_ptr(), *_ptrs(offsets),
                out.data_ptr(), layout.rows, layout.n, layout.bn,
                int(exclusive), spec.sentinel or 0)
    return (out,)


def tree(spec, operands, layout, exclusive=False, return_totals=False):
    """Tree schedule: carry's row walk, Blelloch sweep inside each tile.
    Returns ``(outputs, running totals or None)``."""
    code, x, flags = _operands(spec, operands, layout)
    out = _out(spec, x, layout)
    running = (_new_leaves(spec, x, layout.chain_shape)
               if return_totals else None)
    if x.numel():
        _launch(spec, "tree", build().scan_tree, x.device, code,
                DTYPE_CODES[x.dtype], x.data_ptr(),
                None if flags is None else flags.data_ptr(), out.data_ptr(),
                *_ptrs(running), layout.rows, layout.n, layout.bn,
                int(exclusive), spec.sentinel or 0)
    return (out,), running
