"""Build, bind and launch the element-monoid scan kernels (``csrc/scan_sum.cu``).

The kernels are compiled at first use with ``nvcc`` for ``sm_90a`` into
``build/`` at the repository root — a shared library with a plain C
interface, loaded with ``ctypes`` — and cached there under a hash of the
source and flags. A missing ``nvcc`` or a failed build raises with the
compiler's output.

One set of kernels (carry, totals, chain, apply, fused, tree) is written
once over a spec and a geometry and instantiated for the four specs with
a CUDA kernel — the sum, the segmented sum (values and int32 flags), the
compact mask (int32 mask, int32 destinations) and the affine recurrence
(gates a and offsets b of one float dtype) — on ``Rows`` (2-D) and
``Channels`` (3-D) layouts. Every kernel but the chain runs the form
that ``tile_network`` chooses by shape. ``totals`` of the sum, the
segmented sum and the mask on ``Rows`` launch ``totals_reduce_kernel``,
and of the affine pair on ``Channels`` tiles of 128, 256 and 512 steps
``totals_chan_reduce_kernel`` (the network's last element built as its
tree, without the scan); every other ``totals`` launches the network's
``totals_kernel``. ``carry``, ``apply``, ``fused`` and ``tree`` run
``carry_reg_kernel``, ``apply_reg_kernel``, ``fused_reg_kernel`` and
``tree_reg_kernel`` (registers and warp shuffles) on ``Rows`` tiles of
128·r elements, ``carry_kernel``, ``apply_kernel``, ``fused_kernel`` and
``tree_kernel`` (shared memory) otherwise, but for the affine pair on
``Channels`` tiles of 128, 256 and 512 steps (the carry also of 32),
which runs ``carry_chan_reg_kernel``, ``apply_chan_reg_kernel``,
``fused_chan_reg_kernel`` and ``tree_chan_reg_kernel`` (each channel's
network, or the tree's sweep, by warp shuffles, the tiles staged by
``cp.async``). Both forms of a kernel count under the
same key. Each
wrapper below takes the spec and its
operands as the engine passes them, checks device, dtype, contiguity and
the layout's shape, raises on anything the kernel does not take,
allocates the outputs and scratch with ``torch.empty``/``torch.zeros``,
launches on PyTorch's current stream, raises if the launch returns an
error, and adds one to its entry of ``LAUNCHES``. The plain PyTorch
version of each kernel lives beside its schedule in ``schedules.py``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from repro_torch.kernels.scan_engine.layouts import Channels

_PKG = Path(__file__).resolve().parents[2]
SOURCE = _PKG / "csrc" / "scan_sum.cu"
BUILD_DIR = _PKG.parents[1] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Spec codes of the C interface, by KernelSpec name.
SPEC_CODES = {"sum": 0, "segsum": 1, "mask": 2, "affine": 3}
KERNELS = ("carry", "totals", "chain", "apply", "fused", "tree")


def kernel_name(spec_name: str, kernel: str) -> str:
    """The launch counter's key: ``carry`` for the sum, ``segsum_carry``,
    ``mask_carry`` and ``affine_carry`` for the others."""
    return kernel if spec_name == "sum" else f"{spec_name}_{kernel}"


# Kernel launches since the last ``reset_launches()``, by kernel.
LAUNCHES = {kernel_name(s, k): 0 for s in SPEC_CODES for k in KERNELS}

# dtype codes of the values (see the dispatch in scan_sum.cu).
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
               torch.int32: 3, torch.int16: 4, torch.int8: 5}
FLOATS = (torch.float32, torch.bfloat16, torch.float16)

# Longest tile: the network's two buffers of 16384 (value, flag) pairs
# take 160 KB, the tree's of 16384 float32 words 128 KB, of the 227 KB a
# block may use; an affine (a, b) pair takes 8 bytes, so 8192 of them.
MAX_BLOCK_N = 16384
MAX_AFFINE_BLOCK_N = 8192
# Channels: a block takes `width` adjacent channels of one batch row (one
# warp's worth at most) and at most this many tile elements, so the affine
# network's two buffers stay within 64 KB and three blocks share an SM.
MAX_WIDTH = 32
MAX_CHANNEL_TILE = 4096
# Time tiles the register carry on Channels takes (32 steps a lane-slot:
# four, eight or sixteen slots a lane), and the elements of its strips'
# tiles at most (two stages of (a, b) in 128 KB of shared memory).
CHAN_REG_TILES = (128, 256, 512)
CHAN_REG_TILE = 8192
# The carry's alone: also tiles of 8, 16, 24 and 32 steps (the SSD carry of
# a 1024-token training row, 8 chunks a channel, of a 2500-token prefill,
# 24, of a 4096-token one, 32), a thread a channel holding its tile.
CHAN_CARRY_TILES = (8, 16, 24, 32) + CHAN_REG_TILES

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
        "nvcc not found (PATH, $CUDA_HOME/bin): the kernels are compiled "
        f"from {SOURCE.parent} at first use on a machine with the CUDA "
        "toolkit")


def compile_library(source: Path, build_dir: Path) -> "tuple[Path, str]":
    """Compile ``source`` with ``nvcc`` into a shared library in
    ``build_dir``, named by a hash of the source, the headers beside it
    (``*.cuh``) and the flags, unless it is there already. Returns the
    library's path and the compiler's output ("" when the library was
    cached); raises with that output if nvcc fails."""
    headers = b"".join(h.read_bytes()
                       for h in sorted(source.parent.glob("*.cuh")))
    digest = hashlib.sha256(
        source.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    so = build_dir / f"{source.stem}_{digest}.so"
    if so.exists():
        return so, ""
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
        capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}) on {source}:\n{log}")
    os.replace(tmp, so)
    return so, log


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    so, log = compile_library(SOURCE, BUILD_DIR)
    build_log = log or build_log
    lib = ctypes.CDLL(str(so))
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    tile = (i, i, i, p, p)          # spec, dtype, chan, x, y
    geom = (ll, ll, ll, i, i)       # b, n, d, width, bn
    signatures = {
        "scan_carry": tile + (p, p, p) + geom + (i, i, i, p),
        "scan_totals": tile + (p, p) + geom + (i, p),
        "scan_chain": (i, i, i, p, p, p, p, p, p, ll, ll, ll, p),
        "scan_apply": tile + (p, p, p) + geom + (i, i, i, p),
        "scan_fused": tile + (p, p, p, p, p, p) + geom + (i, i, i, p),
        "scan_tree": tile + (p, p, p) + geom + (i, i, i, p),
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


def _check_spec(spec) -> None:
    if spec.name not in SPEC_CODES:
        raise NotImplementedError(
            f"no CUDA kernel for the {spec.name!r} spec yet (ROADMAP "
            "Queue 2)")


def channel_width(layout: Channels) -> int:
    """Channels one block takes: the widest power of two up to
    ``MAX_WIDTH`` that divides D and keeps the tile within
    ``MAX_CHANNEL_TILE`` elements. Any split gives the same bits: only
    the time tile fixes the association."""
    w = MAX_WIDTH
    while w > 1 and (layout.d % w or layout.bt * w > MAX_CHANNEL_TILE):
        w //= 2
    return w


def chan_reg_width(layout: Channels) -> int:
    """Channels a block of the register carry, apply, fused and tree
    (``carry_chan_reg_kernel``, ``apply_chan_reg_kernel``,
    ``fused_chan_reg_kernel``, ``tree_chan_reg_kernel``) takes: the
    widest power of two up to ``MAX_WIDTH`` that divides D and keeps the
    tile within ``CHAN_REG_TILE`` elements: 32 channels, rows
    of 128 bytes of float32, at 128 and 256 steps (rows of 64 bytes held
    its copies alone to 2.6 ms at the SSD carry, 128 bytes to 2.0; PERF.md,
    tools/chan_variants.py). Any split gives the same bits."""
    w = MAX_WIDTH
    while w > 1 and (layout.d % w or layout.bt * w > CHAN_REG_TILE):
        w //= 2
    return w


def tile_network(spec, layout, kernel: str) -> str:
    """The in-tile network a ``kernel`` launch (``"carry"``,
    ``"totals"``, ``"apply"``, ``"fused"`` or ``"tree"``) runs, chosen
    here by shape and nowhere else: ``"register"`` (``carry_reg_kernel``,
    ``apply_reg_kernel``, ``fused_reg_kernel``, ``tree_reg_kernel``: a
    warp a 128-element segment, Hillis–Steele or the Blelloch sweep by
    warp shuffles) for ``Rows`` tiles whose length is a multiple of 128,
    of every spec but the affine pair (its wrappers lay it out on
    ``Channels``), and for the affine pair's carry, apply, fused and tree
    on ``Channels`` tiles of ``CHAN_REG_TILES`` steps whose
    ``chan_reg_width`` is a multiple of 4 channels
    (``carry_chan_reg_kernel``, ``apply_chan_reg_kernel`` and
    ``tree_chan_reg_kernel``: a warp two channels, lane l holding steps
    l + 32 s, the carry or the chain's offsets on the left, the tree's
    Blelloch sweep across lanes and then over lane 31's registers; the
    carry alone also on tiles of 8, 16, 24 and 32 steps,
    ``CHAN_CARRY_TILES``, a thread a channel holding its tile;
    ``fused_chan_reg_kernel``: a warp four, a tile a block, its offset by
    the look-back); for ``totals``, the reduction without the scan
    (``totals_reduce_kernel`` for ``Rows`` tiles of any length of the sum,
    the segmented sum and the mask, ``totals_chan_reduce_kernel`` for the
    affine pair on ``Channels`` tiles of ``CHAN_REG_TILES`` steps, any
    D); ``"shared"`` (``carry_kernel``, ``totals_kernel``,
    ``apply_kernel``, ``fused_kernel``, ``tree_kernel``: the network in
    shared memory) for every other launch. Both give the bits of
    ``schedules.tile_scan`` (carry, apply, fused; totals its last
    element) or ``schedules.tree_scan`` (tree); the kernel refuses a
    register launch of any other shape, and nothing falls back."""
    if kernel not in ("carry", "totals", "apply", "fused", "tree"):
        raise ValueError(f"no tile network for the {kernel!r} kernel")
    if isinstance(layout, Channels):
        tiles = CHAN_CARRY_TILES if kernel == "carry" else CHAN_REG_TILES
        if spec.name != "affine" or layout.bt not in tiles:
            return "shared"
        if kernel == "totals" or chan_reg_width(layout) % 4 == 0:
            return "register"
        return "shared"
    if kernel == "totals":
        return "shared" if spec.name == "affine" else "register"
    if layout.bn % 128 == 0 and spec.name != "affine":
        return "register"
    return "shared"


def _geometry(layout, network="shared"):
    """(chan, b, n, d, width, bn) of the C interface; on Channels the
    strip width of the ``network`` the launch runs."""
    if isinstance(layout, Channels):
        width = (chan_reg_width(layout) if network == "register"
                 else channel_width(layout))
        return 1, layout.b, layout.t, layout.d, width, layout.bt
    return 0, layout.rows, layout.n, 1, 1, layout.bn


def _operands(spec, operands, layout):
    """(spec code, first operand, second operand or None) after the
    checks."""
    _check_spec(spec)
    x = operands[0]
    _on_cuda(x)
    if spec.name == "mask":
        takes = (torch.int32,)
    elif spec.name == "affine":
        takes = FLOATS
    else:
        takes = tuple(DTYPE_CODES)
    if x.dtype not in takes:
        raise TypeError(f"no CUDA scan kernel for {x.dtype} ({spec.name} "
                        f"spec); supported: {sorted(str(d) for d in takes)}")
    ndim = 3 if isinstance(layout, Channels) else 2
    if x.dim() != ndim or not x.is_contiguous():
        raise ValueError(
            f"the CUDA scan kernels take contiguous {ndim}-D tensors on "
            f"{type(layout).__name__}, got shape {tuple(x.shape)} strides "
            f"{x.stride()}")
    if tuple(x.shape) != layout.shape:
        raise ValueError(f"tensor shape {tuple(x.shape)} != layout "
                         f"{layout.shape}")
    _, b, n, d, width, bn = _geometry(layout)
    top = MAX_AFFINE_BLOCK_N if spec.name == "affine" else MAX_BLOCK_N
    if not 1 <= bn <= top:
        raise ValueError(f"block {bn} outside [1, {top}] ({spec.name} "
                         "spec)")
    if b * (d // width) * (n // bn) >= 2 ** 31:
        raise ValueError(f"{b * (d // width)} x {n // bn} tiles exceed one "
                         "launch grid")
    y = None
    if spec.name in ("segsum", "affine"):
        y = operands[1]
        want = torch.int32 if spec.name == "segsum" else x.dtype
        if (y.device != x.device or y.dtype != want or y.shape != x.shape
                or not y.is_contiguous()):
            raise ValueError(
                f"the {spec.name} spec's second operand must be contiguous "
                f"{want} of shape {tuple(x.shape)} on {x.device}, got "
                f"{y.dtype} {tuple(y.shape)} on {y.device}")
    return SPEC_CODES[spec.name], x, y


def _leaf_dtypes(spec, x, y):
    """Accumulation dtype of each element leaf (the chain's dtypes)."""
    return spec.elem_dtypes((x.dtype, torch.int32 if y is None else y.dtype))


def _new_leaves(spec, x, y, shape):
    return tuple(torch.empty(shape, dtype=dt, device=x.device)
                 for dt in _leaf_dtypes(spec, x, y))


def _ptrs(leaves):
    """(leaf 0, leaf 1) data pointers; None (NULL) where absent."""
    if leaves is None:
        return None, None
    return (leaves[0].data_ptr(),
            leaves[1].data_ptr() if len(leaves) > 1 else None)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _network(spec, layout, kernel, network):
    """The network a launch runs: the one it is asked for (``"register"``
    or ``"shared"``, to time the two at one shape; the kernel refuses a
    register launch of a shape it does not take) or ``tile_network``'s
    choice."""
    if network not in (None, "register", "shared"):
        raise ValueError(f"unknown tile network {network!r}")
    return network or tile_network(spec, layout, kernel)


def _launch(spec, kernel: str, fn, device, *args) -> None:
    name = kernel_name(spec.name, kernel)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        msg = build().scan_error_string(err).decode()
        raise RuntimeError(f"scan kernel {name} launch failed: {msg} ({err})")
    LAUNCHES[name] += 1


def _out(spec, x, y, layout):
    dt = spec.out_dtypes((x.dtype, torch.int32 if y is None else y.dtype))[0]
    return torch.empty(layout.shape, dtype=dt, device=x.device)


def carry(spec, operands, layout, exclusive=False, return_totals=False,
          network=None):
    """Carry schedule: one block per lane (row, or channel strip), the
    running carry on chip. Returns ``(outputs, running totals or None)``.
    ``network`` (``"register"`` or ``"shared"``) launches that network in
    place of ``tile_network``'s choice, to time the two at one shape; the
    kernel refuses a register launch of a shape it does not take."""
    network = _network(spec, layout, "carry", network)
    code, x, y = _operands(spec, operands, layout)
    out = _out(spec, x, y, layout)
    running = (_new_leaves(spec, x, y, layout.chain_shape)
               if return_totals else None)
    if x.numel():
        geo = _geometry(layout, network)
        _launch(spec, "carry", build().scan_carry, x.device, code,
                DTYPE_CODES[x.dtype], geo[0], x.data_ptr(), _ptr(y),
                out.data_ptr(), *_ptrs(running), *geo[1:], int(exclusive),
                spec.sentinel or 0, int(network == "register"))
    return (out,), running


def totals(spec, operands, layout, network=None):
    """Per-chunk totals (``layout.chain_shape``), one tensor per element
    leaf in its accumulation dtype: each tile's network's last element.
    Which kernel builds it is ``tile_network(spec, layout, "totals")``'s
    choice, made there alone: ``"register"``, the reduction without the
    scan (``totals_reduce_kernel`` on ``Rows`` for the sum, the segmented
    sum and the mask,
    ``totals_chan_reduce_kernel`` on ``Channels`` for the affine pair at
    ``CHAN_REG_TILES`` steps), or ``"shared"``, the network's
    ``totals_kernel``. ``network`` as in ``carry``."""
    network = _network(spec, layout, "totals", network)
    code, x, y = _operands(spec, operands, layout)
    tot = _new_leaves(spec, x, y, layout.chain_shape)
    if x.numel():
        geo = _geometry(layout, network)
        _launch(spec, "totals", build().scan_totals, x.device, code,
                DTYPE_CODES[x.dtype], geo[0], x.data_ptr(), _ptr(y),
                *_ptrs(tot), *geo[1:], int(network == "register"))
    return tot


def chain(spec, totals, return_running=False):
    """Sequential exclusive chain over the chunk axis (axis 1) of
    (rows, chunks) or (B, chunks, D) totals, left to right from the
    identity. Returns ``(offsets, running totals or None)``; the running
    totals are offset ⊕ total, the carry after each chunk."""
    _check_spec(spec)
    n_leaves = spec.n_leaves
    if len(totals) != n_leaves:
        raise ValueError(f"{spec.name} chain takes {n_leaves} leaves")
    t0 = totals[0]
    _on_cuda(t0)
    if spec.name == "affine":
        want = (torch.float32, torch.float32)
    else:
        want = (t0.dtype,) + ((torch.int32,) if n_leaves == 2 else ())
    if t0.dtype not in (torch.float32, torch.int32) or (
            spec.name == "mask" and t0.dtype != torch.int32):
        raise TypeError(f"chain takes float32/int32 totals, got {t0.dtype}")
    for t, dt in zip(totals, want):
        if (t.device != t0.device or t.dtype != dt or t.dim() not in (2, 3)
                or t.shape != t0.shape or not t.is_contiguous()):
            raise ValueError(
                f"chain takes contiguous 2-D or 3-D totals of one shape "
                f"with dtypes {want}")
    offsets = tuple(torch.empty_like(t) for t in totals)
    running = (tuple(torch.empty_like(t) for t in totals)
               if return_running else None)
    if t0.numel():
        chan = int(t0.dim() == 3)
        d = t0.shape[2] if chan else 1
        _launch(spec, "chain", build().scan_chain, t0.device,
                SPEC_CODES[spec.name], DTYPE_CODES[t0.dtype], chan,
                *_ptrs(totals), *_ptrs(offsets), *_ptrs(running),
                t0.shape[0], t0.shape[1], d)
    return offsets, running


def apply(spec, operands, offsets, layout, exclusive=False, network=None):
    """Rescan every (lane, chunk) tile and combine its chunk offsets;
    returns the outputs. ``network`` as in ``carry``."""
    network = _network(spec, layout, "apply", network)
    code, x, y = _operands(spec, operands, layout)
    want = _leaf_dtypes(spec, x, y)
    if len(offsets) != len(want) or any(
            tuple(o.shape) != layout.chain_shape or o.dtype != dt
            or o.device != x.device or not o.is_contiguous()
            for o, dt in zip(offsets, want)):
        raise ValueError(
            f"offsets {[(tuple(o.shape), o.dtype, str(o.device)) for o in offsets]}"
            f" do not match the chain {layout.chain_shape} {want} on "
            f"{x.device}")
    out = _out(spec, x, y, layout)
    if x.numel():
        geo = _geometry(layout, network)
        _launch(spec, "apply", build().scan_apply, x.device, code,
                DTYPE_CODES[x.dtype], geo[0], x.data_ptr(), _ptr(y),
                *_ptrs(offsets), out.data_ptr(), *geo[1:], int(exclusive),
                spec.sentinel or 0, int(network == "register"))
    return (out,)


def fused(spec, operands, layout, exclusive=False, network=None):
    """Fused schedule: decoupled in one launch, each tile taking its
    offset through a look-back over its predecessors' published
    prefixes. Returns the outputs. The scratch — a ticket counter and one
    64-bit state word per tile (the tiles of the network's strips),
    zeroed here per launch, and each tile's published aggregate and
    inclusive prefix where they do not ride in the state word — is
    allocated here. ``network`` as in ``carry``."""
    network = _network(spec, layout, "fused", network)
    code, x, y = _operands(spec, operands, layout)
    out = _out(spec, x, y, layout)
    if x.numel():
        geo = _geometry(layout, network)
        tiles = geo[1] * (geo[3] // geo[4]) * (geo[2] // geo[5])
        state = torch.zeros(1 + tiles, dtype=torch.int64, device=x.device)
        agg = _new_leaves(spec, x, y, layout.chain_shape)
        incl = _new_leaves(spec, x, y, layout.chain_shape)
        _launch(spec, "fused", build().scan_fused, x.device, code,
                DTYPE_CODES[x.dtype], geo[0], x.data_ptr(), _ptr(y),
                out.data_ptr(), state.data_ptr(), *_ptrs(agg), *_ptrs(incl),
                *geo[1:], int(exclusive), spec.sentinel or 0,
                int(network == "register"))
    return (out,)


def tree(spec, operands, layout, exclusive=False, return_totals=False,
         network=None):
    """Tree schedule: carry's lane walk, Blelloch sweep inside each tile.
    Returns ``(outputs, running totals or None)``. ``network`` as in
    ``carry``."""
    network = _network(spec, layout, "tree", network)
    code, x, y = _operands(spec, operands, layout)
    out = _out(spec, x, y, layout)
    running = (_new_leaves(spec, x, y, layout.chain_shape)
               if return_totals else None)
    if x.numel():
        geo = _geometry(layout, network)
        _launch(spec, "tree", build().scan_tree, x.device, code,
                DTYPE_CODES[x.dtype], geo[0], x.data_ptr(), _ptr(y),
                out.data_ptr(), *_ptrs(running), *geo[1:], int(exclusive),
                spec.sentinel or 0, int(network == "register"))
    return (out,), running
