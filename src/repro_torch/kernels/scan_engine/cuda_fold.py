"""Build, bind and launch the attention-fold kernels (``csrc/attn_fold.cu``).

The kernels are compiled at first use with ``nvcc`` for ``sm_90a`` into
``build/`` (``cuda.compile_library``: a shared library with a plain C
interface, cached under a hash of the source and flags) and loaded with
``ctypes``.

Four kernels serve the three carried-payload specs of the flash
attention fold (``core/scan/assoc``):

  fold_fwd    ``softmax_pair`` on ``KVBlocks`` (the flash forward)
  fold_dq     ``softmax_bwd_dq`` on ``KVBlocks``
  fold_dkv    ``softmax_bwd_dkv`` on ``QBlocks``
  fold_chain  the split-KV chain and finalize of any of the three: one
              ``__global__`` function for the softmax pair (counted as
              ``fold_chain``) and one for the sums of the two backward
              specs (counted as ``fold_chain_sum``)

``fold`` runs the carry schedule (one launch that finalizes),
``fold_totals`` the split pass of the decoupled schedule (each chunk of
the fold axis publishes its payload) and ``chain`` its chain. Each
wrapper checks device, dtype, contiguity and the layout's shapes, raises
on anything the kernels do not take (float16, a head dim above 256, a
KV block above 128 rows), allocates outputs and chain buffers with
``torch.empty``, launches on PyTorch's current stream, raises if the
launch returns an error, and adds one to its entry of ``LAUNCHES``. The
plain PyTorch version of each kernel lives in ``schedules.py``
(``fold_carry_plain``, ``fold_totals_plain``, ``fold_finalize_plain``).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.scan_engine import cuda
from repro_torch.kernels.scan_engine.layouts import KVBlocks, QBlocks

SOURCE = cuda.SOURCE.parent / "attn_fold.cu"
BUILD_DIR = cuda.BUILD_DIR

KERNELS = ("fold_fwd", "fold_dq", "fold_dkv", "fold_chain",
           "fold_chain_sum")
# spec name -> (kernel, layout type, operand kinds)
BWD_KINDS = ("q", "kv", "kv", "q", "qstat", "qstat", "qstat")
SPECS = {
    "softmax_pair": ("fold_fwd", KVBlocks, ("q", "kv", "kv")),
    "softmax_bwd_dq": ("fold_dq", KVBlocks, BWD_KINDS),
    "softmax_bwd_dkv": ("fold_dkv", QBlocks, BWD_KINDS),
}
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_D = 256        # head dim: a cell's rows stay whole in shared memory
MAX_BK = 128       # KV rows of a KVBlocks cell
MAX_SPLITS = 65535  # grid.y

# Kernel launches since the last ``reset_launches()``, by kernel.
LAUNCHES = {k: 0 for k in KERNELS}

_lib = None
build_log = ""  # the compiler's output of the last build in this process


class FoldArgs(ctypes.Structure):
    """The C ``FoldArgs``: geometry, mask and bounds of one launch."""

    _fields_ = [(n, ctypes.c_int) for n in (
        "bh", "bh_kv", "tq", "tk", "d", "bq", "bk", "group", "nq", "nk",
        "splits", "bpc", "pos_bq", "pos_bk")] + [
        ("scale", ctypes.c_float), ("softcap", ctypes.c_float)] + [
        (n, ctypes.c_int) for n in (
            "has_softcap", "causal", "has_window", "window", "has_kv_len",
            "kv_len", "bounds", "b_causal", "b_has_window", "b_window",
            "b_has_kv_len", "b_kv_len")]


class FoldPtrs(ctypes.Structure):
    """The C ``FoldPtrs``: device pointers, NULL where absent."""

    _fields_ = [(n, ctypes.c_void_p) for n in (
        "q", "k", "v", "dout", "m", "l", "delta", "kv_map", "out0", "out1",
        "m_out", "l_out", "counts", "c0", "c1", "c2")]


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    so, log = cuda.compile_library(SOURCE, BUILD_DIR)
    build_log = log or build_log
    lib = ctypes.CDLL(str(so))
    fold_sig = (ctypes.POINTER(FoldArgs), ctypes.POINTER(FoldPtrs),
                ctypes.c_int, ctypes.c_void_p)
    for name in ("attn_fold_fwd", "attn_fold_dq", "attn_fold_dkv"):
        fn = getattr(lib, name)
        fn.argtypes = fold_sig
        fn.restype = ctypes.c_int
    lib.attn_fold_chain.argtypes = (
        ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(FoldPtrs), ctypes.c_void_p)
    lib.attn_fold_chain.restype = ctypes.c_int
    lib.attn_error_string.argtypes = (ctypes.c_int,)
    lib.attn_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def _launch(kernel: str, fn, device, *args) -> None:
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        msg = build().attn_error_string(err).decode()
        raise RuntimeError(
            f"attention fold kernel {kernel} launch failed: {msg} ({err})")
    LAUNCHES[kernel] += 1


def _check(spec, operands, layout):
    """The kernel of ``spec`` and the validated operands."""
    if spec.name not in SPECS or spec.attn is None:
        raise NotImplementedError(
            f"no CUDA fold kernel for the {spec.name!r} spec")
    kernel, lay_type, kinds = SPECS[spec.name]
    if not isinstance(layout, lay_type) or tuple(layout.op_kinds) != kinds:
        raise ValueError(
            f"the {kernel} kernel takes a {lay_type.__name__} layout with "
            f"operand kinds {kinds}, got {type(layout).__name__} "
            f"{tuple(layout.op_kinds)}")
    layout.check_ops(len(operands))
    x = operands[0]
    if not x.is_cuda:
        raise ValueError(
            f"the CUDA fold kernels take CUDA tensors, got {x.device}")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(
            f"no CUDA fold kernel for {x.dtype}; supported: float32, "
            "bfloat16")
    if layout.d > MAX_D or (kernel != "fold_dkv" and layout.bk > MAX_BK):
        raise ValueError(
            f"the fold kernels take head dim <= {MAX_D} and KV blocks of "
            f"<= {MAX_BK} rows, got d={layout.d} bk={layout.bk}")
    if layout.splits > MAX_SPLITS:
        raise ValueError(f"{layout.splits} splits exceed one launch grid")
    shapes = {"q": (layout.bh, layout.tq, layout.d),
              "kv": (layout.bh_kv, layout.tk, layout.d),
              "qstat": (layout.bh, layout.tq, 1)}
    for o, kind in zip(operands, layout.op_kinds):
        want = torch.float32 if kind == "qstat" else x.dtype
        if (o.device != x.device or o.dtype != want
                or tuple(o.shape) != shapes[kind] or not o.is_contiguous()):
            raise ValueError(
                f"{kernel}: a {kind!r} operand must be contiguous {want} of "
                f"shape {shapes[kind]} on {x.device}, got {o.dtype} "
                f"{tuple(o.shape)} on {o.device}")
    return kernel


def _args(spec, layout, splits, bpc):
    at = spec.attn
    causal, window, kv_len = layout.kv_bounds or (False, None, None)
    bounds = layout.kv_bounds is not None and (
        causal or window is not None or kv_len is not None)
    return FoldArgs(
        bh=layout.bh, bh_kv=layout.bh_kv, tq=layout.tq, tk=layout.tk,
        d=layout.d, bq=layout.bq, bk=layout.bk, group=layout.group,
        nq=layout.nq, nk=layout.nk, splits=splits, bpc=bpc,
        pos_bq=at.block_q, pos_bk=at.block_k, scale=at.scale,
        softcap=at.softcap or 0.0, has_softcap=at.softcap is not None,
        causal=bool(at.causal), has_window=at.window is not None,
        window=at.window or 0, has_kv_len=at.kv_len is not None,
        kv_len=at.kv_len or 0, bounds=bounds, b_causal=bool(causal),
        b_has_window=window is not None, b_window=window or 0,
        b_has_kv_len=kv_len is not None, b_kv_len=kv_len or 0)


def _kv_map(layout, device):
    """The layout's page map as contiguous int32 on ``device`` (its range
    checked), or None."""
    m = layout.kv_block_map
    if m is None:
        return None
    m = m.to(device=device, dtype=torch.int32).contiguous()
    if int(m.min()) < 0 or int(m.max()) >= layout.nk:
        raise ValueError(f"kv_block_map entries must lie in [0, {layout.nk})")
    return m


def _operand_ptrs(operands, kv_map):
    ptrs = FoldPtrs()
    for name, o in zip(("q", "k", "v", "dout", "m", "l", "delta"), operands):
        setattr(ptrs, name, o.data_ptr())
    ptrs.kv_map = cuda._ptr(kv_map)
    return ptrs


def _fold_fn(kernel):
    return getattr(build(), f"attn_{kernel}")


def fold(spec, operands, layout, count_cells=False):
    """Carry schedule: one launch folds every (row, sub-tile) block over
    the whole fold axis and writes the finalized outputs. Returns
    ``(outputs, counts or None)``: with ``count_cells`` an int32
    ``layout.count_shape`` tensor of the cells each row ran."""
    kernel = _check(spec, operands, layout)
    x = operands[0]
    out_dts = spec.out_dtypes(tuple(o.dtype for o in operands))
    outs = tuple(torch.empty(layout.out_shape_for(i), dtype=dt,
                             device=x.device)
                 for i, dt in enumerate(out_dts))
    if kernel == "fold_dkv" and outs[0].dtype != outs[1].dtype:
        raise TypeError("fold_dkv writes dk and dv in one dtype")
    counts = (torch.empty(layout.count_shape, dtype=torch.int32,
                          device=x.device) if count_cells else None)
    kv_map = _kv_map(layout, x.device)
    ptrs = _operand_ptrs(operands, kv_map)
    ptrs.out0 = outs[0].data_ptr()
    if len(outs) > 1 and kernel == "fold_dkv":
        ptrs.out1 = outs[1].data_ptr()
    if len(outs) == 3:   # the forward's (m, l) statistics
        ptrs.m_out, ptrs.l_out = outs[1].data_ptr(), outs[2].data_ptr()
    ptrs.counts = cuda._ptr(counts)
    args = _args(spec, layout, 1, layout.num_seq_blocks)
    if outs[0].numel():
        _launch(kernel, _fold_fn(kernel), x.device, ctypes.byref(args),
                ctypes.byref(ptrs), DTYPE_CODES[x.dtype])
    elif counts is not None:
        counts.zero_()
    return outs, counts


def fold_totals(spec, operands, layout):
    """Split pass of the decoupled schedule: each of ``layout.splits``
    chunks of the fold axis folds its blocks from the identity and
    publishes its payload — one float32 ``layout.chain_shape_for(leaf)``
    tensor per leaf."""
    kernel = _check(spec, operands, layout)
    x = operands[0]
    totals = tuple(torch.empty(layout.chain_shape_for(i), dtype=torch.float32,
                               device=x.device)
                   for i in range(spec.n_leaves))
    kv_map = _kv_map(layout, x.device)
    ptrs = _operand_ptrs(operands, kv_map)
    for name, t in zip(("c0", "c1", "c2"), totals):
        setattr(ptrs, name, t.data_ptr())
    args = _args(spec, layout, layout.splits, layout.blocks_per_chunk)
    if totals[0].numel():
        _launch(kernel, _fold_fn(kernel), x.device, ctypes.byref(args),
                ctypes.byref(ptrs), DTYPE_CODES[x.dtype])
    return totals


def chain(spec, totals, layout, out_dts):
    """The chain over the splits (axis 1 of the totals), left to right
    from the identity, and the spec's finalize: the outputs in
    ``out_dts``, shaped as ``layout.out_shape_for``."""
    if spec.name not in SPECS:
        raise NotImplementedError(
            f"no CUDA fold kernel for the {spec.name!r} spec")
    if len(totals) != spec.n_leaves:
        raise ValueError(f"{spec.name} chain takes {spec.n_leaves} leaves")
    t0 = totals[0]
    if not t0.is_cuda:
        raise ValueError(
            f"the CUDA fold kernels take CUDA tensors, got {t0.device}")
    for i, t in enumerate(totals):
        if (t.dtype != torch.float32 or t.device != t0.device
                or tuple(t.shape) != layout.chain_shape_for(i)
                or not t.is_contiguous()):
            raise ValueError(
                f"chain leaf {i} must be contiguous float32 of shape "
                f"{layout.chain_shape_for(i)} on {t0.device}")
    if out_dts[0] not in DTYPE_CODES or (
            spec.name == "softmax_bwd_dkv" and out_dts[1] != out_dts[0]):
        raise TypeError(f"no CUDA fold chain for output dtypes {out_dts}")
    outs = tuple(torch.empty(layout.out_shape_for(i), dtype=dt,
                             device=t0.device)
                 for i, dt in enumerate(out_dts))
    ptrs = FoldPtrs()
    for name, t in zip(("c0", "c1", "c2"), totals):
        setattr(ptrs, name, t.data_ptr())
    ptrs.out0 = outs[0].data_ptr()
    softmax = spec.name == "softmax_pair"
    if softmax and len(outs) == 3:
        ptrs.m_out, ptrs.l_out = outs[1].data_ptr(), outs[2].data_ptr()
    elif not softmax and len(outs) == 2:
        ptrs.out1 = outs[1].data_ptr()
    rows_blocks, splits, tile, _ = t0.shape
    if outs[0].numel():
        _launch("fold_chain" if softmax else "fold_chain_sum",
                build().attn_fold_chain, t0.device,
                0 if softmax else 1, DTYPE_CODES[out_dts[0]],
                rows_blocks * tile, splits, tile, layout.d,
                ctypes.byref(ptrs))
    return outs
