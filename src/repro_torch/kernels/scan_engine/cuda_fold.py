"""Build, bind and launch the attention-fold kernels (``csrc/attn_fold.cu``
and ``csrc/attn_fold_tc.cu``).

Each source is compiled at first use with ``nvcc`` for ``sm_90a`` into
``build/`` (``cuda.compile_library``: a shared library with a plain C
interface, cached under a hash of the source, its headers and the flags)
and loaded with ``ctypes``.

The kernels serve the three carried-payload specs of the flash attention
fold (``core/scan/assoc``):

  fold_fwd     ``softmax_pair`` on ``KVBlocks`` (the flash forward), SIMT
  fold_fwd_tc  the same on the tensor cores (wgmma, TMA), bfloat16
  fold_fwd_tf32
               the same on the tensor cores, float32: each product as
               three TF32 products of the operands split into hi + lo
  fold_dq      ``softmax_bwd_dq`` on ``KVBlocks``, SIMT
  fold_dq_tc   the same on the tensor cores, bfloat16
  fold_dq_tf32 the same on the tensor cores, float32, as fold_fwd_tf32
  fold_dkv     ``softmax_bwd_dkv`` on ``QBlocks``, SIMT
  fold_dkv_tc  the same on the tensor cores, bfloat16
  fold_dkv_tf32
               the same on the tensor cores, float32, as fold_dq_tf32
  fold_chain   the split-KV chain and finalize of any of the three: one
               ``__global__`` function for the softmax pair (a warp a
               row; counted as ``fold_chain``) and one for the sums of
               the two backward specs (counted as ``fold_chain_sum``)

``fold_form`` chooses between the SIMT and tensor-core form of a fold
from dtype, head dim and block sizes: bfloat16 takes the tensor-core form
wherever that form's tiling takes the shape, float32 the 3xTF32 forms at
head dims 64, 128 and 256 with q and KV blocks of 64 or 128 rows, and
every other float32 fold SIMT (its products stay float32). ``fold`` runs
the carry schedule (one launch that finalizes), ``fold_totals`` the
split pass of the decoupled
schedule (each chunk of the fold axis publishes its payload) and
``chain`` its chain. Each wrapper checks device, dtype, contiguity and
the layout's shapes, raises on anything the kernels do not take
(float16, a head dim above 256, a KV block above 128 rows), allocates
outputs and chain buffers with ``torch.empty``, launches the chosen
kernel on PyTorch's current stream, raises if the launch returns an
error (no other form is tried), and adds one to the kernel's entry of
``LAUNCHES``. The plain PyTorch version of each kernel lives in
``schedules.py`` (``fold_carry_plain``, ``fold_totals_plain``,
``fold_finalize_plain``).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.scan_engine import cuda
from repro_torch.kernels.scan_engine.layouts import KVBlocks, QBlocks

SOURCE = cuda.SOURCE.parent / "attn_fold.cu"
TC_SOURCE = cuda.SOURCE.parent / "attn_fold_tc.cu"
BUILD_DIR = cuda.BUILD_DIR

KERNELS = ("fold_fwd", "fold_fwd_tc", "fold_fwd_tf32", "fold_dq",
           "fold_dq_tc", "fold_dq_tf32", "fold_dkv", "fold_dkv_tc",
           "fold_dkv_tf32", "fold_chain", "fold_chain_sum")
# the forms built from attn_fold_tc.cu, and those of them taking float32
TC_FORMS = ("fold_fwd_tc", "fold_fwd_tf32", "fold_dq_tc", "fold_dq_tf32",
            "fold_dkv_tc", "fold_dkv_tf32")
TF32_FORMS = ("fold_fwd_tf32", "fold_dq_tf32", "fold_dkv_tf32")
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
# The tensor-core forms' range: head dims that are whole 64-column
# (128-byte) TMA boxes, KV cells of one or two 64-row wgmma tiles, and q
# blocks of two 64-row tiles or (forward) the rows of several heads
# packed into one tile. The bfloat16 forms (forward, dq and dk/dv) also
# take a head dim that is a multiple of 16 between them (zamba2's 112,
# stablelm's 160), on the instantiation of the next of these dims
# (``tc_dim``), the columns past d read as zeros by TMA and never stored.
TC_DIMS = (64, 128, 256)
TC_BK = (64, 128)
TC_BQ = {"fold_fwd": (8, 16, 32, 64, 128), "fold_dq": (64, 128),
         "fold_dkv": (64, 128)}
# The float32 (3xTF32) forms' head dims. dk/dv: 64 kv rows a block,
# chunks of TF32_ROWS q rows split into TF32 hi and lo tiles, a stage the
# whole d up to 128, else 64 columns (a chunk streams through four stages
# for the scores, then four for the updates); dq: one 64-row q tile a
# block, k and v streamed in stages of 32 columns, then 64 columns of k
# for each dqᵀ tile; forward: one 64-row q tile a block, k streamed in
# stages of 32 columns of the cell's (one or two) 64-row kv tiles, then v
# in stages of 64 columns of a 64-row kv tile for each warpgroup's accᵀ
# tile.
TF32_DIMS = (64, 128, 256)
TF32_ROWS = 32   # q rows a chunk
TF32_DQ_STAGES = {64: 5, 128: 4, 256: 2}
TF32_FWD_STAGES = {64: 4, 128: 4, 256: 3}
TF32_FWD_STATS = 6 * 64 * 4   # the forward's row statistics: 6 x 64 floats
SMEM_LIMIT = 232448   # dynamic shared memory a block may use (227 KB)
PANEL_BYTES = 64 * 128   # 64 rows of a 64-column bf16 box

# Kernel launches since the last ``reset_launches()``, by kernel.
LAUNCHES = {k: 0 for k in KERNELS}

_lib = None
_lib_tc = None
# the compiler's output of the last build of each source in this process
build_log = ""
build_log_tc = ""


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


_FOLD_SIG = (ctypes.POINTER(FoldArgs), ctypes.POINTER(FoldPtrs),
             ctypes.c_int, ctypes.c_void_p)


def _bind(lib, names, error_string):
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = _FOLD_SIG
        fn.restype = ctypes.c_int
    fn = getattr(lib, error_string)
    fn.argtypes = (ctypes.c_int,)
    fn.restype = ctypes.c_char_p


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the SIMT kernel library."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    so, log = cuda.compile_library(SOURCE, BUILD_DIR)
    build_log = log or build_log
    lib = ctypes.CDLL(str(so))
    _bind(lib, ("attn_fold_fwd", "attn_fold_dq", "attn_fold_dkv"),
          "attn_error_string")
    lib.attn_fold_chain.argtypes = (
        ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(FoldPtrs), ctypes.c_void_p)
    lib.attn_fold_chain.restype = ctypes.c_int
    _lib = lib
    return lib


def build_tc() -> ctypes.CDLL:
    """Compile (once per source hash) and load the tensor-core library."""
    global _lib_tc, build_log_tc
    if _lib_tc is not None:
        return _lib_tc
    so, log = cuda.compile_library(TC_SOURCE, BUILD_DIR)
    build_log_tc = log or build_log_tc
    lib = ctypes.CDLL(str(so))
    _bind(lib, ("attn_fold_fwd_tc", "attn_fold_fwd_tf32", "attn_fold_dq_tc",
                "attn_fold_dq_tf32", "attn_fold_dkv_tc",
                "attn_fold_dkv_tf32"),
          "attn_tc_error_string")
    _lib_tc = lib
    return lib


def tc_dim(d: int) -> int:
    """The head dim of the tensor-core instantiation that runs head dim
    ``d``: the smallest of ``TC_DIMS`` that holds it (112 -> 128, 160 ->
    256)."""
    return next(t for t in TC_DIMS if t >= d)


def fold_form(kernel: str, dtype, d: int, bq: int, bk: int) -> str:
    """The kernel that runs fold ``kernel`` ("fold_fwd", "fold_dq" or
    "fold_dkv") on ``dtype`` operands of head dim ``d`` in (``bq``,
    ``bk``) cells, by its ``LAUNCHES`` name: ``fold_fwd_tc`` /
    ``fold_dq_tc`` / ``fold_dkv_tc`` for bfloat16 with d any multiple of
    16 (run at ``tc_dim(d)``), bk in ``TC_BK`` and bq in ``TC_BQ``;
    ``fold_fwd_tf32`` / ``fold_dq_tf32`` / ``fold_dkv_tf32`` for float32
    with d in ``TF32_DIMS`` and bk, bq in ``TC_BK`` (three TF32 products
    keep ~22 bits of each operand, where the float32 bars against the
    plain versions, 1e-5 / 1e-4, rule out bf16 or single TF32 products);
    else the SIMT kernel (a decode step's bq of 8 among them, and float32
    at a head dim between ``TF32_DIMS``).
    A choice by shape: no form gives way to another. Raises TypeError for
    a dtype no kernel takes and ValueError past the kernels' range."""
    if dtype not in DTYPE_CODES:
        raise TypeError(
            f"no CUDA fold kernel for {dtype}; supported: float32, "
            "bfloat16")
    if d > MAX_D or (kernel != "fold_dkv" and bk > MAX_BK):
        raise ValueError(
            f"the fold kernels take head dim <= {MAX_D} and KV blocks of "
            f"<= {MAX_BK} rows, got d={d} bk={bk}")
    if (dtype == torch.bfloat16 and kernel in TC_BQ and d % 16 == 0
            and bk in TC_BK and bq in TC_BQ[kernel]):
        return kernel + "_tc"
    if (dtype == torch.float32 and d in TF32_DIMS and bk in TC_BK
            and bq in TC_BK):
        return kernel + "_tf32"
    return kernel


def tc_tiling(form: str, d: int, bq: int) -> dict:
    """The block of a tensor-core form as ``attn_fold_tc.cu`` lays it out
    (``FwdTiles`` / ``DqTiles`` / ``DkvTiles``): consumer warpgroups
    (each a 64-row wgmma tile), threads, the ring's stages and bytes per
    stage, and the dynamic shared memory of the launch (1024 bytes of
    alignment slack, the resident tiles, the ring and its mbarriers). A
    forward block adds a producer warpgroup to two consumers (setmaxnreg
    hands its registers over), else a producer warp; a forward stage is
    one 64-row k or v tile, and each consumer keeps its q tile and its p
    as bf16 hi and lo (four 64-column panels). A dq block is two
    warpgroups over one 64-row q tile, one of whose threads issues the
    loads: the q and dO tiles stay resident beside four
    panels (p·g, then ds, as hi and lo), and a stage is one 64-row k or v
    tile. A dk/dv block is two warpgroups, one of whose threads issues
    the loads; a stage is a 64-row chunk of q and of dO with its rows'
    (m, l, delta), beside the block's k and v rows and four panels (pᵀ
    and p·g / dsᵀ as hi and lo). The float32 dk/dv block
    (``Tf32DkvTiles``) is laid out the same way in float32 with chunks of
    ``TF32_ROWS`` q rows: a stage holds the chunk's q and dO each as TF32
    hi and lo tiles beside their rows' (m, l, delta), and the four
    [64 kv][32 q] tiles are pᵀ and p·g / dsᵀ as hi and lo; at d = 256 a
    stage holds 64 of the chunk's columns, a chunk streaming through four
    stages for sᵀ and dpᵀ and then four, raw, for the updates of its four
    64-row tiles of dkᵀ and dvᵀ. The float32 dq block (``Tf32DqTiles``)
    keeps its 64-row q and dO tiles in float32 beside ds as TF32 hi and
    lo ([64 q][64 kv] each); a stage is 32 columns of a 64-row kv tile's k
    and of its v (each split into hi, over the raw floats, and lo), or 64
    columns of k for each warpgroup's dqᵀ tile. The float32 forward block
    (``Tf32FwdTiles``) keeps its 64-row q tile in float32 beside p as TF32
    hi and lo ([64 q][128 kv] each) and the rows' statistics (the two
    warpgroups' partial row max and sum, and the combine's two scales);
    a stage is 32 columns of k for each of the cell's 64-row kv tiles
    (split into hi, over the raw floats, and lo), or 64 columns of v of
    one kv tile for each warpgroup's accᵀ tile, 32 KB either way. The
    bfloat16 forms are laid out at ``tc_dim(d)``, the instantiation that
    runs ``d``."""
    if form in TF32_FORMS:
        if d not in TF32_DIMS:
            raise ValueError(f"{form} takes d in {TF32_DIMS}")
        if form == "fold_fwd_tf32":
            stages, stage = TF32_FWD_STAGES[d], 4 * 64 * 32 * 4
            resident = 64 * d * 4 + 2 * 64 * 128 * 4 + TF32_FWD_STATS
        elif form == "fold_dq_tf32":
            stages, stage = TF32_DQ_STAGES[d], 4 * 64 * 32 * 4
            resident = 2 * 64 * d * 4 + 4 * 64 * 32 * 4
        else:
            stages = 4 if d == 64 else 2
            chunk = d if d < 256 else 64   # the chunk's columns a stage
            stage = 4 * TF32_ROWS * chunk * 4 + 3 * TF32_ROWS * 4
            resident = 2 * 64 * d * 4 + 4 * 64 * TF32_ROWS * 4
        return dict(warpgroups=2, threads=256, stages=stages,
                    stage_bytes=stage,
                    smem=1024 + resident + stages * stage
                    + 8 * (2 * stages + 1))
    d = tc_dim(d)
    tile = d // 64 * PANEL_BYTES
    if form == "fold_fwd_tc":
        wgs = 2 if bq == 128 and d <= 128 else 1
        stages = 4 if d == 256 else 6 if wgs == 2 and d == 128 else 8
        stage = tile
        resident = wgs * (tile + 4 * PANEL_BYTES)
        threads = 384 if wgs == 2 else 160
    elif form == "fold_dq_tc":
        wgs, stages, stage = 2, (4 if d == 256 else 8), tile
        resident = 2 * tile + 4 * PANEL_BYTES
        threads = 256
    elif form == "fold_dkv_tc":
        wgs, stages, stage = 2, (2 if d == 256 else 4), 2 * tile + 3 * 64 * 4
        resident = 2 * tile + 4 * PANEL_BYTES
        threads = 256
    else:
        raise ValueError(f"{form!r} is not a tensor-core form")
    return dict(warpgroups=wgs, threads=threads, stages=stages,
                stage_bytes=stage,
                smem=1024 + resident + stages * stage + 8 * (2 * stages + 1))


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it:
    to nearest on the 13 low mantissa bits, ties away from zero (the
    magnitude's bits carry into the exponent), the low bits left 0."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as ``fold_dkv_tf32`` forms every product, in plain
    PyTorch: each float32 operand split into TF32 hi = tf32(x) and lo =
    tf32(x - hi), then hi·hi' + hi·lo' + lo·hi' in float32 (the products
    of 11-bit mantissas are exact in float32; lo·lo', ~2^-22 of the
    product, is dropped). The tensor cores add in another order, so this
    states the arithmetic, not the kernel's bits."""
    a, b = a.to(torch.float32), b.to(torch.float32)
    ah, bh = tf32_round(a), tf32_round(b)
    al, bl = tf32_round(a - ah), tf32_round(b - bh)
    return torch.matmul(ah, bh) + (torch.matmul(ah, bl) + torch.matmul(al, bh))


def tc_tile_rows(bq: int, group: int, tile: int):
    """Tile ``tile`` of a (kv head, q block) in ``fold_fwd_tc``: the
    group's q heads x ``bq`` rows, in that order, cut into 64-row tiles.
    Returns, per tile row, (head within the group, q row within the q
    block, stored): a decode step (bq = 8, group 4) packs its four heads
    into rows 0..31 of one tile, and rows past the group are computed but
    never stored."""
    vr = 64 * tile + torch.arange(64)
    return vr // bq, vr % bq, vr // bq < group


def _launch(kernel: str, lib, fn, device, *args) -> None:
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        err_str = (lib.attn_tc_error_string if kernel in TC_FORMS
                   else lib.attn_error_string)
        raise RuntimeError(
            f"attention fold kernel {kernel} launch failed: "
            f"{err_str(err).decode()} ({err})")
    LAUNCHES[kernel] += 1


def _check(spec, operands, layout, form=None):
    """The kernel (``fold_form``, or ``form`` where given) that runs
    ``spec`` on the validated operands."""
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
    chosen = fold_form(kernel, x.dtype, layout.d, layout.bq, layout.bk)
    if form is None:
        form = chosen
    elif not form.startswith(kernel) or form not in KERNELS:
        raise ValueError(f"{form!r} is not a form of {kernel}")
    elif form != chosen and form in TC_FORMS and x.dtype != (
            torch.float32 if form in TF32_FORMS else torch.bfloat16):
        raise TypeError(f"{form} does not take {x.dtype} operands")
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
        if form in TC_FORMS and o.data_ptr() % 16:
            raise ValueError(
                f"{form} loads its operands by TMA: each must start on a "
                "16-byte boundary")
    return form


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


def _run(form, device, args, ptrs, dtype):
    """Launch fold kernel ``form`` (a ``fold_form`` name)."""
    if form in TC_FORMS:
        lib = build_tc()
        last = tc_tiling(form, args.d, args.bq)["smem"]
    else:
        lib, last = build(), DTYPE_CODES[dtype]
    _launch(form, lib, getattr(lib, f"attn_{form}"), device,
            ctypes.byref(args), ctypes.byref(ptrs), last)


def fold(spec, operands, layout, count_cells=False, form=None):
    """Carry schedule: one launch folds every (row, sub-tile) block over
    the whole fold axis and writes the finalized outputs. Returns
    ``(outputs, counts or None)``: with ``count_cells`` an int32
    ``layout.count_shape`` tensor of the cells each row ran. ``form`` (a
    ``KERNELS`` name of the same fold) launches that form in place of
    ``fold_form``'s choice, to time two forms at one shape; the kernel
    refuses a shape it does not take."""
    form = _check(spec, operands, layout, form)
    dkv = spec.name == "softmax_bwd_dkv"
    x = operands[0]
    out_dts = spec.out_dtypes(tuple(o.dtype for o in operands))
    outs = tuple(torch.empty(layout.out_shape_for(i), dtype=dt,
                             device=x.device)
                 for i, dt in enumerate(out_dts))
    if dkv and outs[0].dtype != outs[1].dtype:
        raise TypeError("fold_dkv writes dk and dv in one dtype")
    counts = (torch.empty(layout.count_shape, dtype=torch.int32,
                          device=x.device) if count_cells else None)
    kv_map = _kv_map(layout, x.device)
    ptrs = _operand_ptrs(operands, kv_map)
    ptrs.out0 = outs[0].data_ptr()
    if len(outs) > 1 and dkv:
        ptrs.out1 = outs[1].data_ptr()
    if len(outs) == 3:   # the forward's (m, l) statistics
        ptrs.m_out, ptrs.l_out = outs[1].data_ptr(), outs[2].data_ptr()
    ptrs.counts = cuda._ptr(counts)
    args = _args(spec, layout, 1, layout.num_seq_blocks)
    if outs[0].numel():
        _run(form, x.device, args, ptrs, x.dtype)
    elif counts is not None:
        counts.zero_()
    return outs, counts


def fold_totals(spec, operands, layout):
    """Split pass of the decoupled schedule: each of ``layout.splits``
    chunks of the fold axis folds its blocks from the identity and
    publishes its payload — one float32 ``layout.chain_shape_for(leaf)``
    tensor per leaf."""
    form = _check(spec, operands, layout)
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
        _run(form, x.device, args, ptrs, x.dtype)
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
    softmax = spec.name == "softmax_pair"
    if softmax and layout.d > MAX_D:
        raise ValueError(f"the softmax chain takes head dims up to {MAX_D}, "
                         f"got {layout.d}")
    outs = tuple(torch.empty(layout.out_shape_for(i), dtype=dt,
                             device=t0.device)
                 for i, dt in enumerate(out_dts))
    ptrs = FoldPtrs()
    for name, t in zip(("c0", "c1", "c2"), totals):
        setattr(ptrs, name, t.data_ptr())
    ptrs.out0 = outs[0].data_ptr()
    if softmax and len(outs) == 3:
        ptrs.m_out, ptrs.l_out = outs[1].data_ptr(), outs[2].data_ptr()
    elif not softmax and len(outs) == 2:
        ptrs.out1 = outs[1].data_ptr()
    rows_blocks, splits, tile, _ = t0.shape
    if outs[0].numel():
        _launch("fold_chain" if softmax else "fold_chain_sum", build(),
                build().attn_fold_chain, t0.device,
                0 if softmax else 1, DTYPE_CODES[out_dts[0]],
                rows_blocks * tile, splits, tile, layout.d,
                ctypes.byref(ptrs))
    return outs
