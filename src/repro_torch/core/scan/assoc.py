"""Associative-operator (monoid) framework for generalized prefix scans.

The PyTorch counterpart of the reference's ``core/scan/assoc.py``. Every
algorithm of the library only requires an *associative* operator with an
identity, so the same machinery drives plain cumulative sums (the paper's
object of study), ``max``/``min``/``prod`` scans and the *affine* monoid
``h' = a*h + b`` (diagonal SSM recurrences).

Elements of a monoid may be tensors or (nested) tuples of tensors (the
affine monoid's elements are ``(a, b)`` pairs); ``combine`` must be
associative over them.

Monoids that also run inside kernels carry a :class:`KernelSpec` (flat
tensor leaves, identity fill constants, in-kernel combine) — the
interface the scan engine (``repro_torch.kernels.scan_engine``) writes
each schedule against, once. Registered here: sum, segmented sum, the
compact-mask spec, the affine spec, and the flash-attention softmax-pair
spec (a *carried payload* monoid: its elements are built per block by an
input TRANSFORM from raw operand tiles rather than read from element
tensors) with its two BACKWARD specs — dq as a sum fold over KV blocks,
dk/dv as a sum fold over a transposed q-major layout — which recompute
the logits per tile instead of materializing the attention matrix.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

Pytree = Any


def _absorb_first_vml_call() -> None:
    """On the CPU, ``torch.exp`` and ``torch.tanh`` call MKL's vector math
    library (VML) from every OpenMP thread. Its first multithreaded call in
    a process now and then returns values off by ~1e-4: the first
    ``torch.exp`` of the attention specs did so in 1 of 40 processes on an
    H100 host's 8-core CPU and in 5 of 80 on an 8-core host running four
    processes at once (``tools/torch_plain_first_call.py``). One discarded
    call of each over a tensor that reaches every thread absorbs it, so
    the plain versions below give the same bits in every process."""
    x = torch.zeros(1 << 20)
    torch.exp(x)
    torch.tanh(x)


_absorb_first_vml_call()


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leafwise over tensors nested in tuples/lists."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(
            tree_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The tensors of ``tree`` in order."""
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """Kernel-side monoid: flat tensor leaves plus in-kernel emitters.

    Each schedule of the scan engine is written once against this
    interface. A kernel spec works on TUPLES of same-shape tensors; every
    callable must broadcast, because the engine applies it to whole
    tiles, to size-1 carry slices, and to per-chunk totals alike.

    Attributes:
      name: registry key (also the kernel family name in launch events).
      fills: per-leaf identity CONSTANTS — pad the log-scan shifts, reset
        the carry, and seed the decoupled combine chain.
      combine: ``combine(left, right)`` over leaf tuples; ``left`` is the
        earlier (lower-index) element.
      elem_dtypes: operand dtypes -> accumulation dtype per element leaf.
      out_dtypes: operand dtypes -> dtype per emitted output.
      out_leaves: which combined leaves are emitted (default: leaf 0).
      emit: optional ``emit(elems, combined) -> outputs`` override — the
        in-kernel select emitter (compaction's fused predicate select).
        ``elems`` are the raw tile elements in the accumulation dtype,
        ``combined`` the carry-adjusted inclusive scan.
      supports_exclusive: whether the engine may shift-and-fill for
        ``exclusive=True``.
      sentinel: the value ``emit`` writes for a dropped lane (the mask
        spec), handed to its CUDA kernel; None for the other specs.
      transform: optional per-block INPUT TRANSFORM. When set, the monoid
        is a *carried payload*: the engine reads no element tensors —
        each block along the folded axis yields ONE macro element
        ``transform(op_tiles, block_ids) -> leaf tuple`` computed from the
        raw operand tiles (flash attention: the ``q·kᵀ`` logits block with
        masking, folded to its ``(m, l, p·v)`` triple). The tiles may
        carry leading batch axes (the plain fold versions run every
        (row, q-block) pair of a fold step at once), and ``block_ids``
        are the layout's ``(head, q_block, kv_block)`` coordinates,
        integer tensors broadcast against those axes. The scan is a FOLD
        over blocks: outputs are emitted once, from the final state.
      finalize: ``finalize(combined) -> outputs`` for transform monoids —
        the fold-time emitter (flash attention's ``acc / l`` normalize).
      attn: the masking geometry baked into an attention transform
        (:class:`AttnMask`), handed to its CUDA fold kernel; None for the
        element specs.
    """

    name: str
    fills: tuple
    combine: Callable[[tuple, tuple], tuple]
    elem_dtypes: Callable[[tuple], tuple]
    out_dtypes: Callable[[tuple], tuple]
    out_leaves: tuple = (0,)
    emit: "Callable[[tuple, tuple], tuple] | None" = None
    supports_exclusive: bool = True
    sentinel: "int | None" = None
    transform: "Callable[[tuple, tuple], tuple] | None" = None
    finalize: "Callable[[tuple], tuple] | None" = None
    attn: "AttnMask | None" = None

    @property
    def n_leaves(self) -> int:
        return len(self.fills)


@dataclasses.dataclass(frozen=True)
class Monoid:
    """An associative operator with identity, over (tuples of) tensors.

    Attributes:
      name: registry key.
      combine: ``combine(left, right)`` — associative. Convention:
        ``left`` is the earlier (lower-index) element.
      identity_like: given one element, produce the identity element with
        matching shapes/dtypes.
      kernel_spec: optional :class:`KernelSpec` — the same monoid stated
        kernel-side, consumed by ``repro_torch.kernels.scan_engine``.
    """

    name: str
    combine: Callable[[Pytree, Pytree], Pytree]
    identity_like: Callable[[Pytree], Pytree]
    kernel_spec: "KernelSpec | None" = None

    def fold(self, elems: Pytree, axis: int = 0) -> Pytree:
        """Reduce ``elems`` along ``axis`` with this monoid (tree-shaped).

        Pairs ADJACENT elements at every level (like the paper's
        up-sweep), which preserves operand order — required for
        non-commutative monoids such as the affine recurrence.
        """
        n = tree_leaves(elems)[0].shape[axis]
        if n == 0:
            raise ValueError("cannot fold an empty axis")
        while n > 1:
            half = n // 2
            even = _stride2(elems, axis, 0, half)
            odd = _stride2(elems, axis, 1, half)
            merged = self.combine(even, odd)
            if n % 2:
                tail = _slice(elems, axis, 2 * half, n)
                merged = tree_map(
                    lambda m, t: torch.cat([m, t], dim=axis), merged, tail)
            elems, n = merged, half + (n % 2)
        return tree_map(lambda x: x.select(axis, 0), elems)


def _stride2(tree: Pytree, axis: int, start: int, count: int) -> Pytree:
    """Every other element along ``axis``: indices start, start+2, ..."""

    def f(x):
        idx = [slice(None)] * x.ndim
        idx[axis] = slice(start, start + 2 * count, 2)
        return x[tuple(idx)]

    return tree_map(f, tree)


def _slice(tree: Pytree, axis: int, lo: int, hi: int) -> Pytree:
    return tree_map(lambda x: x.narrow(axis, lo, hi - lo), tree)


# ---------------------------------------------------------------------------
# Kernel specs (flat-leaf monoids for the scan engine)
# ---------------------------------------------------------------------------


def accum_dtype(dt: torch.dtype) -> torch.dtype:
    """Accumulation dtype policy shared by every kernel registration:
    bf16/f16 accumulate in f32, int8/int16 in int32."""
    if dt in (torch.bfloat16, torch.float16):
        return torch.float32
    if dt in (torch.int8, torch.int16):
        return torch.int32
    return dt


def _sum_kcombine(left, right):
    return (left[0] + right[0],)


SUM_KERNEL = KernelSpec(
    name="sum",
    fills=(0,),
    combine=_sum_kcombine,
    elem_dtypes=lambda dts: (accum_dtype(dts[0]),),
    out_dtypes=lambda dts: (dts[0],),
)


def _segmented_sum_kcombine(left, right):
    v1, f1 = left
    v2, f2 = right
    # A flag anywhere on the right KILLS the incoming value (Blelloch's
    # segmented lift). Flags accumulate as a boolean OR of ``!= 0`` — NOT
    # a max, which a negative nonzero flag would silently escape.
    seen = torch.logical_or(f1 != 0, f2 != 0)
    return (torch.where(f2 != 0, v2, v1 + v2), seen.to(f1.dtype))


SEGMENTED_SUM_KERNEL = KernelSpec(
    name="segsum",
    fills=(0, 0),
    combine=_segmented_sum_kcombine,
    elem_dtypes=lambda dts: (accum_dtype(dts[0]), torch.int32),
    out_dtypes=lambda dts: (dts[0],),
)


def _affine_kcombine(left, right):
    a1, b1 = left
    a2, b2 = right
    return (a1 * a2, a2 * b1 + b2)


# (a, b) elements of h' = a*h + b, the earlier element on the left; the
# output is the b leaf (the state trajectory from h_0 = 0), in b's dtype.
AFFINE_KERNEL = KernelSpec(
    name="affine",
    fills=(1, 0),
    combine=_affine_kcombine,
    elem_dtypes=lambda dts: (accum_dtype(dts[0]), accum_dtype(dts[1])),
    out_dtypes=lambda dts: (dts[1],),
    out_leaves=(1,),
)


def mask_kernel_spec(sentinel: int) -> KernelSpec:
    """Compact-mask monoid: a 0/1 keep-mask cumsum with the predicate
    select FUSED into the writeback — surviving lanes emit their exclusive
    rank (global scatter destination once the chunk offset is combined),
    dropped lanes emit ``sentinel``. The monoid itself is integer SUM; the
    select emitter is what makes it stream compaction (paper §1).
    """

    def emit(elems, combined):
        m = elems[0]
        # combined is the carry-adjusted INCLUSIVE mask scan; minus the
        # element itself gives the exclusive rank (exact: integers).
        return (torch.where(m != 0, combined[0] - m, sentinel),)

    return KernelSpec(
        name="mask",
        fills=(0,),
        combine=_sum_kcombine,
        elem_dtypes=lambda dts: (torch.int32,),
        out_dtypes=lambda dts: (torch.int32,),
        emit=emit,
        supports_exclusive=False,
        sentinel=int(sentinel),
    )


# Finite stand-in for -inf in masked logits: keeps the softmax-pair
# max-carry NaN-free (``-inf - -inf`` is NaN; ``NEG_INF - NEG_INF`` is 0).
# Masked probabilities are additionally zeroed (``p = where(mask, ·, 0)``)
# so a fully-masked row yields l == 0 and finalizes to EXACTLY 0 — not
# the visited-column-count-dependent uniform softmax. That invariance is
# what makes the causal-aware KV bound bitwise-free: a skipped
# fully-masked block's element is the monoid identity ``(NEG_INF, 0, 0)``,
# and combining the identity in is bitwise a no-op.
NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class AttnMask:
    """The attention geometry of one fold: the logits scale, the
    causal / sliding-window / KV-length mask, the softcap and the block
    sizes that turn block ids into absolute positions (``None``: no such
    mask). ``with_stats`` makes the forward emit its ``(m, l)`` rows."""

    scale: float
    causal: bool = True
    window: "int | None" = None
    softcap: "float | None" = None
    kv_len: "int | None" = None
    block_q: int = 128
    block_k: int = 128
    with_stats: bool = False


def _softmax_acc_kcombine(left, right):
    """Carried-payload lift of the softmax pair: (m, l, acc) triples.

    ``m`` is the running row max, ``l`` the sum of ``exp(s - m)``, and
    ``acc`` the exp-weighted value accumulator — both sums rescale by
    ``exp(m_i - m)`` when the shared max moves. Associative; identity is
    ``(NEG_INF, 0, 0)`` (exp underflows to exactly 0 against any live
    max, and ``exp(0) = 1`` against another NEG_INF).
    """
    m1, l1, a1 = left
    m2, l2, a2 = right
    m = torch.maximum(m1, m2)
    alpha1 = torch.exp(m1 - m)
    alpha2 = torch.exp(m2 - m)
    return (m, l1 * alpha1 + l2 * alpha2, a1 * alpha1 + a2 * alpha2)


def _attn_block_logits(q, k, block_ids, *, scale, causal, window, softcap,
                       kv_len, block_q, block_k, matmul=torch.matmul):
    """Shared q·kᵀ logits tile for the attention forward AND backward
    transforms: ``(s, mask)`` where ``s`` is the scaled (and softcapped)
    logits block BEFORE masking and ``mask`` the combined
    causal/window/length liveness — stated once so the backward's
    recomputed logits are bit-identical to the forward's.

    ``block_ids`` convention (``KVBlocks``/``QBlocks`` layouts):
    ``(head, q_block, kv_block)`` — absolute row/col positions derive
    from the last two (integer tensors, broadcast against the tiles'
    leading axes). ``kv_len`` masks padded KV tails (``None``: no length
    mask beyond the geometry).
    """
    qi, kj = block_ids[-2], block_ids[-1]
    s = matmul(q, k.transpose(-1, -2)) * scale           # (..., bq, bk)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    dev = s.device
    qi = torch.as_tensor(qi, device=dev)[..., None, None]
    kj = torch.as_tensor(kj, device=dev)[..., None, None]
    rows = qi * block_q + torch.arange(s.shape[-2], device=dev)[:, None]
    cols = kj * block_k + torch.arange(s.shape[-1], device=dev)[None, :]
    mask = torch.ones(s.shape, dtype=torch.bool, device=dev)
    if kv_len is not None:
        mask = mask & (cols < kv_len)
    if causal:
        mask = mask & (cols <= rows)
    if window is not None:
        mask = mask & (cols > rows - window)
    return s, mask


def softmax_pair_kernel_spec(
    *,
    scale: float,
    causal: bool = True,
    window: "int | None" = None,
    softcap: "float | None" = None,
    kv_len: "int | None" = None,
    block_q: int = 128,
    block_k: int = 128,
    with_stats: bool = False,
    matmul=torch.matmul,
) -> KernelSpec:
    """Flash-attention monoid: online softmax with the value payload.

    The KV-block loop of flash attention is an inclusive FOLD over KV
    blocks of :data:`SOFTMAX_PAIR` with the weighted-value accumulator
    carried alongside. The per-block element is produced by the input
    transform — ``q·kᵀ`` logits with causal/window/softcap/length
    masking, folded within the block to its ``(m, l, acc)`` triple — so
    the engine's schedules never see an element array, only operands
    ``(q, k, v)`` tiles of shapes ``(bq, d)/(bk, d)/(bk, d)``.

    ``with_stats=True`` additionally emits the folded ``(m, l)`` row
    statistics (f32, trailing dim 1) after the normalized output — the
    residuals the backward folds need to reconstruct the softmax without
    materializing the attention matrix.

    Masked probabilities are zeroed, so a fully-masked row emits exactly
    0 (and zero gradients) rather than a uniform average over however
    many masked columns the grid happened to visit — the invariance that
    lets the causal-aware KV bound skip fully-masked blocks bitwise-free.

    ``matmul`` computes the cell's two products, ``q·kᵀ`` and ``p·v``
    (``cuda_fold.matmul_3xtf32`` states the float32 tensor-core form's
    arithmetic in plain PyTorch).
    """
    geom = AttnMask(scale=scale, causal=causal, window=window,
                    softcap=softcap, kv_len=kv_len, block_q=block_q,
                    block_k=block_k, with_stats=with_stats)

    def transform(ops, block_ids):
        q, k, v = (o.to(torch.float32) for o in ops)
        s, mask = _attn_block_logits(
            q, k, block_ids, scale=scale, causal=causal, window=window,
            softcap=softcap, kv_len=kv_len, block_q=block_q,
            block_k=block_k, matmul=matmul)
        s = torch.where(mask, s, NEG_INF)
        m = torch.amax(s, dim=-1, keepdim=True)           # (..., bq, 1)
        # exp underflows to exactly 0 at masked columns of LIVE rows, so
        # the where only changes fully-masked rows (m == NEG_INF there,
        # where exp(s - m) would be exp(0) = 1): they get l == 0.
        p = torch.where(mask, torch.exp(s - m), 0.0)      # (..., bq, bk)
        l = torch.sum(p, dim=-1, keepdim=True)            # (..., bq, 1)
        acc = matmul(p, v)                                # (..., bq, d)
        return (m, l, acc)

    def finalize(combined):
        m, l, acc = combined
        # l == 0 marks a fully-masked row (or an empty fold): acc is 0
        # there, and the guarded divide makes the output exactly 0.
        safe = torch.where(l == 0.0, 1.0, l)
        if with_stats:
            return (acc / safe, m, l)
        return (acc / safe,)

    def out_dtypes(dts):
        if with_stats:
            return (dts[0], torch.float32, torch.float32)
        return (dts[0],)

    return KernelSpec(
        name="softmax_pair",
        fills=(NEG_INF, 0, 0),
        combine=_softmax_acc_kcombine,
        elem_dtypes=lambda dts: (torch.float32,) * 3,
        out_dtypes=out_dtypes,
        supports_exclusive=False,
        transform=transform,
        finalize=finalize,
        attn=geom,
    )


def _identity_finalize(combined):
    return tuple(combined)


def _attn_bwd_ds(ops, block_ids, *, scale, causal, window, softcap, kv_len,
                 block_q, block_k, matmul=torch.matmul):
    """Shared backward tile: recomputed probabilities ``p`` and masked
    logit gradients ``ds`` for one (q-block, kv-block) cell.

    ``ops`` are f32 tiles ``(q, k, v, do, m, l, delta)`` where ``m``/``l``
    are the forward's saved row statistics and ``delta = rowsum(dO ⊙ O)``
    — the standard flash backward: ``p = exp(s - m)/l`` (no materialized
    attention matrix outside this tile), ``dp = dO·Vᵀ``,
    ``ds = p ⊙ (dp - delta)``, with the softcap chain rule
    ``tanh' = 1 - (s/cap)²`` applied on the recomputed capped logits.
    ``matmul`` computes the two products.
    """
    q, k, v, do, m, l, delta = ops
    s, mask = _attn_block_logits(
        q, k, block_ids, scale=scale, causal=causal, window=window,
        softcap=softcap, kv_len=kv_len, block_q=block_q, block_k=block_k,
        matmul=matmul)
    sm = torch.where(mask, s, NEG_INF)
    safe_l = torch.where(l == 0.0, 1.0, l)
    p = torch.where(mask, torch.exp(sm - m), 0.0) / safe_l  # (..., bq, bk)
    dp = matmul(do, v.transpose(-1, -2))                    # (..., bq, bk)
    ds = p * (dp - delta)
    if softcap is not None:
        ds = ds * (1.0 - (s / softcap) ** 2)                # tanh'
    return p, ds


def _dsum_kcombine(left, right):
    return tuple(a + b for a, b in zip(left, right))


def softmax_pair_bwd_dq_kernel_spec(
    *,
    scale: float,
    causal: bool = True,
    window: "int | None" = None,
    softcap: "float | None" = None,
    kv_len: "int | None" = None,
    block_q: int = 128,
    block_k: int = 128,
    matmul=torch.matmul,
) -> KernelSpec:
    """Flash-backward dq: a SUM fold over KV blocks (``KVBlocks``).

    Operands ``(q, k, v, do, m, l, delta)``; each block contributes
    ``scale · ds @ K`` to the carried (bq, d) dq accumulator. Plain sum
    monoid — all the attention structure lives in the transform, so the
    engine's fold schedules (carry accumulate / split-KV decoupled) run
    it unchanged. ``matmul`` computes the cell's three products
    (``cuda_fold.matmul_3xtf32`` states the float32 tensor-core form's
    arithmetic in plain PyTorch).
    """
    cfg = dict(scale=scale, causal=causal, window=window, softcap=softcap,
               kv_len=kv_len, block_q=block_q, block_k=block_k)

    def transform(ops, block_ids):
        ops = tuple(o.to(torch.float32) for o in ops)
        _, ds = _attn_bwd_ds(ops, block_ids, matmul=matmul, **cfg)
        dq = matmul(ds, ops[1]) * scale                   # (..., bq, d)
        return (dq,)

    return KernelSpec(
        name="softmax_bwd_dq",
        fills=(0,),
        combine=_dsum_kcombine,
        elem_dtypes=lambda dts: (torch.float32,),
        out_dtypes=lambda dts: (dts[0],),
        supports_exclusive=False,
        transform=transform,
        finalize=_identity_finalize,
        attn=AttnMask(**cfg),
    )


def softmax_pair_bwd_dkv_kernel_spec(
    *,
    scale: float,
    causal: bool = True,
    window: "int | None" = None,
    softcap: "float | None" = None,
    kv_len: "int | None" = None,
    block_q: int = 128,
    block_k: int = 128,
    matmul=torch.matmul,
) -> KernelSpec:
    """Flash-backward dk/dv: a SUM fold over q blocks (``QBlocks``).

    The transposed organization: for each KV block the fold walks the
    (group × q-block) axis — GQA head summation included, since every q
    head mapping to this KV head is part of the fold — accumulating
    ``dk += scale · dsᵀ @ Q`` and ``dv += pᵀ @ dO`` into the carried
    (bk, d) pair. ``matmul`` computes the cell's four products
    (``cuda_fold.matmul_3xtf32`` states the float32 tensor-core form's
    arithmetic in plain PyTorch).
    """
    cfg = dict(scale=scale, causal=causal, window=window, softcap=softcap,
               kv_len=kv_len, block_q=block_q, block_k=block_k)

    def transform(ops, block_ids):
        ops = tuple(o.to(torch.float32) for o in ops)
        p, ds = _attn_bwd_ds(ops, block_ids, matmul=matmul, **cfg)
        q, do = ops[0], ops[3]
        dk = matmul(ds.transpose(-1, -2), q) * scale        # (..., bk, d)
        dv = matmul(p.transpose(-1, -2), do)                # (..., bk, d)
        return (dk, dv)

    return KernelSpec(
        name="softmax_bwd_dkv",
        fills=(0, 0),
        combine=_dsum_kcombine,
        elem_dtypes=lambda dts: (torch.float32,) * 2,
        out_dtypes=lambda dts: (dts[1], dts[2]),
        supports_exclusive=False,
        transform=transform,
        finalize=_identity_finalize,
        attn=AttnMask(**cfg),
    )


# ---------------------------------------------------------------------------
# Standard monoids
# ---------------------------------------------------------------------------


SUM = Monoid("sum", lambda a, b: tree_map(torch.add, a, b),
             lambda x: tree_map(torch.zeros_like, x),
             kernel_spec=SUM_KERNEL)

PROD = Monoid(
    "prod",
    lambda a, b: tree_map(torch.mul, a, b),
    lambda x: tree_map(torch.ones_like, x),
)


def _min_value(dtype):
    if dtype.is_floating_point:
        return -float("inf")
    return torch.iinfo(dtype).min


def _max_value(dtype):
    if dtype.is_floating_point:
        return float("inf")
    return torch.iinfo(dtype).max


MAX = Monoid(
    "max",
    lambda a, b: tree_map(torch.maximum, a, b),
    lambda x: tree_map(lambda v: torch.full_like(v, _min_value(v.dtype)), x),
)

MIN = Monoid(
    "min",
    lambda a, b: tree_map(torch.minimum, a, b),
    lambda x: tree_map(lambda v: torch.full_like(v, _max_value(v.dtype)), x),
)


# Affine monoid: elements (a, b) represent x -> a*x + b (elementwise).
# Composition (earlier then later): (a1, b1) then (a2, b2) is
# (a1*a2, a2*b1 + b2); identity (1, 0). The inclusive scan's b component
# is the trajectory of h_t = a_t * h_{t-1} + b_t from h_0 = 0.
AFFINE = Monoid(
    "affine",
    _affine_kcombine,
    lambda x: (torch.ones_like(x[0]), torch.zeros_like(x[1])),
    kernel_spec=AFFINE_KERNEL,
)


# Online-softmax monoid: elements (m, s) where m is a running max and s the
# sum of exp(x - m). Flash attention's KV-block loop is an inclusive scan of
# these pairs — the paper's blocked-scan pattern with this monoid.
def _softmax_combine(left, right):
    m1, s1 = left
    m2, s2 = right
    m = torch.maximum(m1, m2)
    s = s1 * torch.exp(m1 - m) + s2 * torch.exp(m2 - m)
    return (m, s)


# Kernel-side, the registration is ``softmax_pair_kernel_spec`` — a
# config-dependent factory (like ``mask_kernel_spec``) because masking
# geometry is baked into the per-block input transform, so the Monoid
# carries no static ``kernel_spec``.
SOFTMAX_PAIR = Monoid(
    "softmax_pair",
    _softmax_combine,
    lambda x: (torch.full_like(x[0], -float("inf")), torch.zeros_like(x[1])),
)


# Matrix-affine monoid for matrix-state recurrences (mLSTM, a general
# SSM): elements (a, B) with a scalar (or broadcastable) decay a and a
# matrix update B, H' = a * H + B. AFFINE's composition law, with a
# broadcast over B; no kernel spec.
MATRIX_AFFINE = Monoid(
    "matrix_affine",
    _affine_kcombine,
    lambda x: (torch.ones_like(x[0]), torch.zeros_like(x[1])),
)


REGISTRY: dict[str, Monoid] = {
    m.name: m for m in (SUM, PROD, MAX, MIN, AFFINE, SOFTMAX_PAIR,
                        MATRIX_AFFINE)}


def get(op: "str | Monoid") -> Monoid:
    """A registered monoid by name, or ``op`` itself when it is a Monoid
    (how the segmented lifts of ``segmented()`` reach the scans)."""
    if isinstance(op, Monoid):
        return op
    try:
        return REGISTRY[op]
    except KeyError:
        raise ValueError(
            f"unknown monoid {op!r}; known: {sorted(REGISTRY)}") from None


def segmented(base: Monoid) -> Monoid:
    """Lift ``base`` into its segmented variant.

    Elements are ``(flag, value)`` where ``flag != 0`` marks the start of
    a new segment. The scan of the lifted monoid restarts at every flag —
    the standard construction (Blelloch 1990), used for MoE per-expert
    ranking and for packed-sequence boundaries.
    """

    def combine(left, right):
        f1, v1 = left
        f2, v2 = right
        both = base.combine(v1, v2)
        keep_right = tree_map(
            lambda b, r: torch.where(_bcast(f2, r), r, b), both, v2)
        # OR of ``!= 0``, not max: any nonzero flag (negative included)
        # must keep marking the segment start through later combines.
        seen = torch.logical_or(f1 != 0, f2 != 0).to(f1.dtype)
        return (seen, keep_right)

    def identity_like(x):
        f, v = x
        return (torch.zeros_like(f), base.identity_like(v))

    kspec = SEGMENTED_SUM_KERNEL if base.name == "sum" else None
    return Monoid(f"segmented_{base.name}", combine, identity_like,
                  kernel_spec=kspec)


def _bcast(flag, val):
    """Broadcast a flag tensor against a value tensor from the left."""
    extra = val.ndim - flag.ndim
    if extra > 0:
        flag = flag.reshape(flag.shape + (1,) * extra)
    return flag != 0
