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
compact-mask spec and the affine spec; the softmax spec is not ported yet
(ROADMAP).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

Pytree = Any


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


REGISTRY: dict[str, Monoid] = {m.name: m for m in (SUM, PROD, MAX, MIN, AFFINE)}


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
