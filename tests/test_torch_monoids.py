"""The monoid laws of tests/test_monoids.py, re-run on the port's
``repro_torch.core.scan.assoc`` (every entry of its ``REGISTRY``,
``matrix_affine`` included), plus each registered combine against the
reference's on the same numpy elements: bitwise for the sums, max, min,
products and the affine pairs (elementwise products and sums in the same
order), within 1e-6 relative for the softmax pair (the two libraries'
``exp`` may differ in the last place)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core.scan import assoc as jassoc
from repro_torch.core.scan import assoc, reference

_f = st.floats(-10, 10, width=32)
_pos = st.floats(0.125, 2.0, width=32)
_quad = st.tuples(_f, _f, _f, _f)
_maybe_masked = st.sampled_from(["live", "masked"])


def _f32(v):
    return torch.tensor(v, dtype=torch.float32)


def _close(a, b, tol=1e-3):
    np.testing.assert_allclose(a.double().numpy(), b.double().numpy(),
                               rtol=tol, atol=tol)


def _tclose(ta, tb, tol=1e-3):
    for a, b in zip(assoc.tree_leaves(ta), assoc.tree_leaves(tb)):
        _close(a, b, tol)


@pytest.mark.parametrize("name", ["sum", "max", "min", "prod"])
@given(x=_f, y=_f, z=_f)
@settings(max_examples=40, deadline=None)
def test_scalar_monoid_associativity(name, x, y, z):
    m = assoc.get(name)
    a, b, c = (_f32(v) for v in (x, y, z))
    _tclose(m.combine(m.combine(a, b), c), m.combine(a, m.combine(b, c)))


@pytest.mark.parametrize("name", ["sum", "max", "min", "prod"])
@given(x=_f)
@settings(max_examples=20, deadline=None)
def test_scalar_monoid_identity(name, x):
    m = assoc.get(name)
    a = _f32(x)
    e = m.identity_like(a)
    _tclose(m.combine(e, a), a)
    _tclose(m.combine(a, e), a)


@given(a1=_pos, b1=_f, a2=_pos, b2=_f, a3=_pos, b3=_f)
@settings(max_examples=40, deadline=None)
def test_affine_associativity(a1, b1, a2, b2, a3, b3):
    m = assoc.AFFINE
    e1, e2, e3 = ((_f32(a), _f32(b)) for a, b in ((a1, b1), (a2, b2),
                                                  (a3, b3)))
    _tclose(m.combine(m.combine(e1, e2), e3),
            m.combine(e1, m.combine(e2, e3)), tol=1e-2)


@given(a=_pos, b=_f)
@settings(max_examples=20, deadline=None)
def test_affine_identity(a, b):
    m = assoc.AFFINE
    e = (_f32(a), _f32(b))
    ident = m.identity_like(e)
    _tclose(m.combine(ident, e), e)
    _tclose(m.combine(e, ident), e)


@given(m1=_f, s1=_pos, m2=_f, s2=_pos, m3=_f, s3=_pos)
@settings(max_examples=40, deadline=None)
def test_softmax_pair_associativity(m1, s1, m2, s2, m3, s3):
    m = assoc.SOFTMAX_PAIR
    e1, e2, e3 = ((_f32(a), _f32(b)) for a, b in ((m1, s1), (m2, s2),
                                                  (m3, s3)))
    _tclose(m.combine(m.combine(e1, e2), e3),
            m.combine(e1, m.combine(e2, e3)), tol=1e-2)


def test_softmax_pair_equals_logsumexp():
    """Scanning the softmax-pair monoid = running (max, sumexp)."""
    xs = torch.from_numpy(np.random.default_rng(0).standard_normal(64)
                          .astype(np.float32))
    m_run, s_run = reference.scan_ref((xs, torch.ones_like(xs)),
                                      assoc.SOFTMAX_PAIR, axis=0)
    lse = m_run.double() + torch.log(s_run.double())
    want = [torch.logsumexp(xs[:i + 1].double(), 0).item()
            for i in range(64)]
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-5, atol=1e-5)


def test_fold_order_preserved_noncommutative():
    """Monoid.fold respects operand order (affine is non-commutative)."""
    rng = np.random.default_rng(4)
    a = torch.from_numpy(rng.uniform(0.5, 1.5, 13).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(13).astype(np.float32))
    fa, fb = assoc.AFFINE.fold((a, b), axis=0)
    sa, sb = _f32(1.0), _f32(0.0)
    for i in range(13):
        sa, sb = assoc.AFFINE.combine((sa, sb), (a[i], b[i]))
    _close(fa, sa, 1e-4)
    _close(fb, sb, 1e-4)


@given(st.lists(st.tuples(st.booleans(), _f), min_size=1, max_size=60))
@settings(max_examples=25, deadline=None)
def test_segmented_lift_matches_python(pairs):
    """Segmented-sum scan == a python loop with resets."""
    flags = torch.tensor([int(f) for f, _ in pairs], dtype=torch.int32)
    vals = torch.tensor([v for _, v in pairs], dtype=torch.float32)
    _, out = reference.scan_ref((flags, vals), assoc.segmented(assoc.SUM),
                                axis=0)
    acc, want = 0.0, []
    for f, v in pairs:
        acc = v if f else acc + v
        want.append(acc)
    np.testing.assert_allclose(out.double().numpy(), want, rtol=1e-3,
                               atol=1e-3)


# ---------------------------------------------------------------------------
# registry-wide law sweep: every entry of the port's REGISTRY, including
# SOFTMAX_PAIR and MATRIX_AFFINE
# ---------------------------------------------------------------------------


def _element_for(name, vals, lib=torch):
    """One monoid element for ``name`` from 4 drawn floats, in torch or
    (``lib=jnp``) as the reference test builds it."""
    f32 = _f32 if lib is torch else jnp.float32
    x, y, z, w = (f32(v) for v in vals)
    if name in ("sum", "max", "min", "prod"):
        return x
    if name == "affine":
        return (lib.abs(x) + f32(0.125), y)
    if name == "matrix_affine":
        # a scalar decay broadcast over a (2, 2) matrix update
        a = lib.abs(x) + f32(0.125)
        B = lib.stack([lib.stack([y, z]), lib.stack([z, w])])
        bcast = (lambda t: t.expand(2, 2)) if lib is torch else \
            (lambda t: jnp.broadcast_to(t, (2, 2)))
        return (bcast(a), B)
    if name == "softmax_pair":
        return (x, lib.abs(y) + f32(0.125))
    raise AssertionError(f"unhandled registry monoid {name!r}")


def test_registry_matches_reference():
    assert sorted(assoc.REGISTRY) == sorted(jassoc.REGISTRY)
    assert "matrix_affine" in assoc.REGISTRY
    assert assoc.MATRIX_AFFINE.kernel_spec is None


@pytest.mark.parametrize("name", sorted(assoc.REGISTRY))
@given(e1=_quad, e2=_quad, e3=_quad)
@settings(max_examples=25, deadline=None)
def test_registry_monoid_associativity(name, e1, e2, e3):
    m = assoc.REGISTRY[name]
    a, b, c = (_element_for(name, e) for e in (e1, e2, e3))
    _tclose(m.combine(m.combine(a, b), c), m.combine(a, m.combine(b, c)),
            tol=1e-2)


@pytest.mark.parametrize("name", sorted(assoc.REGISTRY))
@given(e=_quad)
@settings(max_examples=15, deadline=None)
def test_registry_monoid_identity(name, e):
    m = assoc.REGISTRY[name]
    a = _element_for(name, e)
    ident = m.identity_like(a)
    _tclose(m.combine(ident, a), a)
    _tclose(m.combine(a, ident), a)


@pytest.mark.parametrize("name", sorted(assoc.REGISTRY))
def test_registry_combine_matches_reference(name):
    """Each registered combine and identity against the reference's on
    the same elements (normal floats drawn from a seed)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    for _ in range(20):
        e1, e2 = (tuple(rng.uniform(-10, 10, 4).astype(np.float32).tolist())
                  for _ in range(2))
        got = assoc.REGISTRY[name].combine(_element_for(name, e1),
                                           _element_for(name, e2))
        want = jassoc.REGISTRY[name].combine(
            _element_for(name, e1, jnp), _element_for(name, e2, jnp))
        ident = assoc.REGISTRY[name].identity_like(_element_for(name, e1))
        ident_j = jassoc.REGISTRY[name].identity_like(
            _element_for(name, e1, jnp))
        for g, w in zip(assoc.tree_leaves(got) + assoc.tree_leaves(ident),
                        jax.tree.leaves(want) + jax.tree.leaves(ident_j)):
            g, w = g.numpy(), np.asarray(w)
            assert g.shape == w.shape and g.dtype == w.dtype
            if name == "softmax_pair":
                np.testing.assert_allclose(g, w, rtol=1e-6)
            else:
                np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# the NEG_INF finite-mask invariant (softmax max-carry edge elements)
# ---------------------------------------------------------------------------


@given(k1=_maybe_masked, k2=_maybe_masked, k3=_maybe_masked,
       e1=_quad, e2=_quad, e3=_quad)
@settings(max_examples=25, deadline=None)
def test_softmax_pair_neg_inf_edges_stay_finite(k1, k2, k3, e1, e2, e3):
    """Fully masked blocks enter the fold as (NEG_INF, bk) elements; any
    mix of masked and live operands combines NaN-free and associatively."""
    m = assoc.SOFTMAX_PAIR

    def elem(kind, vals):
        mm, ss = _element_for("softmax_pair", vals)
        if kind == "masked":
            mm = _f32(assoc.NEG_INF)
        return (mm, ss)

    a, b, c = elem(k1, e1), elem(k2, e2), elem(k3, e3)
    left = m.combine(m.combine(a, b), c)
    right = m.combine(a, m.combine(b, c))
    for leaf in (*left, *right):
        assert not bool(torch.isnan(leaf)), (k1, k2, k3)
    _tclose(left, right, tol=1e-2)


def test_neg_inf_finite_sentinel_vs_true_inf():
    """Why NEG_INF is finite: a true -inf max-carry NaNs the rescale
    (``-inf - -inf``); the -1e30 sentinel keeps exp(0) = 1 arithmetic."""
    m = assoc.SOFTMAX_PAIR
    masked = (_f32(assoc.NEG_INF), _f32(4.0))
    out = m.combine(masked, masked)
    assert not any(bool(torch.isnan(leaf)) for leaf in out)
    np.testing.assert_allclose(float(out[1]), 8.0)
    inf_masked = (_f32(-float("inf")), _f32(4.0))
    assert bool(torch.isnan(m.combine(inf_masked, inf_masked)[1]))


# ---------------------------------------------------------------------------
# kernel-side carried payload: the (m, l, acc) triple of the flash spec
# ---------------------------------------------------------------------------


def _payload_elem(vals, masked=False):
    x, y, z, w = (_f32(v) for v in vals)
    mm = _f32(assoc.NEG_INF) if masked else x
    return (mm[None], (torch.abs(y) + 0.125)[None], torch.stack([z, w]))


@given(k1=_maybe_masked, k2=_maybe_masked, k3=_maybe_masked,
       e1=_quad, e2=_quad, e3=_quad)
@settings(max_examples=25, deadline=None)
def test_softmax_payload_triple_associativity(k1, k2, k3, e1, e2, e3):
    """The kernel spec's combine carries the weighted-value accumulator
    beside the (m, l) pair; the lifted triple stays associative (masked
    operands included), or the split-KV fold would leave the carry's."""
    spec = assoc.softmax_pair_kernel_spec(scale=1.0)
    a = _payload_elem(e1, k1 == "masked")
    b = _payload_elem(e2, k2 == "masked")
    c = _payload_elem(e3, k3 == "masked")
    left = spec.combine(spec.combine(a, b), c)
    right = spec.combine(a, spec.combine(b, c))
    for leaf in (*left, *right):
        assert not bool(torch.any(torch.isnan(leaf)))
    _tclose(left, right, tol=1e-2)


@given(e=_quad)
@settings(max_examples=15, deadline=None)
def test_softmax_payload_identity_fills(e):
    """The spec's fills (NEG_INF, 0, 0) are a two-sided identity."""
    spec = assoc.softmax_pair_kernel_spec(scale=1.0)
    a = _payload_elem(e)
    ident = tuple(torch.full_like(leaf, f) for leaf, f in zip(a, spec.fills))
    _tclose(spec.combine(ident, a), a)
    _tclose(spec.combine(a, ident), a)
