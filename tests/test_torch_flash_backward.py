"""The port's flash attention backward held against the JAX reference.

``repro_torch.kernels.flash_attention.flash_attention`` is differentiable
through a ``torch.autograd.Function`` whose backward runs two more engine
folds (dq over ``KVBlocks``, dk/dv over the transposed ``QBlocks``). The
same numpy inputs and cotangents go through ``jax.grad`` of the
reference (Pallas in interpret mode) and ``torch.autograd.grad`` of the
port (the plain fold versions on CPU tensors), over the reference's
8-config grid under both fold schedules.

Tolerances are the reference tests' own: 1e-4 for float32 gradients
(tests/test_flash_backward.py:102), 1e-5 between the two schedules
(:107), 0.15 for bfloat16 gradients (:210). Fully masked rows must give
exactly 0 and zero gradients, and the bounds knob must not move a bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jops
from repro.kernels.flash_attention import ref as jref
from repro.kernels.flash_attention.flash_attention import (
    flash_attention_bwd_kernel as j_bwd_kernel)
from repro.kernels.flash_attention.flash_attention import (
    flash_attention_kernel as j_kernel)
from repro_torch.kernels.flash_attention import ops, ref
from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention_bwd_kernel, flash_attention_kernel)

SCHEDULES = ("carry", "decoupled")
GRAD_TOL = 1e-4     # tests/test_flash_backward.py:102
SCHED_TOL = 1e-5    # tests/test_flash_backward.py:107
BF16_GRAD_TOL = 0.15  # tests/test_flash_backward.py:210

# (name, B, Hkv, group, Tq, Tk, D, causal, window, softcap, bq, bk)
CONFIGS = [
    ("causal", 2, 2, 1, 256, 256, 32, True, None, None, 128, 128),
    ("noncausal", 1, 2, 1, 256, 256, 32, False, None, None, 128, 128),
    ("window", 1, 2, 1, 256, 256, 32, True, 64, None, 64, 128),
    ("softcap", 1, 1, 1, 256, 256, 32, True, None, 30.0, 128, 128),
    ("gqa2", 2, 2, 2, 256, 256, 32, True, None, None, 128, 128),
    ("gqa4_window_cap", 1, 2, 4, 256, 256, 16, True, 96, 20.0, 128, 64),
    ("ragged_kv", 1, 2, 1, 300, 300, 32, True, None, None, 128, 128),
    ("ragged_kv_noncausal", 1, 1, 1, 200, 300, 16, False, None, None,
     128, 128),
]


def _qkv(seed, B, Hq, Hkv, Tq, Tk, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Hq, Tq, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, Tk, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, Tk, D)).astype(np.float32))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol,
                               err_msg=msg)


def _port_grads(q, k, v, dtype=torch.float32, **kw):
    """Gradients of sum(out²) (a cotangent that varies per element) of
    the port's flash attention."""
    ts = [torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v)]
    out = ops.flash_attention(*ts, **kw)
    return torch.autograd.grad((out.float() ** 2).sum(), ts)


def _ref_grads(q, k, v, dtype=jnp.float32, **kw):
    def loss(q, k, v):
        out = jops.flash_attention(q, k, v, interpret=True, **kw)
        return jnp.sum(out.astype(jnp.float32) ** 2)

    return jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(x, dtype) for x in (q, k, v)))


@pytest.mark.parametrize("cfg", CONFIGS, ids=[c[0] for c in CONFIGS])
def test_grad_wall(cfg):
    """dq/dk/dv under both schedules against the reference's, and carry
    against decoupled."""
    name, B, Hkv, g, Tq, Tk, D, causal, window, softcap, bq, bk = cfg
    q, k, v = _qkv(sum(map(ord, name)), B, Hkv * g, Hkv, Tq, Tk, D)
    kw = dict(scale=D ** -0.5, causal=causal, window=window,
              softcap=softcap, block_q=bq, block_k=bk)
    port = {s: _port_grads(q, k, v, schedule=s, **kw) for s in SCHEDULES}
    for s in SCHEDULES:
        want = _ref_grads(q, k, v, schedule=s, **kw)
        for leaf, (a, b) in enumerate(zip(port[s], want)):
            _close(a, b, GRAD_TOL, f"{name}/{s} leaf {leaf}")
    for a, b in zip(port["carry"], port["decoupled"]):
        _close(a, b, SCHED_TOL)


@pytest.mark.parametrize("splits", [1, 2, 4, 8])
def test_grad_split_invariance(splits):
    """The decoupled backward does not depend on the chunk count."""
    q, k, v = _qkv(7, 1, 2, 1, 128, 1024, 16)
    kw = dict(scale=0.25, causal=True, schedule="decoupled",
              kv_splits=splits, block_k=128)
    got = _port_grads(q, k, v, **kw)
    for a, b in zip(got, _ref_grads(q, k, v, **kw)):
        _close(a, b, GRAD_TOL)
    for a, b in zip(got, _port_grads(q, k, v, scale=0.25,
                                     schedule="carry")):
        _close(a, b, SCHED_TOL)


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_grads_all_masked_rows(schedule):
    """Rows whose whole KV band is masked emit 0 and contribute ZERO
    gradient everywhere — no NaN, no leak — as in the reference."""
    q, k, v = (x[0] for x in _qkv(17, 2, 2, 2, 256, 256, 16))
    kw = dict(scale=0.25, causal=True, window=32, kv_len=64, block_q=64,
              block_k=64, schedule=schedule)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out, m, l = flash_attention_kernel(tq, tk, tv, return_stats=True, **kw)
    g = torch.zeros_like(out)
    g[:, 96:] = 2.0 * out[:, 96:] + 1.0
    delta = (g * out).sum(-1, keepdim=True)
    grads = flash_attention_bwd_kernel(tq, tk, tv, g, m, l, delta, **kw)
    jout, jm, jl = j_kernel(*(jnp.asarray(x) for x in (q, k, v)),
                            return_stats=True, interpret=True, **kw)
    _close(out, jout, SCHED_TOL)
    _close(m, jm, SCHED_TOL)
    _close(l, jl, SCHED_TOL)
    for name, arr in zip(("dq", "dk", "dv"), grads):
        assert not bool(torch.isnan(arr).any()), name
        assert float(arr.abs().max()) == 0.0, name


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_bwd_kernel_matches_reference(schedule):
    """The backward kernels with the ops wrapper's padded-row convention
    (m = +1e30, l = 0, dO = delta = 0 on rows past Tq) against the
    reference's, GQA group 2."""
    rng = np.random.default_rng(41)
    Tq, Tk, D = 192, 256, 16
    q = rng.standard_normal((4, Tq, D)).astype(np.float32)
    k = rng.standard_normal((2, Tk, D)).astype(np.float32)
    v = rng.standard_normal((2, Tk, D)).astype(np.float32)
    do = rng.standard_normal((4, Tq, D)).astype(np.float32)
    kw = dict(group=2, scale=0.25, causal=True, softcap=15.0, block_q=64,
              block_k=128, schedule=schedule)
    out, m, l = flash_attention_kernel(
        *(torch.from_numpy(x) for x in (q, k, v)), return_stats=True, **kw)
    m, l = m.numpy().copy(), l.numpy().copy()
    do[:, 160:] = 0.0
    m[:, 160:], l[:, 160:] = 1e30, 0.0
    delta = (do * out.numpy()).sum(-1, keepdims=True)
    ops_ = (q, k, v, do, m, l, delta)
    got = flash_attention_bwd_kernel(*(torch.from_numpy(x) for x in ops_),
                                     **kw)
    want = j_bwd_kernel(*(jnp.asarray(x) for x in ops_), interpret=True,
                        **kw)
    for a, b in zip(got, want):
        assert bool(torch.isfinite(a).all())
        _close(a, b, GRAD_TOL)


@pytest.mark.parametrize("oracle", ["mha_ref", "blockwise_ref"])
def test_reference_oracles_fully_masked_guarded(oracle):
    """The port's oracles keep the reference's guard: fully masked rows
    are exactly 0 forward with exactly 0 gradients."""
    fn = getattr(ref, oracle)
    q, k, v = (torch.from_numpy(x[0]).requires_grad_()
               for x in _qkv(3, 1, 2, 2, 128, 128, 16))
    kw = dict(scale=0.25, causal=True, window=16, kv_len=32)
    out = fn(q, k, v, **kw)
    assert bool((out[:, 48:] == 0).all())
    assert not bool(torch.isnan(out).any())
    grads = torch.autograd.grad((out[:, 48:] ** 2).sum(), (q, k, v))
    for g in grads:
        assert not bool(torch.isnan(g).any())
        assert float(g.abs().max()) == 0.0


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_grads_bf16(schedule):
    """bf16 operands: gradients come back in bf16, finite, and track the
    reference's bf16 gradients and its f32 blockwise oracle's."""
    q, k, v = _qkv(13, 1, 4, 2, 128, 128, 32)
    got = _port_grads(q, k, v, dtype=torch.bfloat16, scale=32 ** -0.5,
                      schedule=schedule)
    want = _ref_grads(q, k, v, dtype=jnp.bfloat16, scale=32 ** -0.5,
                      schedule=schedule)
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    blk = ref.blockwise_ref(ts[0].reshape(4, 128, 32),
                            ts[1].reshape(2, 128, 32),
                            ts[2].reshape(2, 128, 32), group=2,
                            scale=32 ** -0.5, block_k=64)
    oracle = torch.autograd.grad((blk ** 2).sum(), ts)
    for a, b, c in zip(got, want, oracle):
        assert a.dtype == torch.bfloat16
        assert bool(torch.isfinite(a.float()).all())
        _close(a, b, BF16_GRAD_TOL)
        _close(a, c, BF16_GRAD_TOL)


def test_autograd_function_paths():
    """Without a gradient the forward runs without the statistics; with
    one it saves (m, l): the outputs are bitwise equal, and a gradient
    through the autograd function matches the blockwise oracle's."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(23, 1, 2, 1, 128, 128, 16))
    with torch.no_grad():
        plain = ops.flash_attention(q, k, v, scale=0.25)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    out = ops.flash_attention(qg, kg, vg, scale=0.25)
    assert out.grad_fn is not None and plain.grad_fn is None
    assert torch.equal(out.detach(), plain)
    got = torch.autograd.grad((out ** 2).sum(), (qg, kg, vg))
    qb, kb, vb = (t.clone().requires_grad_() for t in (q, k, v))
    blk = ref.blockwise_ref(qb.reshape(2, 128, 16), kb.reshape(1, 128, 16),
                            vb.reshape(1, 128, 16), group=2, scale=0.25,
                            block_k=64).reshape(1, 2, 128, 16)
    want = torch.autograd.grad((blk ** 2).sum(), (qb, kb, vb))
    for a, b in zip(got, want):
        _close(a, b, GRAD_TOL)
    _close(jref.mha_ref(jnp.asarray(q.numpy().reshape(2, 128, 16)),
                        jnp.asarray(k.numpy().reshape(1, 128, 16)),
                        jnp.asarray(v.numpy().reshape(1, 128, 16)),
                        group=2, scale=0.25).reshape(1, 2, 128, 16),
           plain, 2e-3)


# float32 dq and dk/dv on the tensor cores (fold_dq_tf32, fold_dkv_tf32):
# their arithmetic, three TF32 products a product
# (cuda_fold.matmul_3xtf32), through the plain dq and dk/dv folds against
# the reference. (name, Hkv, group, Tq, Tk, D, causal, window, softcap,
# kv_len, bq, bk)
TF32_CONFIGS = [
    ("causal_gqa2", 2, 2, 256, 256, 32, True, None, None, None, 128, 128),
    ("window_bq64", 1, 2, 256, 256, 64, True, 96, None, None, 64, 64),
    ("softcap_gqa4", 1, 4, 256, 256, 32, True, None, 20.0, None, 128, 64),
    ("noncausal_kv_tail", 2, 1, 128, 256, 64, False, None, None, 200, 64,
     128),
    ("d256_softcap_gqa2", 1, 2, 128, 256, 256, True, None, 50.0, None, 128,
     128),
]


@functools.lru_cache(maxsize=None)
def _tf32_reference(cfg):
    """The float32 operands (q, k, v, dO, m, l, delta) of ``cfg`` from
    seeded numpy and the port's forward, the keywords, and the
    reference's (dq, dk, dv)."""
    name, hkv, g, tq, tk, d, causal, window, softcap, kv_len, bq, bk = cfg
    rng = np.random.default_rng(sum(map(ord, name)))
    q, do = (rng.standard_normal((hkv * g, tq, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((hkv, tk, d)).astype(np.float32)
            for _ in range(2))
    kw = dict(group=g, scale=d ** -0.5, causal=causal, window=window,
              softcap=softcap, kv_len=kv_len, block_q=bq, block_k=bk)
    out, m, l = flash_attention_kernel(
        *(torch.from_numpy(x) for x in (q, k, v)), return_stats=True, **kw)
    m, l = m.numpy(), l.numpy()
    delta = (do * out.numpy()).sum(-1, keepdims=True)
    ops_ = (q, k, v, do, m, l, delta)
    want = j_bwd_kernel(*(jnp.asarray(x) for x in ops_), interpret=True,
                        **kw)
    return ops_, kw, tuple(np.asarray(w) for w in want)


def _tf32_case(cfg, matmul, which="dkv"):
    """(the port's dk, dv — or dq — through the plain fold with
    ``matmul``, by schedule, and the reference's)."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        backward_folds)
    from repro_torch.kernels.scan_engine import schedules
    from repro_torch.core.scan.assoc import (
        softmax_pair_bwd_dkv_kernel_spec, softmax_pair_bwd_dq_kernel_spec)
    ops_, kw, want = _tf32_reference(cfg)
    cfg_ = {n: kw[n] for n in ("scale", "causal", "window", "softcap",
                               "kv_len", "block_q", "block_k")}
    make = (softmax_pair_bwd_dq_kernel_spec if which == "dq"
            else softmax_pair_bwd_dkv_kernel_spec)
    spec = make(matmul=matmul, **cfg_)
    tops = tuple(torch.from_numpy(x) for x in ops_)
    got = {}
    for s in SCHEDULES:
        folds = backward_folds(ops_[0].shape, ops_[1].shape, schedule=s,
                               **kw)
        _, lay = folds[which == "dkv"]
        fold = (schedules.fold_carry_plain if s == "carry"
                else schedules.fold_decoupled_plain)
        got[s] = fold(tops, spec, lay)
    return got, (want[:1] if which == "dq" else want[1:])


@pytest.mark.parametrize("cfg", TF32_CONFIGS, ids=[c[0] for c in TF32_CONFIGS])
def test_3xtf32_dkv_meets_the_reference_bar(cfg):
    """dk and dv with every product of the cell as three TF32 products of
    the split operands (the float32 tensor-core form's arithmetic) meet
    the reference tests' float32 gradient bar against the reference's dk
    and dv, under the carry fold and the split pass with its chain."""
    from repro_torch.kernels.scan_engine import cuda_fold
    got, want = _tf32_case(cfg, cuda_fold.matmul_3xtf32)
    for s in SCHEDULES:
        for leaf, (a, b) in enumerate(zip(got[s], want)):
            assert bool(torch.isfinite(a).all())
            _close(a, b, GRAD_TOL, f"{cfg[0]}/{s} leaf {leaf}")


@pytest.mark.parametrize("cfg", TF32_CONFIGS, ids=[c[0] for c in TF32_CONFIGS])
def test_3xtf32_dq_meets_the_reference_bar(cfg):
    """dq with the cell's three products (s, dp and ds·k) each as three
    TF32 products of the split operands (fold_dq_tf32's arithmetic) meets
    the reference tests' float32 gradient bar against the reference's
    dq, under the carry fold and the split pass with its chain."""
    from repro_torch.kernels.scan_engine import cuda_fold
    got, want = _tf32_case(cfg, cuda_fold.matmul_3xtf32, "dq")
    for s in SCHEDULES:
        assert len(got[s]) == len(want) == 1
        assert bool(torch.isfinite(got[s][0]).all())
        _close(got[s][0], want[0], GRAD_TOL, f"{cfg[0]}/{s} dq")


def test_one_tf32_product_misses_the_bar():
    """Why three products: with each product one TF32 product (~11 bits
    an operand), dk / dv miss the float32 bar the three meet."""
    from repro_torch.kernels.scan_engine import cuda_fold

    def one_tf32(a, b):
        return torch.matmul(cuda_fold.tf32_round(a.float()),
                            cuda_fold.tf32_round(b.float()))

    got, want = _tf32_case(TF32_CONFIGS[0], one_tf32)
    err = max(float(np.abs(_np(a) - _np(b)).max())
              for a, b in zip(got["carry"], want))
    assert err > 10 * GRAD_TOL, err


def test_tf32_round_and_split():
    """``tf32_round`` is ``cvt.rna.tf32.f32``: the 13 low bits cleared,
    to nearest with ties away from zero; hi + lo keeps x to ~2^-22."""
    from repro_torch.kernels.scan_engine import cuda_fold
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -11 - 2.0 ** -20, 3.0e-3, -0.0],
                     dtype=torch.float32)
    r = cuda_fold.tf32_round(x)
    assert (r.view(torch.int32) & 0x1FFF).eq(0).all()
    assert r.tolist()[:4] == [one, one + ulp, -(one + ulp), one]
    assert torch.signbit(r[5])
    rng = np.random.default_rng(3)
    y = torch.from_numpy(rng.standard_normal(4096).astype(np.float32) *
                         np.float32(1e3))
    hi = cuda_fold.tf32_round(y)
    lo = cuda_fold.tf32_round(y - hi)
    rel = ((hi.double() + lo.double() - y.double()).abs()
           / y.double().abs()).max().item()
    assert rel <= 2.0 ** -21, rel
