"""The port's affine (SSM) scan held against the JAX reference.

The same numpy inputs go through ``repro.kernels.ssm_scan.ops.ssm_scan``
(Pallas in interpret mode, as the reference's own tests run it on the
CPU) and through ``repro_torch.kernels.ssm_scan.ops.ssm_scan`` (the plain
PyTorch version of each kernel on a CPU tensor), forward and gradient,
under the four schedules.

Tolerances are the reference tests' own: 2e-4 for float32 and 0.1 for
bfloat16 forwards, 1e-4 and 3e-2 (scaled by the gradient's range) for
gradients. The two packages cannot agree bitwise on arbitrary floats:
XLA's CPU compiler contracts the affine combine ``a2 * b1 + b2`` into a
fused multiply-add, while the port (and its CUDA kernels) round the
product and the sum separately. On exact data (gates in {±1}, integer
offsets) there is no rounding, and there the two must agree bit for
bit under every schedule.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.scan import reference as jax_reference
from repro.kernels.ssm_scan import ops as jax_ops
from repro_torch.core import scan as scanlib
from repro_torch.kernels.scan_engine import cuda
from repro_torch.kernels.ssm_scan import ops, ref
from repro_torch.obs import trace

SCHEDULES4 = ("carry", "decoupled", "fused", "tree")


def _inputs(shape, dtype, seed, lo=0.7, b_scale=0.1):
    """(a, b) as jax arrays and torch tensors holding the same values."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(lo, 1.0, shape).astype(np.float32)
    b = (rng.standard_normal(shape) * b_scale).astype(np.float32)
    return _pair(a, b, dtype)


def _exact_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    a = rng.choice([-1.0, 1.0], shape).astype(np.float32)
    b = rng.integers(-3, 4, shape).astype(np.float32)
    return a, b


def _pair(a, b, dtype="float32"):
    aj = jnp.asarray(a, getattr(jnp, dtype))
    bj = jnp.asarray(b, getattr(jnp, dtype))
    at = torch.from_numpy(np.array(aj.astype(jnp.float32))).to(
        getattr(torch, dtype))
    bt = torch.from_numpy(np.array(bj.astype(jnp.float32))).to(
        getattr(torch, dtype))
    return aj, bj, at, bt


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy().astype(np.float64)
    return np.asarray(x.astype(jnp.float32), np.float64)


def _bits(x):
    a = x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(
        x.astype(jnp.float32))
    return a.view(np.uint32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 64, 128), (2, 256, 512), (3, 100, 64),
                                   (1, 1024, 256)])
def test_ssm_scan_shapes_dtypes(shape, dtype):
    aj, bj, at, bt = _inputs(shape, dtype, hash(shape) % 2**31)
    got = ops.ssm_scan(at, bt)
    assert got.dtype == at.dtype and tuple(got.shape) == shape
    want = jax_ops.ssm_scan(aj, bj, interpret=True)
    tol = 0.1 if dtype == "bfloat16" else 2e-4
    _close(got, want, tol)
    _close(got, ref.ssm_scan_ref(at.float(), bt.float()), tol)


@pytest.mark.parametrize("block_t", [32, 128, 512])
def test_ssm_scan_block_invariance(block_t):
    aj, bj, at, bt = _inputs((2, 512, 128), "float32", 7, lo=0.8, b_scale=1)
    got = ops.ssm_scan(at, bt, block_t=block_t)
    _close(got, ref.ssm_scan_ref(at, bt), 2e-4)
    _close(got, jax_ops.ssm_scan(aj, bj, block_t=block_t, interpret=True),
           2e-4)


def test_ssm_scan_vs_core_affine():
    """Kernel route and the core library's blocked AFFINE scan agree (two
    implementations of one monoid), as in the reference."""
    aj, bj, at, bt = _inputs((1, 200, 32), "float32", 8, lo=0.8, b_scale=1)
    got = ops.ssm_scan(at, bt)
    _, hb = scanlib.scan((at, bt), "affine", axis=1, algorithm="blocked",
                         block_size=64)
    _close(got, hb, 2e-4)
    _close(got, jax_ops.ssm_scan(aj, bj, interpret=True), 2e-4)


@pytest.mark.parametrize("shape", [(1, 2048, 128), (2, 1024, 256),
                                   (1, 1000, 64)])
def test_ssm_decoupled_matches_reference(shape):
    aj, bj, at, bt = _inputs(shape, "float32", hash(shape) % 2**31)
    got = ops.ssm_scan(at, bt, schedule="decoupled", block_t=128)
    _, want = jax_reference.scan_ref((aj, bj), "affine", axis=1)
    _close(got, want, 2e-4)
    _close(got, jax_ops.ssm_scan(aj, bj, interpret=True,
                                 schedule="decoupled", block_t=128), 2e-4)


@pytest.mark.parametrize("block_t", [64, 256])
def test_ssm_decoupled_block_invariance_and_bit_identity(block_t):
    aj, bj, at, bt = _inputs((1, 2048, 128), "float32", 6, lo=0.8,
                             b_scale=1)
    carry = ops.ssm_scan(at, bt, block_t=block_t, schedule="carry")
    dec = ops.ssm_scan(at, bt, block_t=block_t, schedule="decoupled")
    fused = ops.ssm_scan(at, bt, block_t=block_t, schedule="fused")
    assert torch.equal(carry, dec) and torch.equal(carry, fused)
    _, want = jax_reference.scan_ref((aj, bj), "affine", axis=1)
    _close(dec, want, 2e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_parity_affine(dtype):
    """carry == decoupled == fused bitwise inside the port on any data;
    each within the reference tests' tolerance of the reference."""
    aj, bj, at, bt = _inputs((1, 2048, 128), dtype, 2)
    outs = [ops.ssm_scan(at, bt, schedule=s, block_t=128)
            for s in ("carry", "decoupled", "fused")]
    for o in outs[1:]:
        np.testing.assert_array_equal(_bits(o), _bits(outs[0]))
    _, want = jax_reference.scan_ref(
        (aj.astype(jnp.float32), bj.astype(jnp.float32)), "affine", axis=1)
    tol = 0.1 if dtype == "bfloat16" else 2e-4
    _close(outs[0], want, tol)
    for s in ("carry", "decoupled", "fused"):
        _close(outs[0], jax_ops.ssm_scan(aj, bj, interpret=True, schedule=s,
                                         block_t=128), tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("schedule", SCHEDULES4)
def test_parity4_affine_exact(schedule, dtype):
    """Exact affine data: every schedule, tree included, bitwise equal to
    the reference's same schedule and to the sequential oracle."""
    a, b = _exact_inputs((1, 2048, 128), 22)
    aj, bj, at, bt = _pair(a, b, dtype)
    got = ops.ssm_scan(at, bt, schedule=schedule, block_t=128)
    want = jax_ops.ssm_scan(aj, bj, interpret=True, schedule=schedule,
                            block_t=128)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    carry = ops.ssm_scan(at, bt, schedule="carry", block_t=128)
    np.testing.assert_array_equal(_bits(got), _bits(carry))
    # the oracle in float32 (exact here), rounded to the output dtype
    _, seq = jax_reference.scan_ref(
        (aj.astype(jnp.float32), bj.astype(jnp.float32)), "affine", axis=1)
    np.testing.assert_array_equal(_bits(got), _bits(seq.astype(bj.dtype)))


def _grad_tol(dtype):
    return 3e-2 if dtype == "bfloat16" else 1e-4


def _assert_grads_close(g, g_ref, dtype):
    want = _np(g_ref)
    atol = _grad_tol(dtype) * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(_np(g), want, rtol=_grad_tol(dtype),
                               atol=atol)


def _port_grads(at, bt, w, schedule="auto"):
    a = at.clone().requires_grad_()
    b = bt.clone().requires_grad_()
    h = ops.ssm_scan(a, b, schedule=schedule)
    loss = torch.sum(h.float() * w)
    return torch.autograd.grad(loss, (a, b))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 128, 8), (2, 512, 16), (3, 1024, 4)])
def test_ssm_grad_matches_reference(shape, dtype):
    rng = np.random.default_rng(32)
    a = rng.uniform(0.6, 1.0, shape).astype(np.float32)
    b = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    w = rng.standard_normal(shape).astype(np.float32)
    aj, bj, at, bt = _pair(a, b, dtype)

    def loss_kernel(a, b):
        h = jax_ops.ssm_scan(a, b, interpret=True)
        return jnp.sum(h.astype(jnp.float32) * jnp.asarray(w))

    def loss_ref(a, b):
        _, h = jax_reference.scan_ref(
            (a.astype(jnp.float32), b.astype(jnp.float32)), "affine",
            axis=1)
        return jnp.sum(h * jnp.asarray(w))

    ga, gb = _port_grads(at, bt, torch.from_numpy(w))
    assert ga.dtype == at.dtype and gb.dtype == bt.dtype
    ka, kb = jax.grad(loss_kernel, argnums=(0, 1))(aj, bj)
    ra, rb = jax.grad(loss_ref, argnums=(0, 1))(aj, bj)
    for got, want in ((gb, kb), (ga, ka), (gb, rb), (ga, ra)):
        _assert_grads_close(got, want, dtype)


def test_ssm_grad_per_schedule():
    """The backward scan honours the caller's schedule: gradients agree
    across the four organizations and with the reference's."""
    rng = np.random.default_rng(33)
    a = rng.uniform(0.6, 1.0, (2, 512, 8)).astype(np.float32)
    b = rng.standard_normal((2, 512, 8)).astype(np.float32)
    aj, bj, at, bt = _pair(a, b)

    def loss(a, b, schedule):
        h = jax_ops.ssm_scan(a, b, interpret=True, schedule=schedule)
        return jnp.sum(h * h)

    grads = []
    for s in SCHEDULES4:
        ta = at.clone().requires_grad_()
        tb = bt.clone().requires_grad_()
        h = ops.ssm_scan(ta, tb, schedule=s)
        grads.append(torch.autograd.grad(torch.sum(h * h), (ta, tb)))
        ja, jb = jax.grad(loss, argnums=(0, 1))(aj, bj, s)
        _close(grads[-1][0], ja, 1e-4)
        _close(grads[-1][1], jb, 1e-4)
    for ga, gb in grads[1:]:
        _close(ga, grads[0][0], 1e-4)
        _close(gb, grads[0][1], 1e-4)


@pytest.mark.parametrize("schedule", SCHEDULES4)
def test_ssm_grad_is_flipped_affine_scan(schedule):
    """db is the same schedule's scan of the flipped cotangent through the
    flipped gates rolled one step, bitwise; da = db · h_prev."""
    rng = np.random.default_rng(35)
    a = torch.from_numpy(rng.uniform(0.6, 1.0, (2, 300, 24)).astype(
        np.float32))
    b = torch.from_numpy(rng.standard_normal((2, 300, 24)).astype(
        np.float32))
    g = torch.from_numpy(rng.standard_normal((2, 300, 24)).astype(
        np.float32))
    ta, tb = a.clone().requires_grad_(), b.clone().requires_grad_()
    h = ops.ssm_scan(ta, tb, schedule=schedule, block_t=64)
    da, db = torch.autograd.grad(h, (ta, tb), g)
    gate = torch.cat([torch.zeros_like(a[:, :1]), torch.flip(a, (1,))[:, :-1]],
                     dim=1)
    lam = torch.flip(ops.ssm_scan(gate, torch.flip(g, (1,)),
                                  schedule=schedule, block_t=64), (1,))
    assert torch.equal(db, lam)
    h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1)
    assert torch.equal(da, lam * h_prev.detach())


def test_backward_launches_engine_kernels():
    """The forward emits one affine ``kernel.launch``; a gradient adds one
    more with the same schedule and the Channels grid."""
    tracer = trace.enable()
    try:
        rng = np.random.default_rng(34)
        a = torch.from_numpy(rng.uniform(0.6, 1, (1, 300, 40)).astype(
            np.float32)).requires_grad_()
        b = torch.from_numpy(rng.standard_normal((1, 300, 40)).astype(
            np.float32))
        tracer.clear()
        h = ops.ssm_scan(a, b, block_t=64, schedule="fused")
        torch.autograd.grad(torch.sum(h ** 2), a)
        evs = [e["args"] for e in tracer.events()
               if e["name"] == "kernel.launch"
               and e["args"]["monoid"] == "affine"]
        assert len(evs) == 2
        for ev in evs:
            assert ev["schedule"] == "fused"
            assert ev["grid"] == [1, 1, 5]          # (B, D/bd, T/bt)
            in_bytes = 2 * 1 * 320 * 128 * 4        # a and b, padded
            assert ev["hbm_read_bytes_est"] == in_bytes
            assert ev["hbm_write_bytes_est"] == in_bytes // 2
            assert ev["vmem_block_bytes_est"] == 2 * 64 * 128 * 4
    finally:
        trace.disable()


def test_back_compat_entry_points():
    aj, bj, at, bt = _inputs((2, 512, 256), "float32", 9)
    got = ops.ssm_scan_kernel(at, bt, block_t=128, block_d=128)
    want = jax_ops.ssm_scan_kernel(aj, bj, block_t=128, block_d=128,
                                   interpret=True)
    _close(got, want, 2e-4)
    dec = ops.ssm_scan_decoupled(at, bt, block_t=128, block_d=128)
    assert torch.equal(dec, got)
    _close(dec, jax_ops.ssm_scan_decoupled(aj, bj, block_t=128, block_d=128,
                                           interpret=True), 2e-4)
    with pytest.raises(ValueError):
        ops.ssm_scan_kernel(at, bt[:, :, :128])
    with pytest.raises(ValueError):
        ops.ssm_scan_kernel(at, bt, block_t=384)  # 512 not divisible


@pytest.mark.parametrize("shape", [(1, 1 << 16, 64), (1, 4096, 8192),
                                   (8, 4096, 512), (2, 100, 64),
                                   (1, 1024, 458752)])
@pytest.mark.parametrize("schedule", ["auto", "tree"])
def test_resolved_schedule_matches_reference(shape, schedule):
    want = jax_ops.resolved_schedule(shape, schedule=schedule)
    assert ops.resolved_schedule(shape, schedule=schedule) == want


def test_resolved_schedule_counts_the_card():
    """On a card the policy's core count is the SM count (132 on an H100
    SXM): zamba2-7b's SSD carry shape has 896 channel stripes, so it keeps
    the carry chain; one stripe spreads its time chunks."""
    assert ops.resolved_schedule((1, 1024, 458752), cores=132) == "carry"
    assert ops.resolved_schedule((1, 1 << 16, 512), cores=132) == "fused"


@pytest.mark.parametrize("shape", [(2, 0, 8), (0, 16, 8), (1, 16, 0)])
def test_empty_returns_b(shape):
    a, b = torch.ones(shape), torch.zeros(shape)
    for s in SCHEDULES4 + ("auto",):
        assert ops.ssm_scan(a, b, schedule=s) is b


def test_ref_oracle_vs_reference():
    aj, bj, at, bt = _inputs((2, 300, 16), "bfloat16", 11)
    from repro.kernels.ssm_scan import ref as jax_ref
    got = ref.ssm_scan_ref(at, bt)
    assert got.dtype == torch.bfloat16
    _close(got, jax_ref.ssm_scan_ref(aj, bj), 0.1)


def test_cpu_tensors_never_reach_the_kernels():
    """On CPU tensors every schedule runs the plain versions: no launch
    is counted."""
    _, _, at, bt = _inputs((1, 256, 128), "float32", 12)
    before = dict(cuda.LAUNCHES)
    for s in SCHEDULES4:
        ops.ssm_scan(at, bt, schedule=s, block_t=64)
    assert cuda.LAUNCHES == before
