"""Backward as a scan: the port's autograd.Function vs the reference's
custom VJP.

``repro_torch``'s ``cumsum`` carries a ``torch.autograd.Function`` whose
backward is one more engine scan of the flipped cotangent with the same
``exclusive`` flag, as the reference's ``jax.custom_vjp`` does. The same
numpy inputs and cotangent weights go through ``torch.autograd.grad``
and ``jax.grad``; the gradients must agree bitwise (both run the same
association), and the backward must emit its own ``kernel.launch``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.scan_blocked import ops as jax_ops
from repro_torch.core.scan import reference
from repro_torch.kernels.scan_blocked import ops
from repro_torch.obs import trace

SHAPES = [(1, 256), (3, 1024), (2, 4096)]


def _bits(a):
    a = np.asarray(a, np.float32)
    return a.view(np.uint32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("exclusive", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_cumsum_grad_matches_reference(shape, exclusive, dtype):
    rng = np.random.default_rng(30)
    x = rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal(shape).astype(np.float32)

    xj = jnp.asarray(x, getattr(jnp, dtype))

    def loss_jax(x):
        out = jax_ops.cumsum(x, exclusive=exclusive, interpret=True)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(w))

    g_ref = jax.grad(loss_jax)(xj)

    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        getattr(torch, dtype)).requires_grad_()
    out = ops.cumsum(xt, exclusive=exclusive)
    loss = torch.sum(out.float() * torch.from_numpy(w))
    (g,) = torch.autograd.grad(loss, xt)

    assert g.dtype == xt.dtype
    np.testing.assert_array_equal(
        _bits(g.float().numpy()),
        _bits(np.asarray(g_ref.astype(jnp.float32))))


@pytest.mark.parametrize("schedule", ["carry", "decoupled", "fused", "tree"])
def test_grad_is_flipped_scan_per_schedule(schedule):
    """The backward honours the caller's schedule: the gradient is the
    same schedule's scan of the flipped cotangent, and agrees with the
    sequential oracle's autograd to float tolerance."""
    rng = np.random.default_rng(31)
    x = torch.from_numpy(rng.standard_normal((2, 4096)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((2, 4096)).astype(np.float32))
    xg = x.clone().requires_grad_()
    (dx,) = torch.autograd.grad(
        ops.cumsum(xg, schedule=schedule, block_n=512), xg, g)
    want = torch.flip(ops.cumsum(torch.flip(g, (1,)), schedule=schedule,
                                 block_n=512), (1,))
    assert torch.equal(dx, want)
    xr = x[:, :300].clone().requires_grad_()
    (dr,) = torch.autograd.grad(reference.cumsum_ref(xr), xr, g[:, :300])
    xk = x[:, :300].clone().requires_grad_()
    (dk,) = torch.autograd.grad(ops.cumsum(xk, schedule=schedule), xk,
                                g[:, :300])
    np.testing.assert_allclose(dk.numpy(), dr.numpy(), rtol=1e-4, atol=1e-4)


def test_backward_launches_engine_kernels():
    """kernel.launch instants fire for the backward too: forward alone
    emits one sum launch, a grad adds another with the same schedule."""
    tracer = trace.enable()
    try:
        rng = np.random.default_rng(34)
        x = torch.from_numpy(
            rng.standard_normal((1, 320)).astype(np.float32))
        tracer.clear()
        ops.cumsum(x)
        fwd = [e for e in tracer.events() if e["name"] == "kernel.launch"
               and e["args"]["monoid"] == "sum"]
        assert len(fwd) == 1

        tracer.clear()
        xg = x.clone().requires_grad_()
        torch.autograd.grad(torch.sum(ops.cumsum(xg) ** 2), xg)
        both = [e for e in tracer.events() if e["name"] == "kernel.launch"
                and e["args"]["monoid"] == "sum"]
        assert len(both) == 2, "forward AND backward cumsum launches"
        assert both[0]["args"]["schedule"] == both[1]["args"]["schedule"]
    finally:
        trace.disable()


def test_empty_inputs_have_grads():
    x = torch.zeros((2, 0), requires_grad=True)
    (g,) = torch.autograd.grad(torch.sum(ops.cumsum(x)), x,
                               allow_unused=True)
    assert g is None or g.shape == (2, 0)
    xj = jnp.zeros((2, 0), jnp.float32)
    gj = jax.grad(lambda x: jnp.sum(jax_ops.cumsum(x, interpret=True)))(xj)
    assert gj.shape == (2, 0)
