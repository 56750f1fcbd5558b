"""SSM training on the engine, port against reference: chunked | kernel
peers (``tests/test_train_ssm.py`` re-run on the port).

The tiny Mamba2 LM of the reference test, its weights carried across by
``convert.lm_from_tree``, the same seeded batch. The port's loss within
1e-5 of the reference's, every gradient leaf within 1e-4, route by route
and with remat on and off; one AdamW step and ``make_train_step`` within
1e-4. The kernel route runs the engine's affine scan in both directions
(its plain versions on CPU tensors here; the reference's Pallas kernel in
interpret mode), shown by the port's ``kernel.launch`` events; the
chunked route launches none. zamba2-7b's SMOKE config (float32) trains
through flash and the kernel: its shared block runs in every period, and
its gradient, summed over those invocations, matches the reference's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train_bridge import (as_tree, batch_np, jbatch, max_leaf_err,
                                 np_tree, port_loss_and_grads, port_params,
                                 ref_loss_and_grads, tbatch)
from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.models.config import ModelConfig as JModelConfig
from repro.optim import adamw as jadamw
from repro.train import step as jstep
from repro_torch import configs
from repro_torch.models.config import ModelConfig
from repro_torch.obs import trace
from repro_torch.optim import adamw
from repro_torch.train import step

IMPLS = ("chunked", "kernel")


def _cfgs(**over):
    base = dict(name="tiny-ssm", family="ssm", num_layers=2,
                d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
                d_ff=128, vocab_size=128, layer_pattern=("mamba",),
                ssm_state=16, ssm_heads=2, ssm_head_dim=16, ssm_chunk=16,
                dtype="float32")
    base.update(over)
    return JModelConfig(**base), ModelConfig(**base)


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = _cfgs()
    params = jlm.init_lm(jax.random.PRNGKey(0), jcfg)
    batch = batch_np(np.random.default_rng(0))
    return jcfg, tcfg, params, port_params(params, tcfg), batch


@pytest.mark.parametrize("remat", (True, False), ids=("remat", "no_remat"))
@pytest.mark.parametrize("impl", IMPLS)
def test_loss_and_grads_match_reference(setup, impl, remat):
    jcfg, tcfg, params, tparams, batch = setup
    jl, jg = ref_loss_and_grads(jcfg, params, batch, ssm_impl=impl,
                                remat=remat)
    tl, tg = port_loss_and_grads(tcfg, tparams, batch, ssm_impl=impl,
                                 remat=remat)
    assert abs(tl - jl) < 1e-5, (tl, jl)
    assert max_leaf_err(as_tree(tg), jg) < 1e-4


def test_port_kernel_matches_chunked(setup):
    """The reference test's wall on the port: kernel against chunked,
    loss 1e-5, gradients 1e-4."""
    _, tcfg, _, tparams, batch = setup
    res = {impl: port_loss_and_grads(tcfg, tparams, batch, ssm_impl=impl,
                                     remat=True) for impl in IMPLS}
    assert abs(res["kernel"][0] - res["chunked"][0]) < 1e-5
    assert max_leaf_err(as_tree(res["kernel"][1]),
                        as_tree(res["chunked"][1])) < 1e-4


@pytest.mark.parametrize("remat", (True, False), ids=("remat", "no_remat"))
def test_kernel_route_launches_engine_both_directions(setup, remat):
    """The kernel route's gradient emits affine ``kernel.launch`` events for
    the forward AND the backward scan (the port records one a launch: a
    forward, with remat its recomputation, and a backward a layer); the
    chunked route none."""
    _, tcfg, _, tparams, _ = setup
    batch = batch_np(np.random.default_rng(7), S=48)
    tracer = trace.enable()
    try:
        counts = {}
        for impl in IMPLS:
            tracer.clear()
            port_loss_and_grads(tcfg, tparams, batch, ssm_impl=impl,
                                remat=remat)
            counts[impl] = sum(
                1 for e in tracer.events() if e["name"] == "kernel.launch"
                and e["args"]["monoid"] == "affine")
    finally:
        trace.disable()
    layers = tcfg.num_layers
    assert counts == {"chunked": 0,
                      "kernel": (3 if remat else 2) * layers}, counts


@pytest.mark.parametrize("impl", IMPLS)
def test_optimizer_step_matches_reference(setup, impl):
    jcfg, tcfg, params, tparams, batch = setup
    acfg = dict(lr=1e-3, grad_clip=1.0, weight_decay=0.1)
    _, jg = ref_loss_and_grads(jcfg, params, batch, ssm_impl=impl,
                               remat=True)
    _, tg = port_loss_and_grads(tcfg, tparams, batch, ssm_impl=impl,
                                remat=True)
    jp, _, _ = jadamw.adamw_update(
        jax.tree.map(jnp.asarray, jg), jadamw.adamw_init(params), params,
        jadamw.AdamWConfig(**acfg), lr=1e-3)
    tp, _, _ = adamw.adamw_update(tg, adamw.adamw_init(tparams), tparams,
                                  adamw.AdamWConfig(**acfg), lr=1e-3)
    assert max_leaf_err(as_tree(tp), np_tree(jp)) < 1e-4
    assert max_leaf_err(as_tree(tp), as_tree(tparams)) > 1e-6


@pytest.mark.parametrize("micro", (1, 2))
@pytest.mark.parametrize("impl", IMPLS)
def test_make_train_step_matches_reference(setup, impl, micro):
    """The whole train step on both packages, past the warmup so the
    parameters move: loss 1e-5, parameters 1e-4."""
    jcfg, tcfg, params, tparams, batch = setup
    kw = dict(remat=True, ssm_impl=impl, total_steps=10, warmup_steps=2,
              microbatches=micro)
    jp, _, jm = jax.jit(jstep.make_train_step(jcfg, jstep.TrainStepConfig(
        **kw)))(params, jadamw.adamw_init(params), jbatch(batch),
                jnp.asarray(3, jnp.int32))
    tp, _, tm = step.make_train_step(tcfg, step.TrainStepConfig(**kw))(
        tparams, adamw.adamw_init(tparams), tbatch(batch), torch.tensor(3))
    assert abs(tm["loss"].item() - float(jm["loss"])) < 1e-5
    assert max_leaf_err(as_tree(tp), np_tree(jp)) < 1e-4


def test_hybrid_pattern_kernel_grads():
    """A hybrid attention + mamba pattern through the kernel route: the
    port's gradients against the reference's and its own chunked ones."""
    jcfg, tcfg = _cfgs(num_layers=2, layer_pattern=("global", "mamba"))
    params = jlm.init_lm(jax.random.PRNGKey(1), jcfg)
    tparams = port_params(params, tcfg)
    batch = batch_np(np.random.default_rng(1))
    _, jg = ref_loss_and_grads(jcfg, params, batch, ssm_impl="kernel",
                               remat=True)
    _, tk = port_loss_and_grads(tcfg, tparams, batch, ssm_impl="kernel",
                                remat=True)
    _, tc = port_loss_and_grads(tcfg, tparams, batch, ssm_impl="chunked",
                                remat=True)
    assert max_leaf_err(as_tree(tk), jg) < 1e-4
    assert max_leaf_err(as_tree(tk), as_tree(tc)) < 1e-4


@pytest.mark.parametrize("remat", (True, False), ids=("remat", "no_remat"))
def test_zamba2_smoke_trains_through_flash_and_kernel(remat):
    """zamba2-7b's SMOKE config (mamba, mamba, shared_attn over two
    periods), float32, attention on flash and the SSD on the kernel: the
    loss within 1e-5 and every gradient leaf within 1e-4 of the
    reference's, the shared block's gradient summed over its invocations
    in both periods; the port's plain routes agree."""
    jcfg = dataclasses.replace(jconfigs.get_smoke_config("zamba2-7b"),
                               dtype="float32")
    tcfg = dataclasses.replace(configs.get_smoke_config("zamba2-7b"),
                               dtype="float32")
    assert tcfg.layer_pattern.count("shared_attn") == 1
    assert tcfg.num_layers // len(tcfg.layer_pattern) == 2
    params = jlm.init_lm(jax.random.PRNGKey(0), jcfg)
    tparams = port_params(params, tcfg)
    batch = batch_np(np.random.default_rng(3), S=64, V=tcfg.vocab_size)
    kw = dict(attn_impl="flash", ssm_impl="kernel", remat=remat)
    jl, jg = ref_loss_and_grads(jcfg, params, batch, **kw)
    tl, tg = port_loss_and_grads(tcfg, tparams, batch, **kw)
    assert abs(tl - jl) < 1e-5, (tl, jl)
    assert max_leaf_err(as_tree(tg), jg) < 1e-4
    assert float(np.abs(as_tree(tg)["shared"]["attn"]["wq"]).max()) > 0
    pl, pg = port_loss_and_grads(tcfg, tparams, batch, attn_impl="dense",
                                 ssm_impl="chunked", remat=remat)
    assert abs(tl - pl) < 1e-5
    assert max_leaf_err(as_tree(tg), as_tree(pg)) < 1e-4


@pytest.mark.parametrize("impl", IMPLS)
def test_ssd_gradient_past_the_exp_overflow(impl):
    """Decays of up to 48 a step (zamba2-7b's at full width reach such
    values): above the diagonal A_i - A_j passes 88 and its exp overflows
    float32. The port masks before the exp, so its forward keeps the
    reference's values (within the reference tests' 1e-4; the reference
    masks after the exp and its gradient of the decays is NaN here) and
    its gradients are finite and match a float64 sequential recurrence
    h_t = exp(da_t) h_(t-1) + dt_t B_t x_t, y_t = C_t h_t."""
    from repro.models.layers import ssm as jssm
    from repro_torch.models.layers import ssm
    rng = np.random.default_rng(5)
    B, T, H, P, N = 1, 256, 2, 4, 8
    xs, Bm, Cm = (rng.standard_normal(s).astype(np.float32)
                  for s in ((B, T, H, P), (B, T, N), (B, T, N)))
    dt = (rng.random((B, T, H)) * 3).astype(np.float32)
    da = -16 * dt
    y_ref, _ = jssm._ssd_chunked(*(jnp.asarray(v) for v in (
        xs, Bm, Cm, dt, da)), 128, None, impl)
    t = [torch.from_numpy(v).requires_grad_(True)
         for v in (xs, Bm, Cm, dt, da)]
    y, _ = ssm._ssd_chunked(*t, 128, None, impl)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref),
                               rtol=1e-4, atol=1e-4)
    w = torch.from_numpy(rng.standard_normal(y.shape).astype(np.float32))
    (y * w).sum().backward()
    t64 = [torch.from_numpy(v).double().requires_grad_(True)
           for v in (xs, Bm, Cm, dt, da)]
    x64, b64, c64, dt64, da64 = t64
    h = torch.zeros(B, H, P, N, dtype=torch.float64)
    ys = []
    for i in range(T):
        h = torch.exp(da64[:, i])[:, :, None, None] * h + torch.einsum(
            "bh,bn,bhp->bhpn", dt64[:, i], b64[:, i], x64[:, i])
        ys.append(torch.einsum("bn,bhpn->bhp", c64[:, i], h))
    (torch.stack(ys, 1) * w.double()).sum().backward()
    for got, want in zip(t, t64):
        assert bool(torch.isfinite(got.grad).all())
        scale = float(want.grad.abs().max())
        assert float((got.grad.double() - want.grad).abs().max()) \
            <= 1e-4 * scale
