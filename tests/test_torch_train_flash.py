"""Training on the engine, port against reference: dense | blockwise |
flash peers (``tests/test_train_flash.py`` re-run on the port).

The tiny float32 LM of the reference test, its weights carried across by
``convert.lm_from_tree``, the same seeded batch. The port's loss must be
within 1e-5 of the reference's and every gradient leaf within 1e-4 (the
reference tests' bars), route by route, with remat on and off; one
``adamw_update`` step's parameters within 1e-4; ``make_train_step``'s
loss and parameters within 1e-5 / 1e-4. The flash route runs the fold
kernels' plain versions on the port's CPU tensors, the reference's Pallas
kernels in interpret mode. The reference test's own walls (flash and
blockwise against dense) hold on the port too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train_bridge import (as_tree, batch_np, jbatch, max_leaf_err,
                                 np_tree, port_loss_and_grads, port_params,
                                 ref_loss_and_grads, tbatch)
from repro.models import lm as jlm
from repro.models.config import ModelConfig as JModelConfig
from repro.optim import adamw as jadamw
from repro.train import step as jstep
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.train import step

IMPLS = ("dense", "blockwise", "flash")


def _cfgs(**over):
    base = dict(name="tiny-flash", family="dense", num_layers=2,
                d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
                d_ff=128, vocab_size=128, layer_pattern=("global",),
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
    jl, jg = ref_loss_and_grads(jcfg, params, batch, attn_impl=impl,
                                remat=remat)
    tl, tg = port_loss_and_grads(tcfg, tparams, batch, attn_impl=impl,
                                 remat=remat)
    assert abs(tl - jl) < 1e-5, (tl, jl)
    assert max_leaf_err(as_tree(tg), jg) < 1e-4


def test_port_impls_agree(setup):
    """The reference test's wall on the port: blockwise and flash against
    dense, loss 1e-5, gradients 1e-4."""
    _, tcfg, _, tparams, batch = setup
    res = {impl: port_loss_and_grads(tcfg, tparams, batch, attn_impl=impl,
                                     remat=True) for impl in IMPLS}
    for impl in ("blockwise", "flash"):
        assert abs(res[impl][0] - res["dense"][0]) < 1e-5
        assert max_leaf_err(as_tree(res[impl][1]),
                            as_tree(res["dense"][1])) < 1e-4


@pytest.mark.parametrize("schedule", ["carry", "decoupled"])
def test_flash_grads_both_schedules(setup, schedule):
    """An explicit fold schedule: the port's flash gradients against the
    reference's under the same schedule and the port's dense ones."""
    jcfg, tcfg, params, tparams, batch = setup
    _, jg = ref_loss_and_grads(jcfg, params, batch, attn_impl="flash",
                               attn_schedule=schedule, remat=True)
    _, tg = port_loss_and_grads(tcfg, tparams, batch, attn_impl="flash",
                                attn_schedule=schedule, remat=True)
    _, td = port_loss_and_grads(tcfg, tparams, batch, attn_impl="dense",
                                remat=True)
    assert max_leaf_err(as_tree(tg), jg) < 1e-4
    assert max_leaf_err(as_tree(tg), as_tree(td)) < 1e-4


@pytest.mark.parametrize("impl", IMPLS)
def test_optimizer_step_matches_reference(setup, impl):
    """One full AdamW step on each package's gradients: the parameters
    within 1e-4, and moved."""
    jcfg, tcfg, params, tparams, batch = setup
    _, jg = ref_loss_and_grads(jcfg, params, batch, attn_impl=impl,
                               remat=True)
    _, tg = port_loss_and_grads(tcfg, tparams, batch, attn_impl=impl,
                                remat=True)
    jp, _, _ = jadamw.adamw_update(
        jax.tree.map(jnp.asarray, jg), jadamw.adamw_init(params), params,
        jadamw.AdamWConfig(lr=1e-3, grad_clip=1.0, weight_decay=0.1),
        lr=1e-3)
    tp, _, _ = adamw.adamw_update(
        tg, adamw.adamw_init(tparams), tparams,
        adamw.AdamWConfig(lr=1e-3, grad_clip=1.0, weight_decay=0.1),
        lr=1e-3)
    assert max_leaf_err(as_tree(tp), np_tree(jp)) < 1e-4
    assert max_leaf_err(as_tree(tp), as_tree(tparams)) > 1e-6


@pytest.mark.parametrize("micro", (1, 2))
@pytest.mark.parametrize("step_idx,warmup", ((0, 100), (3, 2)),
                         ids=("warmup0", "step3"))
@pytest.mark.parametrize("impl", ("blockwise", "flash"))
def test_make_train_step_matches_reference(setup, impl, step_idx, warmup,
                                           micro):
    """The whole train step (remat, the chunked loss, microbatches, the
    schedule and AdamW) on both packages: loss 1e-5, parameters 1e-4. At
    step 0 of the reference test's warmup the rate is 0; at step 3 past a
    warmup of 2 the parameters move."""
    jcfg, tcfg, params, tparams, batch = setup
    kw = dict(remat=True, attn_impl=impl, total_steps=10,
              warmup_steps=warmup, microbatches=micro)
    jp, _, jm = jax.jit(jstep.make_train_step(jcfg, jstep.TrainStepConfig(
        **kw)))(params, jadamw.adamw_init(params), jbatch(batch),
                jnp.asarray(step_idx, jnp.int32))
    fn = step.make_train_step(tcfg, step.TrainStepConfig(**kw))
    opt = adamw.adamw_init(tparams)
    tp, topt, tm = fn(tparams, opt, tbatch(batch), torch.tensor(step_idx))
    assert abs(tm["loss"].item() - float(jm["loss"])) < 1e-5
    assert abs(tm["grad_norm"].item() - float(jm["grad_norm"])) < 1e-4
    assert max_leaf_err(as_tree(tp), np_tree(jp)) < 1e-4
    assert int(topt.step) == 1 and int(opt.step) == 0
    moved = max_leaf_err(as_tree(tp), as_tree(tparams))
    assert (moved > 1e-6) == (step_idx > 0)


def test_gqa_softcap_flash_grads(setup):
    """GQA (4 q heads over 2 kv heads) with a softcapped config through the
    train loss: the port's flash gradients against the reference's and
    against its own dense ones."""
    jcfg, tcfg = _cfgs(attn_softcap=30.0)
    params = jlm.init_lm(jax.random.PRNGKey(1), jcfg)
    tparams = port_params(params, tcfg)
    batch = batch_np(np.random.default_rng(1))
    _, jg = ref_loss_and_grads(jcfg, params, batch, attn_impl="flash",
                               remat=True)
    _, tg = port_loss_and_grads(tcfg, tparams, batch, attn_impl="flash",
                                remat=True)
    _, td = port_loss_and_grads(tcfg, tparams, batch, attn_impl="dense",
                                remat=True)
    assert max_leaf_err(as_tree(tg), jg) < 1e-4
    assert max_leaf_err(as_tree(tg), as_tree(td)) < 1e-4
