"""The bridge of the training tests (``tests/test_torch_train_flash.py``,
``tests/test_torch_train_ssm.py``, ``tests/test_torch_train_checkpoint.py``)
between the reference and the port: the same weights (the reference's
tree carried across by ``convert.lm_from_tree``), the same seeded batches,
the loss and gradients of both, and gradients and stepped parameters
compared leaf by leaf in the reference's tree layout
(``convert.tree_from_lm``)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import lm as jlm
from repro_torch.models import convert, lm
from repro_torch.train import step


def batch_np(rng, B=2, S=64, V=128):
    return {
        "tokens": rng.integers(0, V, (B, S)).astype(np.int32),
        "labels": rng.integers(0, V, (B, S)).astype(np.int32),
        "mask": np.ones((B, S), np.float32),
    }


def jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def tbatch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def port_params(tree, cfg):
    """The port's train-step parameters (``convert.params_tree``: the
    reference's layout, as tensors) holding the reference tree's weights,
    on the CPU."""
    return convert.params_tree(
        convert.lm_from_tree(np_tree(tree), cfg, device="cpu"), cfg)


def ref_loss_and_grads(cfg, params, batch, **kw):
    """The reference's (loss, grads tree), compiled once a call."""
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.lm_loss(p, b, cfg, **kw), has_aux=True))(
            params, jbatch(batch))
    return float(loss), np_tree(grads)


def port_loss_and_grads(cfg, params, batch, **kw):
    """The port's (loss, grads tree) on the CPU, through the train step's
    value-and-grad (``kw``: ``TrainStepConfig`` fields)."""
    module = step._LossAndGrad(cfg, lm.lm_loss)
    loss, _, grads = step._value_and_grad(module, params, tbatch(batch),
                                          step.TrainStepConfig(**kw))
    return loss.item(), grads


def as_tree(tree):
    """A port tree of tensors as numpy arrays of the same bits."""
    return jax.tree.map(convert.to_numpy, tree)


def max_leaf_err(a, b):
    """The largest absolute difference over the leaves of two trees of the
    same structure (numpy arrays, any float dtype)."""
    assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
    errs = jax.tree.map(
        lambda x, y: float(np.max(np.abs(np.asarray(x, np.float32)
                                         - np.asarray(y, np.float32)))),
        a, b)
    return max(jax.tree.leaves(errs))
