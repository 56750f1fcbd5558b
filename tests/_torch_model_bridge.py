"""The bridge of the model tests (``tests/test_torch_models.py``,
``tests/test_torch_model_layers.py``, ``tests/test_torch_serve_paging.py``,
``tests/test_torch_moe.py``) between the reference and the port: the
configs of both, the reference compiled once a call, weights carried
across through ``repro_torch.models.convert``, and the tolerances.

Tolerances. float32: the port runs the reference's float32 arithmetic in
another association (torch's and XLA's contractions sum in different
orders), which moves results by a few float32 ulps of the largest
magnitudes (about 1e-6 of them, observed up to 5e-6 through an xLSTM
stack); the bar is ``F32_TOL`` = 1e-4 of the output's largest magnitude.
bf16: every bf16 rounding may fall either way, one ulp (2^-8 of the
value) each, compounding over a few layers; the bars are 2^-3 of the
largest magnitude for hidden states and 2^-4 for logits
(``BF16_TOL_HIDDEN``, ``BF16_TOL_LOGITS``; observed up to 5.6e-2 and
3.3e-2).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro_torch import configs
from repro_torch.models import convert

F32_TOL = 1e-4
BF16_TOL_HIDDEN, BF16_TOL_LOGITS = 2.0 ** -3, 2.0 ** -4

DECODER_ARCHS = [a for a in jconfigs.ARCHS
                 if not jconfigs.get_smoke_config(a).is_encdec]


def cfgs(arch, **over):
    """(reference config, port config) of ``arch``'s SMOKE config."""
    return (dataclasses.replace(jconfigs.get_smoke_config(arch), **over),
            dataclasses.replace(configs.get_smoke_config(arch), **over))


def jitted(fn, **static):
    """The reference function, compiled once with ``static`` keywords
    bound (one XLA compilation instead of one per op: the reference
    tests' own CPU mode, at a tenth of the time)."""
    return jax.jit(functools.partial(fn, **static))


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def perturbed(tree, seed=0):
    """The float32 leaves of a reference tree moved off their constant
    inits (norm weights of ones, zero biases), so they are tested."""
    rng = np.random.default_rng(seed)

    def one(a):
        a = np.asarray(a)
        if a.dtype != np.float32:
            return a
        return (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
    return jax.tree.map(one, tree)


def port(module, tree):
    """``module`` (built on the CPU) holding the reference tree's weights."""
    n = convert.load_tree(module, np_tree(tree))
    assert n == len(list(module.parameters()))
    return module


def rel_err(got, want):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def normal(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


_MODELS = {}


def seeded_params(cfg, seed=0):
    """A parameter tree of the reference's ``init_lm`` structure, names
    and dtypes (``jax.eval_shape``: nothing is computed) holding seeded
    numpy values: N(0, 1/fan_in) for matrices (fan_in their second-last
    axis, past the periods axis of the stacked blocks), 1 + N(0, 0.1^2)
    for vectors. The reference's own init compiles for seconds per
    architecture; its values are held in ``test_init_lm_is_seeded_and_
    sized`` and ``test_arch_kernel_routes_match_reference_and_plain_routes``.
    """
    shapes = jax.eval_shape(lambda: jlm.init_lm(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(seed)

    def one(path, leaf):
        core = leaf.shape[1:] if path[0].key == "blocks" else leaf.shape
        if len(core) >= 2:
            a = rng.standard_normal(leaf.shape) * core[-2] ** -0.5
        else:
            a = 1.0 + 0.1 * rng.standard_normal(leaf.shape)
        return jnp.asarray(a.astype(np.float32)).astype(leaf.dtype)
    return jax.tree_util.tree_map_with_path(one, shapes)


def models(arch, dtype, init="seeded"):
    """(reference cfg, port cfg, reference params, port LM), built once a
    process; ``init`` "seeded" (``seeded_params``) or "reference" (the
    reference's ``init_lm``). Capacity high enough that no MoE token
    drops (a dropped token of a 25-token forward legitimately differs
    from a 1-token decode)."""
    key = (arch, dtype, init)
    if key not in _MODELS:
        jcfg, tcfg = cfgs(arch, dtype=dtype, capacity_factor=8.0)
        params = (seeded_params(jcfg) if init == "seeded" else
                  jax.jit(jlm.init_lm, static_argnums=1)(
                      jax.random.PRNGKey(0), jcfg))
        _MODELS[key] = (jcfg, tcfg, params,
                        convert.lm_from_tree(np_tree(params), tcfg,
                                             device="cpu"))
    return _MODELS[key]
