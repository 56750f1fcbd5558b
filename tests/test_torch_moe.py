"""The port's MoE layer (``repro_torch.models.layers.moe``).

The cases of tests/test_segmented_moe.py on the port's MoE (the layer's
forward and gradients, capacity drops accounted), the layer against the
reference's on carried weights, and its dispatch — each shard's partition
plan, the kept tokens and their expert-buffer slots — bitwise the
reference's integers for the same router choices, capacity drops and
data shards included. Tolerances: ``tests/_torch_model_bridge.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_model_bridge import F32_TOL, jitted, port, rel_err
from repro.models.config import ModelConfig as JModelConfig
from repro.models.layers import moe as jmoe
from repro.relational.partition import partition_plan as jpartition_plan
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import moe


def cfg_pair(**kw):
    base = dict(name="t", family="moe", d_model=32, num_heads=4,
                num_kv_heads=4, head_dim=8, d_ff=64, moe_d_ff=64,
                vocab_size=128, num_experts=4, top_k=2, capacity_factor=2.0,
                dtype="float32")
    base.update(kw)
    return JModelConfig(**base), ModelConfig(**base)


def layer(**kw):
    jcfg, tcfg = cfg_pair(**kw)
    tree = jmoe.init_moe(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, tree, port(moe.MoE(tcfg, device="cpu"), tree)


def test_moe_layer_forward_and_grad():
    _, cfg, _, m = layer()
    x = torch.randn(2, 16, 32, generator=torch.Generator().manual_seed(1))
    y, aux = moe.apply_moe(m, x, cfg)
    loss = (y ** 2).sum() + aux.load_balance_loss
    grads = torch.autograd.grad(loss, list(m.parameters()))
    for g in grads:
        assert bool(torch.isfinite(g).all())


def test_moe_capacity_drops_accounted():
    """A tiny capacity factor drops tokens: dropped_fraction > 0 and the
    output stays finite (dropped tokens pass through the residual)."""
    _, cfg, _, m = layer(d_model=16, num_heads=2, num_kv_heads=2,
                         d_ff=32, moe_d_ff=32, vocab_size=64,
                         num_experts=2, capacity_factor=0.1)
    x = torch.randn(4, 64, 16, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        y, aux = moe.apply_moe(m, x, cfg)
    assert float(aux.dropped_fraction) > 0.0
    assert bool(torch.isfinite(y).all())


@pytest.mark.parametrize("capacity_factor", [2.0, 0.5])
def test_moe_matches_reference(capacity_factor):
    jcfg, tcfg, tree, m = layer(capacity_factor=capacity_factor)
    x = np.random.default_rng(2).standard_normal((2, 16, 32)).astype(
        np.float32)
    want_y, want_aux = jitted(jmoe.apply_moe, cfg=jcfg)(tree, jnp.asarray(x))
    with torch.no_grad():
        got_y, got_aux = moe.apply_moe(m, torch.from_numpy(x), tcfg)
    assert rel_err(got_y, want_y) < F32_TOL
    for name in moe.MoEAux._fields:
        assert abs(float(getattr(got_aux, name)) -
                   float(getattr(want_aux, name))) < F32_TOL, name


@pytest.mark.parametrize("shards,capacity", [(1, 8), (1, 3), (4, 2)])
def test_dispatch_integers_match_reference_bitwise(shards, capacity):
    """For the same router choices (G shards of TL·K expert ids), the
    port's per-shard plans give the reference's ``jax.vmap``-ed plans'
    ranks, and so the same kept tokens and buffer slots."""
    E, TL, K = 4, 24, 2
    ids = np.random.default_rng(shards + capacity).integers(
        0, E, (shards, TL * K)).astype(np.int32)
    plan = jax.vmap(lambda i: jpartition_plan(i, E))(jnp.asarray(ids))
    keep = np.asarray(plan.ranks) < capacity
    slot = np.where(keep, ids * capacity + np.asarray(plan.ranks),
                    E * capacity)
    got_keep, got_slot = moe.dispatch_slots(torch.from_numpy(ids), E,
                                            capacity)
    assert np.array_equal(got_keep.numpy(), keep)
    assert np.array_equal(got_slot.numpy(), slot)
    assert got_slot.dtype == torch.int32
