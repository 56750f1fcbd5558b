"""The port's models (``repro_torch.models``) against the reference's.

The same weights (carried across by ``repro_torch.models.convert`` as
numpy arrays) and the same seeded inputs go through whole models: for
every decoder-only architecture's SMOKE config (seamless-m4t, the one
encoder-decoder, waits with ``encdec.py``) the final hidden states of
``forward`` and the logits of ``prefill`` + ``decode_step``, in float32
and once in bf16, and the kernel routes (``attn_impl="flash"``,
``ssm_impl="kernel"``: the Pallas kernels in interpret mode on the
reference, the kernels' plain versions on the port's CPU tensors) for
zamba2 and gemma2. The reference tests ``test_arch_decode_matches_forward``
and ``test_gemma2_softcaps_active`` (tests/test_models_smoke.py) re-run on
the port. The layers are held one by one in
``tests/test_torch_model_layers.py``; tolerances:
``tests/_torch_model_bridge.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_model_bridge import (BF16_TOL_HIDDEN, BF16_TOL_LOGITS,
                                 DECODER_ARCHS, F32_TOL, jitted, models,
                                 np_tree, rel_err)
from repro.models import lm as jlm
from repro_torch import configs
from repro_torch.models import lm
from repro_torch.models.layers import embedding


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


def _inputs(cfg, B=2, S=24, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    emb = (rng.standard_normal((B, cfg.frontend_tokens, 1024))
           .astype(np.float32) if cfg.frontend_tokens else None)
    return toks, emb


def _serve(arch, dtype, S=24, attn_impl=None, ssm_impl=None,
           init="seeded"):
    """Reference and port (hidden, prefill logits, decode logits)."""
    jcfg, tcfg, params, m = models(arch, dtype, init)
    toks, emb = _inputs(jcfg, S=S)
    je = None if emb is None else jnp.asarray(emb)
    te = None if emb is None else torch.from_numpy(emb)
    hj, _, _ = jitted(jlm.forward, cfg=jcfg)(params, jnp.asarray(toks),
                                              embeds=je)
    ht, _, _ = lm.forward(m, torch.from_numpy(toks), tcfg, embeds=te)
    max_len = S + 8 + (jcfg.frontend_tokens or 0)
    lj, cj = jitted(jlm.prefill, cfg=jcfg, max_len=max_len,
                    attn_impl=attn_impl, ssm_impl=ssm_impl)(
        params, jnp.asarray(toks[:, :S]), embeds=je)
    lt, ct = lm.prefill(m, torch.from_numpy(toks[:, :S]), tcfg, max_len,
                        embeds=te, attn_impl=attn_impl, ssm_impl=ssm_impl)
    n = S + (jcfg.frontend_tokens or 0)
    gj, _ = jitted(jlm.decode_step, cfg=jcfg, ssm_impl=ssm_impl)(
        params, jnp.asarray(toks[:, S:]), cj, jnp.asarray(n, jnp.int32))
    gt, _ = lm.decode_step(m, torch.from_numpy(toks[:, S:]), ct,
                           torch.tensor(n, dtype=torch.int32), tcfg,
                           ssm_impl=ssm_impl)
    return (hj, ht), (lj, lt), (gj, gt)


@pytest.mark.parametrize("arch", DECODER_ARCHS)
def test_arch_float32_matches_reference(arch):
    (hj, ht), (lj, lt), (gj, gt) = _serve(arch, "float32")
    assert ht.shape == hj.shape
    assert rel_err(ht, hj) < F32_TOL
    assert rel_err(lt, lj) < F32_TOL
    assert rel_err(gt, gj) < F32_TOL


@pytest.mark.parametrize("arch", DECODER_ARCHS)
def test_arch_bf16_matches_reference(arch):
    (hj, ht), (lj, lt), (gj, gt) = _serve(arch, "bfloat16")
    assert ht.dtype == torch.bfloat16
    assert rel_err(ht, hj) < BF16_TOL_HIDDEN
    assert rel_err(lt, lj) < BF16_TOL_LOGITS
    assert rel_err(gt, gj) < BF16_TOL_LOGITS


@pytest.mark.parametrize("arch", ["zamba2-7b", "gemma2-9b"])
def test_arch_kernel_routes_match_reference_and_plain_routes(arch):
    """``attn_impl="flash"`` and ``ssm_impl="kernel"``: against the
    reference's Pallas kernels (interpret mode) on the same routes, and
    against the port's own plain routes. gemma2's 64-token prompt fills
    its local layers' rings (the banded route), its global layers take
    the padded-cache flash prefill."""
    S = 64
    (_, _), (lj, lt), (gj, gt) = _serve(
        arch, "float32", S=S, attn_impl="flash", ssm_impl="kernel",
        init="reference")
    assert rel_err(lt, lj) < F32_TOL
    assert rel_err(gt, gj) < F32_TOL
    (_, _), (_, lp), (_, gp) = _serve(arch, "float32", S=S,
                                      init="reference")
    assert rel_err(lt, lp.numpy()) < F32_TOL
    assert rel_err(gt, gp.numpy()) < F32_TOL


@pytest.mark.parametrize("arch", ["gemma2-9b", "zamba2-7b", "xlstm-125m",
                                  "granite-moe-1b-a400m"])
def test_arch_decode_matches_forward(arch):
    """The reference test on the port: prefill + decode equals the full
    forward (ring buffers, SSM states, xLSTM states, MoE decode), at the
    reference test's tolerance."""
    _, cfg, _, m = models(arch, "float32")
    g = torch.Generator().manual_seed(1)
    B, S = 2, 24
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=g)
    hidden, _, _ = lm.forward(m, toks, cfg)
    want = embedding.lm_logits(m, hidden[:, -1:], cfg)[:, 0]
    _, cache = lm.prefill(m, toks[:, :S], cfg, max_len=S + 8)
    got, _ = lm.decode_step(m, toks[:, S:], cache,
                            torch.tensor(S, dtype=torch.int32), cfg)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-3,
                               atol=2e-3)


def test_gemma2_softcaps_active():
    """The reference test on the port, with the port's own init."""
    cfg = configs.get_smoke_config("gemma2-9b")
    assert cfg.attn_softcap == 50.0 and cfg.final_softcap == 30.0
    g = torch.Generator().manual_seed(0)
    m = lm.init_lm(cfg, generator=g, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (1, 16), generator=g)
    hidden, _, _ = lm.forward(m, toks, cfg)
    logits = embedding.lm_logits(m, hidden, cfg)
    assert float(logits.abs().max()) <= 30.0 + 1e-3


def test_init_lm_is_seeded_and_sized():
    """The port's own random init: the same weights from the same seed,
    and the parameter names, shapes, dtypes and count of the LM built
    from the reference's ``init_lm`` tree."""
    _, tcfg, ref, from_ref = models("zamba2-7b", "float32", "reference")
    a, b = (lm.init_lm(tcfg, generator=torch.Generator().manual_seed(3),
                       device="cpu") for _ in range(2))
    for (na, pa), (nb, pb) in zip(a.named_parameters(),
                                  b.named_parameters()):
        assert na == nb and torch.equal(pa, pb)
    shapes = {n: (p.shape, p.dtype) for n, p in from_ref.named_parameters()}
    assert shapes == {n: (p.shape, p.dtype) for n, p in a.named_parameters()}
    assert sum(p.numel() for p in a.parameters()) == sum(
        np.asarray(x).size for x in jax.tree.leaves(np_tree(ref)))


def test_lm_loss_matches_reference():
    """The chunked cross-entropy (chunks smaller than the sequence) and
    the MoE auxiliaries in the loss."""
    jcfg, tcfg, params, m = models("granite-moe-1b-a400m", "float32")
    toks, _ = _inputs(jcfg, S=20)
    mask = (np.arange(21) % 5 != 0).astype(np.float32)[None].repeat(2, 0)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks[:, ::-1]),
          "mask": jnp.asarray(mask)}
    tb = {"tokens": torch.from_numpy(toks),
          "labels": torch.from_numpy(toks[:, ::-1].copy()),
          "mask": torch.from_numpy(mask)}
    want, wm = jitted(jlm.lm_loss, cfg=jcfg, loss_chunk=8)(params, jb)
    got, gm = lm.lm_loss(m, tb, tcfg, loss_chunk=8)
    assert abs(float(got) - float(want)) < F32_TOL * abs(float(want))
    for k in ("ce", "load_balance_loss", "router_z_loss",
              "dropped_fraction"):
        assert abs(float(gm[k]) - float(wm[k])) < F32_TOL * max(
            abs(float(wm[k])), 1.0), k


@pytest.mark.parametrize("arch,dtype", [("zamba2-7b", "bfloat16"),
                                        ("gemma2-9b", "float32"),
                                        ("xlstm-125m", "bfloat16")])
def test_tree_from_lm_round_trips_bitwise(arch, dtype):
    """``convert.tree_from_lm`` gives the reference's tree back from the
    port's model: the same structure, dtypes (bf16 as ``ml_dtypes``'
    bfloat16, loaded here beside the reference) and bits as the tree the
    model was built from, periods stacked on axis 0; and
    ``lm_from_tree(tree_from_lm(lm))`` holds the model's bits."""
    from repro_torch.models import convert
    jcfg, tcfg, params, m = models(arch, dtype)
    tree, ref = convert.tree_from_lm(m, tcfg), np_tree(params)
    assert jax.tree_util.tree_structure(tree) == \
        jax.tree_util.tree_structure(ref)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(ref)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    back = convert.lm_from_tree(tree, tcfg, device="cpu")
    for (n, p), (n2, q) in zip(m.named_parameters(), back.named_parameters()):
        assert n == n2 and p.dtype == q.dtype
        assert torch.equal(p.view(torch.uint8), q.view(torch.uint8)), n
