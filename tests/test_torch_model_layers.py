"""The port's model layers (``repro_torch.models.layers``) against the
reference's: each layer function on the same weights (the reference's
init, float32 leaves moved off their constants, carried across by
``repro_torch.models.convert``) and the same seeded inputs, route by
route — norms, rope, embedding and logits, MLP, the frontend adapter,
attention (dense, blockwise, banded, flash, the ring buffer, the
full-cache and padded-cache prefills, the per-row append, the paged
gather and scatter, cross-attention), the Mamba2 SSD (chunked, the
kernel route, a prior state, the recurrent step) and xLSTM. Tolerances:
``tests/_torch_model_bridge.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_model_bridge import (BF16_TOL_HIDDEN, F32_TOL, cfgs, jitted,
                                 normal, perturbed, port, rel_err)
from repro.models.layers import attention as jattn
from repro.models.layers import embedding as jemb
from repro.models.layers import frontend as jfront
from repro.models.layers import mlp as jmlp
from repro.models.layers import norms as jnorms
from repro.models.layers import rope as jrope
from repro.models.layers import ssm as jssm
from repro.models.layers import xlstm as jxlstm
from repro_torch.models.layers import (attention, embedding, frontend, mlp,
                                       norms, rope, ssm, xlstm)


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm", "gemma_rmsnorm"])
def test_norm_matches_reference(kind):
    jcfg, tcfg = cfgs("stablelm-12b", dtype="float32", norm=kind)
    tree = perturbed(jnorms.init_norm(jcfg))
    m = port(norms.Norm(tcfg, device="cpu"), tree)
    x = normal((2, 5, jcfg.d_model))
    want = jnorms.apply_norm(tree, jnp.asarray(x), jcfg)
    assert rel_err(norms.apply_norm(m, torch.from_numpy(x), tcfg),
                   want) < F32_TOL
    w = normal((16,), 1)
    xh = normal((2, 5, 4, 16), 2)
    want = jnorms.rms_norm_headwise(jnp.asarray(w), jnp.asarray(xh))
    got = norms.rms_norm_headwise(torch.from_numpy(w), torch.from_numpy(xh))
    assert rel_err(got, want) < F32_TOL


@pytest.mark.parametrize("per_row", [False, True])
def test_rope_matches_reference(per_row):
    x = normal((2, 4, 6, 16))
    pos = (np.array([[3, 4, 5, 6, 7, 8], [0, 1, 2, 3, 4, 5]])[:, None]
           if per_row else np.arange(6) + 11)
    want = jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    got = rope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                          10_000.0)
    assert rel_err(got, want) < F32_TOL


@pytest.mark.parametrize("arch", ["gemma2-9b", "phi3-medium-14b"])
def test_embedding_and_logits_match_reference(arch):
    """Tied (gemma2: sqrt(d) scaling, final softcap) and untied (phi3)."""
    jcfg, tcfg = cfgs(arch, dtype="float32")
    tree = jemb.init_embedding(jax.random.PRNGKey(0), jcfg)
    m = torch.nn.Module()
    m.embed = embedding.Embedding(tcfg, device="cpu")
    if not tcfg.tie_embeddings:
        m.lm_head = embedding.init_lm_head(tcfg, device="cpu")
    port(m, tree)
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 7))
    want = jemb.embed_tokens(tree, jnp.asarray(toks), jcfg)
    got = embedding.embed_tokens(m, torch.from_numpy(toks), tcfg)
    assert rel_err(got, want) < F32_TOL
    h = normal((2, 7, jcfg.d_model))
    want = jemb.lm_logits(tree, jnp.asarray(h), jcfg)
    got = embedding.lm_logits(m, torch.from_numpy(h), tcfg)
    assert got.dtype == torch.float32
    assert rel_err(got, want) < F32_TOL


@pytest.mark.parametrize("gated,act", [(True, "silu"), (True, "gelu"),
                                       (False, "relu"), (False, "gelu")])
def test_mlp_matches_reference(gated, act):
    jcfg, tcfg = cfgs("stablelm-12b", dtype="float32", gated_mlp=gated,
                      act=act)
    tree = jmlp.init_mlp(jax.random.PRNGKey(1), jcfg)
    m = port(mlp.MLP(tcfg, device="cpu"), tree)
    x = normal((2, 5, jcfg.d_model))
    want = jmlp.apply_mlp(tree, jnp.asarray(x), jcfg)
    assert rel_err(mlp.apply_mlp(m, torch.from_numpy(x), tcfg),
                   want) < F32_TOL


def test_frontend_matches_reference():
    jcfg, tcfg = cfgs("llava-next-mistral-7b")
    tree = perturbed(jfront.init_frontend(jax.random.PRNGKey(2), jcfg))
    m = port(frontend.Frontend(tcfg, device="cpu"), tree)
    e = normal((2, 3, frontend.FRONTEND_DIM))
    want = jfront.apply_frontend(tree, jnp.asarray(e), jcfg)
    got = frontend.apply_frontend(m, torch.from_numpy(e), tcfg)
    assert got.dtype == torch.bfloat16
    assert rel_err(got, want) < BF16_TOL_HIDDEN


def _attn(arch="gemma2-9b", **over):
    jcfg, tcfg = cfgs(arch, dtype="float32", **over)
    tree = perturbed(jattn.init_attention(jax.random.PRNGKey(3), jcfg))
    return jcfg, tcfg, tree, port(attention.Attention(tcfg, device="cpu"),
                                  tree)


def _both(jcfg, tcfg, tree, m, x, cache=None, cache_len=None,
          positions=None, **kw):
    """(reference, port) (out, new_cache) of one attention call; numpy
    ``cache`` leaves, ``cache_len`` and ``positions``."""
    def j(v):
        return None if v is None else jnp.asarray(v)

    def t(v):
        return None if v is None else torch.from_numpy(np.asarray(v))
    jl = None if cache_len is None else jnp.asarray(cache_len, jnp.int32)
    tl = None if cache_len is None else torch.tensor(cache_len,
                                                     dtype=torch.int32)
    want = jitted(jattn.apply_attention, cfg=jcfg, **kw)(
        tree, jnp.asarray(x), cache=None if cache is None else {
            k: j(v) for k, v in cache.items()},
        cache_len=jl, positions=j(positions))
    got = attention.apply_attention(
        m, torch.from_numpy(x), tcfg, cache=None if cache is None else {
            k: t(v) for k, v in cache.items()},
        cache_len=tl, positions=t(positions), **kw)
    return want, got


# (name, arch, kind, S, impl, cache slots or None, cache_len)
ATTN_CASES = [
    ("dense", "gemma2-9b", "global", 24, None, None, None),
    ("blockwise", "gemma2-9b", "global", 24, "blockwise", None, None),
    ("banded", "gemma2-9b", "local", 64, None, None, None),
    ("flash", "gemma2-9b", "global", 40, "flash", None, None),
    ("flash_local", "gemma3-12b", "local", 40, "flash", None, None),
    ("qk_norm_local_theta", "gemma3-12b", "local", 24, "dense", None, None),
    ("dense_local", "gemma2-9b", "local", 64, "dense", None, None),
    ("ring_prefill_banded", "gemma2-9b", "local", 64, None, 80, 0),
    # a ring prefill past one 512-query block, not a multiple of it: dense
    ("ring_prefill_dense", "gemma2-9b", "local", 520, None, 80, 0),
    ("padded_flash_prefill", "gemma2-9b", "global", 24, "flash", 32, 0),
    ("padded_dense_prefill", "phi3-medium-14b", "global", 24, None, 32, 0),
    ("flash_mid_stream_dense", "gemma2-9b", "global", 4, "flash", 32, 8),
    ("decode", "gemma2-9b", "global", 1, None, 32, 17),
    ("decode_ring", "gemma2-9b", "local", 1, None, 80, 45),
    ("decode_per_row", "gemma2-9b", "global", 1, None, 32, [5, 17]),
    ("decode_ring_per_row", "gemma3-12b", "local", 1, None, 80, [5, 45]),
]


@pytest.mark.parametrize("case", ATTN_CASES, ids=[c[0] for c in ATTN_CASES])
def test_attention_route_matches_reference(case):
    _, arch, kind, S, impl, slots, cache_len = case
    jcfg, tcfg, tree, m = _attn(arch)
    x = normal((2, S, jcfg.d_model), 4)
    cache = None
    if slots is not None:
        c = jattn.init_kv_cache(jcfg, 2, slots, kind)
        cache = {k: normal(v.shape, 5 + i) for i, (k, v) in
                 enumerate(c.items())}
        if np.ndim(cache_len) == 0 and cache_len == 0:
            cache = {k: np.zeros_like(v) for k, v in cache.items()}
    positions = None
    if np.ndim(cache_len) == 1:
        positions = np.asarray(cache_len)[:, None] + np.arange(S)[None]
    elif cache_len:
        positions = cache_len + np.arange(S)
    want, got = _both(jcfg, tcfg, tree, m, x, cache, cache_len, positions,
                      kind=kind, impl=impl)
    assert rel_err(got[0], want[0]) < F32_TOL
    if slots is None:
        assert got[1] is None and want[1] is None
    else:
        for key in ("k", "v"):
            assert rel_err(got[1][key], want[1][key]) < F32_TOL


def test_attention_full_cache_prefill_matches_reference():
    """A global layer's prefill filling its whole cache past 4096 tokens:
    the blockwise fold (impl None) and the flash fold (impl "flash"),
    the cache written directly."""
    jcfg, tcfg, tree, m = _attn("phi3-medium-14b", d_model=16, num_heads=2,
                                num_kv_heads=1, head_dim=8)
    S = 4104
    x = normal((1, S, 16), 6)
    zeros = {k: np.zeros((1, 1, S, 8), np.float32) for k in ("k", "v")}
    for impl in (None, "flash"):
        want, got = _both(jcfg, tcfg, tree, m, x, zeros, 0, impl=impl)
        assert rel_err(got[0], want[0]) < F32_TOL
        for key in ("k", "v"):
            assert rel_err(got[1][key], want[1][key]) < F32_TOL


def test_attention_paged_decode_matches_reference_and_contiguous():
    """The paged route: gathered through a page table, the token scattered
    back to its page; == the reference's, and bitwise the port's own
    contiguous decode over the same values."""
    from repro_torch.serve import paging
    jcfg, tcfg, tree, m = _attn("gemma2-9b")
    ps, n_log, P = 8, 4, 12
    pt = np.zeros((2, n_log), np.int32)
    pt[0, :3] = [4, 9, 2]
    pt[1, :2] = [7, 11]
    pools = {k: normal((P, 2, ps, 16), 9 + i)
             for i, k in enumerate(("k_pages", "v_pages"))}
    lens = np.array([19, 10])
    x = normal((2, 1, jcfg.d_model), 10)
    pos = lens[:, None]
    want_out, want_c = jitted(jattn.apply_attention, cfg=jcfg)(
        tree, jnp.asarray(x), positions=jnp.asarray(pos),
        cache={"k_pages": jnp.asarray(pools["k_pages"]),
               "v_pages": jnp.asarray(pools["v_pages"]),
               "pt": jnp.asarray(pt)},
        cache_len=jnp.asarray(lens, jnp.int32))
    tcache = {"k_pages": torch.from_numpy(pools["k_pages"]),
              "v_pages": torch.from_numpy(pools["v_pages"]),
              "pt": torch.from_numpy(pt)}
    got_out, got_c = attention.apply_attention(
        m, torch.from_numpy(x), tcfg, positions=torch.from_numpy(pos),
        cache=tcache, cache_len=torch.from_numpy(lens))
    assert rel_err(got_out, want_out) < F32_TOL
    for key in ("k_pages", "v_pages"):
        assert rel_err(got_c[key], want_c[key]) < F32_TOL
    assert torch.equal(got_c["pt"], tcache["pt"])
    # the port's contiguous cache holding the gathered values
    contig = {k: paging.gather_pages(tcache[k + "_pages"], tcache["pt"])
              for k in ("k", "v")}
    c_out, c_c = attention.apply_attention(
        m, torch.from_numpy(x), tcfg, positions=torch.from_numpy(pos),
        cache=contig, cache_len=torch.from_numpy(lens))
    assert torch.equal(c_out, got_out)
    for k in ("k", "v"):
        assert torch.equal(
            paging.gather_pages(got_c[k + "_pages"], tcache["pt"]), c_c[k])


def test_cross_attention_matches_reference():
    jcfg, tcfg, tree, m = _attn("gemma3-12b")
    x, mem = normal((2, 5, jcfg.d_model), 11), normal((2, 9, jcfg.d_model),
                                                      12)
    want = jattn.apply_cross_attention(tree, jnp.asarray(x),
                                       jnp.asarray(mem), jcfg)
    got = attention.apply_cross_attention(m, torch.from_numpy(x),
                                          torch.from_numpy(mem), tcfg)
    assert rel_err(got, want) < F32_TOL


def _ssm_layer():
    jcfg, tcfg = cfgs("zamba2-7b", dtype="float32")
    tree = perturbed(jssm.init_ssm(jax.random.PRNGKey(4), jcfg))
    return jcfg, tcfg, tree, port(ssm.SSM(tcfg, device="cpu"), tree)


# (name, T, cache: None | "zero" | "state", impl)
SSM_CASES = [
    ("train_chunked", 300, None, "auto"),
    ("train_kernel", 300, None, "kernel"),
    ("serve_auto", 200, "zero", "auto"),
    ("serve_kernel", 200, "zero", "kernel"),
    ("continue_state_chunked", 77, "state", "chunked"),
    ("continue_state_kernel", 77, "state", "kernel"),
    ("decode_step", 1, "state", "auto"),
]


@pytest.mark.parametrize("case", SSM_CASES, ids=[c[0] for c in SSM_CASES])
def test_ssm_matches_reference(case):
    """Chunked SSD (T not a chunk multiple: padded), the kernel route
    (Pallas interpret on the reference, plain versions on the port), a
    prior state to continue from, and the T = 1 recurrent step."""
    _, T, kind, impl = case
    jcfg, tcfg, tree, m = _ssm_layer()
    x = normal((2, T, jcfg.d_model), 13)
    cache = None
    if kind is not None:
        c = jssm.init_ssm_cache(jcfg, 2)
        cache = {k: (np.zeros(v.shape, np.float32) if kind == "zero"
                     else 0.5 * normal(v.shape, 14 + i))
                 for i, (k, v) in enumerate(c.items())}
    want_y, want_c = jitted(jssm.apply_ssm, cfg=jcfg, impl=impl)(
        tree, jnp.asarray(x),
        cache=None if cache is None else {k: jnp.asarray(v)
                                          for k, v in cache.items()})
    got_y, got_c = ssm.apply_ssm(
        m, torch.from_numpy(x), tcfg, impl=impl,
        cache=None if cache is None else {k: torch.from_numpy(v)
                                          for k, v in cache.items()})
    assert rel_err(got_y, want_y) < F32_TOL
    if cache is None:
        assert got_c is None and want_c is None
    else:
        for key in ("conv", "h"):
            assert rel_err(got_c[key], want_c[key]) < F32_TOL


def test_ssm_auto_takes_the_chunked_route_on_the_cpu(monkeypatch):
    """On CPU tensors ``impl="auto"`` never reaches the kernels (the
    reference's route off a TPU), with or without a cache."""
    from repro_torch.kernels.ssm_scan import ops as kops
    monkeypatch.setattr(kops, "ssm_scan",
                        lambda *a, **k: pytest.fail("kernel route taken"))
    _, tcfg, _, m = _ssm_layer()
    x = torch.from_numpy(normal((1, 40, tcfg.d_model)))
    ssm.apply_ssm(m, x, tcfg)
    ssm.apply_ssm(m, x, tcfg, cache=ssm.init_ssm_cache(tcfg, 1,
                                                       device="cpu"))


# (name, layer, T, cache)
XLSTM_CASES = [
    ("mlstm_chunked", "mlstm", 70, None),
    ("mlstm_state", "mlstm", 40, "state"),
    ("mlstm_step", "mlstm", 1, "state"),
    ("slstm", "slstm", 12, None),
    ("slstm_state", "slstm", 5, "state"),
]


@pytest.mark.parametrize("case", XLSTM_CASES, ids=[c[0] for c in XLSTM_CASES])
def test_xlstm_matches_reference(case):
    _, layer, T, kind = case
    jcfg, tcfg = cfgs("xlstm-125m", dtype="float32")
    init = getattr(jxlstm, f"init_{layer}")
    tree = perturbed(init(jax.random.PRNGKey(5), jcfg))
    cls = xlstm.MLSTM if layer == "mlstm" else xlstm.SLSTM
    m = port(cls(tcfg, device="cpu"), tree)
    x = normal((2, T, jcfg.d_model), 15)
    cache = None
    if kind:
        c = getattr(jxlstm, f"init_{layer}_cache")(jcfg, 2)
        cache = {k: np.asarray(v) + 0.3 * np.abs(normal(v.shape, 16 + i))
                 for i, (k, v) in enumerate(c.items())}
    apply_j = getattr(jxlstm, f"apply_{layer}")
    apply_t = getattr(xlstm, f"apply_{layer}")
    want_y, want_c = jitted(apply_j, cfg=jcfg)(
        tree, jnp.asarray(x),
        cache=None if cache is None else {k: jnp.asarray(v)
                                          for k, v in cache.items()})
    got_y, got_c = apply_t(
        m, torch.from_numpy(x), tcfg,
        cache=None if cache is None else {k: torch.from_numpy(v)
                                          for k, v in cache.items()})
    assert rel_err(got_y, want_y) < F32_TOL
    if cache is not None:
        for key in cache:
            assert rel_err(got_c[key], want_c[key]) < F32_TOL


# ---------------------------------------------------------------------------
# the single-device sharding surface every layer calls
# ---------------------------------------------------------------------------


class _Mesh:
    """A mesh as the port reads one: axis name -> size."""

    def __init__(self, **shape):
        self.shape = shape


def test_sharding_resolves_as_reference():
    """``resolve`` gives the reference's PartitionSpec entries with no mesh
    and under a one-device (data, model) mesh, with and without rule
    overrides; ``shard`` is the identity without a mesh and under one
    device, and raises past one (the torch.distributed slice)."""
    from jax.sharding import Mesh
    from repro.dist import sharding as jsharding
    from repro_torch.dist import sharding
    axes = [("batch", "seq", "embed"), ("batch", None, "heads", "vocab"),
            ("experts", "capacity", "mlp"), ("unknown", "ssm_inner")]
    for ax in axes:
        assert sharding.resolve(ax) == tuple(jsharding.resolve(ax))
    jmesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                 ("data", "model"))
    for rules in (None, {"seq": "model", "batch": ("data",)}):
        with jsharding.use_mesh(jmesh, rules), \
                sharding.use_mesh(_Mesh(data=1, model=1), rules):
            assert sharding.current_rules() == jsharding.current_rules()
            for ax in axes:
                assert sharding.resolve(ax) == tuple(jsharding.resolve(ax))
            x = torch.ones(2, 3)
            assert sharding.shard(x, "batch", "embed") is x
    assert sharding.current_mesh() is None
    x = torch.ones(2, 3)
    assert sharding.shard(x, "batch", "embed") is x
    with sharding.use_mesh(_Mesh(data=2, model=1)):
        with pytest.raises(NotImplementedError):
            sharding.shard(x, "batch", "embed")
