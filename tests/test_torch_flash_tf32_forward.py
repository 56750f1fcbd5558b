"""The float32 flash forward as ``fold_fwd_tf32`` computes it, held
against the JAX reference.

``fold_fwd_tf32`` (``csrc/attn_fold_tc.cu``) forms both products of a
cell, s = q·kᵀ and p·v, as three TF32 products of the operands split into
hi + lo. ``cuda_fold.matmul_3xtf32`` states that arithmetic in plain
PyTorch; passed to ``softmax_pair_kernel_spec(matmul=...)`` it runs
through the plain carry fold and the plain split pass with its chain. The
same numpy inputs go through the reference's forward (the engine's Pallas
fold in interpret mode, with its (m, l) statistics), and out, m and l must
meet the reference tests' float32 forward bar, 1e-5 / 1e-5
(tests/test_flash_engine.py:99). The kernel itself runs only on the card
(``tests/test_torch_cuda_kernels.py``).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.flash_attention import (
    flash_attention_kernel as j_kernel)
from repro_torch.core.scan.assoc import softmax_pair_kernel_spec
from repro_torch.kernels.flash_attention import ref
from repro_torch.kernels.flash_attention.flash_attention import forward_fold
from repro_torch.kernels.scan_engine import cuda_fold, schedules
from test_torch_flash_backward import TF32_CONFIGS

SCHEDULES = ("carry", "decoupled")
FWD_TOL = 1e-5   # tests/test_flash_engine.py:99
IDS = [c[0] for c in TF32_CONFIGS]


@functools.lru_cache(maxsize=None)
def _reference(cfg):
    """(q, k, v) of ``cfg`` from seeded numpy, the keywords, and the
    reference's (out, m, l)."""
    name, hkv, g, tq, tk, d, causal, window, softcap, kv_len, bq, bk = cfg
    rng = np.random.default_rng(sum(map(ord, name)) + 1)
    q = rng.standard_normal((hkv * g, tq, d)).astype(np.float32)
    k, v = (rng.standard_normal((hkv, tk, d)).astype(np.float32)
            for _ in range(2))
    kw = dict(group=g, scale=d ** -0.5, causal=causal, window=window,
              softcap=softcap, kv_len=kv_len, block_q=bq, block_k=bk)
    want = j_kernel(*(jnp.asarray(x) for x in (q, k, v)), return_stats=True,
                    interpret=True, **kw)
    return (q, k, v), kw, tuple(np.asarray(w) for w in want)


def _port(cfg, matmul):
    """The port's (out, m, l) through the plain fold with ``matmul``, by
    schedule, and the reference's."""
    ops_, kw, want = _reference(cfg)
    mask = {n: kw[n] for n in ("scale", "causal", "window", "softcap",
                               "kv_len", "block_q", "block_k")}
    spec = softmax_pair_kernel_spec(with_stats=True, matmul=matmul, **mask)
    tops = tuple(torch.from_numpy(x) for x in ops_)
    got = {}
    for s in SCHEDULES:
        _, lay = forward_fold(tops[0].shape, tops[1].shape, schedule=s,
                              return_stats=True, **kw)
        fold = (schedules.fold_carry_plain if s == "carry"
                else schedules.fold_decoupled_plain)
        got[s] = fold(tops, spec, lay)
    return got, want


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("cfg", TF32_CONFIGS, ids=IDS)
def test_3xtf32_forward_meets_the_reference_bar(cfg, schedule):
    """out, m and l with the cell's two products each as three TF32
    products of the split operands (fold_fwd_tf32's arithmetic) meet the
    reference tests' float32 forward bar against the reference's forward,
    under the carry fold and under the split pass with its chain; d = 256
    with softcap 50 among the cases."""
    got, want = _port(cfg, cuda_fold.matmul_3xtf32)
    got = got[schedule]
    assert len(got) == len(want) == 3
    for leaf, (a, b) in enumerate(zip(got, want)):
        assert bool(torch.isfinite(a).all())
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), b, rtol=FWD_TOL, atol=FWD_TOL,
                                   err_msg=f"{cfg[0]}/{schedule} leaf {leaf}")


def test_one_tf32_product_misses_the_forward_bar():
    """Why three products: with each product one TF32 product (~11 bits
    an operand), the forward misses the float32 bar the three meet."""

    def one_tf32(a, b):
        return torch.matmul(cuda_fold.tf32_round(a.float()),
                            cuda_fold.tf32_round(b.float()))

    got, want = _port(TF32_CONFIGS[0], one_tf32)
    err = max(float(np.abs(a.numpy() - b).max())
              for a, b in zip(got["carry"], want))
    assert err > 10 * FWD_TOL, err


@pytest.mark.parametrize("cfg", TF32_CONFIGS, ids=IDS)
def test_3xtf32_forward_bounds_do_not_move_a_bit(cfg):
    """The cell's element is formed from zero and then combined, so
    skipping the dead cells (the KV bounds) gives the bits of folding
    their identity elements, with the 3xTF32 products as with any."""
    ops_, kw, _ = _reference(cfg)
    mask = {n: kw[n] for n in ("scale", "causal", "window", "softcap",
                               "kv_len", "block_q", "block_k")}
    spec = softmax_pair_kernel_spec(with_stats=True,
                                    matmul=cuda_fold.matmul_3xtf32, **mask)
    tops = tuple(torch.from_numpy(x) for x in ops_)
    outs = []
    for bounds in (True, False):
        _, lay = forward_fold(tops[0].shape, tops[1].shape,
                              return_stats=True, use_kv_bounds=bounds, **kw)
        outs.append(schedules.fold_carry_plain(tops, spec, lay))
    for a, b in zip(*outs):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("cfg", TF32_CONFIGS, ids=IDS)
def test_split_payload_ref_is_the_split_pass(cfg):
    """``ref.split_payload_ref``, the dense statement of the split pass's
    chunk payloads (m, l, acc) that the card holds ``fold_fwd_tf32`` to in
    float64, gives the plain split pass's payloads within the forward bar
    (from float64 inputs; fully masked chunks' m is NEG_INF in both)."""
    ops_, kw, _ = _reference(cfg)
    tops = tuple(torch.from_numpy(x) for x in ops_)
    spec, lay = forward_fold(tops[0].shape, tops[1].shape,
                             schedule="decoupled", return_stats=True, **kw)
    want = schedules.fold_totals_plain(tops, spec, lay)
    got = ref.split_payload_ref(*(t.double() for t in tops), spec, lay)
    assert len(got) == len(want) == 3
    for leaf, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == torch.float64 and a.shape == b.shape
        np.testing.assert_allclose(a.float().numpy(), b.numpy(), rtol=FWD_TOL,
                                   atol=FWD_TOL,
                                   err_msg=f"{cfg[0]} leaf {leaf}")
