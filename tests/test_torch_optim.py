"""The port's optimizer (``repro_torch.optim``) against the reference's
on the same inputs: ``cosine_schedule`` within one float32 ulp of its
peak rate at every step of a few warmup / total pairs, ``global_norm`` within 1e-6
relative, ``adamw_update`` within 1e-6 over several steps (a bf16
parameter's float32 master never aliases it, nor a float32 one's), and
``compress_grads`` / ``decompress_grads`` bit for bit: the int8 blocks,
their scales and the error feedback, over ragged leaf sizes (rounding is
half to even in both)."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro.optim import compression as jcomp
from repro.optim import schedule as jsched
from repro_torch.optim import adamw, compression, schedule


def _tree(seed, bf16=False):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((6, 40)).astype(np.float32)
    return {"w": w.astype(ml_dtypes.bfloat16) if bf16 else w,
            "blocks": {"n": rng.standard_normal((2, 40)).astype(np.float32),
                       "b": rng.standard_normal((9,)).astype(np.float32)}}


def _torch(tree):
    def one(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(a.copy())
    return jax.tree.map(one, tree)


def _np(t):
    if t.dtype == torch.bfloat16:
        return t.float().numpy()
    return t.numpy()


@pytest.mark.parametrize("warmup,total", ((10, 100), (0, 50), (1, 4),
                                          (100, 10_000), (2000, 3000)))
def test_cosine_schedule_within_one_ulp(warmup, total):
    """Within one float32 ulp of the schedule's scale (its peak rate) at
    every step. The ulp of each value cannot be the bar: the float32
    cosines of XLA and torch differ in their last bit, and near the end
    of the decay ``1 + cos`` cancels, so one ulp of the cosine is several
    of the value (the reference's own compiled and eager forms differ by
    up to 8 ulps of the value there, 2 of the peak)."""
    peak = np.float32(3e-4)
    for s in range(total + 11):
        want = np.float32(jsched.cosine_schedule(
            s, peak_lr=3e-4, warmup_steps=warmup, total_steps=total))
        got = schedule.cosine_schedule(s, peak_lr=3e-4, warmup_steps=warmup,
                                       total_steps=total)
        assert got.dtype == torch.float32
        got = np.float32(got.item())
        assert abs(got - want) <= np.spacing(peak), (s, got, want)


def test_cosine_schedule_on_a_tensor_step():
    got = schedule.cosine_schedule(torch.tensor(7), warmup_steps=5,
                                   total_steps=20)
    want = jsched.cosine_schedule(jnp.asarray(7), warmup_steps=5,
                                  total_steps=20)
    assert abs(got.item() - float(want)) <= 1e-10


@pytest.mark.parametrize("seed", range(3))
def test_global_norm_matches(seed):
    tree = _tree(seed)
    want = float(jadamw.global_norm(jax.tree.map(jnp.asarray, tree)))
    got = adamw.global_norm(_torch(tree)).item()
    assert abs(got - want) <= 1e-6 * want


@pytest.mark.parametrize("bf16", (False, True), ids=("f32", "bf16"))
def test_adamw_update_matches_reference(bf16):
    """Five steps on the same gradients, a clipped one among them (norm
    past ``grad_clip``) and a scheduled rate: parameters, moments and
    masters within 1e-6, the step counter and metrics alike; the master
    never shares memory with its parameter."""
    params = _tree(0, bf16)
    jp, tp = jax.tree.map(jnp.asarray, params), _torch(params)
    js, ts = jadamw.adamw_init(jp), adamw.adamw_init(tp)
    for k in ("w",):
        assert ts.master[k].data_ptr() != tp[k].data_ptr()
    assert ts.master["blocks"]["n"].data_ptr() != tp["blocks"]["n"].data_ptr()
    cfg_j = jadamw.AdamWConfig(lr=1e-2, grad_clip=1.0)
    cfg_t = adamw.AdamWConfig(lr=1e-2, grad_clip=1.0)
    for i in range(5):
        g = _tree(10 + i)
        scale = 3.0 if i == 2 else 0.01
        g = jax.tree.map(lambda a: (a * scale).astype(np.float32), g)
        lr = float(jsched.cosine_schedule(i, warmup_steps=2, total_steps=5,
                                          peak_lr=1e-2))
        jp, js, jm = jadamw.adamw_update(jax.tree.map(jnp.asarray, g), js,
                                         jp, cfg_j, lr=lr)
        tp, ts, tm = adamw.adamw_update(_torch(g), ts, tp, cfg_t, lr=lr)
        assert int(ts.step) == int(js.step) == i + 1
        for got, want in ((tp, jp), (ts.mu, js.mu), (ts.nu, js.nu),
                          (ts.master, js.master)):
            for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
                b = np.asarray(b, np.float32)
                assert np.abs(_np(a).astype(np.float32) - b).max() <= \
                    1e-6 * max(1.0, np.abs(b).max())
        assert abs(tm["grad_norm"].item() - float(jm["grad_norm"])) <= \
            1e-6 * float(jm["grad_norm"])
        assert tp["w"].dtype == (torch.bfloat16 if bf16 else torch.float32)
        for k in ("w",):
            assert ts.master[k].data_ptr() != tp[k].data_ptr()


def test_adamw_decays_by_leaf_dimensions():
    """Decay only on leaves of ``decay_min_ndim`` dimensions or more: a
    zero gradient moves a matrix by ``lr * wd * w`` and leaves a vector."""
    p = {"m": torch.ones((2, 3)), "v": torch.ones(3)}
    g = {"m": torch.zeros((2, 3)), "v": torch.zeros(3)}
    new, _, _ = adamw.adamw_update(g, adamw.adamw_init(p), p,
                                   adamw.AdamWConfig(lr=0.5,
                                                     weight_decay=0.1))
    assert torch.allclose(new["m"], torch.full((2, 3), 1 - 0.05))
    assert torch.equal(new["v"], p["v"])


@pytest.mark.parametrize("sizes", ((256,), (1,), (255, 257), (3, 700, 5),
                                   (40, 6)), ids=str)
def test_compression_bitwise(sizes):
    rng = np.random.default_rng(len(sizes) + sum(sizes))
    grads = {f"g{i}": (rng.standard_normal((n,)) *
                       10.0 ** rng.integers(-6, 3)).astype(np.float32)
             for i, n in enumerate(sizes)}
    grads["m"] = rng.standard_normal((3, 7)).astype(np.float32)
    grads["m"][1] = 0.0                       # a block of zeros
    err = {k: (rng.standard_normal(v.shape) * 1e-3).astype(np.float32)
           for k, v in grads.items()}
    jq, je = jcomp.compress_grads(jax.tree.map(jnp.asarray, grads),
                                  jax.tree.map(jnp.asarray, err))
    tq, te = compression.compress_grads(_torch(grads), _torch(err))
    for k in grads:
        assert tq[k][0].dtype == torch.int8
        assert np.array_equal(tq[k][0].numpy(), np.asarray(jq[k][0])), k
        assert tq[k][1].numpy().tobytes() == np.asarray(jq[k][1]).tobytes()
        assert te[k].numpy().tobytes() == np.asarray(je[k]).tobytes(), k
    jd = jcomp.decompress_grads(jq, grads)
    td = compression.decompress_grads(tq, _torch(grads))
    for k in grads:
        assert td[k].numpy().tobytes() == np.asarray(jd[k]).tobytes(), k
    # a second round carries the first one's error feedback
    jq2, je2 = jcomp.compress_grads(jax.tree.map(jnp.asarray, grads), je)
    tq2, te2 = compression.compress_grads(_torch(grads), te)
    for k in grads:
        assert np.array_equal(tq2[k][0].numpy(), np.asarray(jq2[k][0]))
        assert te2[k].numpy().tobytes() == np.asarray(je2[k]).tobytes()


def test_init_error_feedback_zeros():
    ef = compression.init_error_feedback({"a": torch.ones((2, 3),
                                                         dtype=torch.bfloat16)})
    assert ef["a"].dtype == torch.float32 and not ef["a"].any()
