"""The port's trainer loop, fault tolerance, checkpoint/restart and
optimizer (``tests/test_train_checkpoint.py`` re-run on the port, case by
case), the same trainer scenario in both packages, and the checkpoint
format held bit for bit across the packages: a checkpoint either one
writes restores in the other with the same bits, and the same tree gives
the same files."""

import dataclasses
import filecmp
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from _torch_train_bridge import as_tree, max_leaf_err, port_params
from repro import configs as jconfigs
from repro.checkpoint import manager as jmanager
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticDataset as JSyntheticDataset
from repro.optim import adamw as jadamw
from repro.train import step as jstep
from repro.train import trainer as jtrainer
from repro_torch import configs
from repro_torch.checkpoint.manager import (CheckpointManager, latest_step,
                                            restore_checkpoint,
                                            save_checkpoint)
from repro_torch.data import DataConfig, SyntheticDataset
from repro_torch.optim import adamw_init
from repro_torch.optim.adamw import AdamWConfig, adamw_update, global_norm
from repro_torch.optim.schedule import cosine_schedule
from repro_torch.train.step import (TrainStepConfig, init_params,
                                    make_train_step)
from repro_torch.train.trainer import (Trainer, TrainerConfig,
                                       _StragglerTracker)


@pytest.fixture
def tmp_ckpt(tmp_path):
    return str(tmp_path / "ckpt")


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _tiny_setup(arch="xlstm-125m", steps=6, **tkw):
    cfg = configs.get_smoke_config(arch)
    params = init_params(cfg, generator=_gen(), device="cpu")
    opt = adamw_init(params)
    step = make_train_step(cfg, TrainStepConfig(remat=False,
                                                total_steps=steps, **tkw))
    ds = SyntheticDataset(DataConfig(
        seq_len=32, global_batch=2, vocab_size=cfg.vocab_size), device="cpu")
    return cfg, params, opt, step, ds


def _flat(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k])
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _flat(x)
    else:
        yield tree


def _same_bits(a, b):
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.is_floating_point and a.element_size() in (2, 4):
        view = {2: torch.int16, 4: torch.int32}[a.element_size()]
        return torch.equal(a.view(view), b.view(view))
    return torch.equal(a, b)


def test_loss_decreases(tmp_ckpt):
    cfg, params, opt, step, ds = _tiny_setup(steps=30)
    tr = Trainer(step, ds, TrainerConfig(
        total_steps=30, checkpoint_every=100, checkpoint_dir=tmp_ckpt,
        log_every=100))
    tr.run(params, opt)
    first = np.mean([h["loss"] for h in tr.history[:5]])
    last = np.mean([h["loss"] for h in tr.history[-5:]])
    assert last < first, (first, last)


def test_checkpoint_restart_resumes_exactly(tmp_ckpt):
    """A run of 8 steps with commits at 4 and 8; a fresh trainer restores
    the final commit bit for bit, and one restarted from step 4 reaches
    step 8 with the uninterrupted run's bits."""
    cfg, params, opt, step, ds = _tiny_setup(steps=8)
    tr = Trainer(step, ds, TrainerConfig(
        total_steps=8, checkpoint_every=4, checkpoint_dir=tmp_ckpt,
        log_every=100))
    p_final, o_final = tr.run(params, opt)

    params2 = init_params(cfg, generator=_gen(), device="cpu")
    opt2 = adamw_init(params2)
    tr2 = Trainer(step, ds, TrainerConfig(
        total_steps=8, checkpoint_every=4, checkpoint_dir=tmp_ckpt))
    start, p_r, o_r = tr2.maybe_restore(params2, opt2)
    assert start == 8  # final commit
    for a, b in zip(_flat(p_r), _flat(p_final)):
        assert _same_bits(a, b)
    for a, b in zip(_flat(o_r), _flat(o_final)):
        assert _same_bits(a, b)

    bundle = restore_checkpoint(tmp_ckpt, 4, {"params": params2,
                                              "opt": opt2})
    tr3 = Trainer(step, ds, TrainerConfig(
        total_steps=8, checkpoint_every=100,
        checkpoint_dir=tmp_ckpt + "_resumed"))
    p_res, o_res = tr3.run(bundle["params"], bundle["opt"], start_step=4)
    assert [h["step"] for h in tr3.history] == [4, 5, 6, 7]
    for a, b in zip(_flat(p_res), _flat(p_final)):
        assert _same_bits(a, b)
    assert int(o_res.step) == 8


def test_commit_marker_protects_partial(tmp_ckpt):
    cfg, params, opt, step, ds = _tiny_setup()
    save_checkpoint(tmp_ckpt, 5, {"params": params})
    # simulate a crash mid-write: a step dir without COMMIT
    os.makedirs(os.path.join(tmp_ckpt, "step_9"), exist_ok=True)
    assert latest_step(tmp_ckpt) == 5


def test_checkpoint_retention(tmp_ckpt):
    mgr = CheckpointManager(tmp_ckpt, keep=2)
    x = {"w": torch.arange(4.0)}
    for s in (1, 2, 3, 4):
        mgr.save(s, x, block=True)
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_ckpt)
                   if d.startswith("step_"))
    assert steps == [3, 4]


def test_bf16_roundtrip(tmp_ckpt):
    x = {"w": torch.tensor([1.5, -2.25, 3.0], dtype=torch.bfloat16)}
    save_checkpoint(tmp_ckpt, 1, x)
    back = restore_checkpoint(tmp_ckpt, 1, x)
    assert back["w"].dtype == torch.bfloat16
    assert _same_bits(back["w"], x["w"])


def test_nan_guard_skips_update(tmp_ckpt):
    cfg, params, opt, step, ds = _tiny_setup()
    calls = {"n": 0}

    def poisoned(p, o, b, i):
        calls["n"] += 1
        p2, o2, m = step(p, o, b, i)
        if calls["n"] == 2:
            m = dict(m, loss=torch.tensor(float("nan")))
        return p2, o2, m

    tr = Trainer(poisoned, ds, TrainerConfig(
        total_steps=4, checkpoint_every=100, checkpoint_dir=tmp_ckpt,
        max_nan_skips=2))
    p_out, _ = tr.run(params, opt)
    steps_logged = [h["step"] for h in tr.history]
    assert 1 not in steps_logged          # the poisoned step was skipped
    assert len(tr.history) == 3
    assert tr.nan_skips == 1


def test_step_retry_on_failure(tmp_ckpt):
    cfg, params, opt, step, ds = _tiny_setup()
    boom = {"armed": True}

    def flaky(p, o, b, i):
        if boom["armed"] and int(i) == 2:
            boom["armed"] = False
            raise RuntimeError("simulated preemption")
        return step(p, o, b, i)

    tr = Trainer(flaky, ds, TrainerConfig(
        total_steps=4, checkpoint_every=2, checkpoint_dir=tmp_ckpt,
        max_step_retries=1))
    tr.run(params, opt)
    assert [h["step"] for h in tr.history][-1] == 3  # completed despite fail


def test_straggler_tracker_flags_outlier():
    t = _StragglerTracker(zscore=3.0, min_samples=10)
    for i in range(30):
        assert not t.observe(i, 1.0 + 0.01 * (i % 3))
    assert t.observe(31, 10.0)   # 10s step vs ~1s mean


def test_adamw_converges_quadratic():
    w = {"w": torch.tensor([5.0, -3.0])}
    st = adamw_init(w)
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0)
    for _ in range(200):
        g = {"w": 2 * w["w"]}   # d/dw w^2
        w, st, _ = adamw_update(g, st, w, cfg)
    assert float(w["w"].abs().max()) < 0.1


def test_grad_clip_and_norm():
    g = {"a": torch.tensor([3.0, 4.0])}
    assert abs(float(global_norm(g)) - 5.0) < 1e-6
    w = {"a": torch.zeros(2)}
    st = adamw_init(w)
    _, _, m = adamw_update(g, st, w, AdamWConfig(grad_clip=1.0))
    assert abs(float(m["grad_norm"]) - 5.0) < 1e-5


def test_cosine_schedule_shape():
    lr0 = float(cosine_schedule(0, peak_lr=1.0, warmup_steps=10,
                                total_steps=100))
    lrw = float(cosine_schedule(10, peak_lr=1.0, warmup_steps=10,
                                total_steps=100))
    lre = float(cosine_schedule(100, peak_lr=1.0, warmup_steps=10,
                                total_steps=100, min_ratio=0.1))
    assert lr0 == 0.0 and abs(lrw - 1.0) < 1e-6 and abs(lre - 0.1) < 1e-6


def test_microbatch_equals_full_batch():
    """Gradient accumulation must match the single-batch gradient."""
    cfg = dataclasses.replace(configs.get_smoke_config("phi3-medium-14b"),
                              dtype="float32")
    params = init_params(cfg, generator=_gen(), device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (4, 16), generator=_gen(1))
    batch = {"tokens": toks, "labels": toks,
             "mask": torch.ones((4, 16), dtype=torch.float32)}
    s1 = make_train_step(cfg, TrainStepConfig(microbatches=1, remat=False))
    s2 = make_train_step(cfg, TrainStepConfig(microbatches=2, remat=False))
    p1, _, m1 = s1(params, adamw_init(params), batch, torch.tensor(0))
    p2, _, m2 = s2(params, adamw_init(params), batch, torch.tensor(0))
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-4)
    for a, b in zip(_flat(p1), _flat(p2)):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   rtol=2e-3, atol=2e-5)


def test_data_pipeline_deterministic():
    cfg = DataConfig(seq_len=16, global_batch=2, vocab_size=100, seed=3)
    a = SyntheticDataset(cfg, device="cpu").batch_at(7)
    b = SyntheticDataset(cfg, device="cpu").batch_at(7)
    assert torch.equal(a["tokens"], b["tokens"])
    c = SyntheticDataset(cfg, device="cpu").batch_at(8)
    assert not torch.equal(a["tokens"], c["tokens"])


# -- the same scenario in both packages ---------------------------------


def test_trainer_history_matches_reference(tmp_path):
    """xlstm-125m's SMOKE config in float32, the same weights (the
    reference's init carried across), the same synthetic batches (the data
    pipeline's bits), six steps of each package's Trainer with a commit
    every two: the loss histories within 1e-5, the final parameters within
    1e-4, and the same commits on disk."""
    jcfg = dataclasses.replace(jconfigs.get_smoke_config("xlstm-125m"),
                               dtype="float32")
    tcfg = dataclasses.replace(configs.get_smoke_config("xlstm-125m"),
                               dtype="float32")
    jparams = jstep.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = port_params(jparams, tcfg)
    kw = dict(remat=False, total_steps=6, warmup_steps=2, peak_lr=1e-3)
    dkw = dict(seq_len=32, global_batch=2, vocab_size=tcfg.vocab_size,
               seed=5)
    ckw = dict(total_steps=6, checkpoint_every=2, log_every=100)
    jtr = jtrainer.Trainer(
        jax.jit(jstep.make_train_step(jcfg, jstep.TrainStepConfig(**kw))),
        JSyntheticDataset(JDataConfig(**dkw)),
        jtrainer.TrainerConfig(checkpoint_dir=str(tmp_path / "ref"), **ckw))
    jp, _ = jtr.run(jparams, jadamw.adamw_init(jparams))
    ttr = Trainer(make_train_step(tcfg, TrainStepConfig(**kw)),
                  SyntheticDataset(DataConfig(**dkw), device="cpu"),
                  TrainerConfig(checkpoint_dir=str(tmp_path / "port"), **ckw))
    tp, _ = ttr.run(tparams, adamw_init(tparams))
    jl = [h["loss"] for h in jtr.history]
    tl = [h["loss"] for h in ttr.history]
    assert len(jl) == len(tl) == 6
    assert max(abs(a - b) for a, b in zip(jl, tl)) < 1e-5, (jl, tl)
    assert max_leaf_err(as_tree(tp), jax.tree.map(np.asarray, jp)) < 1e-4
    assert latest_step(str(tmp_path / "port")) == 6
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        os.listdir(tmp_path / "ref"))
    assert sorted(os.listdir(tmp_path / "port" / "step_6")) == sorted(
        os.listdir(tmp_path / "ref" / "step_6"))


# -- the on-disk format across the packages ------------------------------


def _np_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "b": {"w": rng.standard_normal((3, 5)).astype(np.float32),
              "h": rng.standard_normal((7,)).astype(ml_dtypes.bfloat16)},
        "a": rng.integers(-9, 9, (4, 2)).astype(np.int32),
        "s": np.asarray(3, np.int32),
        "l": [rng.standard_normal((2,)).astype(np.float32)],
    }


def _torch_like(tree):
    if isinstance(tree, dict):
        return {k: _torch_like(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch_like(x) for x in tree]
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def test_reference_checkpoint_restores_in_port_bitwise(tmp_ckpt):
    tree = _np_tree()
    jmanager.save_checkpoint(tmp_ckpt, 3, tree, extra={"loss": 1.5})
    like = jax.tree.map(lambda t: torch.zeros_like(t), _torch_like(tree))
    back = restore_checkpoint(tmp_ckpt, 3, like)
    want = _torch_like(tree)
    for a, b in zip(_flat(back), _flat(want)):
        assert _same_bits(a, b)
    assert back["b"]["h"].dtype == torch.bfloat16
    from repro_torch.checkpoint.manager import read_extra
    assert read_extra(tmp_ckpt, 3) == {"loss": 1.5}


def test_port_checkpoint_restores_in_reference_bitwise(tmp_ckpt):
    tree = _np_tree(1)
    save_checkpoint(tmp_ckpt, 4, _torch_like(tree), extra={"loss": 2.5})
    like = jax.tree.map(jnp.asarray, tree)
    back = jmanager.restore_checkpoint(tmp_ckpt, 4, like)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    assert jmanager.read_extra(tmp_ckpt, 4) == {"loss": 2.5}


def test_same_tree_same_files(tmp_path):
    """The same tree saved by each package: the same files, byte for byte
    (the manifest, the ``.npy`` leaves and the commit marker), an AdamW
    bundle's named-tuple leaves included."""
    tree = _np_tree(2)
    jtree = {"params": tree, "opt": jadamw.adamw_init(
        jax.tree.map(jnp.asarray, tree["b"]))}
    ttree = {"params": _torch_like(tree),
             "opt": adamw_init(_torch_like(tree["b"]))}
    jmanager.save_checkpoint(str(tmp_path / "ref"), 7, jtree,
                             extra={"reason": "x"})
    save_checkpoint(str(tmp_path / "port"), 7, ttree, extra={"reason": "x"})
    ref, port = tmp_path / "ref" / "step_7", tmp_path / "port" / "step_7"
    names = sorted(os.listdir(ref))
    assert "opt..step.npy" in names and "opt..master.w.npy" in names
    assert sorted(os.listdir(port)) == names
    match, mismatch, errors = filecmp.cmpfiles(ref, port, names,
                                               shallow=False)
    assert (mismatch, errors) == ([], []), (mismatch, errors)
