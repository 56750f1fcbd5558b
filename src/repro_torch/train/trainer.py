"""Training loop with fault tolerance and straggler mitigation.

  * **Checkpoint/restart**: async committed checkpoints every
    ``checkpoint_every`` steps (manifest + COMMIT marker — a crash mid-
    write never corrupts); on start the trainer resumes from the latest
    commit, replaying the data stream from the checkpointed step (the
    synthetic pipeline is a pure function of (seed, step)).
  * **Step retry**: a failing step (device OOM, a lost host, a flaky
    link: an exception from the step) is retried up to
    ``max_step_retries`` after re-materializing state from the last
    checkpoint.
  * **Straggler mitigation**: per-step wall-times feed an online
    mean/variance tracker; a step slower than ``straggler_zscore`` σ is
    logged with its index and triggers an immediate checkpoint, so a
    scheduler's swap of the slow host loses no work.
  * **NaN/overflow guard**: a non-finite loss skips the update
    (parameters and optimizer state roll back to the step's inputs,
    which the step leaves valid) and counts toward ``max_nan_skips``.

Spans and histograms go through ``repro_torch.obs`` under the reference's
names: ``train.step`` (a span closing on the loss's ``.item()``, so it
measures the whole step), ``train.step.retry`` and ``train.nan_skip``
(instants), ``train.step_s`` (a histogram of step seconds).
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import tempfile
import time
from typing import Callable, Optional

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.obs import default_registry, trace

log = logging.getLogger("repro_torch.train")


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    checkpoint_every: int = 50
    checkpoint_dir: str = dataclasses.field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(),
                                             "repro_ckpt"))
    keep_checkpoints: int = 3
    log_every: int = 10
    max_step_retries: int = 2
    max_nan_skips: int = 10
    straggler_zscore: float = 3.0
    straggler_min_samples: int = 20


class _StragglerTracker:
    """Online mean/std of step times (Welford) + z-score flagging."""

    def __init__(self, zscore: float, min_samples: int):
        self.z = zscore
        self.min_samples = min_samples
        self.n = 0
        self.mean = 0.0
        self.m2 = 0.0
        self.flagged: list[int] = []

    def observe(self, step: int, dt: float) -> bool:
        is_straggler = False
        if self.n >= self.min_samples:
            std = math.sqrt(self.m2 / max(self.n - 1, 1))
            if std > 0 and (dt - self.mean) / std > self.z:
                is_straggler = True
                self.flagged.append(step)
        self.n += 1
        d = dt - self.mean
        self.mean += d / self.n
        self.m2 += d * (dt - self.mean)
        return is_straggler


class Trainer:
    def __init__(
        self,
        step_fn: Callable,          # (params, opt, batch, idx) -> (p, o, m)
        dataset,                    # with .batch_at(step)
        tcfg: TrainerConfig,
        ckpt: Optional[CheckpointManager] = None,
    ):
        self.step_fn = step_fn
        self.dataset = dataset
        self.cfg = tcfg
        self.ckpt = ckpt or CheckpointManager(
            tcfg.checkpoint_dir, keep=tcfg.keep_checkpoints)
        self.straggler = _StragglerTracker(
            tcfg.straggler_zscore, tcfg.straggler_min_samples)
        self.history: list[dict] = []
        self.nan_skips = 0

    # -- state (de)hydration -------------------------------------------
    def _bundle(self, params, opt_state):
        return {"params": params, "opt": opt_state}

    def maybe_restore(self, params, opt_state, shardings=None):
        step, tree, extra = self.ckpt.restore_latest(
            self._bundle(params, opt_state), shardings)
        if step is None:
            return 0, params, opt_state
        log.info("restored checkpoint at step %d", step)
        return step, tree["params"], tree["opt"]

    # -- main loop ------------------------------------------------------
    def run(self, params, opt_state, start_step: int = 0):
        step = start_step
        while step < self.cfg.total_steps:
            batch = self.dataset.batch_at(step)
            t0 = time.perf_counter()
            for attempt in range(self.cfg.max_step_retries + 1):
                try:
                    # The span closes on the loss sync, so it measures the
                    # whole step (dispatch + device) — what the straggler
                    # tracker sees.
                    with trace.span("train.step", step=step,
                                    attempt=attempt):
                        new_params, new_opt, metrics = self.step_fn(
                            params, opt_state, batch, torch.tensor(step))
                        loss = float(metrics["loss"].item())
                    break
                except Exception as e:  # noqa: BLE001 — retry path
                    log.warning("step %d attempt %d failed: %s",
                                step, attempt, e)
                    trace.instant("train.step.retry", step=step,
                                  attempt=attempt, error=repr(e))
                    if attempt == self.cfg.max_step_retries:
                        raise
                    # Re-materialize from the last commit (a coordinated
                    # restart in one process).
                    step_r, params, opt_state = self.maybe_restore(
                        params, opt_state)
                    step = max(step_r, 0)
                    batch = self.dataset.batch_at(step)
            dt = time.perf_counter() - t0
            default_registry().histogram("train.step_s").record(dt)

            if not math.isfinite(loss):
                trace.instant("train.nan_skip", step=step,
                              skips=self.nan_skips + 1)
                self.nan_skips += 1
                log.warning("non-finite loss at step %d (skip %d/%d)",
                            step, self.nan_skips, self.cfg.max_nan_skips)
                if self.nan_skips > self.cfg.max_nan_skips:
                    raise FloatingPointError(
                        f"too many non-finite losses (step {step})")
                step += 1
                continue  # params/opt_state NOT updated — rollback

            params, opt_state = new_params, new_opt
            self.history.append(
                {"step": step, "loss": loss, "time_s": dt})

            if self.straggler.observe(step, dt):
                log.warning(
                    "straggler step %d (%.3fs vs mean %.3fs) — "
                    "checkpointing for hot-swap", step, dt,
                    self.straggler.mean)
                self.ckpt.save(step + 1, self._bundle(params, opt_state),
                               extra={"reason": "straggler"})

            if step % self.cfg.log_every == 0:
                log.info("step %d loss %.4f (%.3fs)", step, loss, dt)
            if (step + 1) % self.cfg.checkpoint_every == 0:
                self.ckpt.save(step + 1, self._bundle(params, opt_state),
                               extra={"loss": loss})
            step += 1

        self.ckpt.save(step, self._bundle(params, opt_state), block=True)
        return params, opt_state
