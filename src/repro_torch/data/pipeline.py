"""Synthetic data pipeline.

Deterministic: the batch for global step ``s`` is a pure function of
``(seed, s)`` — restart-safe (fault tolerance requires the data stream to
be reproducible from the checkpointed step counter alone). The batch is
drawn with numpy exactly as the reference draws it, so a step's batch has
the reference's bits, and then put on the device.

The token stream is Zipf-distributed over the vocab (matches LM token
frequency shape, keeps the loss landscape non-degenerate) with document
boundaries every ~doc_len tokens so packing/segmenting paths are
exercised.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int = 1024
    global_batch: int = 8
    vocab_size: int = 32_000
    seed: int = 0
    mean_doc_len: int = 512
    frontend_tokens: int = 0     # vlm/audio: precomputed embedding positions
    frontend_dim: int = 1024


class Batch(dict):
    """dict with attribute access: tokens, labels, mask[, embeds]."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None


def _batch_for_step(cfg: DataConfig, step: int) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, 0xD1CE]))
    B, S = cfg.global_batch, cfg.seq_len
    # Zipf-ish token draw (power law over vocab ranks).
    u = rng.random((B, S + 1))
    ranks = np.floor((cfg.vocab_size - 1) * u ** 3.0).astype(np.int32)
    toks = np.minimum(ranks, cfg.vocab_size - 1)
    # Document boundaries -> EOS resets for the mask.
    boundary = rng.random((B, S + 1)) < (1.0 / max(cfg.mean_doc_len, 2))
    toks = np.where(boundary, 1, toks)  # id 1 = synthetic EOS
    out = {
        "tokens": toks[:, :-1],
        "labels": toks[:, 1:].astype(np.int32),
        "mask": np.ones((B, S), np.float32),
    }
    if cfg.frontend_tokens:
        out["embeds"] = rng.standard_normal(
            (B, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)
    return out


class SyntheticDataset:
    """Iterator over deterministic synthetic batches on ``device``."""

    def __init__(self, cfg: DataConfig, device="cuda", start_step: int = 0):
        self.cfg = cfg
        self.device = device
        self.step = start_step

    def batch_at(self, step: int) -> Batch:
        return Batch({k: torch.from_numpy(np.ascontiguousarray(v)).to(
            self.device) for k, v in _batch_for_step(self.cfg, step).items()})

    def __iter__(self):
        return self

    def __next__(self) -> Batch:
        b = self.batch_at(self.step)
        self.step += 1
        return b
