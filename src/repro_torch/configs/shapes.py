"""Assigned input-shape set (common to all 10 LM-family architectures).

  train_4k      seq 4,096  × global_batch 256   → lowers train_step
  prefill_32k   seq 32,768 × global_batch 32    → lowers prefill (serve)
  decode_32k    seq 32,768 × global_batch 128   → lowers serve_step
                 (ONE new token against a KV cache of seq_len)
  long_500k     seq 524,288 × global_batch 1    → serve_step, sub-quadratic
                 archs only (SSM/hybrid/SWA) — skips per DESIGN.md §6.

VLM (llava): ``frontend_tokens`` of the sequence arrive as precomputed
patch embeddings, the rest as text tokens. Audio (seamless): the sequence
splits half/half into encoder frames and decoder tokens for train/prefill;
decode uses a fixed 4,096-frame encoder memory (≈3 min of audio) with the
full-seq decoder cache.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    step: str  # train | prefill | decode


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

# Archs allowed to run long_500k (sub-quadratic or windowed attention).
LONG_CONTEXT_ARCHS = frozenset(
    {"gemma3-12b", "gemma2-9b", "xlstm-125m", "zamba2-7b"}
)


def cells(arch: str) -> list[str]:
    """Shape names applicable to ``arch`` (the dry-run row)."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if arch in LONG_CONTEXT_ARCHS:
        out.append("long_500k")
    return out
