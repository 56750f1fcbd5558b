"""Optimizer: AdamW with float32 masters, its schedule and gradient
compression (the reference's ``optim`` exports; ``compressed_psum``, a
collective, waits for the ``torch.distributed`` slice)."""

from repro_torch.optim.adamw import (AdamWState, adamw_init, adamw_update,
                                     global_norm)
from repro_torch.optim.compression import (compress_grads, decompress_grads,
                                           init_error_feedback)
from repro_torch.optim.schedule import cosine_schedule

__all__ = [
    "AdamWState", "adamw_init", "adamw_update", "compress_grads",
    "cosine_schedule", "decompress_grads", "global_norm",
    "init_error_feedback",
]
