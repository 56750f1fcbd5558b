"""Monoid-generic scan engine: each schedule written once.

The PyTorch counterpart of the reference's ``kernels/scan_engine``. The
organization (carry, decoupled, fused, tree in ``schedules``) is written
once over a ``KernelSpec`` and a layout (``Rows``, ``Channels``); the
operator is a registration (``monoids.SUM``, ``monoids.AFFINE``, ...).
Carried-payload monoids (flash attention's forward and backward) run the
FOLD forms of the schedules (``fold_carry``, ``fold_decoupled`` with
``fold_chain``) on the ``KVBlocks`` / ``QBlocks`` layouts. On CUDA
tensors the schedules launch the hand-written Hopper kernels of
``csrc/scan_sum.cu`` (bound in ``cuda``) and ``csrc/attn_fold.cu``
(``cuda_fold``); on CPU tensors they run the plain PyTorch version of
each kernel.
"""

from repro_torch.kernels.scan_engine import cuda, cuda_fold, monoids
from repro_torch.kernels.scan_engine.layouts import (Channels, KVBlocks,
                                                     QBlocks, Rows,
                                                     block_live)
from repro_torch.kernels.scan_engine.schedules import (
    RESOLVABLE, SCHEDULES, exclusive_chain, fold_carry, fold_chain,
    fold_decoupled, fused_native_available, resolve_schedule, scan,
    scan_carry, scan_decoupled, scan_fused, scan_tree, tile_scan, tree_scan)

__all__ = [
    "Channels", "KVBlocks", "QBlocks", "RESOLVABLE", "Rows", "SCHEDULES",
    "block_live", "cuda", "cuda_fold", "exclusive_chain", "fold_carry",
    "fold_chain", "fold_decoupled", "fused_native_available", "monoids",
    "resolve_schedule", "scan", "scan_carry", "scan_decoupled",
    "scan_fused", "scan_tree", "tile_scan", "tree_scan",
]
