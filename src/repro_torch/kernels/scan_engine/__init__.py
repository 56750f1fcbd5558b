"""Monoid-generic scan engine: each schedule written once.

The PyTorch counterpart of the reference's ``kernels/scan_engine``. The
organization (carry, decoupled, fused, tree in ``schedules``) is written
once over a ``KernelSpec`` and a layout (``Rows``, ``Channels``); the
operator is a registration (``monoids.SUM``, ``monoids.AFFINE``, ...). On
CUDA tensors the schedules launch the hand-written Hopper kernels of
``csrc/scan_sum.cu`` (bound in ``cuda``); on CPU tensors they run the
plain PyTorch version of each kernel.
"""

from repro_torch.kernels.scan_engine import cuda, monoids
from repro_torch.kernels.scan_engine.layouts import Channels, Rows
from repro_torch.kernels.scan_engine.schedules import (
    RESOLVABLE, SCHEDULES, exclusive_chain, resolve_schedule, scan,
    scan_carry, scan_decoupled, scan_fused, scan_tree, tile_scan, tree_scan)

__all__ = [
    "RESOLVABLE", "Channels", "Rows", "SCHEDULES", "cuda", "exclusive_chain",
    "monoids", "resolve_schedule", "scan", "scan_carry", "scan_decoupled",
    "scan_fused", "scan_tree", "tile_scan", "tree_scan",
]
