"""Logical-axis sharding tables + the installed-mesh context.

The PyTorch port's copy of the reference's ``dist/sharding.py``, its
single-device surface. Model code never names mesh axes directly: it
annotates tensors with LOGICAL axes ("batch", "heads", "mlp", ...)
through ``shard``, and this module resolves them against the installed
mesh through a rules table (logical axis -> tuple of mesh axes). With no
mesh installed every annotation is the identity, so the same model code
runs on one device.

A mesh here is any object with a ``shape`` mapping of axis name to size
(the reference's ``jax.sharding.Mesh`` has one). ``resolve`` returns the
reference's PartitionSpec entries as a tuple. Placing a tensor across
devices (``sanitize_spec``, ``shard_map``, ``spec_for_params`` and
``shard`` under a mesh of more than one device) waits for the
``torch.distributed`` slice (ROADMAP Queue 1 item 8).
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional

import torch

# Logical axis -> mesh axes (filtered to the installed mesh's axis names),
# the reference's table.
DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "seq": (),               # sequence replicated by default ...
    "seq_shard": ("model",),  # ... except KV/state slots in serve cells
    "embed": (),
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "mlp": ("model",),
    "experts": ("model",),
    "capacity": (),
    "ssm_inner": ("model",),
    "layers": (),
}


class _State(threading.local):
    def __init__(self):
        self.stack: list = []


_STATE = _State()


def current_mesh():
    """The innermost installed mesh, or None outside any ``use_mesh``."""
    return _STATE.stack[-1][0] if _STATE.stack else None


def current_rules() -> dict[str, tuple[str, ...]]:
    return _STATE.stack[-1][1] if _STATE.stack else dict(DEFAULT_RULES)


@contextlib.contextmanager
def use_mesh(mesh, rules: Optional[dict] = None):
    """Install ``mesh`` (+ optional logical-rule overrides) for the block."""
    merged = dict(DEFAULT_RULES)
    if rules:
        merged.update({k: tuple(v) if not isinstance(v, str) else (v,)
                       for k, v in rules.items()})
    _STATE.stack.append((mesh, merged))
    try:
        yield mesh
    finally:
        _STATE.stack.pop()


def resolve(axes) -> tuple:
    """Logical axis names (or None) per dim -> PartitionSpec entries.

    Unknown logical names and names whose mesh axes are absent from the
    installed mesh resolve to None (replicated).
    """
    mesh = current_mesh()
    rules = current_rules()
    entries = []
    for ax in axes:
        if ax is None:
            entries.append(None)
            continue
        mesh_axes = rules.get(ax, ())
        if mesh is not None:
            mesh_axes = tuple(a for a in mesh_axes if a in mesh.shape)
        if not mesh_axes:
            entries.append(None)
        elif len(mesh_axes) == 1:
            entries.append(mesh_axes[0])
        else:
            entries.append(mesh_axes)
    return tuple(entries)


def shard(x: torch.Tensor, *axes) -> torch.Tensor:
    """Constrain ``x``'s placement by logical axes; the identity without a
    mesh, or under a mesh of one device."""
    mesh = current_mesh()
    if mesh is None or math.prod(mesh.shape.values()) == 1:
        return x
    raise NotImplementedError(
        "sharding over a mesh of more than one device waits for the "
        "torch.distributed slice")
