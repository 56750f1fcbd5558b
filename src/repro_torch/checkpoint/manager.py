"""Async, fault-tolerant checkpointing in the reference's on-disk format.

  * One directory per step: ``<root>/step_<N>/``; each leaf saved as a
    ``.npy`` named by its dotted path in the tree (dict keys in sorted
    order, sequence indices, ``.field`` for a named tuple's field, as the
    reference's tree paths print).
  * A JSON **manifest** (``step``, ``leaves[{name, shape, dtype}]``,
    ``extra``) written LAST, then a ``COMMIT`` marker, all in a ``.tmp``
    directory that ``os.replace`` moves into place — a partially-written
    checkpoint is never restorable, so a failure mid-save costs nothing.
  * **Async**: ``save()`` snapshots to host memory synchronously and
    writes to disk on a background thread; the next save joins the
    previous writer (back-pressure).
  * numpy has no bfloat16 (nor float8): their bits are stored as unsigned
    integers of the same width, with the logical dtype in the manifest,
    so a checkpoint of either package restores in the other bit for bit.
  * Retention: the ``keep`` most recent commits are kept.

Trees are nested dicts (also lists, tuples and named tuples) of tensors or
numpy arrays. ``restore_checkpoint`` puts each leaf on the device and
dtype of ``like``'s leaf; its ``shardings`` (the reference's elastic
re-shard onto a mesh) wait for the ``torch.distributed`` slice.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

Pytree = Any

_COMMIT = "COMMIT"
_MANIFEST = "manifest.json"

# logical dtype -> (the integer numpy stores its bits as, the torch dtype)
_BITCAST = {
    "bfloat16": (np.uint16, torch.bfloat16),
    "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
    "float8_e5m2": (np.uint8, torch.float8_e5m2),
}
_INT_OF = {np.uint16: torch.int16, np.uint8: torch.uint8}


def _to_savable(leaf) -> tuple[np.ndarray, str]:
    """(the array ``np.save`` writes, the logical dtype's name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        name = str(t.dtype).replace("torch.", "")
        if name in _BITCAST:
            bits, _ = _BITCAST[name]
            return t.view(_INT_OF[bits]).numpy().view(bits), name
        return t.numpy(), name
    arr = np.asarray(leaf)
    name = str(arr.dtype)
    if name in _BITCAST:       # an ml_dtypes array
        return arr.view(_BITCAST[name][0]), name
    return arr, name


def _from_saved(arr: np.ndarray, logical_dtype: str) -> torch.Tensor:
    if logical_dtype in _BITCAST:
        bits, dtype = _BITCAST[logical_dtype]
        return torch.from_numpy(arr.view(bits).view(
            np.int16 if bits is np.uint16 else np.uint8)).view(dtype)
    return torch.from_numpy(arr)


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _leaf_paths(tree: Pytree, prefix: str = "") -> list[tuple[str, Any]]:
    """(dotted name, leaf) in the reference's order and spelling."""
    def sub(key):
        return f"{prefix}.{key}" if prefix else str(key)
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _leaf_paths(tree[k],
                                                              sub(k))]
    if _is_namedtuple(tree):
        return [p for f in tree._fields
                for p in _leaf_paths(getattr(tree, f), sub(f".{f}"))]
    if isinstance(tree, (list, tuple)):
        return [p for i, x in enumerate(tree) for p in _leaf_paths(x, sub(i))]
    return [(prefix, tree)]


def _rebuild(like: Pytree, leaves: dict, prefix: str = "") -> Pytree:
    def sub(key):
        return f"{prefix}.{key}" if prefix else str(key)
    if isinstance(like, dict):
        return type(like)((k, _rebuild(v, leaves, sub(k)))
                          for k, v in like.items())
    if _is_namedtuple(like):
        return type(like)(*(_rebuild(getattr(like, f), leaves, sub(f".{f}"))
                            for f in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(x, leaves, sub(i))
                          for i, x in enumerate(like))
    return leaves[prefix]


def latest_step(root: str) -> Optional[int]:
    if not os.path.isdir(root):
        return None
    steps = []
    for d in os.listdir(root):
        if d.startswith("step_") and os.path.exists(
                os.path.join(root, d, _COMMIT)):
            steps.append(int(d.split("_")[1]))
    return max(steps) if steps else None


def save_checkpoint(root: str, step: int, tree: Pytree,
                    extra: Optional[dict] = None) -> None:
    """Synchronous commit of ``tree`` at ``step`` (see manager for async)."""
    d = os.path.join(root, f"step_{step}")
    tmp = d + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": [], "extra": extra or {}}
    for name, leaf in _leaf_paths(tree):
        savable, logical = _to_savable(leaf)
        np.save(os.path.join(tmp, name + ".npy"), savable)
        manifest["leaves"].append(
            {"name": name, "shape": list(savable.shape), "dtype": logical})
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, _COMMIT), "w") as f:
        f.write("ok")
    if os.path.exists(d):
        shutil.rmtree(d)
    os.replace(tmp, d)


def restore_checkpoint(root: str, step: int, like: Pytree,
                       shardings: Optional[Pytree] = None) -> Pytree:
    """Restore into the structure of ``like``, each leaf on the device and
    in the dtype of ``like``'s leaf."""
    if shardings is not None:
        raise NotImplementedError(
            "restoring onto a mesh's shardings waits for the "
            "torch.distributed slice (ROADMAP Queue 1 item 8)")
    d = os.path.join(root, f"step_{step}")
    if not os.path.exists(os.path.join(d, _COMMIT)):
        raise FileNotFoundError(f"no committed checkpoint at {d}")
    with open(os.path.join(d, _MANIFEST)) as f:
        manifest = json.load(f)
    logical = {l["name"]: l["dtype"] for l in manifest["leaves"]}
    restored = {}
    for name, leaf in _leaf_paths(like):
        arr = np.load(os.path.join(d, name + ".npy"))
        val = _from_saved(arr, logical.get(name, str(arr.dtype)))
        restored[name] = val.to(device=leaf.device, dtype=leaf.dtype)
    return _rebuild(like, restored)


def read_extra(root: str, step: int) -> dict:
    with open(os.path.join(root, f"step_{step}", _MANIFEST)) as f:
        return json.load(f).get("extra", {})


def _snapshot(tree: Pytree) -> Pytree:
    """A host copy of every tensor leaf (a CPU tensor is cloned)."""
    if isinstance(tree, dict):
        return type(tree)((k, _snapshot(v)) for k, v in tree.items())
    if _is_namedtuple(tree):
        return type(tree)(*(_snapshot(x) for x in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_snapshot(x) for x in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        return t.clone() if t.device.type == "cpu" else t.cpu()
    return np.array(tree)


class CheckpointManager:
    """Async save + retention + restore-latest."""

    def __init__(self, root: str, keep: int = 3):
        self.root = root
        self.keep = keep
        self._writer: Optional[threading.Thread] = None
        os.makedirs(root, exist_ok=True)

    def save(self, step: int, tree: Pytree, extra: Optional[dict] = None,
             block: bool = False) -> None:
        # Snapshot to host memory NOW (the caller may go on to change the
        # device tensors); write to disk in the background.
        host_tree = _snapshot(tree)
        self.wait()

        def _write():
            save_checkpoint(self.root, step, host_tree, extra)
            self._gc()

        self._writer = threading.Thread(target=_write, daemon=True)
        self._writer.start()
        if block:
            self.wait()

    def wait(self) -> None:
        if self._writer is not None:
            self._writer.join()
            self._writer = None

    def restore_latest(self, like: Pytree,
                       shardings: Optional[Pytree] = None
                       ) -> tuple[Optional[int], Pytree, dict]:
        step = latest_step(self.root)
        if step is None:
            return None, like, {}
        tree = restore_checkpoint(self.root, step, like, shardings)
        return step, tree, read_extra(self.root, step)

    def _gc(self) -> None:
        steps = sorted(
            int(d.split("_")[1]) for d in os.listdir(self.root)
            if d.startswith("step_") and os.path.exists(
                os.path.join(self.root, d, _COMMIT)))
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.root, f"step_{s}"),
                          ignore_errors=True)
