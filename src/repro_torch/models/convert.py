"""Carry a reference parameter tree into the port's modules.

``lm_from_tree`` takes the tree the reference's ``init_lm`` returns, as
numpy arrays (nested dicts; each pattern position's block parameters
stacked across periods on axis 0), and a ``ModelConfig``, and returns the
port's ``LM`` holding exactly those weights on the device asked for.
``load_tree`` does the same for any one module (a layer of the port
against the reference's layer tree). Every parameter of the module must
be set, with the reference's shape and dtype: a missing, extra or
misshapen leaf raises.

Numpy has no bfloat16: the reference's bf16 leaves arrive through
``ml_dtypes`` (the dtype named "bfloat16"); their bits move as uint16.

``tree_from_lm`` goes the other way: an ``LM`` (or a flat ``name ->
tensor`` dict of its parameters) as the reference's tree of numpy arrays,
periods stacked on axis 0. ``params_tree`` gives that layout as tensors
(the train step's parameters) and ``flat_params`` the ``LM``'s parameter
names back from it, as views.
"""

from __future__ import annotations

import sys

import numpy as np
import torch
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import LM


def to_tensor(a, device="cuda") -> torch.Tensor:
    """A numpy array (bfloat16 through ``ml_dtypes`` included) as a tensor
    of the same dtype and bits on ``device``."""
    a = np.array(a)                      # a writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def load_tree(module: nn.Module, tree: dict, prefix: str = "") -> int:
    """Copy the leaves of ``tree`` into the parameters of ``module`` of the
    same names (recursing through submodules); returns the leaves set."""
    done = 0
    for key, value in tree.items():
        where = f"{prefix}{key}"
        target = getattr(module, key, None)
        if target is None:
            raise KeyError(f"the port has no parameter {where!r}")
        if isinstance(value, dict):
            done += load_tree(target, value, where + ".")
            continue
        t = to_tensor(value, target.device)
        if t.shape != target.shape or t.dtype != target.dtype:
            raise ValueError(
                f"{where}: reference {tuple(t.shape)} {t.dtype}, port "
                f"{tuple(target.shape)} {target.dtype}")
        with torch.no_grad():
            target.copy_(t)
        done += 1
    return done


def _period(tree, p):
    if isinstance(tree, dict):
        return {k: _period(v, p) for k, v in tree.items()}
    return np.asarray(tree)[p]


def lm_from_tree(tree: dict, cfg: ModelConfig, *, device="cuda") -> LM:
    """The port's ``LM`` for ``cfg`` with the weights of the reference tree
    ``tree`` (numpy leaves), on ``device``."""
    lm = LM(cfg, device=device)
    done = 0
    for key, value in tree.items():
        if key != "blocks":
            done += load_tree(lm, {key: value})
            continue
        for p, period in enumerate(lm.blocks):
            for name, sub in value.items():
                done += load_tree(period[name], _period(sub, p),
                                  f"blocks.{p}.{name}.")
    n_params = sum(1 for _ in lm.parameters())
    if done != n_params:
        raise ValueError(f"the tree set {done} of the port's {n_params} "
                         "parameters")
    return lm


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array of the same bits: a bf16 one as
    ``ml_dtypes``' bfloat16 where that module is loaded already (beside
    the reference), else as its uint16 bits."""
    t = t.detach().cpu()
    if t.dtype != torch.bfloat16:
        return t.numpy()
    bits = t.view(torch.int16).numpy().view(np.uint16)
    ml_dtypes = sys.modules.get("ml_dtypes")
    return bits if ml_dtypes is None else bits.view(ml_dtypes.bfloat16)


def _stacked(lm, cfg: ModelConfig, leaf, stack) -> dict:
    flat = dict(lm.named_parameters()) if isinstance(lm, nn.Module) else lm
    periods = cfg.pattern_periods[0]
    tree, stacked = {}, {}
    for name, t in flat.items():
        parts = name.split(".")
        if parts[0] == "blocks":
            stacked.setdefault(tuple(parts[2:]), {})[int(parts[1])] = t
            continue
        node = tree
        for key in parts[:-1]:
            node = node.setdefault(key, {})
        node[parts[-1]] = leaf(t)
    for path, by_period in stacked.items():
        if sorted(by_period) != list(range(periods)):
            raise ValueError(f"blocks.*.{'.'.join(path)}: periods "
                             f"{sorted(by_period)} of {periods}")
        node = tree.setdefault("blocks", {})
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = stack([leaf(by_period[p]) for p in range(periods)])
    return tree


def tree_from_lm(lm, cfg: ModelConfig) -> dict:
    """The reference's parameter tree (nested dicts of numpy arrays, each
    pattern position's block leaves stacked across periods on axis 0) of
    an ``LM`` or of a flat ``name -> tensor`` dict of its parameters; the
    inverse of ``lm_from_tree``."""
    return _stacked(lm, cfg, to_numpy, np.stack)


def params_tree(lm, cfg: ModelConfig) -> dict:
    """An ``LM``'s parameters (or a flat ``name -> tensor`` dict of them)
    as tensors in the reference's tree layout on their device: the block
    leaves stacked across periods (a copy), the others as they are (detached).
    The train step's parameters: the optimizer sees the reference's
    leaves (a stacked norm weight has two dimensions there, and decays)."""
    return _stacked(lm, cfg, lambda t: t.detach(), torch.stack)


def flat_params(tree: dict) -> dict:
    """``name -> tensor`` of an ``LM``'s parameters from a tree in the
    reference's layout (``params_tree``): each block leaf unbound along
    its periods axis into views, so gradients flow to the stacked leaf."""
    flat = {}

    def walk(node, prefix):
        for key, value in node.items():
            if isinstance(value, dict):
                walk(value, prefix + (key,))
            elif prefix[:1] == ("blocks",):
                for p, t in enumerate(torch.unbind(value, 0)):
                    flat[".".join(("blocks", str(p)) + prefix[1:] +
                                  (key,))] = t
            else:
                flat[".".join(prefix + (key,))] = value
    walk(tree, ())
    return flat
