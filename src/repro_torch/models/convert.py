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
"""

from __future__ import annotations

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
