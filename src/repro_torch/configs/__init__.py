"""Architecture registry — one module per assigned architecture.

The PyTorch port's copy of the reference's ``configs/`` (pure Python,
field for field the same). ``get_config(name)`` returns the exact
published full-scale ModelConfig; ``get_smoke_config(name)`` a reduced
same-family config for CPU tests. ``chip_smoke.py`` takes its model
cells' widths from here.
"""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.shapes import (LONG_CONTEXT_ARCHS, SHAPES, ShapeSpec,
                                  cells)
from repro_torch.models.config import ModelConfig

ARCHS: tuple[str, ...] = (
    "gemma3-12b",
    "gemma2-9b",
    "phi3-medium-14b",
    "stablelm-12b",
    "granite-moe-1b-a400m",
    "qwen3-moe-235b-a22b",
    "xlstm-125m",
    "zamba2-7b",
    "llava-next-mistral-7b",
    "seamless-m4t-large-v2",
)

_MODULES = {name: "repro_torch.configs." + name.replace("-", "_") for name in ARCHS}


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; one of {sorted(_MODULES)}")
    mod = importlib.import_module(_MODULES[name])
    return mod.CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    """Reduced config of the same family/wiring for CPU smoke tests."""
    mod = importlib.import_module(_MODULES[name])
    return mod.SMOKE


def all_configs() -> dict[str, ModelConfig]:
    return {name: get_config(name) for name in ARCHS}


def scale_down(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Generic reducer used by the per-arch SMOKE definitions."""
    return dataclasses.replace(cfg, **overrides)


__all__ = [
    "ARCHS", "LONG_CONTEXT_ARCHS", "SHAPES", "ShapeSpec", "all_configs",
    "cells", "get_config", "get_smoke_config", "scale_down",
]
