"""Architecture registry of the port.

``get_config(name)`` returns the full published config; ``get_smoke(name)``
returns the reduced same-family config used by CPU tests. Only the
architectures whose slice is ported are registered; the others raise.
"""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import ModelConfig

__all__ = ["ModelConfig", "get_config", "get_smoke"]

_MODULES = {
    "qwen3-1.7b": "qwen3_1_7b",
}


def _load(name: str):
    if name not in _MODULES:
        raise KeyError(f"arch {name!r} is not ported yet; available: {list(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str, **overrides) -> ModelConfig:
    cfg = _load(name).CONFIG
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def get_smoke(name: str, **overrides) -> ModelConfig:
    cfg = _load(name).SMOKE
    return dataclasses.replace(cfg, **overrides) if overrides else cfg
