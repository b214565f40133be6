"""Architecture registry (the JAX package's ``configs/__init__.py``).

``get_config(arch)`` / ``get_reduced(arch)`` return the full / smoke
``ModelConfig`` of an architecture; the widths are the JAX package's,
field for field.  ``input_specs`` and ``make_batch`` come with the model
stack.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (SHAPES, ModelConfig, RunConfig,
                                     ShapeConfig)

_MODULES = {
    "recurrentgemma-9b": "recurrentgemma_9b",
    "olmo-1b": "olmo_1b",
    "gemma3-1b": "gemma3_1b",
    "qwen1.5-32b": "qwen1_5_32b",
    "smollm-135m": "smollm_135m",
    "rwkv6-3b": "rwkv6_3b",
    "granite-moe-1b-a400m": "granite_moe_1b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "seamless-m4t-large-v2": "seamless_m4t_large",
    "phi-3-vision-4.2b": "phi3_vision_4b",
}

ARCHS = tuple(_MODULES)


def _mod(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; choose from {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _mod(arch).CONFIG


def get_reduced(arch: str) -> ModelConfig:
    return _mod(arch).reduced()


def shape_applicable(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    """(runs?, reason).  long_500k only for sub-quadratic families
    (DESIGN.md §5); every arch here is generative so decode always runs."""
    if shape == "long_500k" and not cfg.sub_quadratic:
        return False, "pure full-attention arch: long_500k skipped per spec"
    return True, ""


__all__ = ["ARCHS", "SHAPES", "ModelConfig", "RunConfig", "ShapeConfig",
           "get_config", "get_reduced", "shape_applicable"]
