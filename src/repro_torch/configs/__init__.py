"""Architecture registry (the JAX package's ``configs/__init__.py``).

``get_config(arch)`` / ``get_reduced(arch)`` return the full / smoke
``ModelConfig`` of an architecture; the widths are the JAX package's,
field for field.  ``input_specs(cfg, shape, ...)`` returns ``meta``
tensors standing in for every model input of that (arch x shape) cell
(the reference's ``ShapeDtypeStruct``s: shapes and dtypes, no storage);
``make_batch`` draws a concrete batch from numpy exactly as the reference
does, so both packages get the same tokens.
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


def _shape(shape: str | ShapeConfig) -> ShapeConfig:
    return SHAPES[shape] if isinstance(shape, str) else shape


def shape_applicable(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    """(runs?, reason).  long_500k only for sub-quadratic families
    (DESIGN.md §5); every arch here is generative so decode always runs."""
    if shape == "long_500k" and not cfg.sub_quadratic:
        return False, "pure full-attention arch: long_500k skipped per spec"
    return True, ""


def input_specs(cfg: ModelConfig, shape: str | ShapeConfig,
                for_loss: bool = True) -> dict:
    """``meta``-device stand-ins for the cell's step function inputs."""
    import torch
    sc = _shape(shape)
    B, S = sc.global_batch, sc.seq_len

    def spec(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    if sc.kind == "decode":
        batch = {"tokens": spec((B, 1), torch.int32)}
    else:
        batch = {"tokens": spec((B, S), torch.int32)}
        if for_loss and sc.kind == "train":
            batch["labels"] = spec((B, S), torch.int32)
    if cfg.modality_stub == "vision" and sc.kind != "decode":
        batch["stub"] = spec((B, cfg.n_stub_tokens, cfg.d_model),
                             cfg.compute_dtype)
    if cfg.encdec and sc.kind != "decode":
        # audio stub: precomputed frame embeddings for the encoder
        batch["enc_frames"] = spec((B, S // 4, cfg.d_model),
                                   cfg.compute_dtype)
    return batch


def make_batch(cfg: ModelConfig, shape: str | ShapeConfig, seed: int = 0,
               batch_override: int | None = None,
               seq_override: int | None = None, device=None) -> dict:
    """Concrete random batch matching :func:`input_specs`, drawn from
    ``numpy.random.default_rng(seed)`` in the reference's order, on
    ``device`` (``None``: the CUDA card)."""
    import numpy as np
    import torch

    from repro_torch.core.executor import resolve_device
    dev = resolve_device(device)
    sc = _shape(shape)
    B = batch_override or sc.global_batch
    S = seq_override or sc.seq_len
    rng = np.random.default_rng(seed)

    def ids(a):
        return torch.as_tensor(a, dtype=torch.int32).to(dev)

    def floats(a):
        return torch.from_numpy(a).to(dev, cfg.compute_dtype)

    batch = {"tokens": ids(rng.integers(0, cfg.vocab, (B, S)))}
    if sc.kind == "train":
        batch["labels"] = ids(rng.integers(0, cfg.vocab, (B, S)))
    if cfg.modality_stub == "vision":
        n = min(cfg.n_stub_tokens, S)
        batch["stub"] = floats(rng.standard_normal((B, n, cfg.d_model)))
    if cfg.encdec:
        batch["enc_frames"] = floats(
            rng.standard_normal((B, max(1, S // 4), cfg.d_model)))
    return batch


__all__ = ["ARCHS", "SHAPES", "ModelConfig", "RunConfig", "ShapeConfig",
           "get_config", "get_reduced", "shape_applicable", "input_specs",
           "make_batch"]
