"""Architecture registry: ``get_config(arch, smoke=False)`` -> the FULL or
SMOKE :class:`~repro_torch.models.config.ModelConfig` of each of the ten
architectures, field for field the JAX package's.
"""
from __future__ import annotations

from importlib import import_module

from ..models.config import SHAPES, InputShape, ModelConfig, cell_supported, input_specs

_MODULES = {
    "granite-3-2b": "granite_3_2b",
    "granite-3-8b": "granite_3_8b",
    "qwen2-0.5b": "qwen2_0_5b",
    "chatglm3-6b": "chatglm3_6b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "musicgen-medium": "musicgen_medium",
    "mamba2-780m": "mamba2_780m",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "internvl2-1b": "internvl2_1b",
}

ARCH_IDS = tuple(_MODULES)

__all__ = ["ARCH_IDS", "SHAPES", "InputShape", "ModelConfig", "all_cells", "cell_supported",
           "get_config", "input_specs"]


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(_MODULES)}")
    mod = import_module(f".{_MODULES[arch]}", __package__)
    return mod.SMOKE if smoke else mod.FULL


def all_cells():
    """Every (arch, shape) pair with its supported/skip verdict."""
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in SHAPES.values():
            ok, why = cell_supported(cfg, shape)
            yield arch, shape.name, ok, why
