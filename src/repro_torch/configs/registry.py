"""--arch <id> registry: maps architecture ids to their config modules."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig, SHAPES, ShapeConfig

_ARCHS = {
    "mixtral-8x22b": "repro_torch.configs.mixtral_8x22b",
    "deepseek-moe-16b": "repro_torch.configs.deepseek_moe_16b",
    "xlstm-125m": "repro_torch.configs.xlstm_125m",
    "paligemma-3b": "repro_torch.configs.paligemma_3b",
    "recurrentgemma-9b": "repro_torch.configs.recurrentgemma_9b",
    "minicpm3-4b": "repro_torch.configs.minicpm3_4b",
    "olmo-1b": "repro_torch.configs.olmo_1b",
    "gemma-2b": "repro_torch.configs.gemma_2b",
    "starcoder2-3b": "repro_torch.configs.starcoder2_3b",
    "whisper-small": "repro_torch.configs.whisper_small",
}


def arch_ids() -> list[str]:
    return list(_ARCHS)


def _module(arch: str):
    if arch not in _ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCHS)}")
    return importlib.import_module(_ARCHS[arch])


def get_config(arch: str) -> ModelConfig:
    return _module(arch).config()


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()


def get_shape(shape: str) -> ShapeConfig:
    return SHAPES[shape]


def cells() -> list[tuple[str, str]]:
    """All 40 (arch x shape) dry-run cells, including the documented skips."""
    return [(a, s) for a in arch_ids() for s in SHAPES]


def cell_supported(arch: str, shape: str) -> tuple[bool, str]:
    """Whether the cell runs, and the reason if skipped (DESIGN.md section 5)."""
    cfg = get_config(arch)
    if shape == "long_500k" and not cfg.supports_long_context:
        return False, ("pure full-attention arch: long_500k requires "
                       "sub-quadratic sequence mixing (skip per assignment)")
    return True, ""
