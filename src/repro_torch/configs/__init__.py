"""Architecture registry of the port: ``get_config`` / ``get_smoke_config``.

All ten architectures of ``repro.configs``, in its order.  The model zoo
(``repro_torch.models.build_model``) runs every one of them.  The paged
serving engine and its CLI take only the archs the reference's serving
path takes: full-attention stacks without MLA or an encoder (dense or MoE
FFNs); they refuse the others with a message
(``serve.paged_model._check_paged_support``).
"""

from __future__ import annotations

import importlib
from typing import Dict

import torch

from repro_torch.models.common import ArchConfig

from .shapes import SHAPES, ShapeSpec, cell_is_runnable

_MODULES = {
    "recurrentgemma-2b": "recurrentgemma_2b",
    "stablelm-3b": "stablelm_3b",
    "starcoder2-3b": "starcoder2_3b",
    "starcoder2-7b": "starcoder2_7b",
    "gemma-7b": "gemma_7b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "mixtral-8x7b": "mixtral_8x7b",
    "xlstm-350m": "xlstm_350m",
    "pixtral-12b": "pixtral_12b",
    "whisper-small": "whisper_small",
}

ALL_ARCHS = tuple(_MODULES)


def _mod(name: str):
    if name not in _MODULES:
        raise ValueError(f"unknown arch {name!r}; one of {ALL_ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str) -> ArchConfig:
    return _mod(name).CONFIG


def get_smoke_config(name: str) -> ArchConfig:
    """Reduced config for CPU-executed tests, in f32 activations like the
    reference's smoke configs."""
    return _mod(name).smoke_config().scaled(dtype=torch.float32)


def all_configs() -> Dict[str, ArchConfig]:
    return {n: get_config(n) for n in ALL_ARCHS}


__all__ = [
    "ALL_ARCHS",
    "SHAPES",
    "ShapeSpec",
    "all_configs",
    "cell_is_runnable",
    "get_config",
    "get_smoke_config",
]
