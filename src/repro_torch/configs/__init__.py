"""Architecture registry of the port: ``get_config`` / ``get_smoke_config``.

Only the architectures the paged engine serves are listed: the dense
full-attention stacks without MLA or an encoder, which are the ones the
reference's serving CLI accepts.  The other names of ``repro.configs``
raise until their paths are ported.
"""

from __future__ import annotations

import importlib

import torch

from repro_torch.models.common import ArchConfig

_MODULES = {
    "stablelm-3b": "stablelm_3b",
    "starcoder2-3b": "starcoder2_3b",
    "starcoder2-7b": "starcoder2_7b",
    "gemma-7b": "gemma_7b",
    "pixtral-12b": "pixtral_12b",
}

ALL_ARCHS = tuple(_MODULES)


def _mod(name: str):
    if name not in _MODULES:
        raise ValueError(f"arch {name!r} is not ported yet; one of {ALL_ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str) -> ArchConfig:
    return _mod(name).CONFIG


def get_smoke_config(name: str) -> ArchConfig:
    """Reduced config for CPU-executed tests, in f32 activations like the
    reference's smoke configs."""
    return _mod(name).smoke_config().scaled(dtype=torch.float32)


__all__ = ["ALL_ARCHS", "get_config", "get_smoke_config"]
