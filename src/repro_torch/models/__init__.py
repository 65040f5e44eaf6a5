"""The model zoo of ``repro.models`` in PyTorch: config schema, primitive
layers, attention (GQA and MLA), MoE, RG-LRU, xLSTM, the transformer
assembly, the parameter tree (seeded init and the bridge from a reference
pytree) and the model bundle."""

from .common import ArchConfig
from .model_zoo import Model, build_model, count_params
from .params import from_jax_params, init_params

__all__ = ["ArchConfig", "Model", "build_model", "count_params",
           "from_jax_params", "init_params"]
