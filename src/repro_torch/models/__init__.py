"""The serving model subset of ``repro.models``: config schema, primitive
layers, the GQA projection and the parameter tree (seeded init and the
bridge from a reference pytree)."""

from .common import ArchConfig
from .params import from_jax_params, init_params

__all__ = ["ArchConfig", "from_jax_params", "init_params"]
