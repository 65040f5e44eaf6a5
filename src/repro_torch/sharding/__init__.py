"""Distribution substrate (``repro.sharding``): logical-axis sharding over a
``DeviceMesh``, int8 gradient compression, compute/communication overlap."""

from .axes import (
    DEFAULT_RULES,
    Spec,
    axis_rules,
    current_mesh,
    logical_constraint,
    logical_to_spec,
    sharding_tree,
    spec_to_placements,
    spec_tree_for_params,
)

__all__ = [
    "DEFAULT_RULES",
    "Spec",
    "axis_rules",
    "current_mesh",
    "logical_constraint",
    "logical_to_spec",
    "sharding_tree",
    "spec_to_placements",
    "spec_tree_for_params",
]
