"""Logical-axis sharding (``repro.sharding.axes``): names -> a spec with the
divisibility fallback, and the spec as DTensor placements on a
``DeviceMesh``.

Every parameter and activation in the model zoo is annotated with *logical*
axis names ("batch", "embed", "heads", "mlp", "vocab", "expert", ...).  A
rules table maps each logical name to an ordered list of candidate mesh axes.
``logical_to_spec`` resolves the annotation against a mesh:

* a mesh axis is assigned to a tensor dim only if the dim size is divisible
  by the mesh axis size (otherwise the next candidate is tried, else the dim
  is replicated) — this is what lets one rules table serve every assigned
  architecture (e.g. starcoder2-3b's 24 heads don't divide a model=16 axis,
  so heads fall back to replicated while its mlp dim, 12288, shards);
* each mesh axis is used at most once per tensor;
* composite candidates like ``("pod", "data")`` shard one dim over several
  mesh axes (the batch dim on the multi-pod mesh); on a mesh without "pod"
  the candidate degrades to ``("data",)``.

The result is a :class:`Spec`, a tuple of one entry per tensor dim (a mesh
axis name, a tuple of them, or None; trailing Nones trimmed), equal as a
tuple to the reference's ``PartitionSpec``.  ``logical_to_spec`` reads only
the mesh's axis names and sizes, so a shape-only stand-in (an object whose
``shape`` maps names to sizes) works as well as a ``DeviceMesh``.

:func:`spec_to_placements` turns a spec into one DTensor placement per mesh
dim (``Shard(d)`` or ``Replicate()``); a composite entry shards its tensor
dim over several mesh dims, major to minor in the mesh's order, as JAX lays
it out.  Model code calls :func:`logical_constraint` on activations: under
:func:`axis_rules` with a mesh installed it redistributes a DTensor to the
placements its names resolve to; without a mesh, or on a plain tensor, it
returns its argument untouched.
"""

from __future__ import annotations

import contextlib
import math
import threading
from contextlib import contextmanager
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch

AxisCandidate = Union[str, Tuple[str, ...]]
Rules = Dict[str, Sequence[AxisCandidate]]

# Default rules table.  "batch" composes pod+data on the multi-pod mesh;
# model-parallel dims try "model".
DEFAULT_RULES: Rules = {
    "batch": [("pod", "data"), "data"],
    "seq": [],  # sequence stays unsharded by default (SP overrides per-config)
    "seq_sp": [("pod", "data"), "data"],  # sequence-parallel activations
    "embed": [],
    "heads": ["model"],
    "kv_heads": ["model"],
    "head_dim": [],
    "qkv": ["model"],
    "mlp": ["model"],
    "vocab": ["model"],
    "expert": ["model"],
    "expert_mlp": ["model"],
    "kv_lora": [],
    "layers": [],
    "stack": [],
    "zero": ["data"],  # ZeRO-sharded optimizer-state dim
    "conv": [],
    "state": [],
}

_CTX = threading.local()


class Spec(tuple):
    """A partition spec: one entry per tensor dim, each a mesh axis name, a
    tuple of names, or None.  ``Spec("data", None) == ("data", None)``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


def mesh_axes(mesh) -> Dict[str, int]:
    """Axis name -> size of a ``DeviceMesh`` (its ``mesh_dim_names`` and
    ``shape``) or of a stand-in whose ``shape`` is that mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


@contextmanager
def axis_rules(mesh, rules: Optional[Rules] = None):
    """Install (mesh, rules) for :func:`logical_constraint`.  With a mesh,
    also enter DTensor's ``implicit_replication``, so plain tensors the
    model builds (rotary tables, masks, ``arange``s) count as replicated
    where they meet DTensor activations."""
    prev = (getattr(_CTX, "mesh", None), getattr(_CTX, "rules", None))
    _CTX.mesh, _CTX.rules = mesh, rules
    try:
        with contextlib.ExitStack() as stack:
            if mesh is not None:
                from torch.distributed.tensor.experimental import \
                    implicit_replication

                stack.enter_context(implicit_replication())
            yield
    finally:
        _CTX.mesh, _CTX.rules = prev


def current_mesh():
    return getattr(_CTX, "mesh", None)


def _cand_axes(cand: AxisCandidate) -> Tuple[str, ...]:
    return cand if isinstance(cand, tuple) else (cand,)


def logical_to_spec(
    logical_axes: Sequence[Optional[str]],
    shape: Sequence[int],
    mesh,
    rules: Optional[Rules] = None,
) -> Spec:
    """Resolve logical axis names to a :class:`Spec` for ``shape`` on
    ``mesh``."""
    rules = rules if rules is not None else DEFAULT_RULES
    assert len(logical_axes) == len(shape), (logical_axes, shape)
    mesh_shape = mesh_axes(mesh)
    used: set = set()
    out = []
    for name, dim in zip(logical_axes, shape):
        assigned = None
        for cand in rules.get(name, ()) if name else ():
            # Keep the subset of axes present in this mesh (("pod","data")
            # degrades to ("data",) on the single-pod mesh).
            axes = tuple(a for a in _cand_axes(cand) if a in mesh_shape)
            if not axes:
                continue
            size = math.prod(mesh_shape[a] for a in axes)
            if size <= 1 or dim % size != 0 or any(a in used for a in axes):
                continue
            assigned = axes if len(axes) > 1 else axes[0]
            used.update(axes)
            break
        out.append(assigned)
    while out and out[-1] is None:  # canonical form
        out.pop()
    return Spec(*out)


def spec_to_placements(spec: Sequence, mesh) -> tuple:
    """One DTensor placement per mesh dim: ``Shard(d)`` where the spec puts
    tensor dim ``d`` on that mesh axis, else ``Replicate()``.  A composite
    entry must list its axes in the mesh's order (major to minor), which is
    the order DTensor shards one dim over several mesh dims."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = _cand_axes(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"composite axes {axes} are not in the mesh's "
                             f"order {tuple(names)}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (a plain tensor answers without importing
    DTensor)."""
    if type(x) is torch.Tensor:
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def logical_constraint(x, logical_axes: Sequence[Optional[str]]):
    """Redistribute a DTensor to the placements its logical names resolve
    to on the installed mesh; ``x`` itself without a mesh or when it is not
    a DTensor."""
    mesh = getattr(_CTX, "mesh", None)
    if mesh is None or not is_dtensor(x):
        return x
    spec = logical_to_spec(logical_axes, x.shape, mesh,
                           getattr(_CTX, "rules", None))
    placements = spec_to_placements(spec, mesh)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)


def rewrap(x, mesh):
    """A full local tensor ``x`` as a replicated DTensor on ``mesh`` (``x``
    itself when ``mesh`` is None)."""
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor, Replicate

    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def on_replicated(fn, *xs):
    """``fn(*xs)`` on full local tensors: under :func:`axis_rules` with a
    mesh, DTensor operands are gathered to ``Replicate()`` on every mesh
    dim and unwrapped first, and the result is a replicated DTensor.  For
    ops DTensor has no sharding rule for (forward or backward)."""
    if getattr(_CTX, "mesh", None) is None:
        return fn(*xs)
    from torch.distributed.tensor import DTensor, Replicate

    mesh, local = None, []
    for x in xs:
        if isinstance(x, DTensor):
            mesh = x.device_mesh
            x = x.redistribute(mesh, [Replicate()] * mesh.ndim).to_local()
        local.append(x)
    return rewrap(fn(*local), mesh)


def _is_axes_leaf(a: Any) -> bool:
    return a is None or (
        isinstance(a, tuple) and all(x is None or isinstance(x, str) for x in a)
    )


def _map_axes(fn, axes_tree, params):
    """Map ``fn(axes, leaf)`` over a tree of logical-axes tuples and the
    matching nested dicts of ``params``."""
    if _is_axes_leaf(axes_tree):
        return fn(axes_tree, params)
    return {k: _map_axes(fn, v, params[k]) for k, v in axes_tree.items()}


def _leaf_spec(axes, leaf, mesh, rules) -> Spec:
    if axes is None:
        return Spec()
    shape = leaf.shape if hasattr(leaf, "shape") else leaf
    return logical_to_spec(axes, shape, mesh, rules)


def spec_tree_for_params(params: Any, axes_tree: Any, mesh,
                         rules: Optional[Rules] = None) -> Any:
    """Map a tree of logical-axes tuples to a tree of :class:`Spec`s; a
    ``params`` leaf is a tensor or a shape."""
    return _map_axes(lambda axes, leaf: _leaf_spec(axes, leaf, mesh, rules),
                     axes_tree, params)


def sharding_tree(params: Any, axes_tree: Any, mesh,
                  rules: Optional[Rules] = None) -> Any:
    """The tree of DTensor placements (one tuple per leaf) of ``params``."""
    return _map_axes(lambda axes, leaf: spec_to_placements(
        _leaf_spec(axes, leaf, mesh, rules), mesh), axes_tree, params)


def zero_shard_spec(spec: Sequence, shape, mesh, axis: str = "data") -> Spec:
    """ZeRO: additionally shard one replicated dim of an optimizer-state
    tensor over the DP axis.

    Given the parameter's spec, find the first dim that is (a) unsharded,
    (b) divisible by the DP axis size, and assign the DP axis to it —
    optimizer m/v (and the f32 master copy) then consume 1/|data| of the
    memory per device.  Falls back to the param spec when nothing divides
    (small norms/bias vectors: replicating those is free).
    """
    sizes = mesh_axes(mesh)
    spec = Spec(*spec)
    if axis not in sizes or sizes[axis] <= 1:
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))
    used = {a for e in entries if e for a in _cand_axes(e)}
    if axis in used:
        return spec
    size = sizes[axis]
    for i, (e, dim) in enumerate(zip(entries, shape)):
        if e is None and dim % size == 0:
            entries[i] = axis
            while entries and entries[-1] is None:
                entries.pop()
            return Spec(*entries)
    return spec
