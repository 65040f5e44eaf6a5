"""Abstract arguments and their layouts for the dry run
(``repro.launch.specs``).

Every argument is a ``meta`` tensor: shapes and dtypes, never allocated.
On a mesh it is a meta **DTensor** whose local tensor is this rank's
shard, laid out by the spec trees below (``sharding.axes`` resolves the
logical names), so a step run on the arguments runs each device's local
ops.  ``build_cell`` returns the step callable and the laid-out abstract
arguments of one (arch x shape) cell.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.configs.shapes import ShapeSpec
from repro_torch.models import build_model
from repro_torch.models.common import ArchConfig
from repro_torch.sharding.axes import (Spec, logical_to_spec,
                                       spec_to_placements,
                                       spec_tree_for_params, zero_shard_spec)
from repro_torch.train.optim import AdamWConfig, tree_map
from repro_torch.train.trainer import make_train_step

FSDP_THRESHOLD = 1 << 24  # leaves above 16M elements also shard over DP


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def param_specs(model, mesh, *, fsdp: bool = True) -> Any:
    """Logical specs + the FSDP transform for big leaves."""
    abs_params = model.abstract_params()
    specs = spec_tree_for_params(abs_params, model.params_axes(), mesh)

    def fsdp_one(spec, leaf):
        if not fsdp or leaf.numel() < FSDP_THRESHOLD:
            return spec
        # stacked-group leaves (ndim>=3 with the layers dim first) keep dim0
        # whole so each layer's slice stays local
        entries = list(spec) + [None] * (leaf.ndim - len(spec))
        start = 1 if leaf.ndim >= 3 else 0
        sub = zero_shard_spec(Spec(*entries[start:]), leaf.shape[start:],
                              mesh, axis="data")
        out = entries[:start] + list(sub)
        while out and out[-1] is None:
            out.pop()
        return Spec(*out)

    return tree_map(fsdp_one, specs, abs_params)


def state_specs(model, mesh) -> Tuple[Any, Any]:
    """(abstract train state, spec tree): f32 masters, AdamW m and v in
    f32 and the int32 step, as ``train.trainer.init_train_state`` holds
    them."""
    abs_params = model.abstract_params(master=True)
    p_specs = param_specs(model, mesh)
    f32 = lambda p: _meta(p.shape, torch.float32)  # noqa: E731
    abs_opt = {"m": tree_map(f32, abs_params), "v": tree_map(f32, abs_params),
               "step": _meta((), torch.int32)}
    # m/v inherit the (FSDP) param spec -> ZeRO sharding for free
    opt_specs = {"m": p_specs, "v": p_specs, "step": Spec()}
    return ({"params": abs_params, "opt": abs_opt},
            {"params": p_specs, "opt": opt_specs})


def _extras_shapes(cfg: ArchConfig, batch: int) -> Dict[str, Any]:
    out = {}
    if cfg.frontend == "patches":
        out["patch_embeds"] = _meta((batch, cfg.n_frontend_tokens,
                                     cfg.d_model), cfg.dtype)
    if cfg.frontend == "frames":
        out["frames"] = _meta((batch, cfg.encoder_ctx, cfg.d_model),
                              cfg.dtype)
    return out


def _extras_specs(cfg: ArchConfig, extras: Dict[str, Any], mesh):
    return {k: logical_to_spec(("batch", None, None), v.shape, mesh)
            for k, v in extras.items()}


def _serving_params(model) -> Any:
    """Serving checkpoints store activations-dtype (bf16) weights."""
    dt = model.cfg.dtype
    return tree_map(lambda l: _meta(l.shape, dt if l.is_floating_point()
                                    else l.dtype), model.abstract_params())


def _placed(leaf: torch.Tensor, spec, mesh):
    """``leaf``'s shape as a meta DTensor laid out by ``spec`` on ``mesh``
    (its local tensor this rank's shard)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    placements = spec_to_placements(spec, mesh)
    local, _ = compute_local_shape_and_global_offset(leaf.shape, mesh,
                                                     placements)
    return DTensor.from_local(_meta(local, leaf.dtype), mesh, placements,
                              run_check=False, shape=leaf.shape,
                              stride=_meta(leaf.shape, leaf.dtype).stride())


def place(tree: Any, specs: Any, mesh) -> Any:
    """A tree of meta tensors as meta DTensors laid out by ``specs``."""
    return tree_map(lambda leaf, spec: _placed(leaf, spec, mesh), tree,
                    specs)


@dataclasses.dataclass
class Cell:
    """One (arch x shape) dry-run cell: ``step(*args)`` runs it.  The
    arguments carry their layouts (the reference's ``in_shardings``), and
    the step updates the train state and the decode cache in place (its
    ``donate_argnums``)."""

    step: Callable
    args: Tuple
    description: str


def build_cell(cfg: ArchConfig, shape: ShapeSpec, mesh) -> Cell:
    """The cell on ``mesh`` (a ``DeviceMesh`` with the production axis
    names: 1x1, (2, 2) or a production mesh).  Run its step under
    ``sharding.axes.axis_rules(mesh)``."""
    model = build_model(cfg)
    b, s = shape.global_batch, shape.seq_len

    def laid_out(trees, specs):
        return tuple(place(t, sp, mesh) for t, sp in zip(trees, specs))

    if shape.kind == "train":
        state, specs = state_specs(model, mesh)
        extras = _extras_shapes(cfg, b)
        batch = {"tokens": _meta((b, s), torch.int32),
                 "labels": _meta((b, s), torch.int32), **extras}
        bspec = {
            "tokens": logical_to_spec(("batch", None), (b, s), mesh),
            "labels": logical_to_spec(("batch", None), (b, s), mesh),
            **_extras_specs(cfg, extras, mesh),
        }
        grads = tree_map(lambda sp: spec_to_placements(sp, mesh),
                         specs["params"])
        step = make_train_step(model, AdamWConfig(), grad_shardings=grads)
        return Cell(step, laid_out((state, batch), (specs, bspec)),
                    f"train_step[{cfg.name}|{shape.name}]")

    p_specs = param_specs(model, mesh)
    params = _serving_params(model)
    if shape.kind == "prefill":
        tokens = _meta((b, s), torch.int32)
        extras = _extras_shapes(cfg, b)
        in_specs = (p_specs, logical_to_spec(("batch", None), (b, s), mesh),
                    _extras_specs(cfg, extras, mesh))

        def step(params, tokens, extra):
            return model.prefill(params, tokens, max_len=s, extra=extra)

        return Cell(step, laid_out((params, tokens, extras), in_specs),
                    f"prefill_step[{cfg.name}|{shape.name}]")

    # decode: one new token against a cache of seq_len
    cache = model.init_cache(b, s, device="meta")
    vspec = logical_to_spec(("batch",), (b,), mesh)
    in_specs = (p_specs,
                spec_tree_for_params(cache, model.cache_axes(), mesh),
                vspec, vspec)
    vec = _meta((b,), torch.int32)

    def step(params, cache, tokens, positions):
        return model.decode_step(params, cache, tokens, positions)

    return Cell(step, laid_out((params, cache, vec, vec), in_specs),
                f"serve_step[{cfg.name}|{shape.name}]")
