"""Parameter trees for the serving model: a seeded init and the reference bridge.

Both build the key and shape tree of ``repro.models.transformer.init_params``
for dense attention stacks: per-layer weights stacked along a leading group
axis under ``groups/b{j}_{kind}``, plus ``embed``, ``final_norm``, ``head``
when embeddings are untied, and ``frontend/proj`` for the patch frontend
(pixtral's stub, ``repro/models/frontends.py``: the paged steps never read
it, and the tree carries it so the reference's parameters map one to one).  Matmul weights and the embedding table are
stored already cast to ``cfg.dtype``, which is bit-identical to the per-call
cast in ``layers.matmul`` and ``embed_tokens`` and halves their bytes in
bf16; norm parameters stay in ``cfg.param_dtype``.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

from repro_torch import resolve_device

Params = Dict[str, Any]

#: lecun_normal's truncated-normal correction: the std of a unit normal
#: truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def _check_supported(cfg) -> None:
    if (cfg.use_mla or cfg.is_moe or cfg.is_encoder_decoder
            or cfg.frontend not in (None, "patches")):
        raise NotImplementedError(
            f"{cfg.name}: only dense attention stacks are ported so far")
    if any(k != "attn" for k in cfg.block_pattern):
        raise NotImplementedError(
            f"{cfg.name}: block kinds {cfg.block_pattern} are not ported yet")


def _shapes(cfg) -> Params:
    """The parameter tree as nested dicts of (shape, kind) leaves; kind is
    ``dense`` (lecun normal, fan-in = shape[-2]), ``embed`` (unit normal) or
    ``norm`` (zeros, kept in param_dtype)."""
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    h, kh, hd, g = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, cfg.n_groups

    def norm(lead=()):
        p = {"scale": (lead + (d,), "norm")}
        if cfg.norm_kind == "layernorm":
            p["bias"] = (lead + (d,), "norm")
        return p

    block = {"norm_mix": norm((g,)),
             "mix": {"wq": ((g, d, h * hd), "dense"),
                     "wk": ((g, d, kh * hd), "dense"),
                     "wv": ((g, d, kh * hd), "dense"),
                     "wo": ((g, h * hd, d), "dense")}}
    if cfg.d_ff > 0 and cfg.mlp_kind != "none":
        block["norm_mlp"] = norm((g,))
        names = (("wi_gate", "wi_up") if cfg.mlp_kind in ("swiglu", "geglu")
                 else ("wi",))
        block["mlp"] = {n: ((g, d, f), "dense") for n in names}
        block["mlp"]["wo"] = ((g, f, d), "dense")
    tree: Params = {
        "embed": {"table": ((v, d), "embed")},
        "groups": {f"b{j}_{kind}": block
                   for j, kind in enumerate(cfg.block_pattern)},
        "final_norm": norm(),
    }
    if not cfg.tie_embeddings:
        tree["head"] = {"kernel": ((d, v), "dense")}
    if cfg.frontend:
        tree["frontend"] = {"proj": ((d, d), "dense")}
    return tree


def _map(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _map(v, fn, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def init_params(cfg, generator: torch.Generator, device=None) -> Params:
    """Seeded random parameters on ``device`` (default CUDA).

    Dense weights are lecun-normal (truncated normal, std sqrt(1/fan_in)),
    the embedding unit normal, norms zero, as in the reference init; the
    numbers differ from ``jax.random``'s.  ``generator`` must live on
    ``device``.  Weights are drawn one stacked layer at a time in f32, so
    the f32 scratch is one layer's largest matrix.
    """
    _check_supported(cfg)
    dev = resolve_device(device)

    def leaf(path, spec):
        shape, kind = spec
        if kind == "norm":
            return torch.zeros(shape, dtype=cfg.param_dtype, device=dev)
        out = torch.empty(shape, dtype=cfg.dtype, device=dev)
        rows = out.view(-1, *shape[-2:])
        std = 1.0 if kind == "embed" else (
            math.sqrt(1.0 / shape[-2]) / _TRUNC_STD)
        for i in range(rows.shape[0]):
            tmp = torch.empty(shape[-2:], dtype=torch.float32, device=dev)
            if kind == "embed":
                tmp.normal_(0.0, std, generator=generator)
            else:
                torch.nn.init.trunc_normal_(tmp, 0.0, std, -2 * std, 2 * std,
                                            generator=generator)
            rows[i].copy_(tmp)
        return out

    return _map(_shapes(cfg), leaf)


def from_jax_params(cfg, tree: Params, device=None) -> Params:
    """Carry a reference parameter pytree (nested dicts of NumPy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``) onto ``device`` (default CUDA),
    with the same keys, shapes and storage dtypes as :func:`init_params`."""
    _check_supported(cfg)
    dev = resolve_device(device)

    def leaf(path, spec):
        shape, kind = spec
        node = tree
        for k in path:
            node = node[k]
        arr = np.asarray(node)
        if arr.shape != shape:
            raise ValueError(f"{'/'.join(path)}: shape {arr.shape}, "
                             f"expected {shape}")
        dtype = cfg.param_dtype if kind == "norm" else cfg.dtype
        return torch.from_numpy(arr.astype(np.float32)).to(dev, dtype)

    return _map(_shapes(cfg), leaf)
