"""AdamW (``repro.train.optim``), in place.

State layout parallels the parameters: {m, v} trees in f32 plus a scalar
``step`` (a 0-d int32 tensor on the parameters' device).  The update runs
one leaf at a time in f32 with the reference's clip, bias corrections and
decoupled weight decay (``repro/train/optim.py:57-91``), under
``no_grad`` and in place: the reference returns new trees, the port
overwrites the parameters, m, v and step and returns the same objects.
Every scalar (step, lr, the clip factor) stays a device tensor, so the
update makes no host sync; reading ``metrics`` does.  On DTensor
parameters m and v take each parameter's placements and the update runs
on DTensors.

Trees are nested dicts; like ``jax.tree`` the helpers here walk them in
sorted-key order, so leaf lists line up with the reference's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def tree_items(tree: Any, path: Tuple[str, ...] = ()) -> List[Tuple[Tuple[str, ...], Any]]:
    """(key path, leaf) pairs of a nested dict in sorted-key order (the
    order of ``jax.tree.leaves``)."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree) for item in tree_items(tree[k], path + (k,))]
    return [(path, tree)]


def tree_leaves(tree: Any) -> list:
    return [leaf for _, leaf in tree_items(tree)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and of the matching nested dicts
    ``rest`` (``fn(leaf, *leaves)``); ``tree``'s keys drive."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(t[k] for t in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def adamw_init(params: Any) -> Any:
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
    device = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def lr_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_ratio (f32 tensor)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree: Any) -> torch.Tensor:
    sq = sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree))
    return torch.sqrt(sq)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: Any, grads: Any, state: Any
                 ) -> Tuple[Any, Any, dict]:
    """One AdamW step, in place; returns (params, state, metrics) with
    metrics ``lr`` and ``grad_norm`` as device tensors."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state["m"]), tree_leaves(state["v"])):
        g = g.float() * clip
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        delta = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
        delta.add_(cfg.weight_decay * p.float())
        if p.dtype == torch.float32:
            p.sub_(delta.mul_(lr))
        else:
            p.copy_(p.float() - lr * delta)
    state["step"].copy_(step)
    return params, state, {"lr": lr, "grad_norm": gnorm}
