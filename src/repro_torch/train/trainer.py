"""Train step assembly (``repro.train.trainer``): microbatched gradient
accumulation + AdamW, on one device (default CUDA).

``make_train_step`` builds the step:

* the global batch splits into ``cfg.num_microbatches`` microbatches along
  the batch dim (the reference's ``reshape(n, b // n, ...)``); each runs
  ``(loss / n).backward()``, which accumulates its f32 gradient into the
  ``.grad`` of the f32 master weights; with per-group remat inside the
  model (``cfg.remat``) the live activations are one microbatch's,
  whatever the global batch;
* the loss is averaged over the microbatches, then one ``adamw_update``
  runs in place and the gradients are dropped (``grad = None``).

Parameters live in the training storage (``init_params(..., master=True)``:
every leaf in ``cfg.param_dtype``) and never require grad themselves.  For
each step the trainer hands the model aliases of them that do: leaves
stacked over groups (``params["groups"]``, whisper's encoder layers)
become one alias per layer, so each layer's gradient lands in its slice of
the master's ``.grad`` in place.  Autograd's backward of a slice of one
stacked leaf would write a zero-filled gradient of the whole stack per
layer (32 x the stack's bytes per microbatch at stablelm-3b's depth).

The reference's ``grad_shardings`` (the FSDP layout of the gradient
accumulator) and the ``bf16_weight_gather`` flag are mesh features; the
port has no mesh yet, so both wait for its sharding (ROADMAP Queue 1 item
5).  The reference's ``compressed_dp`` mode waits with them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch import resolve_device

from .optim import AdamWConfig, adamw_init, adamw_update, tree_leaves, tree_map

TrainState = Dict[str, Any]  # {"params", "opt"}

#: subtrees whose leaves stack layers along dim 0 (``index_tree`` slices
#: them per layer in the model)
_STACKED = (("groups",), ("encoder", "layers"))


def init_train_state(model, generator: torch.Generator, opt_cfg: AdamWConfig,
                     device=None) -> TrainState:
    """Seeded master weights on ``device`` (default CUDA) and fresh AdamW
    state."""
    params = model.init(generator, device=device, master=True)
    return {"params": params, "opt": adamw_init(params)}


def _split_microbatches(batch: Dict[str, torch.Tensor], n: int
                        ) -> List[Dict[str, torch.Tensor]]:
    def split(x):
        b = x.shape[0]
        assert b % n == 0, (b, n)
        return x.reshape(n, b // n, *x.shape[1:])

    parts = {k: split(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def _alias(leaf: torch.Tensor, stacked: bool):
    """Leaves requiring grad that share ``leaf``'s storage, their ``.grad``
    the matching part of ``leaf.grad``: one per layer if ``stacked``."""
    if not stacked:
        return _one(leaf, leaf.grad)
    return [_one(leaf[i], leaf.grad[i]) for i in range(leaf.shape[0])]


def _one(view: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
    out = view.detach().requires_grad_()
    out.grad = grad
    return out


def bind_grads(params: Any) -> Any:
    """Zero ``.grad`` on every master leaf and return the tree of aliases
    the model differentiates (see the module docstring)."""
    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        tree.grad = torch.zeros_like(tree)
        return _alias(tree, any(path[:len(s)] == s for s in _STACKED))

    return walk(params, ())


def _to_device(batch, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def make_train_step(model, opt_cfg: AdamWConfig
                    ) -> Callable[[TrainState, Dict[str, Any]], Any]:
    """The step: ``train_step(state, batch) -> (state, metrics)``.  The
    batch (NumPy arrays or tensors) moves to the parameters' device; the
    state is updated in place and returned; metrics ``loss``, ``lr`` and
    ``grad_norm`` are device tensors."""
    cfg = model.cfg

    def train_step(state: TrainState, batch: Dict[str, Any]):
        params = state["params"]
        device = tree_leaves(params)[0].device
        n = cfg.num_microbatches
        live = bind_grads(params)
        loss = torch.zeros((), dtype=torch.float32, device=device)
        for mb in _split_microbatches(_to_device(batch, device), n):
            mb_loss = model.loss(live, mb)
            (mb_loss / n).backward()
            loss += mb_loss.detach() / n
        grads = tree_map(lambda p: p.grad, params)
        _, _, metrics = adamw_update(opt_cfg, params, grads, state["opt"])
        for p in tree_leaves(params):
            p.grad = None
        metrics["loss"] = loss
        return state, metrics

    return train_step


@dataclasses.dataclass
class Trainer:
    """Minimal driver used by the CLI and the fault-tolerance drill."""

    model: Any
    opt_cfg: AdamWConfig
    checkpointer: Optional[Any] = None  # train.checkpoint.Checkpointer
    checkpoint_every: int = 0
    device: Any = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self._step_fn = make_train_step(self.model, self.opt_cfg)

    def init(self, generator: torch.Generator) -> TrainState:
        return init_train_state(self.model, generator, self.opt_cfg,
                                device=self.device)

    def run(self, state: TrainState, batches, *, steps: int,
            on_metrics: Optional[Callable[[int, dict], None]] = None
            ) -> TrainState:
        it = iter(batches)
        start = int(state["opt"]["step"])
        for i in range(start, start + steps):
            batch = next(it)
            state, metrics = self._step_fn(state, batch)
            if on_metrics is not None:
                on_metrics(i + 1, {k: float(v) for k, v in metrics.items()})
            if (self.checkpointer is not None and self.checkpoint_every
                    and (i + 1) % self.checkpoint_every == 0):
                self.checkpointer.save(int(state["opt"]["step"]), state)
        return state
