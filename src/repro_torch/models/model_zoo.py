"""Model bundle (``repro.models.model_zoo``): closes an ArchConfig over the
transformer assembly, and the analytic parameter counters."""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from . import transformer
from .common import ArchConfig
from .params import _map, _shapes, init_params, leaves, storage_dtype


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig

    # -- parameters -------------------------------------------------------
    def init(self, generator: torch.Generator, device=None, *,
             master: bool = False) -> Any:
        """Seeded parameters on ``device`` (default CUDA); ``master``: the
        training storage, every leaf in ``param_dtype``."""
        return init_params(self.cfg, generator, device=device, master=master)

    def abstract_params(self, *, master: bool = False) -> Any:
        """The tree of ``init`` as ``meta`` tensors (shapes and storage
        dtypes, no storage): nothing is allocated."""
        return _map(_shapes(self.cfg), lambda path, spec: torch.empty(
            spec[0], dtype=storage_dtype(self.cfg, spec[1], master),
            device="meta"))

    def params_axes(self) -> Any:
        return transformer.params_axes(self.cfg)

    # -- steps ------------------------------------------------------------
    def forward(self, params, tokens, extra=None):
        return transformer.forward(self.cfg, params, tokens, extra)

    def loss(self, params, batch):
        return transformer.lm_loss(self.cfg, params, batch)

    def prefill(self, params, tokens, max_len=None, extra=None):
        return transformer.prefill(self.cfg, params, tokens, max_len, extra)

    def decode_step(self, params, cache, tokens, positions):
        return transformer.decode_step(self.cfg, params, cache, tokens,
                                       positions)

    def init_cache(self, batch, max_len, device=None):
        return transformer.init_cache(self.cfg, batch, max_len, device=device)

    def cache_axes(self):
        return transformer.cache_axes(self.cfg)


def build_model(cfg: ArchConfig) -> Model:
    return Model(cfg)


#: routed-expert leaves, counted at top_k / n_experts by ``active_only``
_EXPERT_KEYS = ("wi_gate", "wi_up", "wo")


def count_params(cfg: ArchConfig, active_only: bool = False) -> int:
    """Total parameters, from the shape tree (nothing is allocated);
    ``active_only`` scales each routed-expert leaf by top_k / n_experts (the
    per-token activated fraction), truncating per leaf as the reference
    does; shared experts count in full."""
    total = 0
    for path, (shape, _) in leaves(_shapes(cfg)):
        n = math.prod(shape)
        if (active_only and cfg.is_moe and len(path) >= 2
                and path[-2] == "mlp" and path[-1] in _EXPERT_KEYS):
            n = int(n * cfg.top_k / cfg.n_experts)
        total += n
    return total
