"""Modality frontend stubs (``repro.models.frontends``): pixtral's patch
embeddings overwrite the first positions; whisper's frames feed the
encoder directly (``transformer.run_encoder``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import matmul

FRONTEND_AXES = {"proj": ("embed", "embed")}


def splice_prefix(cfg, p, x: torch.Tensor,
                  prefix_embeds: torch.Tensor) -> torch.Tensor:
    """Overwrite the first P positions of x (B, S, d) with projected embeds."""
    proj = matmul(prefix_embeds.to(x.dtype), p["proj"])
    pad = x.shape[1] - proj.shape[1]
    if pad < 0:
        proj = proj[:, : x.shape[1]]
        pad = 0
    mask = (torch.arange(x.shape[1], device=x.device)
            < prefix_embeds.shape[1])[None, :, None]
    return torch.where(mask, F.pad(proj, (0, 0, 0, pad)), x)
