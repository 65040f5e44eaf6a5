"""Architecture config schema: ``repro.models.common.ArchConfig`` with torch
dtypes.

One dataclass covers every assigned architecture; family-specific fields are
optional with sane defaults.  ``block_pattern`` describes the repeating layer
group; parameters are stacked along a leading group axis, as in ``repro``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // n_heads

    # layer stack: one entry per layer within a repeating group
    block_pattern: Tuple[str, ...] = ("attn",)  # attn|local_attn|swa|rglru|mlstm|slstm
    mlp_kind: str = "swiglu"  # swiglu | geglu | gelu | none
    norm_kind: str = "rmsnorm"  # rmsnorm | layernorm
    rope_theta: float = 10000.0
    use_rope: bool = True
    tie_embeddings: bool = False
    logit_softcap: Optional[float] = None  # gemma-style final soft-capping

    # attention windows
    window: Optional[int] = None  # sliding-window / local-attn width

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25

    # MLA (deepseek-v2)
    use_mla: bool = False
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128

    # recurrent families
    rglru_conv_width: int = 4  # recurrentgemma temporal-conv width
    lru_width: Optional[int] = None  # RG-LRU state width (default d_model)

    # enc-dec (whisper)
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_ctx: int = 0  # encoder sequence length (whisper: 1500 frames)

    # modality frontend stub
    frontend: Optional[str] = None  # None | "patches" | "frames"
    n_frontend_tokens: int = 0  # patch/frame embeddings prepended to the LM

    # training substrate knobs
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    remat: bool = True
    num_microbatches: int = 8
    zero_sharded_opt: bool = True
    scan_layers: bool = True

    # --- derived ---------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def n_groups(self) -> int:
        assert self.n_layers % len(self.block_pattern) == 0, (
            f"{self.name}: n_layers={self.n_layers} not divisible by "
            f"pattern length {len(self.block_pattern)}"
        )
        return self.n_layers // len(self.block_pattern)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def supports_long_context(self) -> bool:
        """True if decoding is sub-quadratic (bounded window or O(1) state)."""
        kinds = set(self.block_pattern)
        full = {"attn"} & kinds
        return not full or (self.window is not None and "attn" not in kinds)

    def param_count(self) -> int:
        """Exact parameter count (embedding + stack + head)."""
        from . import model_zoo  # lazy: avoids an import cycle

        return model_zoo.count_params(self)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: shared + top_k experts)."""
        from . import model_zoo

        return model_zoo.count_params(self, active_only=True)

    def scaled(self, **overrides) -> "ArchConfig":
        """A reduced copy for smoke tests (dataclasses.replace wrapper)."""
        return dataclasses.replace(self, **overrides)
