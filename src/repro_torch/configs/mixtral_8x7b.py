"""mixtral-8x7b [moe]: 8 experts top-2, GQA kv=8, SWA (arXiv:2401.04088).

The assignment specifies SWA; window=4096 (mistral-7b lineage).  SWA bounds
the decode cache, so long_500k runs for this arch.
"""

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14_336,  # per-expert
    vocab_size=32_000,
    block_pattern=("swa",),
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
    rope_theta=1_000_000.0,
    window=4096,
    n_experts=8,
    top_k=2,
    capacity_factor=1.25,
    num_microbatches=8,
)


def smoke_config() -> ArchConfig:
    return CONFIG.scaled(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=64,
        vocab_size=256, window=16, n_experts=4, top_k=2,
        num_microbatches=1, remat=False, capacity_factor=8.0)
