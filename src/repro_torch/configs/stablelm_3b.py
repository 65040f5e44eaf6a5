"""stablelm-3b [dense]: 32L MHA, LayerNorm, partial-RoPE-style dense LM
[hf:stabilityai/stablelm-2-1_6b lineage; unverified]."""

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-3b",
    family="dense",
    n_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=6912,
    vocab_size=50_304,
    block_pattern=("attn",),
    mlp_kind="swiglu",
    norm_kind="layernorm",
    rope_theta=10_000.0,
    num_microbatches=8,
)


def smoke_config() -> ArchConfig:
    return CONFIG.scaled(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=256, num_microbatches=1, remat=False)
