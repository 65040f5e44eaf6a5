"""starcoder2-3b [dense]: GQA kv=2, RoPE, LayerNorm, GELU MLP
(arXiv:2402.19173)."""

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-3b",
    family="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    d_ff=12_288,
    vocab_size=49_152,
    block_pattern=("attn",),
    mlp_kind="gelu",
    norm_kind="layernorm",
    rope_theta=100_000.0,
    num_microbatches=8,
)


def smoke_config() -> ArchConfig:
    return CONFIG.scaled(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=256, num_microbatches=1, remat=False)
