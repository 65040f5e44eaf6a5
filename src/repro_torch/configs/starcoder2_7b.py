"""starcoder2-7b [dense]: GQA kv=4, RoPE, LayerNorm, GELU MLP
(arXiv:2402.19173)."""

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    d_ff=18_432,
    vocab_size=49_152,
    block_pattern=("attn",),
    mlp_kind="gelu",
    norm_kind="layernorm",
    rope_theta=100_000.0,
    num_microbatches=8,
)


def smoke_config() -> ArchConfig:
    return CONFIG.scaled(
        n_layers=2, d_model=72, n_heads=6, n_kv_heads=2, d_ff=144,
        vocab_size=256, head_dim=12, num_microbatches=1, remat=False)
