"""gemma-7b [dense]: GeGLU, head_dim=256, MHA kv=16, tied embeddings,
256k vocab (arXiv:2403.08295)."""

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    d_ff=24_576,
    vocab_size=256_000,
    head_dim=256,
    block_pattern=("attn",),
    mlp_kind="geglu",
    norm_kind="rmsnorm",
    tie_embeddings=True,
    num_microbatches=8,
)


def smoke_config() -> ArchConfig:
    return CONFIG.scaled(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=256, head_dim=16, num_microbatches=1, remat=False)
