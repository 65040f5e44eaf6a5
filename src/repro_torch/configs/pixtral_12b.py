"""pixtral-12b [vlm]: mistral-nemo-style decoder backbone; the pixtral-ViT
frontend is a STUB — inputs carry precomputed patch embeddings
[hf:mistralai/Pixtral-12B-2409; unverified]."""

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14_336,
    vocab_size=131_072,
    head_dim=128,
    block_pattern=("attn",),
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
    rope_theta=1_000_000_000.0,
    frontend="patches",
    n_frontend_tokens=256,
    num_microbatches=8,
)


def smoke_config() -> ArchConfig:
    return CONFIG.scaled(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=256, head_dim=16, n_frontend_tokens=8,
        num_microbatches=1, remat=False)
