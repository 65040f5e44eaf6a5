"""recurrentgemma-2b [hybrid]: RG-LRU + local attention (arXiv:2402.19427).

26 layers with local attention every third layer (Griffin 1:2 pattern).
26 % 3 != 0, so the repeating group is the 13-layer half-stack
(r,r,a)x4 + r — over 26 layers that yields the paper's 18 recurrent +
8 local-attention layers with attention at every third position.
"""

from repro_torch.models.common import ArchConfig

_PATTERN = ("rglru", "rglru", "local_attn") * 4 + ("rglru",)

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,  # MQA on the local-attention layers
    d_ff=7680,
    vocab_size=256_000,
    head_dim=256,
    block_pattern=_PATTERN,
    mlp_kind="geglu",
    norm_kind="rmsnorm",
    window=2048,  # local attention window
    lru_width=2560,
    rglru_conv_width=4,
    tie_embeddings=True,
    logit_softcap=30.0,
    num_microbatches=8,
)


def smoke_config() -> ArchConfig:
    return CONFIG.scaled(
        n_layers=13, d_model=64, n_heads=2, n_kv_heads=1, d_ff=96,
        vocab_size=256, head_dim=16, window=8, lru_width=64,
        num_microbatches=1, remat=False)
