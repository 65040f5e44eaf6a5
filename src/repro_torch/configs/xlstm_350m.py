"""xlstm-350m [ssm]: mLSTM + sLSTM blocks at the paper's 7:1 ratio
(arXiv:2405.04517).  d_ff=0: xLSTM blocks carry their own projections."""

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50_304,
    block_pattern=("mlstm",) * 7 + ("slstm",),
    mlp_kind="none",
    norm_kind="layernorm",
    use_rope=False,
    tie_embeddings=True,
    num_microbatches=4,
)


def smoke_config() -> ArchConfig:
    return CONFIG.scaled(
        n_layers=8, d_model=32, n_heads=2, n_kv_heads=2,
        vocab_size=256, num_microbatches=1, remat=False)
