"""whisper-small [audio]: encoder-decoder; the log-mel conv frontend is a
STUB — encoder inputs are precomputed frame embeddings (arXiv:2212.04356).

Enc-dec (not encoder-only), so decode shapes run: the assigned seq_len is
applied to the decoder self-attention cache mechanically; the cross-attention
context is fixed at 1500 frames.
"""

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=51_865,
    block_pattern=("attn",),
    mlp_kind="gelu",
    norm_kind="layernorm",
    use_rope=False,  # learned positions
    is_encoder_decoder=True,
    n_encoder_layers=12,
    encoder_ctx=1500,
    frontend="frames",
    num_microbatches=4,
)


def smoke_config() -> ArchConfig:
    return CONFIG.scaled(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=256, n_encoder_layers=2, encoder_ctx=16,
        num_microbatches=1, remat=False)
