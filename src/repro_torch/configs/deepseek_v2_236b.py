"""deepseek-v2-236b [moe]: MLA (kv_lora=512) + 160 routed experts top-6 +
2 shared experts (arXiv:2405.04434).

Deviation noted in DESIGN.md: the real model's first layer uses a dense FFN;
here all 60 layers are MoE so the stack scans as one homogeneous group
(compile-size constraint of the 512-device dry-run host).
"""

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    d_ff=1536,  # per-expert FFN width
    vocab_size=102_400,
    block_pattern=("attn",),
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
    n_experts=160,
    n_shared_experts=2,
    top_k=6,
    capacity_factor=1.25,
    use_mla=True,
    kv_lora_rank=512,
    q_lora_rank=1536,
    rope_head_dim=64,
    nope_head_dim=128,
    v_head_dim=128,
    num_microbatches=8,
)


def smoke_config() -> ArchConfig:
    return CONFIG.scaled(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=32,
        vocab_size=256, n_experts=8, n_shared_experts=1, top_k=2,
        kv_lora_rank=16, q_lora_rank=32, rope_head_dim=8, nope_head_dim=16,
        v_head_dim=16, num_microbatches=1, remat=False,
        # drop-free capacity: smoke tests compare prefill/decode against the
        # full forward, and capacity-dropping is co-batch-dependent
        capacity_factor=8.0)
