"""GQA projection of ``repro.models.attention``: the part the paged serving
steps use.  Attention itself runs in ``kernels`` over the paged pool."""

from __future__ import annotations

from .layers import apply_rope, matmul


def _qkv(cfg, p, x, positions):
    """x (B, T, d) -> q (B, T, H, hd), k and v (B, T, KH, hd)."""
    b, t, _ = x.shape
    h, kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = matmul(x, p["wq"]).reshape(b, t, h, hd)
    k = matmul(x, p["wk"]).reshape(b, t, kh, hd)
    v = matmul(x, p["wv"]).reshape(b, t, kh, hd)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v
