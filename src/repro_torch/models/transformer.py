"""Model assembly (``repro.models.transformer``): decoder-only LMs and the
whisper encoder-decoder — ``forward`` and ``lm_loss`` (differentiable, for
training and inference), ``init_cache``, ``prefill`` and ``decode_step``
(inference, under ``no_grad``).

The stack is ``n_groups`` repetitions of ``cfg.block_pattern`` with every
parameter stacked along a leading group axis, as in the reference; where
the reference scans over groups, the port loops.  Block kinds: attn |
local_attn | swa | rglru | mlstm | slstm, each pre-norm residual
(x += mix(norm(x)); x += mlp(norm(x)), the MLP a MoE FFN for MoE configs
and skipped where ``d_ff == 0`` or ``mlp_kind == "none"``).
:func:`params_axes` and :func:`cache_axes` give the logical axes of every
parameter and cache leaf (``sharding.axes``); the layers constrain their
activations by logical names, which acts only under ``axis_rules`` with a
mesh installed and DTensor operands.

``forward``, ``prefill`` and ``run_encoder`` build their positions as
``arange(T)`` and say so to ``attention.flash_attention``
(``arange_positions=True``), which is what lets their self-attention take
the CUDA flash kernel.  ``decode_step`` updates the cache in place and
returns it.

``forward`` builds an autograd graph only where a parameter requires grad
(the trainer's); serving and the zoo's inference callers pass parameters
that do not, so they run without one.  With ``cfg.remat`` and grad
enabled, each group of the block pattern runs under
``torch.utils.checkpoint`` (non-reentrant): its activations are recomputed
in the backward, as the reference's ``jax.checkpoint(group_fn)``
(``repro/models/transformer.py:266-267``).  The recompute runs the group's
forward again, so a flash call there counts in ``attention.FLASH_ROUTES``
(and the kernel's ``LAUNCHES``) a second time.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.sharding.axes import (flatten_last, is_dtensor,
                                       logical_constraint, per_rows,
                                       unflatten_last)

from . import attention as attn
from . import frontends, moe, rglru, xlstm
from .layers import (EMBED_AXES, MLP_AXES, NORM_AXES, apply_mlp, apply_norm,
                     embed_tokens, index_tree, matmul, stack_trees, unembed)

Params = Dict[str, Any]
_ATTN = ("attn", "local_attn", "swa")


def _has_mlp(cfg) -> bool:
    return cfg.d_ff > 0 and cfg.mlp_kind != "none"


def _block_axes(cfg, kind: str):
    ax: Dict[str, Any] = {"norm_mix": NORM_AXES if cfg.norm_kind == "layernorm"
                          else {"scale": ("embed",)}}
    norm_ax = ax["norm_mix"]
    if kind in _ATTN:
        ax["mix"] = attn.MLA_AXES if cfg.use_mla else attn.GQA_AXES
    elif kind == "rglru":
        ax["mix"] = rglru.RGLRU_AXES
    elif kind == "mlstm":
        ax["mix"] = xlstm.MLSTM_AXES
    elif kind == "slstm":
        ax["mix"] = xlstm.SLSTM_AXES
    if _has_mlp(cfg):
        ax["norm_mlp"] = norm_ax
        if cfg.is_moe:
            ax["mlp"] = {k: v for k, v in moe.MOE_AXES.items()
                         if k != "shared" or cfg.n_shared_experts}
        else:
            ax["mlp"] = {
                k: MLP_AXES[k] for k in
                (("wi_gate", "wi_up", "wo")
                 if cfg.mlp_kind in ("swiglu", "geglu") else ("wi", "wo"))
            }
    if cfg.is_encoder_decoder:
        ax["norm_cross"] = norm_ax
        ax["cross"] = attn.GQA_AXES
    return ax


def _lift(ax_tree):
    """Prepend the stacked-groups (or stacked-layers) axis to every leaf."""
    if isinstance(ax_tree, dict):
        return {k: _lift(v) for k, v in ax_tree.items()}
    return ("layers",) + tuple(ax_tree)


def params_axes(cfg) -> Any:
    """Logical-axes tree matching ``init_params`` (leading group dim ->
    "layers")."""
    ax: Dict[str, Any] = {
        "embed": EMBED_AXES,
        "groups": _lift({f"b{j}_{kind}": _block_axes(cfg, kind)
                         for j, kind in enumerate(cfg.block_pattern)}),
        "final_norm": {"scale": ("embed",)} if cfg.norm_kind != "layernorm"
        else NORM_AXES,
    }
    if not cfg.tie_embeddings:
        ax["head"] = {"kernel": ("embed", "vocab")}
    if cfg.frontend:
        ax["frontend"] = frontends.FRONTEND_AXES
    if cfg.is_encoder_decoder:
        enc_block_ax = {
            "norm_mix": NORM_AXES, "mix": attn.GQA_AXES,
            "norm_mlp": NORM_AXES,
            "mlp": {"wi": MLP_AXES["wi"], "wo": MLP_AXES["wo"]},
        }
        ax["encoder"] = {
            "layers": _lift(enc_block_ax),
            "pos": {"pos": ("seq", "embed")},
            "final_norm": NORM_AXES,
        }
        ax["dec_pos"] = {"pos": ("seq", "embed")}
    return ax


def _positions(b: int, t: int, device) -> torch.Tensor:
    return torch.arange(t, device=device)[None].expand(b, t)


def _ffn(cfg, bp, x):
    if not _has_mlp(cfg):
        return x
    h = apply_norm(cfg, bp["norm_mlp"], x)
    ff = (moe.apply_moe(cfg, bp["mlp"], h) if cfg.is_moe
          else apply_mlp(cfg, bp["mlp"], h))
    return x + ff


def _cross_train(cfg, bp, x, positions, cross_kv):
    h = apply_norm(cfg, bp["norm_cross"], x)
    (k, v), enc_pos = cross_kv
    return x + attn.gqa_train(cfg, bp["cross"], h, positions, causal=False,
                              kv_override=(k, v), kv_positions=enc_pos)


def _cross_kv(cfg, bp, enc_out, enc_pos):
    kh, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    k = unflatten_last(matmul(enc_out, bp["cross"]["wk"]), (kh, hd))
    v = unflatten_last(matmul(enc_out, bp["cross"]["wv"]), (kh, hd))
    return (k, v), enc_pos


# ------------------------------------------------------------------ forward
def _mix_train(cfg, kind, bp, x, positions, cross_kv=None):
    h = apply_norm(cfg, bp["norm_mix"], x)
    if kind in _ATTN:
        window = cfg.window if kind in ("local_attn", "swa") else None
        if cfg.use_mla:
            out = attn.mla_train(cfg, bp["mix"], h, positions,
                                 arange_positions=True)
        else:
            out = attn.gqa_train(cfg, bp["mix"], h, positions, window=window,
                                 arange_positions=True)
    elif kind == "rglru":
        out = rglru.rglru_train(cfg, bp["mix"], h)
    elif kind == "mlstm":
        out = xlstm.mlstm_train(cfg, bp["mix"], h)
    else:  # slstm
        out = xlstm.slstm_train(cfg, bp["mix"], h)
    x = x + out
    if cross_kv is not None:
        x = _cross_train(cfg, bp, x, positions, cross_kv)
    return _ffn(cfg, bp, x)


def _dec_pos_embed(cfg, params, s: int) -> torch.Tensor:
    """Learned decoder positions, clamped to the table size (the assigned
    decode/prefill shapes mechanically exceed whisper's native context)."""
    table = params["dec_pos"]["pos"].to(cfg.dtype)
    idx = torch.clamp(torch.arange(s, device=table.device),
                      max=table.shape[0] - 1)
    return table[idx][None]


def run_encoder(cfg, params, frames: torch.Tensor) -> torch.Tensor:
    """Whisper encoder over precomputed frame embeddings (B, Te, d)."""
    enc = params["encoder"]
    x = frames.to(cfg.dtype) + enc["pos"]["pos"].to(cfg.dtype)[None]
    pos = _positions(x.shape[0], x.shape[1], x.device)
    for i in range(cfg.n_encoder_layers):
        lp = index_tree(enc["layers"], i)
        h = apply_norm(cfg, lp["norm_mix"], x)
        x = x + attn.gqa_train(cfg, lp["mix"], h, pos, causal=False,
                               arange_positions=True)
        h = apply_norm(cfg, lp["norm_mlp"], x)
        x = x + apply_mlp(cfg, lp["mlp"], h)
    return apply_norm(cfg, enc["final_norm"], x)


def _embed(cfg, params, tokens, extra):
    """Token embeddings with pixtral's patch prefix spliced in, and for
    whisper the encoder output and its positions (else None, None)."""
    b, s = tokens.shape
    x = embed_tokens(cfg, params["embed"], tokens)
    if cfg.frontend == "patches" and "patch_embeds" in extra:
        x = frontends.splice_prefix(cfg, params["frontend"], x,
                                    extra["patch_embeds"])
    enc_out = enc_pos = None
    if cfg.is_encoder_decoder:
        enc_out = run_encoder(cfg, params, extra["frames"])
        enc_pos = _positions(b, enc_out.shape[1], enc_out.device)
        x = x + _dec_pos_embed(cfg, params, s)
    return x, enc_out, enc_pos


def _logits(cfg, params, x):
    x = apply_norm(cfg, params["final_norm"], x)
    head = params["embed"] if cfg.tie_embeddings else params["head"]
    return unembed(cfg, head, x)


def _group(cfg, gp, x, positions, enc_out, enc_pos):
    """One group of the block pattern (the reference's ``_group_train``)."""
    for j, kind in enumerate(cfg.block_pattern):
        bp = gp[f"b{j}_{kind}"]
        cross_kv = (_cross_kv(cfg, bp, enc_out, enc_pos)
                    if enc_out is not None else None)
        x = _mix_train(cfg, kind, bp, x, positions, cross_kv)
    return x


def forward(cfg, params, tokens: torch.Tensor,
            extra: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """Full-sequence logits.  tokens: (B, S) -> (B, S, V) f32."""
    extra = extra or {}
    x, enc_out, enc_pos = _embed(cfg, params, tokens, extra)
    positions = _positions(*tokens.shape, tokens.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for g in range(cfg.n_groups):
        gp = index_tree(params["groups"], g)
        if remat:
            x = checkpoint(_group, cfg, gp, x, positions, enc_out, enc_pos,
                           use_reentrant=False)
        else:
            x = _group(cfg, gp, x, positions, enc_out, enc_pos)
    return _logits(cfg, params, x)


def lm_loss(cfg, params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Next-token cross-entropy; batch: tokens (B,S), labels (B,S) (-1 = pad)."""
    logits = forward(cfg, params, batch["tokens"],
                     {k: v for k, v in batch.items()
                      if k not in ("tokens", "labels")})
    labels = batch["labels"]
    valid = labels >= 0
    label = torch.clamp(labels, min=0).long()[..., None]
    if is_dtensor(logits) and any(pl.is_shard(logits.ndim - 1)
                                  for pl in logits.placements):
        # vocab-parallel where the vocab is sharded: the logits stay
        # sharded and only (B, S) partial maxima and sums cross ranks.
        # logsumexp would gather the vocab, and DTensor has no
        # vocab-parallel gather, so the log-sum is spelled out (ATen's own
        # steps) and the pick is a masked sum (one nonzero term, so the
        # same value)
        top = logits.detach().amax(-1, keepdim=True)
        lse = (logits - top).exp().sum(-1).log() + top[..., 0]
        vocab = torch.arange(logits.shape[-1], device=label.device)
        picked = torch.where(vocab == label, logits, 0.0).sum(-1)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        picked = torch.gather(logits, -1, label)[..., 0]
    nll = torch.where(valid, lse - picked, 0.0)
    return nll.sum() / torch.clamp(valid.sum(), min=1)


# ================================================================ caches
def _cache_len(cfg, kind: str, max_len: int) -> int:
    if kind in ("local_attn", "swa") and cfg.window is not None:
        return min(cfg.window, max_len)
    return max_len


def init_cache(cfg, batch: int, max_len: int, device=None) -> Params:
    """Decode-state tree on ``device`` (default CUDA); attn caches sized
    max_len (window-clamped), each leaf stacked over the groups."""
    dev = resolve_device(device)
    groups: Dict[str, Any] = {}
    for j, kind in enumerate(cfg.block_pattern):
        if kind in _ATTN:
            ln = _cache_len(cfg, kind, max_len)
            one = (attn.init_mla_cache(cfg, batch, ln, device=dev)
                   if cfg.use_mla
                   else attn.init_kv_cache(cfg, batch, ln, device=dev))
        elif kind == "rglru":
            one = rglru.init_rglru_state(cfg, batch, device=dev)
        elif kind == "mlstm":
            one = xlstm.init_mlstm_state(cfg, batch, device=dev)
        else:
            one = xlstm.init_slstm_state(cfg, batch, device=dev)
        groups[f"b{j}_{kind}"] = {
            k: a[None].expand((cfg.n_groups,) + a.shape).clone()
            for k, a in one.items()}
    cache: Params = {"groups": groups}
    if cfg.is_encoder_decoder:
        kh, hd = cfg.n_kv_heads, cfg.resolved_head_dim
        shape = (cfg.n_groups, batch, cfg.encoder_ctx, kh, hd)
        cache["cross"] = {
            f"b{j}_{kind}": {
                "k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
                "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}
            for j, kind in enumerate(cfg.block_pattern)}
    return cache


def cache_axes(cfg) -> Any:
    """Logical axes of the cache tree (prefixed by the groups dim)."""
    groups = {}
    for j, kind in enumerate(cfg.block_pattern):
        if kind in _ATTN:
            ax = attn.MLA_CACHE_AXES if cfg.use_mla else attn.KV_CACHE_AXES
        elif kind == "rglru":
            ax = rglru.RGLRU_STATE_AXES
        elif kind == "mlstm":
            ax = xlstm.MLSTM_STATE_AXES
        else:
            ax = {"c": ("batch", "embed"), "n": ("batch", "embed"),
                  "h": ("batch", "embed"), "m": ("batch", "embed"),
                  "conv": ("batch", None, "embed")}
        groups[f"b{j}_{kind}"] = _lift(ax)
    out: Dict[str, Any] = {"groups": groups}
    if cfg.is_encoder_decoder:
        out["cross"] = {
            f"b{j}_{kind}": _lift(attn.KV_CACHE_AXES)
            for j, kind in enumerate(cfg.block_pattern)
        }
    return out


# ================================================================ prefill
def _mix_prefill(cfg, kind, bp, x, positions, max_len, cross_kv=None):
    h = apply_norm(cfg, bp["norm_mix"], x)
    window = cfg.window if kind in ("local_attn", "swa") else None
    if kind in _ATTN:
        ln = _cache_len(cfg, kind, max_len)
        if cfg.use_mla:
            out, c = attn.mla_prefill(cfg, bp["mix"], h, positions, ln,
                                      arange_positions=True)
        else:
            out, c = attn.gqa_prefill(cfg, bp["mix"], h, positions, ln,
                                      window=window, arange_positions=True)
    elif kind == "rglru":
        out, c = rglru.rglru_train(cfg, bp["mix"], h, return_state=True)
    elif kind == "mlstm":
        out, c = xlstm.mlstm_train(cfg, bp["mix"], h, return_state=True)
    else:
        out, c = xlstm.slstm_train(cfg, bp["mix"], h, return_state=True)
    x = x + out
    if cross_kv is not None:
        x = _cross_train(cfg, bp, x, positions, cross_kv)
    return _ffn(cfg, bp, x), c


@torch.no_grad()
def prefill(cfg, params, tokens: torch.Tensor, max_len: Optional[int] = None,
            extra: Optional[Dict[str, torch.Tensor]] = None):
    """Process the prompt; returns (last-token logits (B, V) f32, cache)."""
    extra = extra or {}
    b, s = tokens.shape
    max_len = max_len or s
    x, enc_out, enc_pos = _embed(cfg, params, tokens, extra)
    positions = _positions(b, s, tokens.device)
    caches, crosses = [], []
    for g in range(cfg.n_groups):
        gp = index_tree(params["groups"], g)
        group_cache, group_cross = {}, {}
        for j, kind in enumerate(cfg.block_pattern):
            nm = f"b{j}_{kind}"
            bp = gp[nm]
            cross_kv = None
            if enc_out is not None:
                cross_kv = _cross_kv(cfg, bp, enc_out, enc_pos)
                group_cross[nm] = dict(zip("kv", cross_kv[0]))
            x, group_cache[nm] = _mix_prefill(cfg, kind, bp, x, positions,
                                              max_len, cross_kv)
        caches.append(group_cache)
        crosses.append(group_cross)
    logits = _logits(cfg, params, x[:, -1:])[:, 0]
    cache: Params = {"groups": stack_trees(caches)}
    if cfg.is_encoder_decoder:
        cache["cross"] = stack_trees(crosses)
    return logits, cache


# ================================================================ decode
def _mix_decode(cfg, kind, bp, x, cache_one, position, cross_cache=None):
    h = apply_norm(cfg, bp["norm_mix"], x)
    window = cfg.window if kind in ("local_attn", "swa") else None
    if kind in _ATTN:
        if cfg.use_mla:
            out, c = attn.mla_decode(cfg, bp["mix"], h, cache_one, position)
        else:
            out, c = attn.gqa_decode(cfg, bp["mix"], h, cache_one, position,
                                     window=window)
    elif kind == "rglru":
        out, c = rglru.rglru_decode(cfg, bp["mix"], h, cache_one)
    elif kind == "mlstm":
        out, c = xlstm.mlstm_decode(cfg, bp["mix"], h, cache_one)
    else:
        out, c = xlstm.slstm_decode(cfg, bp["mix"], h, cache_one)
    x = x + out
    if cross_cache is not None:
        h = apply_norm(cfg, bp["norm_cross"], x)
        b, te = cross_cache["k"].shape[:2]
        hq, hd = cfg.n_heads, cfg.resolved_head_dim
        q = unflatten_last(matmul(h, bp["cross"]["wq"]), (hq, hd))
        q_pos = torch.full((b, 1), te, dtype=torch.long, device=x.device)
        o = attn.flash_attention(q, cross_cache["k"], cross_cache["v"],
                                 q_pos, _positions(b, te, x.device),
                                 causal=False)
        x = x + matmul(flatten_last(o), bp["cross"]["wo"])
    return _ffn(cfg, bp, x), c


def _local(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (whose storage a write lands in), else x."""
    return x.to_local() if is_dtensor(x) else x


@torch.no_grad()
def decode_step(cfg, params, cache: Params, tokens: torch.Tensor,
                positions: torch.Tensor):
    """One decode step.  tokens (B,) int; positions (B,) int.

    Returns (logits (B, V) f32, cache): the cache is updated in place (a
    caller keeps no older copy of it) and returned.
    """
    x = embed_tokens(cfg, params["embed"], tokens[:, None])
    if cfg.is_encoder_decoder:
        table = params["dec_pos"]["pos"].to(cfg.dtype)
        # each row's position on the rank that holds the row
        pos = per_rows(lambda t, p: t[torch.clamp(p, max=t.shape[0] - 1)],
                       positions, table, positions, summed=(0,))
        x = x + pos[:, None]
    for g in range(cfg.n_groups):
        gp = index_tree(params["groups"], g)
        for j, kind in enumerate(cfg.block_pattern):
            nm = f"b{j}_{kind}"
            stacked = cache["groups"][nm]
            cross = (index_tree(cache["cross"][nm], g)
                     if cfg.is_encoder_decoder else None)
            x, new = _mix_decode(cfg, kind, gp[nm], x,
                                 index_tree(stacked, g), positions, cross)
            for leaf, val in new.items():
                dst = stacked[leaf][g]
                if _local(val).data_ptr() != _local(dst).data_ptr():
                    # not written in place
                    if is_dtensor(dst):
                        val = val.redistribute(dst.device_mesh,
                                               dst.placements)
                    dst.copy_(val)
    return _logits(cfg, params, x)[:, 0], cache
