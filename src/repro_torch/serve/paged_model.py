"""Decode/prefill steps that read and write the PAGED KV pool.

The device side of the WFE adaptation, ported from
``repro.serve.paged_model``: the host scheduler names blocks via tables;
the step scatters each new token's K/V into the block its table names and
attends through the tables (the CUDA kernel on the card, the plain version
on the CPU — ``kernels.ops`` selects by device).

Unlike the reference's functional updates, the pools are written IN PLACE:
``pools["k"]`` is one (L, N, bs, KH, D) tensor and each layer reads and
writes its view ``pools["k"][l]``, so a step copies no page.  The caller
must therefore not let a page be reallocated while a step that reads it is
still queued on the device (see ``engine.ServeEngine.execute_plan``).

Supported stacks: dense attention ("attn") without MLA, fp pools.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch import resolve_device
from repro_torch.kernels import paged_chunk_attention, paged_decode_attention
from repro_torch.models.attention import _qkv
from repro_torch.models.layers import (apply_mlp, apply_norm, embed_tokens,
                                       matmul, unembed)

Params = Dict[str, Any]

def init_pools(cfg, n_blocks: int, block_size: int, kv_dtype=None,
               device=None) -> Dict[str, torch.Tensor]:
    """One K and one V pool for all layers: (L, N, bs, KH, D) in
    ``cfg.dtype`` on ``device`` (default CUDA).  The reference's
    ``kv_dtype`` overrides (int8 pages among them) are not ported yet: any
    value but None raises."""
    kh, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    if kv_dtype is not None:
        raise NotImplementedError(f"kv_dtype={kv_dtype!r} is not ported yet; "
                                  "pools follow cfg.dtype")
    dtype = cfg.dtype
    dev = resolve_device(device)
    n_layers = cfg.n_groups * len(cfg.block_pattern)
    shape = (n_layers, n_blocks, block_size, kh, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def _check_paged_support(cfg):
    # full-attention GQA only, as in the reference (paged_model.py:81-86)
    if cfg.use_mla or cfg.is_encoder_decoder or cfg.is_moe:
        raise NotImplementedError(f"{cfg.name}: paged serving of this "
                                  "architecture is not ported yet")
    if any(k != "attn" for k in cfg.block_pattern):
        raise ValueError(f"paged serving needs full attention, got "
                         f"{cfg.block_pattern}")


def _layers(cfg, params):
    """(layer index, that layer's params) in stack order: layer l is
    (group l // n_pat, pattern entry l % n_pat)."""
    n_pat = len(cfg.block_pattern)
    for l in range(cfg.n_groups * n_pat):
        g_i, j = divmod(l, n_pat)
        kind = cfg.block_pattern[j]
        grp = params["groups"][f"b{j}_{kind}"]
        yield l, {k: {n: t[g_i] for n, t in sub.items()}
                  for k, sub in grp.items()}


def _mlp_residual(cfg, bp, x):
    if cfg.d_ff > 0 and cfg.mlp_kind != "none":
        x = x + apply_mlp(cfg, bp["mlp"], apply_norm(cfg, bp["norm_mlp"], x))
    return x


def paged_decode_step(cfg, params, pools, tables, lengths, tokens, positions):
    """One token for a batch of requests against the paged pool.

    tables (B, nblk) i32; lengths (B,) i32 (INCLUDING the new token);
    tokens (B,) i32; positions (B,) i32 (= lengths - 1).
    Returns (logits (B, V) f32, pools) — the pools written in place.
    """
    _check_paged_support(cfg)
    b = tokens.shape[0]
    bs = pools["k"].shape[2]
    kh, hd, h = cfg.n_kv_heads, cfg.resolved_head_dim, cfg.n_heads
    g = h // kh
    x = embed_tokens(cfg, params["embed"], tokens[:, None])
    rows = torch.arange(b, device=tokens.device)
    # the pool block and in-block offset receiving this token's K/V.  Batch
    # pad rows all write token 0 at position 0 of the scratch slot: equal
    # values, so index_put_'s unordered duplicate writes are harmless
    blk_of_tok = tables[rows, (positions // bs).long()].long()
    off = (positions % bs).long()
    # per-request LIVE table slots: the decode token's own block is the
    # last one holding context (the kernel walks no further)
    num_live = (positions // bs + 1).to(torch.int32)
    for l, bp in _layers(cfg, params):
        hn = apply_norm(cfg, bp["norm_mix"], x)
        q, k1, v1 = _qkv(cfg, bp["mix"], hn, positions[:, None])
        k_pool, v_pool = pools["k"][l], pools["v"][l]
        k_pool[blk_of_tok, off] = k1[:, 0]
        v_pool[blk_of_tok, off] = v1[:, 0]
        qg = q.reshape(b, kh, g, hd).contiguous()
        out = paged_decode_attention(qg, k_pool, v_pool, tables, lengths,
                                     num_live, scale=1.0 / math.sqrt(hd))
        out = out.reshape(b, 1, h * hd).to(x.dtype)
        x = x + matmul(out, bp["mix"]["wo"])
        x = _mlp_residual(cfg, bp, x)
    x = apply_norm(cfg, params["final_norm"], x)
    head = params["embed"] if cfg.tie_embeddings else params["head"]
    logits = unembed(cfg, head, x)[:, 0]
    return logits, pools


def paged_prefill_chunk(cfg, params, pools, tables, tokens, positions,
                        chunk_lens=None):
    """Run a C-token prompt CHUNK against already-materialized pages.

    The chunk's K/V rows scatter into the pool blocks the table names
    first, then every chunk query attends over the table's prior context
    plus the chunk's own earlier tokens through one causal-by-position
    paged attention.

    tables (B, nblk) i32; tokens/positions (B, C) i32 (absolute positions);
    chunk_lens (B,) i32 — valid tokens per row (None = all C; padded
    columns scatter nothing and their outputs are never read).
    Returns (logits of each row's LAST VALID token (B, V) f32, pools) — the
    pools written in place.
    """
    _check_paged_support(cfg)
    b, c = tokens.shape
    dev = tokens.device
    bs = pools["k"].shape[2]
    nblk = tables.shape[1]
    kh, hd, h = cfg.n_kv_heads, cfg.resolved_head_dim, cfg.n_heads
    g = h // kh
    if chunk_lens is None:
        chunk_lens = torch.full((b,), c, dtype=torch.int32, device=dev)
    valid = torch.arange(c, device=dev)[None, :] < chunk_lens[:, None]
    # destination of each VALID chunk token.  The reference drops padded
    # columns with an out-of-range sentinel and mode="drop"; an index that
    # far out of range is a device-side assert in torch, so the padded
    # columns are left out of the scatter instead.  One nonzero() per step
    # (it syncs with the host), shared by every layer.
    vb, vc = valid.nonzero(as_tuple=True)
    vpos = positions[vb, vc]
    blk = tables[vb, torch.clamp(vpos // bs, max=nblk - 1).long()].long()
    off = (vpos % bs).long()
    # per-request LIVE table slots: the chunk's last valid token sits in the
    # deepest block any of its queries can see (padded columns clamp to the
    # row's last valid position, so they derive the same bound)
    rows = torch.arange(b, device=dev)
    last_pos = positions[rows, torch.clamp(chunk_lens - 1, min=0).long()]
    num_live = (last_pos // bs + 1).to(torch.int32)
    x = embed_tokens(cfg, params["embed"], tokens)
    for l, bp in _layers(cfg, params):
        hn = apply_norm(cfg, bp["norm_mix"], x)
        q, k1, v1 = _qkv(cfg, bp["mix"], hn, positions)
        # scatter the chunk's K/V into the pool FIRST, so the attention
        # below sees intra-chunk keys through the same tables
        k_pool, v_pool = pools["k"][l], pools["v"][l]
        k_pool[blk, off] = k1[vb, vc]
        v_pool[blk, off] = v1[vb, vc]
        qg = q.reshape(b, c, kh, g, hd).contiguous()
        out = paged_chunk_attention(qg, k_pool, v_pool, tables, positions,
                                    num_live, scale=1.0 / math.sqrt(hd))
        out = out.reshape(b, c, h * hd).to(x.dtype)
        x = x + matmul(out, bp["mix"]["wo"])
        x = _mlp_residual(cfg, bp, x)
    # unembed ONLY each row's last valid token
    last = x[rows, (chunk_lens - 1).long()][:, None]  # (B, 1, d)
    last = apply_norm(cfg, params["final_norm"], last)
    head = params["embed"] if cfg.tie_embeddings else params["head"]
    logits = unembed(cfg, head, last)[:, 0]
    return logits, pools
