"""Decode, prefill and mixed steps that read and write the PAGED KV pool.

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

Pools hold f32, fp16, bf16 or int8 pages (``KV_DTYPES``); int8 pages carry
per-(block, kv-head) scales written by ``kernels.quant.scatter_quantized``.

Supported stacks: full attention ("attn") without MLA or an encoder, with
dense or MoE FFNs (``_check_paged_support``, as the reference's).  MLA
stacks page their 576-wide latents instead of K/V through
``init_mla_pools`` and ``paged_mla_decode_step`` (plain PyTorch, as the
reference's jnp: the latent row is wider than the attention kernels'
head dims).
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch import resolve_device
from repro_torch.kernels import paged_chunk_attention, paged_decode_attention
from repro_torch.kernels.quant import scatter_quantized
from repro_torch.models.attention import _mla_qkv, _qkv, mla_latent_attention
from repro_torch.models.layers import (apply_norm, embed_tokens, index_tree,
                                       matmul, unembed)
from repro_torch.models.transformer import _ffn

Params = Dict[str, Any]

#: ``kv_dtype=`` strings -> pool storage dtype (None = follow cfg.dtype)
KV_DTYPES = {"fp32": torch.float32, "fp16": torch.float16,
             "bf16": torch.bfloat16, "int8": torch.int8}


def init_pools(cfg, n_blocks: int, block_size: int, kv_dtype=None,
               device=None) -> Dict[str, torch.Tensor]:
    """One K and one V pool for all layers: (L, N, bs, KH, D) on ``device``
    (default CUDA), in ``KV_DTYPES[kv_dtype]`` (None follows
    ``cfg.dtype``).  ``"int8"`` adds ``k_scale``/``v_scale`` (L, N, KH) f32.

    A scale row ``[l, n]`` belongs to pool block ``n`` as its page does,
    and is read only through the protected table snapshot that names the
    page, so WFE's era safety covers it and the blocks layer never touches
    it.  A recycled block keeps its last scale: that can only start the
    running absmax higher (a coarser code, never a wrong one).
    """
    kh, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    if kv_dtype is not None and kv_dtype not in KV_DTYPES:
        raise ValueError(f"kv_dtype={kv_dtype!r}: expected one of "
                         f"{sorted(KV_DTYPES)} or None")
    dtype = cfg.dtype if kv_dtype is None else KV_DTYPES[kv_dtype]
    dev = resolve_device(device)
    n_layers = cfg.n_groups * len(cfg.block_pattern)
    shape = (n_layers, n_blocks, block_size, kh, hd)
    pools = {"k": torch.zeros(shape, dtype=dtype, device=dev),
             "v": torch.zeros(shape, dtype=dtype, device=dev)}
    if dtype == torch.int8:
        sshape = (n_layers, n_blocks, kh)
        pools["k_scale"] = torch.zeros(sshape, dtype=torch.float32, device=dev)
        pools["v_scale"] = torch.zeros(sshape, dtype=torch.float32, device=dev)
    return pools


def _write_kv(pools, l, blk, off, k_rows, v_rows, dest=None):
    """Write layer ``l``'s new K/V rows (M, KH, D) at (blk, off) in place
    and return that layer's (k_pool, v_pool, k_scales, v_scales) views; the
    scales are None for float pools.  Int8 pools quantize the rows under
    their blocks' running absmax (``dest``: see ``scatter_quantized``)."""
    k_pool, v_pool = pools["k"][l], pools["v"][l]
    if "k_scale" not in pools:
        k_pool[blk, off] = k_rows.to(k_pool.dtype)
        v_pool[blk, off] = v_rows.to(v_pool.dtype)
        return k_pool, v_pool, None, None
    k_sc, v_sc = pools["k_scale"][l], pools["v_scale"][l]
    scatter_quantized(k_pool, k_sc, blk, off, k_rows, dest)
    scatter_quantized(v_pool, v_sc, blk, off, v_rows, dest)
    return k_pool, v_pool, k_sc, v_sc


def _check_paged_support(cfg):
    """The reference's (paged_model.py:81-86): full-attention GQA only.
    Windowed archs would need window masking in the paged gather, MLA pages
    latents instead of K/V (``paged_mla_decode_step``), and an encoder's
    cross-attention has no paged cache; MoE FFNs are served."""
    if cfg.use_mla or cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"{cfg.name}: the paged steps serve GQA decoders; MLA decodes "
            "through init_mla_pools/paged_mla_decode_step, and "
            "encoder-decoder stacks are not served")
    if any(k != "attn" for k in cfg.block_pattern):
        raise ValueError(f"{cfg.name}: paged serving needs full attention, "
                         f"got {cfg.block_pattern}")


def _layers(cfg, params):
    """(layer index, that layer's params) in stack order: layer l is
    (group l // n_pat, pattern entry l % n_pat)."""
    n_pat = len(cfg.block_pattern)
    for l in range(cfg.n_groups * n_pat):
        g_i, j = divmod(l, n_pat)
        kind = cfg.block_pattern[j]
        yield l, index_tree(params["groups"][f"b{j}_{kind}"], g_i)


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
    # values, so index_put_'s unordered duplicate writes are harmless.  In
    # int8 mode they also grow the scratch slot's scale; the block pool
    # never hands that slot out, so no request reads it.  The B destination
    # blocks are re-coded as they are (``dest=blk_of_tok``): a duplicate
    # re-codes to the same bytes, and no torch.unique syncs with the host
    blk_of_tok = tables[rows, (positions // bs).long()].long()
    off = (positions % bs).long()
    # per-request LIVE table slots: the decode token's own block is the
    # last one holding context (the kernel walks no further)
    num_live = (positions // bs + 1).to(torch.int32)
    for l, bp in _layers(cfg, params):
        hn = apply_norm(cfg, bp["norm_mix"], x)
        q, k1, v1 = _qkv(cfg, bp["mix"], hn, positions[:, None])
        k_pool, v_pool, k_sc, v_sc = _write_kv(
            pools, l, blk_of_tok, off, k1[:, 0], v1[:, 0], dest=blk_of_tok)
        qg = q.reshape(b, kh, g, hd).contiguous()
        out = paged_decode_attention(qg, k_pool, v_pool, tables, lengths,
                                     num_live, k_sc, v_sc,
                                     scale=1.0 / math.sqrt(hd))
        out = out.reshape(b, 1, h * hd).to(x.dtype)
        x = x + matmul(out, bp["mix"]["wo"])
        x = _ffn(cfg, bp, x)
    x = apply_norm(cfg, params["final_norm"], x)
    head = params["embed"] if cfg.tie_embeddings else params["head"]
    logits = unembed(cfg, head, x)[:, 0]
    return logits, pools


def paged_prefill_chunk(cfg, params, pools, tables, tokens, positions,
                        chunk_lens=None, write_rows=None, write_cols=None,
                        write_blocks=None, dest_blocks=None):
    """Run a C-token prompt CHUNK against already-materialized pages.

    The chunk's K/V rows scatter into the pool blocks the table names
    first, then every chunk query attends over the table's prior context
    plus the chunk's own earlier tokens through one causal-by-position
    paged attention.

    tables (B, nblk) i32; tokens/positions (B, C) i32 (absolute positions);
    chunk_lens (B,) i32 — valid tokens per row (None = all C; padded
    columns' outputs are never read).
    The K/V writes: ``write_rows``/``write_cols`` (M,) name the (row,
    column) of each token whose K/V the step writes, ``write_blocks`` (M,)
    the pool block it goes to (at offset position % bs), and for int8
    pools ``dest_blocks`` the blocks to re-code, which must hold every
    value of ``write_blocks`` (duplicates re-code a block twice to the same
    bytes).  The engine passes them from the host, so the step makes no
    host sync and, padded, has one shape per step signature: every
    (row, column) of the chunk, padded ones routed to a scratch block no
    request reads (the reference's ``mode="drop"``), and ``dest_blocks``
    padded with that block.  Left None, they are derived here for the
    valid tokens only (the reference drops padded columns with an
    out-of-range sentinel, which torch turns into a device-side assert),
    at the cost of a host sync each (``nonzero``, ``unique``).
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
    # destination of each written chunk token, shared by every layer
    if write_rows is None:
        valid = torch.arange(c, device=dev)[None, :] < chunk_lens[:, None]
        vb, vc = valid.nonzero(as_tuple=True)
    else:
        vb, vc = write_rows.long(), write_cols.long()
    vpos = positions[vb, vc]
    blk = (tables[vb, torch.clamp(vpos // bs, max=nblk - 1).long()].long()
           if write_blocks is None else write_blocks.long())
    off = (vpos % bs).long()
    # int8 pools re-code each destination block once; the blocks are the
    # same for every layer, so one set serves
    dest = None
    if "k_scale" in pools:
        dest = (torch.unique(blk) if dest_blocks is None
                else dest_blocks.long())
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
        k_pool, v_pool, k_sc, v_sc = _write_kv(
            pools, l, blk, off, k1[vb, vc], v1[vb, vc], dest=dest)
        qg = q.reshape(b, c, kh, g, hd).contiguous()
        out = paged_chunk_attention(qg, k_pool, v_pool, tables, positions,
                                    num_live, k_sc, v_sc,
                                    scale=1.0 / math.sqrt(hd))
        out = out.reshape(b, c, h * hd).to(x.dtype)
        x = x + matmul(out, bp["mix"]["wo"])
        x = _ffn(cfg, bp, x)
    # unembed ONLY each row's last valid token
    last = x[rows, (chunk_lens - 1).long()][:, None]  # (B, 1, d)
    last = apply_norm(cfg, params["final_norm"], last)
    head = params["embed"] if cfg.tie_embeddings else params["head"]
    logits = unembed(cfg, head, last)[:, 0]
    return logits, pools


def paged_mixed_step(cfg, params, pools, tables, tokens, positions,
                     out_slots, write_blocks=None, dest_blocks=None):
    """Decode tokens and one prompt chunk in one step on ONE token axis.

    The axis holds D decode slots, then the chunk's C columns: T = D + C
    tokens go through the embedding, every layer's norms, projections,
    rotary, K/V write and FFN once, and the attention runs in two calls on
    the same pools: the decode kernel over the D decode slots (as in
    ``paged_decode_step``) and the chunk kernel over the chunk as one
    (1, C) row (as in ``paged_prefill_chunk``).

    tables (D + 1, nblk) i32: row i < D is decode slot i's table, row D
    the chunk's.  tokens/positions (T,) i32: slot i < D is decode slot i's
    token at its absolute position (a pad slot: token 0 at position 0 over
    a table of the scratch slot); slots D.. are the chunk's tokens at
    their absolute positions, padded columns clamped to the chunk's last
    valid position.  out_slots (D + 1,) i32: the slot whose logits each
    output row takes; the chunk's last valid slot is its largest entry.
    The K/V writes: ``write_blocks`` (T,) the pool block each slot's K/V
    goes to (at offset position % bs), a padded column's to a scratch
    block no request reads, and for int8 pools ``dest_blocks`` the blocks
    to re-code, holding every value of ``write_blocks`` (see
    ``paged_prefill_chunk``).  Left None, they are derived here from the
    tables for the decode slots and the chunk's valid columns only, at
    the cost of a host sync each (``nonzero``, ``unique``).
    Returns (logits of the ``out_slots`` (D + 1, V) f32, pools) — the pools
    written in place.
    """
    _check_paged_support(cfg)
    t = tokens.shape[0]
    d = tables.shape[0] - 1
    dev = tokens.device
    bs = pools["k"].shape[2]
    kh, hd, h = cfg.n_kv_heads, cfg.resolved_head_dim, cfg.n_heads
    g = h // kh
    if write_blocks is None:
        slots = torch.arange(t, device=dev)
        row = torch.clamp(slots, max=d)
        col = torch.clamp(positions // bs, max=tables.shape[1] - 1).long()
        written = (slots <= out_slots.max()).nonzero(as_tuple=True)[0]
        blk = tables[row, col].long()[written]
    else:
        written = None
        blk = write_blocks.long()
    wpos = positions if written is None else positions[written]
    off = (wpos % bs).long()
    dest = None
    if "k_scale" in pools:
        dest = (torch.unique(blk) if dest_blocks is None
                else dest_blocks.long())
    # per-slot LIVE table slots: a decode token's own block, and the
    # chunk's last column's (its last valid position)
    dec_pos = positions[:d]
    dec_lengths = dec_pos + 1
    dec_live = (dec_pos // bs + 1).to(torch.int32)
    chunk_tables = tables[d:]
    chunk_pos = positions[d:][None]
    chunk_live = (positions[t - 1:] // bs + 1).to(torch.int32)
    scale = 1.0 / math.sqrt(hd)
    x = embed_tokens(cfg, params["embed"], tokens[None])
    for l, bp in _layers(cfg, params):
        hn = apply_norm(cfg, bp["norm_mix"], x)
        q, k1, v1 = _qkv(cfg, bp["mix"], hn, positions[None])
        k_rows, v_rows = k1[0], v1[0]
        if written is not None:
            k_rows, v_rows = k_rows[written], v_rows[written]
        k_pool, v_pool, k_sc, v_sc = _write_kv(pools, l, blk, off, k_rows,
                                               v_rows, dest=dest)
        qg = q.reshape(t, kh, g, hd)
        out_dec = paged_decode_attention(
            qg[:d].contiguous(), k_pool, v_pool, tables[:d], dec_lengths,
            dec_live, k_sc, v_sc, scale=scale)
        out_chunk = paged_chunk_attention(
            qg[None, d:].contiguous(), k_pool, v_pool, chunk_tables,
            chunk_pos, chunk_live, k_sc, v_sc, scale=scale)
        out = torch.cat([out_dec, out_chunk[0]]).reshape(1, t, h * hd)
        x = x + matmul(out.to(x.dtype), bp["mix"]["wo"])
        x = _ffn(cfg, bp, x)
    # unembed ONLY the decode slots and the chunk's last valid token
    last = x[0, out_slots.long()][:, None]  # (D + 1, 1, d)
    last = apply_norm(cfg, params["final_norm"], last)
    head = params["embed"] if cfg.tie_embeddings else params["head"]
    logits = unembed(cfg, head, last)[:, 0]
    return logits, pools


# ===================================================================== MLA
def init_mla_pools(cfg, n_blocks: int, block_size: int, kv_dtype=None,
                   device=None) -> Dict[str, torch.Tensor]:
    """Paged MLA latent pool on ``device`` (default CUDA): pages store
    (c_kv ‖ k_rope) rows, ``lat`` (L, N, bs, r + dr) — 576 values a token
    for deepseek-v2 instead of 2·KH·D; the same WFE block lifecycle applies.

    ``kv_dtype="int8"`` is refused, as in the reference: a latent row is
    the fused (c_kv ‖ k_rope) vector, whose halves have different ranges,
    so the dense pools' per-(block, kv-head) scales do not apply.
    """
    if kv_dtype == "int8":
        raise NotImplementedError(
            "kv_dtype='int8' is not supported for paged MLA: latent pages "
            "store fused (c_kv ‖ k_rope) rows whose two halves need "
            "separate scale ranges — the per-(block, kv-head) scheme of "
            "the dense pools does not map onto the latent cache")
    if kv_dtype is not None and kv_dtype not in KV_DTYPES:
        raise ValueError(f"kv_dtype={kv_dtype!r}: expected one of "
                         f"{sorted(KV_DTYPES)} or None")
    dtype = cfg.dtype if kv_dtype is None else KV_DTYPES[kv_dtype]
    width = cfg.kv_lora_rank + cfg.rope_head_dim
    shape = (cfg.n_groups * len(cfg.block_pattern), n_blocks, block_size,
             width)
    return {"lat": torch.zeros(shape, dtype=dtype,
                               device=resolve_device(device))}


def paged_mla_decode_step(cfg, params, pools, tables, lengths, tokens,
                          positions):
    """One decode token through the paged LATENT pool (absorbed-form MLA).

    As ``paged_decode_step`` for ``cfg.use_mla`` archs: each new token's
    latent row is written in place into the block its table names, then
    attention runs in the latent space over the gathered pages.
    tables (B, nblk) i32; lengths (B,) i32 (including the new token);
    tokens/positions (B,) i32.  Returns (logits (B, V) f32, pools).
    """
    if not cfg.use_mla:
        raise ValueError(f"{cfg.name}: paged_mla_decode_step needs an MLA "
                         "config")
    if pools["lat"].dtype == torch.int8:
        raise NotImplementedError(
            "paged_mla_decode_step has no int8 latent path — see "
            "init_mla_pools (fused (c_kv ‖ k_rope) rows need a split "
            "scale scheme)")
    b = tokens.shape[0]
    bs = pools["lat"].shape[2]
    r = cfg.kv_lora_rank
    nblk = tables.shape[1]
    x = embed_tokens(cfg, params["embed"], tokens[:, None])
    rows = torch.arange(b, device=tokens.device)
    blk_of_tok = tables[rows, (positions // bs).long()].long()
    off = (positions % bs).long()
    valid = (torch.arange(nblk * bs, device=tokens.device)[None, :]
             < lengths[:, None])
    for l, bp in _layers(cfg, params):
        hn = apply_norm(cfg, bp["norm_mix"], x)
        q_nope, q_rope, c_kv1, k_rope1 = _mla_qkv(cfg, bp["mix"], hn,
                                                  positions[:, None])
        lat = pools["lat"][l]
        lat[blk_of_tok, off] = torch.cat(
            [c_kv1[:, 0], k_rope1[:, 0, 0]], -1).to(lat.dtype)
        pages = lat[tables.long()].reshape(b, nblk * bs, -1)
        x = x + mla_latent_attention(cfg, bp["mix"], hn, q_nope, q_rope,
                                     pages[..., :r], pages[..., r:], valid)
        x = _ffn(cfg, bp, x)
    x = apply_norm(cfg, params["final_norm"], x)
    head = params["embed"] if cfg.tie_embeddings else params["head"]
    logits = unembed(cfg, head, x)[:, 0]
    return logits, pools
