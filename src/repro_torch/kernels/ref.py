"""Plain PyTorch versions of the package's CUDA kernels.

They are the semantic ground truth on the port's side: on a CPU tensor the
selectors in ``ops`` run them, and on the card ``chip_smoke.py`` holds each
kernel against them.  Each mirrors a function of ``repro.kernels.ref`` and
the TPU kernel's edge semantics where the two differ (an all-masked
attention row returns 0, as the kernel's ``max(l, 1e-30)`` guard gives).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

INF_ERA32 = 2**31 - 1


# ----------------------------------------------------------------- era_scan
def era_scan_interval_ref(alloc_eras: torch.Tensor, retire_eras: torch.Tensor,
                          res_lo: torch.Tensor, res_hi: torch.Tensor
                          ) -> torch.Tensor:
    """(R,), (R,), (S,), (S,) int32 -> (R,) bool deletable mask.

    Block i is deletable iff no slot s with ``lo[s] != INT32_MAX`` has
    ``lo[s] <= retire[i]`` and ``alloc[i] <= hi[s]``.
    """
    valid = res_lo != INF_ERA32
    conflict = ((res_lo[None, :] <= retire_eras[:, None])
                & (alloc_eras[:, None] <= res_hi[None, :])
                & valid[None, :])
    return ~conflict.any(dim=1)


# ------------------------------------------------------ paged chunk attention
def paged_attention_chunk_ref(
    q: torch.Tensor,            # (B, C, KH, G, D) a query chunk per request
    k_pool: torch.Tensor,       # (N, bs, KH, D) paged key pool
    v_pool: torch.Tensor,       # (N, bs, KH, D) paged value pool
    tables: torch.Tensor,       # (B, nblk) int32 block ids
    q_positions: torch.Tensor,  # (B, C) int32 absolute query positions
    num_live_blocks: Optional[torch.Tensor] = None,  # (B,) int32
    *,
    scale: Optional[float] = None,
    k_scales: Optional[torch.Tensor] = None,  # (N, KH) f32, int8 pools
    v_scales: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Each query row at absolute position p attends over the pool tokens
    its table names at positions <= p, within the first
    ``num_live_blocks[b]`` table slots (None = the exact bound derived from
    the highest query position).  Returns (B, C, KH, G, D) in q's dtype.
    Pools of any float type are read as f32; int8 pools need their scales
    (see ``paged_attention_chunk_int8_ref``).

    Only the table slots some row can see are gathered (the walk of the
    CUDA kernel), so slots past the bound are never read and a NaN there
    cannot reach the output; the bounded and the unbounded walk therefore
    run the same arithmetic and agree bitwise.
    """
    check_scales(k_pool, k_scales, v_scales)
    b, c, kh, g, d = q.shape
    _, bs, _, _ = k_pool.shape
    nblk = tables.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    tables = tables.long()
    qpos = q_positions.long()
    last = qpos.max(dim=1).values                      # (B,)
    live = (last // bs + 1 if num_live_blocks is None
            else num_live_blocks.long())
    # visible slots per request: live, cut to the deepest causal block
    vis = torch.minimum(torch.clamp(live, 0, nblk),
                        torch.clamp(last // bs + 1, min=0))
    w = int(vis.max()) if b else 0
    if w == 0:  # nothing visible anywhere: every row is all-masked
        return torch.zeros_like(q)
    kvpos = torch.arange(w * bs, device=q.device)
    slot_ok = kvpos[None, :] < (vis * bs)[:, None]     # (B, S)
    ids = tables[:, :w]
    k = _gather_pages(k_pool, k_scales, ids).reshape(b, w * bs, kh, d)
    v = _gather_pages(v_pool, v_scales, ids).reshape(b, w * bs, kh, d)
    # zero the unread slots: a dead page (or its scale) may hold anything,
    # NaN included
    k = torch.where(slot_ok[:, :, None, None], k, 0.0)
    v = torch.where(slot_ok[:, :, None, None], v, 0.0)
    s = torch.einsum("bckgd,bskd->bkgcs", q.float(), k) * scale
    mask = (kvpos[None, None, :] <= qpos[:, :, None]) & slot_ok[:, None, :]
    s = torch.where(mask[:, None, None], s, -math.inf)
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)         # all-masked rows
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgcs,bskd->bkgcd", p, v) / torch.clamp(l, min=1e-30)
    return o.permute(0, 3, 1, 2, 4).to(q.dtype).contiguous()


def paged_attention_ref(q, k_pool, v_pool, tables, lengths,
                        num_live_blocks=None, *, scale=None, k_scales=None,
                        v_scales=None):
    """Decode (C == 1) form: q (B, KH, G, D), lengths (B,) including the
    query token.  Returns (B, KH, G, D)."""
    q_positions = (lengths.long() - 1)[:, None].to(torch.int32)
    return paged_attention_chunk_ref(q[:, None], k_pool, v_pool, tables,
                                     q_positions, num_live_blocks,
                                     scale=scale, k_scales=k_scales,
                                     v_scales=v_scales)[:, 0]


def check_scales(k_pool: torch.Tensor, k_scales, v_scales) -> None:
    """The reference's operand rules for the int8 mode (its messages, so
    its tests' ``match=`` strings hold): scales come both or neither, and
    an int8 pool needs them.  The port also refuses scales beside a float
    pool, which its kernel has no variant for."""
    if (k_scales is None) != (v_scales is None):
        raise ValueError("k_scales and v_scales must be given together")
    if k_pool.dtype == torch.int8 and k_scales is None:
        raise ValueError("int8 pools need k_scales/v_scales "
                         "(init_pools(kv_dtype='int8') provides them)")
    if k_pool.dtype != torch.int8 and k_scales is not None:
        raise ValueError(f"k_scales/v_scales go with int8 pools, got "
                         f"{k_pool.dtype} pools")


def _gather_pages(pool, scales, ids):
    """pool[ids] as f32; an int8 page is dequantized as it is gathered,
    ``code.float() * scale`` (``quant.dequantize_pool``'s arithmetic, on
    the gathered pages only)."""
    pages = pool[ids].float()                      # (..., bs, KH, D)
    if scales is None:
        return pages
    return pages * scales.float()[ids][..., None, :, None]


# ------------------------------------------------- int8 paged chunk attention
def paged_attention_chunk_int8_ref(q, k_pool, v_pool, k_scales, v_scales,
                                   tables, q_positions, num_live_blocks=None,
                                   *, scale=None):
    """The fused-dequant kernel's plain version: int8 code pools
    (N, bs, KH, D) and their (N, KH) f32 scales, in the reference's
    argument order.  Equals ``paged_attention_chunk_ref`` on the
    ``dequantize_pool`` pools bitwise; only the gathered pages are
    dequantized, so the scale of a slot past the bound is never read."""
    return paged_attention_chunk_ref(q, k_pool, v_pool, tables, q_positions,
                                     num_live_blocks, scale=scale,
                                     k_scales=k_scales, v_scales=v_scales)


def paged_attention_int8_ref(q, k_pool, v_pool, k_scales, v_scales, tables,
                             lengths, num_live_blocks=None, *, scale=None):
    """Decode (C == 1) form of ``paged_attention_chunk_int8_ref``."""
    return paged_attention_ref(q, k_pool, v_pool, tables, lengths,
                               num_live_blocks, scale=scale,
                               k_scales=k_scales, v_scales=v_scales)


# ------------------------------------------------------------ flash attention
NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True) -> torch.Tensor:
    """Dense GQA forward attention, the semantics of the TPU kernel
    ``repro/kernels/flash_attention.py`` ``_flash_kernel`` (:33):
    q (B, T, H, D), k/v (B, T, KH, D) -> (B, T, H, D) in q's dtype, query
    head ``kh * G + g`` on kv head ``kh`` (G = H // KH).

    q, k and v are read as f32; scores are ``(q . k) * (1 / sqrt(D))``;
    causal keeps ``kpos <= qpos`` and gives masked scores -1e30; the
    output is ``sum_j exp(s_j - m) v_j / max(l, 1e-30)``.  The TPU kernel
    casts P to V's dtype before the PV product, and V is already f32
    there (:55), so P is not rounded.
    """
    b, t, h, d = q.shape
    kh = k.shape[2]
    g = h // kh
    qf = q.float().reshape(b, t, kh, g, d)
    s = torch.einsum("btkgd,bskd->bkgts", qf, k.float()) * (1.0 / math.sqrt(d))
    if causal:
        pos = torch.arange(t, device=q.device)
        s = torch.where(pos[None, :] <= pos[:, None], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgts,bskd->btkgd", p, v.float())
    o = o / torch.clamp(l, min=1e-30).permute(0, 3, 1, 2, 4)
    return o.reshape(b, t, h, d).to(q.dtype)
