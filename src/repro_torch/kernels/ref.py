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


def era_scan_ref(alloc_eras: torch.Tensor, retire_eras: torch.Tensor,
                 reservations: torch.Tensor) -> torch.Tensor:
    """WFE cleanup() point-era scan (paper Fig. 4): lo == hi == era."""
    res = reservations.reshape(-1)  # (T*H,)
    return era_scan_interval_ref(alloc_eras, retire_eras, res, res)


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


# ----------------------------------- models of the CUDA variants' algebra
# The paged kernel's split-KV and tensor-core variants (csrc/
# paged_attention.cu) compute the same function as the plain version in
# another algebra.  These plain models repeat that algebra: the CPU tests
# hold it against the reference, and on the card the kernels are held
# against it (the split-KV walk near-bitwise in f32).
SPLIT_EMPTY_M = -1e30  # the running max's floor: a split past the bound


def _walk_bound(q_positions, num_live_blocks, bs, nblk):
    """Table slots each request walks: min(live, nblk, deepest causal
    block), 0 for a request with no query row at a position >= 0."""
    last = q_positions.long().max(dim=1).values
    live = (torch.full_like(last, nblk) if num_live_blocks is None
            else num_live_blocks.long())
    jend = torch.minimum(torch.clamp(live, 0, nblk),
                         torch.clamp(last, min=0) // bs + 1)
    return torch.where(last >= 0, jend, 0)


def _rows(q, q_positions):
    """q (B, C, KH, G, D) as f32 (B, KH, C*G, D) rows, position-major, and
    each row's position (B, C*G)."""
    b, c, kh, g, d = q.shape
    rows = q.float().permute(0, 2, 1, 3, 4).reshape(b, kh, c * g, d)
    pos = q_positions.long()[:, :, None].expand(b, c, g).reshape(b, c * g)
    return rows, pos


def split_kv_partials_ref(q, k_pool, v_pool, tables, q_positions,
                          num_live_blocks=None, *, pages_per_split: int,
                          n_splits: int, scale=None, k_scales=None,
                          v_scales=None):
    """The split-KV walk's partials: m, l (B, KH, C*G, n_splits) and acc
    (B, KH, C*G, n_splits, D), f32.  Split s covers table slots
    [s * pages_per_split, (s + 1) * pages_per_split), cut to the request's
    walk bound; within it a row's scores are (q . k) * scale over the keys
    at positions <= its own, m = max(-1e30, max s), P = exp(s - m), l = sum
    P and acc = P V.  A split past the bound gives (-1e30, 0, 0).  Int8
    pages are dequantized as they are read (code * scale)."""
    check_scales(k_pool, k_scales, v_scales)
    b, c, kh, g, d = q.shape
    bs = k_pool.shape[1]
    nblk = tables.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    jend = _walk_bound(q_positions, num_live_blocks, bs, nblk)
    rows, pos = _rows(q, q_positions)
    r = c * g
    dev = q.device
    m = torch.full((b, kh, r, n_splits), SPLIT_EMPTY_M, device=dev)
    l = torch.zeros((b, kh, r, n_splits), device=dev)
    acc = torch.zeros((b, kh, r, n_splits, d), device=dev)
    tables = tables.long()
    for s in range(n_splits):
        j0 = s * pages_per_split
        ids = tables[:, j0:j0 + pages_per_split]
        w = ids.shape[1]
        if w == 0:
            continue
        kvpos = j0 * bs + torch.arange(w * bs, device=dev)
        key_ok = kvpos[None, :] < (torch.clamp(jend, min=j0) * bs)[:, None]
        k = _gather_pages(k_pool, k_scales, ids).reshape(b, w * bs, kh, d)
        v = _gather_pages(v_pool, v_scales, ids).reshape(b, w * bs, kh, d)
        # a slot past the bound is never read: its page may hold NaN
        k = torch.where(key_ok[:, :, None, None], k, 0.0)
        v = torch.where(key_ok[:, :, None, None], v, 0.0)
        sc = torch.einsum("bkrd,bskd->bkrs", rows, k) * scale
        vis = key_ok[:, None, :] & (kvpos[None, None, :] <= pos[:, :, None])
        sc = torch.where(vis[:, None], sc, -math.inf)
        ms = torch.clamp(sc.amax(dim=-1), min=SPLIT_EMPTY_M)
        p = torch.exp(sc - ms[..., None])
        m[..., s] = ms
        l[..., s] = p.sum(dim=-1)
        acc[..., s, :] = torch.einsum("bkrs,bskd->bkrd", p, v)
    return m, l, acc


def combine_splits_ref(m, l, acc):
    """Merge each row's splits in split order, one at a time (the combine
    kernel's fold): M = max m, out = sum acc_s e^(m_s - M) / max(sum l_s
    e^(m_s - M), 1e-30).  A split of (-1e30, 0, 0) adds exact zeros.
    Returns (B, KH, R, D) f32."""
    mx = m.amax(dim=-1, keepdim=True)
    w = torch.exp(m - mx)
    tot = torch.zeros(m.shape[:-1], device=m.device)
    out = torch.zeros(acc.shape[:-2] + acc.shape[-1:], device=m.device)
    for s in range(m.shape[-1]):
        tot = tot + l[..., s] * w[..., s]
        out = out + acc[..., s, :] * w[..., s, None]
    return out / torch.clamp(tot, min=1e-30)[..., None]


def paged_attention_split_ref(q, k_pool, v_pool, tables, q_positions,
                              num_live_blocks=None, *, pages_per_split: int,
                              n_splits: int, scale=None, k_scales=None,
                              v_scales=None):
    """The split-KV walk and its combine: (B, C, KH, G, D) in q's dtype."""
    b, c, kh, g, d = q.shape
    m, l, acc = split_kv_partials_ref(
        q, k_pool, v_pool, tables, q_positions, num_live_blocks,
        pages_per_split=pages_per_split, n_splits=n_splits, scale=scale,
        k_scales=k_scales, v_scales=v_scales)
    out = combine_splits_ref(m, l, acc).reshape(b, kh, c, g, d)
    return out.permute(0, 2, 1, 3, 4).to(q.dtype).contiguous()


def paged_attention_tile_ref(q, k_pool, v_pool, tables, q_positions,
                             num_live_blocks=None, *, scale=None,
                             k_scales=None, v_scales=None):
    """The tensor-core tile's algebra over bf16 or int8 pages: q and the
    pages go into the product as bf16 (int8 codes exactly, undequantized);
    the k scale of a key's slot multiplies that key's column of S; P =
    exp(S - m) and l = sum P stay f32; the v scale multiplies P's column,
    and P is rounded to bf16 before P V.  Returns (B, C, KH, G, D) in q's
    dtype."""
    check_scales(k_pool, k_scales, v_scales)
    b, c, kh, g, d = q.shape
    bs = k_pool.shape[1]
    nblk = tables.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    jend = _walk_bound(q_positions, num_live_blocks, bs, nblk)
    w = int(jend.max()) if b else 0
    if w == 0:
        return torch.zeros_like(q)
    rows, pos = _rows(q.to(torch.bfloat16), q_positions)
    ids = tables.long()[:, :w]
    kvpos = torch.arange(w * bs, device=q.device)
    key_ok = kvpos[None, :] < (jend * bs)[:, None]                # (B, S)

    def pages(pool):
        x = pool[ids].to(torch.bfloat16).float()      # codes are exact
        return torch.where(key_ok[:, :, None, None],
                           x.reshape(b, w * bs, kh, d), 0.0)

    def col_scales(scales):                           # (B, KH, 1, S)
        if scales is None:
            return torch.ones((b, kh, 1, w * bs), device=q.device)
        sc = scales.float()[ids].repeat_interleave(bs, dim=1)   # (B, S, KH)
        sc = torch.where(key_ok[:, :, None], sc, 0.0)
        return sc.permute(0, 2, 1)[:, :, None, :]

    s = torch.einsum("bkrd,bskd->bkrs", rows, pages(k_pool))
    s = s * (col_scales(k_scales) * scale)
    vis = key_ok[:, None, :] & (kvpos[None, None, :] <= pos[:, :, None])
    s = torch.where(vis[:, None], s, -math.inf)
    mx = torch.clamp(s.amax(dim=-1, keepdim=True), min=SPLIT_EMPTY_M)
    p = torch.exp(s - mx)
    l = p.sum(dim=-1, keepdim=True)
    pv = (p * col_scales(v_scales)).to(torch.bfloat16).float()
    o = torch.einsum("bkrs,bskd->bkrd", pv, pages(v_pool))
    o = (o / torch.clamp(l, min=1e-30)).reshape(b, kh, c, g, d)
    return o.permute(0, 2, 1, 3, 4).to(q.dtype).contiguous()


# ------------------------------------------- the f32 tile's order (both kernels)
NEG_INF = -1e30
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453


#: keys a K/V tile of the f32 tile walks, at every D (``kKeys`` of
#: ``csrc/attention_f32.cuh``)
F32_TILE_KEYS = 32


def _f32_tile_walk(rows, k, v, pos, kend, scale):
    """The f32 tile's order of operations.  rows (B, KH, R, D) f32; k, v
    (B, KH, S, D) f32, zero at and past each request's ``kend`` (B,); pos
    (B, R) each row's position (keys <= pos are seen; -1 sees none).  Keys
    go in tiles of ``F32_TILE_KEYS``: S = (rows K^T) * (scale * log2 e)
    in f32, masked by select, the row max over the tile, corr = 2^(m_old -
    m_new) applied once to l and O, P = 2^(S - m_new), l += sum P, O += P V.
    Returns out = O * (1 / max(l, 1e-30)) (B, KH, R, D) and the
    log-sum-exp (m + log2 l) ln 2 (B, KH, R), both f32."""
    b, kh, r, d = rows.shape
    dev = rows.device
    sl = (torch.tensor(scale, dtype=torch.float32)
          * torch.tensor(LOG2E, dtype=torch.float32)).to(dev)
    m = torch.full((b, kh, r), NEG_INF, device=dev)
    l = torch.zeros((b, kh, r), device=dev)
    o = torch.zeros((b, kh, r, d), device=dev)
    keys = F32_TILE_KEYS
    for k0 in range(0, k.shape[2], keys):
        kt, vt = k[:, :, k0:k0 + keys], v[:, :, k0:k0 + keys]
        kp = torch.arange(k0, k0 + kt.shape[2], device=dev)
        vis = ((kp[None, None, :] <= pos[:, :, None])
               & (kp[None, None, :] < kend[:, None, None]))       # (B, R, n)
        s = torch.where(vis[:, None], torch.matmul(rows, kt.transpose(2, 3))
                        * sl, -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        l = l * corr + p.sum(dim=-1)
        o = o * corr[..., None] + torch.matmul(p, vt)
        m = m_new
    lc = torch.clamp(l, min=1e-30)
    return o * (1.0 / lc)[..., None], (m + torch.log2(lc)) * LN2


def paged_attention_f32_tile_ref(q, k_pool, v_pool, tables, q_positions,
                                 num_live_blocks=None, *, scale=None,
                                 k_scales=None, v_scales=None):
    """The f32 tile's algebra over paged K/V (the ``cuda_core`` variant of
    ``csrc/paged_attention.cu``): q and every pool type read as f32, int8
    pages as ``code * scale`` in f32 (``quant.dequantize_pool``'s
    rounding), and the tiles of :func:`_f32_tile_walk` over each request's
    keys [0, min(live * bs, last position + 1)); keys past that bound are
    never read.  Returns (B, C, KH, G, D) in q's dtype."""
    check_scales(k_pool, k_scales, v_scales)
    b, c, kh, g, d = q.shape
    bs = k_pool.shape[1]
    nblk = tables.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    last = q_positions.long().max(dim=1).values
    live = (torch.full_like(last, nblk) if num_live_blocks is None
            else torch.clamp(num_live_blocks.long(), 0, nblk))
    kend = torch.where(last >= 0, torch.minimum(live * bs, last + 1), 0)
    w = -(-int(kend.max()) // bs) if b else 0
    if w == 0:
        return torch.zeros_like(q)
    ids = tables.long()[:, :w]
    key_ok = (torch.arange(w * bs, device=q.device)[None, :]
              < kend[:, None])                                   # (B, S)

    def pages(pool, scales):
        x = _gather_pages(pool, scales, ids).reshape(b, w * bs, kh, d)
        return torch.where(key_ok[:, :, None, None], x, 0.0).transpose(1, 2)

    rows, pos = _rows(q, q_positions)
    out, _ = _f32_tile_walk(rows, pages(k_pool, k_scales),
                            pages(v_pool, v_scales), pos, kend, scale)
    out = out.reshape(b, kh, c, g, d).permute(0, 2, 1, 3, 4)
    return out.to(q.dtype).contiguous()


def flash_attention_f32_tile_ref(q, k, v, *, causal: bool = True,
                                 with_lse: bool = False):
    """The f32 tile's algebra over dense K/V (the ``cuda_core`` variant of
    ``csrc/flash_attention.cu``): q (B, T, H, D), k/v (B, T, KH, D) read as
    f32, rows (position, group) pairs at position t (T - 1 when not
    causal), the tiles of :func:`_f32_tile_walk`.  Returns (B, T, H, D) in
    q's dtype, and with ``with_lse`` also the f32 (B, H, T) log-sum-exp."""
    b, t, h, d = q.shape
    kh = k.shape[2]
    g = h // kh
    rows = q.float().reshape(b, t, kh, g, d).permute(0, 2, 1, 3, 4).reshape(
        b, kh, t * g, d)
    pos = (torch.arange(t, device=q.device).repeat_interleave(g) if causal
           else torch.full((t * g,), t - 1, device=q.device))
    out, lse = _f32_tile_walk(rows, k.float().transpose(1, 2),
                              v.float().transpose(1, 2),
                              pos[None].expand(b, t * g),
                              torch.full((b,), t, device=q.device), 1.0
                              / math.sqrt(d))
    out = out.reshape(b, kh, t, g, d).permute(0, 2, 1, 3, 4).reshape(
        b, t, h, d).to(q.dtype)
    if not with_lse:
        return out
    return out, lse.reshape(b, kh, t, g).transpose(2, 3).reshape(b, h, t)


# ------------------------------------------------------------ flash attention


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


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            dout: torch.Tensor, *, causal: bool = True):
    """dQ, dK, dV of :func:`flash_attention_ref` at ``dout``: autograd
    through the plain forward (f32 inside, the output rounded to q's
    dtype), the gradients in the inputs' dtypes.  The plain version of
    ``csrc/flash_attention_bwd.cu``; the reference trains through autodiff
    of its jnp attention the same way (``repro/models/attention.py:70``)."""
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        out = flash_attention_ref(*leaves, causal=causal)
        return torch.autograd.grad(out, leaves, dout)


def f32_bwd_tile_rows(d: int) -> int:
    """Rows a streamed tile of the f32 backward holds at head dim ``d``:
    keys in dQ, queries in dK/dV (``F32Bwd::kKeys`` of
    ``csrc/flash_attention_bwd.cu``: 32, or 16 where ``d`` pads to 128 or
    256)."""
    return 32 if d <= 80 else 16


def flash_attention_bwd_f32_tile_ref(q, k, v, dout, *, causal: bool = True,
                                     out=None, lse=None, fault=None):
    """The f32 backward tile's order of operations (the ``cuda_core``
    variant of ``csrc/flash_attention_bwd.cu``), for tests.  q and dout
    (B, T, H, D), k and v (B, T, KH, D) read as f32; ``out`` and the f32
    (B, H, T) ``lse`` are the forward's (default: the f32 tile's, from
    :func:`flash_attention_f32_tile_ref`).  Delta = rowsum(dO * out).
    Scores in log2 units: P = 2^(S * (scale * log2 e) - lse * log2 e),
    masked by select; dS = P (dP - Delta).  dQ walks tiles of
    :func:`f32_bwd_tile_rows` keys and sums dS K in tile order; dK and dV
    walk each kv head's query heads in order and, for each, tiles of as
    many queries, summing P^T dO and dS^T Q; dQ and dK are scaled at the
    end.  ``fault`` plants one for tests: ``"dkdv unmasked"`` (the causal
    mask dropped in dK and dV) or ``"tail tile skipped"`` (each walk stops
    at its last whole tile).  Returns (dq, dk, dv) in q's dtype."""
    b, t, h, d = q.shape
    kh = k.shape[2]
    g = h // kh
    scale = 1.0 / math.sqrt(d)
    if out is None or lse is None:
        out, lse = flash_attention_f32_tile_ref(q, k, v, causal=causal,
                                                with_lse=True)
    log2e = torch.tensor(LOG2E, dtype=torch.float32)
    sl = torch.tensor(scale, dtype=torch.float32) * log2e
    qh, doh = (x.float().transpose(1, 2) for x in (q, dout))   # (B, H, T, D)
    kf, vf = (x.float().transpose(1, 2) for x in (k, v))       # (B, KH, T, D)
    lse2 = lse.float() * log2e                                  # (B, H, T)
    delta = (doh * out.float().transpose(1, 2)).sum(-1)         # (B, H, T)
    pos = torch.arange(t, device=q.device)
    rows = f32_bwd_tile_rows(d)
    stop = t // rows * rows if fault == "tail tile skipped" else t

    def p_ds(qx, dox, kx, vx, l2, dl, qp, kp, masked):
        """P and dS of queries qp against keys kp (rows: queries)."""
        p = torch.exp2(torch.matmul(qx, kx.transpose(-1, -2)) * sl
                       - l2[..., None])
        if masked:
            p = torch.where(kp[None, :] <= qp[:, None], p, 0.0)
        dp = torch.matmul(dox, vx.transpose(-1, -2))
        return p, p * (dp - dl[..., None])

    # dQ: key tiles in order, every query head at once
    kx, vx = (x.repeat_interleave(g, 1) for x in (kf, vf))     # (B, H, T, D)
    dq = torch.zeros_like(qh)
    for k0 in range(0, stop, rows):
        k1 = min(k0 + rows, t)
        _, ds = p_ds(qh, doh, kx[:, :, k0:k1], vx[:, :, k0:k1], lse2, delta,
                     pos, pos[k0:k1], causal)
        dq = dq + torch.matmul(ds, kx[:, :, k0:k1])
    # dK, dV: query head g of every kv head, then its query tiles, in order
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for gi in range(g):
        sel = slice(gi, h, g)                 # heads kh * G + gi
        for q0 in range(0, stop, rows):
            q1 = min(q0 + rows, t)
            qt, dot = qh[:, sel, q0:q1], doh[:, sel, q0:q1]
            p, ds = p_ds(qt, dot, kf, vf, lse2[:, sel, q0:q1],
                         delta[:, sel, q0:q1], pos[q0:q1], pos,
                         causal and fault != "dkdv unmasked")
            dv = dv + torch.matmul(p.transpose(-1, -2), dot)
            dk = dk + torch.matmul(ds.transpose(-1, -2), qt)
    return tuple(x.transpose(1, 2).to(q.dtype).contiguous()
                 for x in (dq * scale, dk * scale, dv))
