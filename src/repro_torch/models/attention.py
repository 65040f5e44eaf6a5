"""Attention of ``repro.models.attention``: GQA (full / sliding-window /
local) and MLA, train, prefill and decode paths.

Every full-sequence attention goes through :func:`flash_attention`, which
keeps the reference's signature and picks one of two implementations from
call-site facts and shapes (:func:`flash_route`), never from a device
tensor's values (that would sync the host):

* ``kernel`` — the CUDA flash kernel (``kernels.flash_attention``) when the
  tensors are on CUDA, q and k have the same length and the caller built
  both position arrays as ``arange(T)`` (``arange_positions=True``: the
  reference's ``forward``, ``prefill`` and ``run_encoder`` calls), the
  window is None or at least T (so the reference's band and window masks
  are all true), Dv == D <= 256, the dtype is f32 or bf16 and the scale is
  1/sqrt(D).  There it computes exactly what the reference's chunked
  version computes.
* ``plain`` — the port of the reference's chunked online-softmax version
  (query and key chunks of 512, a key band for windowed layers) in every
  other case: MLA (D 192 for q and k, Dv 128), cross-attention (Tq != Tk),
  windowed layers past their window, decode, and everything on the CPU.

DTensor operands (under ``sharding.axes.axis_rules`` with a mesh) run
shard by shard (:func:`_flash_per_shard`): DTensor's ``local_map`` hands
each rank its local q, k and v, and :func:`flash_attention` picks the
route above from the local tensors (the kernel on the card, forward and
backward).  Attention is local to a batch row and to a kv head with its
query heads, so each mesh dim keeps q's batch sharding, or a head
sharding where k's kv heads shard on it too; q's heads otherwise take
k's layout (replicated), so a rank's query heads meet exactly the kv
heads they read.

``FLASH_ROUTES`` counts the calls of each route; a group that remat
recomputes in the backward calls again and counts again.  Where autograd
needs the gradient (training), the kernel route runs through
``kernels.flash_attention.FlashAttentionFn``, whose backward is the CUDA
backward kernel; the plain route is differentiated by autograd.  A kernel
error raises: nothing catches it and nothing falls back.

Decode is a single-token dot against the cache; MLA decode uses the
absorbed form (q multiplied into W_uk, attention in the 512-wide latent
space), so the cache stores latents.  Products run in f32 where the
reference asks for f32 accumulation (``preferred_element_type``): their
operands are read as f32, which is exact for bf16 values.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as flash_kernel
from repro_torch.sharding.axes import (flatten_last, is_dtensor,
                                       logical_constraint, per_shard,
                                       rewrap, unflatten_last)

from .layers import apply_rope, matmul
from .loops import counted_range

NEG_INF = -1e30

#: calls of each flash route: ``kernel`` (the CUDA kernel) and ``plain``
FLASH_ROUTES = {"kernel": build.Counter(), "plain": build.Counter()}


# ===================================================================== GQA
GQA_AXES = {
    "wq": ("embed", "qkv"),
    "wk": ("embed", "qkv"),
    "wv": ("embed", "qkv"),
    "wo": ("qkv", "embed"),
}


def _qkv(cfg, p, x, positions, rope=True):
    """x (B, T, d) -> q (B, T, H, hd), k and v (B, T, KH, hd)."""
    b, t, _ = x.shape
    h, kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = unflatten_last(matmul(x, p["wq"]), (h, hd))
    k = unflatten_last(matmul(x, p["wk"]), (kh, hd))
    v = unflatten_last(matmul(x, p["wv"]), (kh, hd))
    if rope and cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    q = logical_constraint(q, ("batch", "seq", "heads", "head_dim"))
    k = logical_constraint(k, ("batch", "seq", "kv_heads", "head_dim"))
    v = logical_constraint(v, ("batch", "seq", "kv_heads", "head_dim"))
    return q, k, v


def flash_route(device_type: str, dtype, q_shape, k_shape, v_shape, *,
                arange_positions: bool, window: Optional[int],
                scale: Optional[float] = None) -> str:
    """``"kernel"`` or ``"plain"`` for a :func:`flash_attention` call, from
    its device type, common dtype (None where q, k and v differ), shapes
    and call-site facts alone."""
    tq, d = q_shape[1], q_shape[3]
    tk, dv = k_shape[1], v_shape[3]
    kernel = (device_type == "cuda" and arange_positions and tq == tk
              and (window is None or window >= tq)
              and dv == d <= flash_kernel.MAX_HEAD_DIM
              and dtype in (torch.float32, torch.bfloat16)
              and (scale is None or scale == 1.0 / math.sqrt(d)))
    return "kernel" if kernel else "plain"


def flash_attention(
    q: torch.Tensor,  # (B, Tq, H, D)
    k: torch.Tensor,  # (B, Tk, KH, D)
    v: torch.Tensor,  # (B, Tk, KH, Dv)
    q_positions: torch.Tensor,  # (B, Tq) absolute positions
    kv_positions: torch.Tensor,  # (B, Tk)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_chunk: int = 512,
    kv_chunk: int = 512,
    scale: Optional[float] = None,
    arange_positions: bool = False,
) -> torch.Tensor:
    """Attention of ``repro.models.attention.flash_attention`` (:70), on the
    route :func:`flash_route` picks.  ``arange_positions``: the caller built
    ``q_positions`` and ``kv_positions`` both as ``arange(T)`` over the
    batch.  Returns (B, Tq, H, Dv) in q's dtype."""
    if is_dtensor(q):
        return _flash_per_shard(q, k, v, q_positions, kv_positions,
                                causal=causal, window=window,
                                q_chunk=q_chunk, kv_chunk=kv_chunk,
                                scale=scale, arange_positions=arange_positions)
    same = q.dtype if q.dtype == k.dtype == v.dtype else None
    route = flash_route(q.device.type, same, q.shape, k.shape, v.shape,
                        arange_positions=arange_positions, window=window,
                        scale=scale)
    FLASH_ROUTES[route].bump()
    if route == "kernel":
        return flash_kernel.flash_attention(q.contiguous(), k.contiguous(),
                                            v.contiguous(), causal=causal)
    return _flash_plain(q, k, v, q_positions, kv_positions, causal=causal,
                        window=window, q_chunk=q_chunk, kv_chunk=kv_chunk,
                        scale=scale)


def _flash_per_shard(q, k, v, q_positions, kv_positions, **kw):
    """:func:`flash_attention` of a DTensor q through ``local_map``: one
    local call per rank.  On each mesh dim q, k and v take ``Shard(0)``
    where q has it (batch rows are independent), ``Shard(2)`` where q and
    k both shard their heads on it and its size divides H and KH (each
    rank then holds whole GQA groups: local query head h reads local kv
    head h // G), else ``Replicate()``; the positions follow the batch
    sharding.  The result (B, Tq, H, Dv) has those placements.  Plain
    tensors among k, v and the positions count as replicated."""
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh

    def as_dtensor(x):
        return x if is_dtensor(x) else rewrap(x, mesh)

    k = as_dtensor(k)
    heads, rows = _per_shard_layout(q, k)
    local = local_map(functools.partial(flash_attention, **kw),
                      out_placements=(heads,),
                      in_placements=(heads, heads, heads, rows, rows),
                      device_mesh=mesh, redistribute_inputs=True)
    return local(q, k, as_dtensor(v), as_dtensor(q_positions),
                 as_dtensor(kv_positions))


def _per_shard_layout(q, k) -> tuple:
    """(placements of q, k and v, placements of per-row tensors) for
    attention run shard by shard (:func:`_flash_per_shard`)."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = q.device_mesh
    h, kh = q.shape[2], k.shape[2]
    heads, rows = [], []
    for i, (qp, kp) in enumerate(zip(q.placements, k.placements)):
        n = mesh.size(i)
        if qp == Shard(0):
            heads.append(Shard(0))
            rows.append(Shard(0))
        elif qp == kp == Shard(2) and h % n == 0 and kh % n == 0:
            heads.append(Shard(2))
            rows.append(Replicate())
        else:
            heads.append(Replicate())
            rows.append(Replicate())
    return tuple(heads), tuple(rows)


def _flash_plain(q, k, v, q_positions, kv_positions, *, causal, window,
                 q_chunk, kv_chunk, scale):
    """Chunked online-softmax attention (the reference's :70, with Python
    loops over query chunks and over key chunks or the key band)."""
    b, tq, h, d = q.shape
    _, tk, kh, dv = v.shape
    g = h // kh
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    dev = q.device

    q_chunk = min(q_chunk, tq)
    kv_chunk = min(kv_chunk, tk)
    nq = -(-tq // q_chunk)
    pad_q = nq * q_chunk - tq
    if pad_q:
        q = F.pad(q, (0, 0, 0, 0, 0, pad_q))
        q_positions = F.pad(q_positions, (0, pad_q), value=-1)
    nk = -(-tk // kv_chunk)
    pad_k = nk * kv_chunk - tk
    if pad_k:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_k))
        kv_positions = F.pad(kv_positions, (0, pad_k), value=2 ** 30)

    qc = q.reshape(b, nq, q_chunk, kh, g, d)
    qpos_c = q_positions.reshape(b, nq, q_chunk)
    kc = k.reshape(b, nk, kv_chunk, kh, d)
    vc = v.reshape(b, nk, kv_chunk, kh, dv)
    kpos_c = kv_positions.reshape(b, nk, kv_chunk)

    banded = window is not None and window < tk
    band_chunks = -(-window // kv_chunk) + 1 if banded else nk

    outs = []
    for i in counted_range(nq, q):
        qi = qc[:, i].float()  # (B, c, KV, G, D)
        qpos = qpos_c[:, i]
        m = torch.full((b, kh, g, q_chunk), NEG_INF, device=dev)
        l = torch.zeros((b, kh, g, q_chunk), device=dev)
        acc = torch.zeros((b, kh, g, q_chunk, dv), device=dev)
        if banded:
            # the band ends at the chunk of this q chunk's last visible key;
            # computed on the device (no sync).  Indices past the last chunk
            # clamp to it, as the reference's dynamic index does: a chunk
            # visited twice adds the same mass to l and acc and cancels.
            hi = torch.div(qpos.max(), kv_chunk, rounding_mode="floor")
            start = torch.clamp(hi - (band_chunks - 1), min=0)
            idxs = torch.clamp(start + torch.arange(band_chunks, device=dev),
                               max=nk - 1)
        for j in counted_range(band_chunks, q):
            if banded:
                sel = idxs[j:j + 1]
                kj = kc.index_select(1, sel)[:, 0]
                vj = vc.index_select(1, sel)[:, 0]
                kp = kpos_c.index_select(1, sel)[:, 0]
            else:
                kj, vj, kp = kc[:, j], vc[:, j], kpos_c[:, j]
            s = torch.einsum("bqkgd,bckd->bkgqc", qi, kj.float()) * scale
            dposq = qpos[:, None, None, :, None]
            dposk = kp[:, None, None, None, :]
            mask = dposq >= 0  # query padding
            if causal:
                mask = mask & (dposk <= dposq)
            if window is not None:
                mask = mask & (dposq - dposk < window)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqc,bckd->bkgqd", p.to(vj.dtype).float(), vj.float())
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]  # (B,KV,G,cq,Dv)
        outs.append(out.permute(0, 3, 1, 2, 4).to(q.dtype))
    outs += outs[-1:] * (nq - len(outs))  # two trips on meta tensors
    out = torch.stack(outs, dim=1).reshape(b, nq * q_chunk, h, dv)
    return out[:, :tq]


def gqa_train(cfg, p, x, positions, *, causal=True, window=None,
              kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              kv_positions: Optional[torch.Tensor] = None,
              arange_positions: bool = False):
    """Full-sequence attention (training / prefill / encoder / cross).
    Cross-attention (``kv_override``) always takes the plain route."""
    b, t, _ = x.shape
    h, hd = cfg.n_heads, cfg.resolved_head_dim
    if kv_override is None:
        q, k, v = _qkv(cfg, p, x, positions)
        kv_positions = positions
    else:  # cross-attention: q from x, k/v precomputed from the encoder
        q = unflatten_last(matmul(x, p["wq"]), (h, hd))
        k, v = kv_override
        arange_positions = False
    out = flash_attention(q, k, v, positions, kv_positions, causal=causal,
                          window=window or cfg.window,
                          arange_positions=arange_positions)
    out = matmul(flatten_last(out), p["wo"])
    return logical_constraint(out, ("batch", "seq", "embed"))


def _fill_cache(k: torch.Tensor, v: torch.Tensor, max_len: int,
                window: Optional[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Place freshly-computed K/V (B, S, KH, D) into a cache of ``max_len``
    slots (ring order when windowed)."""
    b, s = k.shape[:2]
    if window is not None and max_len <= window:
        # ring cache: keep the last max_len tokens at slot pos % max_len
        take = min(s, max_len)
        slots = torch.arange(s - take, s, device=k.device) % max_len
        kc = k.new_zeros((b, max_len) + k.shape[2:])
        vc = v.new_zeros((b, max_len) + v.shape[2:])
        kc[:, slots] = k[:, -take:]
        vc[:, slots] = v[:, -take:]
        return kc, vc
    pad = max_len - s
    assert pad >= 0, (s, max_len)
    tail = (0, 0) * (k.ndim - 2)
    return F.pad(k, tail + (0, pad)), F.pad(v, tail + (0, pad))


def gqa_prefill(cfg, p, x, positions, max_len: int, *, window=None,
                arange_positions: bool = False):
    """Full-sequence attention that also returns the populated KV cache."""
    b, t, _ = x.shape
    h, hd = cfg.n_heads, cfg.resolved_head_dim
    q, k, v = _qkv(cfg, p, x, positions)
    out = flash_attention(q, k, v, positions, positions, causal=True,
                          window=window, arange_positions=arange_positions)
    out = matmul(flatten_last(out), p["wo"])
    kc, vc = per_shard(functools.partial(_fill_cache, max_len=max_len,
                                         window=window), k, v)
    return (logical_constraint(out, ("batch", "seq", "embed")),
            {"k": kc, "v": vc})


# ------------------------------------------------------------- decode (GQA)
def init_kv_cache(cfg, batch: int, max_len: int, dtype=None, device=None):
    kh, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    dtype = dtype or cfg.dtype
    dev = resolve_device(device)
    return {"k": torch.zeros((batch, max_len, kh, hd), dtype=dtype, device=dev),
            "v": torch.zeros((batch, max_len, kh, hd), dtype=dtype, device=dev)}


KV_CACHE_AXES = {
    "k": ("batch", "seq", "kv_heads", "head_dim"),
    "v": ("batch", "seq", "kv_heads", "head_dim"),
}


def _write_token_local(cache, slot, row):
    """The indexed write of :func:`_write_token` into a DTensor cache, on
    each rank's shard: ``row`` takes the cache's layout of its batch and
    trailing dims and ``slot`` its batch layout, so every rank writes its
    own rows (the cache's slots dim must not be sharded)."""
    from torch.distributed.tensor import Replicate, Shard

    mesh, placements = cache.device_mesh, cache.placements
    if Shard(1) in placements:
        raise NotImplementedError("a decode cache sharded along its slots")
    row_pl = [Shard(p.dim - 1) if isinstance(p, Shard) and p.dim > 1 else p
              for p in placements]
    slot_pl = [p if p == Shard(0) else Replicate() for p in placements]
    row = (row if is_dtensor(row) else rewrap(row, mesh)).redistribute(
        mesh, row_pl).to_local()
    slot = (slot if is_dtensor(slot) else rewrap(slot, mesh)).redistribute(
        mesh, slot_pl).to_local()
    local = cache.to_local()
    rows = torch.arange(local.shape[0], device=local.device)
    local[rows, slot.long()] = row.to(local.dtype)
    return cache


def _write_token(cache: torch.Tensor, slot: torch.Tensor,
                 row: torch.Tensor) -> torch.Tensor:
    """Write each batch row's new entry ``row`` (B, ...) at ``slot`` (B,) of
    ``cache`` (B, S, ...).  With ``scatter_cache_update`` the write is in
    place and touches B rows; without it, the reference's one-hot blend
    builds a new cache."""
    from .perf_flags import FLAGS

    if FLAGS["scatter_cache_update"]:
        if is_dtensor(cache):
            return _write_token_local(cache, slot, row)
        rows = torch.arange(cache.shape[0], device=cache.device)
        cache[rows, slot.long()] = row.to(cache.dtype)
        return cache
    oh = F.one_hot(slot.long(), cache.shape[1]).to(cache.dtype)
    oh = oh.reshape(oh.shape + (1,) * (cache.ndim - 2))
    return cache * (1 - oh) + oh * row[:, None].to(cache.dtype)


def _decode_attend(q, k, v, valid):
    """One query token against the cache: q (B, 1, H, hd), k and v (B, S,
    KH, hd), valid (B, S) -> (B, 1, H, hd) in f32.  On DTensors
    :func:`gqa_decode` runs it shard by shard (``local_map``), as
    :func:`_flash_per_shard` runs the flash route."""
    b, _, h, hd = q.shape
    kh = k.shape[2]
    s = torch.einsum("bqkgd,bskd->bkgqs",
                     q.reshape(b, 1, kh, h // kh, hd).float(), k.float()
                     ) / math.sqrt(hd)
    s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", w.to(v.dtype).float(), v.float())
    return out.reshape(b, 1, h, hd)


def gqa_decode(cfg, p, x, cache, position, *, window=None):
    """One-token decode: x (B, 1, d); cache k/v (B, S, KH, D); position (B,).
    Returns (out, cache); see :func:`_write_token` for the cache update."""
    b = x.shape[0]
    h, hd = cfg.n_heads, cfg.resolved_head_dim
    q, k1, v1 = _qkv(cfg, p, x, position[:, None])
    max_len = cache["k"].shape[1]
    slot = position if window is None else position % window
    k = _write_token(cache["k"], slot, k1[:, 0])
    v = _write_token(cache["v"], slot, v1[:, 0])
    slots = torch.arange(max_len, device=x.device)[None, :]
    if window is not None:
        # Ring buffer (max_len == window): slot i holds the largest absolute
        # position p = i (mod window) with p <= current position.
        kv_pos = position[:, None] - torch.remainder(
            position[:, None] - slots, max_len)
        valid = kv_pos >= 0  # slots not yet written
    else:
        valid = slots <= position[:, None]
    if is_dtensor(q):
        from torch.distributed.tensor.experimental import local_map

        heads, rows = _per_shard_layout(q, k)
        attend = local_map(_decode_attend, out_placements=(heads,),
                           in_placements=(heads, heads, heads, rows),
                           device_mesh=q.device_mesh,
                           redistribute_inputs=True)
        valid = valid if is_dtensor(valid) else rewrap(valid, q.device_mesh)
    else:
        attend = _decode_attend
    out = attend(q, k, v, valid)
    out = out.reshape(b, 1, h * hd).to(x.dtype)
    out = matmul(out, p["wo"])
    return logical_constraint(out, ("batch", "seq", "embed")), {"k": k, "v": v}


# ===================================================================== MLA
MLA_AXES = {
    "wq_a": ("embed", "kv_lora"),
    "wq_b": ("kv_lora", "qkv"),
    "wkv_a": ("embed", "kv_lora"),
    "wk_b": ("kv_lora", "qkv"),
    "wv_b": ("kv_lora", "qkv"),
    "wo": ("qkv", "embed"),
    "norm_kv": ("kv_lora",),
    "norm_q": ("kv_lora",),
}


def _rms(x, scale):
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + 1e-6)
    return (y * (1.0 + scale.float())).to(x.dtype)


def _mla_qkv(cfg, p, x, positions):
    b, t, _ = x.shape
    h = cfg.n_heads
    dn, dr = cfg.nope_head_dim, cfg.rope_head_dim
    r = cfg.kv_lora_rank
    cq = _rms(matmul(x, p["wq_a"]), p["norm_q"])
    q = matmul(cq, p["wq_b"]).reshape(b, t, h, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    kv = matmul(x, p["wkv_a"])
    c_kv = _rms(kv[..., :r], p["norm_kv"])  # (B,T,r) — the cached latent
    k_rope = apply_rope(kv[..., r:].reshape(b, t, 1, dr), positions,
                        cfg.rope_theta)  # shared across heads
    return q_nope, q_rope, c_kv, k_rope


def _mla_attend(cfg, p, x, positions, causal, arange_positions):
    """Decompressed MLA: expand latents to per-head K/V and attend.
    Returns (out, c_kv, k_rope)."""
    b, t, _ = x.shape
    h = cfg.n_heads
    dn, dr, dvh = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(cfg, p, x, positions)
    k_nope = matmul(c_kv, p["wk_b"]).reshape(b, t, h, dn)
    v = matmul(c_kv, p["wv_b"]).reshape(b, t, h, dvh)
    q = torch.cat([q_nope, q_rope], -1)
    k = torch.cat([k_nope, k_rope.expand(b, t, h, dr)], -1)
    out = flash_attention(q, k, v, positions, positions, causal=causal,
                          scale=1.0 / math.sqrt(dn + dr),
                          arange_positions=arange_positions)
    return matmul(out.reshape(b, t, h * dvh), p["wo"]), c_kv, k_rope


def mla_train(cfg, p, x, positions, *, causal=True,
              arange_positions: bool = False):
    """Decompressed MLA over the full sequence."""
    out = _mla_attend(cfg, p, x, positions, causal, arange_positions)[0]
    return logical_constraint(out, ("batch", "seq", "embed"))


def mla_prefill(cfg, p, x, positions, max_len: int, *,
                arange_positions: bool = False):
    """Decompressed-attention prefill that returns the latent cache."""
    t = x.shape[1]
    out, c_kv, k_rope = _mla_attend(cfg, p, x, positions, True,
                                    arange_positions)
    pad = max_len - t
    c_kv, k_rope = per_shard(
        lambda c, r: (F.pad(c, (0, 0, 0, pad)), F.pad(r, (0, 0, 0, pad))),
        c_kv, k_rope[:, :, 0])
    cache = {"c_kv": c_kv, "k_rope": k_rope}
    return logical_constraint(out, ("batch", "seq", "embed")), cache


def init_mla_cache(cfg, batch: int, max_len: int, dtype=None, device=None):
    dtype = dtype or cfg.dtype
    dev = resolve_device(device)
    return {"c_kv": torch.zeros((batch, max_len, cfg.kv_lora_rank),
                                dtype=dtype, device=dev),
            "k_rope": torch.zeros((batch, max_len, cfg.rope_head_dim),
                                  dtype=dtype, device=dev)}


MLA_CACHE_AXES = {
    "c_kv": ("batch", "seq", "kv_lora"),
    "k_rope": ("batch", "seq", "head_dim"),
}


def mla_latent_attention(cfg, p, x, q_nope, q_rope, c_kv, k_rope, valid):
    """Absorbed-form attention over latents c_kv (B, S, r) and k_rope
    (B, S, dr) for one query token; ``valid`` (B, S) masks the keys.

    score(h, t) = (q_nope[h] @ W_uk[h])·c_kv[t] + q_rope[h]·k_rope[t]
    out(h)      = (Σ_t w[t]·c_kv[t]) @ W_uv[h]
    Returns the output projection (B, 1, d)."""
    b = x.shape[0]
    h = cfg.n_heads
    dn, dr, dvh = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    r = cfg.kv_lora_rank
    # absorb W_uk into q: (B,1,H,dn) @ (r, H*dn) -> (B,1,H,r)
    wk_b = p["wk_b"].to(x.dtype).reshape(r, h, dn)
    q_lat = torch.einsum("bqhd,rhd->bqhr", q_nope.float(),
                         wk_b.float()).to(x.dtype)
    s = (torch.einsum("bqhr,bsr->bhqs", q_lat.float(), c_kv.float())
         + torch.einsum("bqhd,bsd->bhqs", q_rope.float(), k_rope.float())
         ) / math.sqrt(dn + dr)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bhqs,bsr->bqhr", w.to(c_kv.dtype).float(),
                         c_kv.float()).to(x.dtype)
    wv_b = p["wv_b"].to(x.dtype).reshape(r, h, dvh)
    out = torch.einsum("bqhr,rhd->bqhd", o_lat.float(),
                       wv_b.float()).to(x.dtype)
    return matmul(out.reshape(b, 1, h * dvh), p["wo"])


def mla_decode(cfg, p, x, cache, position):
    """Absorbed-form decode: scores in the latent space, the cache stores
    latents, so per-token cache traffic is r + dr (576) instead of
    h·(dn+dvh).  Returns (out, cache); see :func:`_write_token`."""
    q_nope, q_rope, c_kv1, k_rope1 = _mla_qkv(cfg, p, x, position[:, None])
    c_kv = _write_token(cache["c_kv"], position, c_kv1[:, 0])
    k_rope = _write_token(cache["k_rope"], position, k_rope1[:, 0, 0])
    max_len = c_kv.shape[1]
    valid = torch.arange(max_len, device=x.device)[None, :] <= position[:, None]
    out = mla_latent_attention(cfg, p, x, q_nope, q_rope, c_kv, k_rope, valid)
    return (logical_constraint(out, ("batch", "seq", "embed")),
            {"c_kv": c_kv, "k_rope": k_rope})
