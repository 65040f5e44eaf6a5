"""Paged chunk attention through WFE-managed block tables: the CUDA kernel.

Replaces the Pallas TPU kernel ``repro/kernels/paged_attention.py``
``paged_attention_chunk`` (:148) and its decode wrapper ``paged_attention``
(:227).  Query rows attend over K/V scattered across the pool blocks a
request's table names, causally by absolute position, walking only the
first ``num_live_blocks[b]`` table slots.  The kernel lives in
``csrc/paged_attention.cu`` (design and what bounds it on an H100 are in
its header); this module checks the operands and launches it on the
current CUDA stream.  Its plain PyTorch version is ``paged_attention_chunk_ref``.

The wrappers here take CUDA tensors only; ``ops`` selects between them
and the plain version by the tensor's device.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import build
from .ref import paged_attention_chunk_ref, paged_attention_ref

__all__ = ["paged_attention_chunk", "paged_attention",
           "paged_attention_chunk_ref", "paged_attention_ref", "LAUNCHES"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128
#: shared memory the kernel stages per block: one f32 (bs, D) K and V tile
MAX_TILE_BYTES = 48 * 1024


#: launches of the kernel (``LAUNCHES.n``), bumped once per launch
LAUNCHES = build.Counter()


def _check(name: str, t: torch.Tensor, ndim: int, dtype=None) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.ndim != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def paged_attention_chunk(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, tables: torch.Tensor,
                          q_positions: torch.Tensor,
                          num_live_blocks: Optional[torch.Tensor] = None, *,
                          scale: Optional[float] = None) -> torch.Tensor:
    """q (B,C,KH,G,D); pools (N,bs,KH,D) f32 or bf16 (q's dtype); tables
    (B,nblk) i32; q_positions (B,C) i32; num_live_blocks (B,) i32 (None =
    every slot: the causal mask still bounds the walk).  Returns
    (B,C,KH,G,D) in q's dtype."""
    _check("q", q, 5)
    b, c, kh, g, d = q.shape
    if q.dtype not in _DTYPES:
        raise ValueError(f"q dtype {q.dtype} not supported; one of "
                         f"{list(_DTYPES)}")
    _check("k_pool", k_pool, 4, q.dtype)
    _check("v_pool", v_pool, 4, q.dtype)
    n, bs, pkh, pd = k_pool.shape
    if (pkh, pd) != (kh, d) or v_pool.shape != k_pool.shape:
        raise ValueError(f"pool shape {tuple(k_pool.shape)} does not match "
                         f"q {tuple(q.shape)}")
    if d > MAX_HEAD_DIM or 8 * bs * d > MAX_TILE_BYTES:
        raise ValueError(f"head_dim {d} / block_size {bs} exceed the "
                         f"kernel's limits (D <= {MAX_HEAD_DIM}, "
                         f"8*bs*D <= {MAX_TILE_BYTES})")
    _check("tables", tables, 2, torch.int32)
    _check("q_positions", q_positions, 2, torch.int32)
    nblk = tables.shape[1]
    if tables.shape[0] != b or tuple(q_positions.shape) != (b, c):
        raise ValueError("tables / q_positions do not match q's batch/chunk")
    if num_live_blocks is None:
        num_live_blocks = torch.full((b,), nblk, dtype=torch.int32,
                                     device=q.device)
    _check("num_live_blocks", num_live_blocks, 1, torch.int32)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    if b == 0 or c == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = build.library().paged_attention_chunk(
        _DTYPES[q.dtype], q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        tables.data_ptr(), q_positions.data_ptr(), num_live_blocks.data_ptr(),
        out.data_ptr(), b, c, kh, g, d, bs, nblk, float(scale), stream)
    build.check(err, "paged_attention_chunk")
    LAUNCHES.n += 1
    return out


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, tables: torch.Tensor,
                    lengths: torch.Tensor,
                    num_live_blocks: Optional[torch.Tensor] = None, *,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Single-token decode: the C == 1 chunk.  q (B,KH,G,D); lengths (B,)
    i32 including the query token.  Returns (B,KH,G,D)."""
    q_positions = (lengths - 1).to(torch.int32)[:, None].contiguous()
    return paged_attention_chunk(q[:, None], k_pool, v_pool, tables,
                                 q_positions, num_live_blocks,
                                 scale=scale)[:, 0]
