"""Paged chunk attention through WFE-managed block tables: the CUDA kernels.

Replaces the Pallas TPU kernel ``repro/kernels/paged_attention.py``
``paged_attention_chunk`` (:148), its decode wrapper ``paged_attention``
(:227) and its int8 variant ``_paged_chunk_kernel_q8`` (:129).  Query rows
attend over K/V scattered across the pool blocks a request's table names,
causally by absolute position, walking only the first
``num_live_blocks[b]`` table slots.  Int8 pools come with per-(block,
kv-head) f32 scales, and the kernels dequantize as they read.

``csrc/paged_attention.cu`` holds three variants (design and what bounds
each on an H100 are in its header); :func:`choose_variant` picks one from
the query and pool types, the C*G query rows per kv head, D and bs:

- ``"split"``: the split-KV walk and its combine, for C*G < 16 (decode);
- ``"tile"``: the tensor-core tile of ``csrc/attention_tile.cuh``, for a
  bf16 query over bf16 or int8 pages (prefill and mixed chunks);
- ``"cuda_core"``: the f32 tile of ``csrc/attention_f32.cuh``
  (register-blocked FMA products on the CUDA cores), the exact path (an
  f32 query's chunks, and the shapes the other two do not take).

This module checks the operands and launches the chosen variant on the
current CUDA stream.  Its plain PyTorch versions are
``paged_attention_chunk_ref`` and ``paged_attention_chunk_int8_ref``; the
plain models of each variant's own order of operations are
``paged_attention_split_ref``, ``paged_attention_tile_ref`` and
``paged_attention_f32_tile_ref``.

The wrappers here take CUDA tensors only; ``ops`` selects between them
and the plain version by the tensor's device.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from . import build
from .ref import (check_scales, paged_attention_chunk_int8_ref,
                  paged_attention_chunk_ref, paged_attention_int8_ref,
                  paged_attention_ref)

__all__ = ["paged_attention_chunk", "paged_attention",
           "paged_attention_chunk_ref", "paged_attention_ref",
           "paged_attention_chunk_int8_ref", "paged_attention_int8_ref",
           "choose_variant", "split_keys", "split_plan", "LAUNCHES",
           "LAUNCHES_Q8",
           "VARIANT_LAUNCHES"]

#: the kernels' type codes: the query's, and the pools' (any of the four)
_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
              torch.int8: 3}
MAX_HEAD_DIM = 256
#: shared memory a block may use on an H100 (227 KB), which sizes the
#: split-KV walk's splits
MAX_SMEM_BYTES = 227 * 1024
#: head dims the tensor-core tile is instantiated for (multiples of 16)
TILE_HEAD_DIMS = (64, 80, 128, 256)
#: the split-KV walk: fewer query rows than this per (request, kv head),
#: and at most SPLIT_KEYS keys (pages_per_split * bs) per split
SPLIT_MAX_ROWS = 16
SPLIT_KEYS = 128
_WARPS = 4  # the split kernel's warps, each with a (rows, D) f32 partial

#: launches over float pools (``LAUNCHES.n``), bumped once per call
LAUNCHES = build.Counter()
#: launches over int8 pools, the port of ``_paged_chunk_kernel_q8``
LAUNCHES_Q8 = build.Counter()
#: launches per kernel variant, whatever the pools: ``tile``, ``split``
#: and its ``combine``, and the f32 tile ``cuda_core``
VARIANT_LAUNCHES = {name: build.Counter()
                    for name in ("tile", "split", "combine", "cuda_core")}


def choose_variant(q_dtype: torch.dtype, kv_dtype: torch.dtype, rows: int,
                   d: int, bs: int) -> str:
    """The kernel variant for a query of ``q_dtype`` with ``rows`` = C*G
    rows per (request, kv head), head dim ``d`` and block size ``bs`` over
    pools of ``kv_dtype``: ``"split"``, ``"tile"`` or ``"cuda_core"``."""
    if rows < SPLIT_MAX_ROWS:
        fits = d % 16 == 0 and d <= MAX_HEAD_DIM and bs <= split_keys(d)
        return "split" if fits else "cuda_core"
    if (q_dtype == torch.bfloat16 and d in TILE_HEAD_DIMS
            and kv_dtype in (torch.bfloat16, torch.int8)):
        return "tile"
    return "cuda_core"


def _split_smem(keys: int, d: int, itemsize: int) -> int:
    """The split kernel's shared memory (``split_smem_bytes`` in the
    source) for ``keys`` keys of K and V of ``itemsize`` bytes at the most
    rows it takes."""
    rows = SPLIT_MAX_ROWS - 1
    return 2 * keys * d * itemsize + 4 * (rows * d + rows * keys + 5 * keys
                                          + _WARPS * rows * d)


@functools.lru_cache(maxsize=None)
def split_keys(d: int) -> int:
    """Keys one split of the split-KV walk covers at head dim ``d``:
    ``SPLIT_KEYS``, halved until a split's K and V fit in shared memory
    beside its f32 rows in the widest pool type (f32): 128 up to D 128, 64
    at D 256.  The pool type does not enter, so every pool type cuts the
    walk at the same keys, and the fused int8 walk equals the walk over
    the dequantized f32 pools bitwise, as the reference requires."""
    keys = SPLIT_KEYS
    while keys > 16 and _split_smem(keys, d, 4) > MAX_SMEM_BYTES:
        keys //= 2
    return keys


def split_plan(nblk: int, bs: int, d: int) -> tuple:
    """(pages_per_split, n_splits) of the split-KV walk over a table of
    ``nblk`` slots at block size ``bs`` and head dim ``d``: splits of
    ``split_keys(d) // bs`` pages counted from slot 0.  It depends on the
    table's width, bs and D alone, never on ``num_live_blocks``, so the
    bounded and the unbounded walk cut the pages at the same slots."""
    pps = max(1, split_keys(d) // bs)
    return pps, max(1, -(-nblk // pps))


def _check_limits(d: int) -> None:
    """The kernels' one shape limit, D <= 256 (the split and tile
    variants' other shapes are guaranteed by ``choose_variant``; the f32
    tile gathers keys one by one, so bs does not bound it)."""
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} exceeds the kernels' {MAX_HEAD_DIM}")


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
                          num_live_blocks: Optional[torch.Tensor] = None,
                          k_scales: Optional[torch.Tensor] = None,
                          v_scales: Optional[torch.Tensor] = None, *,
                          scale: Optional[float] = None) -> torch.Tensor:
    """q (B,C,KH,G,D) f32 or bf16; pools (N,bs,KH,D) f32, fp16, bf16 or
    int8 (both alike, whatever q's type); k_scales/v_scales (N,KH) f32, for
    int8 pools only; tables (B,nblk) i32; q_positions (B,C) i32;
    num_live_blocks (B,) i32 (None = every slot: the causal mask still
    bounds the walk).  Returns (B,C,KH,G,D) in q's dtype."""
    _check("q", q, 5)
    b, c, kh, g, d = q.shape
    if q.dtype not in _Q_DTYPES:
        raise ValueError(f"q dtype {q.dtype} not supported; one of "
                         f"{list(_Q_DTYPES)}")
    if k_pool.dtype not in _KV_DTYPES:
        raise ValueError(f"pool dtype {k_pool.dtype} not supported; one of "
                         f"{list(_KV_DTYPES)}")
    check_scales(k_pool, k_scales, v_scales)
    _check("k_pool", k_pool, 4)
    _check("v_pool", v_pool, 4, k_pool.dtype)
    n, bs, pkh, pd = k_pool.shape
    quantized = k_scales is not None
    if quantized:
        _check("k_scales", k_scales, 2, torch.float32)
        _check("v_scales", v_scales, 2, torch.float32)
        if k_scales.shape != (n, kh) or v_scales.shape != (n, kh):
            raise ValueError(f"scales must be (N, KH) = {(n, kh)}, got "
                             f"{tuple(k_scales.shape)}, "
                             f"{tuple(v_scales.shape)}")
    if (pkh, pd) != (kh, d) or v_pool.shape != k_pool.shape:
        raise ValueError(f"pool shape {tuple(k_pool.shape)} does not match "
                         f"q {tuple(q.shape)}")
    variant = choose_variant(q.dtype, k_pool.dtype, c * g, d, bs)
    _check_limits(d)
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
    lib = build.library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    operands = (q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                k_scales.data_ptr() if quantized else None,
                v_scales.data_ptr() if quantized else None,
                tables.data_ptr(), q_positions.data_ptr(),
                num_live_blocks.data_ptr())
    kv = _KV_DTYPES[k_pool.dtype]
    if variant == "split":
        pps, nsplit = split_plan(nblk, bs, d)
        part = dict(dtype=torch.float32, device=q.device)
        part_m = torch.empty((b, kh, c * g, nsplit), **part)
        part_l = torch.empty((b, kh, c * g, nsplit), **part)
        part_acc = torch.empty((b, kh, c * g, nsplit, d), **part)
        err = lib.paged_attention_split(
            _Q_DTYPES[q.dtype], kv, *operands, part_m.data_ptr(),
            part_l.data_ptr(), part_acc.data_ptr(), out.data_ptr(), b, c, kh,
            g, d, bs, nblk, pps, nsplit, float(scale), stream)
        launched = ("split", "combine")
    elif variant == "tile":
        err = lib.paged_attention_tile(
            kv, *operands, out.data_ptr(), b, c, kh, g, d, bs, nblk,
            float(scale), stream)
        launched = ("tile",)
    else:
        err = lib.paged_attention_chunk(
            _Q_DTYPES[q.dtype], kv, *operands, out.data_ptr(), b, c, kh, g, d,
            bs, nblk, float(scale), stream)
        launched = ("cuda_core",)
    build.check(err, f"paged_attention_chunk ({variant})")
    for name in launched:
        VARIANT_LAUNCHES[name].bump()
    (LAUNCHES_Q8 if quantized else LAUNCHES).bump()
    return out


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, tables: torch.Tensor,
                    lengths: torch.Tensor,
                    num_live_blocks: Optional[torch.Tensor] = None,
                    k_scales: Optional[torch.Tensor] = None,
                    v_scales: Optional[torch.Tensor] = None, *,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Single-token decode: the C == 1 chunk.  q (B,KH,G,D); lengths (B,)
    i32 including the query token.  Returns (B,KH,G,D)."""
    q_positions = (lengths - 1).to(torch.int32)[:, None].contiguous()
    return paged_attention_chunk(q[:, None], k_pool, v_pool, tables,
                                 q_positions, num_live_blocks, k_scales,
                                 v_scales, scale=scale)[:, 0]
