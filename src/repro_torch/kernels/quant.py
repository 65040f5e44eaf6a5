"""Symmetric per-(block, kv-head) int8 quantization for the paged KV pool.

Ported from ``repro.kernels.quant``.  Every int8 pool page holds codes in
[-127, 127] plus ONE f32 scale per (pool block, kv head): ``k_scale`` /
``v_scale`` tensors shaped (N, KH) beside the pools.  A value is
``code.float() * scale``; the paged-attention kernel does that multiply
right after it loads a tile (``csrc/paged_attention.cu``), so K/V stream
from device memory at one byte per element.

Writes keep a RUNNING absmax per block: a new token may only grow its
block's scale, and when it does the rows already stored are re-coded
``round(code * old / new)`` from their int8 codes (there is no other copy).
A block's error is therefore at most half the largest scale it ever had.

The arithmetic is the reference's, operation for operation, so the codes
and scales agree with it bit for bit: ``torch.round`` rounds half to even
as ``jnp.round`` does, and ``x / scale`` stays a true division.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["QMAX", "dequantize_pool", "quantize_rows", "requantize_blocks",
           "scatter_quantized"]

#: symmetric int8 code range [-127, 127]; -128 is unused
QMAX = 127.0


def _safe(scales: torch.Tensor) -> torch.Tensor:
    """Division-safe scales: a never-written block has scale 0 and every
    code 0; dividing by 1.0 instead keeps 0 / 1 = 0 without NaN."""
    return torch.where(scales > 0, scales, 1.0)


def dequantize_pool(pool: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """int8 pool (N, bs, KH, D) + scales (N, KH) -> f32 (N, bs, KH, D).

    The kernel's staging arithmetic: int8 -> f32 is exact and the multiply
    is one f32 rounding, so the f32 kernel on this tensor equals the fused
    int8 kernel bitwise.
    """
    return pool.float() * scales.float()[:, None, :, None]


def quantize_rows(x: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Quantize fp rows (..., KH, D) under per-(row, head) scales (..., KH):
    ``round(x / scale)`` clipped to the code range."""
    q = torch.round(x.float() / _safe(scales)[..., None])
    return torch.clamp(q, -QMAX, QMAX).to(torch.int8)


def requantize_blocks(blocks: torch.Tensor, old_scales: torch.Tensor,
                      new_scales: torch.Tensor) -> torch.Tensor:
    """Re-code stored int8 rows (..., bs, KH, D) from old to new scales
    (..., KH): ``round(code * old / new)``.  Scales only grow, so the
    ratio is <= 1; an unchanged scale gives ratio 1.0 and the same codes."""
    ratio = torch.where(new_scales > 0, old_scales / _safe(new_scales), 0.0)
    q = torch.round(blocks.float() * ratio[..., None, :, None])
    return torch.clamp(q, -QMAX, QMAX).to(torch.int8)


def scatter_quantized(pool: torch.Tensor, scales: torch.Tensor,
                      blk: torch.Tensor, off: torch.Tensor,
                      toks: torch.Tensor,
                      dest: Optional[torch.Tensor] = None) -> None:
    """Scatter fp K/V rows into an int8 pool under running absmax scales,
    writing ``pool`` and ``scales`` IN PLACE (as the fp pools are written).

    pool (N, bs, KH, D) int8; scales (N, KH) f32; blk/off (M,) destination
    block and offset of each row; toks (M, KH, D) fp.  Every row is
    written: the reference's padded rows (its out-of-range drop sentinel)
    are left out by the caller.  ``dest`` names the blocks to re-code and
    must hold every value of ``blk``; None takes ``torch.unique(blk)``, one
    gather per block however many rows land in it.  A duplicate in
    ``dest`` re-codes the same block twice to the same bytes.

    Three steps, in the reference's order:

    1. ``scales[blk] = max(scales[blk], absmax / QMAX)``, a running max;
    2. re-code each destination block's stored rows from the PRE-update
       codes and scale to the post-update scale (gathered before any
       write);
    3. quantize the new rows under the post-update scale and write them at
       their offsets, over step 2's re-coding of those rows.
    """
    if blk.numel() == 0:
        return
    kh = scales.shape[1]
    if dest is None:
        dest = torch.unique(blk)
    amax = toks.float().abs().amax(dim=-1)                        # (M, KH)
    old = scales[dest]                                            # a copy
    scales.scatter_reduce_(0, blk[:, None].expand(-1, kh), amax / QMAX,
                           reduce="amax")
    pool[dest] = requantize_blocks(pool[dest], old, scales[dest])
    pool[blk, off] = quantize_rows(toks, scales[blk])
