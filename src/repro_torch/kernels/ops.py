"""Selectors between each CUDA kernel and its plain PyTorch version.

They dispatch on the device of the tensors they are given: a CPU tensor
goes to the plain version (``ref``), a CUDA tensor to the kernel, which
launches or raises.  There is no fallback from the kernel to the plain
version.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import era_scan, flash_attention as flash, paged_attention, ref

__all__ = ["can_delete_blocks", "can_delete_blocks_interval",
           "flash_attention",
           "paged_decode_attention", "paged_chunk_attention"]


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def can_delete_blocks(alloc_eras, retire_eras, reservations, *,
                      use_kernel: bool = False) -> torch.Tensor:
    """Vectorized WFE can_delete over R retired blocks: (R,), (R,) and
    (T, H) point reservations -> (R,) bool, on the device of the tensors
    given (NumPy arrays become CPU tensors).  ``use_kernel`` launches the
    CUDA kernel on CUDA tensors; without it, or on CPU tensors, the plain
    version runs."""
    alloc_eras, retire_eras, reservations = (
        torch.as_tensor(t).to(torch.int32)
        for t in (alloc_eras, retire_eras, reservations))
    if use_kernel and not _on_cpu(alloc_eras):
        return era_scan.era_scan(alloc_eras.contiguous(),
                                 retire_eras.contiguous(), reservations)
    return ref.era_scan_ref(alloc_eras, retire_eras, reservations)


def can_delete_blocks_interval(alloc_eras, retire_eras, res_lo, res_hi, *,
                               device="cuda") -> np.ndarray:
    """The era table's ``torch`` (``device="cpu"``) and ``cuda`` backends.

    Takes the NumPy int32 mirrors, runs the scan on ``device`` and returns
    the (R,) bool mask as NumPy.  On CUDA the mirrors go to the card and
    the mask back in one round trip (``era_scan.round_trip``: one packed
    pinned copy each way and one stream sync); that round trip is part of
    the backend's cost.
    """
    arrays = [np.ascontiguousarray(a, np.int32)
              for a in (alloc_eras, retire_eras, res_lo, res_hi)]
    dev = torch.device(device)
    if dev.type == "cpu":
        mask = ref.era_scan_interval_ref(*map(torch.from_numpy, arrays))
        return mask.numpy()
    if dev.type != "cuda":
        raise ValueError(f"no kernel or plain version for device {dev}")
    return era_scan.round_trip(*arrays, dev)


def paged_decode_attention(q, k_pool, v_pool, tables, lengths,
                           num_live_blocks=None, k_scales=None,
                           v_scales=None, *,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Decode attention over the paged pool.  q (B,KH,G,D) -> (B,KH,G,D).
    ``k_scales``/``v_scales`` (N,KH) f32 go with int8 pools."""
    if _on_cpu(q):
        return ref.paged_attention_ref(q, k_pool, v_pool, tables, lengths,
                                       num_live_blocks, scale=scale,
                                       k_scales=k_scales, v_scales=v_scales)
    return paged_attention.paged_attention(q, k_pool, v_pool, tables, lengths,
                                           num_live_blocks, k_scales,
                                           v_scales, scale=scale)


def paged_chunk_attention(q, k_pool, v_pool, tables, q_positions,
                          num_live_blocks=None, k_scales=None,
                          v_scales=None, *,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Chunked-prefill attention over the paged pool.  q (B,C,KH,G,D) ->
    (B,C,KH,G,D); a query at absolute position p sees pool tokens at
    positions <= p within its first ``num_live_blocks[b]`` table slots.
    ``k_scales``/``v_scales`` (N,KH) f32 go with int8 pools."""
    if _on_cpu(q):
        return ref.paged_attention_chunk_ref(q, k_pool, v_pool, tables,
                                             q_positions, num_live_blocks,
                                             scale=scale, k_scales=k_scales,
                                             v_scales=v_scales)
    return paged_attention.paged_attention_chunk(
        q, k_pool, v_pool, tables, q_positions, num_live_blocks, k_scales,
        v_scales, scale=scale)


def flash_attention(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """Dense GQA forward attention.  q (B,T,H,D), k/v (B,T,KH,D) ->
    (B,T,H,D)."""
    if _on_cpu(q):
        return ref.flash_attention_ref(q, k, v, causal=causal)
    return flash.flash_attention(q, k, v, causal=causal)
