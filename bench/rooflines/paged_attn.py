"""Operations and bytes of one paged-attention call (the decode, mixed and
prefill steps' attention over the KV pages), from the step's live rows.

A row has ``q`` query tokens and a context of ``ctx`` tokens that includes
them; it reads ``ceil(ctx / bs)`` pages.  Each input byte is counted once
and each output byte once, whatever the kernel re-reads: the queries and
the output (``q x H x D`` each), the K and V pages (``bs x KH x D`` each;
a page that several rows of the call alias, a shared prefix, once), the
table slots, the positions and the live count (int32).  Operations:
``4 D`` per (query head, visible key) pair, QK and PV.  The count is the
same whatever kernel implements the call; padded rows and columns are not
the algorithm's work and are not counted."""

from __future__ import annotations

import numpy as np

#: kernels of ``repro_torch``'s paged attention (csrc/paged_attention.cu)
KERNELS = ("paged_tile_kernel", "paged_split_kernel", "split_combine_kernel",
           "paged_f32_kernel")


def work(q, ctx, *, heads: int, kv_heads: int, head_dim: int, bs: int,
         act_bytes: int = 2, kv_bytes: int = 2, kv_pages: int = None):
    """(operations, bytes) of one call over rows ``q``, ``ctx``, whose
    rows read ``kv_pages`` distinct pages (by default none shared)."""
    q = np.asarray(q, dtype=np.int64)
    ctx = np.asarray(ctx, dtype=np.int64)
    pages = -(-ctx // bs)
    if kv_pages is None:
        kv_pages = int(pages.sum())
    pairs = q * ctx - q * (q - 1) // 2
    ops = 4 * head_dim * heads * int(pairs.sum())
    nbytes = (2 * int(q.sum()) * heads * head_dim * act_bytes
              + 2 * kv_pages * bs * kv_heads * head_dim * kv_bytes
              + 4 * int(pages.sum() + q.sum() + len(q)))
    return ops, nbytes


def bound_s(q, ctx, *, peak_ops: float, hbm_bps: float, **shape) -> float:
    """Least time of one call on the chip: bytes over bandwidth or
    operations over the peak, the larger."""
    ops, nbytes = work(q, ctx, **shape)
    return max(ops / peak_ops, nbytes / hbm_bps)
