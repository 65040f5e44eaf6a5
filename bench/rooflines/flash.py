"""Operations of the causal flash-attention calls of a training step
(forward, and the backward's recompute and gradients), per sequence of
``t`` tokens, ``heads`` query heads of ``head_dim``.

Visible (query, key) pairs of a causal sequence: t (t + 1) / 2.  Forward:
4 D operations per pair and head (QK and PV).  Backward: 10 D (QK again,
dP = dO V^T, dV, dQ and dK), as PERF.md's kernel table counts it.  The
calls are bound by operations at these shapes (the bytes, q, k, v, o and
their gradients, take a small fraction of the time), so the bound time is
the operations over the bf16 peak."""

from __future__ import annotations

KERNELS_FWD = ("flash_tile_kernel", "flash_f32_kernel")
KERNELS_BWD = ("dkdv_tile_kernel", "dq_tile_kernel", "split_sum_kernel",
               "dkdv_f32_kernel", "dq_f32_kernel", "delta_kernel")


def pairs(t: int) -> int:
    return t * (t + 1) // 2


def forward_ops(t: int, heads: int, head_dim: int) -> int:
    return 4 * head_dim * heads * pairs(t)


def backward_ops(t: int, heads: int, head_dim: int) -> int:
    return 10 * head_dim * heads * pairs(t)
