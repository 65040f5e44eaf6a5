"""Compute/communication overlap primitives (``repro.sharding.overlap``).

* ``ag_matmul`` — all-gather-then-matmul with the gather decomposed into
  k - 1 ring steps over the process group, each overlapped with the
  matmul of the chunk that is already resident (the "collective matmul"
  of Wang et al.);
* ``rs_matmul`` — matmul with reduce-scattered output, the same
  decomposition in reverse.

Where the reference runs under ``shard_map`` with ``ppermute``, each ring
step here posts ``dist.batch_isend_irecv`` (send to one neighbour, receive
from the other), runs the resident chunk's matmul while the transfer is in
flight, then waits.  The chunk products are plain matrix products (the
reference's ``jnp.dot`` outside any Pallas kernel), so ``torch.matmul``
computes them.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["ag_matmul", "rs_matmul"]


def _ring(group):
    """(k, this rank's index in the group, global rank of index i)."""
    k = dist.get_world_size(group)
    idx = dist.get_rank(group)

    def peer(i: int) -> int:
        return dist.get_global_rank(group, i % k) if group is not None \
            else i % k

    return k, idx, peer


def _permute(send: torch.Tensor, to: int, frm: int, group):
    """Post one ring step: ``send`` to global rank ``to``, a buffer of its
    shape from ``frm``.  Returns (buffer, requests)."""
    recv = torch.empty_like(send)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, to, group),
        dist.P2POp(dist.irecv, recv, frm, group)])
    return recv, reqs


def _wait(reqs) -> None:
    for r in reqs:
        r.wait()


def ag_matmul(x_shard: torch.Tensor, w_shard: torch.Tensor, group=None
              ) -> torch.Tensor:
    """Overlapped all_gather(x) @ w over ``group`` (k ranks).

    x_shard: (m/k, n) — this rank's rows of x (row block ``rank``);
    w_shard: (n, p/k) — this rank's weight columns (column parallel).
    Returns the local (m, p/k) output, equal to all_gather(x) @ w_shard,
    computed as k chunk-matmuls pipelined with k - 1 ring steps.
    """
    k, idx, peer = _ring(group)
    m = x_shard.shape[0]
    out = x_shard.new_empty((k * m, w_shard.shape[1]))
    chunk = x_shard
    for i in range(k):
        reqs = None
        if i < k - 1:  # the next chunk travels while this one multiplies
            nxt, reqs = _permute(chunk, peer(idx + 1), peer(idx - 1), group)
        src = (idx - i) % k  # whose rows we currently hold
        out[src * m:(src + 1) * m] = torch.matmul(chunk, w_shard)
        if reqs is not None:
            _wait(reqs)
            chunk = nxt
    return out


def rs_matmul(x: torch.Tensor, w_shard: torch.Tensor, group=None
              ) -> torch.Tensor:
    """Overlapped x @ w with reduce-scattered output over ``group``.

    x: (m, n/k) local activation (row-parallel input);
    w_shard: (n/k, p) local weight shard.
    Returns (m/k, p): row block ``rank`` of the sum over ranks of the
    (m, p) partial products, as k - 1 ring steps of permute + add, each
    overlapped with the next chunk's matmul.
    """
    k, idx, peer = _ring(group)
    m = x.shape[0]
    assert m % k == 0, (m, k)
    mc = m // k

    def chunk_mm(j):  # the partial destined for rank j, in f32
        return torch.matmul(x[j * mc:(j + 1) * mc].float(), w_shard.float())

    acc = chunk_mm((idx + 1) % k)
    # ring: after k-1 permute+add steps every rank holds its reduced chunk
    for i in range(1, k):
        recv, reqs = _permute(acc, peer(idx - 1), peer(idx + 1), group)
        part = chunk_mm((idx + 1 + i) % k)
        _wait(reqs)
        acc = recv + part
    return acc.to(x.dtype)
