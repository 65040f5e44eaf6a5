"""Sharded block pool: N per-shard pools joined by distributed era clocks.

Ported from ``repro.blocks.sharded_pool``.  One monolithic
:class:`~repro_torch.blocks.block_pool.BlockPool` funnels every
alloc/retire through a single SMR instance — one free stack, one era
clock, one set of retire lists.  At serving scale that instance becomes the
contention point the Crystalline paper (arXiv 2108.02763, ported in
``core/crystalline.py``) warns about.  This module splits the pool into
``n_shards`` independent shards:

* each shard is a full ``BlockPool`` owning a disjoint global slot range
  ``[base, base + per_shard)``; the serving engine keeps one device pool
  (and one CUDA stream) per shard and localizes slot ids into it;
* each shard has its own SMR instance — its own era clock, reservations,
  and retire lists.  A block lives its entire lifecycle (alloc stamp,
  retire stamp, reservation scan) against its home shard's clock, so the
  single-instance safety proof applies shard by shard (``Block.home_shard``
  records the home; eras from different clocks are never compared);
* the shard clocks are joined by a
  :class:`~repro_torch.core.distributed_eras.ShardedEraDomain` max-merge,
  run on step boundaries (``step_boundary``) and before fleet drains:
  merging only advances lagging clocks (monotone join), which keeps
  reservation lag — and therefore reclamation delay — bounded by one
  merge period;
* an in-flight step may read blocks from every shard, so
  ``protect_step`` publishes one era reservation PER shard, each from that
  shard's own clock.  Cost: n_shards wait-free O(1) publishes per step —
  independent of batch size, preserving the interval property that made
  eras the right scheme in the first place.

Routing: a thread's *home* shard is ``tid % n_shards`` — allocation
pressure spreads across shards as workers scale, and a worker's metadata
nodes (block-table versions) stay on one clock.  Under per-shard exhaustion
``alloc`` falls back to stealing from the other shards before declaring the
whole pool exhausted.
"""

from __future__ import annotations

import threading
from typing import List, Optional

from repro_torch.core import Block
from repro_torch.core.distributed_eras import ShardedEraDomain

from .block_pool import BlockPool, KVBlock, PoolExhausted

__all__ = ["ShardedBlockPool"]


class ShardedBlockPool:
    """Drop-in pool façade over ``n_shards`` independent ``BlockPool``s."""

    def __init__(self, n_blocks: int, *, n_shards: int = 2,
                 scheme: str = "WFE", max_threads: int = 16,
                 merge_freq: int = 1, **pool_kwargs):
        if n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        if n_blocks < n_shards:
            raise ValueError(f"n_blocks={n_blocks} < n_shards={n_shards}")
        self.n_blocks = n_blocks
        self.n_shards = n_shards
        self.merge_freq = max(1, merge_freq)
        sizes = [n_blocks // n_shards + (1 if s < n_blocks % n_shards else 0)
                 for s in range(n_shards)]
        bases = [sum(sizes[:s]) for s in range(n_shards)]
        self.shards: List[BlockPool] = [
            BlockPool(sizes[s], scheme=scheme, max_threads=max_threads,
                      first_block=bases[s], **pool_kwargs)
            for s in range(n_shards)
        ]
        self._bases = bases
        self.eras = ShardedEraDomain([p.smr for p in self.shards])
        self._steps = 0  # merge cadence counter (racy increment is fine:
        # a missed boundary only delays the next merge by one step)
        self._tid_lock = threading.Lock()

    # ---------------------------------------------------------- threads
    def register_thread(self) -> int:
        """One registration covers every shard (same tid in each)."""
        with self._tid_lock:
            tids = [p.register_thread() for p in self.shards]
        assert len(set(tids)) == 1, "shard tid allocation diverged"
        return tids[0]

    def home(self, tid: int) -> int:
        return tid % self.n_shards

    # ---------------------------------------------------------- allocation
    def alloc(self, tid: int, shard: Optional[int] = None) -> KVBlock:
        """Allocate a slot.

        ``shard`` pins the allocation to one shard — the serving router
        uses this so a request's pages all live in one shard's slot range
        (and therefore one shard's device-pool chain).  Without a pin the
        home shard is tried first, then the others (work stealing).
        """
        if shard is not None:
            blk = self.shards[shard].alloc(tid)
            blk.home_shard = shard
            return blk
        h = self.home(tid)
        last_exc: Optional[PoolExhausted] = None
        for k in range(self.n_shards):
            s = (h + k) % self.n_shards
            try:
                blk = self.shards[s].alloc(tid)
                blk.home_shard = s
                return blk
            except PoolExhausted as e:
                last_exc = e
        raise PoolExhausted(
            f"all {self.n_shards} shards of {self.n_blocks} blocks "
            f"exhausted") from last_exc

    def alloc_blocks(self, n: int, tid: int,
                     shard: Optional[int] = None) -> List[KVBlock]:
        """Bulk allocation — all ``n`` from ONE shard (all or nothing).

        A prefill chunk's pages must share a shard (the request's device
        steps touch one shard's KV chain), so the bulk grab never splits
        across shards; unpinned callers fall back shard by shard.
        """
        if shard is not None:
            blks = self.shards[shard].alloc_blocks(n, tid)
            for blk in blks:
                blk.home_shard = shard
            return blks
        h = self.home(tid)
        last_exc: Optional[PoolExhausted] = None
        for k in range(self.n_shards):
            s = (h + k) % self.n_shards
            try:
                return self.alloc_blocks(n, tid, shard=s)
            except PoolExhausted as e:
                last_exc = e
        raise PoolExhausted(
            f"no single shard of {self.n_shards} has {n} free blocks"
        ) from last_exc

    def retire(self, blk: KVBlock, tid: int) -> None:
        # the home shard's clock stamped alloc_era; retire on the same clock
        self.shards[blk.home_shard].retire(blk, tid)

    # ------------------------------------------------- shared ownership
    def add_sharer(self, blk: KVBlock) -> None:
        self.shards[blk.home_shard].add_sharer(blk)

    def release_block(self, blk: KVBlock, tid: int) -> bool:
        """Last-sharer-retires, routed to the block's home shard (the
        retire must stamp the same clock that stamped ``alloc_era``)."""
        return self.shards[blk.home_shard].release_block(blk, tid)

    # ------------------------------------------------- SMR-managed metadata
    def alloc_node(self, cls, tid: int, *args, shard: Optional[int] = None,
                   **kwargs) -> Block:
        """``shard`` pins the node to a request's shard so its retire lands
        where the request's other retires do; default is the caller's home."""
        s = self.home(tid) if shard is None else shard
        blk = self.shards[s].alloc_node(cls, tid, *args, **kwargs)
        blk.home_shard = s
        return blk

    def retire_node(self, blk: Block, tid: int) -> None:
        self.shards[blk.home_shard].retire_node(blk, tid)

    # ---------------------------------------------------------- protection
    def protect_step(self, slot: int, tid: int,
                     shard: Optional[int] = None) -> None:
        """Publish an era reservation covering blocks alive now.

        ``shard=None`` publishes one reservation PER shard (a step whose
        batch may touch any shard); a shard-pinned step reserves only in
        its own shard — each reservation is against that shard's clock.
        """
        if shard is not None:
            self.shards[shard].protect_step(slot, tid)
            return
        for p in self.shards:
            p.protect_step(slot, tid)

    def release_step(self, slot: int, tid: int,
                     shard: Optional[int] = None) -> None:
        if shard is not None:
            self.shards[shard].release_step(slot, tid)
            return
        for p in self.shards:
            p.release_step(slot, tid)

    def reap_thread(self, tid: int) -> None:
        """Clear a dead (joined) worker's reservations in EVERY shard —
        registration spans all shards, so reaping must too."""
        for p in self.shards:
            p.reap_thread(tid)

    # ---------------------------------------------------------- era merge
    def step_boundary(self, tid: int) -> None:
        """Periodic max-merge of the shard clocks (call once per step).

        Piggybacks on step completion exactly like the production design
        rides on a step collective: every ``merge_freq`` completions the
        shard clocks join to the fleet maximum.
        """
        self._steps += 1
        if self._steps % self.merge_freq == 0:
            self.eras.merge_all()

    def advance_eras(self, tid: int) -> None:
        """Tick every shard's clock once, then re-join (drain helper)."""
        for p in self.shards:
            p.advance_eras(tid)
        self.eras.merge_all()

    # ---------------------------------------------------------- reclamation
    def cleanup(self, tid: int, shard: Optional[int] = None, **kwargs) -> int:
        """Drain this thread's retire list: one shard, or fan-out to all.

        Steady-state callers (the scheduler's per-step cleanup) pass the
        shard they just retired into; quiescent callers fan out.
        """
        if shard is not None:
            return self.shards[shard].cleanup(tid, **kwargs)
        return sum(p.cleanup(tid, **kwargs) for p in self.shards)

    def cleanup_all(self, *, backend: Optional[str] = None) -> int:
        """Fused cross-shard drain: merge clocks, then every shard's fleet
        scan (each shard's reservation phases snapshotted once)."""
        self.eras.merge_all()
        return sum(p.cleanup_all(backend=backend) for p in self.shards)

    # ---------------------------------------------------------- metrics
    @property
    def free_blocks(self) -> int:
        return sum(p.free_blocks for p in self.shards)

    def unreclaimed(self) -> int:
        return sum(p.unreclaimed() for p in self.shards)

    @property
    def smrs(self):
        return [p.smr for p in self.shards]

    def stats(self) -> dict:
        merged: dict = {"n_blocks": self.n_blocks, "n_shards": self.n_shards,
                        "free_blocks": self.free_blocks}
        for p in self.shards:
            for k, v in p.smr.stats().items():
                if k == "global_era":
                    merged[k] = max(merged.get(k, 0), v)
                else:
                    merged[k] = merged.get(k, 0) + v
        merged.update(self.eras.stats())
        return merged
