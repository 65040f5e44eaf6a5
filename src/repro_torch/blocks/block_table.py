"""Versioned per-request block tables.

A request's block table is itself an SMR-managed node (``TableVersion``):
appending a block publishes a NEW version and *retires* the old one — the
exact linked-structure update pattern the paper's ``get_protected`` protects
(readers may hold a stale version; the version node cannot be reclaimed
while any in-flight step's era reservation covers it, and the block ids it
names stay valid because the blocks' retire eras are >= that reservation).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from repro_torch.core import Block
from repro_torch.core.atomics import AtomicRef, PtrView

from .block_pool import BlockPool, KVBlock

__all__ = ["TableVersion", "BlockTableRef"]


class TableVersion(Block):
    """Immutable snapshot of a request's block list (paper Fig. 2 node)."""

    __slots__ = ("blocks",)

    def __init__(self, blocks: Tuple[KVBlock, ...]):
        super().__init__()
        self.blocks = blocks

    def _poison_payload(self) -> None:
        self.blocks = None  # loud use-after-free in tests

    @property
    def block_ids(self) -> Tuple[int, ...]:
        return tuple(b.index for b in self.blocks)


class BlockTableRef:
    """The mutable cell holding the current TableVersion for one request.

    Prefix sharing: ``adopt_prefix`` constructs a new table version whose
    prefix ALIASES shared blocks from the prefix cache, and
    ``release_all`` drops per-block references instead of retiring
    outright — a shared block outlives this request until its LAST sharer
    releases it.
    """

    def __init__(self, pool: BlockPool, tid: int, shard: Optional[int] = None):
        self._pool = pool
        # request -> shard pin: every page of this table comes from one
        # shard's slot range, so the request's device steps touch exactly
        # one shard's KV-pool chain (None = unpinned / unsharded pool)
        self.shard = shard
        # node alloc/retire go through the pool, not pool.smr directly: a
        # sharded pool pins each version node to the REQUEST's shard so the
        # scheduler's per-step cleanup of that shard drains them
        empty = pool.alloc_node(TableVersion, tid, (), shard=shard)
        self._ref = AtomicRef(empty)
        self.view = PtrView(self._ref)

    def current(self) -> TableVersion:
        return self._ref.load()

    def append_block(self, tid: int) -> KVBlock:
        """Allocate a pool block and publish a new table version."""
        return self.append_blocks(tid, 1)[0]

    def append_blocks(self, tid: int, n: int) -> List[KVBlock]:
        """Bulk-append ``n`` blocks under ONE new table version.

        The chunked-prefill planner allocates every page a chunk needs in
        one shot (``BlockPool.alloc_blocks`` — atomic under pressure), and
        publishing a single version for all of them retires one node
        instead of n: version churn stays O(chunks), not O(blocks).
        """
        blks = self._pool.alloc_blocks(n, tid, shard=self.shard)
        old = self._ref.load()
        new = self._pool.alloc_node(
            TableVersion, tid, old.blocks + tuple(blks), shard=self.shard)
        self._ref.store(new)  # single writer per request (the scheduler)
        self._pool.retire_node(old, tid)
        return blks

    def adopt_prefix(self, tid: int, blocks: List[KVBlock]) -> None:
        """Publish a version whose prefix ALIASES cached shared blocks.

        Only valid on an empty table (a fresh or evicted-and-rewound
        request); the caller owns one sharer reference per block — this
        table takes them over and ``release_all`` drops them later.
        """
        old = self._ref.load()
        assert not old.blocks, "adopt_prefix on a non-empty table"
        new = self._pool.alloc_node(TableVersion, tid, tuple(blocks),
                                    shard=self.shard)
        self._ref.store(new)
        self._pool.retire_node(old, tid)

    def release_all(self, tid: int) -> int:
        """Release every block + retire the table (request finished,
        evicted, or cancelled).  Returns the number of references dropped.

        Blocks go through ``release_block`` — one sharer-reference drop
        each — so a block shared with the prefix cache (or another
        request's table) survives until its last sharer releases it, and
        that last release retires it exactly once.  Table-version nodes
        are never shared; they retire directly.  This is the ONLY way
        blocks leave a table — cancellation included: a client abandoning
        a request mid-step must not force-retire pages an in-flight
        dispatch's era reservation still covers, and the refcount/era
        split makes force-retire unnecessary (refcounts decide logical
        death, the era scan decides physical reuse).  Idempotent: a
        second call sees the empty version and drops nothing.
        """
        old = self._ref.load()
        blocks = old.blocks  # snapshot: retire_node may poison the payload
        empty = self._pool.alloc_node(TableVersion, tid, (), shard=self.shard)
        self._ref.store(empty)
        for blk in blocks:
            self._pool.release_block(blk, tid)
        self._pool.retire_node(old, tid)
        return len(blocks)

    def __len__(self) -> int:
        cur = self._ref.load()
        return len(cur.blocks) if cur.blocks is not None else 0
