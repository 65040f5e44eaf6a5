"""Refcounted prefix cache over the WFE block pool.

Prompts that share a token prefix share pool blocks: the cache maps
block-aligned token prefixes to runs of already-materialized ``KVBlock``s,
and a request admitted with a matching prefix aliases those blocks in its
own table instead of re-prefilling them — the cached chunks cost ZERO
prefill dispatches (the prefill cursor starts at the cached boundary, so
``paged_prefill_chunk`` never re-scatters a cached page).

Ownership is per-block sharer refcounts (``KVBlock.sharers``):

* every holder of a block — the cache entry that names it and every
  request whose table aliases it — owns one reference;
* ``BlockPool.release_block`` drops a reference with one atomic
  fetch-and-add; the LAST sharer (the 1 -> 0 transition, observed by
  exactly one thread) retires the block.  Retirement is therefore
  exactly-once under concurrent release — no lock couples the sharers;
* retire-at-zero hands the block to the pool's SMR scheme, so a reader
  still inside an era reservation that covers the block keeps reading
  safely: refcounts decide WHEN a block is logically dead, the era scan
  decides when its slot is physically reusable.  This split is exactly
  the paper's division of labor (cf. Crystalline's refcount-driven
  wait-free reclamation): the refcount transition is wait-free (one F&A),
  and reclamation stays wait-free-bounded under WFE.

Key discipline (chunk-aligned keys): a prefix is cacheable only in whole
``block_size`` pages — a partially-filled page cannot be shared because
the divergent tail (or the first decode token) would scatter into it.
Chunk boundaries from chunked prefill are block-aligned by construction
(pages are bulk-allocated per chunk), so block granularity IS the chunk
granularity of chunked prefill.  Keys are the literal ``(shard, token-prefix)``
tuples — collision-free by construction; Python interns the hashing.
Literal keys cost O(P^2) tokens of key storage per cached prompt and
O(P^2 / block_size) hashing per deepest-match walk — the right trade at
this repro's prompt scale (correctness is free to audit); a prompt-length
jump to many thousands of tokens would warrant a per-level trie keyed by
one block of tokens, which makes both O(P).

Sharding: a cached run lives in ONE shard's slot range (the producing
request's pin), and a consumer's device steps touch one shard's KV chain,
so entries are keyed by shard and a request only matches entries from its
own shard.

Eviction: entries are LRU.  Under pool pressure the scheduler evicts
cache entries BEFORE preempting victim requests — and because eviction
merely drops the cache's references, a block still shared by a live
request is never force-retired (shared blocks are not victims; the last
sharer still retires exactly once).
"""

from __future__ import annotations

import itertools
import threading
from typing import List, Optional, Sequence, Tuple

from .block_pool import KVBlock

__all__ = ["PrefixCache"]


class _Entry:
    """One cached block-aligned prefix: the blocks of the WHOLE run."""

    __slots__ = ("key", "blocks", "shard", "stamp")

    def __init__(self, key, blocks: Tuple[KVBlock, ...], shard: int,
                 stamp: int):
        self.key = key
        self.blocks = blocks
        self.shard = shard
        self.stamp = stamp


class PrefixCache:
    """Block-aligned token-prefix -> shared ``KVBlock`` run, LRU.

    The cache owns one sharer reference per block PER ENTRY naming it
    (nested prefixes of one prompt each reference the shallow blocks), so
    entries can be evicted in any LRU order: a block is retired only when
    the last reference — cache entries and request tables alike — drops.
    """

    def __init__(self, pool, *, block_size: int,
                 max_entries: Optional[int] = None):
        self._pool = pool
        self.block_size = block_size
        self.max_entries = max_entries
        self._entries: dict = {}  # (shard, token-prefix tuple) -> _Entry
        self._lock = threading.Lock()
        self._clock = itertools.count()
        # counters (written under the lock; read racily by stats())
        self.lookups = 0
        self.hits = 0
        self.hit_tokens = 0
        self.inserted_entries = 0
        self.evicted_entries = 0

    # ------------------------------------------------------------- keys
    def _max_hit_blocks(self, prompt: Sequence[int]) -> int:
        """Cacheable-prefix cap for a CONSUMER: at least one prompt token
        must remain to prefill (its logits yield the first generated
        token), so the hit never covers the final token."""
        return max(0, (len(prompt) - 1) // self.block_size)

    def _max_insert_blocks(self, prompt: Sequence[int]) -> int:
        """Cacheable-prefix cap for a PRODUCER: only pages fully covered
        by prompt tokens are immutable (the next partial page receives
        the prompt tail and/or decode scatters)."""
        return len(prompt) // self.block_size

    def _key(self, prompt: Sequence[int], depth: int, shard: int):
        return (shard, tuple(prompt[: depth * self.block_size]))

    # ---------------------------------------------------------- consume
    def acquire(self, prompt: Sequence[int],
                shard: int = 0) -> List[KVBlock]:
        """Deepest cached run matching ``prompt``'s block-aligned prefix.

        Each returned block carries one NEW sharer reference owned by the
        caller (taken under the cache lock, while the entry's own
        reference still pins the count above zero — no 0 -> 1
        resurrection is possible).  Returns ``[]`` on a miss.
        """
        nb = self._max_hit_blocks(prompt)
        with self._lock:
            self.lookups += 1
            for depth in range(nb, 0, -1):
                e = self._entries.get(self._key(prompt, depth, shard))
                if e is None:
                    continue
                for blk in e.blocks:
                    self._pool.add_sharer(blk)
                e.stamp = next(self._clock)
                self.hits += 1
                self.hit_tokens += depth * self.block_size
                return list(e.blocks)
            return []

    # ---------------------------------------------------------- produce
    def insert(self, prompt: Sequence[int], blocks: Sequence[KVBlock],
               tid: int, shard: int = 0) -> int:
        """Register every block-aligned prefix of a materialized prompt.

        ``blocks`` is the producing request's table run (cached aliases
        included — re-inserting an aliased prefix dedupes on the key).
        ``tid`` is the calling thread's SMR id: a capacity overflow evicts
        LRU entries here, and the retires must land in the CALLER's
        per-thread retire list (single-writer discipline).  Returns the
        number of NEW entries created.
        """
        nb = min(self._max_insert_blocks(prompt), len(blocks))
        added = 0
        with self._lock:
            for depth in range(1, nb + 1):
                key = self._key(prompt, depth, shard)
                if key in self._entries:
                    continue
                run = tuple(blocks[:depth])
                for blk in run:
                    self._pool.add_sharer(blk)
                self._entries[key] = _Entry(key, run, shard,
                                            next(self._clock))
                added += 1
            self.inserted_entries += added
            while (self.max_entries is not None
                   and len(self._entries) > self.max_entries):
                self._release_entry_locked(self._lru_locked(None), tid)
        return added

    # ----------------------------------------------------------- evict
    def _lru_locked(self, shard: Optional[int]) -> Optional[_Entry]:
        best = None
        for e in self._entries.values():
            if shard is not None and e.shard != shard:
                continue
            if best is None or e.stamp < best.stamp:
                best = e
        return best

    def _release_entry_locked(self, entry: _Entry, tid: int) -> int:
        """Drop one entry + its references; returns blocks RETIRED (the
        1 -> 0 transitions).  A block still aliased by a live request or
        a deeper entry merely loses a reference — shared blocks are never
        force-retired."""
        del self._entries[entry.key]
        retired = 0
        for blk in entry.blocks:
            retired += self._pool.release_block(blk, tid)
        self.evicted_entries += 1
        return retired

    def evict_lru(self, tid: int, shard: Optional[int] = None) -> int:
        """Evict LRU entries until >= 1 block actually retires.

        The scheduler calls this under pool pressure BEFORE preempting a
        victim request: reclaiming cache-only blocks is free, preempting
        a request redoes its prefill.  Nested prefixes mean evicting the
        shallowest entry alone often frees nothing (deeper entries still
        pin its blocks), so the loop keeps evicting until a retire
        happens — ONE call per failed allocation, not one per entry.
        Returns the number of blocks retired; 0 means the cache (or this
        shard's slice) is out of reclaimable entries and the caller must
        fall back to request eviction.
        """
        with self._lock:
            while True:
                entry = self._lru_locked(shard)
                if entry is None:
                    return 0
                retired = self._release_entry_locked(entry, tid)
                if retired:
                    return retired

    def clear(self, tid: int) -> int:
        """Release every entry (engine drain: the cache must not pin pool
        slots past shutdown).  Returns the number of entries dropped."""
        with self._lock:
            entries = list(self._entries.values())
            for entry in entries:  # order is irrelevant: one pass, O(n)
                self._release_entry_locked(entry, tid)
            return len(entries)

    # ----------------------------------------------------------- stats
    def __len__(self) -> int:
        return len(self._entries)

    @property
    def cached_blocks(self) -> int:
        """Distinct pool blocks currently pinned by cache entries."""
        with self._lock:
            return len({id(b) for e in self._entries.values()
                        for b in e.blocks})

    def stats(self) -> dict:
        return {
            "entries": len(self._entries),
            "cached_blocks": self.cached_blocks,
            "lookups": self.lookups,
            "hits": self.hits,
            "hit_tokens": self.hit_tokens,
            "inserted_entries": self.inserted_entries,
            "evicted_entries": self.evicted_entries,
        }
