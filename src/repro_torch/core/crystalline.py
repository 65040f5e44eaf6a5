"""Crystalline — batched wait-free reclamation (arXiv 2108.02763).

The WFE authors' follow-up scheme: keep WFE's wait-free protected
dereference (fast path + published-request helping, `wfe.py`) but retire
blocks in *batches* to amortize per-retire overhead and shrink the scan.
This port maps Crystalline's batch machinery onto the repo's existing era
substrate instead of its intrusive per-node ``next``/``batch_link`` fields:

* **Batch accumulation** — ``retire()`` is O(1): the block lands on a
  per-thread pending list (no era stamp, no scan).  Once ``batch_size``
  blocks accumulate, the batch *seals*: one ``global_era`` read stamps the
  whole batch's ``retire_era``, and the batch's conflict interval lower
  bound is the **minimum alloc era across the batch**
  (``batch_era = min(alloc_era)``), exactly Crystalline's rule that a
  batch is freeable only when no reservation falls inside
  ``[min birth era, retire era]``.
* **Per-batch reference linkage** — every sealed block points at a shared
  :class:`_Batch` record carrying the block list and a live counter (the
  port's analogue of Crystalline's ``refc``/batch list links); the counter
  reaches zero exactly when the whole batch is reclaimed, which the stress
  tests assert.
* **Era-mirror mapping** — sealed blocks enter the ordinary
  :class:`~repro_torch.core.era_table.ArrayRetireList`, whose packed int32
  columns are fed from ``retire_era_fields = ("batch_era", "retire_era")``.
  Because every block in a batch carries the *same* interval, the four
  cleanup backends (scalar / NumPy / torch / CUDA ``era_scan``) decide each
  batch all-or-none and stay bit-identical with zero backend changes —
  the batch structure lives entirely in the columns.
* **Wait-freedom** — inherited from WFE verbatim: ``get_protected`` is the
  same bounded fast path + helping slow path (Lemmas 1-5), and
  ``increment_era`` still helps every published request first.  ``retire``
  is a bounded list append; seal is O(batch_size) and runs at most once
  per ``batch_size`` retires, so every operation stays wait-free bounded.

Safety: the scan interval ``[batch_era, retire_era]`` contains each
member's true lifetime interval (``batch_era <= alloc_era`` and the
seal-time ``retire_era`` is >= the era current at the member's logical
retire), so batching is strictly conservative — it can only *delay* a
free relative to WFE, never admit one WFE would reject.  The flip side is
the memory bound gains a factor ``batch_size`` (one straggler reservation
pins its whole batch), which the stress suite's c·T²·H-style bound
absorbs.

Quiescence: drains must see pending (unsealed) blocks too, or a
``batch_size - 1`` remainder would leak forever.  ``flush``/
``cleanup_batch`` seal the calling thread's pending batch first;
``cleanup_batch_all`` (the engine's fused drain) seals *every* thread's —
per-tid pending locks make the cross-thread seal safe against a
concurrent owner retire.  ``unreclaimed()`` counts pending blocks so the
quiescence checks cannot pass while a partial batch is still parked.
"""

from __future__ import annotations

import threading
from typing import List, Optional

from .atomics import INF_ERA
from .smr_base import Block
from .wfe import WFE

__all__ = ["Crystalline"]


class _Batch:
    """Shared record linking the blocks of one sealed retire batch.

    ``live`` counts not-yet-freed members (Crystalline's ``refc``); the
    backends free a batch all-or-none per scan, so ``live`` steps from
    ``len(blocks)`` to 0 within one compact of the owning retire list.
    """

    __slots__ = ("blocks", "batch_era", "retire_era", "live")

    def __init__(self, blocks: List[Block], batch_era: int, retire_era: int):
        self.blocks = blocks
        self.batch_era = batch_era
        self.retire_era = retire_era
        self.live = len(blocks)


class Crystalline(WFE):
    name = "Crystalline"
    wait_free = True
    bounded_memory = True
    supports_batched_cleanup = True
    #: the scan interval is the BATCH interval, not the member's own
    retire_era_fields = ("batch_era", "retire_era")

    def __init__(
        self,
        max_threads: int,
        max_hes: int = 8,
        era_freq: int = 32,
        cleanup_freq: int = 32,
        max_attempts: int = 16,
        batch_size: int = 8,
    ):
        super().__init__(max_threads, max_hes=max_hes, era_freq=era_freq,
                         cleanup_freq=cleanup_freq, max_attempts=max_attempts)
        self.batch_size = max(1, batch_size)
        # pending (unsealed) blocks, one open batch per thread.  The owner
        # appends; fleet drains seal cross-thread — hence a lock per tid.
        # Lock order: pending lock -> retire-list lock (never the reverse).
        self._pending: List[List[Block]] = [[] for _ in range(max_threads)]
        self._pending_locks = [threading.Lock() for _ in range(max_threads)]
        # telemetry (single writer per index: frees of one list are
        # serialized by that list's lock, seals by the pending lock)
        self.batches_sealed = [0] * max_threads
        self.batches_freed = [0] * max_threads

    # -- batched retirement ----------------------------------------------------
    def retire(self, blk: Block, tid: int) -> None:
        """O(1) wait-free retire: park the block on the open batch."""
        self.retire_count[tid] += 1
        with self._pending_locks[tid]:
            pend = self._pending[tid]
            pend.append(blk)
            if len(pend) < self.batch_size:
                return
            retire_era = self._seal_locked(tid)
        # cleanup cadence counts BATCHES, not blocks — the amortization
        # that motivates the scheme (retire_counter reused from WFE)
        if self.retire_counter[tid] % self.cleanup_freq == 0:
            if retire_era == self.global_era.load():
                self.increment_era(tid)
            self.cleanup(tid)
        self.retire_counter[tid] += 1

    def _seal_locked(self, tid: int) -> int:
        """Stamp + publish the open batch.  Caller holds the pending lock.

        Returns the batch's retire era (0 when there was nothing to seal).
        One ``global_era`` read serves the whole batch; the conflict
        interval lower bound is the minimum member alloc era.
        """
        pend = self._pending[tid]
        if not pend:
            return 0
        retire_era = self.global_era.load()
        batch_era = min(b.alloc_era for b in pend)
        batch = _Batch(list(pend), batch_era, retire_era)
        rl = self.retire_lists[tid]
        with rl.lock:  # members enter the scannable list as one unit
            for b in batch.blocks:
                b.retire_era = retire_era
                b.batch_era = batch_era
                b.batch = batch
                rl.append(b)
        pend.clear()
        self.batches_sealed[tid] += 1
        return retire_era

    def seal(self, tid: int) -> None:
        """Force-seal this thread's open batch (drain paths, tests)."""
        with self._pending_locks[tid]:
            self._seal_locked(tid)

    def seal_all(self) -> None:
        for tid in range(self.max_threads):
            self.seal(tid)

    def reap_thread(self, tid: int) -> None:
        # WFE's reap (cancel orphaned slow-path requests, sweep all
        # reservation slots) plus sealing the dead thread's open batch:
        # no owner retire will ever complete it, and an unsealed batch is
        # invisible to the scan — without the seal up to batch_size - 1
        # blocks would leak.  Cross-thread seal is already safe (the
        # pending lock exists for the fleet drain); after join it cannot
        # even race the owner.
        super().reap_thread(tid)
        self.seal(tid)

    # -- reclamation -----------------------------------------------------------
    def can_delete(self, blk: Block, js: int, je: int) -> bool:
        # Scalar reference path: scan the BATCH interval.  The batched
        # backends get the same interval via retire_era_fields.
        for i in range(self.max_threads):
            row = self.reservations[i]
            for j in range(js, je):
                era = row[j].load_a()
                if era != INF_ERA and blk.batch_era <= era <= blk.retire_era:
                    return False
        return True

    def free(self, blk: Block, tid: int) -> None:
        batch = blk.batch
        if batch is not None:
            blk.batch = None  # break the cycle for refcounting GC
            batch.live -= 1  # serialized by the owning list's lock
            if batch.live == 0:
                self.batches_freed[tid] += 1
        super().free(blk, tid)

    def flush(self, tid: int) -> None:
        self.seal(tid)
        self.cleanup(tid)

    def cleanup_batch(self, tid: int, backend: str = "numpy",
                      **backend_kwargs) -> int:
        self.seal(tid)
        return super().cleanup_batch(tid, backend, **backend_kwargs)

    def cleanup_batch_all(self, backend: str = "numpy",
                          **backend_kwargs) -> int:
        self.seal_all()  # fleet drain must flush every open batch
        return super().cleanup_batch_all(backend, **backend_kwargs)

    # -- metrics ---------------------------------------------------------------
    def unreclaimed(self) -> int:
        # pending blocks are retired-but-not-freed too; without them a
        # partial batch would count as "reclaimed" and quiescence checks
        # would pass spuriously
        return super().unreclaimed() + sum(len(p) for p in self._pending)

    def pending(self) -> int:
        """Blocks parked on open (unsealed) batches, sampled racily."""
        return sum(len(p) for p in self._pending)

    def stats(self) -> dict:
        s = super().stats()
        s["batches_sealed"] = sum(self.batches_sealed)
        s["batches_freed"] = sum(self.batches_freed)
        s["pending"] = self.pending()
        return s
