"""Common API for safe-memory-reclamation (SMR) schemes.

The API follows the paper (§2.3): ``alloc_block`` / ``get_protected`` /
``retire`` / ``clear``, plus ``start_op``/``end_op`` so epoch-style schemes
(EBR, IBR) can bracket operations — for HP/HE/WFE ``end_op`` simply calls
``clear``.  Thread identity is an explicit ``tid`` (the paper's pseudo-code
does the same); threads obtain a tid from ``register_thread()``.

Every reclaimable object derives from :class:`Block` — the paper's
``block header`` embedded in each node.  ``free()`` poisons the block so that
use-after-free becomes loudly visible in tests instead of silently reading
stale data.
"""

from __future__ import annotations

import threading
from typing import Any, List, Optional, Tuple, Type

import numpy as np

from .atomics import INF_ERA
from .era_table import ArrayRetireList, batched_can_delete

__all__ = ["Block", "SMRScheme", "POISON"]


class _Poison:
    __slots__ = ()

    def __repr__(self) -> str:  # pragma: no cover
        return "<poison>"


POISON = _Poison()


class Block:
    """Reclamation header every managed node embeds (paper Fig. 2).

    ``alloc_era``/``retire_era`` bound the block's lifetime interval.
    ``freed`` flags reclaimed blocks; schemes poison payload slots on free so
    that unsafe reclamation manifests as an explicit error.
    """

    __slots__ = ("alloc_era", "retire_era", "birth_epoch", "batch_era",
                 "batch", "freed", "home_shard")

    def __init__(self) -> None:
        self.alloc_era = 0
        self.retire_era = INF_ERA
        self.birth_epoch = 0  # used by IBR
        self.batch_era = 0  # used by Crystalline: min alloc era of the batch
        self.batch = None  # Crystalline's shared per-batch record
        self.freed = False
        # owning SMR shard (sharded pools); eras are only comparable within
        # one instance's clock, so a block must retire where it was born
        self.home_shard = 0

    def _poison_payload(self) -> None:
        """Overwrite payload slots with POISON.  Subclasses extend."""


class SMRScheme:
    """Base class; concrete schemes implement the protected-access protocol."""

    #: human-readable scheme id used by benchmarks
    name: str = "base"
    #: True if every SMR operation is wait-free bounded
    wait_free: bool = False
    #: True if retired-but-unreclaimed memory is bounded even with stalled threads
    bounded_memory: bool = False
    #: (alloc-like, retire-like) Block fields bounding the lifetime interval
    #: used by the batched scan (IBR overrides with birth_epoch)
    retire_era_fields: Tuple[str, str] = ("alloc_era", "retire_era")

    def __init__(self, max_threads: int):
        self.max_threads = max_threads
        self._tid_lock = threading.Lock()
        self._next_tid = 0
        # single-writer-per-index stats (no locking needed)
        self.alloc_count: List[int] = [0] * max_threads
        self.free_count: List[int] = [0] * max_threads
        self.retire_count: List[int] = [0] * max_threads
        # list-compatible, but additionally keeps packed int32 era columns
        # in lock-step for the batched reclamation scan (era_table.py)
        self.retire_lists: List[ArrayRetireList] = [
            ArrayRetireList(self.retire_era_fields) for _ in range(max_threads)
        ]

    # -- thread management -------------------------------------------------
    def register_thread(self) -> int:
        with self._tid_lock:
            tid = self._next_tid
            self._next_tid += 1
        if tid >= self.max_threads:
            raise RuntimeError(
                f"{self.name}: more than max_threads={self.max_threads} threads"
            )
        return tid

    @property
    def registered_threads(self) -> int:
        """How many tids have been handed out (caps at ``max_threads``).

        The supervisor uses ``max_threads - registered_threads`` as the
        respawn headroom: quarantined tids are never reused, so each
        replacement worker consumes a fresh registration.
        """
        return min(self._next_tid, self.max_threads)

    # -- core API (paper §2.3) ----------------------------------------------
    def alloc_block(self, cls: Type[Block], tid: int, *args: Any, **kwargs: Any) -> Block:
        raise NotImplementedError

    def get_protected(self, ptr: Any, index: int, tid: int, parent: Optional[Block] = None) -> Any:
        """Safely dereference ``ptr`` (an object with ``load() -> Block``).

        ``index`` names the reservation slot; ``parent`` is the block that
        physically contains the pointer (WFE uses it on the slow path; other
        schemes ignore it).
        """
        raise NotImplementedError

    def retire(self, blk: Block, tid: int) -> None:
        raise NotImplementedError

    def clear(self, tid: int) -> None:
        raise NotImplementedError

    def start_op(self, tid: int) -> None:
        """Bracket the start of a data-structure operation (EBR/IBR)."""

    def transfer(self, src: int, dst: int, tid: int) -> None:
        """Copy the reservation in slot ``src`` to slot ``dst``.

        Safe protection hand-off: while the source slot still holds the
        reservation, duplicating a published pointer (HP) or era (HE/WFE)
        keeps the protected block covered continuously.  Epoch schemes
        protect by bracket, so this is a no-op for them.
        """

    def end_op(self, tid: int) -> None:
        self.clear(tid)

    def reap_thread(self, tid: int) -> None:
        """Clear every reservation a DEAD thread left published.

        Crash tolerance (docs/robustness.md): a thread that dies holding
        a reservation blocks reclamation forever — no ``release_step``
        will ever run on its behalf.  The supervisor calls this only
        after ``Thread.join()`` returns, which is the entire safety
        argument (reap-after-join, stated next to Theorem 4 in
        docs/schemes.md): a joined thread can never again publish,
        dereference, or retire on this tid, and clearing ITS reservations
        cannot un-protect a page any live reader holds, because every
        reader protects pages through its own per-tid slots.

        The default — closing the operation bracket — is exactly the
        quiescent state for every scheme without extra per-thread
        protocol state: EBR announces ``_QUIESCENT``, 2GEIBR stores the
        infinite interval, HE's ``end_op`` routes to ``clear`` which
        writes ``INF_ERA`` into all slots.  WFE overrides to also cancel
        orphaned slow-path requests (the helping protocol's counters must
        stay balanced) and to clear its two special transfer slots.  The
        dead tid's retire list needs no special handling: the batched
        scan is reader-agnostic, so any live thread's
        ``cleanup_batch_all`` drains it.
        """
        self.end_op(tid)

    # -- reclamation --------------------------------------------------------
    def free(self, blk: Block, tid: int) -> None:
        assert not blk.freed, "double free"
        blk.freed = True
        blk._poison_payload()
        self.free_count[tid] += 1

    def flush(self, tid: int) -> None:
        """Best-effort cleanup of this thread's retire list (benchmark drain)."""

    # -- era clock (distributed-eras hooks) ----------------------------------
    def era_clock(self):
        """The scheme's global era/epoch counter (AtomicInt), or None.

        Schemes without a global clock (HP, Leak) return None; the
        distributed-era machinery (``core/distributed_eras.py``) skips them
        — there is nothing to merge across shards.
        """
        return None

    def advance_era(self, tid: int) -> None:
        """Tick the global era/epoch clock once (no-op without a clock).

        WFE overrides this with ``increment_era`` so a drive-by advance
        still honours the helping obligation; epoch schemes bump the epoch
        so grace periods can expire at quiescence.  Used by the engine's
        era-progress-bounded drain and the sharded pool's merge step.
        """

    # -- batched reclamation (era_table.py) ----------------------------------
    #: True when the scheme publishes reservation intervals for the scan
    supports_batched_cleanup: bool = False

    def _reservation_phases(self):
        """Ordered (lo, hi) reservation snapshots the batched scan must check.

        Each phase is a flat pair of int32 arrays (see era_table): a block is
        deletable iff it conflicts with no interval in ANY phase.  Schemes
        whose scan order carries a proof obligation (WFE's Lemmas 4/5)
        override :meth:`_batched_mask` instead.  ``None`` = no batched path.
        """
        return None

    def _batched_mask(self, alloc: np.ndarray, retire: np.ndarray,
                      backend: str, **backend_kwargs) -> Optional[np.ndarray]:
        """Deletable mask for arbitrary lifetime arrays (any thread's, or a
        concatenation of several threads' — the scan is reader-agnostic)."""
        phases = self._reservation_phases()
        if phases is None:
            return None
        mask: Optional[np.ndarray] = None
        for lo, hi in phases:
            m = batched_can_delete(alloc, retire, lo, hi, backend,
                                   **backend_kwargs)
            mask = m if mask is None else (mask & m)
        return mask

    def deletable_mask(self, tid: int, backend: str = "numpy",
                       **backend_kwargs) -> Optional[np.ndarray]:
        """(R,) bool deletable mask over this thread's retire list.

        Returns None when the scheme has no batched path (HP, Leak) — the
        caller should fall back to the scalar ``flush``.
        """
        alloc, retire = self.retire_lists[tid].arrays()
        return self._batched_mask(alloc, retire, backend, **backend_kwargs)

    def cleanup_batch(self, tid: int, backend: str = "numpy",
                      **backend_kwargs) -> int:
        """Vectorized drain of this thread's retire list.  Returns #freed.

        One batched interval scan replaces the per-block O(T·H) Python loop;
        ``backend`` selects scalar (reference) / numpy / torch / cuda.  Falls back
        to the scalar ``flush`` for schemes without era intervals.
        """
        rl = self.retire_lists[tid]
        if len(rl) == 0:
            return 0
        if not self.supports_batched_cleanup:
            # scalar fallback OUTSIDE the list lock: flush() routes to the
            # scheme's own cleanup, which takes the lock itself
            before = self.free_count[tid]
            self.flush(tid)
            return self.free_count[tid] - before
        with rl.lock:
            mask = self.deletable_mask(tid, backend, **backend_kwargs)
            return rl.compact(mask, lambda blk: self.free(blk, tid))

    def cleanup_batch_all(self, backend: str = "numpy",
                          **backend_kwargs) -> int:
        """Fused drain: every thread's retire list in ONE batched scan.

        Concatenates all lifetime arrays so each reservation phase is
        snapshotted once for the whole fleet instead of once per thread.
        List locks are held only for the per-list snapshot and compact —
        never across the scan itself — so a fleet drain cannot stall
        retiring threads for the duration of a (possibly kernel-compiling)
        mask computation.  Safety: each compact is applied only if the
        list's ``version`` is unchanged since its snapshot (a competing
        cleanup reordered it → skip, that cleaner already did the work);
        appends don't bump the version — they land past the snapshotted
        prefix and ``compact`` preserves them.
        """
        if not self.supports_batched_cleanup:
            freed = 0
            for tid in range(self.max_threads):
                before = self.free_count[tid]
                self.flush(tid)
                freed += self.free_count[tid] - before
            return freed
        lists = self.retire_lists
        snaps = [lst.snapshot() for lst in lists]
        sizes = [s[1] for s in snaps]
        if sum(sizes) == 0:
            return 0
        alloc = np.concatenate([s[2] for s in snaps])
        retire = np.concatenate([s[3] for s in snaps])
        mask = self._batched_mask(alloc, retire, backend, **backend_kwargs)
        freed = 0
        off = 0
        for tid, (lst, (version, n, _, _)) in enumerate(zip(lists, snaps)):
            if n:
                with lst.lock:
                    if lst.version == version:
                        freed += lst.compact(
                            mask[off:off + n],
                            lambda blk, t=tid: self.free(blk, t))
            off += n
        return freed

    # -- metrics -------------------------------------------------------------
    def unreclaimed(self) -> int:
        """Retired-but-not-freed blocks across all threads (sampled racily)."""
        return sum(len(lst) for lst in self.retire_lists)

    def stats(self) -> dict:
        return {
            "allocs": sum(self.alloc_count),
            "frees": sum(self.free_count),
            "retires": sum(self.retire_count),
            "unreclaimed": self.unreclaimed(),
        }
