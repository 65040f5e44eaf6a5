"""Era-stamped device block pool, reclaimed with one of the paper's SMR
schemes: WFE by default, or Crystalline, HE, EBR or 2GEIBR (``scheme=``).

The SMR mapping (DESIGN.md §2.1):

* **blocks** = fixed-size KV-cache pages in a device-resident pool; a
  ``KVBlock`` is the reclamation header (paper Fig. 2's ``block header``)
  carrying ``alloc_era``/``retire_era`` and the pool slot index;
* **readers** = in-flight device steps: before dispatch, the scheduler
  publishes ONE era reservation per step (``protect_step``) — an era
  reservation covers *every* block whose lifetime spans it (this interval
  property is exactly why Hazard Eras beats Hazard Pointers here: a step
  touching 10k blocks needs one slot, not 10k);
* **reclaimers** = scheduler threads retiring blocks on request
  completion/eviction; WFE's wait-freedom bounds their latency
  (``retire``/``alloc_block``/``get_protected`` are all wait-free bounded)
  — a stalled completion thread can neither block admission nor make pool
  memory unbounded;
* ``cleanup()`` uses the scheme's batched ``cleanup_batch()`` (backed by
  ``core/era_table.py``) when the retire list is large: the paper's
  R×(T·H) interval scan is the reclamation hot path and maps to a single
  NumPy compare-reduce or the CUDA ``era_scan`` kernel
  (``cleanup_backend`` / ``use_kernel`` select the backend).

Free-slot recycling is a Treiber stack of fresh cons cells (identity-CAS,
so ABA-free in Python).  Note the paper's scope: *reclamation* is
wait-free; free-list pop (allocation) is lock-free, same as malloc in the
paper's own evaluation.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional

from repro_torch.core import Block, make_scheme
from repro_torch.core.atomics import INF_ERA, AtomicInt, AtomicRef, PtrView

__all__ = ["KVBlock", "BlockPool", "PoolExhausted"]


class PoolExhausted(RuntimeError):
    """No free blocks even after reclamation — admission must back off."""


class KVBlock(Block):
    """Reclamation header for one pool slot (paper Fig. 2).

    ``sharers`` counts logical owners of the slot — the allocating
    request plus, under prefix caching, every other request table and
    cache entry aliasing it.  The count starts at 1 (the allocator) and
    moves only by atomic fetch-and-add; the 1 -> 0 transition is observed
    by exactly one releaser, which retires the block (last-sharer-retires,
    see ``BlockPool.release_block``).
    """

    __slots__ = ("index", "on_free", "sharers")

    def __init__(self, index: int, on_free: Optional[Callable] = None):
        super().__init__()
        self.index = index
        self.on_free = on_free
        self.sharers = AtomicInt(1)

    def _poison_payload(self) -> None:
        # Returning the slot to the free list IS the poison: any later read
        # through a stale table would observe recycled data in tests.
        if self.on_free is not None:
            self.on_free(self.index)
            self.on_free = None


class _Cell:
    __slots__ = ("value", "next")

    def __init__(self, value, nxt):
        self.value = value
        self.next = nxt


class _FreeStack:
    """Treiber stack of slot indices (fresh cells -> no ABA)."""

    def __init__(self, values):
        head = None
        for v in values:
            head = _Cell(v, head)
        self._head = AtomicRef(head)
        self._approx = len(list(values)) if not isinstance(values, range) else len(values)

    def push(self, value) -> None:
        while True:
            h = self._head.load()
            if self._head.cas(h, _Cell(value, h)):
                return

    def pop(self):
        while True:
            h = self._head.load()
            if h is None:
                return None
            if self._head.cas(h, h.next):
                return h.value


class _EpochNode(Block):
    """Never-retired anchor; get_protected on it publishes the current era."""

    __slots__ = ()


class BlockPool:
    """SMR-managed pool of ``n_blocks`` KV pages (WFE unless ``scheme`` says
    otherwise; HP is refused).

    The device arrays themselves (one (n_blocks, block_size, KH, D) pool per
    layer) are owned by the serving engine; this class owns slot lifetime.
    """

    def __init__(self, n_blocks: int, *, scheme: str = "WFE",
                 max_threads: int = 16, max_hes: int = 8,
                 cleanup_backend: str = "numpy", use_kernel: bool = False,
                 vectorized_threshold: int = 64, first_block: int = 0,
                 **smr_kwargs):
        self.n_blocks = n_blocks
        # slot ids live in [first_block, first_block + n_blocks): a sharded
        # pool gives each shard a disjoint range of the one device pool
        self.first_block = first_block
        # reclamation backend policy: retire lists below the threshold take
        # the scalar flush (batch setup isn't worth it), larger ones the
        # selected batched backend; use_kernel=True upgrades numpy -> cuda
        self.cleanup_backend = "cuda" if use_kernel else cleanup_backend
        self.vectorized_threshold = vectorized_threshold
        self._drain_lock = threading.Lock()
        if scheme == "HP":
            # the paper's motivating contrast: an HP slot protects ONE
            # pointer, so a step snapshot naming thousands of blocks cannot
            # be covered by one reservation — era/interval schemes can.
            raise ValueError(
                "Hazard Pointers cannot protect a step snapshot with one "
                "reservation; use an era scheme (WFE/HE) or epoch scheme")
        if scheme in ("WFE", "HE", "Crystalline"):  # era-slot schemes
            smr_kwargs = {"max_hes": max_hes, **smr_kwargs}
        if scheme in ("EBR", "2GEIBR"):  # epoch-frequency naming differs
            smr_kwargs = {("epoch_freq" if k == "era_freq" else k): v
                          for k, v in smr_kwargs.items()}
        self.smr = make_scheme(scheme, max_threads=max_threads, **smr_kwargs)
        self._free = _FreeStack(
            range(first_block + n_blocks - 1, first_block - 1, -1))
        self._free_count = n_blocks  # advisory (racy) gauge
        self._lock_gauge = threading.Lock()
        # step-epoch anchor: one reservation protects a whole dispatched step
        self._epoch_ref = AtomicRef(_EpochNode())
        self._epoch_view = PtrView(self._epoch_ref)
        # fault-injection gate for alloc_blocks (serve/faults.py): called
        # as hook(n, tid), may raise PoolExhausted.  None = disabled.
        self._fault_alloc: Optional[Callable[[int, int], None]] = None

    # ---------------------------------------------------------- threads
    def register_thread(self) -> int:
        return self.smr.register_thread()

    # ---------------------------------------------------------- allocation
    def alloc(self, tid: int, shard: Optional[int] = None) -> KVBlock:
        """Wait-free-reclaimed allocation of one pool slot.

        ``shard`` is accepted for interface parity with the sharded pool
        (an unsharded pool is its own single shard).
        """
        return self.alloc_blocks(1, tid)[0]

    def alloc_blocks(self, n: int, tid: int,
                     shard: Optional[int] = None) -> List[KVBlock]:
        """Bulk allocation of ``n`` pool slots — all or nothing.

        A chunked-prefill step materializes many pages at once; grabbing
        them in one call amortizes the free-stack traffic and, critically,
        is atomic under pressure: if fewer than ``n`` slots are free even
        after draining our retire list, every popped slot is pushed back
        (the raw indices were never wrapped in a reclamation header, so
        the rollback is a plain stack push) and ``PoolExhausted`` is
        raised — the scheduler then evicts and retries, or shrinks the
        chunk to the pages the request already owns.
        """
        if self._fault_alloc is not None:
            # injected failure surfaces as an ordinary exhaustion, so the
            # caller's recovery ladder (evict / shrink chunk) is exercised
            self._fault_alloc(n, tid)
        idxs: List[int] = []
        for _ in range(n):
            idx = self._free.pop()
            if idx is None:
                # drain our own retire list, then retry once
                self.cleanup(tid)
                idx = self._free.pop()
            if idx is None:
                for i in idxs:
                    self._free.push(i)
                raise PoolExhausted(
                    f"pool of {self.n_blocks} blocks exhausted "
                    f"({len(idxs)} of {n} requested slots free)")
            idxs.append(idx)
        blks = [self.smr.alloc_block(KVBlock, tid, i, self._on_free)
                for i in idxs]
        with self._lock_gauge:
            self._free_count -= n
        return blks

    def _on_free(self, index: int) -> None:
        self._free.push(index)
        with self._lock_gauge:
            self._free_count += 1

    def retire(self, blk: KVBlock, tid: int) -> None:
        self.smr.retire(blk, tid)

    # ------------------------------------------------- shared ownership
    def add_sharer(self, blk: KVBlock) -> None:
        """Add one logical owner (a table alias or prefix-cache entry).

        Callers must already hold a reference (the count is provably > 0
        at the increment), so no 0 -> 1 resurrection can race a retire.
        """
        blk.sharers.fa_add(1)

    def release_block(self, blk: KVBlock, tid: int) -> bool:
        """Drop one sharer reference; the LAST sharer retires the block.

        One wait-free fetch-and-add per release: exactly one releaser
        observes the 1 -> 0 transition and calls ``retire`` — concurrent
        releases can neither double-retire nor leak.  Readers still inside
        an era reservation that covers the block remain safe: the refcount
        decides when the block is logically dead, the scheme's interval
        scan decides when its slot is physically reusable.  Returns True
        iff THIS release retired the block (cache eviction uses it to
        tell progress from a no-op reference drop).
        """
        if blk.sharers.fa_add(-1) == 1:
            self.retire(blk, tid)
            return True
        return False

    # ------------------------------------------------- SMR-managed metadata
    def alloc_node(self, cls, tid: int, *args, shard: Optional[int] = None,
                   **kwargs) -> Block:
        """Allocate a non-pool SMR node (e.g. a block-table version).

        Routed through the pool so sharded pools can pin the node to one
        shard's clock (a block must retire where it was born); ``shard`` is
        accepted for interface parity and ignored here.
        """
        return self.smr.alloc_block(cls, tid, *args, **kwargs)

    def retire_node(self, blk: Block, tid: int) -> None:
        self.smr.retire(blk, tid)

    # ---------------------------------------------------------- protection
    def protect_step(self, slot: int, tid: int,
                     shard: Optional[int] = None) -> None:
        """Publish an era reservation covering every block alive now.

        Call before dispatching a device step; the returned reservation
        guards all pool slots named by any block table snapshot read AFTER
        this call (interval property, DESIGN.md §2.1).
        """
        self.smr.get_protected(self._epoch_view, slot, tid)

    def release_step(self, slot: int, tid: int,
                     shard: Optional[int] = None) -> None:
        """Clear one step's reservation (device step completed).

        ``shard`` is accepted for interface parity (single-shard pool).
        """
        # Per-slot clear: write the empty value for this scheme's slot kind
        # (WFE: (era, tag) pair keeps its tag; HE: era int; HP: pointer).
        smr = self.smr
        if not hasattr(smr, "reservations"):
            smr.end_op(tid)  # EBR-style schemes have no per-slot state
            return
        row = smr.reservations[tid][slot]
        if hasattr(row, "store_a"):  # WFE (era, tag) pair
            row.store_a(INF_ERA)
        elif smr.name in ("HE", "2GEIBR"):  # era/epoch integer slot
            row.store(INF_ERA)
        else:  # HP-style pointer slot
            row.store(None)

    def reap_thread(self, tid: int) -> None:
        """Clear a DEAD (joined) worker's reservations so reclamation can
        proceed without it (crash tolerance, docs/robustness.md).

        Must only be called after the thread is joined: the safety
        argument (docs/schemes.md, next to Theorem 4) rests entirely on
        the dead tid never publishing or dereferencing again.  The tid is
        quarantined by the caller — it is never handed to another worker.
        """
        self.smr.reap_thread(tid)

    # ---------------------------------------------------------- reclamation
    def cleanup(self, tid: int, *, shard: Optional[int] = None,
                vectorized_threshold: Optional[int] = None,
                use_kernel: Optional[bool] = None,
                backend: Optional[str] = None) -> int:
        """Drain this thread's retire list.  Returns the number freed.

        Short lists take the scheme's scalar ``flush`` (batch setup costs
        more than it saves); longer ones take ``cleanup_batch`` with the
        pool's configured backend.  The batched WFE path preserves
        Theorem 4's scan order (see ``WFE.deletable_mask``).
        """
        smr = self.smr
        threshold = (self.vectorized_threshold if vectorized_threshold is None
                     else vectorized_threshold)
        if backend is None:
            backend = ("cuda" if use_kernel else
                       self.cleanup_backend if use_kernel is None else "numpy")
        before = smr.free_count[tid]
        if len(smr.retire_lists[tid]) < threshold or \
                not smr.supports_batched_cleanup:
            smr.flush(tid)
            return smr.free_count[tid] - before
        return smr.cleanup_batch(tid, backend)

    def cleanup_all(self, *, backend: Optional[str] = None) -> int:
        """Cross-thread batched drain: EVERY thread's retire list, one scan.

        Intended for quiescent points — the serve loop's idle ticks and
        engine shutdown — where one fused scan (all lists concatenated,
        each reservation phase snapshotted once for the whole fleet) beats
        per-thread drains.  Safe concurrently with owner threads retiring
        and cleaning: every cleanup path holds the per-list lock
        (``ArrayRetireList.lock``), and this pool-level lock additionally
        serializes whole-fleet drains against each other.
        """
        backend = self.cleanup_backend if backend is None else backend
        with self._drain_lock:
            return self.smr.cleanup_batch_all(backend)

    def advance_eras(self, tid: int) -> None:
        """Tick the scheme's era/epoch clock (drain-progress helper)."""
        self.smr.advance_era(tid)

    # ---------------------------------------------------------- metrics
    @property
    def free_blocks(self) -> int:
        return self._free_count

    def unreclaimed(self) -> int:
        return self.smr.unreclaimed()

    def stats(self) -> dict:
        s = self.smr.stats()
        s["free_blocks"] = self._free_count
        s["n_blocks"] = self.n_blocks
        return s

