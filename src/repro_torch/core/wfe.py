"""Wait-Free Eras (WFE) — the paper's contribution.  Paper Figure 4.

Faithful port of the pseudo-code, line-comments reference the paper's line
numbers.  Structure:

* ``reservations[tid][0..max_hes+1]`` — ``(era, tag)`` pairs.  Slots
  ``[0, max_hes)`` are the application reservations; slot ``max_hes`` is the
  first *special* reservation (pins the parent block during helping, Lemma 4)
  and slot ``max_hes+1`` the second (pins the dereferenced block while the
  reservation is handed over, Lemma 5).
* ``state[tid][idx]`` — slow-path request cells: ``result`` is an
  ``(ptr, era)`` pair that doubles as the request flag (``ptr == invptr``
  means "help wanted", with the cycle tag in the era slot).
* ``counter_start``/``counter_end`` — F&A'd when a thread enters/leaves the
  slow path; era advancers consult them to know whether helping is needed.

Wait-freedom: ``get_protected`` takes the fast path for ``max_attempts - 1``
iterations, then publishes a request; after that the loop is bounded by the
number of in-flight era advancers (Lemma 1), because every *subsequent*
``increment_era()`` first helps all published requests (Theorems 1-3).
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple, Type

import numpy as np

from .atomics import INF_ERA, INVPTR, AtomicInt, AtomicPair, AtomicRef
from .era_table import EraTable, batched_can_delete
from .smr_base import Block, SMRScheme

__all__ = ["WFE"]


class _StateCell:
    """Per-(thread, index) slow-path request record (paper Fig. 3)."""

    __slots__ = ("result", "era", "pointer")

    def __init__(self) -> None:
        # result: {ptr, era}; initially {nullptr, INF}.  ptr == INVPTR means a
        # pending request whose cycle tag sits in the era component.
        self.result = AtomicPair((None, INF_ERA))
        self.era = AtomicInt(INF_ERA)  # parent's alloc_era for this request
        self.pointer = AtomicRef(None)  # the block** being dereferenced


class WFE(SMRScheme):
    name = "WFE"
    wait_free = True
    bounded_memory = True
    supports_batched_cleanup = True

    def __init__(
        self,
        max_threads: int,
        max_hes: int = 8,
        era_freq: int = 32,
        cleanup_freq: int = 32,
        max_attempts: int = 16,
    ):
        super().__init__(max_threads)
        self.max_hes = max_hes
        self.era_freq = max(1, era_freq)
        self.cleanup_freq = max(1, cleanup_freq)
        # max_attempts == 1 forces the slow path on every call (stress mode,
        # paper §5: "forcing the slow path to be taken all the time").
        self.max_attempts = max(1, max_attempts)
        self.global_era = AtomicInt(1)
        self.counter_start = AtomicInt(0)
        self.counter_end = AtomicInt(0)
        # (era, tag) pairs; two extra special slots per thread.  The era
        # component of every pair write-throughs into the era table, so the
        # batched cleanup scans one contiguous (T, H+2) int32 array.
        self.era_table = EraTable(max_threads, max_hes + 2)
        self.reservations: List[List[AtomicPair]] = [
            [AtomicPair((INF_ERA, 0), mirror_a=self.era_table.mirror_lo(i, j))
             for j in range(max_hes + 2)]
            for i in range(max_threads)
        ]
        self.state: List[List[_StateCell]] = [
            [_StateCell() for _ in range(max_hes)] for _ in range(max_threads)
        ]
        self.alloc_counter = [0] * max_threads
        self.retire_counter = [0] * max_threads
        # telemetry: how often the slow path was taken / served by a helper
        self.slow_path_count = [0] * max_threads
        self.helped_count = [0] * max_threads

    # -- allocation / retirement (paper lines 51-67) ---------------------------
    def alloc_block(self, cls: Type[Block], tid: int, *args: Any, **kwargs: Any) -> Block:
        if self.alloc_counter[tid] % self.era_freq == 0:
            self.increment_era(tid)  # help others before advancing the clock
        self.alloc_counter[tid] += 1
        blk = cls(*args, **kwargs)
        blk.alloc_era = self.global_era.load()
        self.alloc_count[tid] += 1
        return blk

    def retire(self, blk: Block, tid: int) -> None:
        blk.retire_era = self.global_era.load()
        self.retire_lists[tid].append(blk)
        self.retire_count[tid] += 1
        if self.retire_counter[tid] % self.cleanup_freq == 0:
            if blk.retire_era == self.global_era.load():
                self.increment_era(tid)
            self.cleanup(tid)
        self.retire_counter[tid] += 1

    # -- era advancement with helping (paper lines 90-99) ----------------------
    def increment_era(self, tid: int) -> None:
        ce = self.counter_end.load()  # read end first: may only overestimate
        cs = self.counter_start.load()
        if cs - ce != 0:
            for i in range(self.max_threads):
                for j in range(self.max_hes):
                    if self.state[i][j].result.load()[0] is INVPTR:
                        self.help_thread(i, j, tid)
        self.global_era.fa_add(1)

    def era_clock(self):
        return self.global_era

    def advance_era(self, tid: int) -> None:
        self.increment_era(tid)  # drive-by advances still help first

    # -- protected dereference (paper lines 12-50) ------------------------------
    def get_protected(self, ptr: Any, index: int, tid: int, parent: Optional[Block] = None) -> Any:
        resv = self.reservations[tid][index]
        prev_era = resv.load_a()
        # Fast path: identical to Hazard Eras, but bounded (lines 16-24).
        for _ in range(self.max_attempts - 1):
            ret = ptr.load()
            new_era = self.global_era.load()
            if prev_era == new_era:
                return ret
            resv.store_a(new_era)
            prev_era = new_era

        # Slow path: request helping (lines 26-50).
        self.slow_path_count[tid] += 1
        if parent is None:
            alloc_era = INF_ERA  # topmost references have no parent (line 26)
        else:
            alloc_era = parent.alloc_era
        self.counter_start.fa_add(1)  # line 30
        st = self.state[tid][index]
        st.pointer.store(ptr)
        st.era.store(alloc_era)
        tag = resv.load_b()
        st.result.store((INVPTR, tag))  # publish request (line 33)

        while True:  # bounded by # of in-flight era advancers (Lemma 1)
            ret = ptr.load()
            new_era = self.global_era.load()
            if prev_era == new_era and st.result.wcas((INVPTR, tag), (None, INF_ERA)):
                # Self-completed; cancel the request (lines 37-41).
                resv.store_b(tag + 1)
                self.counter_end.fa_add(1)
                return ret
            # Keep our reservation current; failure means a helper already
            # produced output and updated the entry (line 45).
            resv.wcas((prev_era, tag), (new_era, tag))
            prev_era = new_era
            res_ptr = st.result.load()[0]
            if res_ptr is not INVPTR:
                break  # a helper produced the output (line 49)

        # Adopt the helper's output (lines 50+): result = {ptr, era}.
        res_ptr, res_era = st.result.load()
        resv.store_a(res_era)  # may rewrite the value the helper already set
        resv.store_b(tag + 1)
        self.counter_end.fa_add(1)
        self.helped_count[tid] += 1
        return res_ptr

    # -- helping (paper lines 100-133) ------------------------------------------
    def help_thread(self, i: int, j: int, tid: int) -> None:
        st = self.state[i][j]
        res: Tuple[Any, Any] = st.result.load()
        if res[0] is not INVPTR:
            return  # request already served / cancelled (line 103)
        era = st.era.load()
        special1 = self.reservations[tid][self.max_hes]
        special2 = self.reservations[tid][self.max_hes + 1]
        special1.store_a(era)  # pin the parent block (line 107, Lemma 4)
        try:
            ptr = st.pointer.load()
            tag = self.reservations[i][j].load_b()
            if tag != res[1]:
                return  # stale request: state fields not from this cycle (line 110)
            # All state data were read consistently.
            prev_era = self.global_era.load()
            while True:  # bounded by # of in-flight era advancers (Lemma 2)
                special2.store_a(prev_era)  # pin the dereferenced block (Lemma 5)
                ret_ptr = ptr.load()
                new_era = self.global_era.load()
                if prev_era == new_era:
                    if st.result.wcas(res, (ret_ptr, new_era)):
                        # Hand the reservation over to thread i (lines 120-125,
                        # at most 2 iterations — Lemma 3).
                        while True:
                            old = self.reservations[i][j].load()
                            if old[1] != tag:
                                break
                            if self.reservations[i][j].wcas(old, (new_era, tag + 1)):
                                break
                    break
                prev_era = new_era
                if st.result.load() != res:
                    break  # requester self-completed (line 130)
            special2.store_a(INF_ERA)
        finally:
            special1.store_a(INF_ERA)  # line 133

    # -- reclamation (paper cleanup(), Theorem 4) --------------------------------
    def can_delete(self, blk: Block, js: int, je: int) -> bool:
        for i in range(self.max_threads):
            row = self.reservations[i]
            for j in range(js, je):
                era = row[j].load_a()
                if era != INF_ERA and blk.alloc_era <= era <= blk.retire_era:
                    return False
        return True

    def cleanup(self, tid: int) -> None:
        remaining: List[Block] = []
        mh = self.max_hes
        with self.retire_lists[tid].lock:  # exclude concurrent batched drains
            for blk in self.retire_lists[tid]:
                ce = self.counter_end.load()
                # Normal reservations first, then special-1 (Lemma 4's order).
                if not (self.can_delete(blk, 0, mh) and self.can_delete(blk, mh, mh + 1)):
                    remaining.append(blk)
                    continue
                # If any slow path was active, check special-2 then re-check the
                # normal reservations (Lemma 5's opposite order).
                if ce == self.counter_start.load() or (
                    self.can_delete(blk, mh + 1, mh + 2) and self.can_delete(blk, 0, mh)
                ):
                    self.free(blk, tid)
                else:
                    remaining.append(blk)
            self.retire_lists[tid][:] = remaining

    def _batched_mask(self, alloc: np.ndarray, retire: np.ndarray,
                      backend: str, **backend_kwargs) -> np.ndarray:
        """Batched can_delete with the Theorem-4 two-phase scan order.

        Scan the normal reservation columns, then special-1 (Lemma 4's
        order); if any slow path was in flight, additionally scan special-2
        and RE-snapshot the normal columns (Lemma 5's opposite order).  Each
        ``snapshot()`` re-reads the live mirror, preserving the scalar
        cleanup's happens-before structure — only the per-block Python loop
        is replaced by one vectorized scan over the whole retire list.
        """
        if len(alloc) == 0:
            return np.zeros(0, bool)
        mh = self.max_hes
        scan = lambda js, je: batched_can_delete(  # noqa: E731
            alloc, retire, *self.era_table.snapshot(js, je),
            backend, **backend_kwargs)
        ce = self.counter_end.load()
        ok = scan(0, mh) & scan(mh, mh + 1)
        if ce != self.counter_start.load():
            ok &= scan(mh + 1, mh + 2)
            ok &= scan(0, mh)
        return ok

    def transfer(self, src: int, dst: int, tid: int) -> None:
        # Copy the era only; each slot keeps its own slow-path cycle tag.
        self.reservations[tid][dst].store_a(self.reservations[tid][src].load_a())

    def clear(self, tid: int) -> None:
        # Reset eras only; tags must persist across slow-path cycles.
        for j in range(self.max_hes):
            self.reservations[tid][j].store_a(INF_ERA)

    def reap_thread(self, tid: int) -> None:
        """Clear a DEAD (joined) thread's reservations AND its slow-path
        protocol state (reap-after-join safety argument: docs/schemes.md
        next to Theorem 4, docs/robustness.md for the full taxonomy).

        Beyond the base ``end_op``, WFE owes the helping protocol two
        things a dead thread can no longer deliver:

        * a published-but-unserved request (``result.ptr == INVPTR``)
          would make ``counter_start != counter_end`` FOREVER, so every
          future ``increment_era`` would rescan and re-help the fleet —
          cancel it exactly as the dead requester would have
          (lines 37-41): retract the request, bump the cycle tag, F&A
          ``counter_end``.  If a live helper wins the ``wcas`` race and
          serves the request first, the requester-side bookkeeping we
          perform is identical to the dead thread adopting the output,
          so the counters balance on both branches.
        * ``clear`` resets only the application slots ``[0, max_hes)``;
          a thread that died while HELPING someone may have left an era
          in its two special slots, which would pin blocks forever — so
          sweep all ``max_hes + 2`` slots.

        One orphan is irrecoverable by design: a thread that died after
        a helper served its request but before adopting the result
        leaves ``counter_end`` one short.  That cannot be detected from
        the cell (a served-and-adopted cell looks identical), and it is
        benign: the imbalance only makes future ``increment_era`` calls
        take the (correct, wait-free) helping scan, never blocks
        reclamation.  Our crash points all sit outside ``get_protected``,
        so the window is unreachable for injected faults.
        """
        for j in range(self.max_hes):
            st = self.state[tid][j]
            res = st.result.load()
            if res[0] is INVPTR:
                st.result.wcas(res, (None, INF_ERA))
                self.reservations[tid][j].store_b(res[1] + 1)
                self.counter_end.fa_add(1)
        for j in range(self.max_hes + 2):
            self.reservations[tid][j].store_a(INF_ERA)

    def flush(self, tid: int) -> None:
        self.cleanup(tid)

    # -- telemetry ----------------------------------------------------------------
    def stats(self) -> dict:
        s = super().stats()
        s["slow_paths"] = sum(self.slow_path_count)
        s["helped"] = sum(self.helped_count)
        s["global_era"] = self.global_era.load()
        return s
