"""2GEIBR — Interval-Based Reclamation, Wen et al., PPoPP'18 (tagless version).

Each thread keeps one reservation *interval* ``[lower, upper]``:
``start_op`` snaps both ends to the current epoch, every protected
dereference extends ``upper`` in a validate loop (lock-free, like HE).
Blocks are stamped with ``birth_epoch`` at allocation and ``retire_era`` at
retirement; a block is reclaimable iff ``[birth, retire]`` overlaps no active
interval.  The paper notes WFE's slow-path construction applies to this
variant as well (§2.4) — the fast path here is exactly HE's loop on a single
two-word reservation.
"""

from __future__ import annotations

from typing import Any, List, Optional, Type

from .atomics import INF_ERA, AtomicInt, AtomicPair
from .era_table import EraTable
from .smr_base import Block, SMRScheme

__all__ = ["IBR2GE"]


class IBR2GE(SMRScheme):
    name = "2GEIBR"
    wait_free = False
    bounded_memory = True
    supports_batched_cleanup = True
    # block lifetime = [birth_epoch, retire_era] (the scheme's own stamping)
    retire_era_fields = ("birth_epoch", "retire_era")

    def __init__(self, max_threads: int, epoch_freq: int = 32, cleanup_freq: int = 32):
        super().__init__(max_threads)
        self.epoch_freq = max(1, epoch_freq)
        self.cleanup_freq = max(1, cleanup_freq)
        self.global_epoch = AtomicInt(1)
        # (lower, upper); (INF, INF) when inactive.  Both bounds mirror into
        # a true interval era table (lo and hi arrays) for the batched scan.
        self.era_table = EraTable(max_threads, 1, interval=True)
        self.intervals: List[AtomicPair] = [
            AtomicPair((INF_ERA, INF_ERA),
                       mirror_a=self.era_table.mirror_lo(i, 0),
                       mirror_b=self.era_table.mirror_hi(i, 0))
            for i in range(max_threads)
        ]
        self.alloc_counter = [0] * max_threads
        self.retire_counter = [0] * max_threads

    def start_op(self, tid: int) -> None:
        e = self.global_epoch.load()
        self.intervals[tid].store((e, e))

    def end_op(self, tid: int) -> None:
        self.intervals[tid].store((INF_ERA, INF_ERA))

    def alloc_block(self, cls: Type[Block], tid: int, *args: Any, **kwargs: Any) -> Block:
        if self.alloc_counter[tid] % self.epoch_freq == 0:
            self.global_epoch.fa_add(1)
        self.alloc_counter[tid] += 1
        blk = cls(*args, **kwargs)
        blk.birth_epoch = self.global_epoch.load()
        self.alloc_count[tid] += 1
        return blk

    def get_protected(self, ptr: Any, index: int, tid: int, parent: Optional[Block] = None) -> Any:
        cell = self.intervals[tid]
        prev_upper = cell.load_b()
        while True:
            ret = ptr.load()
            e = self.global_epoch.load()
            if prev_upper == e:
                return ret
            cell.store_b(e)  # extend the interval's upper bound
            prev_upper = e

    def retire(self, blk: Block, tid: int) -> None:
        blk.retire_era = self.global_epoch.load()
        self.retire_lists[tid].append(blk)
        self.retire_count[tid] += 1
        if self.retire_counter[tid] % self.cleanup_freq == 0:
            self.cleanup(tid)
        self.retire_counter[tid] += 1

    def cleanup(self, tid: int) -> None:
        snapshot = [self.intervals[i].load() for i in range(self.max_threads)]
        remaining: List[Block] = []
        with self.retire_lists[tid].lock:  # exclude concurrent batched drains
            for blk in self.retire_lists[tid]:
                conflict = False
                for lo, hi in snapshot:
                    if lo == INF_ERA:
                        continue
                    # interval [lo, hi] vs lifetime [birth, retire]
                    if not (blk.retire_era < lo or blk.birth_epoch > hi):
                        conflict = True
                        break
                if conflict:
                    remaining.append(blk)
                else:
                    self.free(blk, tid)
            self.retire_lists[tid][:] = remaining

    def clear(self, tid: int) -> None:
        pass  # the interval bracket is the protection

    def era_clock(self):
        return self.global_epoch

    def advance_era(self, tid: int) -> None:
        self.global_epoch.fa_add(1)

    def flush(self, tid: int) -> None:
        self.cleanup(tid)

    def _reservation_phases(self):
        # one snapshot of the (lo, hi) interval per thread; conflict iff
        # lo <= retire and birth <= hi — exactly the scalar test above
        return [self.era_table.snapshot()]
