"""Hazard Eras (HE) — Ramalhete & Correia, SPAA'17.  Paper Figure 1.

The lock-free baseline that WFE extends.  Blocks carry
``[alloc_era, retire_era]``; readers publish era reservations; a block is
reclaimable iff its lifetime overlaps no published reservation.
``get_protected`` loops until the global era stops moving — the (only)
lock-free loop WFE later bounds.

Includes the race fix the paper mentions (§5): ``retire()`` re-reads the
global era after stamping ``retire_era`` and only advances the clock when the
stamp is still current.
"""

from __future__ import annotations

from typing import Any, List, Optional, Type

from .atomics import INF_ERA, AtomicInt
from .era_table import EraTable
from .smr_base import Block, SMRScheme

__all__ = ["HazardEras"]


class HazardEras(SMRScheme):
    name = "HE"
    wait_free = False
    bounded_memory = True
    supports_batched_cleanup = True

    def __init__(
        self,
        max_threads: int,
        max_hes: int = 8,
        era_freq: int = 32,
        cleanup_freq: int = 32,
    ):
        super().__init__(max_threads)
        self.max_hes = max_hes
        self.era_freq = max(1, era_freq)
        self.cleanup_freq = max(1, cleanup_freq)
        self.global_era = AtomicInt(1)
        # reservations[tid][j] = era (INF_ERA when unreserved), mirrored into
        # the era table for the batched cleanup scan
        self.era_table = EraTable(max_threads, max_hes)
        self.reservations: List[List[AtomicInt]] = [
            [AtomicInt(INF_ERA, mirror=self.era_table.mirror_lo(i, j))
             for j in range(max_hes)]
            for i in range(max_threads)
        ]
        self.alloc_counter = [0] * max_threads
        self.retire_counter = [0] * max_threads

    # -- paper Fig. 1 --------------------------------------------------------
    def alloc_block(self, cls: Type[Block], tid: int, *args: Any, **kwargs: Any) -> Block:
        if self.alloc_counter[tid] % self.era_freq == 0:
            self.global_era.fa_add(1)
        self.alloc_counter[tid] += 1
        blk = cls(*args, **kwargs)
        blk.alloc_era = self.global_era.load()
        self.alloc_count[tid] += 1
        return blk

    def get_protected(self, ptr: Any, index: int, tid: int, parent: Optional[Block] = None) -> Any:
        prev_era = self.reservations[tid][index].load()
        while True:
            ret = ptr.load()
            new_era = self.global_era.load()
            if prev_era == new_era:
                return ret
            self.reservations[tid][index].store(new_era)
            prev_era = new_era

    def retire(self, blk: Block, tid: int) -> None:
        blk.retire_era = self.global_era.load()
        self.retire_lists[tid].append(blk)
        self.retire_count[tid] += 1
        if self.retire_counter[tid] % self.cleanup_freq == 0:
            if blk.retire_era == self.global_era.load():
                self.global_era.fa_add(1)
            self.cleanup(tid)
        self.retire_counter[tid] += 1

    def transfer(self, src: int, dst: int, tid: int) -> None:
        self.reservations[tid][dst].store(self.reservations[tid][src].load())

    def era_clock(self):
        return self.global_era

    def advance_era(self, tid: int) -> None:
        self.global_era.fa_add(1)

    def clear(self, tid: int) -> None:
        for j in range(self.max_hes):
            self.reservations[tid][j].store(INF_ERA)

    # -- reclamation ----------------------------------------------------------
    def can_delete(self, blk: Block, js: int, je: int) -> bool:
        for i in range(self.max_threads):
            row = self.reservations[i]
            for j in range(js, je):
                era = row[j].load()
                if era != INF_ERA and blk.alloc_era <= era <= blk.retire_era:
                    return False
        return True

    def cleanup(self, tid: int) -> None:
        remaining: List[Block] = []
        with self.retire_lists[tid].lock:  # exclude concurrent batched drains
            for blk in self.retire_lists[tid]:
                if self.can_delete(blk, 0, self.max_hes):
                    self.free(blk, tid)
                else:
                    remaining.append(blk)
            self.retire_lists[tid][:] = remaining

    def flush(self, tid: int) -> None:
        self.cleanup(tid)

    def _reservation_phases(self):
        # HE's scan has no ordering obligation: one snapshot of all slots
        return [self.era_table.snapshot()]
