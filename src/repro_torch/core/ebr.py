"""Epoch-Based Reclamation (EBR) — Fraser 2004 / RCU lineage.

Three-epoch scheme: a thread announces the global epoch on ``start_op`` and
goes quiescent on ``end_op``.  A retired block is freed once every active
thread has announced an epoch strictly newer than the block's retire epoch
(two grace periods).  Fast, but **blocking**: one stalled reader pins every
retired block forever — the unbounded-memory behaviour the paper's §5
experiments expose and that ``benchmarks/unreclaimed.py`` reproduces.
"""

from __future__ import annotations

from typing import Any, List, Optional, Type

import numpy as np

from .atomics import INF_ERA, MIRROR_INF, AtomicInt
from .era_table import EraTable
from .smr_base import Block, SMRScheme

__all__ = ["EBR"]

_QUIESCENT = INF_ERA


class EBR(SMRScheme):
    name = "EBR"
    wait_free = False
    bounded_memory = False  # a stalled thread blocks reclamation
    supports_batched_cleanup = True

    def __init__(self, max_threads: int, epoch_freq: int = 32, cleanup_freq: int = 32):
        super().__init__(max_threads)
        self.epoch_freq = max(1, epoch_freq)
        self.cleanup_freq = max(1, cleanup_freq)
        self.global_epoch = AtomicInt(1)
        # announcements mirror into the era table for the batched scan
        self.era_table = EraTable(max_threads, 1)
        self.announce: List[AtomicInt] = [
            AtomicInt(_QUIESCENT, mirror=self.era_table.mirror_lo(i, 0))
            for i in range(max_threads)
        ]
        self.alloc_counter = [0] * max_threads
        self.retire_counter = [0] * max_threads

    def start_op(self, tid: int) -> None:
        self.announce[tid].store(self.global_epoch.load())

    def end_op(self, tid: int) -> None:
        self.announce[tid].store(_QUIESCENT)

    def alloc_block(self, cls: Type[Block], tid: int, *args: Any, **kwargs: Any) -> Block:
        if self.alloc_counter[tid] % self.epoch_freq == 0:
            self.global_epoch.fa_add(1)
        self.alloc_counter[tid] += 1
        blk = cls(*args, **kwargs)
        self.alloc_count[tid] += 1
        return blk

    def get_protected(self, ptr: Any, index: int, tid: int, parent: Optional[Block] = None) -> Any:
        return ptr.load()  # the epoch bracket is the protection

    def retire(self, blk: Block, tid: int) -> None:
        blk.retire_era = self.global_epoch.load()
        self.retire_lists[tid].append(blk)
        self.retire_count[tid] += 1
        if self.retire_counter[tid] % self.cleanup_freq == 0:
            self.cleanup(tid)
        self.retire_counter[tid] += 1

    def cleanup(self, tid: int) -> None:
        min_active = self.global_epoch.load()
        for i in range(self.max_threads):
            e = self.announce[i].load()
            if e != _QUIESCENT and e < min_active:
                min_active = e
        remaining: List[Block] = []
        with self.retire_lists[tid].lock:  # exclude concurrent batched drains
            for blk in self.retire_lists[tid]:
                # Freed only after two grace periods beyond the retire epoch.
                if blk.retire_era + 2 <= min_active:
                    self.free(blk, tid)
                else:
                    remaining.append(blk)
            self.retire_lists[tid][:] = remaining

    def clear(self, tid: int) -> None:
        pass  # protection is the epoch bracket, not per-pointer state

    def era_clock(self):
        return self.global_epoch

    def advance_era(self, tid: int) -> None:
        self.global_epoch.fa_add(1)

    def flush(self, tid: int) -> None:
        self.global_epoch.fa_add(1)
        self.cleanup(tid)

    def cleanup_batch(self, tid: int, backend: str = "numpy",
                      **backend_kwargs) -> int:
        # like flush: drains must advance the epoch or the grace-period
        # condition (retire + 2 <= min_active) can never become true
        self.global_epoch.fa_add(1)
        return super().cleanup_batch(tid, backend, **backend_kwargs)

    def cleanup_batch_all(self, backend: str = "numpy",
                          **backend_kwargs) -> int:
        self.global_epoch.fa_add(1)
        return super().cleanup_batch_all(backend, **backend_kwargs)

    def _reservation_phases(self):
        # Grace-period rule as an interval scan: a block stays iff some
        # announcement e (or the global epoch itself) has e < retire + 2,
        # i.e. the pseudo-interval [e - 1, ∞) overlaps [*, retire_era].
        ann, _ = self.era_table.snapshot()
        ge = self.global_epoch.load()
        lo = np.append(ann, min(ge, MIRROR_INF - 1)).astype(np.int32)
        np.subtract(lo, 1, out=lo, where=lo != MIRROR_INF)
        hi = np.full_like(lo, MIRROR_INF - 1)
        return [(lo, hi)]
