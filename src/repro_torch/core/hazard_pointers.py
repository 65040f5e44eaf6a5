"""Hazard Pointers (HP) — Michael, TPDS 2004.

Readers publish the pointer itself and validate it did not change
(publish-validate loop — lock-free, not wait-free, as the paper's §2.4
discusses).  A retired block is freed once it appears in no published slot.
"""

from __future__ import annotations

from typing import Any, List, Optional, Type

from .atomics import AtomicRef
from .smr_base import Block, SMRScheme

__all__ = ["HazardPointers"]


class HazardPointers(SMRScheme):
    name = "HP"
    wait_free = False
    bounded_memory = True

    def __init__(self, max_threads: int, max_hps: int = 8, cleanup_freq: int = 32):
        super().__init__(max_threads)
        self.max_hps = max_hps
        self.cleanup_freq = max(1, cleanup_freq)
        self.hp: List[List[AtomicRef]] = [
            [AtomicRef(None) for _ in range(max_hps)] for _ in range(max_threads)
        ]
        self.retire_counter = [0] * max_threads

    def alloc_block(self, cls: Type[Block], tid: int, *args: Any, **kwargs: Any) -> Block:
        blk = cls(*args, **kwargs)
        self.alloc_count[tid] += 1
        return blk

    def get_protected(self, ptr: Any, index: int, tid: int, parent: Optional[Block] = None) -> Any:
        slot = self.hp[tid][index]
        ret = ptr.load()
        while True:
            slot.store(ret)
            again = ptr.load()
            if again is ret:
                return ret
            ret = again

    def retire(self, blk: Block, tid: int) -> None:
        self.retire_lists[tid].append(blk)
        self.retire_count[tid] += 1
        if self.retire_counter[tid] % self.cleanup_freq == 0:
            self.cleanup(tid)
        self.retire_counter[tid] += 1

    def cleanup(self, tid: int) -> None:
        # Snapshot all published hazard pointers, then scan the retire list.
        protected = set()
        for i in range(self.max_threads):
            for j in range(self.max_hps):
                p = self.hp[i][j].load()
                if p is not None:
                    protected.add(id(p))
        remaining: List[Block] = []
        with self.retire_lists[tid].lock:  # exclude concurrent batched drains
            for blk in self.retire_lists[tid]:
                if id(blk) in protected:
                    remaining.append(blk)
                else:
                    self.free(blk, tid)
            self.retire_lists[tid][:] = remaining

    def transfer(self, src: int, dst: int, tid: int) -> None:
        self.hp[tid][dst].store(self.hp[tid][src].load())

    def clear(self, tid: int) -> None:
        for j in range(self.max_hps):
            self.hp[tid][j].store(None)

    def flush(self, tid: int) -> None:
        self.cleanup(tid)
