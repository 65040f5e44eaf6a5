"""Leak Memory — the paper's no-reclamation baseline (§5).

Retired blocks are never freed; provides the zero-overhead upper bound for
throughput comparisons and the unbounded lower bound for memory efficiency.
"""

from __future__ import annotations

from typing import Any, Optional, Type

from .smr_base import Block, SMRScheme

__all__ = ["LeakMemory"]


class LeakMemory(SMRScheme):
    name = "Leak"
    wait_free = True  # vacuously: every op is a constant number of steps
    bounded_memory = False

    def alloc_block(self, cls: Type[Block], tid: int, *args: Any, **kwargs: Any) -> Block:
        blk = cls(*args, **kwargs)
        self.alloc_count[tid] += 1
        return blk

    def get_protected(self, ptr: Any, index: int, tid: int, parent: Optional[Block] = None) -> Any:
        return ptr.load()

    def retire(self, blk: Block, tid: int) -> None:
        self.retire_lists[tid].append(blk)  # kept only for the metric
        self.retire_count[tid] += 1

    def clear(self, tid: int) -> None:
        pass
