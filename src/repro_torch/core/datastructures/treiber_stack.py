"""Treiber's lock-free stack — the paper's usage example (Figure 2).

Each node embeds a reclamation header (:class:`Block`); ``pop`` dereferences
the top via ``get_protected(index 0)`` and retires the unlinked node.
"""

from __future__ import annotations

from typing import Any, Optional

from ..atomics import AtomicRef, PtrView
from ..smr_base import POISON, Block
from ..smr_base import SMRScheme

__all__ = ["StackNode", "TreiberStack"]


class StackNode(Block):
    __slots__ = ("next", "obj")

    def __init__(self, obj: Any = None):
        super().__init__()
        self.next: Optional[StackNode] = None  # written before publication only
        self.obj = obj

    def _poison_payload(self) -> None:
        self.next = POISON  # type: ignore[assignment]
        self.obj = POISON


class TreiberStack:
    def __init__(self, smr: SMRScheme):
        self.smr = smr
        self.top = AtomicRef(None)
        self._top_view = PtrView(self.top)

    def push(self, obj: Any, tid: int) -> None:
        smr = self.smr
        smr.start_op(tid)
        try:
            node = smr.alloc_block(StackNode, tid, obj)
            while True:
                head = self.top.load()
                node.next = head
                if self.top.cas(head, node):
                    return
        finally:
            smr.end_op(tid)

    def pop(self, tid: int) -> Optional[Any]:
        smr = self.smr
        smr.start_op(tid)
        try:
            while True:
                # top is a topmost reference: no parent block (paper Fig. 2)
                node = smr.get_protected(self._top_view, 0, tid, parent=None)
                if node is None:
                    return None
                nxt = node.next
                assert nxt is not POISON, "use-after-free: popped node was reclaimed"
                if self.top.cas(node, nxt):
                    obj = node.obj
                    smr.retire(node, tid)
                    return obj
        finally:
            smr.end_op(tid)
