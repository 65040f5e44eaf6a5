"""Harris's sorted lock-free linked list with Michael's modification.

The paper's Linked-List benchmark (§5): Harris 2001 with the hazard-pointer-
compatible unlink discipline from Michael 2004 — a marked node is physically
unlinked *before* being retired, so traversals never walk retired nodes.

``next`` cells are ``(successor, marked)`` pairs (one CAS updates both — the
mark bit lives in the pointer word on real hardware).

Hazard discipline: three rotating reservation slots (prev / curr / next),
handed off with ``SMRScheme.transfer`` as the traversal advances.  WFE's
``parent`` argument is the block physically containing the dereferenced
``next`` cell.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

from ..atomics import AtomicPair, PairPtrView
from ..smr_base import POISON, Block, SMRScheme

__all__ = ["ListNode", "HarrisMichaelList"]


class ListNode(Block):
    __slots__ = ("key", "value", "next")

    def __init__(self, key: Any, value: Any = None):
        super().__init__()
        self.key = key
        self.value = value
        self.next = AtomicPair((None, False))  # (successor, marked)

    def _poison_payload(self) -> None:
        self.value = POISON
        self.next = POISON  # type: ignore[assignment]


# reservation slot roles
_PREV, _CURR, _NEXT = 0, 1, 2


class HarrisMichaelList:
    """Sorted set/map with lock-free insert/delete/get."""

    def __init__(self, smr: SMRScheme, head_cell: Optional[AtomicPair] = None):
        self.smr = smr
        # the head cell is not inside any block (topmost reference)
        self.head = head_cell if head_cell is not None else AtomicPair((None, False))

    # -- internal: Michael's find -------------------------------------------------
    def _find(self, key: Any, tid: int) -> Tuple[bool, AtomicPair, Optional[ListNode], Optional[ListNode], Optional[ListNode]]:
        """Returns (found, prev_cell, prev_node, curr, next).

        Postcondition: ``prev_cell`` points at unmarked ``curr``; all marked
        nodes in front were physically unlinked and retired.  ``curr`` is the
        first node with ``curr.key >= key`` (or None).  prev/curr protected in
        slots ``_PREV``/``_CURR``.
        """
        smr = self.smr
        while True:  # restart label (Michael's `try_again`)
            prev_cell = self.head
            prev_node: Optional[ListNode] = None
            curr = smr.get_protected(PairPtrView(prev_cell), _CURR, tid, parent=prev_node)
            restart = False
            while True:
                if prev_cell.load() != (curr, False):
                    restart = True
                    break
                if curr is None:
                    return False, prev_cell, prev_node, None, None
                # protect curr's successor, re-reading until consistent
                while True:
                    nxt = smr.get_protected(PairPtrView(curr.next), _NEXT, tid, parent=curr)
                    nxt2, cmark = curr.next.load()
                    if nxt2 is nxt:
                        break
                if cmark:
                    # curr is logically deleted: unlink before anyone retires it
                    if prev_cell.wcas((curr, False), (nxt, False)):
                        smr.retire(curr, tid)
                        smr.transfer(_NEXT, _CURR, tid)
                        curr = nxt
                        continue
                    restart = True
                    break
                if curr.key >= key:
                    return curr.key == key, prev_cell, prev_node, curr, nxt
                # advance: curr becomes prev
                prev_cell = curr.next
                prev_node = curr
                smr.transfer(_CURR, _PREV, tid)
                smr.transfer(_NEXT, _CURR, tid)
                curr = nxt
            if restart:
                continue

    # -- public API ---------------------------------------------------------------
    def insert(self, key: Any, value: Any, tid: int) -> bool:
        smr = self.smr
        smr.start_op(tid)
        try:
            found, prev_cell, _prev, curr, _nxt = self._find(key, tid)
            if found:
                return False
            node = smr.alloc_block(ListNode, tid, key, value)
            while True:
                node.next.store((curr, False))
                if prev_cell.wcas((curr, False), (node, False)):
                    return True
                found, prev_cell, _prev, curr, _nxt = self._find(key, tid)
                if found:
                    smr.free(node, tid)  # never published: immediate free is safe
                    return False
        finally:
            smr.end_op(tid)

    def delete(self, key: Any, tid: int) -> bool:
        smr = self.smr
        smr.start_op(tid)
        try:
            while True:
                found, prev_cell, _prev, curr, nxt = self._find(key, tid)
                if not found:
                    return False
                assert curr is not None
                # logical delete: mark curr's next
                if not curr.next.wcas((nxt, False), (nxt, True)):
                    continue  # lost a race on curr; re-find
                # physical unlink (or delegate to the next find's cleanup)
                if prev_cell.wcas((curr, False), (nxt, False)):
                    smr.retire(curr, tid)
                else:
                    self._find(key, tid)
                return True
        finally:
            smr.end_op(tid)

    def get(self, key: Any, tid: int) -> Optional[Any]:
        smr = self.smr
        smr.start_op(tid)
        try:
            found, _pc, _p, curr, _n = self._find(key, tid)
            if not found:
                return None
            assert curr is not None
            value = curr.value
            assert value is not POISON, "use-after-free: read a reclaimed node"
            return value
        finally:
            smr.end_op(tid)

    def __contains__(self) -> bool:  # pragma: no cover
        raise TypeError("use get(key, tid)")
