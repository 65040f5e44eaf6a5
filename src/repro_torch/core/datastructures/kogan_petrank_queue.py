"""Kogan-Petrank wait-free queue (PPoPP'11) — the paper's KP benchmark.

Phase-based helping: every operation publishes an ``OpDesc`` in ``state[tid]``
and all threads help pending operations with phase ≤ their own, so every
enqueue/dequeue completes in a bounded number of steps.

The original KP queue assumes a garbage collector; the paper (§5) evaluates
it with SMR schemes instead — this port does the same: nodes *and* OpDesc
records are SMR-managed blocks, protected via ``get_protected`` before every
dereference and retired by whichever thread replaces them (the CAS/store
winner).  With WFE the whole queue, including reclamation, is wait-free —
the paper's headline claim.

Reservation slots: 0=head, 1=tail, 2=next, 3=desc, 4=value-read spare.
"""

from __future__ import annotations

from typing import Any, List, Optional

from ..atomics import AtomicInt, AtomicRef, PtrView
from ..smr_base import POISON, Block, SMRScheme

__all__ = ["KPQueue"]

_HEAD, _TAIL, _NEXT, _DESC, _SPARE = 0, 1, 2, 3, 4


class _Node(Block):
    __slots__ = ("value", "next", "enq_tid", "deq_tid")

    def __init__(self, value: Any = None, enq_tid: int = -1):
        super().__init__()
        self.value = value
        self.next = AtomicRef(None)
        self.enq_tid = enq_tid
        self.deq_tid = AtomicInt(-1)

    def _poison_payload(self) -> None:
        self.value = POISON
        self.next = POISON  # type: ignore[assignment]


class _OpDesc(Block):
    """Immutable once published.

    ``value`` carries the dequeued value for completed dequeues: it is
    captured by the completing helper while the new sentinel is provably
    pre-consumption (protected and still head-adjacent), so the owning
    dequeuer never has to re-dereference a node that a later dequeue may
    already have retired — that re-read was a use-after-free under HP with
    concurrent consumers.
    """

    __slots__ = ("phase", "pending", "enqueue", "node", "value")

    def __init__(self, phase: int, pending: bool, enqueue: bool,
                 node: Optional[_Node], value: Any = None):
        super().__init__()
        self.phase = phase
        self.pending = pending
        self.enqueue = enqueue
        self.node = node
        self.value = value

    def _poison_payload(self) -> None:
        self.node = POISON  # type: ignore[assignment]
        self.value = POISON


class KPQueue:
    def __init__(self, smr: SMRScheme):
        self.smr = smr
        self.n = smr.max_threads
        sentinel = smr.alloc_block(_Node, 0, None, -1)
        self.head = AtomicRef(sentinel)
        self.tail = AtomicRef(sentinel)
        self._head_view = PtrView(self.head)
        self._tail_view = PtrView(self.tail)
        self.state: List[AtomicRef] = [
            AtomicRef(smr.alloc_block(_OpDesc, 0, -1, False, True, None))
            for _ in range(self.n)
        ]
        self._state_views = [PtrView(s) for s in self.state]

    # -- protected loads ------------------------------------------------------
    def _desc(self, i: int, tid: int) -> _OpDesc:
        return self.smr.get_protected(self._state_views[i], _DESC, tid, parent=None)

    def _max_phase(self, tid: int) -> int:
        mx = -1
        for i in range(self.n):
            d = self._desc(i, tid)
            if d.phase > mx:
                mx = d.phase
        return mx

    def _is_still_pending(self, i: int, phase: int, tid: int) -> bool:
        d = self._desc(i, tid)
        return d.pending and d.phase <= phase

    # -- helping ----------------------------------------------------------------
    def _help(self, phase: int, tid: int) -> None:
        for i in range(self.n):
            d = self._desc(i, tid)
            if d.pending and d.phase <= phase:
                if d.enqueue:
                    self._help_enq(i, phase, tid)
                else:
                    self._help_deq(i, phase, tid)

    def _help_enq(self, i: int, phase: int, tid: int) -> None:
        smr = self.smr
        while self._is_still_pending(i, phase, tid):
            last = smr.get_protected(self._tail_view, _TAIL, tid)
            nxt = smr.get_protected(PtrView(last.next), _NEXT, tid, parent=last)
            if last is self.tail.load():
                if nxt is None:
                    if self._is_still_pending(i, phase, tid):
                        d = self._desc(i, tid)
                        node = d.node
                        if node is not None and last.next.cas(None, node):
                            self._help_finish_enq(tid)
                            return
                else:
                    self._help_finish_enq(tid)

    def _help_finish_enq(self, tid: int) -> None:
        smr = self.smr
        last = smr.get_protected(self._tail_view, _TAIL, tid)
        nxt = smr.get_protected(PtrView(last.next), _NEXT, tid, parent=last)
        if nxt is not None:
            etid = nxt.enq_tid
            cur = self._desc(etid, tid)
            if last is self.tail.load() and cur.node is nxt:
                new = smr.alloc_block(_OpDesc, tid, cur.phase, False, True, nxt)
                if self.state[etid].cas(cur, new):
                    smr.retire(cur, tid)
                else:
                    smr.free(new, tid)  # never published
            self.tail.cas(last, nxt)

    def _help_deq(self, i: int, phase: int, tid: int) -> None:
        smr = self.smr
        while self._is_still_pending(i, phase, tid):
            first = smr.get_protected(self._head_view, _HEAD, tid)
            last = smr.get_protected(self._tail_view, _TAIL, tid)
            nxt = smr.get_protected(PtrView(first.next), _NEXT, tid, parent=first)
            if first is not self.head.load():
                continue
            if first is last:
                if nxt is None:
                    cur = self._desc(i, tid)
                    if last is self.tail.load() and cur.pending and cur.phase <= phase:
                        # empty queue: complete the op with node == None
                        new = smr.alloc_block(_OpDesc, tid, cur.phase, False, False, None)
                        if self.state[i].cas(cur, new):
                            smr.retire(cur, tid)
                        else:
                            smr.free(new, tid)
                else:
                    self._help_finish_enq(tid)
            else:
                cur = self._desc(i, tid)
                node = cur.node
                if not (cur.pending and cur.phase <= phase):
                    break
                if first is self.head.load() and node is not first:
                    # record which sentinel this dequeue is consuming
                    new = smr.alloc_block(_OpDesc, tid, cur.phase, True, False, first)
                    if self.state[i].cas(cur, new):
                        smr.retire(cur, tid)
                    else:
                        smr.free(new, tid)
                        continue
                first.deq_tid.cas(-1, i)
                self._help_finish_deq(tid)

    def _help_finish_deq(self, tid: int) -> None:
        smr = self.smr
        first = smr.get_protected(self._head_view, _HEAD, tid)
        nxt = smr.get_protected(PtrView(first.next), _NEXT, tid, parent=first)
        dtid = first.deq_tid.load()
        if dtid != -1:
            cur = self._desc(dtid, tid)
            if first is self.head.load() and nxt is not None:
                # capture the dequeued value NOW: nxt is protected (slot
                # _NEXT, published before the head check) and head has not
                # advanced past it yet, so it cannot have been retired —
                # the only window in which reading it is safe under HP
                new = smr.alloc_block(_OpDesc, tid, cur.phase, False, False,
                                      cur.node, nxt.value)
                if self.state[dtid].cas(cur, new):
                    smr.retire(cur, tid)
                else:
                    smr.free(new, tid)
                self.head.cas(first, nxt)

    # -- public API -----------------------------------------------------------------
    def enqueue(self, value: Any, tid: int) -> None:
        smr = self.smr
        smr.start_op(tid)
        try:
            phase = self._max_phase(tid) + 1
            node = smr.alloc_block(_Node, tid, value, tid)
            desc = smr.alloc_block(_OpDesc, tid, phase, True, True, node)
            old = self.state[tid].load()
            self.state[tid].store(desc)  # own slot; replaced desc is ours to retire
            smr.retire(old, tid)
            self._help(phase, tid)
            self._help_finish_enq(tid)
        finally:
            smr.end_op(tid)

    def dequeue(self, tid: int) -> Optional[Any]:
        smr = self.smr
        smr.start_op(tid)
        try:
            phase = self._max_phase(tid) + 1
            desc = smr.alloc_block(_OpDesc, tid, phase, True, False, None)
            old = self.state[tid].load()
            self.state[tid].store(desc)
            smr.retire(old, tid)
            self._help(phase, tid)
            self._help_finish_deq(tid)
            cur = self._desc(tid, tid)
            node = cur.node  # the sentinel this dequeue consumed
            if node is None:
                return None  # empty
            # the completing helper captured the value into the desc while
            # the new sentinel was still protected and pre-consumption
            value = cur.value
            assert value is not POISON, "use-after-free reading dequeued value"
            smr.retire(node, tid)  # only the owning dequeuer retires its sentinel
            return value
        finally:
            smr.end_op(tid)
