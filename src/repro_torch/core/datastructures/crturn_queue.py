"""CRTurn-style wait-free queue — Ramalhete & Correia, PPoPP'17 poster.

Turn-based helping: enqueuers publish their node in ``enqueuers[tid]`` and
every thread helps the next registered request in round-robin (turn) order
starting after the tid that enqueued the current tail; dequeuers publish a
``Request`` and nodes are *assigned* to the next open request in turn order;
delivery hands over an immutable ``_Answer`` box carrying the node AND its
item, captured while the node is provably pre-consumption — the requester
never re-dereferences a node a later dequeue may have already retired.

The enqueue side is the published algorithm (deregister-the-tail's-request
before linking, then link the next request in turn order, then swing tail).

The dequeue side keeps the poster's structure (per-thread request slots,
turn-ordered assignment via a ``deq_tid`` CAS on the node, retire-previous-
request reclamation) but uses an explicit ternary answer handshake
(``answer: None → _Answer | EMPTY``) for delivery: the poster's four-way
``deqself/deqhelp/giveUp/casDeqAndHead`` interplay is under-specified in the
text we reproduce from, and a mis-remembered "faithful" port would be worse
than a provably safe variant.  The handshake preserves the key properties:

* wait-free bounded — a requester is answered within ``n`` turn-ordered
  deliveries, empty detection closes the request with one CAS;
* at-most-once delivery — ``answer`` transitions by CAS exactly once, a node
  rebinds only away from a *provably dead* request (answer already set to a
  different value), so no node is delivered twice and none is lost;
* head advances only after its successor has been delivered, so the retiring
  CAS winner is unique.

Reservation slots: 0=head, 1=next, 2=request, 3=tail, 4=answer-read spare.
"""

from __future__ import annotations

from typing import Any, List, Optional

from ..atomics import AtomicInt, AtomicRef, PtrView
from ..smr_base import POISON, Block, SMRScheme

__all__ = ["CRTurnQueue", "EMPTY"]

_HEAD, _NEXT, _REQ, _TAIL, _SPARE = 0, 1, 2, 3, 4


class _Empty:
    __slots__ = ()

    def __repr__(self) -> str:  # pragma: no cover
        return "<empty>"


EMPTY = _Empty()


class _Answer:
    """Immutable delivery record: the assigned node plus its item.

    The item is captured by the DELIVERER, at a point where the node is
    still head-adjacent (pre-consumption) and covered by the deliverer's
    reservation.  Requesters read the item from here — re-dereferencing the
    node after delivery was a use-after-free under HP with concurrent
    consumers (a later dequeue may already have retired and poisoned it).
    """

    __slots__ = ("node", "item")

    def __init__(self, node: "_Node", item: Any):
        self.node = node
        self.item = item


class _Node(Block):
    __slots__ = ("item", "enq_tid", "deq_tid", "deq_req", "next")

    def __init__(self, item: Any = None, enq_tid: int = -1):
        super().__init__()
        self.item = item
        self.enq_tid = enq_tid
        self.deq_tid = AtomicInt(-1)  # turn bookkeeping for round-robin
        self.deq_req = AtomicRef(None)  # binding: the Request this node answers
        self.next = AtomicRef(None)

    def _poison_payload(self) -> None:
        self.item = POISON
        self.next = POISON  # type: ignore[assignment]


class _Request(Block):
    __slots__ = ("answer",)

    def __init__(self) -> None:
        super().__init__()
        self.answer = AtomicRef(None)  # None -> node | EMPTY, exactly once

    def _poison_payload(self) -> None:
        self.answer = POISON  # type: ignore[assignment]


class CRTurnQueue:
    def __init__(self, smr: SMRScheme):
        self.smr = smr
        self.n = smr.max_threads
        sentinel = smr.alloc_block(_Node, 0, None, -1)
        self.head = AtomicRef(sentinel)
        self.tail = AtomicRef(sentinel)
        self._head_view = PtrView(self.head)
        self._tail_view = PtrView(self.tail)
        self.enqueuers: List[AtomicRef] = [AtomicRef(None) for _ in range(self.n)]
        self.dreqs: List[AtomicRef] = [AtomicRef(None) for _ in range(self.n)]
        self._dreq_views = [PtrView(r) for r in self.dreqs]
        self.prev_req: List[Optional[_Request]] = [None] * self.n
        # telemetry: loop-bound watermarks (wait-freedom oracle for tests)
        self.max_enq_iters = [0] * self.n
        self.max_deq_iters = [0] * self.n

    # -- enqueue (published CRTurn algorithm) ------------------------------------
    def enqueue(self, item: Any, tid: int) -> None:
        smr = self.smr
        smr.start_op(tid)
        try:
            my = smr.alloc_block(_Node, tid, item, tid)
            self.enqueuers[tid].store(my)
            iters = 0
            while self.enqueuers[tid].load() is not None:
                iters += 1
                ltail = smr.get_protected(self._tail_view, _TAIL, tid)
                if ltail is not self.tail.load():
                    continue
                # deregister the request of the thread that enqueued the tail
                et = ltail.enq_tid
                if et >= 0 and self.enqueuers[et].load() is ltail:
                    self.enqueuers[et].cas(ltail, None)
                # help the next registered enqueuer in turn order
                for j in range(1, self.n + 1):
                    cand = self.enqueuers[(et + j) % self.n].load()
                    if cand is not None:
                        ltail.next.cas(None, cand)
                        break
                lnext = ltail.next.load()
                if lnext is not None:
                    self.tail.cas(ltail, lnext)
            if iters > self.max_enq_iters[tid]:
                self.max_enq_iters[tid] = iters
        finally:
            smr.end_op(tid)

    # -- dequeue helping ----------------------------------------------------------
    def _open_request(self, cand_tid: int, tid: int) -> Optional[_Request]:
        r = self.smr.get_protected(self._dreq_views[cand_tid], _REQ, tid)
        if r is None or r.freed:
            return None
        # the request may have been deregistered+retired between our load
        # and this read (a reservation published after the retire cannot
        # pin it); a poisoned answer marks exactly that dead state
        ans_cell = r.answer
        if ans_cell is POISON or ans_cell.load() is not None:
            return None
        return r

    def _help_deliver(self, lhead: "_Node", lnext: "_Node", tid: int) -> None:
        """Assign lnext to an open request (turn order), deliver, advance head."""
        smr = self.smr
        turn = lhead.deq_tid.load()
        bound = smr.get_protected(PtrView(lnext.deq_req), _SPARE, tid, parent=lnext)
        if bound is None:
            for j in range(1, self.n + 1):
                cand_tid = (turn + j) % self.n
                cr = self._open_request(cand_tid, tid)
                if cr is None:
                    continue
                if lnext.deq_req.cas(None, cr):
                    lnext.deq_tid.cas(-1, cand_tid)
                break
            bound = smr.get_protected(PtrView(lnext.deq_req), _SPARE, tid, parent=lnext)
            if bound is None:
                return  # no open requests at all
        # deliver (at most once: answer CASes None -> _Answer(lnext, item));
        # the item is read HERE — lnext is protected and head has not
        # advanced past it, the only window where the read is safe.
        # The binding itself may be DEAD: an owner only moves on after its
        # answer is set, so a retired — possibly already freed/poisoned —
        # bound request implies this binding was answered or closed; never
        # deliver into it (its owner will not read it), rebind instead.
        ans_cell = bound.answer if not bound.freed else POISON
        delivered = (ans_cell is not POISON
                     and ans_cell.cas(None, _Answer(lnext, lnext.item)))
        if not delivered:
            ans = ans_cell.load() if ans_cell is not POISON else None
            if ans is None or ans is EMPTY or ans.node is not lnext:
                # dead binding (freed / closed EMPTY / answered elsewhere):
                # rebind to another open request in turn order
                for j in range(1, self.n + 1):
                    cand_tid = (turn + j) % self.n
                    cr = self._open_request(cand_tid, tid)
                    if cr is None or cr is bound:
                        continue
                    lnext.deq_req.cas(bound, cr)
                    lnext.deq_tid.store(cand_tid)
                    break
                return  # the next helping iteration delivers
        # delivered: advance head past the consumed sentinel; winner retires it
        if self.head.cas(lhead, lnext):
            smr.retire(lhead, tid)

    # -- dequeue -------------------------------------------------------------------
    def dequeue(self, tid: int) -> Optional[Any]:
        smr = self.smr
        smr.start_op(tid)
        try:
            # CRTurn's reclamation discipline: retire the previous request
            prev = self.prev_req[tid]
            if prev is not None:
                smr.retire(prev, tid)
                self.prev_req[tid] = None
            r = smr.alloc_block(_Request, tid)
            self.dreqs[tid].store(r)
            iters = 0
            while r.answer.load() is None:
                iters += 1
                lhead = smr.get_protected(self._head_view, _HEAD, tid)
                if lhead is not self.head.load():
                    continue
                if lhead is self.tail.load():
                    lnext = lhead.next.load()
                    if lnext is None:
                        # queue observed empty: close our own request
                        r.answer.cas(None, EMPTY)
                        break  # answer is now EMPTY or a delivered node
                    self.tail.cas(lhead, lnext)  # tail lagging: help advance
                    continue
                lnext = smr.get_protected(PtrView(lhead.next), _NEXT, tid, parent=lhead)
                if lhead is not self.head.load() or lnext is None:
                    continue
                self._help_deliver(lhead, lnext, tid)
            if iters > self.max_deq_iters[tid]:
                self.max_deq_iters[tid] = iters
            self.dreqs[tid].cas(r, None)  # deregister
            self.prev_req[tid] = r  # retired on our next dequeue
            ans = r.answer.load()
            if ans is EMPTY:
                return None
            # ans is the delivery record; its item was captured while the
            # node was still protected and pre-consumption
            item = ans.item
            assert item is not POISON, "use-after-free reading dequeued item"
            return item
        finally:
            smr.end_op(tid)
