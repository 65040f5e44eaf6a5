"""Natarajan-Mittal lock-free external BST (PPoPP'14) — the paper's BST bench.

Leaf-oriented tree: internal nodes route, leaves hold keys.  Child edges are
``(child, flag, tag)`` triples updated by single CAS (flag = the leaf below is
being deleted; tag = no modification may happen under this edge while the
sibling subtree is being moved up).

Reclamation: the delete whose ``ancestor`` CAS succeeds retires the removed
``parent`` internal node and the deleted ``leaf`` — the same discipline the
IBR/Setbench benchmark (which the paper's §5 uses) applies; intermediate
nodes of multi-delete chains are resolved by the combined CAS and retired by
their own deletes' cleanups.

Hazard discipline: five reservation slots (ancestor/successor/parent/leaf/
current) handed along the seek path with ``SMRScheme.transfer``.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

from ..atomics import AtomicTriple, TriplePtrView
from ..smr_base import POISON, Block, SMRScheme

__all__ = ["BSTNode", "NatarajanBST"]

# sentinel keys: larger than any application key (paper uses inf0<inf1<inf2)
_INF0 = (1, 0)
_INF1 = (1, 1)
_INF2 = (1, 2)


def _k(key: Any) -> Tuple[int, Any]:
    """Wrap application keys so sentinels compare greater."""
    return (0, key)


class BSTNode(Block):
    __slots__ = ("key", "value", "left", "right", "is_leaf")

    def __init__(self, key: Any, value: Any = None, is_leaf: bool = True):
        super().__init__()
        self.key = key
        self.value = value
        self.is_leaf = is_leaf
        self.left = AtomicTriple((None, False, False))
        self.right = AtomicTriple((None, False, False))

    def _poison_payload(self) -> None:
        self.value = POISON
        self.left = POISON  # type: ignore[assignment]
        self.right = POISON  # type: ignore[assignment]


# reservation slot roles
_ANC, _SUCC, _PAR, _LEAF, _CUR = 0, 1, 2, 3, 4


class _SeekRecord:
    __slots__ = ("ancestor", "successor", "parent", "leaf")

    def __init__(self, ancestor: BSTNode, successor: BSTNode, parent: BSTNode, leaf: BSTNode):
        self.ancestor = ancestor
        self.successor = successor
        self.parent = parent
        self.leaf = leaf


class NatarajanBST:
    def __init__(self, smr: SMRScheme):
        self.smr = smr
        # Sentinel structure (paper §3): R(inf2) -> [S(inf1), leaf(inf2)],
        # S -> [leaf(inf0), leaf(inf1)].  Sentinels are never retired.
        self.R = BSTNode(_INF2, is_leaf=False)
        self.S = BSTNode(_INF1, is_leaf=False)
        self.R.left.store((self.S, False, False))
        self.R.right.store((BSTNode(_INF2), False, False))
        self.S.left.store((BSTNode(_INF0), False, False))
        self.S.right.store((BSTNode(_INF1), False, False))

    # -- protected edge read -----------------------------------------------------
    def _read_edge(self, cell: AtomicTriple, slot: int, tid: int, parent: Optional[BSTNode]):
        """Protect and consistently read an edge; returns (child, flag, tag)."""
        smr = self.smr
        while True:
            child = smr.get_protected(TriplePtrView(cell), slot, tid, parent=parent)
            triple = cell.load()
            if triple[0] is child:
                return triple

    # -- seek (paper Algorithm 2) ---------------------------------------------------
    def _seek(self, key: Tuple[int, Any], tid: int) -> _SeekRecord:
        smr = self.smr
        while True:
            anc, succ, parent = self.R, self.S, self.S
            # leaf := S.left's child; current field walks down from there
            leaf, _f, _t = self._read_edge(self.S.left, _LEAF, tid, self.S)
            if self.S.left.load()[0] is not leaf:
                continue
            parent_field = self.S.left.load()
            if leaf.is_leaf:
                cur_cell = None
                current_field = (None, False, False)
            else:
                cur_cell = leaf.left if key < leaf.key else leaf.right
                if cur_cell is POISON:
                    continue  # stale publish of a reclaimed node: re-seek
                current_field = self._read_edge(cur_cell, _CUR, tid, leaf)
            cur = current_field[0]
            ok = True
            while cur is not None:
                # advance ancestor/successor when the edge above parent→leaf
                # is untagged
                if not parent_field[2]:
                    anc = parent
                    succ = leaf
                    smr.transfer(_PAR, _ANC, tid)
                    smr.transfer(_LEAF, _SUCC, tid)
                parent = leaf
                smr.transfer(_LEAF, _PAR, tid)
                leaf = cur
                smr.transfer(_CUR, _LEAF, tid)
                parent_field = current_field
                if cur.is_leaf:
                    break
                cur_cell = cur.left if key < cur.key else cur.right
                if cur_cell is POISON:
                    ok = False  # stale publish of a reclaimed node: re-seek
                    break
                current_field = self._read_edge(cur_cell, _CUR, tid, cur)
                cur = current_field[0]
                if cur_cell.load()[0] is not cur:
                    ok = False
                    break
            if ok:
                return _SeekRecord(anc, succ, parent, leaf)

    # -- cleanup (paper Algorithm 5) -------------------------------------------------
    def _cleanup(self, key: Tuple[int, Any], rec: _SeekRecord, tid: int) -> bool:
        ancestor, successor, parent = rec.ancestor, rec.successor, rec.parent
        # edge in ancestor pointing toward the successor
        succ_cell = ancestor.left if key < ancestor.key else ancestor.right
        # parent's edges: child side (toward key) and sibling side
        if key < parent.key:
            child_cell, sibling_cell = parent.left, parent.right
        else:
            child_cell, sibling_cell = parent.right, parent.left
        if succ_cell is POISON or child_cell is POISON \
                or sibling_cell is POISON:
            # ancestor/parent already reclaimed: the record is stale (HP can
            # publish a pointer read from an already-spliced-out edge; the
            # poison makes that visible) — the chain was resolved elsewhere
            return False
        child_val = child_cell.load()
        if not child_val[1]:
            # our leaf's edge is not flagged: the delete being helped flagged
            # the other side — the "sibling" is the child side itself
            sibling_cell = child_cell
        # tag the sibling edge so nothing changes underneath while it moves up
        while True:
            s = sibling_cell.load()
            if s is POISON:
                return False  # parent already reclaimed: the chain was resolved
            if s[2]:
                break
            if sibling_cell.cas(s, (s[0], s[1], True)):
                break
        s_addr, s_flag, _ = sibling_cell.load()
        # splice: ancestor's successor edge -> sibling subtree (flag transfers)
        if succ_cell.cas((successor, False, False), (s_addr, s_flag, False)):
            # unlinked: retire the removed internal node and the deleted leaf
            self.smr.retire(parent, tid)
            self.smr.retire(rec.leaf, tid)
            return True
        return False

    # -- public API ---------------------------------------------------------------
    def insert(self, key_raw: Any, value: Any, tid: int) -> bool:
        key = _k(key_raw)
        smr = self.smr
        smr.start_op(tid)
        try:
            while True:
                rec = self._seek(key, tid)
                leaf = rec.leaf
                if leaf.key == key:
                    return False
                parent = rec.parent
                child_cell = parent.left if key < parent.key else parent.right
                # build: new internal routing to (new leaf, existing leaf)
                new_leaf = smr.alloc_block(BSTNode, tid, key, value, True)
                internal_key = max(key, leaf.key)
                new_int = smr.alloc_block(BSTNode, tid, internal_key, None, False)
                if key < leaf.key:
                    new_int.left.store((new_leaf, False, False))
                    new_int.right.store((leaf, False, False))
                else:
                    new_int.left.store((leaf, False, False))
                    new_int.right.store((new_leaf, False, False))
                if child_cell.cas((leaf, False, False), (new_int, False, False)):
                    return True
                # failed: if the edge is flagged/tagged at our leaf, help clean
                smr.free(new_leaf, tid)  # never published
                smr.free(new_int, tid)
                cv = child_cell.load()
                if cv is not POISON and cv[0] is leaf and (cv[1] or cv[2]):
                    self._cleanup(key, rec, tid)
        finally:
            smr.end_op(tid)

    def delete(self, key_raw: Any, tid: int) -> bool:
        key = _k(key_raw)
        smr = self.smr
        smr.start_op(tid)
        try:
            injected = False
            leaf: Optional[BSTNode] = None
            while True:
                rec = self._seek(key, tid)
                if not injected:
                    leaf = rec.leaf
                    if leaf.key != key:
                        return False
                    parent = rec.parent
                    child_cell = parent.left if key < parent.key else parent.right
                    # injection: flag the edge parent -> leaf
                    if child_cell.cas((leaf, False, False), (leaf, True, False)):
                        injected = True
                        if self._cleanup(key, rec, tid):
                            return True
                    else:
                        cv = child_cell.load()
                        if cv is not POISON and cv[0] is leaf and (cv[1] or cv[2]):
                            self._cleanup(key, rec, tid)
                else:
                    # cleanup mode: retry until our leaf is gone
                    if rec.leaf is not leaf:
                        return True  # someone (the combined CAS) removed it
                    if self._cleanup(key, rec, tid):
                        return True
        finally:
            smr.end_op(tid)

    def get(self, key_raw: Any, tid: int) -> Optional[Any]:
        key = _k(key_raw)
        smr = self.smr
        smr.start_op(tid)
        try:
            while True:
                rec = self._seek(key, tid)
                if rec.leaf.key != key:
                    return None
                # read value FIRST, then check liveness: checking freed
                # before the read would leave a window where the reclaimer
                # poisons the value in between (stale publish, see _seek)
                value = rec.leaf.value
                if rec.leaf.freed or value is POISON:
                    continue  # stale leaf (reclaimed before publish): re-seek
                return value
        finally:
            smr.end_op(tid)
