"""Linearizable atomic primitives (shim layer).

The paper assumes x86_64/AArch64 hardware atomics: single-word load/store,
CAS, wide-CAS (WCAS, two adjacent words), and fetch-and-add (F&A).  CPython
has no native atomics, so each cell below guards its word(s) with one lock:
every operation is a single critical section and therefore a single
linearization point.  This preserves the *semantics* (every interleaving the
schemes can exhibit is exercised by the thread scheduler); the *progress*
property (lock-freedom of the primitive itself) is emulated, which DESIGN.md
§2.3 states explicitly.

All higher layers (WFE, HE, HP, EBR, IBR and the data structures) use only
this module for shared mutable state, so the algorithms above this line are
port-faithful to the paper's pseudo-code.

Mirrored cells
--------------
``AtomicInt`` and ``AtomicPair`` optionally carry a *mirror*: an
``(ndarray, row, col)`` target that every store/CAS writes through to under
the cell's own lock.  The era-table layer (``core/era_table.py``) binds each
reservation slot to one int32 array element this way, so the batched
reclamation scan reads reservation snapshots from a contiguous array with
exactly the per-slot atomicity the scalar ``can_delete`` loop gets from
individual ``load()`` calls.  Era values at or above ``MIRROR_INF`` (notably
``INF_ERA``) are clamped to ``MIRROR_INF``, the int32 "no reservation"
sentinel the kernels use.
"""

from __future__ import annotations

import threading
from typing import Any, Tuple

__all__ = [
    "INF_ERA",
    "MIRROR_INF",
    "INVPTR",
    "AtomicInt",
    "AtomicRef",
    "AtomicPair",
    "AtomicTriple",
    "PtrView",
    "PairPtrView",
]

# The paper uses ∞ for "no reservation".  Eras are Python ints (unbounded),
# so any finite era compares below INF_ERA.
INF_ERA: int = (1 << 63) - 1

# int32 image of INF_ERA in mirrored arrays (kernels compare eras as int32;
# the era clock advances once per alloc/retire batch, so a 31-bit horizon
# outlasts any realistic run between restarts).
MIRROR_INF: int = (1 << 31) - 1


def _mirror_write(mirror, value) -> None:
    """Write ``value`` through to an (ndarray, row, col) mirror target.

    Only the true ∞ sentinel reads back as "empty"; a finite era at or past
    the int32 horizon saturates to MIRROR_INF - 1 so it still reads as a
    live reservation (delaying reclamation is safe, skipping it is not).
    """
    arr, row, col = mirror
    if isinstance(value, int) and value != INF_ERA:
        arr[row, col] = min(max(value, 0), MIRROR_INF - 1)
    else:
        arr[row, col] = MIRROR_INF


class _InvPtr:
    """Reserved pointer value that no data structure may ever store.

    The paper reserves the maximal address (MAP_FAILED).  A unique sentinel
    object plays that role here; ``is INVPTR`` is the identity test.
    """

    __slots__ = ()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return "<invptr>"


INVPTR = _InvPtr()


class AtomicInt:
    """Single-word atomic integer: load/store/CAS/F&A.

    ``mirror=(ndarray, row, col)`` write-throughs every update into an int32
    array element under this cell's lock (see module docstring).
    """

    __slots__ = ("_v", "_lock", "_mirror")

    def __init__(self, value: int = 0, mirror=None):
        self._v = value
        self._lock = threading.Lock()
        self._mirror = mirror
        if mirror is not None:
            _mirror_write(mirror, value)

    def load(self) -> int:
        with self._lock:
            return self._v

    def store(self, value: int) -> None:
        with self._lock:
            self._v = value
            if self._mirror is not None:
                _mirror_write(self._mirror, value)

    def cas(self, expected: int, new: int) -> bool:
        with self._lock:
            if self._v == expected:
                self._v = new
                if self._mirror is not None:
                    _mirror_write(self._mirror, new)
                return True
            return False

    def fa_add(self, delta: int = 1) -> int:
        """Fetch-and-add; returns the *previous* value (x86 ``lock xadd``)."""
        with self._lock:
            old = self._v
            self._v = old + delta
            if self._mirror is not None:
                _mirror_write(self._mirror, self._v)
            return old


class AtomicRef:
    """Single-word atomic reference."""

    __slots__ = ("_v", "_lock")

    def __init__(self, value: Any = None):
        self._v = value
        self._lock = threading.Lock()

    def load(self) -> Any:
        with self._lock:
            return self._v

    def store(self, value: Any) -> None:
        with self._lock:
            self._v = value

    def cas(self, expected: Any, new: Any) -> bool:
        with self._lock:
            if self._v is expected:
                self._v = new
                return True
            return False


class AtomicPair:
    """Two adjacent words updated together by WCAS (cmpxchg16b analogue).

    Components are exposed as ``.A`` / ``.B`` in the paper; here a pair tuple
    ``(a, b)``.  Single-word stores of one component (the paper's plain
    ``reservations[tid][index].A = era`` stores) are provided as
    ``store_a``/``store_b`` — on real hardware those are ordinary aligned
    64-bit stores that do not touch the sibling word.
    """

    __slots__ = ("_a", "_b", "_lock", "_mirror_a", "_mirror_b")

    def __init__(self, pair: Tuple[Any, Any], mirror_a=None, mirror_b=None):
        self._a, self._b = pair
        self._lock = threading.Lock()
        self._mirror_a = mirror_a
        self._mirror_b = mirror_b
        if mirror_a is not None:
            _mirror_write(mirror_a, self._a)
        if mirror_b is not None:
            _mirror_write(mirror_b, self._b)

    def _sync_mirrors(self) -> None:
        if self._mirror_a is not None:
            _mirror_write(self._mirror_a, self._a)
        if self._mirror_b is not None:
            _mirror_write(self._mirror_b, self._b)

    def load(self) -> Tuple[Any, Any]:
        with self._lock:
            return (self._a, self._b)

    def load_a(self) -> Any:
        with self._lock:
            return self._a

    def load_b(self) -> Any:
        with self._lock:
            return self._b

    def store(self, pair: Tuple[Any, Any]) -> None:
        with self._lock:
            self._a, self._b = pair
            self._sync_mirrors()

    def store_a(self, a: Any) -> None:
        with self._lock:
            self._a = a
            if self._mirror_a is not None:
                _mirror_write(self._mirror_a, a)

    def store_b(self, b: Any) -> None:
        with self._lock:
            self._b = b
            if self._mirror_b is not None:
                _mirror_write(self._mirror_b, b)

    def wcas(self, expected: Tuple[Any, Any], new: Tuple[Any, Any]) -> bool:
        with self._lock:
            if self._a == expected[0] and self._b == expected[1]:
                self._a, self._b = new
                self._sync_mirrors()
                return True
            return False


class AtomicTriple:
    """Atomic cell holding a (ptr, flag, tag) triple.

    Used by the Natarajan-Mittal BST, where flag/tag live in pointer low bits
    on real hardware — one CAS updates the packed word.  Here the whole triple
    is one atomic cell with a single linearization point, which is the same
    abstraction.
    """

    __slots__ = ("_v", "_lock")

    def __init__(self, value: Tuple[Any, bool, bool]):
        self._v = value
        self._lock = threading.Lock()

    def load(self) -> Tuple[Any, bool, bool]:
        with self._lock:
            return self._v

    def store(self, value: Tuple[Any, bool, bool]) -> None:
        with self._lock:
            self._v = value

    def cas(self, expected: Tuple[Any, bool, bool], new: Tuple[Any, bool, bool]) -> bool:
        with self._lock:
            if (
                self._v[0] is expected[0]
                and self._v[1] == expected[1]
                and self._v[2] == expected[2]
            ):
                self._v = new
                return True
            return False


class PtrView:
    """Uniform ``load() -> block`` view over an AtomicRef.

    ``get_protected(ptr, ...)`` in the paper takes ``block**`` — a location it
    re-reads in its validation loop.  Views adapt the differently shaped
    atomic cells of each data structure to that contract.
    """

    __slots__ = ("_ref",)

    def __init__(self, ref: AtomicRef):
        self._ref = ref

    def load(self) -> Any:
        return self._ref.load()


class PairPtrView:
    """View of the pointer component of an (ptr, mark) AtomicPair."""

    __slots__ = ("_pair",)

    def __init__(self, pair: AtomicPair):
        self._pair = pair

    def load(self) -> Any:
        return self._pair.load()[0]


class TriplePtrView:
    """View of the pointer component of an (ptr, flag, tag) AtomicTriple."""

    __slots__ = ("_cell",)

    def __init__(self, cell: AtomicTriple):
        self._cell = cell

    def load(self) -> Any:
        return self._cell.load()[0]


__all__.append("TriplePtrView")
