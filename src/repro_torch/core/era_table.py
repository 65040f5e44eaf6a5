"""Array-backed era table: the batched-reclamation substrate.

The paper's ``cleanup()`` (Fig. 4, Theorem 4) is an interval-overlap scan of
R retired blocks against T×H published reservations.  The scalar schemes
walk Python ``AtomicInt``/``AtomicPair`` lists one slot at a time — O(R·T·H)
interpreter work on the serving hot path.  This module keeps two contiguous
int32 mirrors so the whole scan becomes one vectorized compare-reduce:

* :class:`EraTable` — a (T, S) reservation mirror.  Each scheme binds its
  reservation cells to table elements via the atomics layer's write-through
  mirrors (``atomics.AtomicInt(mirror=...)``), so every store/WCAS updates
  the array *under the same lock* as the scalar word.  A snapshot read from
  the array therefore has exactly the per-slot atomicity of the scalar
  ``can_delete`` loop's individual ``load()`` calls.
* :class:`ArrayRetireList` — a drop-in replacement for the per-thread
  ``List[Block]`` retire list that additionally maintains packed
  ``(alloc_era, retire_era)`` int32 columns, appended at ``retire()`` time.

:func:`batched_can_delete` is the backend dispatch: ``scalar`` (pure-Python
reference, the paper's loop verbatim), ``numpy`` (broadcast compare-reduce),
``torch`` (the same compare-reduce in eager PyTorch on the CPU) and ``cuda``
(the ``kernels/era_scan`` CUDA kernel).  All four take the generalized
*interval* reservation form ``[lo, hi]``; point reservations
(HE/WFE eras) pass ``lo == hi``, IBR passes its per-thread interval, and EBR
derives ``lo = announce - 1`` (see ``ebr.py``).  A block is deletable iff no
valid reservation interval overlaps its lifetime:

    conflict(blk, s)  ⇔  lo[s] ≤ blk.retire_era  ∧  blk.alloc_era ≤ hi[s]

which for ``lo == hi == e`` reduces to the paper's
``alloc_era ≤ e ≤ retire_era``.
"""

from __future__ import annotations

import threading
from typing import Callable, Iterator, List, Optional, Tuple

import numpy as np

from .atomics import INF_ERA, MIRROR_INF

__all__ = [
    "EraTable",
    "ArrayRetireList",
    "batched_can_delete",
    "clip_era",
    "BACKENDS",
]

BACKENDS = ("scalar", "numpy", "torch", "cuda")


def clip_era(v: int) -> int:
    """Map an unbounded Python-int era onto the int32 mirror domain."""
    if v == INF_ERA or v >= MIRROR_INF:
        return MIRROR_INF if v == INF_ERA else MIRROR_INF - 1
    return v if v >= 0 else 0


class EraTable:
    """(max_threads, n_slots) int32 mirror of a scheme's reservations.

    ``interval=True`` allocates a second array for the upper bounds (IBR);
    point-reservation schemes alias ``hi`` to ``lo`` so the generalized scan
    sees degenerate ``[e, e]`` intervals without copying twice.
    """

    __slots__ = ("max_threads", "n_slots", "lo", "hi")

    def __init__(self, max_threads: int, n_slots: int, *, interval: bool = False):
        self.max_threads = max_threads
        self.n_slots = n_slots
        self.lo = np.full((max_threads, n_slots), MIRROR_INF, np.int32)
        self.hi = (np.full((max_threads, n_slots), MIRROR_INF, np.int32)
                   if interval else self.lo)

    # mirror targets handed to the atomics layer ---------------------------
    def mirror_lo(self, tid: int, slot: int):
        return (self.lo, tid, slot)

    def mirror_hi(self, tid: int, slot: int):
        return (self.hi, tid, slot)

    def snapshot(self, js: int = 0, je: Optional[int] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """Fresh copy of reservation columns [js, je) as flat (lo, hi) rows.

        Each call re-reads the live mirror — WFE's Theorem-4 ordering relies
        on the second normal-column scan observing writes made after the
        first, so snapshots must never be cached across phases.
        """
        je = self.n_slots if je is None else je
        lo = self.lo[:, js:je].reshape(-1).copy()
        if self.hi is self.lo:
            return lo, lo
        return lo, self.hi[:, js:je].reshape(-1).copy()


class ArrayRetireList:
    """Per-thread retire list with packed era columns.

    Behaves like the ``List[Block]`` the scalar cleanups already use
    (``append`` / iterate / ``len`` / ``lst[:] = remaining``) while keeping
    ``alloc``/``retire`` int32 arrays in lock-step so the batched scan never
    rebuilds them from Python objects.

    Appends come only from the owning thread (it alone retires into its
    list), but *cleaners* may differ from the owner: the cross-thread drain
    (``SMRScheme.cleanup_batch_all``) compacts every thread's list.
    ``lock`` (reentrant) guards every mutation — appends, the full-slice
    rebuild, and compaction — so a cleaner can never race an append or
    another cleaner on the same list.  Each hold is short (one append, one
    compact, one snapshot); the fused drain deliberately does NOT hold
    list locks while computing its mask, so a fleet drain never stalls
    retiring threads for the duration of a scan — ``version`` lets it
    detect a competing cleanup between snapshot and compact and skip that
    list instead (see ``SMRScheme.cleanup_batch_all``).  Uncontended
    acquisition is the same cost as the per-word locks the atomics shim
    already pays on every operation.
    """

    __slots__ = ("_blocks", "_alloc", "_retire", "_fields", "lock", "version")

    def __init__(self, era_fields: Tuple[str, str] = ("alloc_era", "retire_era"),
                 capacity: int = 64):
        self._blocks: List = []
        self._alloc = np.empty(capacity, np.int32)
        self._retire = np.empty(capacity, np.int32)
        self._fields = era_fields
        self.lock = threading.RLock()
        #: bumped by every remove/reorder (compact, rebuild) — NOT by
        #: append, which only extends past any previously snapshotted prefix
        self.version = 0

    # -- list protocol used by the scalar cleanups -------------------------
    def append(self, blk) -> None:
        with self.lock:
            n = len(self._blocks)
            if n == self._alloc.shape[0]:
                self._alloc = np.concatenate(
                    [self._alloc, np.empty_like(self._alloc)])
                self._retire = np.concatenate(
                    [self._retire, np.empty_like(self._retire)])
            self._alloc[n] = clip_era(getattr(blk, self._fields[0]))
            self._retire[n] = clip_era(getattr(blk, self._fields[1]))
            self._blocks.append(blk)

    def __len__(self) -> int:
        return len(self._blocks)

    def __iter__(self) -> Iterator:
        return iter(self._blocks)

    def __getitem__(self, key):
        return self._blocks[key]

    def __setitem__(self, key, value) -> None:
        if not (isinstance(key, slice) and key == slice(None, None, None)):
            raise TypeError("ArrayRetireList only supports full-slice rebuild")
        with self.lock:
            blocks = list(value)
            self._blocks = []
            self.version += 1
            if len(blocks) > self._alloc.shape[0]:
                cap = max(64, 1 << (len(blocks) - 1).bit_length())
                self._alloc = np.empty(cap, np.int32)
                self._retire = np.empty(cap, np.int32)
            for blk in blocks:
                self.append(blk)

    # -- batched access -----------------------------------------------------
    def arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        """Era columns for the live blocks (views — do not mutate)."""
        n = len(self._blocks)
        return self._alloc[:n], self._retire[:n]

    def snapshot(self) -> Tuple[int, int, np.ndarray, np.ndarray]:
        """(version, n, alloc copy, retire copy) — a stable prefix image.

        Taken under the lock; a later ``compact`` against this snapshot's
        mask is valid iff ``version`` is unchanged (appends don't bump it —
        they only extend past ``n`` and are preserved by ``compact``).
        """
        with self.lock:
            n = len(self._blocks)
            return (self.version, n,
                    self._alloc[:n].copy(), self._retire[:n].copy())

    def compact(self, deletable: np.ndarray, free_fn: Callable) -> int:
        """Free masked blocks, keep the rest packed in place.  Returns #freed.

        Only the first ``len(deletable)`` entries are scanned; entries
        appended after the mask was computed (possible during the fused
        drain's unlocked mask phase) are preserved at the tail.
        """
        with self.lock:
            blocks = self._blocks
            n = len(deletable)
            self.version += 1
            keep = 0
            for i in range(n):
                if deletable[i]:
                    free_fn(blocks[i])
                else:
                    if keep != i:
                        blocks[keep] = blocks[i]
                        self._alloc[keep] = self._alloc[i]
                        self._retire[keep] = self._retire[i]
                    keep += 1
            tail = len(blocks) - n  # post-mask appends, preserved
            for i in range(n, n + tail):
                blocks[keep + i - n] = blocks[i]
                self._alloc[keep + i - n] = self._alloc[i]
                self._retire[keep + i - n] = self._retire[i]
            del blocks[keep + tail:]
            return n - keep


# ---------------------------------------------------------------- backends
def _can_delete_scalar(alloc, retire, res_lo, res_hi) -> np.ndarray:
    """Reference: the paper's can_delete loop, interval-generalized."""
    out = np.empty(len(alloc), bool)
    for i in range(len(alloc)):
        a, r = alloc[i], retire[i]
        ok = True
        for s in range(len(res_lo)):
            lo = res_lo[s]
            if lo != MIRROR_INF and lo <= r and a <= res_hi[s]:
                ok = False
                break
        out[i] = ok
    return out


def _can_delete_numpy(alloc, retire, res_lo, res_hi) -> np.ndarray:
    valid = res_lo != MIRROR_INF
    conflict = (valid[None, :]
                & (res_lo[None, :] <= retire[:, None])
                & (alloc[:, None] <= res_hi[None, :]))
    return ~conflict.any(axis=1)


def batched_can_delete(alloc: np.ndarray, retire: np.ndarray,
                       res_lo: np.ndarray, res_hi: np.ndarray,
                       backend: str = "numpy") -> np.ndarray:
    """(R,) bool deletable mask of retired lifetimes vs reservation intervals.

    ``backend``: ``scalar`` | ``numpy`` | ``torch`` | ``cuda``.  All four are
    bit-identical on the same inputs (asserted by tests/test_torch_host and
    tests/test_torch_kernels).  ``cuda`` copies the int32 mirrors to the
    current CUDA device, runs the era-scan kernel and copies the mask back;
    it raises where no CUDA device is present.
    """
    alloc = np.ascontiguousarray(alloc, np.int32)
    retire = np.ascontiguousarray(retire, np.int32)
    res_lo = np.ascontiguousarray(res_lo, np.int32)
    res_hi = np.ascontiguousarray(res_hi, np.int32)
    if backend == "scalar":
        return _can_delete_scalar(alloc, retire, res_lo, res_hi)
    if backend == "numpy":
        return _can_delete_numpy(alloc, retire, res_lo, res_hi)
    if backend in ("torch", "cuda"):
        # lazy import: core/ stays importable without torch
        from repro_torch.kernels.ops import can_delete_blocks_interval

        return can_delete_blocks_interval(
            alloc, retire, res_lo, res_hi,
            device="cpu" if backend == "torch" else "cuda")
    raise ValueError(f"unknown cleanup backend {backend!r}; one of {BACKENDS}")
