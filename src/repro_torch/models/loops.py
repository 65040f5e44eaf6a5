"""Loops whose trips run the same ops at the same shapes, counted from two
trips on ``meta`` tensors.

The dry run (``launch.dryrun``) runs a step on meta tensors, where values
do not exist and only shapes and ops matter.  A Python loop over 8
microbatches, 64 query chunks, 512 mLSTM chunks or 32 768 sLSTM steps
would dispatch every trip's ops there; :func:`counted_range` runs the first two trips instead and lets
the analysis (``launch.hlo_analysis``) count the second as often as the
trips after the first, as the reference's analysis multiplies a while
loop's body by its trip count.  Their gradients count as often: the
autograd nodes a trip creates are recorded by their sequence numbers, and
an op that runs in the backward of one of them counts by that node's
factor.  On any other device ``counted_range`` is ``range``.

What two trips do not show: a leaf's gradient that every trip adds to
(a weight read in each step) accumulates twice, not once a trip, so the
bytes of those adds are under-counted; and the list a loop keeps of its
per-trip outputs holds the second trip's output in place of the rest, so
the peak omits their storage.  The FLOPs are those of every trip.
"""

from __future__ import annotations

import bisect
import contextlib
import math

import torch

class Trips:
    """The loop factors of one analysis: the factors of the open loops,
    and the disjoint ranges of autograd sequence numbers the closed ones
    created, each with its factor.  ``launch.hlo_analysis.analyze``
    installs one for the step it runs (:func:`counting`)."""

    def __init__(self):
        self.open: list = []
        self.lo: list = []  # each range's first sequence number
        self.ranges: list = []  # (first, end, factor)

    @contextlib.contextmanager
    def trip(self, n: int):
        """Count the ops inside ``n`` times, their gradients too."""
        record = torch.is_grad_enabled()
        lo = _next_seq() if record else 0
        self.open.append(n)
        try:
            yield
        finally:
            self.open.pop()
            if record:
                self._record(lo, _next_seq(), n)

    def _record(self, lo: int, hi: int, n: int) -> None:
        """Multiply the ranges inside [lo, hi) by ``n`` and give ``n`` to
        the rest of it.  Loops close innermost first, so the ranges inside
        are the last ones recorded."""
        i = bisect.bisect_left(self.lo, lo)
        out, at = [], lo
        for a, b, f in self.ranges[i:]:
            if a > at:
                out.append((at, a, n))
            out.append((a, b, f * n))
            at = b
        if at < hi:
            out.append((at, hi, n))
        del self.ranges[i:], self.lo[i:]
        self.ranges.extend(out)
        self.lo.extend(a for a, _, _ in out)

    def factor(self) -> int:
        """How many times the op running now counts: the trips of the open
        loops, times those of the loop that created the autograd node whose
        backward runs it."""
        f = math.prod(self.open)
        node = torch._C._current_autograd_node()
        if node is not None and self.ranges:
            seq = node._sequence_nr()
            i = bisect.bisect_right(self.lo, seq) - 1
            if i >= 0 and seq < self.ranges[i][1]:
                f *= self.ranges[i][2]
        return f


_ACTIVE = None  # the Trips of the analysis running in this process


@contextlib.contextmanager
def counting():
    """Install a fresh :class:`Trips` for the duration (one analysis)."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, Trips()
    try:
        yield _ACTIVE
    finally:
        _ACTIVE = prev


def _next_seq() -> int:
    """The sequence number the next autograd node takes."""
    leaf = torch.empty(0, device="meta", requires_grad=True)
    return leaf.view(0).grad_fn._sequence_nr() + 1


def counted_range(n: int, like: torch.Tensor):
    """``range(n)`` for a loop whose trips run the same ops at the same
    shapes, except that the first may differ (its carries, zeros, need no
    gradient).  Where ``like`` is a meta tensor and ``n`` > 2 it yields 0
    and 1 only: trip 0 counts once and trip 1 stands for the ``n - 1``
    trips after it (under an analysis, :func:`counting`)."""
    if n <= 2 or like.device.type != "meta":
        yield from range(n)
        return
    yield 0
    trips = _ACTIVE
    with trips.trip(n - 1) if trips is not None else contextlib.nullcontext():
        yield 1
