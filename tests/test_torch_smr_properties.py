"""The SMR invariants of ``test_smr_properties.py`` on the port's schemes,
each schedule run side by side through the port and through
``repro.core``.

Hypothesis draws an interleaved op sequence over several logical threads
(alloc / publish / protect / retire / clear / flush), executed
single-threaded: every shim operation is one linearization point, so any
such schedule is a legal concurrent history.  On the port, after every
operation:

  I1 (safety)     no block a thread protects (got since its last clear)
                  is freed;
  I3 (no-leak)    frees never exceed retires (a double free asserts).

And after every operation both packages have freed the same blocks
(identified by allocation order) with the same per-thread ``retire_count``
and ``free_count``.  At the end, once every reservation is cleared and
the threads have flushed, both have ``unreclaimed() == 0`` (I2,
liveness), and with WFE's slow path forced both took it equally often.
"""

import pytest

pytest.importorskip(
    "hypothesis",
    reason="hypothesis not installed (pip install -r requirements-dev.txt)")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import make_scheme as ref_make_scheme
from repro.core.atomics import AtomicRef as RefAtomicRef
from repro.core.atomics import PtrView as RefPtrView
from repro.core.smr_base import Block as RefBlock
from repro_torch.core import make_scheme
from repro_torch.core.atomics import AtomicRef, PtrView
from repro_torch.core.smr_base import Block

N_THREADS = 3
N_CELLS = 2


class _Node(Block):
    __slots__ = ("v",)

    def __init__(self, v=0):
        super().__init__()
        self.v = v

    def _poison_payload(self):
        self.v = None


class _RefNode(RefBlock):
    __slots__ = ("v",)

    def __init__(self, v=0):
        super().__init__()
        self.v = v

    def _poison_payload(self):
        self.v = None


OPS = st.sampled_from(["alloc_publish", "protect", "retire_current",
                       "clear", "flush"])


def _schedule():
    return st.lists(st.tuples(st.integers(0, N_THREADS - 1), OPS,
                              st.integers(0, N_CELLS - 1)),
                    min_size=1, max_size=60)


class _Run:
    """One package's scheme driven through a schedule: its cells, each
    thread's protected blocks and open bracket, every block in allocation
    order.  ``brackets``: the main test's start_op/end_op discipline;
    without it (the forced slow path) ``clear`` is ``smr.clear``."""

    def __init__(self, make, node, cell_cls, view_cls, scheme, kw,
                 brackets):
        self.smr = make(scheme, max_threads=N_THREADS, **kw)
        self.node, self.brackets = node, brackets
        self.tids = [self.smr.register_thread() for _ in range(N_THREADS)]
        self.cells = [cell_cls(None) for _ in range(N_CELLS)]
        self.views = [view_cls(c) for c in self.cells]
        self.protected = {t: set() for t in self.tids}
        self.in_bracket = {t: False for t in self.tids}
        self.allocs = []

    def _enter(self, tid):
        if self.brackets and not self.in_bracket[tid]:
            self.smr.start_op(tid)
            self.in_bracket[tid] = True

    def step(self, t, op, c):
        smr, tid = self.smr, self.tids[t]
        if op == "alloc_publish":
            self._enter(tid)
            blk = smr.alloc_block(self.node, tid, len(self.allocs))
            self.allocs.append(blk)
            self.cells[c].store(blk)
        elif op == "protect":
            self._enter(tid)
            got = smr.get_protected(self.views[c], c, tid)
            if got is not None:
                # I1 at acquisition: a protected block is not yet freed
                assert not got.freed, "protected a freed block"
                self.protected[tid].add(got)
        elif op == "retire_current":
            self._enter(tid)
            blk = self.cells[c].load()
            if blk is not None:  # unlink, then retire exactly once
                self.cells[c].store(None)
                smr.retire(blk, tid)
        elif op == "clear":
            if not self.brackets:
                smr.clear(tid)
            elif self.in_bracket[tid]:
                smr.end_op(tid)
                self.in_bracket[tid] = False
            self.protected[tid].clear()
        else:
            smr.flush(tid)

    def check(self):
        """I1 and I3 after an operation."""
        for held in self.protected.values():
            for blk in held:
                assert not blk.freed, "freed a protected block"
        assert sum(self.smr.free_count) <= sum(self.smr.retire_count)

    def state(self):
        """Freed blocks by allocation order, and the per-thread counts."""
        return ({i for i, b in enumerate(self.allocs) if b.freed},
                list(self.smr.retire_count), list(self.smr.free_count))

    def quiesce(self):
        """Release everything and flush every thread, six rounds."""
        for tid in self.tids:
            if not self.brackets:
                self.smr.clear(tid)
            elif self.in_bracket[tid]:
                self.smr.end_op(tid)
            self.protected[tid].clear()
        for _ in range(6):
            for tid in self.tids:
                self.smr.flush(tid)


def _side_by_side(scheme, kw, sched, brackets):
    """Run ``sched`` through both packages, holding I1/I3 on the port and
    the two packages' freed sets and counts equal after every operation;
    returns (port run, reference run) after the quiescent drain."""
    port = _Run(make_scheme, _Node, AtomicRef, PtrView, scheme, kw,
                brackets)
    ref = _Run(ref_make_scheme, _RefNode, RefAtomicRef, RefPtrView, scheme,
               kw, brackets)
    for i, (t, op, c) in enumerate(sched):
        port.step(t, op, c)
        ref.step(t, op, c)
        port.check()
        assert port.state() == ref.state(), (scheme, i, op)
    port.quiesce()
    ref.quiesce()
    assert port.state() == ref.state(), (scheme, "drain")
    return port, ref


@pytest.mark.parametrize("scheme", ["WFE", "HE", "HP", "2GEIBR"])
@settings(max_examples=60, deadline=None)
@given(sched=_schedule())
def test_protocol_invariants_under_random_schedules(scheme, sched):
    kw = ({"era_freq": 1, "cleanup_freq": 1} if scheme in ("WFE", "HE")
          else {"epoch_freq": 1, "cleanup_freq": 1} if scheme == "2GEIBR"
          else {"cleanup_freq": 1})
    port, ref = _side_by_side(scheme, kw, sched, brackets=True)
    # I2: every retired block freed once the reservations are gone
    assert port.smr.unreclaimed() == 0, f"{scheme}: blocks left unreclaimed"
    assert ref.smr.unreclaimed() == 0


@settings(max_examples=30, deadline=None)
@given(sched=_schedule())
def test_wfe_forced_slow_path_invariants(sched):
    """The same invariants with WFE's slow path forced on every protect."""
    kw = {"era_freq": 1, "cleanup_freq": 1, "max_attempts": 1}
    port, ref = _side_by_side("WFE", kw, sched, brackets=False)
    assert port.smr.unreclaimed() == 0
    assert ref.smr.unreclaimed() == 0
    assert list(port.smr.slow_path_count) == list(ref.smr.slow_path_count)
    assert sum(port.smr.slow_path_count) >= sum(
        1 for _, op, _ in sched if op == "protect")
