"""The port's SMR core under threads (``pytest -m stress``): WFE's slow
path and helping, the paper's wait-free mechanism, and Crystalline's,
ported from ``test_smr_stress.py`` onto ``repro_torch.core``.

``max_attempts=1`` forces the slow path on every protected dereference
(paper §5), and 8 threads mix protected reads with swap-and-retire on
shared cells:

* no use-after-free: the poisoning ``free()`` makes an unsafe reclamation
  visible, and a protected reader must never see a freed block or a
  poisoned payload; for WFE and Crystalline, and for every other scheme
  that claims wait-freedom or bounded memory, whose sampled unreclaimed
  count stays under the reference's c T^2 H bound and drains to zero;
* helping works: across up to six rounds some request is served by a
  helper (``helped_count > 0``), and the slow path ran;
* Crystalline's batches: every sealed batch is freed exactly once;
* WFE's era advancers against forced-slow-path readers (the hand-over
  WCAS of ``help_thread``).

The threads, operations, cells and bounds are the reference's.  Each case
runs with the interpreter's thread switch interval at 0.1 ms (restored
after it) where the default is 5 ms: the threads then interleave within
a few operations instead of running one after another, which is what
makes helping fire, and the era advancers' case takes seconds, not a
minute.  Each case runs under its own time limit: its threads are joined
with a deadline, and a thread still running fails the case.
"""

import sys
import threading
import time

import pytest

from repro_torch.core import SCHEMES, Block, make_scheme
from repro_torch.core.atomics import AtomicRef, PtrView
from repro_torch.core.wfe import WFE

pytestmark = pytest.mark.stress

STRESS_SCHEMES = sorted(name for name, cls in SCHEMES.items()
                        if cls.wait_free or cls.bounded_memory)
N_THREADS = 8
OPS = 250
N_CELLS = 4
LIMIT_S = 60.0  # each case's time limit


@pytest.fixture(autouse=True)
def _fine_interleaving():
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    yield
    sys.setswitchinterval(prev)


class _Node(Block):
    __slots__ = ("payload",)

    def __init__(self, payload):
        super().__init__()
        self.payload = payload

    def _poison_payload(self):
        self.payload = None


def _make(name: str, max_threads: int, force_slow: bool = False):
    kw = {}
    if name in ("WFE", "HE", "Crystalline"):
        kw = {"era_freq": 1, "cleanup_freq": 1}
    elif name in ("EBR", "2GEIBR"):
        kw = {"epoch_freq": 1, "cleanup_freq": 1}
    elif name == "HP":
        kw = {"cleanup_freq": 1}
    if name == "Crystalline":
        kw["batch_size"] = 3  # small batches: frequent seals under stress
    if force_slow and name in ("WFE", "Crystalline"):
        kw["max_attempts"] = 1  # slow path on every get_protected
    return make_scheme(name, max_threads=max_threads, **kw)


def _run(threads, deadline):
    """Start ``threads`` (daemons) and join them by ``deadline``; a thread
    still running fails the case instead of stalling the run."""
    for t in threads:
        t.daemon = True
        t.start()
    for t in threads:
        t.join(timeout=max(0.0, deadline - time.monotonic()))
    stuck = sum(t.is_alive() for t in threads)
    assert not stuck, f"{stuck} threads still running at the time limit"


def _drain_to_zero(smr, rounds: int = 100) -> int:
    """Quiesce every thread, then advance eras and flush until the retire
    lists drain; the residual unreclaimed count."""
    for tid in range(smr.max_threads):
        smr.end_op(tid)
    for _ in range(rounds):
        if smr.unreclaimed() == 0:
            return 0
        for tid in range(smr.max_threads):
            smr.advance_era(tid)
            smr.flush(tid)
    return smr.unreclaimed()


def _hammer(smr, deadline):
    """N_THREADS threads, each mixing protected reads with
    swap-and-retire.  Returns (errors, sampled unreclaimed peak, retired).
    """
    cells = [AtomicRef(None) for _ in range(N_CELLS)]
    views = [PtrView(c) for c in cells]
    start = threading.Barrier(N_THREADS)
    errors = []
    peak = [0] * N_THREADS

    def worker(widx):
        tid = smr.register_thread()
        seed = smr.alloc_block(_Node, tid, (tid, -1))
        cells[widx % N_CELLS].cas(None, seed)
        start.wait()
        try:
            for i in range(OPS):
                c = (widx + i) % N_CELLS
                smr.start_op(tid)
                blk = smr.get_protected(views[c], 0, tid)
                if blk is not None:
                    assert not blk.freed, "reader observed a freed block"
                    assert blk.payload is not None, \
                        "reader observed a poisoned payload"
                    if i % 3 == widx % 3:
                        new = smr.alloc_block(_Node, tid, (tid, i))
                        # identity CAS: exactly one swapper retires blk
                        if cells[c].cas(blk, new):
                            smr.retire(blk, tid)
                smr.end_op(tid)
                if i % 16 == 0:
                    peak[widx] = max(peak[widx], smr.unreclaimed())
        except Exception as e:  # pragma: no cover - failure path
            errors.append(e)

    _run([threading.Thread(target=worker, args=(w,))
          for w in range(N_THREADS)], deadline)
    return errors, max(peak), sum(smr.retire_count)


@pytest.mark.parametrize("name", STRESS_SCHEMES)
def test_stress_no_uaf_and_bounded(name):
    deadline = time.monotonic() + LIMIT_S
    smr = _make(name, N_THREADS, force_slow=True)
    errors, peak, retired = _hammer(smr, deadline)
    assert not errors, errors[0]
    assert retired > 0, "workload never exercised retirement"
    if SCHEMES[name].bounded_memory:
        h = getattr(smr, "max_hes", getattr(smr, "max_hps", 1))
        bound = 4 * N_THREADS * (N_THREADS * h + 64)
        assert peak <= bound, f"{name}: unreclaimed peaked at {peak} > {bound}"
        assert _drain_to_zero(smr) == 0, f"{name} leaked at quiescence"


@pytest.mark.parametrize("name", ("WFE", "Crystalline"))
def test_stress_forced_slow_path_helping(name):
    """Whether a request is served by a helper is a scheduling race, so one
    round may see none; across six rounds a live helping path fires while
    a dead one never does."""
    deadline = time.monotonic() + LIMIT_S
    slow = helped = 0
    for _ in range(6):
        smr = _make(name, N_THREADS, force_slow=True)
        errors, _, _ = _hammer(smr, deadline)
        assert not errors, errors[0]
        slow += sum(smr.slow_path_count)
        helped += sum(smr.helped_count)
        assert _drain_to_zero(smr) == 0, f"{name} leaked at quiescence"
        if helped:
            break
    assert slow > 0, "slow path never taken"
    assert helped > 0, "no request was ever served by a helper"


def test_stress_crystalline_batch_linkage():
    deadline = time.monotonic() + LIMIT_S
    smr = _make("Crystalline", N_THREADS, force_slow=True)
    errors, _, retired = _hammer(smr, deadline)
    assert not errors, errors[0]
    assert retired > 0
    assert _drain_to_zero(smr) == 0, "Crystalline leaked at quiescence"
    sealed, freed = sum(smr.batches_sealed), sum(smr.batches_freed)
    assert sealed > 0, "no batch was ever sealed"
    assert freed == sealed, f"{sealed} batches sealed, {freed} freed"
    assert smr.pending() == 0
    assert sum(smr.free_count) == sum(smr.retire_count)


def test_stress_wfe_era_advancers_vs_slow_path():
    deadline = time.monotonic() + LIMIT_S
    smr = WFE(max_threads=N_THREADS, max_attempts=1, era_freq=1,
              cleanup_freq=1)
    cell = AtomicRef(None)
    view = PtrView(cell)
    start = threading.Barrier(N_THREADS)
    stop = threading.Event()
    errors = []

    def advancer():
        tid = smr.register_thread()
        cell.cas(None, smr.alloc_block(_Node, tid, 0))
        start.wait()
        for i in range(OPS):
            new = smr.alloc_block(_Node, tid, i)
            old = cell.load()
            if old is not None and cell.cas(old, new):
                smr.retire(old, tid)
        stop.set()

    def reader():
        tid = smr.register_thread()
        start.wait()
        try:
            ops = 0
            while not stop.is_set() or ops < 20:
                blk = smr.get_protected(view, 0, tid)
                if blk is not None:
                    assert not blk.freed
                smr.clear(tid)
                ops += 1
        except Exception as e:  # pragma: no cover
            errors.append(e)

    _run([threading.Thread(target=advancer) for _ in range(2)]
         + [threading.Thread(target=reader) for _ in range(N_THREADS - 2)],
         deadline)
    assert not errors, errors[0]
    assert sum(smr.slow_path_count) > 0
    assert _drain_to_zero(smr) == 0
