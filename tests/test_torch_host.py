"""The port's host layer (``repro_torch.core`` / ``repro_torch.blocks``) held
against the reference and against the pool and scheduler cases of
``test_blocks_serve``.

The era table's ``scalar|numpy|torch`` backends must return bit-identical
masks; the ``cuda`` backend is held to them on the card
(``test_torch_cuda.py``).  The port's WFE, driven through the same seeded
history as ``repro.core``'s, must end in the same state.
"""

import threading
import zlib

import numpy as np
import pytest

from repro.core import SCHEMES as REF_SCHEMES
from repro.core import make_scheme as ref_make_scheme
from repro.core.atomics import AtomicRef as RefAtomicRef
from repro.core.atomics import PtrView as RefPtrView
from repro.core.smr_base import Block as RefBlock
from repro_torch.blocks import (BlockPool, BlockTableRef, PoolExhausted,
                                Scheduler)
from repro_torch.core import SCHEMES, WFE, make_scheme
from repro_torch.core.atomics import MIRROR_INF, AtomicRef, PtrView
from repro_torch.core.era_table import batched_can_delete
from repro_torch.core.smr_base import Block

CPU_BACKENDS = ("scalar", "numpy", "torch")


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


# ------------------------------------------------- era-table backends
def _random_intervals(seed):
    rng = np.random.default_rng(seed)
    r = int(rng.integers(1, 400))
    s = int(rng.integers(1, 700))
    alloc = rng.integers(0, 120, r).astype(np.int32)
    retire = (alloc + rng.integers(0, 60, r)).astype(np.int32)
    lo = rng.integers(0, 200, s).astype(np.int32)
    hi = np.where(rng.random(s) < 0.5, lo,
                  lo + rng.integers(0, 40, s)).astype(np.int32)
    lo[rng.random(s) < 0.4] = MIRROR_INF
    return alloc, retire, lo, hi


@pytest.mark.parametrize("seed", range(6))
def test_backends_identical_on_random_intervals(seed):
    """scalar == numpy == torch on randomized lifetimes/reservations."""
    args = _random_intervals(seed)
    masks = [batched_can_delete(*args, backend=b) for b in CPU_BACKENDS]
    for b, m in zip(CPU_BACKENDS[1:], masks[1:]):
        assert m.dtype == np.bool_
        np.testing.assert_array_equal(masks[0], m, err_msg=b)


def test_backends_identical_boundary_eras():
    """alloc == era == retire blocks deletion in every backend; adjacent
    eras outside the lifetime do not."""
    alloc = np.array([5, 5, 5, 5], np.int32)
    retire = np.array([10, 10, 10, 10], np.int32)
    for era, deletable in [(5, False), (10, False), (4, True), (11, True),
                           (MIRROR_INF, True)]:
        lo = np.array([era], np.int32)
        for b in CPU_BACKENDS:
            got = batched_can_delete(alloc, retire, lo, lo, backend=b)
            assert bool(got.all()) == deletable, (b, era)


def test_unknown_backend_raises():
    one = np.zeros(1, np.int32)
    with pytest.raises(ValueError, match="pallas"):
        batched_can_delete(one, one, one, one, backend="pallas")


def test_scheme_registry_matches_reference():
    """Every scheme of the reference registry is ported under its name;
    HP is a scheme of its own but the pool refuses it, as the reference's
    does (one pointer slot cannot cover a step's snapshot)."""
    assert list(SCHEMES) == list(REF_SCHEMES)
    for name, cls in SCHEMES.items():
        assert cls.__name__ == REF_SCHEMES[name].__name__
    assert isinstance(make_scheme("WFE", max_threads=2), WFE)
    assert make_scheme("HP", max_threads=2).name == "HP"
    with pytest.raises(ValueError, match="Hazard Pointers"):
        BlockPool(4, scheme="HP")
    with pytest.raises(ValueError, match="unknown SMR scheme"):
        make_scheme("RCU", max_threads=2)


# ------------------------------------------------- WFE against the reference
def _history(smr, node, cell_cls, view_cls, rng, n_ops=160, n_threads=3):
    """Drive a scheme through a seeded single-threaded-legal history (the
    generator of ``test_cleanup_batch._random_history``)."""
    tids = [smr.register_thread() for _ in range(n_threads)]
    cells = [cell_cls(None) for _ in range(2)]
    views = [view_cls(c) for c in cells]
    for _ in range(n_ops):
        t = tids[int(rng.integers(n_threads))]
        c = int(rng.integers(2))
        op = rng.random()
        if op < 0.35:
            smr.start_op(t)
            cells[c].store(smr.alloc_block(node, t, 1))
        elif op < 0.6:
            smr.start_op(t)
            if cells[c].load() is not None:
                smr.get_protected(views[c], c % smr.max_hes, t)
        elif op < 0.85:
            blk = cells[c].load()
            if blk is not None:
                cells[c].store(None)
                smr.retire(blk, t)
        else:
            smr.end_op(t)
    return tids


@pytest.mark.parametrize("max_attempts", [16, 1])
@pytest.mark.parametrize("seed", range(4))
def test_wfe_matches_reference_history(seed, max_attempts):
    """The same seeded history through the port's WFE and the reference's
    leaves the same stats, era mirrors and deletable masks; every CPU
    backend agrees with the reference's numpy backend."""
    kw = dict(era_freq=3, cleanup_freq=5, max_attempts=max_attempts)
    port = make_scheme("WFE", max_threads=3, **kw)
    ref = ref_make_scheme("WFE", max_threads=3, **kw)
    s = 1000 * seed + zlib.crc32(b"WFE") + max_attempts
    tids = _history(port, _Node, AtomicRef, PtrView, np.random.default_rng(s))
    _history(ref, _RefNode, RefAtomicRef, RefPtrView,
             np.random.default_rng(s))
    assert port.stats() == ref.stats()
    np.testing.assert_array_equal(port.era_table.lo, ref.era_table.lo)
    if max_attempts == 1:
        assert port.stats()["slow_paths"] > 0
    for tid in tids:
        want = ref.deletable_mask(tid, "numpy")
        for b in CPU_BACKENDS:
            np.testing.assert_array_equal(port.deletable_mask(tid, b), want,
                                          err_msg=f"{b}/tid{tid}")


def test_wfe_forced_slow_path_self_completes():
    """max_attempts=1 skips the fast path; with a quiet era clock the thread
    self-completes its request (paper lines 37-41)."""
    smr = WFE(max_threads=2, max_attempts=1)
    tid = smr.register_thread()
    cell = AtomicRef(None)
    blk = smr.alloc_block(_Node, tid, 1)
    cell.store(blk)
    assert smr.get_protected(PtrView(cell), 0, tid) is blk
    assert smr.slow_path_count[tid] == 1
    assert smr.stats()["slow_paths"] == 1
    assert smr.counter_start.load() == smr.counter_end.load() == 1
    assert smr.reservations[tid][0].load_b() == 1


# ================================================================ pool
def test_pool_alloc_free_roundtrip():
    pool = BlockPool(8, max_threads=2, era_freq=1, cleanup_freq=1)
    tid = pool.register_thread()
    blks = [pool.alloc(tid) for _ in range(8)]
    assert pool.free_blocks == 0
    assert sorted(b.index for b in blks) == list(range(8))
    with pytest.raises(PoolExhausted):
        pool.alloc(tid)
    for b in blks:
        pool.retire(b, tid)
    for _ in range(16):
        pool.cleanup(tid)
    assert pool.free_blocks == 8
    again = [pool.alloc(tid) for _ in range(8)]
    assert sorted(b.index for b in again) == list(range(8))


def test_protected_step_blocks_reclaim():
    """A published step reservation must pin blocks retired after it."""
    pool = BlockPool(4, max_threads=2, era_freq=1, cleanup_freq=1)
    t0 = pool.register_thread()
    t1 = pool.register_thread()
    blk = pool.alloc(t0)
    pool.protect_step(0, t1)
    pool.retire(blk, t0)
    for _ in range(16):
        pool.cleanup(t0)
    assert not blk.freed, "reserved era did not protect the block"
    pool.release_step(0, t1)
    for _ in range(16):
        pool.cleanup(t0)
    assert blk.freed


@pytest.mark.parametrize("backend", CPU_BACKENDS)
def test_vectorized_cleanup_matches_scalar(backend):
    """The batched cleanup frees exactly what the scalar cleanup would."""
    pool = BlockPool(256, max_threads=2, era_freq=1, cleanup_freq=10**9,
                     cleanup_backend=backend)
    t0 = pool.register_thread()
    t1 = pool.register_thread()
    blks = [pool.alloc(t0) for _ in range(128)]
    pool.protect_step(0, t1)
    for b in blks:
        pool.retire(b, t0)
    pool.cleanup(t0, vectorized_threshold=1)
    assert all(not b.freed for b in blks), "protected blocks freed"
    pool.release_step(0, t1)
    pool.cleanup(t0, vectorized_threshold=1)
    assert all(b.freed for b in blks), "unprotected blocks kept"


def test_use_kernel_selects_cuda_backend():
    """use_kernel=True maps to the cuda scan; the default stays numpy."""
    assert BlockPool(4, use_kernel=True).cleanup_backend == "cuda"
    assert BlockPool(4).cleanup_backend == "numpy"


def test_table_versions_are_smr_nodes():
    pool = BlockPool(16, max_threads=2, era_freq=1, cleanup_freq=1)
    tid = pool.register_thread()
    table = BlockTableRef(pool, tid)
    for _ in range(4):
        table.append_block(tid)
    assert len(table) == 4
    assert len(set(table.current().block_ids)) == 4
    table.release_all(tid)
    for _ in range(32):
        pool.cleanup(tid)
    assert pool.free_blocks == 16


def test_pool_concurrent_stress():
    """Writers churn blocks while readers hold step reservations."""
    pool = BlockPool(64, max_threads=4, era_freq=2, cleanup_freq=2)
    stop = threading.Event()
    errors = []

    def churn():
        tid = pool.register_thread()
        try:
            for _ in range(300):
                blks = [pool.alloc(tid) for _ in range(4)]
                for b in blks:
                    pool.retire(b, tid)
                pool.cleanup(tid)
            for _ in range(64):
                pool.cleanup(tid)
        except Exception as e:  # pragma: no cover
            errors.append(e)
        finally:
            stop.set()

    def reader():
        tid = pool.register_thread()
        try:
            while not stop.is_set():
                pool.protect_step(0, tid)
                pool.release_step(0, tid)
        except Exception as e:  # pragma: no cover
            errors.append(e)

    ts = [threading.Thread(target=churn)] + [
        threading.Thread(target=reader) for _ in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in ts)
    assert not errors, errors[0] if errors else None


# ================================================================ scheduler
def test_scheduler_basic_flow():
    pool = BlockPool(32, max_threads=2, era_freq=1, cleanup_freq=1)
    tid = pool.register_thread()
    sched = Scheduler(pool, block_size=4, max_batch=4)
    reqs = [sched.submit([1, 2, 3], max_new_tokens=5) for _ in range(6)]
    steps = 0
    while any(not r.done for r in reqs) and steps < 500:
        plan = sched.tick(tid)
        if plan is None:
            break
        sched.complete(plan, np.full((len(plan.requests),), 7, np.int64), tid)
        steps += 1
    assert all(r.done for r in reqs), [r.state for r in reqs]
    assert all(r.generated == [7] * 5 for r in reqs)
    assert sched.stats["completed"] == 6
    for _ in range(32):
        pool.cleanup(tid)
    assert pool.free_blocks == 32, "blocks leaked after completion"


def test_scheduler_eviction_under_pressure():
    """A tiny pool forces eviction; evicted requests still finish."""
    pool = BlockPool(6, max_threads=2, era_freq=1, cleanup_freq=1)
    tid = pool.register_thread()
    sched = Scheduler(pool, block_size=2, max_batch=4)
    reqs = [sched.submit([1, 2], max_new_tokens=6) for _ in range(4)]
    steps = 0
    while any(not r.done for r in reqs) and steps < 2000:
        plan = sched.tick(tid)
        if plan is None:
            pool.cleanup(tid)
            steps += 1
            continue
        sched.complete(plan, np.full((len(plan.requests),), 3, np.int64), tid)
        steps += 1
    assert all(r.done for r in reqs), [(r.state, r.length) for r in reqs]
    assert sched.stats["evictions"] > 0, "pressure never triggered eviction"
