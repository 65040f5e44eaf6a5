"""The port's NatarajanBST retires the leaf a helped delete splices out.

When a thread's cleanup finds its own leaf's edge unflagged, the delete it
is helping flagged the sibling edge: that sibling leaf is the one the
splice removes, and the thread's own leaf stays in the tree.  Retiring the
thread's own leaf instead frees a node that is still reachable, and its
own delete later retires it a second time (a double free).

``test_helped_delete_retires_the_flagged_leaf`` drives one helped delete
by hand.  The stress test runs the conformance matrix's workload (4
threads, 12 keys each, 150 operations, a 5e-5 s switch interval) many
times under four schemes, with each thread's keys interleaved with the
others' so that neighbouring leaves belong to different threads and
helped deletes are common.  The reference's copy keeps the fault; only
the port's is fixed.
"""

from __future__ import annotations

import random
import sys
import threading

import pytest

from repro_torch.core import make_scheme
from repro_torch.core.datastructures import NatarajanBST
from repro_torch.core.datastructures.natarajan_bst import _k

N_THREADS = 4
KEYS_PER_THREAD = 12
OPS = 150
RUNS = 150


def _smr(scheme: str, n: int = N_THREADS):
    kw = ({"era_freq": 2, "cleanup_freq": 2} if scheme in ("WFE", "HE")
          else {"epoch_freq": 2, "cleanup_freq": 2}
          if scheme in ("EBR", "2GEIBR") else {"cleanup_freq": 2})
    if scheme == "Crystalline":
        kw["batch_size"] = 3
    return make_scheme(scheme, max_threads=n, **kw)


@pytest.mark.parametrize("scheme", ("WFE", "EBR"))
def test_helped_delete_retires_the_flagged_leaf(scheme):
    smr = _smr(scheme, n=2)
    ds = NatarajanBST(smr)
    a, b = smr.register_thread(), smr.register_thread()
    assert ds.insert(1, "one", a) and ds.insert(2, "two", a)
    # thread a's delete of 1 flags the edge to leaf 1 and stops there
    smr.start_op(a)
    rec1 = ds._seek(_k(1), a)
    leaf1, parent = rec1.leaf, rec1.parent
    assert leaf1.key == _k(1)
    cell1 = parent.left if _k(1) < parent.key else parent.right
    assert cell1.cas((leaf1, False, False), (leaf1, True, False))
    # thread b, seeking 2, meets the sibling of the flagged edge and helps
    retired = []
    real_retire = smr.retire

    def spy(blk, tid):
        retired.append(blk)
        real_retire(blk, tid)

    smr.retire = spy
    smr.start_op(b)
    rec2 = ds._seek(_k(2), b)
    leaf2 = rec2.leaf
    assert leaf2.key == _k(2) and rec2.parent is parent
    assert ds._cleanup(_k(2), rec2, b)
    smr.end_op(b)
    smr.end_op(a)
    assert retired == [parent, leaf1]
    assert not leaf2.freed
    assert ds.get(2, b) == "two" and ds.get(1, b) is None
    # a's delete now finds its leaf gone and retires nothing more
    assert ds.delete(1, a) is False
    assert retired == [parent, leaf1]
    assert ds.delete(2, b) and ds.get(2, a) is None


def _one_run(scheme: str, seed: int):
    smr = _smr(scheme)
    ds = NatarajanBST(smr)
    start = threading.Barrier(N_THREADS)
    errors = []

    def worker(w):
        tid = smr.register_thread()
        r = random.Random(seed * 100 + w)
        model = {}
        start.wait()
        try:
            for i in range(OPS):
                # thread w owns keys w, w + 4, w + 8, ...
                key = w + N_THREADS * r.randrange(KEYS_PER_THREAD)
                op = r.random()
                if op < 0.4:
                    assert ds.insert(key, (w, i), tid) == (key not in model)
                    model.setdefault(key, (w, i))
                elif op < 0.7:
                    assert ds.delete(key, tid) == (key in model)
                    model.pop(key, None)
                else:
                    assert ds.get(key, tid) == model.get(key)
                if i % 7 == 0:
                    got = ds.get((w + 1) % N_THREADS
                                 + N_THREADS * r.randrange(KEYS_PER_THREAD),
                                 tid)
                    assert got is None or isinstance(got, tuple)
        except Exception as e:  # pragma: no cover - failure path
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(w,), daemon=True)
               for w in range(N_THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=20)
    if any(t.is_alive() for t in threads):
        errors.append("a worker hung")
    return errors, smr


@pytest.mark.stress
@pytest.mark.parametrize("scheme", ("WFE", "EBR", "2GEIBR", "Crystalline"))
def test_bst_helping_stress_no_double_free(scheme, quiescence_check):
    old = sys.getswitchinterval()
    sys.setswitchinterval(5e-5)
    try:
        for seed in range(RUNS):
            errors, smr = _one_run(scheme, seed)
            assert not errors, (scheme, seed, errors[0])
    finally:
        sys.setswitchinterval(old)
    smr.clear(0)
    quiescence_check(smr, label=f"bst/{scheme}")
