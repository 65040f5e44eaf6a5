"""The conformance matrix of ``test_conformance_matrix.py`` on the port:
every SMR scheme x every data structure of ``repro_torch.core`` under a
4-thread mixed workload, held against ``repro.core``'s same structure
under the same scheme.

* Key-value structures: each thread owns a disjoint key range and runs a
  seeded insert/delete/get script against a local model, reading the
  other threads' ranges now and then (the values read must never be
  poisoned payloads).  With one writer per key, a thread's results on its
  own keys do not depend on the interleaving: the sequence of them, and
  the sweep at quiescence, must equal what the reference's structure
  answers to the same scripts run one thread after another (which also
  keeps the reference's known BST fault from showing: it needs
  concurrent deletes).
* Queues: 2 producers / 2 consumers; the dequeued multiset is the
  enqueued one (as the reference's structure dequeues it, run
  sequentially) and each producer's items come out in FIFO order.
* Stack: 2 pushers / 2 poppers; popped and residual items are the pushed
  multiset, as the reference's stack returns it.

Every cell ends with full reclamation at quiescence (``quiescence_check``)
and ``Leak`` is the control that must not drain.
"""

import random
import threading
import time

import pytest

from repro.core import make_scheme as ref_make_scheme
from repro.core import datastructures as ref_ds
from repro_torch.core import datastructures as ds
from repro_torch.core import make_scheme

pytestmark = pytest.mark.stress

SCHEMES = ("WFE", "Crystalline", "HE", "HP", "EBR", "2GEIBR")
KV_STRUCTS = {"list": "HarrisMichaelList", "hashmap": "MichaelHashMap",
              "bst": "NatarajanBST"}
QUEUES = {"kp": "KPQueue", "crturn": "CRTurnQueue"}

N_THREADS = 4
KEYS_PER_THREAD = 12
OPS = 150


def _smr(make, scheme, n=N_THREADS):
    kw = ({"era_freq": 2, "cleanup_freq": 2} if scheme in ("WFE", "HE")
          else {"epoch_freq": 2, "cleanup_freq": 2}
          if scheme in ("EBR", "2GEIBR") else {"cleanup_freq": 2})
    if scheme == "Crystalline":
        # batch_size=3: uneven against the workload sizes, so sealed
        # batches AND pending remainders both occur at quiescence
        kw["batch_size"] = 3
    return make(scheme, max_threads=n, **kw)


def _kv_worker(d, w, tid, model, label):
    """Thread ``w``'s seeded script on ``d``; returns its results on its
    own keys, each asserted against ``model`` as it goes."""
    lo = w * KEYS_PER_THREAD
    r = random.Random(1000 + w)
    own = []
    for i in range(OPS):
        key = lo + r.randrange(KEYS_PER_THREAD)
        op = r.random()
        if op < 0.4:
            got = d.insert(key, (w, i), tid)
            assert got == (key not in model), (*label, "insert", key)
            model.setdefault(key, (w, i))
        elif op < 0.7:
            got = d.delete(key, tid)
            assert got == (key in model), (*label, "delete", key)
            model.pop(key, None)
        else:
            got = d.get(key, tid)
            assert got == model.get(key), (*label, "get", key)
        own.append(got)
        if i % 7 == 0:
            # cross-thread read traffic: someone else's range; the value
            # is racy but must never be a poisoned payload
            other = ((w + 1) % N_THREADS) * KEYS_PER_THREAD \
                + r.randrange(KEYS_PER_THREAD)
            got = d.get(other, tid)
            assert got is None or isinstance(got, tuple), \
                (*label, "cross-read saw poison", got)
    return own


def _sweep(d, tid=0):
    return [d.get(key, tid) for key in range(N_THREADS * KEYS_PER_THREAD)]


def _kv_reference(name, scheme):
    """The reference's structure under the same scheme, the four scripts
    run one after another: (own-key results per thread, final sweep)."""
    smr = _smr(ref_make_scheme, scheme)
    d = getattr(ref_ds, KV_STRUCTS[name])(smr)
    tids = [smr.register_thread() for _ in range(N_THREADS)]
    own = [_kv_worker(d, w, tids[w], {}, (name, scheme, "reference"))
           for w in range(N_THREADS)]
    return own, _sweep(d)


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("name", sorted(KV_STRUCTS))
def test_kv_matrix_mixed_workload(name, scheme, quiescence_check):
    smr = _smr(make_scheme, scheme)
    d = getattr(ds, KV_STRUCTS[name])(smr)
    start = threading.Barrier(N_THREADS)
    errors = []
    models = [dict() for _ in range(N_THREADS)]
    own = [None] * N_THREADS

    def worker(w):
        tid = smr.register_thread()
        start.wait()
        try:
            own[w] = _kv_worker(d, w, tid, models[w], (name, scheme))
        except Exception as e:  # pragma: no cover - failure path
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(w,))
               for w in range(N_THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors, errors[0]
    # quiescent sweep: the union of the per-owner models IS the structure
    sweep = _sweep(d)
    for w in range(N_THREADS):
        for key in range(w * KEYS_PER_THREAD, (w + 1) * KEYS_PER_THREAD):
            assert sweep[key] == models[w].get(key), \
                (name, scheme, "final", key)
    want_own, want_sweep = _kv_reference(name, scheme)
    assert own == want_own, (name, scheme, "own-key results")
    assert sweep == want_sweep, (name, scheme, "sweep")
    smr.clear(0)
    quiescence_check(smr, label=f"{name}/{scheme}")


def _queue_reference(name, scheme, n_items):
    """The reference's queue, producers then one consumer, one thread."""
    smr = _smr(ref_make_scheme, scheme)
    q = getattr(ref_ds, QUEUES[name])(smr)
    tid = smr.register_thread()
    for p in range(2):
        for i in range(n_items):
            q.enqueue(p * 10_000 + i, tid)
    out = []
    while (got := q.dequeue(tid)) is not None:
        out.append(got)
    return out


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("name", sorted(QUEUES))
def test_queue_matrix_mpmc(name, scheme, quiescence_check):
    smr = _smr(make_scheme, scheme)
    q = getattr(ds, QUEUES[name])(smr)
    n_items = 120
    start = threading.Barrier(N_THREADS)
    errors = []
    popped = [list() for _ in range(2)]
    done = threading.Event()

    def producer(p):
        tid = smr.register_thread()
        start.wait()
        for i in range(n_items):
            q.enqueue(p * 10_000 + i, tid)

    def consumer(c):
        tid = smr.register_thread()
        start.wait()
        try:
            while not done.is_set():
                got = q.dequeue(tid)
                if got is not None:
                    popped[c].append(got)
                    if sum(len(x) for x in popped) >= 2 * n_items:
                        done.set()
        except Exception as e:  # pragma: no cover
            errors.append(e)

    producers = [threading.Thread(target=producer, args=(p,))
                 for p in range(2)]
    consumers = [threading.Thread(target=consumer, args=(c,))
                 for c in range(2)]
    for t in producers + consumers:
        t.start()
    for t in producers:
        t.join(timeout=300)
    # producers done: wait (bounded wall-clock) for consumers to drain
    deadline = time.monotonic() + 120
    while (sum(len(x) for x in popped) < 2 * n_items
           and time.monotonic() < deadline):
        done.wait(0.01)
    done.set()
    for t in consumers:
        t.join(timeout=300)
    assert not errors, errors[0]
    got = sorted(popped[0] + popped[1])
    want = sorted(p * 10_000 + i for p in range(2) for i in range(n_items))
    assert got == want, (name, scheme, "dequeue multiset mismatch")
    assert got == sorted(_queue_reference(name, scheme, n_items))
    # linearizable MPMC FIFO: each producer's items appear in order within
    # each consumer's local sequence
    for c in range(2):
        for p in range(2):
            sub = [v for v in popped[c] if v // 10_000 == p]
            assert sub == sorted(sub), (name, scheme, "per-producer order")
    assert q.dequeue(0) is None
    quiescence_check(smr, label=f"{name}/{scheme}")


def _stack_reference(scheme, n_items):
    """The reference's stack, pushers then one popper, one thread."""
    smr = _smr(ref_make_scheme, scheme)
    s = ref_ds.TreiberStack(smr)
    tid = smr.register_thread()
    for p in range(2):
        for i in range(n_items):
            s.push(p * 10_000 + i, tid)
    out = []
    while (got := s.pop(tid)) is not None:
        out.append(got)
    return out


@pytest.mark.parametrize("scheme", SCHEMES)
def test_stack_matrix_concurrent(scheme, quiescence_check):
    smr = _smr(make_scheme, scheme)
    s = ds.TreiberStack(smr)
    n_items = 150
    start = threading.Barrier(N_THREADS)
    errors = []
    popped = [list() for _ in range(2)]
    stop = threading.Event()

    def pusher(p):
        tid = smr.register_thread()
        start.wait()
        for i in range(n_items):
            s.push(p * 10_000 + i, tid)

    def popper(c):
        tid = smr.register_thread()
        start.wait()
        try:
            while not stop.is_set():
                got = s.pop(tid)
                if got is not None:
                    popped[c].append(got)
        except Exception as e:  # pragma: no cover
            errors.append(e)

    pushers = [threading.Thread(target=pusher, args=(p,)) for p in range(2)]
    poppers = [threading.Thread(target=popper, args=(c,)) for c in range(2)]
    for t in pushers + poppers:
        t.start()
    for t in pushers:
        t.join(timeout=300)
    stop.set()
    for t in poppers:
        t.join(timeout=300)
    assert not errors, errors[0]
    residual = []
    while (got := s.pop(0)) is not None:
        residual.append(got)
    got_all = sorted(popped[0] + popped[1] + residual)
    want = sorted(p * 10_000 + i for p in range(2) for i in range(n_items))
    assert got_all == want, (scheme, "push/pop multiset mismatch")
    assert got_all == sorted(_stack_reference(scheme, n_items))
    quiescence_check(smr, label=f"stack/{scheme}")


# ---------------------------------------------------- no-reclamation control
def _leak_script(mod, make, name):
    smr = make("Leak", max_threads=N_THREADS)
    d = getattr(mod, KV_STRUCTS[name])(smr)
    tid = smr.register_thread()
    r = random.Random(7)
    out = []
    for i in range(OPS):
        key = r.randrange(KEYS_PER_THREAD)
        if r.random() < 0.5:
            out.append(d.insert(key, (0, i), tid))
        else:
            out.append(d.delete(key, tid))
    return smr, out


@pytest.mark.parametrize("name", sorted(KV_STRUCTS))
def test_leak_control_fails_quiescence(name, quiescence_check):
    """Leak as the negative control: the same workload must FAIL the
    quiescence check, or a scheme that silently stopped reclaiming would
    pass the whole matrix too."""
    smr, out = _leak_script(ds, make_scheme, name)
    ref, ref_out = _leak_script(ref_ds, ref_make_scheme, name)
    assert out == ref_out
    assert sum(smr.retire_count) == sum(ref.retire_count) > 0, \
        "workload never retired a node"
    left = quiescence_check(smr, label=f"{name}/Leak", expect_drain=False)
    assert left == sum(smr.retire_count), \
        "Leak must hold every retired node (frees nothing, loses nothing)"
