"""The port's SMR schemes, data structures and pool schemes held against
``repro.core`` and ``repro.serve`` on the CPU.

* Each of the seven schemes, driven through the same seeded history
  (allocate, protect, retire, end, clean up, advance the clock) in both
  packages, ends with the same stats, free counts and retire lists; every
  CPU cleanup backend (``scalar|numpy|torch``) gives the reference's NumPy
  mask on its reservation mirrors.  The ``cuda`` backend is held to the
  same masks on the card (``test_torch_cuda.py``).
* The reservation mirrors carry the three forms the era scan takes:
  points (lo == hi, WFE/HE/Crystalline), intervals (lo < hi, 2GEIBR) and
  EBR's open form (hi == INT32_MAX - 1).
* A scripted workload on each data structure under each scheme returns
  what a sequential model returns, in both packages, and drains to zero
  at quiescence; ``Leak`` is the control that must not drain.
* The engine trace of ``test_torch_serve`` under each pool scheme, with
  every cleanup on the batched ``torch`` scan, emits the reference
  engine's greedy tokens and stats.
"""

import random
import threading
import zlib

import jax
import numpy as np
import pytest

from repro.configs import get_smoke_config as ref_smoke_config
from repro.core import make_scheme as ref_make_scheme
from repro.core import datastructures as ref_ds
from repro.core.atomics import AtomicRef as RefAtomicRef
from repro.core.atomics import PtrView as RefPtrView
from repro.core.smr_base import Block as RefBlock
from repro.models import build_model
from repro.serve import ServeEngine as RefEngine
from repro_torch.configs import get_smoke_config
from repro_torch.core import datastructures as ds
from repro_torch.core import make_scheme
from repro_torch.core.atomics import MIRROR_INF, AtomicRef, PtrView
from repro_torch.core.smr_base import Block
from repro_torch.models.params import from_jax_params
from repro_torch.serve import ServeEngine

ALL_SCHEMES = ("WFE", "Crystalline", "HE", "HP", "EBR", "2GEIBR", "Leak")
BATCHED = ("WFE", "Crystalline", "HE", "EBR", "2GEIBR")
POOL_SCHEMES = BATCHED  # test_serve_runtime.py's pool schemes
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


def _kwargs(scheme, cleanup_freq):
    """Clock and cleanup frequencies under each scheme's own names."""
    if scheme in ("WFE", "HE", "Crystalline"):
        kw = {"era_freq": 3, "cleanup_freq": cleanup_freq}
    elif scheme in ("EBR", "2GEIBR"):
        kw = {"epoch_freq": 3, "cleanup_freq": cleanup_freq}
    elif scheme == "HP":
        kw = {"cleanup_freq": cleanup_freq}
    else:
        kw = {}
    if scheme == "Crystalline":
        kw["batch_size"] = 4  # ragged against the history's retire count
    return kw


def _pair(scheme, cleanup_freq, max_threads=3):
    kw = _kwargs(scheme, cleanup_freq)
    return (make_scheme(scheme, max_threads=max_threads, **kw),
            ref_make_scheme(scheme, max_threads=max_threads, **kw))


def _history(smr, node, cell_cls, view_cls, rng, n_ops=240, n_threads=3,
             maintenance=True):
    """A seeded single-threaded-legal history; block payloads are the op
    index, so two packages' retire lists compare by payload."""
    tids = [smr.register_thread() for _ in range(n_threads)]
    cells = [cell_cls(None) for _ in range(2)]
    views = [view_cls(c) for c in cells]
    for i in range(n_ops):
        t = tids[int(rng.integers(n_threads))]
        c = int(rng.integers(2))
        op = rng.random()
        if op < 0.3:
            smr.start_op(t)
            cells[c].store(smr.alloc_block(node, t, i))
        elif op < 0.5:
            smr.start_op(t)
            if cells[c].load() is not None:
                smr.get_protected(views[c], c, t)
        elif op < 0.75:
            blk = cells[c].load()
            if blk is not None:
                cells[c].store(None)
                smr.retire(blk, t)
        elif op < 0.85 or not maintenance:
            smr.end_op(t)
        elif op < 0.93:
            smr.flush(t)
        else:
            smr.advance_era(t)
    return tids


def _state(smr, tids):
    return (smr.stats(), list(smr.free_count), list(smr.retire_count),
            {t: [b.v for b in smr.retire_lists[t]] for t in tids})


def _seed(scheme, seed):
    return 1000 * seed + zlib.crc32(scheme.encode())


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("scheme", ALL_SCHEMES)
def test_scheme_matches_reference_history(scheme, seed):
    """The same seeded history leaves the same stats, free counts and
    retire lists in both packages; every CPU backend gives the
    reference's NumPy mask over each thread's retire list."""
    port, ref = _pair(scheme, cleanup_freq=5)
    tids = _history(port, _Node, AtomicRef, PtrView,
                    np.random.default_rng(_seed(scheme, seed)))
    _history(ref, _RefNode, RefAtomicRef, RefPtrView,
             np.random.default_rng(_seed(scheme, seed)))
    assert _state(port, tids) == _state(ref, tids)
    assert port.stats()["retires"] > 0
    if scheme == "Leak":
        assert port.stats()["frees"] == 0
    elif scheme != "HP":
        assert port.stats()["frees"] > 0
    for tid in tids:
        want = ref.deletable_mask(tid, "numpy")
        for b in CPU_BACKENDS:
            got = port.deletable_mask(tid, b)
            if want is None:  # HP and Leak have no batched path
                assert got is None and scheme in ("HP", "Leak")
            else:
                np.testing.assert_array_equal(got, want,
                                              err_msg=f"{b}/tid{tid}")


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("scheme", BATCHED)
def test_scheme_masks_identical_across_backends(scheme, seed):
    """With cleanup deferred (populated retire lists, live reservations),
    scalar == numpy == torch on each scheme's mirrors, per thread and
    over the fused all-thread scan, and both equal the reference's."""
    port, ref = _pair(scheme, cleanup_freq=10 ** 9)
    s = _seed(scheme, seed) + 7
    tids = _history(port, _Node, AtomicRef, PtrView,
                    np.random.default_rng(s), n_ops=160, maintenance=False)
    _history(ref, _RefNode, RefAtomicRef, RefPtrView,
             np.random.default_rng(s), n_ops=160, maintenance=False)
    for tid in tids:
        want = ref.deletable_mask(tid, "numpy")
        for b in CPU_BACKENDS:
            np.testing.assert_array_equal(port.deletable_mask(tid, b), want,
                                          err_msg=f"{b}/tid{tid}")
    alloc = np.concatenate([port.retire_lists[t].arrays()[0] for t in tids])
    retire = np.concatenate([port.retire_lists[t].arrays()[1] for t in tids])
    want = ref._batched_mask(alloc, retire, "numpy")
    for b in CPU_BACKENDS:
        np.testing.assert_array_equal(port._batched_mask(alloc, retire, b),
                                      want, err_msg=b)
    freed = port.cleanup_batch_all("torch")
    assert freed == ref.cleanup_batch_all("numpy")
    assert _state(port, tids) == _state(ref, tids)


def _phases(scheme):
    """A scheme's reservation phases with two threads inside an operation,
    each protecting a block, the clock advanced between them."""
    smr = make_scheme(scheme, max_threads=3, **_kwargs(scheme, 10 ** 9))
    tids = [smr.register_thread() for _ in range(2)]
    for t in tids:
        cell = AtomicRef(None)
        smr.start_op(t)
        cell.store(smr.alloc_block(_Node, t, t))
        smr.advance_era(t)
        smr.get_protected(PtrView(cell), 0, t)
        smr.advance_era(t)
        smr.get_protected(PtrView(cell), 0, t)
    if scheme in ("WFE", "Crystalline"):
        return [smr.era_table.snapshot()]
    return smr._reservation_phases()


@pytest.mark.parametrize("scheme,form", [
    ("WFE", "point"), ("Crystalline", "point"), ("HE", "point"),
    ("2GEIBR", "interval"), ("EBR", "open")])
def test_reservation_forms(scheme, form):
    """The mirrors carry the forms the era scan is held against: points
    (lo == hi), intervals (lo < hi), EBR's open form (hi == INT32_MAX - 1);
    empty slots are lo == INT32_MAX."""
    phases = _phases(scheme)
    lo = np.concatenate([p[0] for p in phases])
    hi = np.concatenate([p[1] for p in phases])
    valid = lo != MIRROR_INF
    assert valid.any()
    lo, hi = lo[valid], hi[valid]
    if form == "point":
        assert (lo == hi).any()
    elif form == "interval":
        assert (lo < hi).any() and (hi < MIRROR_INF - 1).all()
    else:
        assert (hi == MIRROR_INF - 1).all()


# ------------------------------------------------------ data structures
KV = {"list": "HarrisMichaelList", "hashmap": "MichaelHashMap",
      "bst": "NatarajanBST"}
QUEUES = {"kp": "KPQueue", "crturn": "CRTurnQueue"}
DS_SCHEMES = ("WFE", "Crystalline", "HE", "HP", "EBR", "2GEIBR")


def _ds_scheme(make, scheme, n=2):
    kw = ({"era_freq": 2, "cleanup_freq": 2} if scheme in ("WFE", "HE")
          else {"epoch_freq": 2, "cleanup_freq": 2}
          if scheme in ("EBR", "2GEIBR") else {"cleanup_freq": 2}
          if scheme != "Leak" else {})
    if scheme == "Crystalline":
        kw["batch_size"] = 3
    return make(scheme, max_threads=n, **kw)


def _kv_script(mod, make, scheme, name, n_ops=120):
    """Scripted insert/delete/get on one thread; returns every result,
    which must equal the sequential model's."""
    smr = _ds_scheme(make, scheme)
    d = getattr(mod, KV[name])(smr)
    tid = smr.register_thread()
    r = random.Random(zlib.crc32(f"{scheme}/{name}".encode()))
    model, out = {}, []
    for i in range(n_ops):
        key = r.randrange(16)
        op = r.random()
        if op < 0.4:
            got = d.insert(key, i, tid)
            assert got == (key not in model), ("insert", key)
            model.setdefault(key, i)
        elif op < 0.7:
            got = d.delete(key, tid)
            assert got == (key in model), ("delete", key)
            model.pop(key, None)
        else:
            got = d.get(key, tid)
            assert got == model.get(key), ("get", key)
        out.append(got)
    for key in range(16):
        assert d.get(key, tid) == model.get(key)
    smr.clear(tid)
    return smr, out


def _queue_script(mod, make, scheme, name, n_ops=120):
    smr = _ds_scheme(make, scheme)
    q = getattr(mod, QUEUES[name])(smr)
    tid = smr.register_thread()
    r = random.Random(zlib.crc32(f"{scheme}/{name}".encode()))
    model, out = [], []
    for i in range(n_ops):
        if r.random() < 0.55:
            q.enqueue(i, tid)
            model.append(i)
        else:
            got = q.dequeue(tid)
            assert got == (model.pop(0) if model else None)
            out.append(got)
    while model:
        assert q.dequeue(tid) == model.pop(0)
    assert q.dequeue(tid) is None
    return smr, out


def _stack_script(mod, make, scheme, n_ops=120):
    smr = _ds_scheme(make, scheme)
    s = mod.TreiberStack(smr)
    tid = smr.register_thread()
    r = random.Random(zlib.crc32(f"{scheme}/stack".encode()))
    model, out = [], []
    for i in range(n_ops):
        if r.random() < 0.55:
            s.push(i, tid)
            model.append(i)
        else:
            got = s.pop(tid)
            assert got == (model.pop() if model else None)
            out.append(got)
    return smr, out


def _script(kind, mod, make, scheme):
    if kind in KV:
        return _kv_script(mod, make, scheme, kind)
    if kind in QUEUES:
        return _queue_script(mod, make, scheme, kind)
    return _stack_script(mod, make, scheme)


@pytest.mark.parametrize("kind", sorted(KV) + sorted(QUEUES) + ["stack"])
@pytest.mark.parametrize("scheme", DS_SCHEMES)
def test_datastructure_conformance(kind, scheme, quiescence_check):
    """Each structure answers as its sequential model under each scheme,
    the port as the reference does, and reclaims every node at
    quiescence."""
    port, out = _script(kind, ds, make_scheme, scheme)
    ref, ref_out = _script(kind, ref_ds, ref_make_scheme, scheme)
    assert out == ref_out
    assert port.stats() == ref.stats()
    assert port.stats()["retires"] > 0
    quiescence_check(port, label=f"{kind}/{scheme}")


@pytest.mark.parametrize("kind", sorted(KV))
def test_leak_control_fails_quiescence(kind, quiescence_check):
    """Under Leak the same workload must NOT drain, or the quiescence
    check above could not fail."""
    port, out = _script(kind, ds, make_scheme, "Leak")
    _, ref_out = _script(kind, ref_ds, ref_make_scheme, "Leak")
    assert out == ref_out
    left = quiescence_check(port, label=f"{kind}/Leak", expect_drain=False)
    assert left == sum(port.retire_count) > 0


@pytest.mark.parametrize("scheme", DS_SCHEMES)
def test_stack_two_threads(scheme, quiescence_check):
    """A pusher and a popper on the port's Treiber stack: popped and
    residual items are the pushed multiset, and every node is reclaimed."""
    smr = _ds_scheme(make_scheme, scheme)
    s = ds.TreiberStack(smr)
    popped, errors = [], []
    start = threading.Barrier(2)
    done = threading.Event()

    def pusher():
        tid = smr.register_thread()
        start.wait()
        for i in range(200):
            s.push(i, tid)
        done.set()

    def popper():
        tid = smr.register_thread()
        start.wait()
        try:
            while not done.is_set() or len(popped) < 100:
                got = s.pop(tid)
                if got is not None:
                    popped.append(got)
                elif done.is_set():
                    break
        except Exception as e:  # pragma: no cover - failure path
            errors.append(e)

    ts = [threading.Thread(target=pusher), threading.Thread(target=popper)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert not errors, errors[0] if errors else None
    residual = []
    while (got := s.pop(0)) is not None:
        residual.append(got)
    assert sorted(popped + residual) == list(range(200))
    quiescence_check(smr, label=f"stack/{scheme}")


# ------------------------------------------------------ engine, pool schemes
def _example_trace():
    """The ``examples/serve_engine.py`` model and trace (as in
    test_torch_serve): 24 prompts on 48 blocks of size 4."""
    dims = dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=384,
                vocab_size=1024)
    ref_cfg = ref_smoke_config("stablelm-3b").scaled(**dims)
    cfg = get_smoke_config("stablelm-3b").scaled(**dims)
    prompts = [[(7 * i + j) % cfg.vocab_size for j in range(1 + i % 9)]
               for i in range(24)]
    return ref_cfg, cfg, prompts


@pytest.fixture(scope="module")
def trace_models():
    ref_cfg, cfg, prompts = _example_trace()
    ref_params = build_model(ref_cfg).init(jax.random.key(0))
    params = from_jax_params(cfg, jax.tree.map(np.asarray, ref_params),
                             device="cpu")
    return ref_cfg, cfg, prompts, ref_params, params


@pytest.mark.parametrize("scheme", POOL_SCHEMES)
def test_engine_schemes_match_reference(scheme, trace_models):
    """Under every pool scheme both engines serve the example trace to
    identical greedy tokens and stats and drain to zero unreclaimed blocks
    with every block free; the port's cleanups all take the batched
    ``torch`` scan (threshold 1), the reference's its NumPy one."""
    ref_cfg, cfg, prompts, ref_params, params = trace_models
    kw = dict(n_blocks=48, block_size=4, max_batch=8, scheme=scheme,
              era_freq=4, cleanup_freq=4, vectorized_threshold=1)
    outs, stats = [], []
    for make in (lambda: RefEngine(ref_cfg, ref_params, **kw),
                 lambda: ServeEngine(cfg, params, cleanup_backend="torch",
                                     device="cpu", **kw)):
        engine = make()
        tid = engine.pool.register_thread()
        reqs = [engine.submit(p, max_new_tokens=12) for p in prompts]
        st = engine.run(tid)
        assert st["completed"] == 24
        assert engine.pool.unreclaimed() == 0
        assert engine.pool.free_blocks == 48
        assert engine.pool.smr.name == scheme
        outs.append([r.generated for r in reqs])
        stats.append(st)
    assert outs[0] == outs[1]
    assert stats[0] == stats[1]
    assert stats[1]["reclaimed"] > 0
