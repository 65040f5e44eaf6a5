"""The port's fault injection and crash-tolerant runtime held against
``repro`` on the CPU (the counterpart of test_fault_tolerance.py).

* ``FaultSpec.parse`` gives the reference's spec on the same strings, and
  the injector takes the reference's decisions (crash ordinals, allocation
  failures, poisoned rows) for the same seed and event sequence.
* Under three seeded crashes, one per crash point, every pool scheme on 1
  and 4 shards completes every request exactly once with the greedy
  tokens of ``repro``'s fault-free engine, and drains to zero.
* A poisoned row fails one request and leaves the others token-exact; a
  reaped tid's freed pages are never read (scribbled NaN / 1e30); the reap
  alone unblocks a pinned drain; the error path drains before raising;
  the front end ends a failed stream with an ``error`` frame.
"""

import asyncio

import jax
import numpy as np
import pytest

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import build_model
from repro.serve import FaultInjector as RefFaultInjector
from repro.serve import FaultSpec as RefFaultSpec
from repro.serve import InjectedCrash as RefInjectedCrash
from repro.serve import ServeEngine as RefEngine
from repro_torch.blocks import BlockPool, PoolExhausted
from repro_torch.configs import get_smoke_config
from repro_torch.core import make_scheme
from repro_torch.core.atomics import INF_ERA, INVPTR
from repro_torch.models.params import from_jax_params
from repro_torch.serve import (CRASH_POINTS, FaultInjector, FaultSpec,
                               Frontend, InjectedCrash, ServeEngine,
                               ServeRuntime)
from repro_torch.serve import frontend as frontend_mod

POOL_SCHEMES = ("WFE", "Crystalline", "HE", "EBR", "2GEIBR")
N_REQS = 10
MAX_NEW = 6
ENGINE_KW = dict(n_blocks=64, block_size=4, max_batch=4, chunk_size=4,
                 max_threads=16, max_inflight=4, era_freq=2, cleanup_freq=2)


def _prompts():
    return [[1 + (i * 7 + j) % 29 for j in range(1 + i % 5)]
            for i in range(N_REQS)]


@pytest.fixture(scope="module")
def models():
    ref_cfg = ref_smoke_config("stablelm-3b")
    cfg = get_smoke_config("stablelm-3b")
    ref_params = build_model(ref_cfg).init(jax.random.key(0))
    params = from_jax_params(cfg, jax.tree.map(np.asarray, ref_params),
                             device="cpu")
    return ref_cfg, cfg, ref_params, params


@pytest.fixture(scope="module")
def reference_tokens(models):
    """``repro``'s fault-free greedy tokens for the shared workload."""
    ref_cfg, _, ref_params, _ = models
    engine = RefEngine(ref_cfg, ref_params, **ENGINE_KW)
    reqs = [engine.submit(p, MAX_NEW) for p in _prompts()]
    stats = engine.run(engine.pool.register_thread())
    assert stats["completed"] == N_REQS and engine.pool.unreclaimed() == 0
    return [list(r.generated) for r in reqs]


def _engine(models, **kw):
    _, cfg, _, params = models
    return ServeEngine(cfg, params, device="cpu", **{**ENGINE_KW, **kw})


# ========================================================== spec + injector
SPECS = [
    "seed=7,crash_rate=0.25,max_crashes=3,crash_at=after_dispatch:5|"
    "before_tick:9,points=before_tick|after_dispatch,alloc_fail_at=3|11,"
    "poison_at=4,poison_rate=0.5",
    "crash_at=before_tick:3|after_reservation:7|after_dispatch:11,"
    "poison_at=5",
    "seed=0,crash_rate=0.01,max_crashes=3",
    " seed = 2 , alloc_fail_rate=0.1,, ",
]


@pytest.mark.parametrize("text", SPECS)
def test_fault_spec_parse_matches_reference(text):
    got, want = FaultSpec.parse(text), RefFaultSpec.parse(text)
    assert got.__dict__ == want.__dict__


@pytest.mark.parametrize("bad", ["frobnicate=1", "points=mid_tick",
                                 "crash_at=nowhere:1", "seed"])
def test_fault_spec_rejects_what_the_reference_rejects(bad):
    with pytest.raises(ValueError) as want:
        RefFaultSpec.parse(bad)
    with pytest.raises(ValueError) as got:
        FaultSpec.parse(bad)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="outside"):
        FaultSpec(crash_rate=1.5)


def _decisions(injector_cls, crash_cls, exhausted_cls, spec, tids):
    """Drive every site of one injector through the same event sequence;
    returns each decision and the final stats."""
    inj = injector_cls(spec)
    out = []
    for k, tid in enumerate(tids):
        point = CRASH_POINTS[k % 3]
        try:
            inj.crash_point(point, tid)
            out.append(None)
        except crash_cls as e:
            out.append((e.point, e.tid, e.ordinal))
        try:
            inj.alloc_gate(1 + k % 4, tid)
            out.append("ok")
        except exhausted_cls:
            out.append("fail")
        out.append(inj.poison_row(1 + k % 5))
    return out, inj.stats()


@pytest.mark.parametrize("seed", (0, 11, 1234))
def test_injector_decisions_match_reference(seed):
    """Decisions key on per-site event ordinals and the seeded streams, as
    in the reference; which tid observes an event does not matter."""
    from repro.blocks.block_pool import PoolExhausted as RefPoolExhausted

    kw = dict(seed=seed, crash_rate=0.3, max_crashes=7, alloc_fail_rate=0.2,
              alloc_fail_at=(2,), poison_rate=0.25, poison_at=(1,),
              crash_at=(("after_dispatch", 4),))
    a = _decisions(FaultInjector, InjectedCrash, PoolExhausted,
                   FaultSpec(**kw), [0] * 60)
    b = _decisions(FaultInjector, InjectedCrash, PoolExhausted,
                   FaultSpec(**kw), [i % 3 for i in range(60)])
    ref = _decisions(RefFaultInjector, RefInjectedCrash, RefPoolExhausted,
                     RefFaultSpec(**kw), [0] * 60)
    assert a == ref
    assert [d if not isinstance(d, tuple) else d[::2] for d in a[0]] == \
        [d if not isinstance(d, tuple) else d[::2] for d in b[0]]
    assert a[1]["n_crashes"] == 7 and a[1]["n_poisoned"] > 0
    assert a[1]["n_alloc_failures"] > 0


def test_injector_max_crashes_cap():
    inj = FaultInjector(FaultSpec(crash_rate=1.0, max_crashes=2))
    crashed = 0
    for _ in range(10):
        try:
            inj.crash_point("after_dispatch", 0)
        except InjectedCrash:
            crashed += 1
    assert crashed == 2 and inj.n_crashes == 2
    assert inj.stats()["events"]["after_dispatch"] == 10


# ============================================== crash matrix, all 5 schemes
@pytest.mark.parametrize("scheme", POOL_SCHEMES)
@pytest.mark.parametrize("shards", (1, 4))
def test_crash_matrix_all_schemes(models, reference_tokens, scheme, shards,
                                  quiescence_check):
    """Three seeded crashes — one per crash point — under the supervised
    runtime: every request completes exactly once with the reference's
    fault-free tokens, and the pool drains to zero."""
    engine = _engine(models, scheme=scheme, n_shards=shards)
    inj = FaultInjector(FaultSpec(crash_at=(
        ("before_tick", 2), ("after_reservation", 1), ("after_dispatch", 3))))
    engine.set_fault_injector(inj)
    finishes = {}

    def on_finish(req):  # runs under the scheduler lock: exactly-once proof
        finishes[req.rid] = finishes.get(req.rid, 0) + 1

    reqs = [engine.submit(p, MAX_NEW, on_finish=on_finish)
            for p in _prompts()]
    runtime = ServeRuntime(engine, n_workers=2)
    stats = runtime.serve()
    assert dict(inj.crashes) == {"before_tick": 1, "after_reservation": 1,
                                 "after_dispatch": 1}
    assert runtime.n_respawns == 3
    assert len(set(runtime.crashed_tids)) == 3, "a dead tid was reused"
    assert len(runtime.recovery_latencies) <= runtime.n_respawns
    assert stats["n_respawns"] == 3 and stats["worker_crashes"] == 3
    assert sorted(finishes) == sorted(r.rid for r in reqs)
    assert all(n == 1 for n in finishes.values()), finishes
    assert stats["completed"] == N_REQS and stats["failed"] == 0
    for r, want in zip(reqs, reference_tokens):
        assert r.state == "done", (r.rid, r.state)
        assert list(r.generated) == want, \
            (r.rid, "crash-requeued request replayed differently")
    assert stats["unreclaimed"] == 0
    quiescence_check(engine.pool, label=f"{scheme}/s{shards}", rounds=0)


def test_crash_requeue_accounting(models, quiescence_check):
    """A crash in the reservation-held window rewinds its rows through the
    eviction path and charges the wasted tokens to the crash counters."""
    engine = _engine(models)
    inj = FaultInjector(FaultSpec(crash_at=(("after_dispatch", 4),)))
    engine.set_fault_injector(inj)
    for i in range(6):
        engine.submit([2 + (i + j) % 13 for j in range(3)], MAX_NEW)
    runtime = ServeRuntime(engine, n_workers=2)
    stats = runtime.serve()
    assert inj.n_crashes == 1 and runtime.n_respawns == 1
    assert stats["crash_requeues"] >= 1
    assert stats["evictions"] >= stats["crash_requeues"]
    assert stats["completed"] == 6 and stats["unreclaimed"] == 0
    quiescence_check(engine.pool, label="requeue-accounting", rounds=0)


# ============================================ graceful degradation (poison)
@pytest.mark.parametrize("shards", (1, 2))
def test_poison_fails_single_request(models, reference_tokens, shards,
                                     quiescence_check):
    """A NaN-poisoned sampled row fails THAT request and leaves every
    other one with the reference's tokens."""
    engine = _engine(models, n_shards=shards)
    engine.set_fault_injector(FaultInjector(FaultSpec(poison_at=(6,))))
    finishes = {}

    def on_finish(req):
        finishes[req.rid] = finishes.get(req.rid, 0) + 1

    reqs = [engine.submit(p, MAX_NEW, on_finish=on_finish)
            for p in _prompts()]
    stats = engine.run(engine.pool.register_thread())
    failed = [r for r in reqs if r.state == "failed"]
    assert len(failed) == 1, [r.state for r in reqs]
    assert stats["failed"] == 1 and stats["completed"] == N_REQS - 1
    assert stats["failed_tokens"] == len(failed[0].generated)
    assert len(failed[0].table) == 0, "failed request still holds pages"
    assert all(n == 1 for n in finishes.values())
    for r, want in zip(reqs, reference_tokens):
        if r.state == "done":
            assert list(r.generated) == want
    quiescence_check(engine.pool, label="poison-degradation", rounds=0)


# =========================================== reaped pages never read again
def test_reaped_tid_pages_never_read_poison(models, quiescence_check):
    """Crash a worker mid-window, reap + requeue inline, then scribble
    NaN/1e30 over every pool slot no live request owns: the finished run
    emits ``repro``'s fault-free tokens (nothing reads a freed page)."""
    ref_cfg, _, ref_params, _ = models
    kw = dict(ENGINE_KW, n_blocks=32, prefix_caching=False)
    prompts = [[3, 1, 4, 1, 5], [8, 7, 1, 9], [2, 6, 5]]
    ref_engine = RefEngine(ref_cfg, ref_params, **kw)
    ref = [ref_engine.submit(p, MAX_NEW) for p in prompts]
    ref_engine.run(ref_engine.pool.register_thread())
    want = [list(r.generated) for r in ref]

    engine = _engine(models, n_blocks=32, prefix_caching=False)
    engine.set_fault_injector(FaultInjector(FaultSpec(
        crash_at=(("after_reservation", 3),))))
    reqs = [engine.submit(p, MAX_NEW) for p in prompts]
    dead = engine.pool.register_thread()
    with pytest.raises(InjectedCrash):
        for _ in range(10_000):
            if not engine.step(dead) and not engine.sched.pending() \
                    and not engine.sched.active:
                raise AssertionError("quiesced before the injected crash")
    engine.pool.reap_thread(dead)
    plan = engine.take_orphaned_plan(dead)
    assert plan is not None, "crash in the reservation window left no plan"
    assert engine.take_orphaned_plan(dead) is None
    sup = engine.pool.register_thread()
    engine.sched.requeue_crashed(plan, sup)
    assert all(not r.inflight for r in reqs)
    live = {i for r in reqs if r.table is not None
            for i in r.table.current().block_ids}
    dead_slots = sorted(set(range(engine.pools["k"].shape[1])) - live)
    assert dead_slots, "the rewind freed no slots to poison"
    engine.pools["k"][:, dead_slots] = float("nan")
    engine.pools["v"][:, dead_slots] = 1e30
    engine.set_fault_injector(None)
    stats = engine.run(sup)
    assert stats["completed"] == len(prompts)
    for r, w in zip(reqs, want):
        assert r.state == "done"
        assert list(r.generated) == w, \
            (r.rid, "a replayed request read a reaped/poisoned page")
    quiescence_check(engine.pool, label="reap-poison", rounds=0)


# ======================================================== serve error path
def test_serve_error_path_drains_and_reports(models, quiescence_check):
    """With no respawn budget every crash is unrecoverable, and serve()
    still drains and parks the merged stats before re-raising."""
    engine = _engine(models)
    engine.set_fault_injector(FaultInjector(FaultSpec(
        crash_at=(("after_dispatch", 2),))))
    reqs = [engine.submit(p, MAX_NEW) for p in _prompts()]
    runtime = ServeRuntime(engine, n_workers=2, max_respawns=0)
    with pytest.raises(InjectedCrash):
        runtime.serve()
    assert runtime.n_respawns == 0 and len(runtime.crashed_tids) == 1
    assert runtime.partial_stats is not None
    assert runtime.partial_stats["unreclaimed"] == 0
    assert runtime.partial_stats["worker_crashes"] == 1
    for r in reqs:
        assert not r.inflight
        assert r.state in ("done", "queued", "active"), (r.rid, r.state)
    tid = engine.pool.register_thread()
    for r in reqs:
        if r.table is not None and len(r.table) > 0:
            r.table.release_all(tid)
    quiescence_check(engine.pool, label="error-path", tid=tid)


def test_exception_mid_step_leaves_plan_for_requeue(models, reference_tokens,
                                                    monkeypatch):
    """An exception inside the device step (not an injected crash) still
    leaves the plan to the supervisor, and the run recovers the
    reference's tokens."""
    from repro_torch.serve import engine as engine_mod

    real = engine_mod.paged_decode_step
    calls = []

    def flaky(*args, **kwargs):
        out = real(*args, **kwargs)
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("device fault after the launches")
        return out

    monkeypatch.setattr(engine_mod, "paged_decode_step", flaky)
    engine = _engine(models, n_shards=2)
    reqs = [engine.submit(p, MAX_NEW) for p in _prompts()]
    runtime = ServeRuntime(engine, n_workers=2)
    stats = runtime.serve()
    assert runtime.n_respawns == 1 and "device fault" in \
        runtime.worker_crashes[0]["error"]
    assert stats["completed"] == N_REQS and stats["unreclaimed"] == 0
    assert [list(r.generated) for r in reqs] == reference_tokens


# ==================================================== reap_thread unit layer
@pytest.mark.parametrize("scheme", POOL_SCHEMES)
def test_reap_unblocks_pinned_drain(scheme, quiescence_check):
    """A dead tid's reservation pins retired blocks; reap_thread alone
    unpins them — for every scheme."""
    pool = BlockPool(8, scheme=scheme, max_threads=4, era_freq=1,
                     cleanup_freq=1)
    live = pool.register_thread()
    dead = pool.register_thread()
    blk = pool.alloc(live)
    if hasattr(pool.smr, "reservations"):
        pool.protect_step(0, dead)  # WFE / Crystalline / HE era slot
    else:
        pool.smr.start_op(dead)  # EBR announce / 2GEIBR interval
    pool.retire(blk, live)
    for _ in range(10):
        pool.cleanup_all()
        pool.advance_eras(live)
    assert pool.unreclaimed() > 0, f"{scheme}: the reservation did not pin"
    pool.reap_thread(dead)
    quiescence_check(pool, label=f"reap/{scheme}", tid=live)


def test_wfe_reap_cancels_orphaned_slow_path():
    """reap_thread cancels a dead thread's published slow-path request so
    the help counters balance again."""
    smr = make_scheme("WFE", max_threads=2, era_freq=1, cleanup_freq=1)
    dead = 0
    tag = smr.reservations[dead][0].load_b()
    smr.state[dead][0].result.store((INVPTR, tag))
    smr.counter_start.fa_add(1)
    assert smr.counter_start.load() != smr.counter_end.load()
    smr.reap_thread(dead)
    assert smr.counter_start.load() == smr.counter_end.load()
    assert smr.state[dead][0].result.load() == (None, INF_ERA)
    for j in range(smr.max_hes + 2):
        assert smr.reservations[dead][j].load_a() == INF_ERA


def test_crystalline_reap_seals_open_batch(quiescence_check):
    pool = BlockPool(8, scheme="Crystalline", max_threads=2, era_freq=1,
                     cleanup_freq=1, batch_size=8)
    dead = pool.register_thread()
    blk = pool.alloc(dead)
    pool.retire(blk, dead)
    assert pool.smr.pending() == 1
    pool.reap_thread(dead)
    assert pool.smr.pending() == 0, "reap left the dead tid's batch open"
    quiescence_check(pool, label="crystalline-reap", tid=1)


# ===================================================== front-end integration
def test_frontend_error_frame_and_healthz(models):
    """Over sockets: a poisoned request's stream ends with an ``error``
    frame; /healthz reports worker liveness, respawns and fault counters."""
    engine = _engine(models, n_shards=2)
    engine.set_fault_injector(FaultInjector(FaultSpec(poison_at=(0,))))
    runtime = ServeRuntime(engine, n_workers=2,
                           max_steps_per_worker=1_000_000)
    frontend = Frontend(runtime, host="127.0.0.1", port=0)

    async def scenario():
        port = await frontend.start()
        status, reader, writer = await frontend_mod._post_generate(
            port, {"prompt": [7, 3, 9, 1], "max_new_tokens": 5})
        assert "200" in status, status
        events = await frontend_mod._read_sse(reader)
        writer.close()
        err = [d for e, d in events if e == "error"]
        assert err and err[0]["state"] == "failed", events
        assert not any(e == "done" for e, _ in events), events
        status, reader, writer = await frontend_mod._post_generate(
            port, {"prompt": [2, 8, 5], "max_new_tokens": 4})
        events = await frontend_mod._read_sse(reader)
        writer.close()
        done = [d for e, d in events if e == "done"]
        assert done and done[0]["state"] == "done", events
        status, health = await frontend_mod._http_json(
            port, "GET", "/healthz")
        assert "200" in status
        assert len(health["workers"]) == 2
        assert all(w["alive"] for w in health["workers"]), health
        assert health["n_respawns"] == 0
        assert health["faults"]["n_poisoned"] == 1, health
        return await frontend.shutdown(deadline_s=15.0)

    stats = asyncio.run(scenario())
    assert stats["failed"] == 1 and stats["completed"] >= 1
    assert stats["unreclaimed"] == 0
