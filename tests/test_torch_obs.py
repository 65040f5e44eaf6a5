"""The port's spans (``repro_torch.obs``) and the stamps and counters
beside them, on the CPU.

* Off, ``span()`` returns the one shared no-op and records nothing; on
  (``enable()``, or a ``torch.profiler`` profile recording on the thread)
  spans nest by parent id, each thread keeps its own bounded ring.
* A span lies on the profile's clock: mapped through ``trace_start_ns``
  it falls inside the ``record_function`` bracket around it.
* The engine's steps give ``engine.step`` (with its kind) and its
  children; each step adds its hand-counted live and computed tokens to
  the scheduler's ``tokens_live``/``tokens_computed`` and one dispatch
  and its time to ``<kind>_dispatches``/``<kind>_ns``, recorded or not.
* ``t_submit <= t_admit <= t_prefill <= t_first``, after a prefix hit too.
* ``Trainer.run`` gives ``train.data``, ``train.step`` and
  ``train.metrics`` per step.
"""

import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch import obs
from repro_torch.configs import get_smoke_config
from repro_torch.data import SyntheticLMData
from repro_torch.models import build_model
from repro_torch.models.params import init_params
from repro_torch.serve import ServeEngine
from repro_torch.train import AdamWConfig, Trainer


@pytest.fixture(autouse=True)
def _fresh():
    obs.clear()
    yield
    obs.clear()


@pytest.fixture(scope="module")
def engine_parts():
    cfg = get_smoke_config("stablelm-3b")
    return cfg, init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")


def _engine(engine_parts, **kw):
    cfg, params = engine_parts
    kw = dict(dict(n_blocks=32, block_size=4, max_batch=4, chunk_size=4),
              **kw)
    return ServeEngine(cfg, params, device="cpu", **kw)


def test_off_returns_the_shared_noop_and_records_nothing():
    sp = obs.span("x", a=1)
    assert sp is obs.NOOP and sp is obs.span("y")
    with sp as inner:
        assert inner is obs.NOOP
    assert obs.records() == []


def test_spans_nest_by_parent_id():
    with obs.enable():
        with obs.span("outer", k=1) as a:
            with obs.span("inner", n=3) as b:
                pass
            with obs.span("inner2") as c:
                pass
        with obs.span("top") as d:
            pass
    assert obs.span("after") is obs.NOOP
    recs = obs.records()
    assert [r.name for r in recs] == ["outer", "inner", "inner2", "top"]
    assert a.parent is None and d.parent is None
    assert b.parent == a.id and c.parent == a.id
    assert len({r.id for r in recs}) == 4
    assert a.attrs == {"k": 1} and b.attrs == {"n": 3}
    assert a.t0_ns <= b.t0_ns <= b.t1_ns <= c.t0_ns <= c.t1_ns <= a.t1_ns
    assert obs.records("inner") == [b]


def test_enable_nests_and_ends():
    with obs.enable():
        with obs.enable():
            assert obs.span("a") is not obs.NOOP
        assert obs.span("b") is not obs.NOOP
    assert obs.span("c") is obs.NOOP


def test_threads_keep_separate_rings():
    def work(tag):
        with obs.span(tag):
            with obs.span(tag + ".child"):
                pass

    with obs.enable():
        threads = [threading.Thread(target=work, args=(f"t{i}",),
                                    name=f"obs-test-{i}") for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
    recs = obs.records()
    assert len(recs) == 6
    by_thread = {}
    for r in recs:
        by_thread.setdefault(r.thread, []).append(r)
    assert sorted(by_thread) == ["obs-test-0", "obs-test-1", "obs-test-2"]
    for name, rs in by_thread.items():
        top = [r for r in rs if r.parent is None]
        child = [r for r in rs if r.parent is not None]
        assert len(top) == 1 and len(child) == 1
        assert child[0].parent == top[0].id
        assert top[0].name == "t" + name[-1]
    obs.clear()  # the threads have ended: their rings go
    assert obs.records() == []


def test_the_ring_is_bounded(monkeypatch):
    monkeypatch.setattr(obs, "RING", 8)

    def work():
        for i in range(20):
            with obs.span("s", i=i):
                pass

    with obs.enable():
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    got = [r.attrs["i"] for r in obs.records("s")]
    assert got == list(range(12, 20))


def test_recording_follows_a_profile():
    assert obs.span("before") is obs.NOOP
    with profile(activities=[ProfilerActivity.CPU]):
        with obs.span("during") as sp:
            pass
        assert sp
    assert obs.span("after") is obs.NOOP
    assert [r.name for r in obs.records()] == ["during"]


def test_a_span_maps_inside_its_record_function_bracket():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(4):
            with record_function(f"bracket{i}"):
                with obs.span(f"span{i}"):
                    torch.ones(256).sum()
    start = prof.profiler.kineto_results.trace_start_ns()
    brackets = {e.name: e.time_range for e in prof.events()
                if e.name.startswith("bracket")}
    spans = obs.records()
    assert len(spans) == 4
    for sp in spans:
        tr = brackets["bracket" + sp.name[4:]]
        a = (sp.t0_ns - start) / 1e3  # microseconds, as time_range
        b = (sp.t1_ns - start) / 1e3
        assert tr.start - 1000 <= a <= b <= tr.end + 1000, (sp, tr)


def test_engine_steps_carry_children_rows_and_tokens(engine_parts):
    """Three 2-token prompts at max_batch 4, chunk 4: a prefill step, two
    mixed steps of 4 decode slots and a chunk bucket of 2 on one token
    axis (live 1 + 2, then 2 + 2), then a decode step of 3 live rows of
    4."""
    engine = _engine(engine_parts)
    tid = engine.pool.register_thread()
    want = [("prefill", 2, 2), ("mixed", 3, 6), ("mixed", 4, 6),
            ("decode", 3, 4)]
    with obs.enable():
        for p in ([5, 9], [11, 3], [7, 1]):
            engine.submit(p, 4)
        for kind, live, computed in want:
            before = dict(engine.sched.stats)
            assert engine.step(tid)
            after = engine.sched.stats
            grown = {k: after[k] - before[k] for k in after}
            assert grown["tokens_live"] == live
            assert grown["tokens_computed"] == computed
            for k in ("prefill", "mixed", "decode"):
                assert grown[k + "_dispatches"] == (k == kind)
                assert (grown[k + "_ns"] > 0) == (k == kind)
    steps = obs.records("engine.step")
    assert [s.attrs for s in steps] == [{"kind": k} for k, _, _ in want]
    recs = obs.records()
    for s in steps[2:]:
        children = {r.name for r in recs if r.parent == s.id}
        assert {"engine.inputs", "engine.launch",
                "sched.complete"} <= children
        tick = [r for r in recs if r.name == "sched.tick"
                and r.t1_ns <= s.t0_ns][-1]
        assert tick.parent is None
    # the decode step retires the first request's table and cleans up
    done = [r for r in recs if r.parent is not None and
            r.name == "sched.complete" and r.parent == steps[3].id][0]
    names = [r.name for r in recs if r.parent == done.id]
    assert "table.release" in names and "pool.cleanup" in names
    # the counters run with recording off too
    obs.clear()
    engine.run(tid)
    assert obs.records() == []
    assert engine.sched.stats["tokens_live"] > after["tokens_live"]
    assert engine.sched.stats["decode_dispatches"] > 1


def test_request_stamps_are_ordered_after_a_prefix_hit(engine_parts):
    engine = _engine(engine_parts)
    tid = engine.pool.register_thread()
    prompt = list(range(1, 11))  # two full blocks of 4 are cacheable
    first = engine.submit(prompt, 2)
    while engine.step(tid):  # no drain: it would empty the cache
        pass
    hits = engine.sched.stats["prefix_hits"]
    second = engine.submit(prompt, 2)
    while engine.step(tid):
        pass
    assert engine.sched.stats["prefix_hits"] == hits + 1
    for r in (first, second):
        assert r.state == "done"
        assert r.t_submit <= r.t_admit <= r.t_prefill <= r.t_first


def test_an_evicted_request_keeps_its_first_stamps(engine_parts):
    engine = _engine(engine_parts)
    tid = engine.pool.register_thread()
    req = engine.submit([3, 1, 4, 1, 5], 4)
    engine.step(tid)
    admit, prefill = req.t_admit, req.t_prefill
    assert admit is not None and prefill is not None
    with engine.sched._lock:
        engine.sched._evict(req, tid)
    engine.run(tid)
    assert req.state == "done" and req.evictions == 1
    assert (req.t_admit, req.t_prefill) == (admit, prefill)
    assert req.t_prefill <= req.t_first


def test_trainer_spans_each_step(engine_parts):
    cfg = get_smoke_config("stablelm-3b").scaled(num_microbatches=2)
    trainer = Trainer(build_model(cfg), AdamWConfig(lr=1e-2), device="cpu")
    state = trainer.init(torch.Generator().manual_seed(0))
    data = SyntheticLMData(cfg.vocab_size, seq_len=16, global_batch=4)
    seen = []
    with obs.enable():
        trainer.run(state, data.stream(0), steps=2,
                    on_metrics=lambda s, m: seen.append(s))
    assert seen == [1, 2]
    recs = obs.records()
    assert [r.name for r in recs] == [
        "train.data", "train.step", "train.metrics",
        "train.data", "train.step", "train.metrics"]
    assert all(r.parent is None for r in recs)
    # no metrics callback: no read-back to time
    obs.clear()
    with obs.enable():
        trainer.run(state, data.stream(2), steps=1)
    assert [r.name for r in obs.records()] == ["train.data", "train.step"]
