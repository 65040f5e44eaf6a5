"""The readers of the program's spans, stamps and counters
(``benchlib/spans.py``), hand-counted on a synthetic run: records of the
program, a profile with known device intervals and ``trace_start_ns``,
and known request stamps."""

from types import SimpleNamespace as NS

import bench_tiny  # noqa: F401  (paths)
import pytest

from benchlib import common, spans

START_NS = 10 ** 15  # the profile's trace_start_ns


def _event(name, a_us, b_us, device="CUDA"):
    return NS(name=name, time_range=NS(start=a_us, end=b_us),
              device_type=NS(name=device))


class _Prof:
    def __init__(self, events):
        self._events = events
        self.profiler = NS(kineto_results=NS(trace_start_ns=lambda: START_NS))

    def events(self):
        return self._events


_IDS = iter(range(1, 10 ** 6))


def _rec(name, a_us, b_us, parent=None, **attrs):
    return NS(name=name, id=next(_IDS), parent=parent,
              t0_ns=START_NS + int(a_us * 1000),
              t1_ns=START_NS + int(b_us * 1000), attrs=attrs)


def _step(kind, a, b, children):
    """An ``engine.step`` from a to b (us) and its children, each (name, a,
    b[, grandchildren])."""
    top = _rec("engine.step", a, b, kind=kind)
    out = [top]
    for name, ca, cb, *kids in children:
        c = _rec(name, ca, cb, parent=top.id)
        out.append(c)
        out += [_rec(n, ka, kb, parent=c.id) for n, ka, kb in
                (kids[0] if kids else ())]
    return out


# device intervals (us): the gaps are 100-150, 300-400, 500-560, 600-700,
# 800-900 and 940-950
KERNELS = [(0, 100), (150, 300), (400, 500), (560, 600), (700, 800),
           (900, 940), (950, 1000)]

SERVE_RECORDS = (
    # gap 100-150 (mid 125) in engine.launch; gap 300-400 (mid 350) in
    # pool.cleanup inside sched.complete
    _step("decode", 90, 370, [
        ("engine.inputs", 90, 100), ("engine.launch", 100, 140),
        ("engine.wait", 140, 300),
        ("sched.complete", 300, 370, [("pool.cleanup", 340, 360)])])
    + [_rec("sched.tick", 375, 395)]
    # gap 500-560 (mid 530) in engine.wait: not the host's
    + _step("mixed", 400, 620, [
        ("engine.inputs", 400, 410), ("engine.launch", 410, 420),
        ("engine.wait", 420, 590), ("sched.complete", 590, 620)])
    # gap 600-700 (mid 650) in worker.park: not the host's
    + [_rec("worker.park", 625, 680), _rec("sched.tick", 690, 700)]
    # gap 800-900 (mid 850) in sched.complete; gap 940-950 (mid 945) in
    # the step's own body, after its complete
    + _step("decode", 700, 950, [
        ("engine.inputs", 700, 710), ("engine.launch", 710, 720),
        ("engine.wait", 720, 840), ("sched.complete", 840, 930)])
    # outside the profile: left out
    + _step("decode", -500, -100, [])
    + _step("decode", 1500, 1600, [])
    + _step("mixed", 1500, 1600, []))


def _serve_run(records, monkeypatch, sent=(), before=None, after=None):
    monkeypatch.setattr(spans, "program_records", lambda: records)
    events = [_event("kernel", a, b) for a, b in KERNELS]
    events.append(_event("host op", 0, 1000, device="CPU"))
    return NS(profile=_Prof(events), prof_window=[0.0, 0.002],
              sent=list(sent), stats_before=before or {},
              stats_after=after or {})


def _read(name, run):
    return common.reader("metrics", name)(run)


def test_steps_less_their_complete(monkeypatch):
    """The scheduler's per-kind step counters between the two snapshots:
    30 decode steps in 450 ms, 19 mixed steps (under the 20 a mean is read
    from), then 20 mixed steps in 6 s."""
    before = {"decode_dispatches": 10, "decode_ns": 10 ** 8,
              "mixed_dispatches": 1, "mixed_ns": 3 * 10 ** 8}
    after = {"decode_dispatches": 40, "decode_ns": 10 ** 8 + 45 * 10 ** 7,
             "mixed_dispatches": 20, "mixed_ns": 60 * 10 ** 8}
    run = _serve_run(SERVE_RECORDS, monkeypatch, before=before, after=after)
    assert _read("decode_step_ms.tpot", run) == pytest.approx(15.0)
    assert _read("mixed_step_ms.tpot", run) is None
    after["mixed_dispatches"] = 21
    assert _read("mixed_step_ms.tpot", run) == pytest.approx(285.0)


def _breakdown():
    return common.load_module(common.BENCH / "breakdown.py",
                              "bench_breakdown")


def test_idle_in_host(monkeypatch):
    run = _serve_run(SERVE_RECORDS, monkeypatch)
    # host: the gaps in engine.launch, pool.cleanup (under sched.complete),
    # sched.complete and engine.step's own body, 260 us of the 2 ms
    # sub-window; not those in engine.wait and worker.park
    assert _read("idle_in_host_pct.tpot", run) == pytest.approx(13.0)


def test_a_gap_outside_every_span(monkeypatch):
    recs = [r for r in SERVE_RECORDS if r.name != "worker.park"]
    run = _serve_run(recs, monkeypatch)
    assert _breakdown().idle_ms(run)["none"] == pytest.approx(0.1)
    assert _read("idle_in_host_pct.tpot", run) == pytest.approx(13.0)


def _sent(n=20):
    """Requests i = 1..n due and submitted at 100 + i s, admitted i ms
    after, their first chunk planned 2 i ms after admission; one never
    admitted, one refused."""
    out = []
    for i in range(1, n + 1):
        t = 100.0 + i
        out.append(NS(due=t, req=NS(t_submit=t, t_admit=t + i / 1e3,
                                    t_prefill=t + 3 * i / 1e3)))
    out.append(NS(due=5.0, req=NS(t_submit=5.0, t_admit=None,
                                  t_prefill=None)))
    out.append(NS(due=6.0, req=None))
    return out


def _stamp_run(sent, **kw):
    return NS(**dict(dict(sent=sent, prof_window=None), **kw))


def test_stamp_waits():
    run = _stamp_run(_sent())
    # 22 requests, rank ceil(0.95 x 22) = 21 of 1..20 ms, inf, inf: the
    # unadmitted and the refused request count infinite
    assert _read("queue_wait_p95_ms.ttft", run) == float("inf")
    run = _stamp_run(_sent()[:20])
    # 20 requests, rank 19: 19 ms to admission, 2 x 19 ms to the chunk
    assert _read("queue_wait_p95_ms.ttft", run) == pytest.approx(19.0)
    assert _read("prefill_wait_p95_ms.ttft", run) == pytest.approx(38.0)


def test_stamp_waits_stop_at_the_profiler():
    """The window opens at 100 s (perf_counter 0); the last step before
    the profiled sub-window ends at perf_counter 10.6, so the profiler's
    start holds the worker from 110.6 s: the requests read are those due
    4 s before it, by due time alone, and a long wait among them that
    runs past the start counts as it was."""
    sent = _sent()[:20]
    # due 106.5: admitted 50 ms after, its first chunk 4.45 s after that
    sent.append(NS(due=106.5, req=NS(t_submit=106.5, t_admit=106.55,
                                     t_prefill=111.0)))
    run = _stamp_run(sent, t0=100.0, perf_t0=0.0, prof_window=[12.0, 15.0],
                     steps=[NS(t1=9.0), NS(t1=10.6), NS(t1=12.5)])
    # queue waits of i = 1..6 and 50 ms: rank 7 of 7
    assert _read("queue_wait_p95_ms.ttft", run) == pytest.approx(50.0)
    # chunk waits of i = 1..6 (2 i ms) and 4450 ms: rank 7 of 7
    assert _read("prefill_wait_p95_ms.ttft", run) == pytest.approx(4450.0)


def test_useful_tokens(monkeypatch):
    run = _serve_run(SERVE_RECORDS, monkeypatch,
                     before={"tokens_live": 10, "tokens_computed": 100},
                     after={"tokens_live": 40, "tokens_computed": 700})
    assert _read("useful_token_pct.tpot", run) == pytest.approx(5.0)


def test_train_data_wait(monkeypatch):
    recs = [_rec("train.data", 10, 40), _rec("train.step", 40, 400),
            _rec("train.metrics", 400, 420), _rec("train.data", 420, 480),
            _rec("train.step", 480, 900), _rec("train.metrics", 900, 950),
            _rec("train.data", 2000, 9000)]  # after the profile
    monkeypatch.setattr(spans, "program_records", lambda: recs)
    run = NS(profile=_Prof([_event("kernel", 0, 1000)]),
             prof_window=[0.0, 0.001])
    assert _read("data_wait_ms_per_step.train", run) == pytest.approx(0.045)


def test_a_program_without_them_reads_none(monkeypatch):
    """The parent's program: no tracing module, no stamps, no counters."""
    monkeypatch.setattr(spans, "program_records", lambda: None)
    old = [NS(req=NS(t_submit=1.0)) for _ in range(5)]
    run = _serve_run(None, monkeypatch, sent=old,
                     before={"steps": 1}, after={"steps": 9})
    for name in ("queue_wait_p95_ms.ttft", "prefill_wait_p95_ms.ttft",
                 "decode_step_ms.tpot", "mixed_step_ms.tpot",
                 "useful_token_pct.tpot", "idle_in_host_pct.tpot",
                 "data_wait_ms_per_step.train"):
        assert _read(name, run) is None, name


def test_no_profile_reads_none(monkeypatch):
    monkeypatch.setattr(spans, "program_records", lambda: SERVE_RECORDS)
    run = NS(profile=None, prof_window=None, sent=[])
    assert _read("idle_in_host_pct.tpot", run) is None
    assert _read("data_wait_ms_per_step.train", run) is None


def test_breakdown_by_span_path(monkeypatch):
    breakdown = _breakdown()
    run = _serve_run(SERVE_RECORDS, monkeypatch)
    idle = breakdown.idle_ms(run)
    assert idle == pytest.approx({
        "engine.step/engine.launch": 0.05,
        "engine.step/sched.complete/pool.cleanup": 0.1,
        "engine.step/engine.wait": 0.06, "worker.park": 0.1,
        "engine.step/sched.complete": 0.1, "engine.step": 0.01})
    steps = breakdown.steps_ms(run)
    assert steps["decode"]["n"] == 2 and steps["mixed"]["n"] == 1
    assert steps["decode"]["median_ms"] == pytest.approx(0.265)
    assert steps["decode"]["mean_ms_under"] == pytest.approx({
        "engine.inputs": 0.01, "engine.launch": 0.025,
        "engine.wait": 0.14, "sched.complete": 0.08,
        "sched.complete/pool.cleanup": 0.01})
    # two ticks of 20 and 10 us over three steps; one park of 55 us
    assert steps["sched.tick_mean_ms_per_step"] == pytest.approx(0.01)
    assert steps["worker.park_ms"] == pytest.approx(0.055)


def test_breakdown_splits_ttft_at_the_stamps():
    breakdown = _breakdown()
    sent = []
    for i in range(1, 21):  # TTFT 10 i ms: 1 + i + 2 i + (7 i - 1)
        due = 10.0 * i
        req = NS(t_submit=due + 1e-3, t_admit=due + 1e-3 + i / 1e3,
                 t_prefill=due + 1e-3 + 3 * i / 1e3)
        sent.append(NS(due=due, submitted=due + 1e-3, req=req,
                       stamps=[due + 10 * i / 1e3]))
    got = breakdown.ttft_split(NS(sent=sent))
    # rank 19 of 20: the request of TTFT 190 ms; the tail is 19 and 20
    assert got["n"] == 20 and got["ttft_p95_ms"] == pytest.approx(190.0)
    assert got["at_p95"] == pytest.approx({
        "to_submit": 1.0, "queue_wait": 19.0, "prefill_wait": 38.0,
        "rest": 132.0})
    assert got["tail_mean"] == pytest.approx({
        "to_submit": 1.0, "queue_wait": 19.5, "prefill_wait": 39.0,
        "rest": 135.5})
