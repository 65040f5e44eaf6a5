"""The port's scheduler policies held against ``repro``, case by case from
``test_scheduler_slo.py``, ``test_bucket_policy.py`` and the TTFT/TPOT
stamps of ``test_chunked_prefill.py``.

Every scheduler-level scenario runs on both packages' ``BlockPool`` /
``ShardedBlockPool`` / ``Scheduler`` with the same submits and the same
completions, and what it observes (tokens per request, evictions, the
stats, the plans' shapes) must be equal; the reference test's own
assertions are then made on the port's run:

* ``prefill_first`` starves a decode request under a prompt flood where
  ``mixed`` finishes it (WFE and Crystalline, 1 and 4 shards);
* a mixed tick spends one token budget (decode rows, then one chunk);
* ``max_batch`` is a hard cap with plans pipelined;
* an evicted request requeues at the head of its queue;
* SLO classes: interactive admits before an older batch request, sheds a
  batch request under pool pressure, and is never shed for one;
* ``deadline_ms=0`` stays live and counts its cutoffs; bad policies, SLO
  names and budgets are refused.

Engine-level runs serve the smoke stablelm-3b on both packages (weights
carried over by ``from_jax_params``), token- and stat-exact, each draining
to zero unreclaimed blocks with every block free: ``prefill_first``
against ``mixed`` (the same tokens), the SLO classes through the engine,
shedding on a pool too small for every table with a third of the requests
in the batch class, ``pow2`` against ``maxlen`` buckets (the same tokens;
``maxlen`` dispatches no more step shapes, one table width for a request's
life), and the order of the TTFT/TPOT stamps.
"""

import jax
import numpy as np
import pytest

import repro.blocks as ref_blocks
from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import build_model
from repro.serve import ServeEngine as RefEngine
import repro_torch.blocks as port_blocks
from repro_torch.configs import get_smoke_config
from repro_torch.models.params import from_jax_params
from repro_torch.serve import ServeEngine

LIBS = {"ref": ref_blocks, "port": port_blocks}


def _both(scenario, *args):
    """Run ``scenario(lib, *args)`` on both packages; their observations
    must be equal.  Returns the port's."""
    got = {name: scenario(lib, *args) for name, lib in LIBS.items()}
    assert got["port"] == got["ref"]
    return got["port"]


def _stats(sched):
    """The scheduler's counters the reference keeps (the port's own token
    counters left out)."""
    return {k: sched.stats[k] for k in ref_blocks.scheduler.STAT_KEYS}


def _complete(sched, plan, tid, tok=5):
    sched.complete(plan, np.full((len(plan.requests),), tok, np.int64), tid)


def _drive(sched, pool, tid, *, max_ticks=2000, until=None):
    """Tick and complete until ``until()`` (default: everything drained);
    returns the kinds of the plans it completed."""
    kinds = []
    for _ in range(max_ticks):
        if until is not None and until():
            return kinds
        plan = sched.tick(tid)
        if plan is None:
            if until is None and not sched.pending() and not sched.active:
                return kinds
            pool.cleanup(tid)
            continue
        kinds.append(plan.kind)
        _complete(sched, plan, tid)
    raise AssertionError("drive() hit the tick limit (livelock?)")


def _req(r):
    return (r.rid, list(r.generated), r.evictions, r.done)


# ====================================================== starvation A/B
def _starvation(lib, scheme, n_shards):
    n_new, flood_len = 8, 16
    out = {}
    for policy in ("prefill_first", "mixed"):
        if n_shards > 1:
            pool = lib.ShardedBlockPool(256, n_shards=n_shards,
                                        max_threads=4, scheme=scheme,
                                        era_freq=1, cleanup_freq=1)
        else:
            pool = lib.BlockPool(256, max_threads=4, scheme=scheme,
                                 era_freq=1, cleanup_freq=1)
        tid = pool.register_thread()
        sched = lib.Scheduler(pool, block_size=4, max_batch=4, chunk_size=4,
                              policy=policy)
        victim = sched.submit([1, 2], n_new)
        _drive(sched, pool, tid, until=lambda: victim.phase == "decode")
        floods: list = []
        for step in range(60):
            if victim.done:
                break
            while sum(1 for r in floods
                      if r.shard == victim.shard and not r.done) < 4:
                for _ in range(n_shards):
                    floods.append(
                        sched.submit([3 + step % 7] * flood_len, 1))
            plan = sched.tick(tid)
            if plan is None:
                pool.cleanup(tid)
                continue
            _complete(sched, plan, tid)
        out[policy] = (len(victim.generated), len(floods),
                       _stats(sched))
    return out


@pytest.mark.parametrize("scheme", ("WFE", "Crystalline"))
@pytest.mark.parametrize("n_shards", (1, 4))
def test_mixed_planner_fixes_decode_starvation(scheme, n_shards):
    got = _both(_starvation, scheme, n_shards)
    assert got["mixed"][0] == 8
    assert got["prefill_first"][0] < 8


# ====================================================== one budget a tick
def _mixed_budget(lib):
    pool = lib.BlockPool(64, max_threads=2, era_freq=1, cleanup_freq=1)
    tid = pool.register_thread()
    sched = lib.Scheduler(pool, block_size=4, max_batch=4, chunk_size=4,
                          token_budget=6)
    decs = [sched.submit([1, 2], 4) for _ in range(3)]
    _drive(sched, pool, tid,
           until=lambda: all(r.phase == "decode" for r in decs))
    pre = sched.submit([9] * 12, 1)
    plan = sched.tick(tid)
    seen = (plan.kind, plan.n_decode, plan.requests[-1] is pre,
            plan.n_tokens, list(plan.chunk_lens),
            plan.tokens[3, :3].tolist())
    _complete(sched, plan, tid)
    length = pre.length
    _drive(sched, pool, tid)
    return seen, length, pre.done, _stats(sched)


def test_mixed_plan_spends_one_budget_per_tick():
    seen, length, done, stats = _both(_mixed_budget)
    assert seen == ("mixed", 3, True, 6, [1, 1, 1, 3], [9, 9, 9])
    assert length == 3 and done and stats["mixed_steps"] > 0


# ====================================================== hard active cap
def _hard_cap(lib):
    pool = lib.BlockPool(64, max_threads=2, era_freq=1, cleanup_freq=1)
    tid = pool.register_thread()
    sched = lib.Scheduler(pool, block_size=4, max_batch=2, max_inflight=4)
    reqs = [sched.submit([1, 2, 3], 3) for _ in range(8)]
    inflight, most = [], 0
    for _ in range(400):
        if all(r.done for r in reqs):
            break
        plan = sched.tick(tid)
        most = max(most, len(sched.active))
        if plan is not None:
            inflight.append(plan)
        if len(inflight) >= 3 or (plan is None and inflight):
            _complete(sched, inflight.pop(0), tid)
        elif plan is None:
            pool.cleanup(tid)
    for p in inflight:
        _complete(sched, p, tid)
    _drive(sched, pool, tid)
    return most, [_req(r) for r in reqs], _stats(sched)


def test_max_batch_is_a_hard_active_cap():
    most, reqs, _ = _both(_hard_cap)
    assert most <= 2
    assert all(done for *_, done in reqs)


# ====================================================== FCFS on eviction
def _requeue(lib):
    pool = lib.BlockPool(6, max_threads=2, era_freq=1, cleanup_freq=1)
    tid = pool.register_thread()
    sched = lib.Scheduler(pool, block_size=2, max_batch=2)
    a = sched.submit([1, 2], 8)
    b = sched.submit([1, 2], 8)
    c = sched.submit([1, 2], 1)
    heads = []
    for _ in range(2000):
        if a.done and b.done and c.done:
            break
        was = sched.stats["evictions"]
        plan = sched.tick(tid)
        if sched.stats["evictions"] > was:
            q = sched.queue
            heads.append((q[0].rid, q[0].evictions,
                          q.index(c) if c in q else None))
        if plan is None:
            pool.cleanup(tid)
            continue
        _complete(sched, plan, tid)
    return heads, [_req(r) for r in (a, b, c)]


def test_evicted_request_requeues_at_head():
    heads, reqs = _both(_requeue)
    assert heads, "pressure never forced an eviction (dead test)"
    c_rid = reqs[2][0]
    for rid, evictions, c_pos in heads:
        assert rid != c_rid and evictions > 0
        assert c_pos is None or c_pos > 0
    assert all(done for *_, done in reqs)


# ====================================================== SLO classes
def _interactive_first(lib):
    pool = lib.BlockPool(32, max_threads=2, era_freq=1, cleanup_freq=1)
    tid = pool.register_thread()
    sched = lib.Scheduler(pool, block_size=4, max_batch=1)
    b = sched.submit([1, 2], 2, slo="batch")
    i = sched.submit([1, 2], 2, slo="interactive")
    plan = sched.tick(tid)
    first = [r.rid for r in sched.active]
    _complete(sched, plan, tid)
    _drive(sched, pool, tid)
    return first, i.rid, i.done and b.done, i.t_first < b.t_first


def test_interactive_admits_before_older_batch():
    first, i_rid, done, earlier = _both(_interactive_first)
    assert first == [i_rid] and done and earlier


def _pressure(lib, order):
    pool = lib.BlockPool(6, max_threads=2, era_freq=1, cleanup_freq=1)
    tid = pool.register_thread()
    sched = lib.Scheduler(pool, block_size=2, max_batch=2)
    reqs = {slo: sched.submit([1, 2], 8, slo=slo) for slo in order}
    _drive(sched, pool, tid)
    return ({slo: _req(r) for slo, r in reqs.items()}, _stats(sched))


def test_interactive_sheds_older_batch_under_pressure():
    reqs, stats = _both(_pressure, ("batch", "interactive"))
    assert reqs["batch"][3] and reqs["interactive"][3]
    assert stats["batch_evictions"] > 0
    assert reqs["batch"][2] > 0 and reqs["interactive"][2] == 0


def test_batch_never_preempts_interactive():
    reqs, _ = _both(_pressure, ("batch", "interactive"))
    assert reqs["interactive"][2] == 0
    # interactive submitted first: still never shed for the batch request
    reqs, _ = _both(_pressure, ("interactive", "batch"))
    assert reqs["interactive"][2] == 0 and reqs["batch"][3]


def _bad_inputs(lib):
    refused = []
    pool = lib.BlockPool(8, max_threads=2)
    for kw in ({"policy": "fifo"}, {"token_budget": 0}):
        try:
            lib.Scheduler(pool, block_size=4, max_batch=2, **kw)
        except ValueError:
            refused.append(sorted(kw))
    sched = lib.Scheduler(pool, block_size=4, max_batch=2)
    try:
        sched.submit([1], 1, slo="premium")
    except ValueError:
        refused.append(["slo"])
    return refused


def test_bad_configs_and_slo_names_are_refused():
    assert _both(_bad_inputs) == [["policy"], ["token_budget"], ["slo"]]


# ====================================================== deadline bound
def _zero_deadline(lib):
    pool = lib.BlockPool(6, max_threads=2, era_freq=1, cleanup_freq=1)
    tid = pool.register_thread()
    sched = lib.Scheduler(pool, block_size=2, max_batch=4, deadline_ms=0.0)
    reqs = [sched.submit([1, 2], 6) for _ in range(4)]
    kinds = _drive(sched, pool, tid, max_ticks=4000)
    return [_req(r) for r in reqs], kinds, _stats(sched)


def test_zero_deadline_stays_live_and_counts_cutoffs():
    reqs, _, stats = _both(_zero_deadline)
    assert all(done for *_, done in reqs)
    assert stats["deadline_cutoffs"] > 0


# ====================================================== engine level
@pytest.fixture(scope="module")
def models():
    ref_cfg = ref_smoke_config("stablelm-3b")
    cfg = get_smoke_config("stablelm-3b")
    ref_params = build_model(ref_cfg).init(jax.random.key(0))
    params = from_jax_params(cfg, jax.tree.map(np.asarray, ref_params),
                             device="cpu")
    return ref_cfg, cfg, ref_params, params


def _serve(models, lib, trace, n_blocks, **kw):
    """Serve ``trace`` ((prompt, new, slo) each) on one package's engine;
    returns (requests, stats, engine) after a full drain."""
    ref_cfg, cfg, ref_params, params = models
    if lib == "ref":
        engine = RefEngine(ref_cfg, ref_params, n_blocks=n_blocks, **kw)
    else:
        engine = ServeEngine(cfg, params, n_blocks=n_blocks, device="cpu",
                             **kw)
    engine.victims = _watch_victims(engine.sched)
    tid = engine.pool.register_thread()
    reqs = [engine.submit(p, n, slo=slo) for p, n, slo in trace]
    stats = engine.run(tid)
    assert all(r.done for r in reqs)
    assert engine.pool.unreclaimed() == 0
    assert engine.pool.free_blocks == n_blocks
    return reqs, stats, engine


def _watch_victims(sched):
    """Record (requester's class, victim's class) of every preemption the
    scheduler's shedding ladder picks."""
    pick, pairs = sched._pick_victim, []

    def watched(exclude, shard=None):
        victim = pick(exclude, shard=shard)
        if victim is not None:
            pairs.append((exclude.slo, victim.slo))
        return victim

    sched._pick_victim = watched
    return pairs


def _serve_both(models, trace, n_blocks, **kw):
    (ref_reqs, ref_stats, _), (reqs, stats, engine) = (
        _serve(models, lib, trace, n_blocks, **kw) for lib in ("ref", "port"))
    assert [r.generated for r in reqs] == [r.generated for r in ref_reqs]
    assert {k: stats[k] for k in ref_stats} == ref_stats
    return reqs, stats, engine


PROMPTS = [[5, 9, 2], [11, 3, 8, 1], [7, 4, 4, 1, 2], [2, 4]]


def test_engine_prefill_first_and_mixed_are_token_exact(models):
    trace = [(p, 5, "interactive") for p in PROMPTS]
    kw = dict(block_size=4, max_batch=4, chunk_size=4, era_freq=1,
              cleanup_freq=1)
    outs = {}
    for policy in ("prefill_first", "mixed"):
        reqs, stats, _ = _serve_both(models, trace, 32, sched_policy=policy,
                                     **kw)
        assert stats["completed"] == len(PROMPTS)
        if policy == "mixed":
            assert stats["mixed_steps"] > 0
        else:
            assert stats["mixed_steps"] == 0
        outs[policy] = [list(r.generated) for r in reqs]
    assert outs["mixed"] == outs["prefill_first"]


def _ragged_trace(n=10, seed=3):
    rng = np.random.default_rng(seed)
    return [([int(t) for t in rng.integers(1, 200, int(rng.integers(1, 30)))],
             6, "batch" if i % 3 == 0 else "interactive") for i in range(n)]


@pytest.mark.parametrize("n_shards", (1, 2))
def test_engine_prefill_first_and_pow2_under_pressure(models, n_shards):
    """Ragged prompts (1-29 tokens), a third in the batch class, on a pool
    too small for every table at once: ``prefill_first`` with ``pow2``
    buckets and a token budget, against the reference."""
    _, stats, _ = _serve_both(
        models, _ragged_trace(), 24, block_size=4, max_batch=4, chunk_size=8,
        token_budget=8, sched_policy="prefill_first", bucket_policy="pow2",
        n_shards=n_shards, era_freq=1, cleanup_freq=1)
    assert stats["completed"] == 10
    assert stats["evictions"] > 0


def test_engine_sheds_batch_requests_under_pressure(models):
    """A pool of 16 blocks for 12 ragged requests, every third in the batch
    class: interactive requesters shed batch ones, and no interactive
    request is ever shed for a batch one."""
    _, stats, engine = _serve_both(
        models, _ragged_trace(12, seed=5), 16, block_size=4, max_batch=4,
        chunk_size=8, era_freq=1, cleanup_freq=1)
    assert stats["batch_evictions"] > 0
    assert ("interactive", "batch") in engine.victims
    assert ("batch", "interactive") not in engine.victims


def test_engine_submit_slo_passthrough(models):
    reqs, _, _ = _serve_both(
        models, [([5, 9, 2], 3, "interactive"), ([5, 9, 2], 3, "batch")], 32,
        block_size=4, max_batch=4, era_freq=1, cleanup_freq=1)
    assert [r.slo for r in reqs] == ["interactive", "batch"]
    assert all(r.max_gap >= 0.0 for r in reqs)


# ====================================================== bucket policy
#: one long-generation request walks its table through several pow2
#: boundaries while the short ones stay narrow
BUCKET_TRACE = [([3, 1, 4, 1, 5], 26, "interactive"), ([2, 7], 4,
                                                       "interactive"),
                ([9, 2, 6], 5, "interactive"), ([8], 4, "interactive")]
BUCKET_KW = dict(block_size=2, max_batch=4, chunk_size=4, era_freq=4,
                 cleanup_freq=4)


def test_coarse_and_pow2_buckets_token_identical(models):
    toks, shapes = {}, {}
    for policy in ("maxlen", "pow2"):
        reqs, _, engine = _serve_both(models, BUCKET_TRACE, 48,
                                      bucket_policy=policy, **BUCKET_KW)
        toks[policy] = [list(r.generated) for r in reqs]
        shapes[policy] = engine.compile_cache_size()
    assert toks["maxlen"] == toks["pow2"]
    # fewer padded step shapes under the coarse policy (the reference's
    # compile-count gate, on the port's count of dispatched shapes)
    assert shapes["maxlen"] <= shapes["pow2"]
    assert shapes["maxlen"] <= 6


def test_maxlen_width_covers_final_table(models):
    _, cfg, _, params = models
    engine = ServeEngine(cfg, params, n_blocks=48, device="cpu",
                         bucket_policy="maxlen", **BUCKET_KW)
    tid = engine.pool.register_thread()
    prompt, n_new, _ = BUCKET_TRACE[0]
    req = engine.submit(prompt, n_new)
    final_blocks = -(-(len(prompt) + n_new) // 2)
    widths = set()
    plan = engine.sched.tick(tid)
    while plan is not None:
        width = engine._bucket_tables(plan, engine.max_batch).shape[1]
        widths.add(width)
        assert width >= final_blocks
        engine.execute_plan(plan, tid)
        plan = engine.sched.tick(tid)
    assert req.done
    assert len(widths) == 1
    engine.drain(tid)


def test_invalid_bucket_policy_rejected(models):
    _, cfg, _, params = models
    with pytest.raises(ValueError, match="bucket_policy"):
        ServeEngine(cfg, params, bucket_policy="hwm", device="cpu")


# ====================================================== latency stamps
def test_ttft_tpot_stamps_in_order(models):
    _, cfg, _, params = models
    engine = ServeEngine(cfg, params, n_blocks=32, block_size=4, max_batch=4,
                         chunk_size=4, era_freq=1, cleanup_freq=1,
                         device="cpu")
    tid = engine.pool.register_thread()
    req = engine.submit([1, 2, 3, 4, 5], 4)
    one = engine.submit([6, 7], 1)
    assert req.ttft is None and req.tpot is None
    engine.run(tid)
    assert req.ttft is not None and req.ttft >= 0
    assert req.tpot is not None and req.tpot >= 0
    assert req.t_last >= req.t_first >= req.t_submit
    # one generated token: a first-token time, no time per output token
    assert one.ttft is not None and one.tpot is None
    assert one.t_last == one.t_first >= one.t_submit
    assert req.ttft == req.t_first - req.t_submit
    assert req.tpot == pytest.approx(
        (req.t_last - req.t_first) / (len(req.generated) - 1))
