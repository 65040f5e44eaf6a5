"""The port's sharded pool, sharded engine and multi-worker runtime held
against ``repro`` on the CPU (the counterpart of test_serve_runtime.py).

* The sharded engine, and ``ServeRuntime`` with 2 and 3 workers under each
  of the five pool schemes on 1 and 2 shards, emit the greedy tokens of
  ``repro``'s unsharded single-worker engine on the same trace and the
  same ``from_jax_params`` weights, exactly, and drain to
  ``unreclaimed == 0`` with every block free.
* ``ShardedBlockPool`` driven through one seeded alloc/retire/protect/
  cleanup history in both packages hands out the same slots, frees the
  same counts and ends with the same stats; routing, cross-shard and
  shard-pinned protection as in the reference.
* ``ShardedEraDomain`` merges skewed clocks as the reference does.
"""

import random

import jax
import numpy as np
import pytest

from repro.blocks import PoolExhausted as RefPoolExhausted
from repro.blocks import ShardedBlockPool as RefShardedBlockPool
from repro.configs import get_smoke_config as ref_smoke_config
from repro.core.distributed_eras import ShardedEraDomain as RefEraDomain
from repro.models import build_model
from repro.serve import ServeEngine as RefEngine
from repro_torch.blocks import PoolExhausted, ShardedBlockPool
from repro_torch.configs import get_smoke_config
from repro_torch.core import ShardedEraDomain
from repro_torch.models.params import from_jax_params
from repro_torch.serve import ServeEngine, ServeRuntime

POOL_SCHEMES = ("WFE", "Crystalline", "HE", "EBR", "2GEIBR")
PROMPTS = [[5, 9, 2], [11, 3, 8, 1], [7], [2, 4], [9, 9, 1], [13]]
N_NEW = 5


@pytest.fixture(scope="module")
def models():
    ref_cfg = ref_smoke_config("stablelm-3b")
    cfg = get_smoke_config("stablelm-3b")
    ref_params = build_model(ref_cfg).init(jax.random.key(0))
    params = from_jax_params(cfg, jax.tree.map(np.asarray, ref_params),
                             device="cpu")
    return ref_cfg, cfg, ref_params, params


@pytest.fixture(scope="module")
def reference(models):
    """``repro``'s unsharded single-worker engine on the trace: (tokens,
    stats), the ground truth of every engine and runtime below."""
    ref_cfg, _, ref_params, _ = models
    engine = RefEngine(ref_cfg, ref_params, n_blocks=32, block_size=4,
                       max_batch=4, era_freq=1, cleanup_freq=1)
    tid = engine.pool.register_thread()
    reqs = [engine.submit(p, N_NEW) for p in PROMPTS]
    stats = engine.run(tid)
    assert all(r.done for r in reqs)
    return [list(r.generated) for r in reqs], stats


def _engine(models, **kw):
    _, cfg, _, params = models
    kw.setdefault("n_blocks", 32)
    kw.setdefault("block_size", 4)
    kw.setdefault("max_batch", 4)
    kw.setdefault("era_freq", 1)
    kw.setdefault("cleanup_freq", 1)
    return ServeEngine(cfg, params, device="cpu", **kw)


# ============================================================ drain
@pytest.mark.parametrize("scheme", POOL_SCHEMES)
def test_engine_drain_terminates_all_schemes(models, scheme,
                                             quiescence_check):
    """The final drain reaches unreclaimed() == 0 on its own."""
    engine = _engine(models, scheme=scheme, era_freq=2, cleanup_freq=2)
    tid = engine.pool.register_thread()
    reqs = [engine.submit(p, N_NEW) for p in PROMPTS[:4]]
    stats = engine.run(tid)
    assert stats["completed"] == 4
    assert all(r.done for r in reqs)
    quiescence_check(engine.pool, label=scheme, rounds=0)


@pytest.mark.parametrize("shards", (1, 2))
def test_engine_drain_bounded_under_live_reservation(models, shards):
    """A still-held reservation makes drain RETURN (bounded), not spin."""
    engine = _engine(models, n_blocks=16, n_shards=shards)
    t0 = engine.pool.register_thread()
    t1 = engine.pool.register_thread()
    blk = engine.pool.alloc(t0)
    engine.pool.protect_step(0, t1)  # a live in-flight reservation
    engine.pool.retire(blk, t0)
    assert engine.drain(t0) == 1, "pinned block should survive the drain"
    engine.pool.release_step(0, t1)
    assert engine.drain(t0) == 0


# ============================================================ sharded engine
def test_sharded_engine_matches_unsharded_and_reference(models, reference,
                                                        quiescence_check):
    """Request-level sharding changes placement, never tokens: the port's
    2-shard engine, its unsharded engine and ``repro``'s engines (sharded
    and not) emit the same tokens; the port's sharded run also ends with
    the reference's sharded stats."""
    ref_cfg, _, ref_params, _ = models
    want, _ = reference
    ref_sharded = RefEngine(ref_cfg, ref_params, n_blocks=32, block_size=4,
                            max_batch=4, n_shards=2, era_freq=1,
                            cleanup_freq=1)
    ref_reqs = [ref_sharded.submit(p, N_NEW) for p in PROMPTS]
    ref_stats = ref_sharded.run(ref_sharded.pool.register_thread())
    assert [r.generated for r in ref_reqs] == want
    for shards in (1, 2):
        engine = _engine(models, n_shards=shards)
        tid = engine.pool.register_thread()
        reqs = [engine.submit(p, N_NEW) for p in PROMPTS]
        stats = engine.run(tid)
        assert stats["completed"] == len(PROMPTS)
        assert [r.generated for r in reqs] == want
        quiescence_check(engine.pool, label=f"s{shards}", rounds=0)
    assert {r.shard for r in reqs} == {0, 1}, "a shard hosted no request"
    assert {k: stats[k] for k in ref_stats} == ref_stats
    assert engine.pool.stats()["n_shards"] == 2


def test_sharded_engine_localizes_tables(models):
    """Each shard's device pool holds its own slots plus one scratch slot,
    and a plan's tables reach the step shard-local."""
    engine = _engine(models, n_blocks=13, n_shards=2)
    sizes = [p.n_blocks for p in engine.pool.shards]
    assert sizes == [7, 6]
    assert [p["k"].shape[1] for p in engine._shard_pools] == [8, 7]
    assert engine.pools is engine._shard_pools[0]
    seen = []
    real = engine._run_step

    def spy(plan, step, arrays, b):
        seen.append((plan.shard, arrays[0].copy()))
        return real(plan, step, arrays, b)

    engine._run_step = spy
    tid = engine.pool.register_thread()
    for p in PROMPTS:
        engine.submit(p, N_NEW)
    engine.run(tid)
    assert {s for s, _ in seen} == {0, 1}
    for s, tables in seen:
        assert tables.min() >= 0 and tables.max() <= sizes[s]  # scratch


# ============================================================ runtime
@pytest.mark.parametrize("scheme", POOL_SCHEMES)
@pytest.mark.parametrize("shards", (1, 2))
def test_runtime_matches_reference(models, reference, scheme, shards):
    """2 (1 shard) or 3 (2 shards) workers under each pool scheme: the
    reference's tokens, merged per-worker stats, no leak."""
    want, _ = reference
    engine = _engine(models, scheme=scheme, n_shards=shards, max_threads=8,
                     max_inflight=6, era_freq=2, cleanup_freq=2)
    reqs = [engine.submit(p, N_NEW) for p in PROMPTS]
    runtime = ServeRuntime(engine, n_workers=shards + 1)
    stats = runtime.serve()
    assert stats["completed"] == len(PROMPTS)
    assert stats["unreclaimed"] == 0
    assert [r.generated for r in reqs] == want
    assert engine.pool.free_blocks == 32, "runtime leaked pool slots"
    merged = engine.sched.stats
    assert merged["admitted"] >= len(PROMPTS)
    assert merged["steps"] == sum(
        st["steps"] for st in engine.sched._worker_stats.values())
    assert sum(stats["worker_steps"]) == merged["steps"]


def test_crystalline_engine_matches_reference_tokens(models, reference,
                                                     quiescence_check):
    """Batched retirement changes WHEN slots recycle, never tokens."""
    want, _ = reference
    engine = _engine(models, scheme="Crystalline", n_shards=2)
    tid = engine.pool.register_thread()
    reqs = [engine.submit(p, N_NEW) for p in PROMPTS]
    engine.run(tid)
    assert [r.generated for r in reqs] == want
    quiescence_check(engine.pool, label="Crystalline", rounds=0)
    smr_stats = engine.pool.stats()
    assert smr_stats["batches_sealed"] > 0
    assert smr_stats["batches_freed"] == smr_stats["batches_sealed"]


@pytest.mark.parametrize("scheme", ("WFE", "Crystalline"))
def test_runtime_forced_slow_path(models, scheme):
    """Concurrent workers with the wait-free slow path forced end to end."""
    engine = _engine(models, scheme=scheme, n_shards=2, max_threads=8,
                     max_attempts=1)
    reqs = [engine.submit([3, 1, 4], 4) for _ in range(4)]
    stats = ServeRuntime(engine, n_workers=2).serve()
    assert stats["completed"] == 4
    assert all(r.done for r in reqs)
    assert stats["unreclaimed"] == 0
    assert sum(sum(smr.slow_path_count) for smr in engine.pool.smrs) > 0


def test_run_is_run_worker_then_drain(models, reference):
    """``run`` goes through ``run_worker``; ``exit_when_idle=False`` parks
    until ``stop`` is set, and ``on_first_step`` fires once."""
    import threading

    want, _ = reference
    engine = _engine(models, n_shards=2)
    tid = engine.pool.register_thread()
    reqs = [engine.submit(p, N_NEW) for p in PROMPTS]
    stop = threading.Event()
    first = []
    th = threading.Thread(target=engine.run_worker, args=(tid,),
                          kwargs=dict(stop=stop, exit_when_idle=False,
                                      on_first_step=lambda: first.append(1)))
    th.start()
    for _ in range(2000):
        if all(r.done for r in reqs):
            break
        th.join(0.01)
    assert th.is_alive(), "a persistent worker exited while idle"
    stop.set()
    with engine.sched._work:
        engine.sched._work.notify_all()
    th.join(30)
    assert not th.is_alive()
    assert first == [1]
    assert [r.generated for r in reqs] == want
    assert engine.drain(tid) == 0
    assert engine.clear_compile_caches() and engine.compile_cache_size() == 0


# ============================================================ sharded pool
def _smr_kwargs(scheme):
    clock = "era_freq" if scheme in ("WFE", "HE", "Crystalline") \
        else "epoch_freq"
    return {clock: 1, "cleanup_freq": 1}


def _pool_history(make, exhausted, scheme, seed, steps=300):
    """One seeded history of pinned and unpinned allocs, bulk allocs,
    retires, step protections, per-shard and fan-out cleanups, era ticks
    and merges; returns what the pool answered at every step."""
    rng = random.Random(seed)
    pool = make(13, n_shards=2, scheme=scheme, max_threads=4,
                **_smr_kwargs(scheme))
    tids = [pool.register_thread() for _ in range(3)]
    held, log = [], []
    for _ in range(steps):
        op = rng.random()
        tid = rng.choice(tids)
        shard = rng.choice((None, 0, 1))
        if op < 0.3:
            try:
                blk = pool.alloc(tid, shard=shard)
                held.append(blk)
                log.append(("alloc", blk.index, blk.home_shard))
            except exhausted:
                log.append(("alloc", "exhausted"))
        elif op < 0.4:
            n = rng.randint(1, 3)
            try:
                blks = pool.alloc_blocks(n, tid, shard=shard)
                held += blks
                log.append(("bulk", [b.index for b in blks]))
            except exhausted:
                log.append(("bulk", "exhausted"))
        elif op < 0.65 and held:
            blk = held.pop(rng.randrange(len(held)))
            pool.retire(blk, tid)
            log.append(("retire", blk.index))
        elif op < 0.72:
            pool.protect_step(rng.randrange(2), tid, shard=shard)
        elif op < 0.8:
            pool.release_step(rng.randrange(2), tid, shard=shard)
        elif op < 0.88:
            log.append(("cleanup", pool.cleanup(tid, shard=shard)))
        elif op < 0.93:
            log.append(("cleanup_all", pool.cleanup_all()))
        elif op < 0.97:
            pool.step_boundary(tid)
        else:
            pool.advance_eras(tid)
        log.append(("free", pool.free_blocks, pool.unreclaimed(),
                    tuple(pool.eras.locals)))
    return log, pool.stats()


@pytest.mark.parametrize("scheme", POOL_SCHEMES)
@pytest.mark.parametrize("seed", (0, 1))
def test_sharded_pool_history_matches_reference(scheme, seed):
    want = _pool_history(RefShardedBlockPool, RefPoolExhausted, scheme, seed)
    got = _pool_history(ShardedBlockPool, PoolExhausted, scheme, seed)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[1]["frees"] > 0, "the history reclaimed nothing"
    assert ("alloc", "exhausted") in got[0], "the pool never ran dry"


@pytest.mark.parametrize("scheme", ("WFE", "Crystalline"))
def test_sharded_pool_routing_and_reclamation(scheme, quiescence_check):
    pool = ShardedBlockPool(12, n_shards=3, max_threads=4, scheme=scheme,
                            era_freq=1, cleanup_freq=1)
    tid = pool.register_thread()
    for s in range(3):  # pinned allocation stays in range
        blk = pool.alloc(tid, shard=s)
        base = pool.shards[s].first_block
        assert base <= blk.index < base + pool.shards[s].n_blocks
        assert blk.home_shard == s
        pool.retire(blk, tid)
    # unpinned allocation steals across shards under pressure
    blks = [pool.alloc(tid) for _ in range(9)]
    assert len({b.home_shard for b in blks}) == 3
    for b in blks:
        pool.retire(b, tid)
    quiescence_check(pool, label=f"sharded/{scheme}", tid=tid)


def _drain_rounds(pool, tid, rounds=8):
    for _ in range(rounds):
        pool.cleanup_all()
        pool.advance_eras(tid)


def test_sharded_pool_cross_shard_protection():
    """A step reservation published per shard pins every shard's blocks."""
    pool = ShardedBlockPool(8, n_shards=2, max_threads=4, era_freq=1,
                            cleanup_freq=1)
    t0 = pool.register_thread()
    t1 = pool.register_thread()
    blks = [pool.alloc(t0, shard=s) for s in range(2)]
    pool.protect_step(0, t1)  # unpinned step: reserves in BOTH shards
    for b in blks:
        pool.retire(b, t0)
    _drain_rounds(pool, t0)
    assert all(not b.freed for b in blks), "reservation failed to pin"
    pool.release_step(0, t1)
    _drain_rounds(pool, t0)
    assert all(b.freed for b in blks)


def test_sharded_pool_shard_pinned_protection():
    """A shard-pinned step reserves only its own shard's clock."""
    pool = ShardedBlockPool(8, n_shards=2, max_threads=4, era_freq=1,
                            cleanup_freq=1)
    t0 = pool.register_thread()
    t1 = pool.register_thread()
    b0 = pool.alloc(t0, shard=0)
    b1 = pool.alloc(t0, shard=1)
    pool.protect_step(0, t1, shard=0)
    pool.retire(b0, t0)
    pool.retire(b1, t0)
    _drain_rounds(pool, t0)
    assert not b0.freed, "shard-0 reservation failed to pin"
    assert b1.freed, "shard-1 block should reclaim (no reservation there)"
    pool.release_step(0, t1, shard=0)
    _drain_rounds(pool, t0)
    assert b0.freed


@pytest.mark.parametrize("n_shards", (1, 2, 3))
def test_sharded_pool_rejects_bad_sizes(n_shards):
    with pytest.raises(ValueError):
        ShardedBlockPool(n_shards - 1, n_shards=n_shards)
    with pytest.raises(ValueError):
        ShardedBlockPool(4, n_shards=0)


# ============================================================ era domain
def test_sharded_era_domain_merge_matches_reference():
    """Skewed clocks merge to the fleet max, never regress, and report the
    reference's locals and stats at every round."""
    def run(pool_cls, domain_cls):
        smrs = [pool_cls(4, n_shards=1, max_threads=2).shards[0].smr
                for _ in range(3)]
        dom = domain_cls(smrs)
        smrs[0].global_era.fa_add(10)
        smrs[2].global_era.fa_add(3)
        trace = [tuple(dom.locals), dom.spread()]
        m = dom.merge_all()
        assert m == max(trace[0]) and dom.spread() == 0
        assert all(a >= b for a, b in zip(dom.locals, trace[0]))
        trace += [m, tuple(dom.locals)]
        smrs[1].global_era.fa_add(5)
        trace += [dom.spread(), dom.merge_all(), dom.merge_all(), dom.stats()]
        return trace

    assert (run(ShardedBlockPool, ShardedEraDomain)
            == run(RefShardedBlockPool, RefEraDomain))

