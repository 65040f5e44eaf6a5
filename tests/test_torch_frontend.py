"""The port's cancellation path, SSE front end and serving CLI held against
``repro`` on the CPU (the counterpart of test_cancellation.py).

Every cancellation point of a request's life — queued, mid-prefill,
mid-decode, an in-flight row and a mixed-batch row — releases its pages
through the refcount/era path only, on 1 and 2 shards; the scheme x shard
cancellation matrix reclaims every abandoned page; survivors of a
cancellation emit the greedy tokens of ``repro``'s engine on the same
weights even with every freed pool slot scribbled NaN / 1e30; the HTTP
front end streams, cancels by DELETE and by disconnect, answers 429 and
/healthz and drains clean; the front end's selftest and the serving CLI
run on the CPU when asked (``--device cpu``) and on CUDA by default.
"""

import asyncio
import json
import threading

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import build_model
from repro.serve import ServeEngine as RefEngine
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models.params import from_jax_params
from repro_torch.serve import Frontend, ServeEngine, ServeRuntime
from repro_torch.serve import frontend as frontend_mod

POOL_SCHEMES = ("WFE", "Crystalline", "HE", "EBR", "2GEIBR")
ENGINE_KW = dict(n_blocks=48, block_size=4, max_batch=4, chunk_size=4,
                 era_freq=2, cleanup_freq=2)


@pytest.fixture(scope="module")
def models():
    ref_cfg = ref_smoke_config("stablelm-3b")
    cfg = get_smoke_config("stablelm-3b")
    ref_params = build_model(ref_cfg).init(jax.random.key(0))
    params = from_jax_params(cfg, jax.tree.map(np.asarray, ref_params),
                             device="cpu")
    return ref_cfg, cfg, ref_params, params


def _ref_tokens(models, prompts, n_new, **kw):
    """``repro``'s greedy tokens for ``prompts`` alone."""
    ref_cfg, _, ref_params, _ = models
    engine = RefEngine(ref_cfg, ref_params, **{**ENGINE_KW, **kw})
    reqs = [engine.submit(p, n_new) for p in prompts]
    engine.run(engine.pool.register_thread())
    return [list(r.generated) for r in reqs]


@pytest.fixture(scope="module")
def survivor_tokens(models):
    return _ref_tokens(models, SURVIVORS, 8, n_blocks=32,
                       prefix_caching=False)


def _engine(models, **kw):
    _, cfg, _, params = models
    return ServeEngine(cfg, params, device="cpu", **{**ENGINE_KW, **kw})


def _run_with(engine, tid, on_step=None, max_steps=10_000):
    """Drive the engine to quiescence, calling ``on_step`` between a
    completed step and the next tick (the deterministic cancel hook)."""
    for _ in range(max_steps):
        stepped = engine.step(tid)
        if on_step is not None:
            on_step()
        if not stepped and not engine.sched.pending() \
                and not engine.sched.active:
            return
    raise AssertionError("engine did not quiesce")


# ================================================== lifecycle cancel points
@pytest.mark.parametrize("shards", (1, 2))
def test_cancel_queued_request(models, shards, quiescence_check):
    """A queued cancel finalizes in place: no pages, no device steps."""
    engine = _engine(models, max_batch=2, n_shards=shards)
    tid = engine.pool.register_thread()
    keep = [engine.submit([1 + i, 2, 3], 4) for i in range(2)]
    victim = engine.submit([9, 9, 9], 4)
    assert engine.cancel(victim) is True
    assert victim.state == "cancelled"
    assert victim.t_released is not None and victim.cancel_latency >= 0
    assert engine.cancel(victim) is False, "second cancel must be a no-op"
    engine.run(tid)
    assert all(r.done for r in keep)
    assert victim.generated == [] and victim.table is None
    stats = engine.sched.stats
    assert stats["cancelled"] == 1 and stats["cancelled_blocks"] == 0
    assert [r.generated for r in keep] == _ref_tokens(
        models, [r.prompt for r in keep], 4, max_batch=2)
    quiescence_check(engine.pool, label="queued-cancel", rounds=0)


@pytest.mark.parametrize("phase", ("prefill", "decode"))
@pytest.mark.parametrize("shards", (1, 2))
def test_cancel_mid_phase_releases_blocks(models, phase, shards,
                                          quiescence_check):
    """Cancelling mid-prefill / mid-decode releases every page at the next
    tick; the survivor keeps the reference's tokens."""
    engine = _engine(models, n_shards=shards)
    tid = engine.pool.register_thread()
    survivor = engine.submit([3, 1, 4, 1, 5], 6)
    victim = engine.submit([2 + i % 7 for i in range(12)], 8)
    done_cancel = []

    def maybe_cancel():
        if done_cancel:
            return
        mid = (0 < victim.length < len(victim.prompt)) \
            if phase == "prefill" else len(victim.generated) >= 2
        if mid:
            assert len(victim.table) > 0, "victim holds no pages yet"
            assert engine.cancel(victim)
            done_cancel.append(True)

    _run_with(engine, tid, on_step=maybe_cancel)
    assert done_cancel, f"never observed the victim mid-{phase}"
    assert victim.state == "cancelled"
    assert len(victim.table) == 0, "cancelled table still holds blocks"
    assert victim.cancel_latency is not None
    assert survivor.done and survivor.state == "done"
    assert survivor.generated == _ref_tokens(models, [survivor.prompt], 6)[0]
    assert engine.sched.stats["cancelled_blocks"] > 0
    engine.drain(tid)
    quiescence_check(engine.pool, label=f"mid-{phase}", rounds=0)


@pytest.mark.parametrize("shards", (1, 2))
def test_cancel_inflight_row_defers_release(models, shards,
                                            quiescence_check):
    """A cancel between tick and execute_plan: pages survive until the
    dispatched step's reservation clears, then release."""
    engine = _engine(models, n_shards=shards)
    tid = engine.pool.register_thread()
    reqs = [engine.submit([1 + i, 2, 3], 6) for i in range(3)]
    victim = None
    for _ in range(100):
        plan = engine.sched.tick(tid)
        if plan is None:
            continue
        row = next((r for r in plan.requests if not r.cancelled), None)
        if row is not None and row.phase == "decode":
            victim = row
            break
        engine.execute_plan(plan, tid)
    assert victim is not None, "no decode plan materialized"
    blocks_before = victim.table.current().blocks
    assert blocks_before, "victim owns no pages at dispatch time"
    assert engine.cancel(victim)
    assert victim.inflight, "victim must still be in flight"
    assert victim.t_released is None
    assert len(victim.table) == len(blocks_before)
    assert all(not b.freed for b in blocks_before), \
        "page freed under a live era reservation"
    engine.execute_plan(plan, tid)  # complete() finalizes the cancel
    assert victim.state == "cancelled" and not victim.inflight
    assert victim.t_released is not None
    assert len(victim.table) == 0
    _run_with(engine, tid)
    assert all(r.done for r in reqs if r is not victim)
    engine.drain(tid)
    quiescence_check(engine.pool, label="inflight-cancel", rounds=0)


def test_cancel_mixed_batch_row(models, quiescence_check):
    """Cancelling one decode row of an in-flight MIXED plan leaves the
    other rows undisturbed."""
    engine = _engine(models, sched_policy="mixed", token_budget=8)
    tid = engine.pool.register_thread()
    decoders = [engine.submit([1 + i, 2], 8) for i in range(2)]
    late = None
    victim = None
    for _ in range(200):
        if late is None and all(len(r.generated) >= 1 for r in decoders):
            late = engine.submit([5 + i % 7 for i in range(10)], 4)
        plan = engine.sched.tick(tid)
        if plan is None:
            if not engine.sched.pending() and not engine.sched.active:
                break
            continue
        if plan.kind == "mixed" and victim is None:
            victim = next(r for r in plan.requests if r.phase == "decode")
            assert engine.cancel(victim)
            assert victim.inflight and victim.t_released is None
        engine.execute_plan(plan, tid)
    assert victim is not None, "no mixed plan materialized"
    assert victim.state == "cancelled" and len(victim.table) == 0
    for r in [r for r in decoders + [late] if r is not None]:
        if r is not victim:
            assert r.done, (r.rid, r.state)
    engine.drain(tid)
    quiescence_check(engine.pool, label="mixed-row-cancel", rounds=0)


# =============================================== scheme x shard stress matrix
@pytest.mark.parametrize("scheme", POOL_SCHEMES)
@pytest.mark.parametrize("shards", (1, 4))
def test_cancellation_matrix_all_schemes(models, scheme, shards,
                                         quiescence_check):
    """Two workers under a half-abandoning workload: every scheme and
    sharding reclaims all abandoned pages at quiescence."""
    engine = _engine(models, scheme=scheme, n_shards=shards, n_blocks=64,
                     max_threads=8, max_inflight=4)
    n, cancel_after = 12, 2

    def cancel_hook(req, index, tok):
        if index + 1 >= cancel_after:  # runs under the scheduler lock
            engine.cancel(req)

    reqs = [engine.submit([1 + (i * 7 + j) % 29 for j in range(1 + i % 6)],
                          6, on_token=cancel_hook if i % 2 else None)
            for i in range(n)]
    engine.cancel(reqs[0])  # and one queued cancel before any tick
    stats = ServeRuntime(engine, n_workers=2).serve()
    assert stats["unreclaimed"] == 0
    assert stats["cancelled"] == n // 2 + 1, stats["cancelled"]
    assert stats["completed"] == n - stats["cancelled"]
    for r in reqs:
        assert r.state in ("done", "cancelled"), (r.rid, r.state)
        assert r.table is None or len(r.table) == 0
    assert all(r.cancel_latency is not None
               for r in reqs if r.state == "cancelled")
    quiescence_check(engine.pool, label=f"{scheme}/s{shards}", rounds=0)


# ========================================================= poisoned reclaim
SURVIVORS = [[3, 1, 4, 1, 5], [2, 7, 1]]
VICTIMS = [[8 + j % 11 for j in range(10)], [9, 9, 2, 6]]


@pytest.mark.parametrize("shards", (1, 2))
def test_cancelled_pages_never_read_poison(models, survivor_tokens, shards,
                                           quiescence_check):
    """Scribble K=NaN / V=1e30 over every pool slot no survivor owns once
    the cancellations finalize: survivors emit ``repro``'s tokens for
    them alone.  Any read of a freed page — including one reallocated from
    the cancelled requests' slots — would change them."""
    engine = _engine(models, n_blocks=32, prefix_caching=False,
                     n_shards=shards)
    tid = engine.pool.register_thread()
    survivors = [engine.submit(p, 8) for p in SURVIVORS]
    victims = [engine.submit(p, 8) for p in VICTIMS]
    poisoned = []

    def maybe_poison():
        # one shard at a time may run in a single thread, so each victim
        # is cancelled on its own, and the pools are scribbled again
        # each time another cancellation has finalized
        for v in victims:
            if len(v.generated) >= 2:
                engine.cancel(v)
        n_cancelled = sum(v.state == "cancelled" for v in victims)
        if n_cancelled == len(poisoned):
            return
        live = {i for s in survivors if s.table is not None
                for i in s.table.current().block_ids}
        dead = 0
        for s, base in enumerate(engine._shard_bases):
            pools = engine._shard_pools[s]
            size = engine._shard_sizes[s]
            slots = [i - base for i in range(base, base + size)
                     if i not in live]
            pools["k"][:, slots] = float("nan")
            pools["v"][:, slots] = 1e30
            dead += len(slots)
        poisoned.append((dead, any(not s.done for s in survivors)))

    _run_with(engine, tid, on_step=maybe_poison)
    assert len(poisoned) == len(VICTIMS) and min(poisoned)[0] > 0, \
        "poison never applied"
    assert any(reading for _, reading in poisoned), \
        "no survivor was still decoding over the poisoned pools"
    assert [s.generated for s in survivors] == survivor_tokens, \
        "a survivor read a freed/poisoned page"
    engine.drain(tid)
    quiescence_check(engine.pool, label="poison", rounds=0)


def test_cancelled_prefix_salvage_reused_bitwise(models, quiescence_check):
    """A cancelled request's materialized prefix stays cached; a later
    identical prompt HITS it and emits ``repro``'s cache-less tokens."""
    bs = 4
    prompt = [1 + j % 13 for j in range(3 * bs)]
    n_new = 6
    want = _ref_tokens(models, [prompt], n_new, prefix_caching=False)[0]
    engine = _engine(models, block_size=bs)
    tid = engine.pool.register_thread()
    victim = engine.submit(prompt, n_new)
    cancelled = []

    def maybe_cancel():
        if not cancelled and len(victim.generated) >= 2:
            assert engine.cancel(victim)
            cancelled.append(True)

    _run_with(engine, tid, on_step=maybe_cancel)
    assert victim.state == "cancelled"
    before = dict(engine.sched.stats)
    reader = engine.submit(prompt, n_new)
    _run_with(engine, tid)
    after = engine.sched.stats
    assert reader.done
    assert after["prefix_hits"] - before["prefix_hits"] >= 1
    assert after["prefix_hit_tokens"] - before["prefix_hit_tokens"] \
        >= (len(prompt) - 1) // bs * bs
    assert list(reader.generated) == want
    engine.drain(tid)
    quiescence_check(engine.pool, label="salvage", rounds=0)


# ======================================================= drain/submit race
def test_submit_after_drain_rejected(models, quiescence_check):
    engine = _engine(models, max_threads=8, n_shards=2)
    runtime = ServeRuntime(engine, n_workers=2,
                           max_steps_per_worker=1_000_000)
    runtime.start()
    req = runtime.submit([5, 2, 8], 4)  # before the drain: served by it
    stats = runtime.drain(deadline_s=30.0)
    assert req.done and req.state == "done"
    assert stats["unreclaimed"] == 0
    assert stats["cancelled_at_deadline"] == 0
    with pytest.raises(RuntimeError, match="draining"):
        runtime.submit([1, 2, 3], 4)
    with pytest.raises(RuntimeError, match="already drained"):
        runtime.drain()
    quiescence_check(engine.pool, label="drain-race", rounds=0)


def test_submit_during_drain_rejected_and_deadline_cancels(models):
    """A submit racing a drain lands before the gate or raises — never
    strands; the deadline cancels stragglers through the era path."""
    engine = _engine(models, max_threads=8)
    runtime = ServeRuntime(engine, n_workers=2,
                           max_steps_per_worker=1_000_000)
    runtime.start()
    slow = runtime.submit([4, 4, 4], 500)  # far beyond the drain deadline
    results = {}

    def drainer():
        results["stats"] = runtime.drain(deadline_s=0.3)

    th = threading.Thread(target=drainer)
    th.start()
    outcomes = []
    for _ in range(50):
        try:
            outcomes.append(runtime.submit([1, 2], 2))
        except RuntimeError:
            outcomes.append(None)
            break
    th.join(timeout=60.0)
    assert not th.is_alive(), "drain wedged"
    stats = results["stats"]
    assert outcomes and outcomes[-1] is None, \
        "submit never observed the drain gate"
    assert slow.state == "cancelled", slow.state
    assert stats["cancelled_at_deadline"] >= 1
    assert stats["unreclaimed"] == 0
    for r in outcomes[:-1]:
        assert r is not None and r.state in ("done", "cancelled")


# ===================================================== HTTP front-end e2e
@pytest.mark.parametrize("shards", (1, 2))
def test_http_frontend_stream_cancel_drain(models, shards):
    """Over sockets: an SSE stream to completion with ``repro``'s tokens, a
    DELETE mid-stream, a disconnect mid-stream, unknown routes, /healthz,
    and a rolling drain with unreclaimed == 0."""
    want = _ref_tokens(models, [[7, 3, 9, 1]], 5)[0]
    engine = _engine(models, max_threads=8, n_shards=shards)
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
        toks = [d for e, d in events if e == "token"]
        assert [t["index"] for t in toks] == list(range(5)), events
        assert [t["token"] for t in toks] == want
        assert next(d for e, d in events if e == "done")["state"] == "done"
        # DELETE mid-stream
        status, reader, writer = await frontend_mod._post_generate(
            port, {"prompt": [2, 8, 5], "max_new_tokens": 64})
        events = await frontend_mod._read_sse(reader, until_tokens=1)
        rid = next(d["id"] for e, d in events if e == "start")
        status, body = await frontend_mod._http_json(
            port, "DELETE", f"/v1/requests/{rid}")
        assert "200" in status and body["cancelled"], (status, body)
        tail = await frontend_mod._read_sse(reader)
        writer.close()
        fin = next(d for e, d in tail if e == "done")
        assert fin["state"] == "cancelled", tail
        # disconnect mid-stream: the edge cancels the request
        status, reader, writer = await frontend_mod._post_generate(
            port, {"prompt": "disconnect", "max_new_tokens": 64})
        events = await frontend_mod._read_sse(reader, until_tokens=2)
        writer.close()
        status, _ = await frontend_mod._http_json(
            port, "DELETE", "/v1/requests/99999")
        assert "404" in status, status
        status, _ = await frontend_mod._http_json(port, "GET", "/nowhere")
        assert "404" in status, status
        for _ in range(600):
            status, health = await frontend_mod._http_json(
                port, "GET", "/healthz")
            if health["active"] == 0 and health["pending"] == 0:
                break
            await asyncio.sleep(0.05)
        assert "200" in status and health["draining"] is False
        assert health["n_blocks"] == 48 and len(health["workers"]) == 2
        return await frontend.shutdown(deadline_s=15.0)

    stats = asyncio.run(scenario())
    assert stats["unreclaimed"] == 0
    assert stats["completed"] >= 1 and stats["cancelled"] >= 2
    assert json.dumps(stats["cancelled"])


def test_frontend_backpressure_and_drain_reject(models):
    """429 + Retry-After past max_pending; the runtime gate after drain."""
    engine = _engine(models, max_threads=8)
    runtime = ServeRuntime(engine, n_workers=2,
                           max_steps_per_worker=1_000_000)
    frontend = Frontend(runtime, host="127.0.0.1", port=0, max_pending=0)

    async def scenario():
        port = await frontend.start()
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        payload = json.dumps({"prompt": [1, 2, 3],
                              "max_new_tokens": 4}).encode()
        writer.write((f"POST /v1/generate HTTP/1.1\r\nHost: l\r\n"
                      f"Content-Length: {len(payload)}\r\n\r\n").encode()
                     + payload)
        await writer.drain()
        status = (await reader.readline()).decode()
        headers = {}
        while True:
            line = (await reader.readline()).decode()
            if not line.strip():
                break
            k, _, v = line.partition(":")
            headers[k.strip().lower()] = v.strip()
        writer.close()
        assert "429" in status, status
        assert headers.get("retry-after") == "1", headers
        stats = await frontend.shutdown(deadline_s=5.0)
        with pytest.raises(RuntimeError, match="draining"):
            runtime.submit([1], 1)
        return stats

    assert asyncio.run(scenario())["unreclaimed"] == 0


# ======================================================= entry points
def test_frontend_selftest_on_cpu(capsys):
    """The front end's own smoke, sharded, on the CPU when asked."""
    assert frontend_mod.main(["--selftest", "--device", "cpu", "--shards",
                              "2", "--workers", "2"]) == 0
    assert "selftest: PASS" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    ["--requests", "6", "--new-tokens", "4"],
    ["--requests", "8", "--shards", "2", "--workers", "2"],
    ["--requests", "6", "--shards", "2", "--workers", "2", "--fault-spec",
     "crash_at=before_tick:1|after_dispatch:2"],
    ["--requests", "4", "--kv-dtype", "int8", "--force-slow-path"],
])
def test_cli_serves_on_cpu(argv, capsys):
    assert launch_serve.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    n = int(argv[1])
    assert f"completed={n}" in out, out
    if "--fault-spec" in argv:
        assert "chaos: crashes=2 respawns=2" in out, out


def test_cli_matches_reference_cli(capsys):
    """The same flags give the same completions and token counts as the
    reference's CLI (weights differ: both are random and seeded)."""
    from repro.launch import serve as ref_launch_serve

    argv = ["--requests", "5", "--new-tokens", "3", "--shards", "2"]
    assert ref_launch_serve.main(argv) == 0
    want = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("scheme=")][0]
    assert launch_serve.main(argv + ["--device", "cpu"]) == 0
    got = [ln for ln in capsys.readouterr().out.splitlines()
           if ln.startswith("scheme=")][0]
    assert got.split(" (")[0] == want.split(" (")[0]


def test_entry_points_default_to_cuda():
    """Without a device the front end's runtime and the CLI run on CUDA,
    and raise where there is none rather than carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default would succeed")
    with pytest.raises(RuntimeError, match="CUDA"):
        frontend_mod.main(["--selftest", "--shards", "2", "--workers", "2"])
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_serve.main(["--requests", "2", "--shards", "2"])
    with pytest.raises(SystemExit):
        launch_serve.main(["--arch", "mixtral-8x7b"])
