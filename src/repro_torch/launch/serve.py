"""Serving CLI: run the continuous-batching engine on a reduced config,
on the CUDA device (``--device cpu`` runs the plain PyTorch path on the
CPU).  Ported from ``repro.launch.serve``; weights are random, seeded.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-3b \
      --requests 16 --new-tokens 12 --scheme WFE

Sharded multi-worker runtime (one SMR instance, device pool and CUDA stream
per shard, era clocks max-merged on step boundaries; K worker threads
pipelining device steps):

  PYTHONPATH=src python -m repro_torch.launch.serve --shards 4 --workers 4

Chunked prefill (a P-token prompt costs ceil(P/C) device steps; reports
TTFT/TPOT — see the reference's docs/benchmarks.md for definitions):

  PYTHONPATH=src python -m repro_torch.launch.serve --chunk-size 32

Mixed-batch token-budget planning with SLO classes (decode rows fund
first each tick; batch-class requests admit after — and shed before —
interactive ones; see the reference's docs/serving.md §Scheduling
policy):

  PYTHONPATH=src python -m repro_torch.launch.serve --slo mix \
      --token-budget 24
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --sched-policy prefill_first

Streaming HTTP mode (asyncio SSE front-end with era-safe mid-flight
cancellation; Ctrl-C runs the rolling drain — see the reference's
docs/frontend.md):

  PYTHONPATH=src python -m repro_torch.launch.serve --http --port 8000 \
      --workers 2
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import ALL_ARCHS, get_smoke_config
from repro_torch.models import init_params
from repro_torch.serve import ServeEngine, ServeRuntime


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ALL_ARCHS, default="stablelm-3b")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=12)
    ap.add_argument("--scheme", default="WFE",
                    choices=("WFE", "Crystalline", "HE", "HP", "EBR",
                             "2GEIBR"))
    ap.add_argument("--n-blocks", type=int, default=64)
    ap.add_argument("--block-size", type=int, default=4)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--force-slow-path", action="store_true",
                    help="WFE max_attempts=1 (paper §5 stress)")
    ap.add_argument("--shards", type=int, default=1,
                    help="pool shards, each with its own SMR instance "
                         "joined by the distributed era clock")
    ap.add_argument("--workers", type=int, default=1,
                    help="serve worker threads (pipelined device steps)")
    ap.add_argument("--merge-freq", type=int, default=1,
                    help="steps between shard era-clock max-merges")
    ap.add_argument("--chunk-size", type=int, default=16,
                    help="prefill chunk token budget: a P-token prompt "
                         "materializes in ceil(P/C) device steps (1 = "
                         "token-at-a-time)")
    ap.add_argument("--bucket-policy", default="maxlen",
                    choices=("maxlen", "pow2"),
                    help="table-width shape buckets: 'maxlen' pads to the "
                         "batch's final width (known at admission; one "
                         "compile per request lifetime, dead slots skipped "
                         "by the length-bounded kernel), 'pow2' is the "
                         "legacy current-width ladder")
    ap.add_argument("--sched-policy", default="mixed",
                    choices=("mixed", "prefill_first"),
                    help="'mixed' = token-budget planner (decode rows "
                         "first, remainder funds one prefill chunk, one "
                         "dispatch); 'prefill_first' = legacy TTFT-first "
                         "planner (decode starves under sustained prompt "
                         "arrival — kept for A/B)")
    ap.add_argument("--token-budget", type=int, default=None,
                    help="tokens per mixed tick (default: max_batch + "
                         "chunk_size — a full decode batch plus a full "
                         "prefill chunk)")
    ap.add_argument("--slo", default="interactive",
                    choices=("interactive", "batch", "mix"),
                    help="SLO class for submitted requests ('mix' tags "
                         "every other request batch-class: batch admits "
                         "after — and sheds before — interactive)")
    ap.add_argument("--kv-dtype", default=None, choices=("fp32", "int8"),
                    help="KV pool storage: 'int8' stores pages as "
                         "symmetric per-(block, kv-head) codes with fp32 "
                         "scales and dequantizes inside the attention "
                         "kernel — half the K/V bytes per decode step, "
                         "~2x the blocks at fixed pool memory (default: "
                         "the arch dtype)")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="disable the refcounted prefix cache (prompts "
                         "sharing a block-aligned prefix alias the same "
                         "pool pages; cached chunks cost zero prefill "
                         "dispatches)")
    ap.add_argument("--http", action="store_true",
                    help="serve over HTTP instead of running the synthetic "
                         "batch: boots the asyncio SSE front-end "
                         "(repro_torch.serve.frontend) on --port with "
                         "--workers persistent worker threads; Ctrl-C runs "
                         "the rolling drain")
    ap.add_argument("--port", type=int, default=8000,
                    help="HTTP port for --http (0 = ephemeral)")
    ap.add_argument("--host", default="127.0.0.1",
                    help="HTTP bind address for --http")
    ap.add_argument("--fault-spec", default=None,
                    help="arm deterministic fault injection (chaos mode), "
                         "e.g. 'seed=0,crash_rate=0.01,max_crashes=3' or "
                         "'crash_at=before_tick:5|after_dispatch:3' — see "
                         "serve/faults.py FaultSpec.parse")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on ('cpu' runs the plain "
                         "PyTorch path)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch)
    if cfg.use_mla or cfg.is_encoder_decoder or any(
            k != "attn" for k in cfg.block_pattern):
        raise SystemExit(f"{args.arch}: the paged engine serves dense "
                         "full-attention GQA archs")
    dev = resolve_device(args.device)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    smr_kwargs = {"era_freq": 4, "cleanup_freq": 4}
    if args.force_slow_path and args.scheme == "WFE":
        smr_kwargs["max_attempts"] = 1
    engine = ServeEngine(cfg, params, n_blocks=args.n_blocks,
                         block_size=args.block_size,
                         max_batch=args.max_batch, scheme=args.scheme,
                         n_shards=args.shards, merge_freq=args.merge_freq,
                         # chaos mode: every respawned worker burns a fresh
                         # tid, so armed faults need real registry headroom
                         max_threads=max(16 if args.fault_spec else 8,
                                         args.workers + 2),
                         max_inflight=max(4, args.workers),
                         chunk_size=args.chunk_size,
                         token_budget=args.token_budget,
                         sched_policy=args.sched_policy,
                         bucket_policy=args.bucket_policy,
                         prefix_caching=not args.no_prefix_cache,
                         kv_dtype=args.kv_dtype, device=dev,
                         **smr_kwargs)
    if args.fault_spec:
        from repro_torch.serve.faults import FaultInjector, FaultSpec
        engine.set_fault_injector(FaultInjector(FaultSpec.parse(
            args.fault_spec)))
        print(f"fault injection armed: {args.fault_spec}")
    if args.http:
        import asyncio

        from repro_torch.serve import Frontend

        runtime = ServeRuntime(engine, n_workers=max(2, args.workers),
                               max_steps_per_worker=1_000_000)

        async def _serve():
            frontend = Frontend(runtime, host=args.host, port=args.port)
            port = await frontend.start()
            print(f"serving on http://{args.host}:{port} "
                  f"(scheme={args.scheme}, shards={args.shards}, "
                  f"{runtime.n_workers} workers; POST /v1/generate "
                  f"streams SSE; Ctrl-C = rolling drain)")
            try:
                await frontend.serve_forever()
            except (KeyboardInterrupt, asyncio.CancelledError):
                pass
            finally:
                stats = await frontend.shutdown(deadline_s=10.0)
                print(f"drained: unreclaimed={stats['unreclaimed']} "
                      f"completed={stats['completed']} "
                      f"cancelled={stats['cancelled']}")
                assert stats["unreclaimed"] == 0, stats

        try:
            asyncio.run(_serve())
        except KeyboardInterrupt:
            pass
        return 0
    if args.kv_dtype == "int8":
        print("kv_dtype=int8: pool pages are symmetric int8 codes + "
              "per-(block, kv-head) fp32 scales (fused in-kernel dequant)")
    elif args.kv_dtype:
        print(f"kv_dtype={args.kv_dtype}")
    reqs = []
    for i in range(args.requests):
        prompt = [(3 * i + j) % cfg.vocab_size for j in range(1 + i % 6)]
        slo = ("batch" if i % 2 else "interactive") \
            if args.slo == "mix" else args.slo
        reqs.append(engine.submit(prompt, args.new_tokens, slo=slo))
    t0 = time.time()
    if args.workers > 1 or args.fault_spec:
        # chaos mode always runs under the runtime: only the supervisor
        # can reap/requeue/respawn a crashed worker (engine.run would die
        # with the first injected crash)
        runtime = ServeRuntime(engine, n_workers=args.workers)
        stats = runtime.serve()
        if args.fault_spec:
            lat = sorted(runtime.recovery_latencies)
            p50 = 1e3 * lat[len(lat) // 2] if lat else None
            print(f"chaos: crashes={len(runtime.crashed_tids)} "
                  f"respawns={runtime.n_respawns} recovery p50 "
                  f"{'-' if p50 is None else f'{p50:.1f} ms'} "
                  f"failed={stats.get('failed', 0)} "
                  f"requeues={stats.get('crash_requeues', 0)}")
    else:
        tid = engine.pool.register_thread()
        stats = engine.run(tid)
    dt = time.time() - t0
    toks = stats["completed"] * args.new_tokens
    print(f"scheme={args.scheme} shards={args.shards} workers={args.workers} "
          f"chunk={args.chunk_size} completed={stats['completed']} "
          f"tokens={toks} ({toks/dt:.1f} tok/s)")
    ttfts = sorted(r.ttft for r in reqs if r.ttft is not None)
    tpots = sorted(r.tpot for r in reqs if r.tpot is not None)
    if ttfts:
        print(f"TTFT p50 {1e3 * ttfts[len(ttfts) // 2]:.1f} ms"
              + (f" | TPOT p50 {1e3 * tpots[len(tpots) // 2]:.2f} ms"
                 if tpots else ""))
    if stats.get("prefix_lookups"):
        total = sum(len(r.prompt) for r in reqs)
        print(f"prefix cache: {stats['prefix_hits']}/"
              f"{stats['prefix_lookups']} hits, "
              f"{stats['prefix_hit_tokens']} cached tokens "
              f"(hit-rate {stats['prefix_hit_tokens'] / total:.2f} "
              f"of {total} prompt tokens)")
    print("scheduler:", stats)
    print("pool:", engine.pool.stats())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
