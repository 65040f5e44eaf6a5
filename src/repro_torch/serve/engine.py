"""Serving engine: continuous batching + SMR block pool + paged steps.

Ported from ``repro.serve.engine``:

  submit() -> scheduler queue -> tick(): admit / allocate blocks (WFE
  alloc_blocks) / protect_step (one era reservation per in-flight step)
  -> device step — a DECODE batch, a PREFILL chunk or a MIXED batch of
  decode rows plus one chunk (``StepPlan.kind``) — reads K/V through the
  protected block tables -> complete(): append tokens, retire finished
  requests' blocks (WFE retire), release the step reservation, cleanup()
  reclaims.

Shape buckets (``bucket_policy``) pad every step to (rows, width) buckets
exactly as the reference does, so a request's steps keep one shape; there
is no compile cache here, and ``compile_cache_size`` counts the distinct
padded step shapes dispatched instead.  Padding is cheap because the
attention kernel is LENGTH-BOUNDED: it walks each request's
``num_live_blocks`` table slots only.

``use_kernel=True`` selects the ``cuda`` era-scan backend for
``cleanup_batch``; attention runs on the CUDA kernel whenever the engine's
device is CUDA, and on its plain version on the CPU.

``kv_dtype`` ("fp32", "fp16", "bf16" or "int8"; None follows the model's
dtype) sets the pages' storage type.  Int8 pages carry per-(block,
kv-head) scales beside the pools, indexed by pool slot like the pages, so
the blocks layer is the same in every mode.

Greedy sampling; the (B,) sampled ids come back to the host each step.

Concurrency: ``step()`` is safe to call from many worker threads (the
``ServeRuntime`` in ``runtime.py`` does exactly that).  Scheduling and
accounting are serialized inside the scheduler.  ``n_shards > 1`` splits
the pool into per-shard SMR instances joined by the distributed era clock
(``blocks/sharded_pool.py``), and each shard gets its own device pool (and
int8 scale pools) and, on the card, its own CUDA stream.  Request-level
sharding makes each plan touch one shard's pages, so a page of shard s is
read and written only on stream s: stream order covers its reuse within
the shard.  A step's whole device work — the copies of its tables, tokens
and positions, the model step, the split-KV scratch, the argmax and the
copy of the sampled ids back to the host — is queued on its shard's
stream under the engine's dispatch lock; the wait for the ids happens
OUTSIDE the lock, so while one worker waits another launches the next
step, and the two shards' streams run on the card at once.  The
reference keeps one lock per shard because its dispatch is one jitted
call; here a step is some thousand eager launches, each of which releases
and retakes the GIL, so two workers launching at once hand the GIL back
and forth at every launch, and one lock for all shards serves twice the
tokens/s of per-shard locks with 2 workers on 2 shards (PERF.md).
Parameters and pools are built before any worker starts and the card is
synchronised once after, so every tensor that crosses streams is
long-lived.

Shutdown runs ``drain()`` — an era-progress-bounded fleet drain that
provably terminates (every round either frees a block or ticks every era
clock, and at quiescence each scheme frees all blocks within a bounded
number of clock ticks).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.blocks import (BlockPool, PrefixCache, Scheduler,
                                ShardedBlockPool)
from repro_torch.models.common import ArchConfig

from .paged_model import init_pools, paged_decode_step, paged_prefill_chunk

__all__ = ["ServeEngine"]

#: era ticks a quiescent drain may need before every scheme must have
#: reclaimed everything: EBR's two grace periods + one for the stamp round,
#: +1 slack.  More stalled rounds than this means a reservation is still
#: held (an in-flight step) — drain returns instead of spinning.
DRAIN_ERA_BOUND = 4


class ServeEngine:
    def __init__(self, cfg: ArchConfig, params, *, n_blocks: int = 64,
                 block_size: int = 8, max_batch: int = 8,
                 scheme: str = "WFE", use_kernel: bool = False,
                 cleanup_backend: str = "numpy",
                 max_threads: int = 8, n_shards: int = 1,
                 max_inflight: int = 4, merge_freq: int = 1,
                 pad_shapes: bool = True, chunk_size: int = 16,
                 token_budget: Optional[int] = None,
                 sched_policy: str = "mixed",
                 bucket_policy: str = "maxlen",
                 prefix_caching: bool = True,
                 prefix_cache_entries: Optional[int] = None,
                 kv_dtype: Optional[str] = None,
                 device=None,
                 **smr_kwargs):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.kv_dtype = kv_dtype
        self.params = params
        self.block_size = block_size
        # width policy, as in the reference:
        #   "maxlen" (default) — pow2 of the batch's FINAL table width,
        #     known at admission (prompt + max_new_tokens), ratcheted by a
        #     per-shard high-water mark so the width never narrows;
        #   "pow2" — the ladder over the CURRENT width.
        if bucket_policy not in ("maxlen", "pow2"):
            raise ValueError(f"bucket_policy {bucket_policy!r}: "
                             "expected 'maxlen' or 'pow2'")
        self.bucket_policy = bucket_policy
        # per-shard width high-water marks, updated outside the dispatch
        # lock: a racing lost update merely lets a narrower shape through
        # once, never an incorrect table
        self._width_hwm = [0] * max(1, n_shards)
        self.pad_shapes = pad_shapes
        self.max_batch = max_batch
        self.n_blocks = n_blocks
        pool_kwargs = dict(scheme=scheme, max_threads=max_threads,
                           cleanup_backend=cleanup_backend,
                           use_kernel=use_kernel, **smr_kwargs)
        if n_shards > 1:
            self.pool = ShardedBlockPool(n_blocks, n_shards=n_shards,
                                         merge_freq=merge_freq, **pool_kwargs)
            self._shard_bases = [p.first_block for p in self.pool.shards]
            self._shard_sizes = [p.n_blocks for p in self.pool.shards]
        else:
            self.pool = BlockPool(n_blocks, **pool_kwargs)
            self._shard_bases = [0]
            self._shard_sizes = [n_blocks]
        # refcounted prefix cache: prompts sharing a block-aligned token
        # prefix alias the same pool pages (see blocks/prefix_cache.py)
        self.prefix_cache = (
            PrefixCache(self.pool, block_size=block_size,
                        max_entries=prefix_cache_entries)
            if prefix_caching else None)
        self.sched = Scheduler(self.pool, block_size=block_size,
                               max_batch=max_batch,
                               max_inflight=max_inflight,
                               chunk_size=chunk_size,
                               token_budget=token_budget,
                               policy=sched_policy,
                               prefix_cache=self.prefix_cache)
        # fault injection (serve/faults.py): None = disabled.  The plans a
        # worker has dispatched-but-not-completed are tracked per tid so a
        # supervisor can requeue them after the worker dies; execute_plan
        # never lets an exception leave with the plan's kernels still
        # queued, so a dead worker holds no device read in flight.
        self.faults = None
        self._inflight_plans: Dict[int, object] = {}
        # one extra scratch slot per shard absorbs the KV writes of
        # batch-padding rows — it is never handed out by the block pool, so
        # padded steps can't corrupt a live request's pages
        pad = 1 if pad_shapes else 0
        self._shard_pools = [init_pools(cfg, size + pad, block_size,
                                        kv_dtype=kv_dtype, device=self.device)
                             for size in self._shard_sizes]
        # one dispatch lock for every shard (see the module docstring):
        # it orders the in-place pool writes; the wait on the sampled ids
        # happens outside it
        self._dispatch_lock = threading.Lock()
        # one CUDA stream per shard (never one per worker): a shard's
        # pages are read and written in that stream's order only
        cuda = self.device.type == "cuda"
        self._streams = [torch.cuda.Stream(device=self.device) if cuda
                         else None for _ in self._shard_sizes]
        if cuda:
            # the parameters and the pools were written on the default
            # stream; the shard streams read them from here on
            torch.cuda.synchronize(self.device)
        self._shapes: Set[Tuple] = set()

    # ------------------------------------------- compile-cache introspection
    def compile_cache_size(self) -> int:
        """Distinct padded step shapes dispatched so far: the reference's
        compile count, kept observable for the bucket policy."""
        return len(self._shapes)

    def clear_compile_caches(self) -> bool:
        """Forget the dispatched step shapes (the port compiles nothing per
        shape; this resets what ``compile_cache_size`` counts)."""
        self._shapes.clear()
        return True

    # single-shard view of the device pools (tests drive the steps with
    # engine.pools directly)
    @property
    def pools(self):
        return self._shard_pools[0]

    @pools.setter
    def pools(self, value):
        self._shard_pools[0] = value

    def submit(self, prompt: List[int], max_new_tokens: int,
               slo: str = "interactive", on_token=None, on_finish=None):
        return self.sched.submit(prompt, max_new_tokens, slo=slo,
                                 on_token=on_token, on_finish=on_finish)

    # ------------------------------------------------------- fault injection
    def set_fault_injector(self, injector) -> None:
        """Install (or remove, with ``None``) a ``FaultInjector``.

        Wires the allocation gate into every shard pool and arms the
        crash/poison hooks in ``step``/``execute_plan``.  Call before
        workers start; the hooks are read once per step without a lock.
        """
        self.faults = injector
        shards = getattr(self.pool, "shards", None) or [self.pool]
        gate = None if injector is None else injector.alloc_gate
        for p in shards:
            p._fault_alloc = gate

    def take_orphaned_plan(self, tid: int):
        """Pop the plan a (dead) worker dispatched but never completed.

        Returns None when the worker died outside the
        reservation-published window.  Supervisor-only: the worker must be
        joined first, so no race with its own pop in ``step``.
        """
        return self._inflight_plans.pop(tid, None)

    def cancel(self, req) -> bool:
        """Abandon a request (client disconnect / DELETE): marks it; the
        scheduler drops it at the next safe point and releases its pages
        through the normal refcount/era path (see ``Scheduler.cancel``).
        Callable from any thread.  Returns True iff this call marked it."""
        return self.sched.cancel(req)

    def step(self, tid: int) -> bool:
        """One scheduler tick + device step.  Returns False when idle.

        Thread-safe: callable concurrently from several workers (each with
        its own registered ``tid``).
        """
        faults = self.faults
        if faults is not None:
            faults.crash_point("before_tick", tid)
        plan = self.sched.tick(tid)
        if plan is None:
            return False
        # track the plan across the reservation-held window: a crash
        # anywhere between here and complete() leaves the entry behind
        # for the supervisor's requeue (take_orphaned_plan)
        self._inflight_plans[tid] = plan
        if faults is not None:
            faults.crash_point("after_reservation", tid)
        self.execute_plan(plan, tid)
        self._inflight_plans.pop(tid, None)
        return True

    def execute_plan(self, plan, tid: int) -> np.ndarray:
        """Dispatch one typed plan to the device and account the result.

        Era safety under asynchronous launch: the step writes the pools in
        place and its kernels are still queued when the launches return.
        ``complete()`` releases the step's era reservation and retires
        finished requests' pages, after which a cleanup may free a page and
        the next tick may reallocate and overwrite it.  So the sampled ids
        reach the host (a wait on the shard stream's event) BEFORE
        ``complete()``: every kernel of this step has then finished reading
        the pages the reservation protects, and in int8 mode their scale
        slots too, which are read only through the same table snapshot.
        An exception raised between the launches and that wait first
        synchronizes the shard's stream: a supervisor reaps a dead
        worker's reservation once its thread is joined, which is safe only
        if no read of the pages it protected is still queued.
        """
        try:
            if plan.kind == "prefill":
                sampled = self._dispatch_prefill(plan)
            elif plan.kind == "mixed":
                sampled = self._dispatch_mixed(plan)
            else:
                sampled = self._dispatch_decode(plan)
        except BaseException:
            stream = self._streams[plan.shard]
            if stream is not None:
                stream.synchronize()
            raise
        faults = self.faults
        if faults is not None:
            row = faults.poison_row(len(plan.requests))
            if row is not None:
                poisoned = np.asarray(sampled, dtype=np.float64).copy()
                poisoned[row] = np.nan
                sampled = poisoned
            faults.crash_point("after_dispatch", tid)
        failed_rows = None
        arr = np.asarray(sampled)
        if not np.issubdtype(arr.dtype, np.integer):
            # graceful degradation: a non-finite sampled output (device
            # fault, poisoned logits) fails THAT request, not the batch —
            # surviving rows keep their (finite) tokens
            finite = np.isfinite(arr)
            if not finite.all():
                failed_rows = [not bool(f) for f in finite]
            sampled = np.where(finite, arr, 0).astype(np.int32)
        self.sched.complete(plan, sampled, tid, failed_rows=failed_rows)
        return sampled

    def _bucket_width(self, plan, nblk: int, shard: int) -> int:
        """Padded table width for a plan (see ``bucket_policy``)."""
        if self.bucket_policy != "maxlen":
            return 1 << max(0, nblk - 1).bit_length()
        final = max(-(-(len(r.prompt) + r.max_new_tokens)
                      // self.block_size) for r in plan.requests)
        nblk = max(nblk, min(final, self._shard_sizes[shard]))
        w = 1 << max(0, nblk - 1).bit_length()
        if plan.kind in ("decode", "mixed"):
            # ratchet decode (and mixed) widths: a wide request completing
            # must never shrink the width mid-decode
            w = max(w, self._width_hwm[shard])
            self._width_hwm[shard] = w
        return w

    def _bucket_tables(self, plan, rows: int) -> np.ndarray:
        """Shard-localize + (optionally) pad a plan's table to its width
        bucket: (rows, W) i32.  The plan names global slots; this shard's
        device pool indexes [0, size + pad).  Pad rows name the shard's
        scratch slot; dead columns of live rows hold local block 0, which
        only the per-request ``num_live_blocks`` bound keeps the kernel
        from reading."""
        s = plan.shard
        pad_slot = self._shard_sizes[s]  # shard-local scratch slot id
        local = np.maximum(plan.tables.astype(np.int32)
                           - self._shard_bases[s], 0)
        if not self.pad_shapes:
            return local
        b, nblk = local.shape
        w = self._bucket_width(plan, nblk, s)
        tables = np.full((rows, w), pad_slot, np.int32)
        tables[:b, :] = 0
        tables[:b, :nblk] = local
        return tables

    def _run_step(self, plan, step, arrays, b: int) -> np.ndarray:
        """Run ``step(cfg, params, pools, *arrays)`` on the plan's shard:
        every copy, launch and the argmax on the shard's stream under the
        dispatch lock, the sampled ids copied into pinned host memory
        behind an event; the wait for that event happens outside the lock.
        Returns the (b,) sampled ids."""
        s = plan.shard
        stream = self._streams[s]
        on_stream = (torch.cuda.stream(stream) if stream is not None
                     else contextlib.nullcontext())
        with self._dispatch_lock, on_stream:
            args = [torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(
                self.device) for a in arrays]
            logits, _ = step(self.cfg, self.params, self._shard_pools[s],
                             *args)
            ids = torch.argmax(logits, dim=-1)[:b]
            if stream is None:
                return ids.numpy()
            host = torch.empty(ids.shape, dtype=ids.dtype, pin_memory=True)
            host.copy_(ids, non_blocking=True)
            # a default (spinning) event: a blocking one measured no faster
            # with 1, 2 or 4 workers (tools/dispatch_lock_ab.py)
            done = torch.cuda.Event()
            done.record(stream)
        # wait OUTSIDE the lock: other workers plan and launch while this
        # one waits (on this shard's stream only, never the default one)
        done.synchronize()
        return host.numpy()

    def _dispatch_decode(self, plan) -> np.ndarray:
        b = plan.tables.shape[0]
        rows = self.max_batch if self.pad_shapes else b
        tables = self._bucket_tables(plan, rows)
        lengths, tokens, positions = (plan.lengths, plan.tokens,
                                      plan.positions)
        if self.pad_shapes:
            lengths = np.ones((rows,), np.int32)  # pad rows: 1 scratch token
            lengths[:b] = plan.lengths
            tokens = np.zeros((rows,), np.int32)
            tokens[:b] = plan.tokens
            positions = np.zeros((rows,), np.int32)
            positions[:b] = plan.positions
        self._shapes.add(("decode", tables.shape))
        return self._run_step(plan, paged_decode_step,
                              (tables, lengths, tokens, positions), b)

    def _dispatch_prefill(self, plan) -> np.ndarray:
        """One prefill chunk (B == 1), its length padded to a pow2 bucket."""
        n = plan.n_tokens
        ctx = int(plan.lengths[0]) - n  # context BEFORE the chunk
        cb = 1 << max(0, n - 1).bit_length() if self.pad_shapes else n
        tables = self._bucket_tables(plan, 1)
        tokens = np.zeros((1, cb), np.int32)
        tokens[0, :n] = plan.tokens
        # pad positions clamp to the last valid one: their (discarded)
        # attention rows stay masked to materialized pages
        positions = (ctx + np.minimum(np.arange(cb), n - 1)
                     ).astype(np.int32)[None, :]
        chunk_lens = np.array([n], np.int32)
        self._shapes.add(("prefill", tables.shape, cb))
        return self._run_step(plan, paged_prefill_chunk,
                              (tables, tokens, positions, chunk_lens), 1)

    def _dispatch_mixed(self, plan) -> np.ndarray:
        """Decode rows + one prefill chunk row in ONE dispatch of the chunked
        step (ragged rows via ``chunk_lens``).  Rows pad to
        ``max_batch + 1``, columns to the pow2 chunk bucket; pad rows write
        their token to the scratch slot; pad columns clamp to each row's
        last valid position."""
        b, c = plan.tokens.shape
        rows = (self.max_batch + 1) if self.pad_shapes else b
        tables = self._bucket_tables(plan, rows)
        cb = 1 << max(0, c - 1).bit_length() if self.pad_shapes else c
        tokens = np.zeros((rows, cb), np.int32)
        tokens[:b, :c] = plan.tokens
        positions = np.zeros((rows, cb), np.int32)
        positions[:b, :c] = plan.positions
        if cb > c:
            positions[:b, c:] = plan.positions[:, c - 1:c]
        chunk_lens = np.ones((rows,), np.int32)  # pad rows: 1 scratch token
        chunk_lens[:b] = plan.chunk_lens
        self._shapes.add(("mixed", tables.shape, cb))
        return self._run_step(plan, paged_prefill_chunk,
                              (tables, tokens, positions, chunk_lens), b)

    # ------------------------------------------------------------- drain
    def drain(self, tid: int) -> int:
        """Era-progress-bounded final drain; returns blocks left unreclaimed.

        Each round either frees at least one block or advances every era
        clock; at quiescence every block is reclaimed within
        DRAIN_ERA_BOUND ticks, so a nonzero return means a reservation is
        genuinely still held.
        """
        pool = self.pool
        if self.prefix_cache is not None:
            # the cache's sharer references would otherwise pin cached
            # pool slots past shutdown
            self.prefix_cache.clear(tid)
        stalled = 0
        while pool.unreclaimed() > 0:
            freed = pool.cleanup_all()
            freed += pool.cleanup(tid)
            if freed > 0:
                stalled = 0
                continue
            if stalled >= DRAIN_ERA_BOUND:
                break  # pinned by a live reservation; caller still holds it
            pool.advance_eras(tid)
            stalled += 1
        return pool.unreclaimed()

    # ------------------------------------------------------------- run loops
    def run_worker(self, tid: int, max_steps: int = 10_000,
                   stop: Optional[threading.Event] = None,
                   exit_when_idle: bool = True,
                   on_first_step=None) -> int:
        """Worker loop: step until the queue AND active set are empty.

        Used by every ``ServeRuntime`` worker thread; does NOT run the
        final drain (the runtime drains once after all workers join).
        ``stop`` aborts promptly (a sibling worker died — its in-flight
        requests would otherwise stall this loop until ``max_steps``).
        ``exit_when_idle=False`` is the PERSISTENT mode for the serving
        front-end: an empty queue parks the worker on the scheduler's
        condition instead of exiting — new submissions (and cancellations)
        wake it — until ``stop`` is set by the runtime's rolling drain.
        ``on_first_step`` fires once, after the first PRODUCTIVE step —
        the supervisor stamps recovery latency with it.
        Returns the number of productive steps taken.
        """
        steps = 0
        productive = 0
        idle = 0
        while steps < max_steps and (stop is None or not stop.is_set()):
            # persistent workers bound PRODUCTIVE steps only: a long-lived
            # server parks through arbitrarily many idle wakeups without
            # burning down its runaway backstop
            steps = steps + 1 if exit_when_idle else productive
            if self.step(tid):
                productive += 1
                if productive == 1 and on_first_step is not None:
                    on_first_step()
                idle = 0
                continue
            if exit_when_idle and not self.sched.pending() \
                    and not self.sched.active:
                break
            # idle tick: another worker's steps are in flight, or blocks
            # need reclaiming before allocation can proceed.  The fused
            # cross-thread drain reclaims blocks retired by workers that
            # are stalled or done ticking.  Back off while idle — a hot
            # spin here starves the working threads of the GIL.
            idle += 1
            if idle % 4 == 1:
                self.pool.cleanup_all()
            else:
                self.sched.wait_for_work(0.002)
        return productive

    def run(self, tid: int, max_steps: int = 10_000) -> Dict[str, int]:
        """Single-threaded serve loop + era-progress-bounded final drain."""
        self.run_worker(tid, max_steps)
        self.drain(tid)
        return dict(self.sched.stats)
