"""Serving engine: continuous batching + WFE block pool + paged steps.

Ported from ``repro.serve.engine`` for one shard on one CUDA stream:

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
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.blocks import BlockPool, PrefixCache, Scheduler
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
                 max_inflight: int = 4,
                 pad_shapes: bool = True, chunk_size: int = 16,
                 token_budget: Optional[int] = None,
                 sched_policy: str = "mixed",
                 bucket_policy: str = "maxlen",
                 prefix_caching: bool = True,
                 prefix_cache_entries: Optional[int] = None,
                 kv_dtype: Optional[str] = None,
                 device=None,
                 **smr_kwargs):
        if n_shards > 1:
            raise NotImplementedError("sharded pools are not ported yet")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.kv_dtype = kv_dtype
        self.params = params
        self.block_size = block_size
        # width policy, as in the reference:
        #   "maxlen" (default) — pow2 of the batch's FINAL table width,
        #     known at admission (prompt + max_new_tokens), ratcheted by a
        #     high-water mark so the width never narrows;
        #   "pow2" — the ladder over the CURRENT width.
        if bucket_policy not in ("maxlen", "pow2"):
            raise ValueError(f"bucket_policy {bucket_policy!r}: "
                             "expected 'maxlen' or 'pow2'")
        self.bucket_policy = bucket_policy
        self._width_hwm = 0
        self.pad_shapes = pad_shapes
        self.max_batch = max_batch
        self.pool = BlockPool(n_blocks, scheme=scheme, max_threads=max_threads,
                              cleanup_backend=cleanup_backend,
                              use_kernel=use_kernel, **smr_kwargs)
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
        self.n_blocks = n_blocks
        # one extra scratch slot absorbs the KV writes of batch-padding rows
        # — it is never handed out by the block pool, so padded steps can't
        # corrupt a live request's pages
        pad = 1 if pad_shapes else 0
        self.pools = init_pools(cfg, n_blocks + pad, block_size,
                                kv_dtype=kv_dtype, device=self.device)
        # serializes the in-place pool writes of concurrent dispatchers;
        # the wait on the sampled ids happens outside it
        self._device_lock = threading.Lock()
        self._shapes: Set[Tuple] = set()

    def compile_cache_size(self) -> int:
        """Distinct padded step shapes dispatched so far: the reference's
        compile count, kept observable for the bucket policy."""
        return len(self._shapes)

    def submit(self, prompt: List[int], max_new_tokens: int,
               slo: str = "interactive", on_token=None, on_finish=None):
        return self.sched.submit(prompt, max_new_tokens, slo=slo,
                                 on_token=on_token, on_finish=on_finish)

    def step(self, tid: int) -> bool:
        """One scheduler tick + device step.  Returns False when idle."""
        plan = self.sched.tick(tid)
        if plan is None:
            return False
        self.execute_plan(plan, tid)
        return True

    def execute_plan(self, plan, tid: int) -> np.ndarray:
        """Dispatch one typed plan to the device and account the result.

        Era safety under asynchronous launch: the step writes the pools in
        place and its kernels are still queued when the dispatch returns.
        ``complete()`` releases the step's era reservation and retires
        finished requests' pages, after which a cleanup may free a page and
        the next tick may reallocate and overwrite it.  So the sampled ids
        are brought to the host (a synchronising ``.cpu()``) BEFORE
        ``complete()``: every kernel of this step has then finished reading
        the pages the reservation protects, and in int8 mode their scale
        slots too, which are read only through the same table snapshot.
        """
        if plan.kind == "prefill":
            sampled = self._dispatch_prefill(plan)
        elif plan.kind == "mixed":
            sampled = self._dispatch_mixed(plan)
        else:
            sampled = self._dispatch_decode(plan)
        sampled = sampled.cpu().numpy()  # the step is done past this line
        self.sched.complete(plan, sampled, tid)
        return sampled

    def _bucket_width(self, plan, nblk: int) -> int:
        """Padded table width for a plan (see ``bucket_policy``)."""
        if self.bucket_policy != "maxlen":
            return 1 << max(0, nblk - 1).bit_length()
        final = max(-(-(len(r.prompt) + r.max_new_tokens)
                      // self.block_size) for r in plan.requests)
        nblk = max(nblk, min(final, self.n_blocks))
        w = 1 << max(0, nblk - 1).bit_length()
        if plan.kind in ("decode", "mixed"):
            # ratchet decode (and mixed) widths: a wide request completing
            # must never shrink the width mid-decode
            w = max(w, self._width_hwm)
            self._width_hwm = w
        return w

    def _bucket_tables(self, plan, rows: int) -> np.ndarray:
        """Pad a plan's table to its width bucket: (rows, W) i32.  Pad rows
        name the scratch slot; dead columns of live rows hold block 0,
        another request's page, which only the per-request
        ``num_live_blocks`` bound keeps the kernel from reading."""
        pad_slot = self.n_blocks
        local = plan.tables.astype(np.int32)
        if not self.pad_shapes:
            return local
        b, nblk = local.shape
        w = self._bucket_width(plan, nblk)
        tables = np.full((rows, w), pad_slot, np.int32)
        tables[:b, :] = 0
        tables[:b, :nblk] = local
        return tables

    def _to_device(self, *arrays) -> List[torch.Tensor]:
        return [torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(
            self.device) for a in arrays]

    def _dispatch_decode(self, plan) -> torch.Tensor:
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
        args = self._to_device(tables, lengths, tokens, positions)
        with self._device_lock:
            logits, _ = paged_decode_step(self.cfg, self.params, self.pools,
                                          *args)
            return torch.argmax(logits, dim=-1)[:b]

    def _dispatch_prefill(self, plan) -> torch.Tensor:
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
        args = self._to_device(tables, tokens, positions, chunk_lens)
        with self._device_lock:
            logits, _ = paged_prefill_chunk(self.cfg, self.params, self.pools,
                                            *args)
            return torch.argmax(logits, dim=-1)[:1]

    def _dispatch_mixed(self, plan) -> torch.Tensor:
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
        args = self._to_device(tables, tokens, positions, chunk_lens)
        with self._device_lock:
            logits, _ = paged_prefill_chunk(self.cfg, self.params, self.pools,
                                            *args)
            return torch.argmax(logits, dim=-1)[:b]

    # ------------------------------------------------------------- drain
    def drain(self, tid: int) -> int:
        """Era-progress-bounded final drain; returns blocks left unreclaimed.

        Each round either frees at least one block or advances the era
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

    # ------------------------------------------------------------- run loop
    def run(self, tid: int, max_steps: int = 10_000) -> Dict[str, int]:
        """Single-threaded serve loop + era-progress-bounded final drain."""
        idle = 0
        for _ in range(max_steps):
            if self.step(tid):
                idle = 0
                continue
            if not self.sched.pending() and not self.sched.active:
                break
            # idle tick: blocks need reclaiming before allocation can
            # proceed; the reference's worker loop drains every 4th idle
            # tick and otherwise waits briefly for work
            idle += 1
            if idle % 4 == 1:
                self.pool.cleanup_all()
            else:
                self.sched.wait_for_work(0.002)
        self.drain(tid)
        return dict(self.sched.stats)
