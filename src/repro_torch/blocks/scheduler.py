"""Wait-free continuous-batching scheduler over the WFE block pool.

The serving control plane (vLLM-style), with the paper's progress guarantee
where it matters: admission, block allocation, retirement and step
protection are all wait-free-bounded WFE operations, so

* a stalled completion thread cannot block admission (no lock couples them);
* eviction under pool pressure has bounded latency (``retire`` is
  wait-free) — the deadline-based planning cutoff below is therefore a real
  bound, not best-effort;
* in-flight device steps (dispatched asynchronously, possibly several deep)
  keep their block-table snapshots readable until completion via one era
  reservation per step (``protect_step``).

Mixed-batch token-budget planning (the decode-starvation fix): each
``tick`` gets ``token_budget`` tokens and fills them DECODE-FIRST — one
token per decode-phase request (decode progress is the starvation victim
under sustained prompt arrival), then the remainder goes to ONE prefill
chunk of the oldest prefill-phase request.  Both ride in a single
``StepPlan(kind="mixed")`` device dispatch: the plan lays them out as C
ragged tokens with per-row positions, decode rows simply rows with
``chunk_lens == 1``, and the engine packs them onto one token axis
(``paged_mixed_step``).  A tick with only one kind of work
degenerates to a pure ``decode`` or ``prefill`` plan.  The era discipline
is unchanged and is exactly what makes the mixed batch cheap: ONE interval
reservation per step protects every page the batch touches — decode rows
AND the chunk (the paper's amortize-protection-over-many-accesses
argument; cf. DEBRA / Crystalline, which budget reclamation work per
operation the same way this planner budgets scheduling work per tick).
The legacy TTFT-first planner (prefill strictly before decode) is kept as
``policy="prefill_first"`` for A/B measurement — the starvation reproducer
in tests/test_scheduler_slo.py fails against it by construction.

SLO classes and admission control: ``submit`` takes ``slo="interactive"``
or ``"batch"``.  Admission drains each shard's interactive intake queue
first (batch requests are DEFERRED behind any interactive backlog), and
``max_batch`` is a HARD active-set cap per shard.  Under pool pressure the
shedding ladder runs: (1) drop an LRU prefix-cache entry (free — redo no
work), (2) preempt the newest batch-class request, regardless of admission
order (batch can never preempt interactive back, so no ping-pong
livelock), (3) same-class LIFO preemption bounded to requests admitted
AFTER the requester (the eviction livelock fix).  An evicted request rejoins
its intake queue at the HEAD (``appendleft``): its TTFT is still clocked
from the original submit, so falling behind brand-new arrivals would
balloon it unfairly.

Multi-worker discipline (the sharded serving runtime): several worker
threads drive ``tick``/``complete`` concurrently.  Scheduling state (the
active list, in-flight slots, request bookkeeping) is guarded by one
scheduler lock held only across the *planning* and *accounting* phases —
the device step itself runs outside it, so worker A can execute its step
while worker B plans the next one (pipelining).  A request is stepped by at
most one worker at a time (``Request.inflight``); eviction never targets a
request whose step is in flight.  Stats are kept per worker — each worker
increments only its own dict (single-writer, no lock, no lost updates) —
and merged at aggregation time by the ``stats`` property.

Spans (``repro_torch.obs``): ``sched.tick`` and ``sched.complete``, under
which ``table.release`` (a finished request's pages), ``prefix.insert`` and
the pool's ``pool.cleanup``.  Each request is stamped at its first admission
(``t_admit``) and its first prefill chunk planned (``t_prefill``).
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch import obs

from .block_pool import PoolExhausted
from .block_table import BlockTableRef

__all__ = ["Request", "StepPlan", "Scheduler", "SLO_CLASSES"]

#: every per-worker stats dict carries these keys (merged by ``stats``)
STAT_KEYS = ("admitted", "completed", "evictions", "batch_evictions",
             "steps", "mixed_steps", "deadline_cutoffs", "reclaimed",
             "prefill_chunks", "prefill_tokens", "prefix_lookups",
             "prefix_hits", "prefix_hit_tokens", "prefix_evictions",
             "cancelled", "cancelled_tokens", "cancelled_blocks",
             "failed", "failed_tokens",
             "crash_requeues", "crash_wasted_tokens",
             "tokens_live", "tokens_computed",
             "decode_dispatches", "decode_ns", "mixed_dispatches", "mixed_ns",
             "prefill_dispatches", "prefill_ns")

#: pseudo worker id for stats written by non-worker threads (the serving
#: edge calling ``cancel``); writes happen under the scheduler lock, so
#: the single-writer discipline relaxes safely for this one dict
EDGE_TID = -1

#: per-request SLO classes: ``interactive`` requests are admitted first and
#: never preempted on behalf of ``batch`` requests; ``batch`` requests are
#: deferred behind any interactive backlog and shed first under pressure
SLO_CLASSES = ("interactive", "batch")


@dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int
    generated: List[int] = field(default_factory=list)
    table: Optional[BlockTableRef] = None
    length: int = 0  # prefill cursor: tokens materialized in the cache
    state: str = "queued"  # queued | active | done | evicted | cancelled
    #                      # | failed (non-finite sampled output: terminal)
    evictions: int = 0
    inflight: bool = False  # a device step for this request is outstanding
    shard: int = 0  # pool/device shard this request's pages live in
    slo: str = "interactive"  # SLO class: "interactive" | "batch"
    # cancellation (client disconnect / DELETE): ``cancel`` sets the flag;
    # the scheduler finalizes at the next safe point — immediately for a
    # queued request, the next planning tick for an active one, and for an
    # IN-FLIGHT one only after its dispatched step completes and releases
    # its era reservation (blocks then flow through the normal
    # refcount/era release path — never a force-retire)
    cancelled: bool = False
    t_cancel: Optional[float] = None  # when cancel() marked the flag
    t_released: Optional[float] = None  # when the blocks were released
    # graceful degradation: a non-finite sampled output marks
    # the ROW's request ``failing`` during complete(); finalization to the
    # terminal "failed" state runs after release_step, exactly like a
    # cancelled in-flight row (the generated-so-far KV may be poisoned,
    # so — unlike cancellation — nothing is salvaged into the prefix cache)
    failing: bool = False
    # streaming hooks (the serving front-end): both run UNDER the
    # scheduler lock on a worker thread, so they must be O(1) handoffs
    # (e.g. loop.call_soon_threadsafe into an asyncio queue).  on_token
    # receives (request, token index, token id); an evicted request
    # replays its tokens from index 0 on the re-run (greedy decode is
    # deterministic), so consumers dedupe by index.  on_finish fires
    # exactly once, when state becomes "done", "cancelled" or "failed".
    on_token: Optional[Callable[["Request", int, int], None]] = None
    on_finish: Optional[Callable[["Request"], None]] = None
    # one prefix-cache lookup per admission: a pressure-starved request
    # must not re-walk the deepest-match keys every tick (reset on
    # eviction rewind — the re-run is cache-eligible again)
    prefix_checked: bool = False
    # latency stamps (time.monotonic): TTFT = t_first - t_submit,
    # TPOT = (t_last - t_first) / (len(generated) - 1); max_gap is the
    # WORST inter-token gap — the starvation symptom TPOT means hide.
    # t_admit (first entry into the active set) and t_prefill (first
    # prefill chunk planned) split TTFT into queue wait, wait for a chunk
    # and the rest; an evicted request keeps both
    t_submit: float = 0.0
    t_admit: Optional[float] = None
    t_prefill: Optional[float] = None
    t_first: Optional[float] = None
    t_last: Optional[float] = None
    max_gap: float = 0.0

    @property
    def phase(self) -> str:
        """``prefill`` while prompt tokens remain unmaterialized (the
        cursor is ``length``; eviction resets it to 0), else ``decode``."""
        return "prefill" if self.length < len(self.prompt) else "decode"

    @property
    def prompt_remaining(self) -> int:
        return max(0, len(self.prompt) - self.length)

    @property
    def next_token(self) -> int:
        """Token to feed at the next decode step (last generated; falls
        back to the prompt cursor mid-prefill)."""
        if self.length < len(self.prompt):
            return self.prompt[self.length]
        return self.generated[-1]

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new_tokens

    @property
    def ttft(self) -> Optional[float]:
        if self.t_first is None:
            return None
        return self.t_first - self.t_submit

    @property
    def tpot(self) -> Optional[float]:
        if self.t_last is None or self.t_first is None \
                or len(self.generated) < 2:
            return None
        return (self.t_last - self.t_first) / (len(self.generated) - 1)

    @property
    def cancel_latency(self) -> Optional[float]:
        """cancel() -> blocks released (the reclamation-visible latency:
        how long an abandoned request kept its pages referenced)."""
        if self.t_cancel is None or self.t_released is None:
            return None
        return self.t_released - self.t_cancel


@dataclass
class StepPlan:
    """Immutable snapshot handed to the device step.

    ``kind == "decode"``: one token per request — tokens/positions/lengths
    are (B,), tables (B, nblk).  ``kind == "prefill"``: a chunk of
    ``n_tokens`` prompt tokens of ONE request — tokens/positions are
    (n_tokens,), tables (1, nblk), lengths (1,) = context INCLUDING the
    chunk.  ``kind == "mixed"``: ``n_decode`` decode rows plus ONE prefill
    chunk row (always last) in a single dispatch — tokens/positions are
    (B, C) with C the chunk length, ``chunk_lens`` (B,) gives each row's
    valid tokens (1 for decode rows), and ``n_tokens`` is the total token
    budget the plan spends.  Either way the plan holds exactly one
    era-reservation slot.
    """

    slot: int  # era-reservation slot guarding this step
    requests: List[Request]
    tokens: np.ndarray  # decode: (B,) i32; prefill: (C,); mixed: (B, C)
    positions: np.ndarray  # decode: (B,) i32; prefill: (C,); mixed: (B, C)
    tables: np.ndarray  # (B, nblk) int32, padded with 0 (global slot ids)
    lengths: np.ndarray  # (B,) i32 — context length INCLUDING this step
    shard: int = 0  # every request in this plan lives in this shard
    kind: str = "decode"  # "decode" | "prefill" | "mixed"
    n_tokens: int = 1  # tokens this plan spends (chunk length for prefill)
    n_decode: int = 0  # mixed: leading decode rows (prefill row is last)
    chunk_lens: Optional[np.ndarray] = None  # mixed: (B,) valid tokens/row


class Scheduler:
    def __init__(self, pool, *, block_size: int, max_batch: int,
                 max_inflight: int = 4, deadline_ms: float = 50.0,
                 chunk_size: int = 16, token_budget: Optional[int] = None,
                 policy: str = "mixed", prefix_cache=None):
        self.pool = pool
        self.block_size = block_size
        # refcounted prefix cache (blocks/prefix_cache.py), or None: the
        # prefill planner consults it before a request's FIRST chunk (the
        # latest moment — prompts admitted together still hit runs the
        # first finisher inserted), `complete` inserts materialized
        # prompts, and pool pressure evicts cache entries before requests
        self.prefix_cache = prefix_cache
        self.max_batch = max_batch
        self.max_inflight = max_inflight
        self.deadline_ms = deadline_ms
        if chunk_size < 1:
            raise ValueError("chunk_size must be >= 1")
        self.chunk_size = chunk_size  # per-step prefill token budget
        # per-tick token budget: decode rows spend 1 each, the remainder
        # funds one prefill chunk.  The default fits a full decode batch
        # PLUS a full chunk, so neither phase can crowd the other out.
        if token_budget is None:
            token_budget = max_batch + chunk_size
        if token_budget < 1:
            raise ValueError("token_budget must be >= 1")
        self.token_budget = token_budget
        if policy not in ("mixed", "prefill_first"):
            raise ValueError(f"policy {policy!r}: expected 'mixed' or "
                             "'prefill_first'")
        self.policy = policy
        # request-level shard router: round-robin assignment at submit,
        # one intake queue PER SLO CLASS per shard (interactive drained
        # first; n_shards == 1 for unsharded pools)
        self.n_shards = getattr(pool, "n_shards", 1)
        self.queues: List[Dict[str, deque]] = [
            {c: deque() for c in SLO_CLASSES} for _ in range(self.n_shards)]
        self.active: List[Request] = []
        self._qlock = threading.Lock()
        # one lock for planning/accounting; the device step runs outside it
        self._lock = threading.RLock()
        # idle workers park here; complete()/submit() wake them (no hot
        # spinning — a busy poll starves the working threads of the GIL)
        self._work = threading.Condition(self._lock)
        self._rid = itertools.count()
        self._slots = deque(range(max_inflight))
        # per-worker stats: tid -> dict, each written by its owner only
        self._worker_stats: Dict[int, Dict[str, int]] = {}

    def _wstats(self, tid: int) -> Dict[str, int]:
        st = self._worker_stats.get(tid)
        if st is None:
            # dict.setdefault is atomic under the GIL; first writer wins
            st = self._worker_stats.setdefault(
                tid, {k: 0 for k in STAT_KEYS})
        return st

    def count_step(self, tid: int, kind: str, live: int, computed: int,
                   ns: int) -> None:
        """Add one dispatched step of ``kind`` to worker ``tid``'s stats:
        its live rows' query tokens (``live``), the token slots its step
        computes, padding included (``computed``), and the nanoseconds
        from its dispatch to its sampled ids on the host (``ns``)."""
        st = self._wstats(tid)
        st["tokens_live"] += live
        st["tokens_computed"] += computed
        st[kind + "_dispatches"] += 1
        st[kind + "_ns"] += ns

    @property
    def stats(self) -> Dict[str, int]:
        """Merged view over the per-worker stat dicts (race-free: each dict
        has a single writer; the merge reads a snapshot)."""
        merged = {k: 0 for k in STAT_KEYS}
        for st in list(self._worker_stats.values()):
            for k in STAT_KEYS:
                merged[k] += st[k]
        return merged

    # --------------------------------------------------------------- intake
    @property
    def queue(self) -> List[Request]:
        """Flat SNAPSHOT of the per-shard intake queues (interactive before
        batch per shard), taken under the queue lock — iterating the live
        deques while submit()/_evict() mutate them raises RuntimeError."""
        with self._qlock:
            return [r for q in self.queues for c in SLO_CLASSES
                    for r in q[c]]

    def pending(self) -> int:
        with self._qlock:
            return sum(len(q[c]) for q in self.queues for c in SLO_CLASSES)

    def submit(self, prompt: List[int], max_new_tokens: int,
               slo: str = "interactive",
               on_token: Optional[Callable] = None,
               on_finish: Optional[Callable] = None) -> Request:
        if slo not in SLO_CLASSES:
            raise ValueError(f"slo {slo!r}: expected one of {SLO_CLASSES}")
        req = Request(next(self._rid), list(prompt), max_new_tokens, slo=slo,
                      on_token=on_token, on_finish=on_finish)
        req.t_submit = time.monotonic()
        req.shard = req.rid % self.n_shards  # round-robin shard router
        with self._qlock:
            self.queues[req.shard][slo].append(req)
        with self._work:
            self._work.notify_all()
        return req

    # --------------------------------------------------------------- cancel
    def cancel(self, req: Request) -> bool:
        """Abandon ``req`` (client disconnect / DELETE).  Returns True iff
        this call marked it (False: already finished or cancelled).

        Callable from ANY thread — the serving edge included — so it only
        MARKS; block release needs a registered SMR tid and happens on a
        worker at the next safe point:

        * queued: removed from its intake queue in place, finalized here
          (a queued request owns no pages — eviction already released any,
          so there is nothing to retire);
        * active, no step outstanding: the next planning tick's sweep
          (``_sweep_cancelled``) excludes it from the plan and releases
          its table;
        * active, IN FLIGHT: the dispatched step keeps its era
          reservation until ``complete`` — finalization runs there, after
          ``release_step``, so ``release_all`` never races the request's
          own dispatch (and any OTHER in-flight step that snapshotted
          these blocks is covered by its own reservation: retirement only
          stamps ``retire_era``; the interval scan defers physical reuse).
        """
        with self._lock:
            if req.cancelled or req.state in ("done", "cancelled", "failed"):
                return False
            req.cancelled = True
            req.t_cancel = time.monotonic()
            if req.state == "queued":
                with self._qlock:
                    try:
                        self.queues[req.shard][req.slo].remove(req)
                    except ValueError:  # pragma: no cover - defensive
                        pass  # not queued after all; the sweep finalizes
                self._finalize_cancelled(req, None, self._wstats(EDGE_TID))
            self._work.notify_all()  # wake a worker to sweep/finish it
            return True

    def wait_for_work(self, timeout: float) -> None:
        """Park until a step completes or a request arrives (idle workers)."""
        with self._work:
            self._work.wait(timeout)

    # --------------------------------------------------------------- tick
    def tick(self, tid: int) -> Optional[StepPlan]:
        """Plan one step.  Returns None when nothing is runnable.

        With a sharded pool each plan draws from ONE shard (the plan's
        device step then touches only that shard's KV-pool chain, so steps
        on different shards execute concurrently).  Shards are tried
        starting from the caller's affinity (``tid % n_shards``).
        """
        with obs.span("sched.tick"), self._lock:
            # drop cancelled requests FIRST: rows excluded from this (and
            # every later) plan, their pages released through the normal
            # refcount/era path before any new allocation competes for them
            self._sweep_cancelled(tid)
            for k in range(self.n_shards):
                plan = self._tick_locked(tid, (tid + k) % self.n_shards)
                if plan is not None:
                    return plan
            return None

    def _sweep_cancelled(self, tid: int) -> None:
        """Finalize every cancelled active request with no step outstanding
        (caller holds the scheduler lock).  In-flight ones wait for their
        ``complete`` — the era reservation of the dispatched step is still
        live, and the completion path finalizes them right after releasing
        it."""
        stats = self._wstats(tid)
        for req in [r for r in self.active
                    if r.cancelled and not r.inflight]:
            self._finalize_cancelled(req, tid, stats)

    def _finalize_cancelled(self, req: Request, tid: Optional[int],
                            stats: Dict[str, int]) -> None:
        """Retire a cancelled request (caller holds the scheduler lock;
        ``req`` must not be in flight).  ``tid is None`` only for QUEUED
        requests, which own no pages (a fresh request has no table; an
        evicted one already released everything on preemption) — every
        other path runs on a worker with a registered SMR tid.

        Salvage before release: whatever block-aligned prefix the request
        fully materialized is immutable and cache-eligible — the insert
        takes sharer references while the table's own references provably
        pin the counts above zero, exactly like the completion-path
        insert.  A later request with the same prompt prefix aliases those
        pages instead of re-prefilling them, so cancelled work is not all
        wasted work.
        """
        if req.table is not None and len(req.table) > 0:
            assert tid is not None, "owned pages imply a worker finalizer"
            if self.prefix_cache is not None:
                materialized = min(req.length, len(req.prompt))
                if materialized > 0:
                    self.prefix_cache.insert(
                        req.prompt[:materialized],
                        req.table.current().blocks, tid, shard=req.shard)
            stats["cancelled_blocks"] += req.table.release_all(tid)
        req.state = "cancelled"
        req.t_released = time.monotonic()
        if req in self.active:
            self.active.remove(req)
        stats["cancelled"] += 1
        stats["cancelled_tokens"] += len(req.generated)
        if req.on_finish is not None:
            req.on_finish(req)

    def _finalize_failed(self, req: Request, tid: int,
                         stats: Dict[str, int]) -> None:
        """Terminal failure of ONE request (non-finite sampled output) —
        the batch's other rows are untouched.  Caller holds the scheduler
        lock; ``req`` is not in flight (its step completed and released
        its reservation).  Unlike cancellation, NOTHING is salvaged into
        the prefix cache: a poisoned logit means the request's KV pages
        are suspect, and a cache insert would hand them to future readers.
        The pages release through the ordinary refcount/era path.
        """
        if req.table is not None and len(req.table) > 0:
            req.table.release_all(tid)
        req.state = "failed"
        req.t_released = time.monotonic()
        if req in self.active:
            self.active.remove(req)
        stats["failed"] += 1
        stats["failed_tokens"] += len(req.generated)
        if req.on_finish is not None:
            req.on_finish(req)

    # ------------------------------------------------------ crash recovery
    def requeue_crashed(self, plan: StepPlan, tid: int) -> None:
        """Rewind a DEAD worker's orphaned plan (supervisor path,
        docs/robustness.md).  ``tid`` is the SUPERVISOR's registered tid —
        the dead worker's tid is already quarantined.

        The dead worker stopped somewhere between publishing the plan's
        era reservation and calling ``complete``; either way no device
        read is still in flight (dispatches are synchronous — the worker
        blocked in ``np.asarray`` until the step finished, or never
        dispatched at all).  Each non-cancelled row rewinds through the
        ordinary eviction path: pages release via refcount/era (never a
        force-retire), the prefill cursor and generated tokens reset, and
        the request requeues at the HEAD of its intake queue — greedy
        decode is deterministic, so the replay is token-identical.
        Cancelled rows finalize instead (their client already left).  The
        plan's in-flight slot returns to the pool; its era reservation is
        cleared separately by ``reap_thread`` (caller runs reap FIRST so
        the evictions' cleanup can free the released pages immediately).
        """
        stats = self._wstats(tid)
        with self._lock:
            for req in plan.requests:
                if not req.inflight:
                    continue  # defensive: the plan completed after all
                req.inflight = False
                if req.cancelled:
                    self._finalize_cancelled(req, tid, stats)
                elif req.state == "active":
                    stats["crash_requeues"] += 1
                    stats["crash_wasted_tokens"] += len(req.generated)
                    self._evict(req, tid)
            if plan.slot not in self._slots:
                self._slots.append(plan.slot)
            self._work.notify_all()

    def _tick_locked(self, tid: int, shard: int) -> Optional[StepPlan]:
        stats = self._wstats(tid)
        deadline = time.monotonic() + self.deadline_ms / 1e3
        self._admit(tid, shard, deadline, stats)
        if not self.active:
            return None
        if not self._slots:
            return None  # all in-flight slots busy; caller completes first
        if self.policy == "prefill_first":
            return self._tick_prefill_first(tid, shard, deadline, stats)
        return self._tick_mixed(tid, shard, deadline, stats)

    def _admit(self, tid: int, shard: int, deadline: float,
               stats: Dict[str, int]) -> None:
        """Admit into this shard's active set up to the HARD ``max_batch``
        cap, interactive intake first (batch requests are deferred behind
        any interactive backlog — the admission half of the SLO ladder).

        ``max_batch`` bounds the ACTIVE SET, not just the per-step batch:
        letting the set grow with the in-flight count (the old
        ``max_batch + n_inflight`` condition) ratcheted pool pressure and
        eviction churn up with pipeline depth.
        """
        while True:
            n_active = sum(1 for r in self.active if r.shard == shard)
            if n_active >= self.max_batch:
                break
            with self._qlock:
                q = self.queues[shard]
                if q["interactive"]:
                    req = q["interactive"].popleft()
                elif q["batch"]:
                    req = q["batch"].popleft()
                else:
                    break
            if req.cancelled:  # raced cancel's queue removal: drop, not admit
                self._finalize_cancelled(req, tid, stats)
                continue
            if req.table is None:
                req.table = BlockTableRef(
                    self.pool, tid,
                    shard=req.shard if self.n_shards > 1 else None)
            req.state = "active"
            if req.t_admit is None:
                req.t_admit = time.monotonic()
            self.active.append(req)
            stats["admitted"] += 1
            if time.monotonic() > deadline:
                # straggler mitigation: cut the batch, run what we have
                stats["deadline_cutoffs"] += 1
                break

    # ------------------------------------------------------------ planners
    def _tick_mixed(self, tid: int, shard: int, deadline: float,
                    stats: Dict[str, int]) -> Optional[StepPlan]:
        """The token-budget planner: decode rows first, then one prefill
        chunk from the remainder — one plan, one dispatch, one reservation.
        """
        budget = self.token_budget
        runnable = self._gather_decode(tid, shard, deadline, stats,
                                       cap=min(self.max_batch, budget))
        budget -= len(runnable)
        pre, n = None, 0
        if budget > 0:
            # oldest prefill-phase request gets the remainder; a candidate
            # that cannot fund even one token (pool exhausted, no victim)
            # yields to the next one
            for req in list(self.active):
                if req.state != "active" or req.inflight \
                        or req.shard != shard or req.phase != "prefill":
                    continue
                n = self._alloc_prefill_chunk(req, tid, shard, deadline,
                                              stats, budget, runnable)
                if n > 0:
                    pre = req
                    break
        if not runnable and pre is None:
            return None
        slot = self._slots.popleft()
        # ORDER MATTERS (Lemma 4 discipline): publish the era reservation
        # FIRST, then snapshot tables — everything read after the publish
        # is covered by the reservation's era.  A sharded plan reserves
        # only in its own shard (all its blocks live there).
        self.pool.protect_step(slot, tid, shard=shard)
        if pre is None:
            return self._build_decode_plan(runnable, slot, shard, stats)
        if not runnable:
            return self._build_prefill_plan(pre, n, slot, shard, stats)
        return self._build_mixed_plan(runnable, pre, n, slot, shard, stats)

    def _tick_prefill_first(self, tid: int, shard: int, deadline: float,
                            stats: Dict[str, int]) -> Optional[StepPlan]:
        """The legacy TTFT-first planner (the seed behavior, kept for A/B):
        prefill strictly before decode — under sustained prompt arrival
        decode-phase requests starve (see tests/test_scheduler_slo.py)."""
        for req in list(self.active):
            if req.state != "active" or req.inflight or req.shard != shard \
                    or req.phase != "prefill":
                continue
            n = self._alloc_prefill_chunk(req, tid, shard, deadline, stats,
                                          self.chunk_size, None)
            if n > 0:
                slot = self._slots.popleft()
                self.pool.protect_step(slot, tid, shard=shard)
                return self._build_prefill_plan(req, n, slot, shard, stats)
            # no pages for even one token of this request: try the next
            # candidate (or fall through to a decode batch)
        runnable = self._gather_decode(tid, shard, deadline, stats,
                                       cap=self.max_batch)
        if not runnable:
            return None
        slot = self._slots.popleft()
        self.pool.protect_step(slot, tid, shard=shard)
        return self._build_decode_plan(runnable, slot, shard, stats)

    def _gather_decode(self, tid: int, shard: int, deadline: float,
                       stats: Dict[str, int], cap: int) -> List[Request]:
        """Collect up to ``cap`` decode-phase rows, allocating a fresh
        block where a request crosses a block boundary.  Priority is
        admission order (FCFS): under pool pressure the shedding ladder
        runs (cache entry, then newest batch-class request, then same-class
        LIFO), so the oldest request makes monotonic progress — no
        eviction livelock.  Requests whose previous step is still in
        flight (another worker's) are skipped; they rejoin once that
        worker completes them.

        The planning deadline covers the WHOLE phase: once at least one
        row is gathered, crossing the deadline cuts the batch (run what we
        have), and the per-request eviction ladder stops one step past it
        — planning latency stays bounded even under heavy pool pressure,
        while a tick under pressure still makes at least one unit of
        progress (one ladder step) so a zero deadline cannot livelock.
        """
        runnable: List[Request] = []
        for req in list(self.active):
            if req.state != "active" or req.inflight or req.shard != shard \
                    or req.phase != "decode":
                continue  # evicted earlier in this loop, being stepped,
                # pinned to a different shard's device chain, or still
                # materializing its prompt (the prefill planner's job)
            if len(runnable) >= cap:
                break
            if runnable and time.monotonic() > deadline:
                # straggler mitigation: cut the batch, run what we have
                stats["deadline_cutoffs"] += 1
                break
            if req.length % self.block_size == 0:  # needs a fresh block
                got = False
                attempts = 0
                while not got:
                    if attempts and time.monotonic() > deadline:
                        stats["deadline_cutoffs"] += 1
                        break  # bounded: give up on this row this tick
                    attempts += 1
                    try:
                        req.table.append_block(tid)
                        got = True
                    except PoolExhausted:
                        if self._evict_cache_entry(tid, shard, stats):
                            continue  # cache-only blocks freed; retry
                        victim = self._pick_victim(exclude=req, shard=shard)
                        if victim is None:
                            break  # req is the newest; it waits this tick
                        if victim in runnable:
                            runnable.remove(victim)
                        self._evict(victim, tid)
                if not got:
                    continue
            runnable.append(req)
        return runnable

    def _evict_cache_entry(self, tid: int, shard: int,
                           stats: Dict[str, int]) -> bool:
        """Under pool pressure, drop one LRU prefix-cache entry first.

        Reclaiming cache-only blocks is free; preempting a victim request
        redoes its prefill.  Blocks still aliased by live requests merely
        lose the cache's reference (shared blocks are not victims — the
        last sharer still retires them exactly once).
        """
        if self.prefix_cache is None:
            return False
        cache_shard = shard if self.n_shards > 1 else None
        if not self.prefix_cache.evict_lru(tid, shard=cache_shard):
            return False
        stats["prefix_evictions"] += 1
        return True

    def _consult_prefix_cache(self, req: Request, tid: int, shard: int,
                              stats: Dict[str, int]) -> None:
        """Alias a cached block run into ``req``'s (empty) table.

        The prefill cursor jumps to the cached boundary, so the cached
        chunks cost ZERO prefill dispatches and the device step never
        re-scatters a cached page.  Runs before the request's first chunk
        — also on re-admission after eviction (the rewound cursor makes
        the rematerialization itself cache-eligible).
        """
        if self.prefix_cache is None or req.prefix_checked \
                or req.length != 0 or len(req.table) != 0:
            return
        req.prefix_checked = True
        stats["prefix_lookups"] += 1
        blocks = self.prefix_cache.acquire(req.prompt, shard=shard)
        if not blocks:
            return
        req.table.adopt_prefix(tid, blocks)
        req.length = len(blocks) * self.block_size
        stats["prefix_hits"] += 1
        stats["prefix_hit_tokens"] += req.length

    def _alloc_prefill_chunk(self, req: Request, tid: int, shard: int,
                             deadline: float, stats: Dict[str, int],
                             budget: int,
                             runnable: Optional[List[Request]]) -> int:
        """Fund one prefill chunk for ``req``: consult the prefix cache,
        size the chunk to ``min(chunk_size, budget, prompt remainder)``,
        and bulk-allocate every page it needs in ONE table version
        (``append_blocks`` → ``alloc_blocks``, atomic under pressure).

        Under exhaustion the shedding ladder runs (cache entry → newest
        batch request → same-class LIFO victim); with no victim left, the
        chunk shrinks to the capacity of pages the request already owns.
        Crossing the planning deadline stops the ladder one step past it
        and runs the shrunken chunk.  A victim already gathered as a
        decode row this tick is dropped from ``runnable``.  Returns the
        chunk length (0 = nothing fundable this tick).
        """
        self._consult_prefix_cache(req, tid, shard, stats)
        ctx = req.length
        n = min(self.chunk_size, budget, len(req.prompt) - ctx)
        if n <= 0:
            return 0

        def owned() -> int:  # tokens fundable by already-owned pages
            return min(n, len(req.table) * self.block_size - ctx)

        need = -(-(ctx + n) // self.block_size) - len(req.table)
        attempts = 0
        while need > 0:
            if attempts and time.monotonic() > deadline:
                stats["deadline_cutoffs"] += 1
                return max(owned(), 0)
            attempts += 1
            try:
                req.table.append_blocks(tid, need)
                need = 0
            except PoolExhausted:
                if self._evict_cache_entry(tid, shard, stats):
                    continue  # cache-only blocks freed; retry the alloc
                victim = self._pick_victim(exclude=req, shard=shard)
                if victim is None:
                    # newest evictable request is us: shrink the chunk to
                    # the pages already owned and run that much
                    n = owned()
                    if n <= 0:
                        return 0
                    need = 0
                else:
                    if runnable is not None and victim in runnable:
                        runnable.remove(victim)
                    self._evict(victim, tid)
        return n

    # ------------------------------------------------------- plan builders
    def _build_decode_plan(self, runnable: List[Request], slot: int,
                           shard: int, stats: Dict[str, int]) -> StepPlan:
        b = len(runnable)
        nblk = max(len(r.table) for r in runnable)
        tables = np.zeros((b, nblk), np.int32)
        tokens = np.zeros((b,), np.int32)
        positions = np.zeros((b,), np.int32)
        lengths = np.zeros((b,), np.int32)
        for i, req in enumerate(runnable):
            req.inflight = True
            snap = req.table.current()  # protected snapshot
            ids = snap.block_ids
            tables[i, : len(ids)] = ids
            tokens[i] = req.next_token
            positions[i] = req.length
            lengths[i] = req.length + 1
        stats["steps"] += 1
        return StepPlan(slot, runnable, tokens, positions, tables, lengths,
                        shard=shard)

    def _build_prefill_plan(self, req: Request, n: int, slot: int,
                            shard: int, stats: Dict[str, int]) -> StepPlan:
        ctx = req.length
        req.inflight = True
        if req.t_prefill is None:
            req.t_prefill = time.monotonic()
        snap = req.table.current()  # protected snapshot
        ids = snap.block_ids
        tables = np.zeros((1, len(ids)), np.int32)
        tables[0, :] = ids
        tokens = np.asarray(req.prompt[ctx:ctx + n], np.int32)
        positions = np.arange(ctx, ctx + n, dtype=np.int32)
        lengths = np.array([ctx + n], np.int32)
        stats["steps"] += 1
        stats["prefill_chunks"] += 1
        stats["prefill_tokens"] += n
        return StepPlan(slot, [req], tokens, positions, tables, lengths,
                        shard=shard, kind="prefill", n_tokens=n)

    def _build_mixed_plan(self, runnable: List[Request], pre: Request,
                          n: int, slot: int, shard: int,
                          stats: Dict[str, int]) -> StepPlan:
        """Decode rows + one prefill chunk row (last) in ONE dispatch.

        Row layout is the chunked kernel's ragged form: (B, C) tokens and
        absolute positions with per-row ``chunk_lens`` — decode rows carry
        1 valid token (their columns past 0 clamp to the row's position,
        so padded columns stay masked to materialized pages).
        """
        rows = runnable + [pre]
        b = len(rows)
        nblk = max(len(r.table) for r in rows)
        tables = np.zeros((b, nblk), np.int32)
        tokens = np.zeros((b, n), np.int32)
        positions = np.zeros((b, n), np.int32)
        chunk_lens = np.zeros((b,), np.int32)
        lengths = np.zeros((b,), np.int32)
        for i, req in enumerate(runnable):
            req.inflight = True
            ids = req.table.current().block_ids  # protected snapshot
            tables[i, : len(ids)] = ids
            tokens[i, 0] = req.next_token
            positions[i, :] = req.length  # pad cols clamp to the one pos
            chunk_lens[i] = 1
            lengths[i] = req.length + 1
        ctx = pre.length
        pre.inflight = True
        if pre.t_prefill is None:
            pre.t_prefill = time.monotonic()
        ids = pre.table.current().block_ids  # protected snapshot
        tables[b - 1, : len(ids)] = ids
        tokens[b - 1, :] = pre.prompt[ctx:ctx + n]
        positions[b - 1, :] = np.arange(ctx, ctx + n, dtype=np.int32)
        chunk_lens[b - 1] = n
        lengths[b - 1] = ctx + n
        stats["steps"] += 1
        stats["mixed_steps"] += 1
        stats["prefill_chunks"] += 1
        stats["prefill_tokens"] += n
        return StepPlan(slot, rows, tokens, positions, tables, lengths,
                        shard=shard, kind="mixed",
                        n_tokens=len(runnable) + n,
                        n_decode=len(runnable), chunk_lens=chunk_lens)

    # --------------------------------------------------------------- complete
    def complete(self, plan: StepPlan, sampled: np.ndarray, tid: int,
                 failed_rows: Optional[List[bool]] = None) -> None:
        """Account one finished device step; release its reservation.

        ``sampled`` holds one token per plan ROW — for prefill rows it is
        the argmax of the chunk's last valid position, consumed only by
        the chunk that materializes the final prompt token (it IS the
        first generated token); earlier chunks' samples are discarded.

        ``failed_rows`` (engine finite-check / fault injection) flags rows
        whose sampled output was non-finite: their accounting is skipped —
        the garbage token must not enter ``generated`` — and the request
        finalizes to the terminal ``failed`` state after ``release_step``,
        through the same post-reservation ordering as a cancelled
        in-flight row.
        """
        with obs.span("sched.complete"):
            stats = self._wstats(tid)
            failed_rids = set()
            if failed_rows is not None:
                failed_rids = {req.rid for req, bad
                               in zip(plan.requests, failed_rows) if bad}
            with self._lock:
                if failed_rids:
                    for req in plan.requests:
                        if req.rid in failed_rids:
                            req.inflight = False  # its step DID complete
                            req.failing = True
                if plan.kind == "prefill":
                    if plan.requests[0].rid not in failed_rids:
                        self._complete_prefill(plan.requests[0],
                                               plan.n_tokens, int(sampled[0]),
                                               tid, stats)
                elif plan.kind == "mixed":
                    for i, req in enumerate(plan.requests):
                        if req.rid in failed_rids:
                            continue
                        if i < plan.n_decode:
                            self._complete_decode(req, int(sampled[i]), tid,
                                                  stats)
                        else:
                            self._complete_prefill(
                                req, int(plan.chunk_lens[i]), int(sampled[i]),
                                tid, stats)
                else:
                    for req, tok in zip(plan.requests, sampled):
                        if req.rid not in failed_rids:
                            self._complete_decode(req, int(tok), tid, stats)
                self.pool.release_step(plan.slot, tid, shard=plan.shard)
                self._slots.append(plan.slot)
                # cancelled/failed rows finalize HERE — after release_step,
                # so release_all never runs under this request's own
                # dispatch (the cancellation ordering; any sibling step
                # still naming these blocks holds its own reservation and
                # the era scan defers physical reuse until it clears)
                for req in plan.requests:
                    if req.cancelled and req.state == "active":
                        self._finalize_cancelled(req, tid, stats)
                    elif req.failing and req.state == "active":
                        self._finalize_failed(req, tid, stats)
                # freed a slot + un-inflighted requests
                self._work.notify_all()
            # shard-clock merge rides on the step boundary (sharded pools)
            boundary = getattr(self.pool, "step_boundary", None)
            if boundary is not None:
                boundary(tid)
            # batched drain (era_table backends) once the list crosses
            # the pool's vectorized threshold; scalar flush below it.
            # Outside the scheduler lock: reclamation must never block
            # planning.  Under sharding every retire from this complete —
            # blocks AND table versions, both pinned to the request's shard
            # — landed in plan.shard, so one shard's drain covers them.
            stats["reclaimed"] += self.pool.cleanup(tid, shard=plan.shard)

    def _complete_decode(self, req: Request, tok: int, tid: int,
                         stats: Dict[str, int]) -> None:
        req.inflight = False
        req.length += 1
        # the step that consumed the last prompt token produces the first
        # generated token; a cancelled row's sample is discarded (nobody
        # is listening — complete() finalizes it after release_step)
        if req.length >= len(req.prompt) and not req.cancelled:
            self._append_token(req, tok, tid, stats)

    def _complete_prefill(self, req: Request, n: int, tok: int, tid: int,
                          stats: Dict[str, int]) -> None:
        req.inflight = False
        req.length += n
        if req.length >= len(req.prompt):
            if self.prefix_cache is not None:
                # register every block-aligned prefix of the now fully-
                # materialized prompt — BEFORE the request can finish and
                # release its references (the cache increments sharer
                # counts while they are provably nonzero).  This runs for
                # cancelled rows too: the scatter happened, the pages are
                # immutable — the prefix outlives the client that paid
                # for it (partial prefixes are salvaged by
                # ``_finalize_cancelled`` the same way)
                self.prefix_cache.insert(
                    req.prompt, req.table.current().blocks,
                    tid, shard=req.shard)
            if not req.cancelled:
                self._append_token(req, tok, tid, stats)

    def _append_token(self, req: Request, tok: int, tid: int,
                      stats: Dict[str, int]) -> None:
        """Deliver one generated token (and retire the request when done).
        Caller holds the scheduler lock."""
        req.generated.append(tok)
        now = time.monotonic()
        if req.t_last is not None:
            # worst inter-token gap: the decode-starvation symptom the
            # TPOT *mean* hides (many fast tokens average one stall away)
            req.max_gap = max(req.max_gap, now - req.t_last)
        req.t_last = now
        if req.t_first is None:
            req.t_first = now
        if req.on_token is not None:
            # streaming handoff (must be O(1) — we hold the scheduler
            # lock); consumers dedupe by index across eviction replays
            req.on_token(req, len(req.generated) - 1, tok)
        if req.done:
            req.state = "done"
            with obs.span("table.release"):
                req.table.release_all(tid)
            self.active.remove(req)
            stats["completed"] += 1
            if req.on_finish is not None:
                req.on_finish(req)

    # --------------------------------------------------------------- evict
    def _pick_victim(self, exclude: Request,
                     shard: Optional[int] = None) -> Optional[Request]:
        """The preemption half of the shedding ladder (the cache rung runs
        in ``_evict_cache_entry`` before this is consulted).

        Rung 2 — priority shedding: an INTERACTIVE requester preempts the
        newest batch-class request first, REGARDLESS of admission order.
        Safe against ping-pong livelock because the inverse move does not
        exist: a batch request can never preempt an interactive one.

        Rung 3 — same-class LIFO (vLLM policy): only requests admitted
        AFTER ``exclude`` are candidates — blocks flow strictly from newer
        to older requests, so the oldest request makes monotonic progress
        and the newest can never steal (it shrinks its chunk or waits
        instead).  Without this bound two prefill-phase requests under
        pressure evict each other forever.

        Never preempts a request whose step is in flight — its block-table
        snapshot is feeding a device step right now (the era reservation
        keeps the blocks readable, but restarting the request mid-step
        would corrupt its token accounting).  Under sharding the victim
        must live in the pressured shard — evicting elsewhere frees the
        wrong slot range.
        """
        def evictable(req: Request) -> bool:
            # a cancelled request is never a victim: the sweep is about to
            # release everything it owns anyway, and eviction would requeue
            # it as if it still had a client
            return (req.state == "active" and not req.inflight
                    and not req.cancelled
                    and (shard is None or req.shard == shard))

        if exclude.slo == "interactive":
            for req in reversed(self.active):
                if req is not exclude and req.slo == "batch" \
                        and evictable(req):
                    return req
        for req in reversed(self.active):
            if req is exclude:
                break  # everything earlier in the list is OLDER: off-limits
            # a batch requester may only preempt batch-class requests —
            # interactive work is never shed on behalf of batch work
            if exclude.slo == "batch" and req.slo != "batch":
                continue
            if evictable(req):
                return req
        return None

    def _evict(self, req: Request, tid: int) -> None:
        req.table.release_all(tid)
        req.length = 0  # prefill cursor rewinds: the prompt rematerializes
        req.generated.clear()
        # latency stamps follow the tokens they timed: the re-run delivers
        # a fresh first token, so TTFT/TPOT restart (keeping the old
        # t_first would understate TTFT and fold the eviction gap into TPOT)
        req.t_first = None
        req.t_last = None
        req.max_gap = 0.0
        req.state = "queued"
        req.prefix_checked = False  # the re-run may hit the cache anew
        req.evictions += 1
        self.active.remove(req)
        with self._qlock:
            # HEAD of the intake queue, not the tail: TTFT is still
            # clocked from the original submit, so falling behind
            # brand-new arrivals would balloon it unfairly — a preempted
            # request re-admits before anything submitted after it
            self.queues[req.shard][req.slo].appendleft(req)
        stats = self._wstats(tid)
        stats["evictions"] += 1
        if req.slo == "batch":
            stats["batch_evictions"] += 1
        # scoped to the pressured shard: _evict runs under the scheduler
        # lock, so a full cross-shard fan-out here would serialize every
        # other worker's planning behind reclamation
        stats["reclaimed"] += self.pool.cleanup(tid, shard=req.shard)
