"""Multi-worker serving runtime over the (optionally sharded) engine.

Ported from ``repro.serve.runtime``.  ``ServeRuntime`` spawns K worker
threads, each with its own registered SMR ``tid``, all driving
``ServeEngine.step`` concurrently:

* worker A waits on its device step's result (the wait on the shard
  stream's event releases the GIL) while worker B plans and dispatches
  the next step against a *disjoint* set of requests — the scheduler's
  ``inflight`` discipline guarantees no request is ever stepped twice
  concurrently, and ``max_inflight`` era-reservation slots bound the
  pipeline depth;
* steps are TYPED plans (``StepPlan.kind``): a worker may be running a
  prefill CHUNK on one shard while siblings run decode batches on others —
  prefill and decode overlap across the per-shard CUDA streams, so long
  prompts stop serializing the fleet (``stats['prefill_chunks']`` /
  ``stats['prefill_tokens']`` count the chunked work);
* each worker keeps its own scheduler stats dict (single-writer);
  ``serve()`` returns the merged aggregate plus per-worker breakdowns;
* shutdown is a graceful two-phase drain: workers exit when the queue and
  active set are empty, then ONE era-progress-bounded ``engine.drain``
  reclaims every retired block (provably terminating — see
  ``ServeEngine.drain``; no magic round counts).

Crash tolerance (the reference's docs/robustness.md): a worker that dies
mid-step is a RECOVERABLE event, not a runtime abort.  The supervisor —
inline in batch mode, a dedicated thread in persistent mode — detects the
death (``Thread.is_alive`` plus the captured exception), joins the thread,
and then, in order:

1. **quarantines** the dead tid — it is never reused;
2. **reaps** its era reservations via ``pool.reap_thread(tid)`` — safe
   exactly because the thread is joined: a joined thread can never
   publish, dereference, or retire again (reap-after-join argument next
   to Theorem 4 in the reference's docs/schemes.md), and
   ``ServeEngine.execute_plan`` synchronizes the shard's stream before an
   exception leaves it, so no kernel of the dead worker still reads the
   pages its reservation protected;
3. **requeues** the plan it dispatched-but-never-completed through the
   scheduler's ordinary eviction rewind (``requeue_crashed``) — greedy
   decode makes the replay token-identical;
4. **respawns** a replacement worker on a FRESH tid (bounded by
   ``max_respawns`` and the scheme's tid headroom).

Recovery latency — crash detected to the replacement's first productive
step — lands in ``recovery_latencies`` (seconds).  An unrecoverable
crash (budget or headroom exhausted) still stops the fleet, but every
exit path now attempts the era-bounded drain first and parks the merged
stats in ``partial_stats`` before re-raising.

Two operating modes:

* **batch** (``serve()``): run everything already submitted to
  completion, then drain — the library mode every benchmark uses;
* **persistent** (``start()`` / ``submit()`` / ``cancel()`` /
  ``drain()``): workers park on the scheduler's condition when idle and
  serve submissions as they arrive — the serving front-end's mode.
  ``drain()`` is the ROLLING drain: it atomically closes admission
  (``submit`` raises from that point on — see below), waits for in-flight
  work to finish within an optional deadline, CANCELS whatever remains
  past it (pages release through the refcount/era path, never a
  force-retire), stops the workers, and runs the final reclamation drain.

The ``submit``/``drain`` race: admission and drain-begin are serialized
by one lock, so every submission either happens-before the drain (and is
served or deadline-cancelled by it) or raises ``RuntimeError`` — a
request can never slip in after the workers have decided to exit and
strand silently, which is exactly what the pre-fix runtime did.

The runtime enforces ``max_threads`` headroom at construction so every
worker (and the drain) can register a tid; the wait-free scheme registry
is per-shard-consistent (``ShardedBlockPool.register_thread``).  Leave
extra headroom when faults are armed: every respawn burns a fresh tid.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from .engine import ServeEngine

__all__ = ["ServeRuntime"]


class ServeRuntime:
    def __init__(self, engine: ServeEngine, *, n_workers: int = 2,
                 max_steps_per_worker: int = 10_000,
                 max_respawns: Optional[int] = None,
                 supervise_poll_s: float = 0.005):
        if n_workers < 1:
            raise ValueError("n_workers must be >= 1")
        self.engine = engine
        self.n_workers = n_workers
        self.max_steps_per_worker = max_steps_per_worker
        #: respawn budget: None = unbounded (headroom still binds); 0
        #: turns every crash into an unrecoverable one (tests use this to
        #: exercise the error path's drain guarantee)
        self.max_respawns = max_respawns
        self.supervise_poll_s = supervise_poll_s
        self.worker_steps: List[int] = [0] * n_workers
        self.errors: List[BaseException] = []
        # crash-tolerance telemetry (supervisor-writer only)
        self.n_respawns = 0
        self.crashed_tids: List[int] = []
        self.worker_crashes: List[Dict[str, object]] = []
        self.recovery_latencies: List[float] = []  # seconds, per respawn
        #: stats snapshot from the last failed serve()/drain() — the
        #: error path still drains and accounts before raising
        self.partial_stats: Optional[Dict[str, object]] = None
        self._worker_excs: List[Optional[BaseException]] = [None] * n_workers
        self._tids: Optional[List[int]] = None
        self._sup_tid: Optional[int] = None
        self._sup_thread: Optional[threading.Thread] = None
        self._exit_when_idle = True
        # set on unrecoverable failure or drain: crashed-and-unrequeued
        # requests would otherwise stall the survivors' idle loops until
        # max_steps before the error surfaced from serve()
        self._stop = threading.Event()
        # persistent mode: the admission gate serializes submit() against
        # drain-begin — once _draining is set under the gate, no submission
        # can slip behind the exiting workers and strand
        self._gate = threading.Lock()
        self._draining = False
        self._threads: List[Optional[threading.Thread]] = []

    # ---------------------------------------------------------------- workers
    def _worker(self, wid: int, tid: int, barrier: threading.Barrier,
                exit_when_idle: bool = True, on_first_step=None) -> None:
        try:
            barrier.wait()  # start together: contention from step one
            self.worker_steps[wid] = self.engine.run_worker(
                tid, self.max_steps_per_worker, stop=self._stop,
                exit_when_idle=exit_when_idle, on_first_step=on_first_step)
        except BaseException as e:
            # park the exception for the SUPERVISOR: it decides whether
            # this is a recoverable crash (reap + requeue + respawn) or a
            # fleet stop — a worker no longer aborts the runtime itself
            self._worker_excs[wid] = e

    def _spawn(self, exit_when_idle: bool) -> List[Optional[threading.Thread]]:
        engine = self.engine
        if self._tids is None:  # one tid per worker, ever
            self._tids = [engine.pool.register_thread()
                          for _ in range(self.n_workers)]
        self._exit_when_idle = exit_when_idle
        self._worker_excs = [None] * self.n_workers
        self.worker_steps = [0] * self.n_workers
        barrier = threading.Barrier(self.n_workers)
        threads: List[Optional[threading.Thread]] = [
            threading.Thread(target=self._worker,
                             args=(w, tid, barrier, exit_when_idle),
                             name=f"serve-worker-{w}", daemon=True)
            for w, tid in enumerate(self._tids)
        ]
        for t in threads:
            t.start()
        return threads

    # ------------------------------------------------------------ supervision
    def _tid_headroom(self) -> int:
        """Unregistered tids left in the scheme (min is per-shard-equal:
        one registration covers every shard)."""
        pool = self.engine.pool
        smr = pool.shards[0].smr if hasattr(pool, "shards") else pool.smr
        return smr.max_threads - smr.registered_threads

    def _supervisor_tid(self) -> Optional[int]:
        """Lazily register the supervisor's own tid (None when the scheme
        registry is full).  Used for requeue accounting and the final
        drain — the supervisor must never write stats under a dead tid."""
        if self._sup_tid is None:
            if self._tid_headroom() < 1:
                return None
            self._sup_tid = self.engine.pool.register_thread()
        return self._sup_tid

    def _drain_tid(self) -> int:
        return self._sup_tid if self._sup_tid is not None else self._tids[0]

    def _handle_crash(self, wid: int,
                      exc: BaseException) -> Optional[threading.Thread]:
        """Recover from worker ``wid``'s death (the thread is JOINED).

        Order matters: reap FIRST (clears the dead tid's era reservations
        — safe after join), then requeue the orphaned plan (the eviction
        rewind's cleanup can then free the rewound pages immediately
        instead of waiting a scan).  Returns the replacement thread, or
        None when the crash is unrecoverable (errors + stop set) or the
        runtime is already stopping.
        """
        t_detect = time.monotonic()
        tid = self._tids[wid]
        self.crashed_tids.append(tid)
        self.worker_crashes.append(
            {"wid": wid, "tid": tid, "error": repr(exc)})
        sup = self._supervisor_tid()
        self.engine.pool.reap_thread(tid)
        plan = self.engine.take_orphaned_plan(tid)
        if plan is not None and sup is not None:
            self.engine.sched.requeue_crashed(plan, sup)
        if self._stop.is_set():
            return None  # fleet already stopping: recovered state, no respawn
        exhausted = (self.max_respawns is not None
                     and self.n_respawns >= self.max_respawns)
        if exhausted or sup is None or self._tid_headroom() < 1:
            self.errors.append(exc)
            self._stop.set()
            return None
        new_tid = self.engine.pool.register_thread()
        self._tids[wid] = new_tid
        self.n_respawns += 1

        def _on_first_step() -> None:
            self.recovery_latencies.append(time.monotonic() - t_detect)

        t = threading.Thread(
            target=self._worker,
            args=(wid, new_tid, threading.Barrier(1), self._exit_when_idle,
                  _on_first_step),
            name=f"serve-worker-{wid}r{self.n_respawns}", daemon=True)
        self._threads[wid] = t
        t.start()
        return t

    def _supervise(self) -> None:
        """Watch the fleet: reap/requeue/respawn crashed workers; return
        once every worker slot is dead and handled (batch mode: idle
        exits; persistent mode: after ``drain`` sets the stop)."""
        while True:
            n_alive = 0
            for wid in range(self.n_workers):
                t = self._threads[wid]
                if t is None:
                    continue
                if t.is_alive():
                    n_alive += 1
                    continue
                t.join()  # dead: join BEFORE touching its state (reap safety)
                self._threads[wid] = None
                exc = self._worker_excs[wid]
                self._worker_excs[wid] = None
                if exc is None:
                    continue  # clean idle/stop exit
                if self._handle_crash(wid, exc) is not None:
                    n_alive += 1
            if n_alive == 0:
                return
            time.sleep(self.supervise_poll_s)

    def serve(self) -> Dict[str, object]:
        """Batch mode: run all submitted requests to completion; returns
        merged stats.

        Spawns the workers and supervises them inline — crashed workers
        are reaped, their in-flight requests requeued, and replacements
        respawned — then runs the final era-progress-bounded drain on one
        tid.  On an UNRECOVERABLE error the drain still runs and the
        merged stats land in ``partial_stats`` before the raise.
        """
        self._stop.clear()  # fresh run; serve() may be called repeatedly
        t0 = time.perf_counter()
        self._threads = self._spawn(exit_when_idle=True)
        self._supervise()
        serve_dt = time.perf_counter() - t0  # tokens are all produced here
        # drain UNCONDITIONALLY: even the error path must reap every
        # reclaimable block and account what completed (satellite fix —
        # the old path raised before draining and leaked the run)
        unreclaimed = self.engine.drain(self._drain_tid())
        stats = self._stats(serve_dt, time.perf_counter() - t0, unreclaimed)
        if self.errors:
            self.partial_stats = stats
            raise self.errors[0]
        return stats

    # ------------------------------------------------------- persistent mode
    @property
    def running(self) -> bool:
        return any(t is not None and t.is_alive() for t in list(self._threads))

    @property
    def draining(self) -> bool:
        return self._draining

    def worker_status(self) -> List[Dict[str, object]]:
        """Per-worker liveness snapshot (the /healthz payload)."""
        out: List[Dict[str, object]] = []
        for wid in range(self.n_workers):
            t = self._threads[wid] if wid < len(self._threads) else None
            out.append({
                "wid": wid,
                "tid": self._tids[wid] if self._tids is not None else None,
                "alive": bool(t is not None and t.is_alive()),
                "steps": self.worker_steps[wid],
            })
        return out

    def start(self) -> "ServeRuntime":
        """Spawn persistent workers: idle workers park on the scheduler's
        condition and serve submissions as they arrive, until ``drain``.
        A supervisor thread watches the fleet and respawns crashed
        workers (see the module docstring)."""
        if self.running:
            raise RuntimeError("ServeRuntime is already running")
        with self._gate:
            self._draining = False
        self._stop.clear()
        self._t0 = time.perf_counter()
        self._threads = self._spawn(exit_when_idle=False)
        self._sup_thread = threading.Thread(
            target=self._supervise, name="serve-supervisor", daemon=True)
        self._sup_thread.start()
        return self

    def submit(self, prompt, max_new_tokens: int, slo: str = "interactive",
               on_token=None, on_finish=None):
        """Admission-gated submit (persistent mode; also safe in batch
        mode before ``serve``).  Raises once a drain has begun: the worker
        fleet is exiting, so a request queued now would never be served —
        rejecting loudly here is the fix for the silent-strand race."""
        with self._gate:
            if self._draining:
                raise RuntimeError(
                    "ServeRuntime is draining: submit rejected (the worker "
                    "fleet is shutting down; a request queued now would "
                    "never be served — retry against a restarted runtime)")
            return self.engine.submit(prompt, max_new_tokens, slo=slo,
                                      on_token=on_token, on_finish=on_finish)

    def cancel(self, req) -> bool:
        """Abandon a request; safe from any thread, draining included
        (cancellation helps a drain converge, so it is never gated)."""
        return self.engine.cancel(req)

    def drain(self, deadline_s: Optional[float] = None,
              poll_s: float = 0.002) -> Dict[str, object]:
        """Rolling drain: close admission, let in-flight work finish
        within ``deadline_s``, cancel what remains, stop the workers, and
        run the final reclamation drain.  Returns merged stats (including
        ``unreclaimed``, which MUST be 0 at a quiescent exit).

        State machine: ``accepting -> draining`` (atomic with the
        admission gate: every submit either happened-before this point or
        raises) ``-> deadline-cancel`` (optional: past ``deadline_s``
        every queued and active request is cancelled; queued ones finalize
        in place, active ones at their next tick/completion — pages
        release through the refcount/era path, never a force-retire)
        ``-> workers joined -> reclamation drain``.  The reclamation
        drain runs on EVERY exit path — an unrecoverable worker error
        raises only after it, with the stats in ``partial_stats``.
        """
        with self._gate:
            already = self._draining
            self._draining = True
        if already and not self.running:
            raise RuntimeError("ServeRuntime.drain: already drained")
        sched = self.engine.sched
        deadline = (None if deadline_s is None
                    else time.monotonic() + deadline_s)
        cancelled_at_deadline = 0
        while (sched.pending() or sched.active) and not self._stop.is_set():
            if deadline is not None and time.monotonic() > deadline:
                # past the deadline: abandon everything still in the house;
                # the workers keep ticking below, so every cancellation
                # finalizes (in-flight rows at their step's completion)
                for req in sched.queue + list(sched.active):
                    if self.cancel(req):
                        cancelled_at_deadline += 1
                deadline = None  # cancel once; keep waiting for quiescence
            time.sleep(poll_s)
        self._stop.set()
        with sched._work:  # wake parked workers to observe the stop
            sched._work.notify_all()
        sup = self._sup_thread
        if sup is not None:
            sup.join()  # the supervisor joins (and handles) every worker
            self._sup_thread = None
        else:
            for t in self._threads:
                if t is not None:
                    t.join()
        self._threads = []
        serve_dt = time.perf_counter() - getattr(self, "_t0",
                                                 time.perf_counter())
        unreclaimed = self.engine.drain(self._drain_tid())
        stats = self._stats(serve_dt, serve_dt, unreclaimed)
        stats["cancelled_at_deadline"] = cancelled_at_deadline
        if self.errors:
            self.partial_stats = stats
            raise self.errors[0]
        return stats

    # ----------------------------------------------------------------- stats
    def _stats(self, serve_dt: float, total_dt: float,
               unreclaimed: int) -> Dict[str, object]:
        stats: Dict[str, object] = dict(self.engine.sched.stats)
        stats["wall_s"] = serve_dt
        stats["total_wall_s"] = total_dt
        stats["unreclaimed"] = unreclaimed
        stats["n_workers"] = self.n_workers
        stats["worker_steps"] = list(self.worker_steps)
        stats["n_respawns"] = self.n_respawns
        stats["worker_crashes"] = len(self.crashed_tids)
        return stats
