"""The serving driver: one run of a serving cell against ``repro_torch``.

Set-up builds the weights from the seed, one ``ServeEngine`` at the
configuration's deployment (pool, batch, chunk, scheme) and a one-worker
``ServeRuntime``, and warms up every step signature the cell's traffic can
reach (``warm_up``).  The window then sends the generated requests through
``ServeRuntime.submit`` at their due times (open loop), stamps every
output token, and closes after ``seconds``.  The requests sent in the
window are then served to completion, under the mix's ``drain_s``.  The
runtime's drain reclaims the pool.

Harness spans wrap the calls into each layer of the program (``Probe``):
``Scheduler.tick``, ``ServeEngine.execute_plan`` (dispatch to the sampled
ids, then ``Scheduler.complete``) and the pool's ``cleanup``.  With
``trace`` a bounded steady sub-window of steps runs under
``torch.profiler``.
"""

from __future__ import annotations

import gc
import math
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from . import weights


def pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def arch_config(arch: dict):
    """``repro_torch``'s ``ArchConfig`` for the file's ``arch`` block."""
    from repro_torch.models.common import ArchConfig
    kw = dict(arch)
    kw["block_pattern"] = tuple(kw["block_pattern"])
    for key in ("dtype", "param_dtype"):
        if key in kw:
            kw[key] = weights.DTYPES[kw[key]]
    return ArchConfig(**kw)


# ------------------------------------------------------------------ probe
@dataclass
class Step:
    kind: str
    q: np.ndarray  # query tokens per live row (1 for a decode row)
    ctx: np.ndarray  # context per live row, this step's tokens included
    t0: float = 0.0
    t1: float = 0.0
    tick_s: float = 0.0
    complete_s: float = 0.0
    cleanup_s: float = 0.0
    profiled: bool = False
    blocks_in_use: int = 0  # pool blocks held (live rows and the cache)
    tables: Optional[np.ndarray] = None  # the plan's tables, profiled steps

    def kv_pages(self, bs: int) -> int:
        """Distinct KV pages the step's attention reads: each row's first
        ``ceil(ctx / bs)`` table entries, a page aliased by several rows
        (a shared prefix) counted once."""
        n = -(-self.ctx // bs)
        return int(np.unique(np.concatenate(
            [self.tables[i, :k] for i, k in enumerate(n)])).size)


class Probe:
    """Harness spans around the program's layer calls, on in the window.

    Instance attributes shadow the engine's, scheduler's and pool's
    methods, so the program's own calls go through the wrappers."""

    def __init__(self, engine, *, profile_at: Optional[float] = None,
                 profile_s: float = 3.0, profile_steps: int = 60):
        self.engine = engine
        self.on = False
        self.steps: List[Step] = []
        self._local = threading.local()
        self.profile_at = profile_at  # monotonic time to start, or None
        self.profile_s = profile_s
        self.profile_steps = profile_steps
        self.n_blocks = engine.n_blocks
        self.prof = None
        self.prof_window = None  # (t_start, t_stop) host clock
        self._prof_n = 0
        self._prof_done = False
        sched, pool = engine.sched, engine.pool
        self._tick, self._complete = sched.tick, sched.complete
        self._cleanup, self._execute = pool.cleanup, engine.execute_plan
        sched.tick = self.tick
        sched.complete = self.complete
        pool.cleanup = self.cleanup
        engine.execute_plan = self.execute_plan

    def _label(self, name: str):
        if self.prof is not None:
            return torch.profiler.record_function("bench." + name)
        return _NULL

    def tick(self, tid):
        t0 = time.perf_counter()
        with self._label("tick"):
            plan = self._tick(tid)
        if self.on and plan is not None:
            self._local.tick_s = time.perf_counter() - t0
        return plan

    def complete(self, plan, sampled, tid, failed_rows=None):
        self._local.cleanup_s = 0.0
        t0 = time.perf_counter()
        with self._label("complete"):
            self._complete(plan, sampled, tid, failed_rows=failed_rows)
        self._local.complete_s = time.perf_counter() - t0

    def cleanup(self, tid, **kw):
        t0 = time.perf_counter()
        with self._label("cleanup"):
            n = self._cleanup(tid, **kw)
        self._local.cleanup_s = (getattr(self._local, "cleanup_s", 0.0)
                                 + time.perf_counter() - t0)
        return n

    def execute_plan(self, plan, tid):
        if not self.on:
            return self._execute(plan, tid)
        self._maybe_start_profile()
        rec = _step_of(plan)
        rec.tick_s = getattr(self._local, "tick_s", 0.0)
        rec.profiled = self.prof is not None
        if rec.profiled:
            rec.tables = plan.tables
        rec.blocks_in_use = self.n_blocks - self.engine.pool.free_blocks
        rec.t0 = time.perf_counter()
        with self._label("step"):
            out = self._execute(plan, tid)
        rec.t1 = time.perf_counter()
        rec.complete_s = getattr(self._local, "complete_s", 0.0)
        rec.cleanup_s = getattr(self._local, "cleanup_s", 0.0)
        self.steps.append(rec)
        if self.prof is not None:
            self._prof_n += 1
            self._maybe_stop_profile()
        return out

    # the profiler runs on the worker's thread, between two steps
    def _maybe_start_profile(self):
        if (self.profile_at is None or self._prof_done or self.prof is not None
                or time.monotonic() < self.profile_at):
            return
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        torch.cuda.synchronize()
        self.prof_window = [time.perf_counter(), None]

    def _maybe_stop_profile(self):
        if (self._prof_n < self.profile_steps and
                time.perf_counter() - self.prof_window[0] < self.profile_s):
            return
        torch.cuda.synchronize()
        self.prof_window[1] = time.perf_counter()
        prof, self.prof = self.prof, None
        prof.stop()
        self._stopped = prof
        self._prof_done = True

    def remove(self) -> None:
        """Put the program's own methods back."""
        for obj, name in ((self.engine.sched, "tick"),
                          (self.engine.sched, "complete"),
                          (self.engine.pool, "cleanup"),
                          (self.engine, "execute_plan")):
            obj.__dict__.pop(name, None)

    @property
    def profile(self):
        return getattr(self, "_stopped", None)


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def _step_of(plan) -> Step:
    """Live rows of a plan: their query tokens and contexts."""
    ctx = np.asarray(plan.lengths, dtype=np.int64)
    if plan.kind == "decode":
        q = np.ones(len(ctx), dtype=np.int64)
    elif plan.kind == "prefill":
        q = np.array([plan.n_tokens], dtype=np.int64)
    else:
        q = np.asarray(plan.chunk_lens, dtype=np.int64)
    return Step(plan.kind, q, ctx)


# ---------------------------------------------------------------- warm-up
def signatures(space: List[dict], *, bs: int, chunk: int) -> dict:
    """The step shapes a mix reaches, as the engine buckets them: table
    widths ``pow2(ceil((prompt + output) / bs))`` of prefill-only chunks,
    with each chunk's ``pow2`` bucket; the widest width (every decode and
    mixed step runs at it once a request has reached it); every chunk
    bucket up to ``chunk``."""
    prefill = set()
    w_hi = 1
    for s in space:
        p_lo, p_hi = s["prompt"]
        n_lo, n_hi = s["output"]
        for p in range(p_lo, p_hi + 1):
            cbs = set()
            for h in s["cached"]:
                rest = p - h
                if rest <= 0:
                    continue
                if rest > chunk:
                    cbs.add(chunk)
                cbs.add(pow2(rest - chunk * ((rest - 1) // chunk)))
            w_lo = pow2(math.ceil((p + n_lo) / bs))
            w_top = pow2(math.ceil((p + n_hi) / bs))
            w = w_lo
            while w <= w_top:
                prefill.update((w, cb) for cb in cbs)
                w *= 2
            w_hi = max(w_hi, w_top)
    buckets = sorted({pow2(c) for c in range(1, chunk + 1)})
    return {"prefill": sorted(prefill), "w_hi": w_hi, "buckets": buckets}


def warm_up(engine, sigs: dict, rng: np.random.Generator, vocab: int) -> int:
    """Dispatch every signature of ``sigs`` once, before the window, so
    each is captured (eager step, then the CUDA graph) in set-up.  Single
    thread, through ``ServeEngine.step``: (1) a request whose final width
    is the widest decodes while one request per chunk bucket prefills
    beside it (the decode and mixed steps); (2) with nothing decoding, one
    request per (width, bucket) runs its chunk alone (the prefill-only
    steps), and each is cancelled at its first token.  The prefix cache
    and the pool are drained after.  Returns the signatures dispatched."""
    bs = engine.block_size
    tid = engine.pool.register_thread()

    def tokens(n):
        return rng.integers(0, vocab, size=n).tolist()

    def step_until(cond, limit=100_000):
        for _ in range(limit):
            if cond():
                return
            if not engine.step(tid):
                engine.pool.cleanup_all()
        raise RuntimeError("warm-up did not reach its step")

    def width_tokens(w, p):
        """Output tokens giving a request of prompt ``p`` the width ``w``."""
        return max(1, bs * (w // 2) + 1 - p)

    w_hi = sigs["w_hi"]
    long = engine.submit(tokens(16), width_tokens(w_hi, 16))
    step_until(lambda: len(long.generated) >= 2)
    for cb in sigs["buckets"]:
        r = engine.submit(tokens(cb), 1)
        step_until(lambda: r.state == "done")
    engine.cancel(long)
    step_until(lambda: long.state == "cancelled")
    for w, cb in sigs["prefill"]:
        p = cb // 2 + 1 if cb > 1 else 1  # the shortest chunk of bucket cb
        n = width_tokens(w, p)
        if p + n > bs * w:
            continue  # no request of this mix has both
        r = engine.submit(tokens(p), n)
        step_until(lambda: len(r.generated) >= 1)
        engine.cancel(r)  # a request of one output token is done already
        step_until(lambda: r.state in ("cancelled", "done"))
    engine.drain(tid)
    if engine.pool.unreclaimed() != 0:
        raise RuntimeError("warm-up left blocks unreclaimed")
    return engine.compile_cache_size()


def fill_prefix_cache(engine, prompts, tid: Optional[int] = None) -> None:
    """Serve each prompt once (one output token), so the prefix cache
    holds it when the window opens (on ``tid``, or a newly registered
    one)."""
    if not prompts:
        return
    if tid is None:
        tid = engine.pool.register_thread()
    reqs = [engine.submit(p, 1) for p in prompts]
    while any(r.state not in ("done",) for r in reqs):
        if not engine.step(tid):
            if any(r.state in ("failed", "cancelled") for r in reqs):
                raise RuntimeError("a preloaded prompt was not served")
            engine.pool.cleanup_all()
    engine.pool.cleanup(tid)


# ----------------------------------------------------------------- window
@dataclass
class Sent:
    due: float  # monotonic time the request was due
    prompt: List[int]
    max_new: int
    prefix: int
    submitted: float = 0.0
    req: object = None
    stamps: List[float] = field(default_factory=list)
    refused: bool = False


@dataclass
class ServeRun:
    """What one serving run measured; the metric readers read it."""
    cell: str
    arch: dict
    deploy: dict
    setup_s: float
    t0: float  # window opens (monotonic)
    t1: float  # window closes
    sent: List[Sent]
    steps: List[Step]
    stats_before: Dict[str, int]
    stats_after: Dict[str, int]
    captures_before: int
    captures_after: int
    profile: object = None
    prof_window: Optional[list] = None

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def window_steps(self) -> List[Step]:
        """Steps dispatched inside the window before the profiled
        sub-window, if any: the profiler's start and stop hold the host
        for seconds, and at 0.8 of the knee the backlog that builds takes
        the rest of the window to clear, so the steps after it stand for
        no untraced run."""
        t0, t1 = self.perf_t0, self.perf_t1
        if self.prof_window is not None and self.prof_window[0] is not None:
            t1 = min(t1, self.prof_window[0])
        return [s for s in self.steps if t0 <= s.t0 < t1 and not s.profiled]


def build_engine(cfg_file: dict, params, device):
    from repro_torch.serve.engine import ServeEngine
    d = cfg_file["serve"]
    cuda = torch.device(device).type == "cuda"
    return ServeEngine(
        arch_config(cfg_file["arch"]), params, n_blocks=d["n_blocks"],
        block_size=d["block_size"], max_batch=d["max_batch"],
        scheme=d["scheme"], use_kernel=bool(d["use_kernel"]) and cuda,
        n_shards=d.get("n_shards", 1), chunk_size=d["chunk_size"],
        kv_dtype=d["kv_dtype"], device=device)


def run(cell_name: str, cfg_file: dict, traffic: dict, gen, *, seed: int,
        seconds: float, trace: bool, device, t_start: float) -> "ServeRun":
    """One run of a serving cell; see the module docstring.  The engine is
    freed before this returns; the weights stay (``run.params``)."""
    arch = cfg_file["arch"]
    d = cfg_file["serve"]
    params = weights.make_params(arch, seed, device)
    engine = build_engine(cfg_file, params, device)
    sigs = signatures(gen.length_space(traffic), bs=d["block_size"],
                      chunk=d["chunk_size"])
    t_warm = time.monotonic()
    n_sigs = warm_up(engine, sigs,
                     np.random.default_rng([int(seed) & 0xFFFFFFFF, 7]),
                     arch["vocab_size"])
    t_warm = time.monotonic() - t_warm
    preload = getattr(gen, "preload", None)
    if preload is not None:
        fill_prefix_cache(engine, preload(traffic, seed, arch["vocab_size"]))
    reqs = gen.requests(traffic, seed, seconds, arch["vocab_size"])
    out = serve_window(cell_name, cfg_file, traffic, gen, engine, reqs,
                       seconds=seconds, trace=trace, device=device,
                       t_start=t_start)
    out.params = params
    out.warmup = (t_warm, n_sigs)
    free_engine(engine)
    return out


def free_engine(engine) -> None:
    engine.clear_compile_caches()
    engine._shard_pools = []
    del engine
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def serve_window(cell_name, cfg_file, traffic, gen, engine, reqs, *, seconds,
                 trace, device, t_start, runtime=None):
    """Open the window on a warmed engine, send ``reqs``, close it, serve
    what is left and drain the runtime (``runtime``, or a new
    ``ServeRuntime``; a drained runtime starts again)."""
    cuda = torch.device(device).type == "cuda"
    if runtime is None:
        from repro_torch.serve.runtime import ServeRuntime
        runtime = ServeRuntime(engine, n_workers=cfg_file["serve"].get(
            "n_workers", 1))
    probe = Probe(engine)
    stats_before = dict(engine.sched.stats)
    captures_before = engine.compile_cache_size()
    shapes_before = set(getattr(engine, "_shapes", ()))
    sent: List[Sent] = []

    def on_token(req, index, tok, rec=None):
        if index == len(rec.stamps):
            rec.stamps.append(time.monotonic())

    def submit(r, due):
        rec = Sent(due, r["prompt"], r["max_new"], r["prefix"])
        sent.append(rec)
        rec.submitted = time.monotonic()
        try:
            rec.req = runtime.submit(
                r["prompt"], r["max_new"],
                on_token=lambda req, k, t, rec=rec: on_token(req, k, t, rec))
        except RuntimeError:
            rec.refused = True
        return rec

    runtime.start()
    if cuda:
        torch.cuda.synchronize()
    t0 = time.monotonic()
    perf_t0 = time.perf_counter()
    if trace:
        probe.profile_at = t0 + 0.7 * seconds
    probe.on = True
    t1 = t0 + seconds
    for r in reqs:
        due = t0 + r["due"]
        if due >= t1:
            break
        wait = due - time.monotonic()
        if wait > 0:
            time.sleep(wait)
        submit(r, due)
    wait = t1 - time.monotonic()
    if wait > 0:
        time.sleep(wait)
    t_close = time.monotonic()
    perf_t1 = time.perf_counter()
    captures_after = engine.compile_cache_size()
    new_shapes = sorted(map(str, set(getattr(engine, "_shapes", ()))
                            - shapes_before))
    deadline = t_close + float(traffic["drain_s"])
    while time.monotonic() < deadline and any(
            s.req is not None and s.req.state in ("queued", "active")
            for s in sent):
        time.sleep(0.01)
    probe.on = False
    stats = runtime.drain(deadline_s=0.0)
    probe.remove()
    if cuda:
        torch.cuda.synchronize()
    stats_after = dict(engine.sched.stats)
    run = ServeRun(cell_name, cfg_file["arch"], cfg_file["serve"],
                   setup_s=t0 - t_start, t0=t0, t1=t_close, sent=sent,
                   steps=probe.steps,
                   stats_before=stats_before, stats_after=stats_after,
                   captures_before=captures_before,
                   captures_after=captures_after, profile=probe.profile,
                   prof_window=probe.prof_window)
    run.perf_t0, run.perf_t1 = perf_t0, perf_t1
    run.new_shapes = new_shapes
    run.unreclaimed = int(stats["unreclaimed"])
    run.free_missing = int(engine.n_blocks - engine.pool.free_blocks)
    run.lateness = [s.submitted - s.due for s in sent]
    return run


# ------------------------------------------------------------- correctness
def finished(run: ServeRun) -> List[Sent]:
    return [s for s in run.sent if s.req is not None and s.req.state == "done"
            and len(s.req.generated) == s.max_new]


def failed(run: ServeRun) -> List[Sent]:
    """Requests sent in the window that were refused, failed, or not
    served in full by the drain deadline."""
    bad = []
    for s in run.sent:
        if s.refused or s.req is None:
            bad.append(s)
        elif s.req.state == "failed":
            bad.append(s)
        elif s.req.state == "cancelled":
            bad.append(s)
        elif s.req.state == "done" and len(s.req.generated) != s.max_new:
            bad.append(s)
    return bad


def sample(run: ServeRun, seed: int, tokens: int, requests: int = 4
           ) -> List[Sent]:
    """Finished requests drawn from the seed until ``tokens`` served tokens
    and ``requests`` requests are in, the longest (prompt plus output)
    among them first."""
    done = finished(run)
    if not done:
        return []
    longest = max(done, key=lambda s: len(s.prompt) + s.max_new)
    rest = [s for s in done if s is not longest]
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, 5])
    out, n = [longest], longest.max_new
    for i in rng.permutation(len(rest)):
        if n >= tokens and len(out) >= requests:
            break
        out.append(rest[i])
        n += rest[i].max_new
    return out


def served_gaps(arch: dict, params, picked: List[Sent], eps: float,
                quant: Optional[str] = None) -> List[float]:
    """Per picked request, the widest gap by which a served token's
    reference logit lies below the reference's best at its position
    (``quant`` set: the gap of the token the lower precision puts first)."""
    from . import reference
    out = []
    for s in picked:
        gen = list(s.req.generated)
        seq = list(s.prompt) + gen[:-1]
        at = list(range(len(s.prompt) - 1, len(seq)))
        ref = reference.logits_at(arch, params, seq, at, eps=eps)
        if quant is None:
            chosen = torch.as_tensor(gen, device=ref.device)
        else:
            low = reference.logits_at(arch, params, seq, at, eps=eps,
                                      quant=quant)
            chosen = low.argmax(-1)
            del low
        best = ref.max(-1).values
        got = ref.gather(1, chosen[:, None].long())[:, 0]
        out.append(float((best - got).max()))
        del ref
    return out


def checks(run: ServeRun, seed: int, cfg_file: dict) -> dict:
    """The numbers that decide ``correct``, each with its limit: every
    request served in full, the pool drained with every block free, and
    the widest gap of a served token under the f32 reference's best over
    a sample of ``check.tokens`` served tokens."""
    limits = cfg_file["serve"]["check"]
    picked = sample(run, seed, int(limits["tokens"]),
                    int(limits.get("requests", 4)))
    t0 = time.perf_counter()
    gaps = served_gaps(run.arch, run.params, picked, cfg_file["norm_eps"])
    run.reference_s = time.perf_counter() - t0
    out = {"failed": (len(failed(run)), 0),
           "unreclaimed": (run.unreclaimed, 0),
           "blocks_not_free": (run.free_missing, 0),
           "sampled_tokens": (sum(s.max_new for s in picked),
                              int(limits["tokens"])),
           "max_gap": (max(gaps) if gaps else math.inf,
                       float(limits["max_gap"]))}
    return out


def is_correct(c: dict) -> bool:
    return (c["failed"][0] == 0 and c["unreclaimed"][0] == 0
            and c["blocks_not_free"][0] == 0
            and c["sampled_tokens"][0] >= c["sampled_tokens"][1]
            and c["max_gap"][0] <= c["max_gap"][1])


def attempted(run: ServeRun) -> int:
    return len(run.sent)


def n_failed(run: ServeRun) -> int:
    return len(failed(run))


def report(run: ServeRun) -> List[str]:
    """Lines for standard error: requests, the generator's lateness, the
    steps, their live rows and the pool's occupancy, and the drain."""
    late = sorted(run.lateness) or [0.0]
    done = finished(run)
    lines = [f"requests sent {len(run.sent)}, finished {len(done)}, failed "
             f"{len(failed(run))}; window {run.window_s:.3f} s, setup "
             f"{run.setup_s:.3f} s",
             f"send lateness median {1e3 * late[len(late) // 2]:.3f} ms, max "
             f"{1e3 * late[-1]:.3f} ms",
             f"steps in window {len(run.window_steps())} "
             f"(profiled {sum(s.profiled for s in run.steps)}), captures in "
             f"window {run.captures_after - run.captures_before} "
             f"{run.new_shapes}"]
    steps = [s for s in run.steps
             if run.perf_t0 <= s.t0 < run.perf_t1]
    if steps:
        rows = np.array([len(s.ctx) for s in steps])
        kinds = {k: sum(s.kind == k for s in steps)
                 for k in ("decode", "mixed", "prefill")}
        held = np.array([s.blocks_in_use for s in run.steps])
        n, bs = run.deploy["n_blocks"], run.deploy["block_size"]
        lines.append(f"live rows a step in the window: mean "
                     f"{rows.mean():.2f}, max "
                     f"{rows.max()}; steps {kinds}")
        lines.append(f"pool blocks in use (live rows and the prefix "
                     f"cache, window and drain): peak {held.max()} of {n} "
                     f"({100.0 * held.max() / n:.1f}%, {held.max() * bs} "
                     f"tokens), mean {held.mean():.1f}")
    if run.prof_window is not None and run.prof_window[1] is not None:
        a, b = run.prof_window
        steps = run.window_steps()
        before = [s for s in steps if s.t1 <= a]
        after = [s for s in steps if s.t0 >= b]
        rate = lambda ss: (len(ss) / (ss[-1].t1 - ss[0].t0)
                           if len(ss) > 1 else float("nan"))
        lines.append(f"steps/s before the profiled sub-window "
                     f"{rate(before):.3f}, after {rate(after):.3f}; "
                     f"profiled {b - a:.3f} s")
    if hasattr(run, "warmup"):
        lines.append(f"warm-up {run.warmup[0]:.3f} s, {run.warmup[1]} step "
                     "signatures")
    return lines
