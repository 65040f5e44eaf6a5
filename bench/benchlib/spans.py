"""The program's own spans, stamps and counters, read by the per-layer
metrics that rest on them: ``repro_torch.obs``'s spans placed on the
profile's clock, ``Request.t_admit`` and ``t_prefill``, and the
scheduler's ``tokens_live``, ``tokens_computed`` and per-kind step
dispatches and times.

A span of the program is stamped with ``time.time_ns()``, the clock the
profiler stamps its host events with, so it lies on the profile at
``(t_ns - trace_start_ns) / 1e3`` microseconds, the unit of the profile's
``time_range``; here in seconds, as ``trace.Trace`` keeps the device's
intervals.  The program records while the profiler records on its thread,
so the profiled sub-window's spans are there after a ``--trace 1`` run.

A program without these (one older than its tracing module) gives every
reader here ``None``, and the metric is left out of the result.
"""

from __future__ import annotations

import bisect
import math
from typing import Dict, List, Optional

from .common import idle_gaps, percentile

#: the spans in which the worker waits, for the card or for work: a device
#: gap whose middle lies in one of these (innermost) was not the host's
WAIT_SPANS = ("engine.wait", "worker.park")

#: the requests the stamp waits read are those due this long before the
#: profiler's start: a choice by due time alone, longer than every p95 of
#: admission plus prefill wait the serving cells have shown (chat's some
#: 2.4 s), so that few of the waits it keeps run into the start's stall
MARGIN_S = 4.0

#: fewest steps of a kind a mean step time is read from
MIN_STEPS = 20


class Placed:
    """One span of the program on the profile's clock, in seconds."""

    __slots__ = ("name", "id", "parent", "a", "b", "attrs")

    def __init__(self, rec, start_ns: int):
        self.name, self.id, self.parent = rec.name, rec.id, rec.parent
        self.a = (rec.t0_ns - start_ns) / 1e9
        self.b = (rec.t1_ns - start_ns) / 1e9
        self.attrs = rec.attrs

    @property
    def seconds(self) -> float:
        return self.b - self.a


def program_records() -> Optional[list]:
    """The program's finished spans; None where it has no tracing module."""
    try:
        from repro_torch import obs
    except ImportError:
        return None
    return obs.records()


def place(records, prof) -> Optional[List[Placed]]:
    """``records`` that lie inside the profile ``prof``, on its clock; None
    where there are no records or no profile."""
    if records is None or prof is None:
        return None
    try:
        start_ns = prof.profiler.kineto_results.trace_start_ns()
    except AttributeError:
        return None
    ends = [e.time_range.end / 1e6 for e in prof.events()]
    end = max(ends) if ends else 0.0
    out = [Placed(r, start_ns) for r in records]
    return [p for p in out if p.a >= 0.0 and p.b <= end]


def spans(run) -> Optional[List[Placed]]:
    """The program's spans of the run's profiled sub-window (cached on
    the run)."""
    if not hasattr(run, "_spans"):
        run._spans = place(program_records(), getattr(run, "profile", None))
    return run._spans


# ------------------------------------------------------------- serving
def profile_start(run) -> float:
    """When the profiler's start began to hold the worker, on the
    monotonic clock of the request stamps: the end of the last step before
    the profiled sub-window (``inf`` where nothing was profiled)."""
    pw = getattr(run, "prof_window", None)
    if not pw or pw[0] is None:
        return math.inf
    ends = [s.t1 for s in getattr(run, "steps", ()) if s.t1 <= pw[0]]
    return run.t0 + (max(ends, default=pw[0]) - run.perf_t0)


def _stamp_wait_p95_ms(run, since: str, until: str) -> Optional[float]:
    """p95 (nearest rank) of the time from each request's stamp ``since``
    to its stamp ``until``, ms, over the requests sent in the window and
    due ``MARGIN_S`` or more before the profiler's start held the worker
    (the start and stop hold the host for seconds); every wait of those
    counts as it was, one that ran into the stall too, and a request never
    stamped (refused, never admitted) counts infinite."""
    reqs = [s.req for s in run.sent]
    if not reqs or not any(hasattr(r, until) for r in reqs if r is not None):
        return None
    cut = profile_start(run) - MARGIN_S
    waits = []
    for s in run.sent:
        if s.due >= cut:
            continue
        r = s.req
        a = None if r is None else getattr(r, since, None)
        b = None if r is None else getattr(r, until, None)
        waits.append(math.inf if a is None or b is None else 1e3 * (b - a))
    return percentile(waits, 95) if waits else None


def queue_wait_p95_ms(run) -> Optional[float]:
    return _stamp_wait_p95_ms(run, "t_submit", "t_admit")


def prefill_wait_p95_ms(run) -> Optional[float]:
    return _stamp_wait_p95_ms(run, "t_admit", "t_prefill")


def step_ms(run, kind: str) -> Optional[float]:
    """Mean time of the steps of ``kind`` from dispatch to sampled ids on
    the host (``engine.step`` less ``Scheduler.complete``), ms, from the
    scheduler's ``<kind>_ns`` and ``<kind>_dispatches`` between the
    harness's two stats snapshots (window and drain); None under
    ``MIN_STEPS`` steps."""
    try:
        before, after = run.stats_before, run.stats_after
        n = after[kind + "_dispatches"] - before[kind + "_dispatches"]
        ns = after[kind + "_ns"] - before[kind + "_ns"]
    except (AttributeError, KeyError):
        return None
    return ns / n / 1e6 if n >= MIN_STEPS else None


def decode_step_ms(run) -> Optional[float]:
    return step_ms(run, "decode")


def mixed_step_ms(run) -> Optional[float]:
    return step_ms(run, "mixed")


def useful_token_pct(run) -> Optional[float]:
    """Query tokens of live rows over the tokens the padded steps computed,
    between the harness's two stats snapshots, %."""
    try:
        before, after = run.stats_before, run.stats_after
        live = after["tokens_live"] - before["tokens_live"]
        computed = after["tokens_computed"] - before["tokens_computed"]
    except KeyError:
        return None
    return 100.0 * live / computed if computed > 0 else None


class Innermost:
    """The innermost span at each moment of spans that nest (one thread's:
    of those covering a moment, the one that started last)."""

    def __init__(self, sp: List[Placed]):
        self.times: List[float] = []
        self.spans: List[Optional[Placed]] = []
        active: Dict[int, Placed] = {}
        # at one moment ends sort before starts
        for t, start, i in sorted([(p.a, 1, i) for i, p in enumerate(sp)]
                                  + [(p.b, 0, i) for i, p in enumerate(sp)]):
            if start:
                active[i] = sp[i]
            else:
                active.pop(i, None)
            inner = max(active.values(), key=lambda p: p.a, default=None)
            if self.times and self.times[-1] == t:
                self.spans[-1] = inner
            else:
                self.times.append(t)
                self.spans.append(inner)

    def at(self, t: float) -> Optional[Placed]:
        i = bisect.bisect_right(self.times, t) - 1
        return self.spans[i] if i >= 0 else None


def profiled_gaps(run):
    """(the device-idle gaps of the profiled sub-window between its first
    and last device interval, the sub-window's length, its spans, their
    ``Innermost``), or None."""
    from .layers import trace
    tr, sp = trace(run), spans(run)
    if tr is None or not tr.kernels or tr.window_s <= 0 or not sp:
        return None
    lo = min(a for _, a, _ in tr.kernels)
    hi = max(b for _, _, b in tr.kernels)
    gaps = idle_gaps(((a, b) for _, a, b in tr.kernels), lo, hi)
    return gaps, tr.window_s, sp, Innermost(sp)


def idle_in_host_pct(run) -> Optional[float]:
    """Device-idle time of the profiled sub-window whose middle lies in a
    span of the program other than its waits (the innermost span there
    exists and is not one of ``WAIT_SPANS``), over the sub-window's
    length, %."""
    got = profiled_gaps(run)
    if got is None:
        return None
    gaps, window_s, _, inner = got

    def in_host(p: Optional[Placed]) -> bool:
        return p is not None and p.name not in WAIT_SPANS

    idle = sum(b - a for a, b in gaps if in_host(inner.at((a + b) / 2)))
    return 100.0 * idle / window_s


# ------------------------------------------------------------ training
def data_wait_ms_per_step(run) -> Optional[float]:
    """The profiled steps' ``train.data`` time (the wait for the next
    batch) over the number of ``train.step`` spans, ms."""
    sp = spans(run)
    if not sp:
        return None
    n = sum(p.name == "train.step" for p in sp)
    if n == 0:
        return None
    return 1e3 * sum(p.seconds for p in sp if p.name == "train.data") / n
