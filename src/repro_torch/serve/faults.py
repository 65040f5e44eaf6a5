"""Deterministic, seeded fault injection for the serving runtime.

Ported from ``repro.serve.faults``.  Crash tolerance needs crashes that
are *reproducible*: "kill the 5th worker step" must mean the same thing
on every run and on every thread interleaving, or a failing chaos test
cannot be replayed.
The injector therefore keys every decision on a per-site **event
ordinal**, not on wall clock or thread identity: each fault site keeps
its own counter plus its own ``random.Random`` stream seeded from
``(seed, site)``, all under one lock, so the k-th event at a site draws
the k-th value of that stream no matter which worker observes it.

Fault sites
-----------

Worker crash points (named stages of ``ServeEngine.step``, the crash
taxonomy of the reference's docs/robustness.md):

* ``before_tick``            — before any planning: no pages, no plan;
* ``after_reservation``      — a plan exists and its slot reservation is
  published, but nothing was dispatched (the dead tid pins pages it
  never read);
* ``after_dispatch``         — the device step ran to completion (its
  sampled ids reached the host) but ``complete()`` never did: generated
  tokens are lost, rows are still marked in flight.

Plus two non-crash faults:

* allocation failure — ``BlockPool.alloc_blocks`` raises
  ``PoolExhausted`` even though blocks are free, exercising the
  eviction ladder;
* output poisoning — one sampled row of a dispatch is replaced with
  NaN, exercising the ``failed`` terminal path (graceful degradation:
  the request fails, the batch survives).

A crash is an :class:`InjectedCrash` raised in the worker thread; the
``ServeRuntime`` supervisor treats any worker exception the same way
(quarantine + reap + requeue + respawn), the subtype only lets tests and
counters tell injected faults from real bugs.
"""

from __future__ import annotations

import random
import threading
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from repro_torch.blocks.block_pool import PoolExhausted

__all__ = ["CRASH_POINTS", "FaultInjector", "FaultSpec", "InjectedCrash"]

#: named worker crash points, in step order
CRASH_POINTS = ("before_tick", "after_reservation", "after_dispatch")


class InjectedCrash(RuntimeError):
    """A deterministic injected worker death."""

    def __init__(self, point: str, tid: int, ordinal: int):
        super().__init__(
            f"injected crash at {point} (tid={tid}, event #{ordinal})")
        self.point = point
        self.tid = tid
        self.ordinal = ordinal


@dataclass(frozen=True)
class FaultSpec:
    """Declarative fault plan.  ``crash_at`` / ``*_at`` name exact event
    ordinals (0-based, per site) and always fire — the deterministic form
    tests use; the ``*_rate`` fields draw per-event from the site's
    seeded stream — the chaos form benchmarks use.  ``max_crashes``
    bounds TOTAL injected crashes (rate + ordinal combined) so an
    idle-spinning worker cannot burn the whole respawn budget."""

    seed: int = 0
    crash_rate: float = 0.0
    crash_points: Tuple[str, ...] = CRASH_POINTS
    crash_at: Tuple[Tuple[str, int], ...] = ()
    max_crashes: Optional[int] = None
    alloc_fail_rate: float = 0.0
    alloc_fail_at: Tuple[int, ...] = ()
    poison_rate: float = 0.0
    poison_at: Tuple[int, ...] = ()

    def __post_init__(self):
        for p in self.crash_points:
            if p not in CRASH_POINTS:
                raise ValueError(f"unknown crash point {p!r} "
                                 f"(one of {CRASH_POINTS})")
        for p, _ in self.crash_at:
            if p not in CRASH_POINTS:
                raise ValueError(f"unknown crash point {p!r} in crash_at")
        for name in ("crash_rate", "alloc_fail_rate", "poison_rate"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} = {v} outside [0, 1]")

    @classmethod
    def parse(cls, text: str) -> "FaultSpec":
        """Parse a ``--fault-spec`` string: comma-separated ``key=value``
        with ``|``-separated lists, e.g. ::

            seed=7,crash_rate=0.02,max_crashes=3
            crash_at=after_dispatch:5|before_tick:9,poison_at=4
            points=before_tick|after_dispatch,alloc_fail_rate=0.01
        """
        kw: Dict[str, object] = {}
        for part in filter(None, (p.strip() for p in text.split(","))):
            if "=" not in part:
                raise ValueError(f"fault-spec item {part!r} is not key=value")
            key, val = part.split("=", 1)
            key = key.strip()
            val = val.strip()
            if key == "points":
                kw["crash_points"] = tuple(val.split("|"))
            elif key == "crash_at":
                pairs = []
                for item in val.split("|"):
                    point, _, n = item.partition(":")
                    pairs.append((point, int(n)))
                kw["crash_at"] = tuple(pairs)
            elif key in ("alloc_fail_at", "poison_at"):
                kw[key] = tuple(int(x) for x in val.split("|"))
            elif key in ("seed", "max_crashes"):
                kw[key] = int(val)
            elif key in ("crash_rate", "alloc_fail_rate", "poison_rate"):
                kw[key] = float(val)
            else:
                raise ValueError(f"unknown fault-spec key {key!r}")
        return cls(**kw)


class FaultInjector:
    """Thread-safe deterministic fault source; one per engine run.

    Decisions are a pure function of (spec, site, event ordinal): the
    ordinal counters and the per-site RNG streams advance under one
    lock, so two runs of the same workload inject the same faults even
    when a different worker observes a given ordinal.
    """

    _SITES = CRASH_POINTS + ("alloc", "poison")

    def __init__(self, spec: Optional[FaultSpec] = None, **kwargs):
        if spec is None:
            spec = FaultSpec(**kwargs)
        elif kwargs:
            raise TypeError("pass a FaultSpec OR field kwargs, not both")
        self.spec = spec
        self._lock = threading.Lock()
        self._events: Dict[str, int] = {s: 0 for s in self._SITES}
        self._rngs = {s: random.Random(f"{spec.seed}:{s}")
                      for s in self._SITES}
        self._crash_at: Dict[str, set] = {}
        for point, n in spec.crash_at:
            self._crash_at.setdefault(point, set()).add(n)
        self.crashes: Dict[str, int] = {p: 0 for p in CRASH_POINTS}
        self.n_alloc_failures = 0
        self.n_poisoned = 0

    @property
    def n_crashes(self) -> int:
        return sum(self.crashes.values())

    # ------------------------------------------------------------- sites
    def crash_point(self, point: str, tid: int) -> None:
        """Worker crash site: raises :class:`InjectedCrash` when the
        spec selects this event; otherwise a cheap counter bump."""
        spec = self.spec
        with self._lock:
            ordinal = self._events[point]
            self._events[point] = ordinal + 1
            hit = ordinal in self._crash_at.get(point, ())
            if (spec.crash_rate > 0.0 and point in spec.crash_points
                    and self._rngs[point].random() < spec.crash_rate):
                hit = True
            if not hit:
                return
            if (spec.max_crashes is not None
                    and self.n_crashes >= spec.max_crashes):
                return
            self.crashes[point] += 1
        raise InjectedCrash(point, tid, ordinal)

    def alloc_gate(self, n: int, tid: int) -> None:
        """``BlockPool.alloc_blocks`` site: raises ``PoolExhausted`` when
        selected — upstream sees an ordinary exhaustion and runs the
        eviction ladder, which is exactly the point."""
        spec = self.spec
        with self._lock:
            ordinal = self._events["alloc"]
            self._events["alloc"] = ordinal + 1
            hit = ordinal in spec.alloc_fail_at
            if (spec.alloc_fail_rate > 0.0
                    and self._rngs["alloc"].random() < spec.alloc_fail_rate):
                hit = True
            if not hit:
                return
            self.n_alloc_failures += 1
        raise PoolExhausted(f"injected allocation failure "
                            f"(event #{ordinal}, {n} blocks, tid={tid})")

    def poison_row(self, n_rows: int) -> Optional[int]:
        """Dispatch-output site: returns the row index to replace with
        NaN for this dispatch, or None."""
        spec = self.spec
        with self._lock:
            ordinal = self._events["poison"]
            self._events["poison"] = ordinal + 1
            hit = ordinal in spec.poison_at
            if (spec.poison_rate > 0.0
                    and self._rngs["poison"].random() < spec.poison_rate):
                hit = True
            if not hit or n_rows <= 0:
                return None
            self.n_poisoned += 1
            return self._rngs["poison"].randrange(n_rows)

    # ------------------------------------------------------------- stats
    def stats(self) -> dict:
        with self._lock:
            return {
                "events": dict(self._events),
                "crashes": dict(self.crashes),
                "n_crashes": self.n_crashes,
                "n_alloc_failures": self.n_alloc_failures,
                "n_poisoned": self.n_poisoned,
            }
