"""Spans of the port's layers, stamped on the clock the device trace uses.

``span(name, **attrs)`` is a context manager that records one span: its
name, the thread it ran on, an id, the id of the span that encloses it on
the same thread (its cause), its start and end (``t0_ns``, ``t1_ns``) and
its attrs.  A finished span goes into a bounded ring of its thread's
(``RING`` spans; the oldest fall out); ``records()`` reads every thread's
ring, ``clear()`` empties them.  Nothing is written out.

Recording is on while ``enable()`` is in force, or on a thread while a
``torch.profiler`` profile records there.  Off, ``span()`` costs one check
and returns the shared no-op ``NOOP``: no clock read, no record.

The clock is ``time.time_ns()``: the profiler stamps its host events with
the real-time clock on Linux and converts the device's times to the same
base, so a span lies on a profile at ``(t_ns - trace_start_ns) / 1e3``
microseconds, the unit of the profile's ``time_range`` (``trace_start_ns``
is ``prof.profiler.kineto_results.trace_start_ns()``).

These spans are kept off the profiler's own timeline on purpose: the
profiler copies every host annotation it records onto the device timeline,
where it would read as device work.

Importing this module imports nothing of torch; the profiler's state is
read once torch is loaded.
"""

from __future__ import annotations

import itertools
import sys
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

__all__ = ["NOOP", "RING", "Span", "clear", "enable", "records", "span"]

#: spans each thread's ring holds
RING = 1 << 16

_forced = 0  # enable() contexts in force
_ids = itertools.count(1)
_local = threading.local()
_threads_lock = threading.Lock()
_threads: List["_Thread"] = []


def _profiler_on() -> bool:
    """Whether a ``torch.profiler`` profile records on this thread.  Until
    torch is imported no profile can; from then on the module-level name
    is rebound to torch's own check."""
    torch = sys.modules.get("torch")
    if torch is None:
        return False
    global _profiler_on
    _profiler_on = torch._C._autograd._profiler_enabled
    return _profiler_on()


class _Enabled:
    """``enable()``'s context: recording on every thread while in force."""

    def __enter__(self):
        global _forced
        with _threads_lock:
            _forced += 1
        return self

    def __exit__(self, *exc):
        global _forced
        with _threads_lock:
            _forced -= 1
        return False


def enable() -> _Enabled:
    """Record on every thread inside ``with enable():`` (contexts nest)."""
    return _Enabled()


class _Thread:
    """One thread's open spans (innermost last) and its ring."""

    __slots__ = ("thread", "name", "stack", "ring")

    def __init__(self):
        self.thread = threading.current_thread()
        self.name = self.thread.name
        self.stack: List[Span] = []
        self.ring: deque = deque(maxlen=RING)


def _state() -> _Thread:
    st = getattr(_local, "st", None)
    if st is None:
        st = _local.st = _Thread()
        with _threads_lock:
            _threads.append(st)
    return st


class Span:
    """A recording span, and after its end the record it leaves."""

    __slots__ = ("name", "thread", "id", "parent", "t0_ns", "t1_ns",
                 "attrs", "_st")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name = name
        self.attrs = attrs
        self.t0_ns = self.t1_ns = 0

    def __enter__(self) -> "Span":
        st = self._st = _state()
        self.thread = st.name
        self.id = next(_ids)
        self.parent = st.stack[-1].id if st.stack else None
        st.stack.append(self)
        self.t0_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.t1_ns = time.time_ns()
        st = self._st
        self._st = None
        st.stack.pop()
        st.ring.append(self)
        return False

    @property
    def seconds(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9


class _Noop:
    """The span ``span()`` returns while recording is off."""

    __slots__ = ()

    def __enter__(self) -> "_Noop":
        return self

    def __exit__(self, *exc) -> bool:
        return False


NOOP = _Noop()


def span(name: str, **attrs) -> Any:
    """A span named ``name`` with ``attrs`` while recording is on, else
    ``NOOP``."""
    if not (_forced or _profiler_on()):
        return NOOP
    return Span(name, attrs)


def records(name: Optional[str] = None) -> List[Span]:
    """Every thread's finished spans (those called ``name``, if given), by
    start."""
    with _threads_lock:
        rings = [st.ring for st in _threads]
    out = [r for ring in rings for r in list(ring)
           if name is None or r.name == name]
    out.sort(key=lambda r: r.t0_ns)
    return out


def clear() -> None:
    """Empty every ring and forget the threads that have ended."""
    with _threads_lock:
        for st in _threads:
            st.ring.clear()
        _threads[:] = [st for st in _threads if st.thread.is_alive()]
