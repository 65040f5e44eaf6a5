"""Paged serving: the engine and its device steps over the paged KV pool,
the multi-worker crash-tolerant runtime, fault injection and the SSE
front-end."""

from .engine import ServeEngine
from .faults import CRASH_POINTS, FaultInjector, FaultSpec, InjectedCrash
from .frontend import Frontend
from .paged_model import init_pools, paged_decode_step, paged_prefill_chunk
from .runtime import ServeRuntime

__all__ = ["ServeEngine", "ServeRuntime", "Frontend", "init_pools",
           "paged_decode_step", "paged_prefill_chunk", "FaultSpec",
           "FaultInjector", "InjectedCrash", "CRASH_POINTS"]
