"""Paged serving: the engine and its device steps over the paged KV pool,
the multi-worker crash-tolerant runtime, fault injection and the SSE
front-end."""

from .engine import ServeEngine
from .faults import CRASH_POINTS, FaultInjector, FaultSpec, InjectedCrash
from .frontend import Frontend
from .paged_model import (init_mla_pools, init_pools, paged_decode_step,
                          paged_mixed_step, paged_mla_decode_step,
                          paged_prefill_chunk)
from .runtime import ServeRuntime

__all__ = ["ServeEngine", "ServeRuntime", "Frontend", "init_pools",
           "paged_decode_step", "paged_prefill_chunk", "paged_mixed_step",
           "init_mla_pools",
           "paged_mla_decode_step", "FaultSpec",
           "FaultInjector", "InjectedCrash", "CRASH_POINTS"]
