"""Paged KV-cache block pool with SMR reclamation (WFE by default, or any
pool scheme of ``repro_torch.core``), the scheduler that hands out its
pages, and the refcounted prefix cache.  The sharded pool of
``repro.blocks`` is not ported yet."""

from .block_pool import BlockPool, KVBlock, PoolExhausted
from .block_table import BlockTableRef, TableVersion
from .prefix_cache import PrefixCache
from .scheduler import Request, Scheduler

__all__ = [
    "BlockPool",
    "BlockTableRef",
    "KVBlock",
    "PoolExhausted",
    "PrefixCache",
    "Request",
    "Scheduler",
    "TableVersion",
]
