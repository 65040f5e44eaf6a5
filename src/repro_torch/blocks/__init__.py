"""Paged KV-cache block pool with SMR reclamation (WFE by default, or any
pool scheme of ``repro_torch.core``), its sharded form (one SMR instance
per shard, clocks max-merged), the scheduler that hands out its pages, and
the refcounted prefix cache."""

from .block_pool import BlockPool, KVBlock, PoolExhausted
from .block_table import BlockTableRef, TableVersion
from .prefix_cache import PrefixCache
from .scheduler import Request, Scheduler
from .sharded_pool import ShardedBlockPool

__all__ = [
    "BlockPool",
    "BlockTableRef",
    "KVBlock",
    "PoolExhausted",
    "PrefixCache",
    "Request",
    "Scheduler",
    "ShardedBlockPool",
    "TableVersion",
]
