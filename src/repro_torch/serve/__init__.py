"""Paged serving: the engine and its device steps over the paged KV pool."""

from .engine import ServeEngine
from .paged_model import init_pools, paged_decode_step, paged_prefill_chunk

__all__ = ["ServeEngine", "init_pools", "paged_decode_step",
           "paged_prefill_chunk"]
