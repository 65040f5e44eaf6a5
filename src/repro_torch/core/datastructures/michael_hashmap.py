"""Michael's lock-free hash map (TPDS 2004) — the paper's Hash-Map benchmark.

A fixed array of buckets, each a Harris-Michael sorted list.  Keys hash to a
bucket; all SMR interaction is inherited from the list.
"""

from __future__ import annotations

from typing import Any, Optional

from ..atomics import AtomicPair
from ..smr_base import SMRScheme
from .harris_list import HarrisMichaelList

__all__ = ["MichaelHashMap"]


class MichaelHashMap:
    def __init__(self, smr: SMRScheme, n_buckets: int = 1024):
        self.smr = smr
        self.n_buckets = n_buckets
        self.buckets = [
            HarrisMichaelList(smr, AtomicPair((None, False))) for _ in range(n_buckets)
        ]

    def _bucket(self, key: Any) -> HarrisMichaelList:
        return self.buckets[hash(key) % self.n_buckets]

    def insert(self, key: Any, value: Any, tid: int) -> bool:
        return self._bucket(key).insert(key, value, tid)

    def delete(self, key: Any, tid: int) -> bool:
        return self._bucket(key).delete(key, tid)

    def get(self, key: Any, tid: int) -> Optional[Any]:
        return self._bucket(key).get(key, tid)
