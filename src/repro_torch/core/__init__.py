"""Core library: the paper's SMR schemes on NumPy era mirrors.

``make_scheme(name, ...)`` is the registry the pool and the serving engine
use to select a reclamation scheme (paper §5 scheme list): WFE,
Crystalline, HE, HP, EBR, 2GEIBR and Leak.  The batched cleanups of the
era and epoch schemes take the backends ``scalar|numpy|torch|cuda``.
"""

from __future__ import annotations

from typing import Any

from .atomics import (
    INF_ERA,
    INVPTR,
    AtomicInt,
    AtomicPair,
    AtomicRef,
    AtomicTriple,
    PairPtrView,
    PtrView,
    TriplePtrView,
)
from .crystalline import Crystalline
from .distributed_eras import DistributedEraClock, ShardedEraDomain
from .ebr import EBR
from .era_table import (BACKENDS, ArrayRetireList, EraTable,
                        batched_can_delete)
from .hazard_eras import HazardEras
from .hazard_pointers import HazardPointers
from .ibr import IBR2GE
from .leak import LeakMemory
from .smr_base import POISON, Block, SMRScheme
from .wfe import WFE

SCHEMES = {
    "WFE": WFE,
    "Crystalline": Crystalline,
    "HE": HazardEras,
    "HP": HazardPointers,
    "EBR": EBR,
    "2GEIBR": IBR2GE,
    "Leak": LeakMemory,
}


def make_scheme(name: str, max_threads: int, **kwargs: Any) -> SMRScheme:
    try:
        cls = SCHEMES[name]
    except KeyError:
        raise ValueError(f"unknown SMR scheme {name!r}; one of {sorted(SCHEMES)}")
    return cls(max_threads, **kwargs)


__all__ = [
    "INF_ERA",
    "INVPTR",
    "POISON",
    "BACKENDS",
    "ArrayRetireList",
    "EraTable",
    "batched_can_delete",
    "AtomicInt",
    "AtomicPair",
    "AtomicRef",
    "AtomicTriple",
    "PtrView",
    "PairPtrView",
    "TriplePtrView",
    "Block",
    "SMRScheme",
    "WFE",
    "Crystalline",
    "DistributedEraClock",
    "ShardedEraDomain",
    "HazardEras",
    "HazardPointers",
    "EBR",
    "IBR2GE",
    "LeakMemory",
    "SCHEMES",
    "make_scheme",
]
