"""Core library: the paper's SMR schemes (WFE so far) on NumPy era mirrors.

``make_scheme(name, ...)`` is the registry the pool and the serving engine
use to select a reclamation scheme.  Only WFE is ported; the other schemes
of ``repro.core`` raise until they are.
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
from .era_table import (BACKENDS, ArrayRetireList, EraTable,
                        batched_can_delete)
from .smr_base import POISON, Block, SMRScheme
from .wfe import WFE

SCHEMES = {"WFE": WFE}

#: schemes of the reference registry that this package does not carry yet
NOT_PORTED = ("Crystalline", "HE", "HP", "EBR", "2GEIBR", "Leak")


def make_scheme(name: str, max_threads: int, **kwargs: Any) -> SMRScheme:
    if name in NOT_PORTED:
        raise ValueError(f"SMR scheme {name!r} is not ported yet; "
                         f"one of {sorted(SCHEMES)}")
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
    "SCHEMES",
    "make_scheme",
]
