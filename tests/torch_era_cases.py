"""Seeded era-scan inputs shaped like one serving tick, as NumPy int32.

Shared by the port's era-scan tests and ``chip_smoke.py``.  Imports
neither JAX nor either package.
"""

import numpy as np

#: the value of an empty reservation slot's lo (``INT32_MAX``)
INF_ERA32 = int(np.iinfo(np.int32).max)

#: the reservation forms the scan takes: WFE/HE/Crystalline points
#: (lo == hi), 2GEIBR intervals (lo < hi), EBR's open form (hi = INF - 1)
FORMS = ("point", "interval", "open")

#: the current era of ``sample_case``'s mirrors
SAMPLE_ERA = 1_000_000


def sample_case(r: int, s: int, valid: float, seed: int = 0, forms=FORMS):
    """Era-table mirrors (alloc, retire, lo, hi) for one scan.  ``r``
    retired blocks lived 0-2000 eras and were allocated 100-20000 eras
    before the current era; each of the ``s`` slots holds a reservation
    with probability ``valid``, the reservations taking ``forms`` in turn
    near the current era (points and EBR's open form within 500 eras,
    intervals starting within 2000 and up to 500 long); the other slots
    are empty (lo = hi = INT32_MAX).  Blocks retired before the oldest
    reservation, most of them, conflict with no slot, so a scan visits
    every valid slot for them."""
    era = SAMPLE_ERA
    rng = np.random.default_rng(seed)
    alloc = era - rng.integers(100, 20_000, r)
    retire = np.minimum(alloc + rng.integers(0, 2_000, r), era)
    lo = np.full(s, INF_ERA32, np.int64)
    hi = np.full(s, INF_ERA32, np.int64)
    idx = np.flatnonzero(rng.random(s) < valid)
    kind = np.asarray(forms)[np.arange(len(idx)) % len(forms)]
    for form in forms:
        at = idx[kind == form]
        n = len(at)
        if form == "point":
            lo[at] = hi[at] = era - rng.integers(0, 500, n)
        elif form == "interval":
            lo[at] = era - rng.integers(0, 2_000, n)
            hi[at] = lo[at] + rng.integers(1, 500, n)
        elif form == "open":
            lo[at] = era - 1 - rng.integers(1, 500, n)
            hi[at] = INF_ERA32 - 1
        else:
            raise ValueError(f"unknown reservation form {form!r}")
    return tuple(a.astype(np.int32) for a in (alloc, retire, lo, hi))
