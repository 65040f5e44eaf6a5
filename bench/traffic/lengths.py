"""Lengths and gaps, shared by the generators.

Every seed of a mix gets the same multiset of prompt lengths, output
lengths and arrival gaps: stratified quantiles of the mix's distributions,
paired and ordered by the mix's own ``salt``.  The seed draws the token ids
(and the benchmark the weights) and, with ``rank_group`` g, reorders the
lengths among the requests whose lengths are of adjacent rank, g ranks at a
time (``rank_shuffle``): each request slot keeps nearly the same work, so
the window holds the same load at the same times, in another order.  With
71 requests in a window, a free reorder moved chat's 95th percentiles by a
quarter from seed to seed (PERF.md §6)."""

from __future__ import annotations

import math
from statistics import NormalDist
from typing import List

import numpy as np


def quantiles(spec: dict, n: int) -> List[int]:
    """``n`` lengths at the midpoints of ``n`` equal-probability strata of
    ``spec``: ``{"dist": "lognormal", "median", "sigma", "min", "max"}`` or
    ``{"dist": "uniform", "min", "max"}``, clipped to [min, max]."""
    lo, hi = int(spec["min"]), int(spec["max"])
    us = [(i + 0.5) / n for i in range(n)]
    if spec["dist"] == "lognormal":
        mu, sigma = math.log(spec["median"]), float(spec["sigma"])
        vals = [math.exp(mu + sigma * NormalDist().inv_cdf(u)) for u in us]
    elif spec["dist"] == "uniform":
        vals = [lo + (hi - lo) * u for u in us]
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return [min(hi, max(lo, int(round(v)))) for v in vals]


def exp_gaps(rate: float, n: int) -> np.ndarray:
    """``n`` gaps of a Poisson process of ``rate``: stratified quantiles of
    the exponential distribution."""
    u = (np.arange(n) + 0.5) / n
    return -np.log1p(-u) / rate


def arrivals(rate: float, seconds: float, rng: np.random.Generator
             ) -> np.ndarray:
    """round(rate x seconds) send times in [0, seconds): the first half a
    mean gap in, then the fixed gaps in the order ``rng`` draws, all scaled
    by one factor (the same for every order) so that the last falls half a
    mean gap before the window's end."""
    n = max(1, int(round(rate * seconds)))
    gaps = exp_gaps(rate, n - 1) if n > 1 else np.zeros(0)
    half = 0.5 / rate
    t = half + np.concatenate([[0.0], np.cumsum(rng.permutation(gaps))])
    return t * (seconds - half) / (half + gaps.sum() + half)


def zipf_counts(k: int, s: float, n: int) -> List[int]:
    """``n`` uses split over ``k`` items with weights 1/rank^s, by largest
    remainder."""
    w = np.array([1.0 / (r + 1) ** s for r in range(k)])
    share = w / w.sum() * n
    counts = np.floor(share).astype(int)
    for i in np.argsort(-(share - counts))[: n - counts.sum()]:
        counts[i] += 1
    return counts.tolist()


def rank_shuffle(values, group: int, rng: np.random.Generator) -> List[int]:
    """``values`` (one per slot) reordered among the slots: the slots are
    ranked by value (ties by slot), cut into runs of ``group`` adjacent
    ranks, and the values of each run are permuted over its slots as
    ``rng`` draws.  The multiset stays; ``group`` 1 changes nothing."""
    vals = list(values)
    ranked = sorted(range(len(vals)), key=lambda i: (vals[i], i))
    out = list(vals)
    for k in range(0, len(ranked), max(1, int(group))):
        slots = ranked[k:k + group]
        for slot, j in zip(slots, rng.permutation(len(slots))):
            out[slot] = vals[slots[j]]
    return out
