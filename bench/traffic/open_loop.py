"""Open-loop traffic: requests sent at fixed times, whether or not earlier
ones have finished (independent users), at ``rate_per_s``.

Parameters (the mix's JSON file): ``rate_per_s``; ``salt`` (fixes the
lengths, how they pair and the arrival gaps); ``rank_group`` (the seed
reorders prompt lengths, and output lengths apart, among runs of that many
adjacent ranks: ``lengths.rank_shuffle``; 1 or absent, not at all);
``prompt`` and ``output`` length distributions (``lengths.quantiles``);
optional ``prefixes``
``{"count", "length", "zipf_s"}``: each prompt is then one of ``count``
shared system prompts of ``length`` tokens, chosen with Zipf popularity
(which request takes which, drawn from the seed with ``rank_group``),
followed by a tail drawn from ``prompt``, and set-up serves each system
prompt once, as a deployment's cache holds them (``preload``);
``drain_s``, how long after the
window the run waits for the requests sent in it."""

from __future__ import annotations

from pathlib import Path
from typing import List

import numpy as np

_HERE = Path(__file__).resolve().parent
LOOP = "open"


def _lengths():
    from importlib.util import module_from_spec, spec_from_file_location
    spec = spec_from_file_location("bench_traffic_lengths", _HERE / "lengths.py")
    mod = module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


L = _lengths()


def requests(params: dict, seed: int, seconds: float, vocab: int,
             rate: float = None) -> List[dict]:
    """The window's requests in send order: ``{"due": seconds after the
    window opens, "prompt": [ids], "max_new": n, "prefix": index or -1}``.
    ``rate`` overrides ``rate_per_s`` (the sweep)."""
    rate = params["rate_per_s"] if rate is None else rate
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFFFFFF, 11])
    fixed = np.random.default_rng(int(params["salt"]))
    due = L.arrivals(rate, seconds, fixed)
    n = len(due)
    tails = L.quantiles(params["prompt"], n)
    outs = L.quantiles(params["output"], n)
    outs = [outs[i] for i in fixed.permutation(n)]
    pre = params.get("prefixes")
    which = [-1] * n
    if pre:
        counts = L.zipf_counts(pre["count"], pre["zipf_s"], n)
        which = [k for k, c in enumerate(counts) for _ in range(c)]
        which = [which[i] for i in fixed.permutation(n)]
        systems = preload(params, seed, vocab)
    order = fixed.permutation(n)
    tails = [tails[i] for i in order]
    outs = [outs[i] for i in order]
    which = [which[i] for i in order]
    group = int(params.get("rank_group", 1))
    if group > 1:
        mix = np.random.default_rng([int(seed) & 0xFFFFFFFFFFFF, 13])
        tails = L.rank_shuffle(tails, group, mix)
        outs = L.rank_shuffle(outs, group, mix)
        which = [which[i] for i in mix.permutation(n)]
    out = []
    for slot in range(n):
        tail = rng.integers(0, vocab, size=tails[slot]).tolist()
        prompt = (systems[which[slot]] + tail) if which[slot] >= 0 \
            else tail
        out.append({"due": float(due[slot]), "prompt": prompt,
                    "max_new": int(outs[slot]), "prefix": which[slot]})
    return out


def length_space(params: dict) -> List[dict]:
    """What the engine's step shapes depend on: prompt and output length
    ranges, and the prompt tokens a prefix cache can already hold."""
    pre = params.get("prefixes")
    base = pre["length"] if pre else 0
    return [{"prompt": (base + params["prompt"]["min"],
                        base + params["prompt"]["max"]),
             "output": (params["output"]["min"], params["output"]["max"]),
             "cached": (0, base) if pre else (0,)}]


def preload(params: dict, seed: int, vocab: int) -> List[List[int]]:
    """The shared system prompts (none without ``prefixes``), drawn from
    the seed."""
    pre = params.get("prefixes")
    if not pre:
        return []
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFFFFFF, 12])
    return rng.integers(0, vocab, size=(pre["count"], pre["length"])).tolist()
