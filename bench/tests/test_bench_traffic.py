"""The benchmark's generators: seeded, with one fixed multiset of lengths
and one fixed set of arrival times per mix, which the seed reorders only
among lengths of adjacent rank."""

import math
from collections import Counter

import bench_tiny  # noqa: F401  (paths)
import numpy as np
import pytest

from benchlib import common


def _mix(name):
    return common.load_json(common.traffic_file(name))


@pytest.mark.parametrize("name", ["chat", "agent"])
def test_same_seed_same_requests(name):
    mix = _mix(name)
    gen = common.generator(mix["kind"])
    a = gen.requests(mix, 2 ** 31 + 17, 10, 1000)
    b = gen.requests(mix, 2 ** 31 + 17, 10, 1000)
    assert a == b
    c = gen.requests(mix, 2 ** 31 + 18, 10, 1000)
    assert [r["prompt"] for r in a] != [r["prompt"] for r in c]


@pytest.mark.parametrize("name", ["chat", "agent"])
def test_seeds_share_the_schedule(name):
    """Another seed draws other tokens into the same schedule: requests
    due at the same times, the same multiset of prompt and output lengths
    and of system prompts, each length moved only within its run of
    ``rank_group`` adjacent ranks; with the group at 1, in the same
    order."""
    mix = _mix(name)
    gen = common.generator(mix["kind"])
    a = gen.requests(mix, 3, 51, 1000)
    b = gen.requests(mix, 4, 51, 1000)
    assert [r["due"] for r in a] == [r["due"] for r in b]
    for key in (lambda r: len(r["prompt"]), lambda r: r["max_new"],
                lambda r: r["prefix"]):
        assert sorted(map(key, a)) == sorted(map(key, b))
    assert [r["prompt"] for r in a] != [r["prompt"] for r in b]
    assert [r["max_new"] for r in a] != [r["max_new"] for r in b]
    group = mix["rank_group"]
    for key in (lambda r: len(r["prompt"]), lambda r: r["max_new"]):
        ranked = sorted(map(key, a))
        rank = {v: i for i, v in reversed(list(enumerate(ranked)))}
        for x, y in zip(a, b):
            assert abs(rank[key(x)] - rank[key(y)]) < 2 * group
    fixed = dict(mix, rank_group=1)
    key = lambda r: (len(r["prompt"]), r["max_new"], r["prefix"], r["due"])
    assert list(map(key, gen.requests(fixed, 3, 51, 1000))) == list(
        map(key, gen.requests(fixed, 4, 51, 1000)))
    assert len(a) == round(mix["rate_per_s"] * 51)
    assert 0 <= a[0]["due"] and a[-1]["due"] < 51
    assert all(x["due"] < y["due"] for x, y in zip(a, a[1:]))


def test_lengths_follow_the_spec():
    L = common.load_module(common.BENCH / "traffic" / "lengths.py")
    spec = {"dist": "lognormal", "median": 256, "sigma": 1.0, "min": 16,
            "max": 2048}
    xs = L.quantiles(spec, 1001)
    assert xs == sorted(xs) and xs[500] == 256
    assert min(xs) >= 16 and max(xs) <= 2048
    u = L.quantiles({"dist": "uniform", "min": 32, "max": 128}, 4)
    assert u == [44, 68, 92, 116]
    assert L.zipf_counts(4, 1.0, 25) == [12, 6, 4, 3]
    g = L.exp_gaps(2.0, 10000)
    assert math.isclose(g.mean(), 0.5, rel_tol=1e-3)


def test_rank_shuffle_moves_within_runs():
    """Values move only among the slots of their run of adjacent ranks;
    the multiset stays; a group of 1 changes nothing."""
    L = common.load_module(common.BENCH / "traffic" / "lengths.py")
    vals = [50, 10, 40, 20, 30, 60, 10]
    assert L.rank_shuffle(vals, 1, np.random.default_rng(0)) == vals
    # ranks by (value, slot): slots 1, 6 | 3, 4 | 2, 0 | 5
    runs = [{1, 6}, {3, 4}, {2, 0}, {5}]
    seen = set()
    for seed in range(20):
        out = L.rank_shuffle(vals, 2, np.random.default_rng(seed))
        assert sorted(out) == sorted(vals)
        for run in runs:
            assert sorted(out[i] for i in run) == sorted(vals[i] for i in run)
        seen.add(tuple(out))
    assert len(seen) == 4  # slots 3, 4 and 2, 0 swap or not


def test_agent_prefixes_are_shared_and_skewed():
    mix = _mix("agent")
    gen = common.generator(mix["kind"])
    reqs = gen.requests(mix, 9, 20, 1000)
    plen = mix["prefixes"]["length"]
    by = Counter(r["prefix"] for r in reqs)
    assert set(by) <= set(range(mix["prefixes"]["count"]))
    assert by.most_common(1)[0][0] == 0
    first = {}
    for r in reqs:
        head = tuple(r["prompt"][:plen])
        assert first.setdefault(r["prefix"], head) == head

