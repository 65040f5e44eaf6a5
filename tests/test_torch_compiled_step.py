"""The engine's compiled steps held against ``repro``'s jitted ones
(``_jit_decode``, ``_jit_prefill``) on the CPU.

On the card the engine captures one CUDA graph per (shard, step
signature) and replays it; a graph needs every input's shape to follow
from the signature, and no host sync anywhere in the step.  These tests
check what makes that so, with the smoke stablelm-3b carried over from
``repro`` by ``from_jax_params``:

(a) ``compile_cache_size()`` equals ``repro.serve.ServeEngine``'s after the
    same trace: the bucket trace and a ragged trace, ``maxlen`` and
    ``pow2`` buckets, f32 and int8 pages, 1 and 2 shards (the same tokens
    too);
(b) every key the engine counts maps to exactly one signature (the shapes
    and dtypes of the step's inputs);
(c) the decode and chunked steps run under ``FakeTensorMode`` at every key
    those traces reach, the attention call replaced by a stand-in of the
    kernel's output shape (on the card the kernel itself is captured): a
    ``nonzero``, ``unique``, ``.item()`` or ``int(tensor)`` left on the
    path raises there, as the step's derived indices do;
(d) over prefix-aliased tables and ragged chunks, with f32 and int8
    pages, in prefill chunks and packed mixed steps
    (``paged_mixed_step``), the static inputs leave every live page and
    scale bitwise what
    the derived path writes, with the same sampled ids, and the run's
    tokens and stats equal ``repro``'s;
(e) the capture tally of ``kernels.build``: a capture counts nothing, each
    replay adds what it launched.
"""

import functools
import threading

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import (DataDependentOutputException,
                                           DynamicOutputShapeException,
                                           FakeTensorMode)
from torch.utils._pytree import tree_map

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import build_model
from repro.serve import ServeEngine as RefEngine
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import build
from repro_torch.models.params import from_jax_params
from repro_torch.serve import ServeEngine, paged_model
from repro_torch.serve.paged_model import paged_prefill_chunk

#: test_torch_scheduling.py's bucket trace: one long generation walks its
#: table through several pow2 boundaries while the short ones stay narrow
BUCKET_TRACE = [([3, 1, 4, 1, 5], 26), ([2, 7], 4), ([9, 2, 6], 5), ([8], 4)]
BUCKET_KW = dict(n_blocks=48, block_size=2, max_batch=4, chunk_size=4,
                 era_freq=4, cleanup_freq=4)
RAGGED_KW = dict(n_blocks=40, block_size=4, max_batch=4, chunk_size=8,
                 era_freq=1, cleanup_freq=1)


def _ragged_trace(n=10, seed=3):
    """test_torch_scheduling.py's ragged prompts (1-29 tokens), 6 new."""
    rng = np.random.default_rng(seed)
    return [([int(t) for t in rng.integers(1, 200, int(rng.integers(1, 30)))],
             6) for _ in range(n)]


TRACES = {"bucket": (BUCKET_TRACE, BUCKET_KW),
          "ragged": (_ragged_trace(), RAGGED_KW)}
#: every trace x bucket policy x page type x shard count, but int8 pages
#: on 2 shards take the bucket trace only (the reference compiles each
#: signature anew, about 0.7 s each here)
CASES = [(trace, policy, kv, shards)
         for trace in TRACES for policy in ("maxlen", "pow2")
         for kv in (None, "int8") for shards in (1, 2)
         if not (kv and shards == 2 and trace == "ragged")]
IDS = [f"{t}-{p}-{kv or 'f32'}-{s}shard" for t, p, kv, s in CASES]


@functools.lru_cache(maxsize=None)
def _models():
    ref_cfg = ref_smoke_config("stablelm-3b")
    cfg = get_smoke_config("stablelm-3b")
    ref_params = build_model(ref_cfg).init(jax.random.key(0))
    params = from_jax_params(cfg, jax.tree.map(np.asarray, ref_params),
                             device="cpu")
    return ref_cfg, cfg, ref_params, params


def _signature(arrays):
    return tuple(None if a is None else (np.shape(a), np.asarray(a).dtype.str)
                 for a in arrays)


@functools.lru_cache(maxsize=None)
def _run(trace, policy, kv, shards):
    """The trace on both engines.  Returns the two compile counts, the
    port's signatures by key and one input per (key, step)."""
    ref_cfg, cfg, ref_params, params = _models()
    prompts, kw = TRACES[trace]
    kw = dict(kw, bucket_policy=policy, kv_dtype=kv, n_shards=shards)
    ref = RefEngine(ref_cfg, ref_params, **kw)
    ref.clear_compile_caches()  # the jitted steps are shared per config
    engine = ServeEngine(cfg, params, device="cpu", **kw)
    signatures, examples = {}, {}
    real = engine._run_step

    def spy(plan, step, arrays, b):
        key = engine._signature(plan.kind, arrays)
        signatures.setdefault(key, set()).add(_signature(arrays))
        examples.setdefault((key, step), arrays)
        return real(plan, step, arrays, b)

    engine._run_step = spy
    tokens = []
    for eng in (ref, engine):
        tid = eng.pool.register_thread()
        reqs = [eng.submit(p, n) for p, n in prompts]
        eng.run(tid)
        assert all(r.done for r in reqs)
        assert eng.pool.unreclaimed() == 0
        tokens.append([list(r.generated) for r in reqs])
    return dict(ref_count=ref.compile_cache_size(),
                count=engine.compile_cache_size(), tokens=tokens,
                signatures=signatures, examples=examples,
                pools=engine._shard_pools)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_compile_count_equals_reference(case):
    run = _run(*case)
    assert run["tokens"][0] == run["tokens"][1]
    assert run["count"] == run["ref_count"], (run["count"], run["ref_count"])


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_one_signature_per_key(case):
    run = _run(*case)
    assert len(run["signatures"]) == run["count"]
    for key, sigs in run["signatures"].items():
        assert len(sigs) == 1, (key, sigs)


def _stand_in(q, *args, **kwargs):
    """The attention kernel's output shape (the card captures the kernel)."""
    return torch.empty_like(q)


def _fake_step(step, arrays, pools, monkeypatch, attention=_stand_in):
    """``step`` and its argmax under ``FakeTensorMode``, ``attention`` in
    place of the attention call: returns the ids' shape, or raises where
    the step needs a value on the host."""
    _, cfg, _, params = _models()
    monkeypatch.setattr(paged_model, "paged_decode_attention", attention)
    monkeypatch.setattr(paged_model, "paged_chunk_attention", attention)
    mode = FakeTensorMode()
    fake_params = tree_map(mode.from_tensor, params)
    fake_pools = {k: mode.from_tensor(v) for k, v in pools.items()}
    args = [None if a is None else mode.from_tensor(
        torch.from_numpy(np.ascontiguousarray(a, np.int32))) for a in arrays]
    with mode:
        logits, _ = step(cfg, fake_params, fake_pools, *args)
        return tuple(torch.argmax(logits, dim=-1).shape)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_steps_run_under_fake_tensors(case, monkeypatch):
    run = _run(*case)
    assert len({key for key, _ in run["examples"]}) == run["count"]
    for (key, step), arrays in run["examples"].items():
        shard_pools = run["pools"][0]
        assert _fake_step(step, arrays, shard_pools, monkeypatch) == (
            arrays[0].shape[0],), key


@pytest.mark.parametrize("fault", ["derived", "int"])
def test_host_syncs_fail_under_fake_tensors(fault, monkeypatch):
    """The controls: the chunk step's derived indices (``nonzero``, and
    ``unique`` with int8 pages) and an ``int(tensor)`` planted in the
    attention call need values on the host, which fake tensors refuse."""
    run = _run("ragged", "maxlen", "int8", 1)
    arrays = next(a for (_, step), a in run["examples"].items()
                  if step is paged_prefill_chunk)
    if fault == "derived":
        with pytest.raises(DynamicOutputShapeException):
            _fake_step(paged_prefill_chunk, arrays[:4], run["pools"][0],
                       monkeypatch)
        return

    def planted(q, k_pool, v_pool, tables, *args, **kwargs):
        return torch.empty_like(q)[:int(tables.max()) + q.shape[0]]

    with pytest.raises(DataDependentOutputException):
        _fake_step(paged_prefill_chunk, arrays, run["pools"][0], monkeypatch,
                   attention=planted)


# ----------------------------------------------- (d) static == derived
SYSTEM = [[1 + j % 13 for j in range(8)], [3 + j % 7 for j in range(8)]]


def _aliased_prompts():
    """8 prompts on two block-aligned 8-token prefixes, ragged tails of 1-9
    tokens: the prefix cache aliases the prefix pages into later tables."""
    rng = np.random.default_rng(11)
    return [SYSTEM[i % 2] + [int(t) for t in
                             rng.integers(1, 200, int(rng.integers(1, 10)))]
            for i in range(8)]


@pytest.mark.parametrize("kv", [None, "int8"], ids=["f32", "int8"])
def test_static_chunk_inputs_equal_derived_path(kv):
    ref_cfg, cfg, ref_params, params = _models()
    kw = dict(n_blocks=40, block_size=4, max_batch=4, chunk_size=8,
              era_freq=1, cleanup_freq=1, kv_dtype=kv)
    engine = ServeEngine(cfg, params, device="cpu", **kw)
    real = engine._run_step
    checked = {"mixed": 0, "prefill": 0, "aliased": 0, "ragged": 0}
    first = set()

    def spy(plan, step, arrays, b):
        if step is paged_model.paged_decode_step:
            return real(plan, step, arrays, b)
        pools = engine._shard_pools[plan.shard]
        derived = {k: v.clone() for k, v in pools.items()}
        # the step's inputs without its write indices: (tables, tokens,
        # positions, chunk_lens) of a prefill chunk, (tables, tokens,
        # positions, out_slots) of the packed mixed step
        base = [torch.from_numpy(np.ascontiguousarray(a, np.int32))
                for a in arrays[:4]]
        logits, _ = step(cfg, params, derived, *base)
        ids = real(plan, step, arrays, b)
        pad = engine._shard_sizes[plan.shard]  # the scratch slot
        for name, t in pools.items():
            assert torch.equal(t[:, :pad], derived[name][:, :pad]), name
        assert np.array_equal(ids, torch.argmax(logits, -1)[:b].numpy())
        checked[plan.kind] += 1
        # a request's first step is its first chunk (the plan's last row):
        # past position 0, its table starts with pages the prefix cache
        # aliased into it.  Ragged: a chunk with padded columns
        tables, tokens, positions, last = arrays[:4]
        if step is paged_prefill_chunk:
            start = positions[0, 0]
            checked["ragged"] += int(last[0] < tokens.shape[1])
        else:
            start = positions[tables.shape[0] - 1]
            checked["ragged"] += int(last.max() < len(tokens) - 1)
        if plan.requests[-1].rid not in first:
            first.add(plan.requests[-1].rid)
            checked["aliased"] += int(start > 0)
        return ids

    engine._run_step = spy
    outs = []
    for eng in (RefEngine(ref_cfg, ref_params, **kw), engine):
        tid = eng.pool.register_thread()
        reqs = [eng.submit(p, 5) for p in _aliased_prompts()]
        stats = eng.run(tid)
        assert eng.pool.unreclaimed() == 0
        assert eng.pool.free_blocks == kw["n_blocks"]
        outs.append(([list(r.generated) for r in reqs], stats))
    (ref_tokens, ref_stats), (tokens, stats) = outs
    assert tokens == ref_tokens
    assert {k: stats[k] for k in ref_stats} == ref_stats
    assert stats["prefix_hits"] > 0
    assert checked["mixed"] > 0 and checked["prefill"] > 0, checked
    assert checked["aliased"] > 0 and checked["ragged"] > 0, checked


# --------------------------------------------------- (e) capture tally
def test_capture_tally_counts_at_replay():
    a, b = build.Counter(), build.Counter()
    a.bump()
    seen = []
    with build.capturing() as tally:
        a.bump()
        a.bump()
        b.bump()
        build.at_replay(lambda: seen.append(b.n))
        assert (a.n, b.n) == (1, 0)  # a capture launches nothing
        assert (build.launched(a), build.launched(b)) == (3, 1)
        # another thread's launches count at once
        other = threading.Thread(target=a.bump)
        other.start()
        other.join()
        assert a.n == 2
    assert tally.counts == {a: 2, b: 1}
    assert (build.launched(a), seen) == (2, [])
    for _ in range(3):
        tally.replay()
    assert (a.n, b.n) == (2 + 3 * 2, 3)
    assert seen == [1, 2, 3]  # each replay's callbacks after its counts
    build.at_replay(lambda: seen.append("now"))
    assert seen[-1] == "now"


def test_capture_tally_nests_and_restores():
    a = build.Counter()
    with build.capturing() as outer:
        a.bump()
        with build.capturing() as inner:
            a.bump()
            a.bump()
        a.bump()
    a.bump()
    assert (outer.counts, inner.counts, a.n) == ({a: 2}, {a: 2}, 1)
    with pytest.raises(RuntimeError):
        with build.capturing():
            raise RuntimeError("a failed capture")
    a.bump()
    assert a.n == 2
