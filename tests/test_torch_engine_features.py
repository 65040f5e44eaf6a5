"""The port's engine held against ``repro.serve.ServeEngine`` on the
features its prefill path carries: chunked prefill and the prefix cache.

The engine now builds the prefill step's scatter indices (and, with int8
pages, the blocks to re-code) on the host and hands them to
``paged_prefill_chunk``; these runs pin that path on every plan kind, in
the reference's own workloads (``test_chunked_prefill.py``,
``test_prefix_cache.py``):

- a P-token prompt materializes in ceil(P/C) chunk dispatches;
- ragged prompts over chunk and block boundaries, under each pool scheme
  and with int8 pages;
- prompts sharing a block-aligned prefix hit the cache, and a second
  identical prompt dispatches nothing for its cached chunks;
- a pool too small for cache and live tables evicts cache entries first;
- the last of N concurrent sharers retires a shared block exactly once.

Every engine run is token- and stat-exact against the reference's on the
same weights (carried over by ``from_jax_params``) and drains to zero
unreclaimed blocks with every block free.
"""

import threading

import jax
import numpy as np
import pytest

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import build_model
from repro.serve import ServeEngine as RefEngine
from repro_torch.blocks import BlockPool
from repro_torch.configs import get_smoke_config
from repro_torch.models.params import from_jax_params
from repro_torch.serve import ServeEngine

POOL_SCHEMES = ("WFE", "HE", "EBR", "2GEIBR")
RAGGED_PROMPTS = [[5, 9, 2], [11, 3, 8, 1, 6], [7], [2, 4, 6, 8, 10, 12, 14],
                  [9, 9, 1, 5, 3, 2, 8, 7, 4], [13, 1]]
BS = 4
SHARED = [1 + j % 13 for j in range(8)]  # a block-aligned shared prefix


def _shared_prompts(n=4, tail=5):
    return [SHARED + [2 + (i * 5 + j) % 11 for j in range(tail)]
            for i in range(n)]


@pytest.fixture(scope="module")
def models():
    ref_cfg = ref_smoke_config("stablelm-3b")
    cfg = get_smoke_config("stablelm-3b")
    ref_params = build_model(ref_cfg).init(jax.random.key(0))
    params = from_jax_params(cfg, jax.tree.map(np.asarray, ref_params),
                             device="cpu")
    return ref_cfg, cfg, ref_params, params


def _serve_both(models, prompts, new, n_blocks, **kw):
    """Serve ``prompts`` on both engines; assert equal tokens and stats and
    a full drain on each.  Returns the port's (stats, requests)."""
    ref_cfg, cfg, ref_params, params = models
    kw = {**dict(block_size=BS, max_batch=4, era_freq=2, cleanup_freq=2),
          **kw}
    outs = []
    for make in (lambda: RefEngine(ref_cfg, ref_params, n_blocks=n_blocks,
                                   **kw),
                 lambda: ServeEngine(cfg, params, n_blocks=n_blocks,
                                     device="cpu", **kw)):
        engine = make()
        tid = engine.pool.register_thread()
        reqs = [engine.submit(p, new) for p in prompts]
        stats = engine.run(tid)
        assert all(r.done for r in reqs)
        assert engine.pool.unreclaimed() == 0
        assert engine.pool.free_blocks == n_blocks
        outs.append((stats, reqs))
    (ref_stats, ref_reqs), (stats, reqs) = outs
    assert [r.generated for r in reqs] == [r.generated for r in ref_reqs]
    assert stats == ref_stats
    return stats, reqs


@pytest.mark.parametrize("p_len,c", [(13, 4), (8, 8), (9, 2), (5, 16)])
def test_prefill_completes_in_ceil_p_over_c_steps(models, p_len, c):
    prompt = [1 + i % 7 for i in range(p_len)]
    stats, (req,) = _serve_both(models, [prompt], 3, 32, chunk_size=c,
                                era_freq=1, cleanup_freq=1)
    chunks = -(-p_len // c)
    assert stats["prefill_chunks"] == chunks
    assert stats["prefill_tokens"] == p_len
    assert stats["steps"] == chunks + 3 - 1
    assert req.ttft is not None and req.tpot is not None


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("scheme", POOL_SCHEMES)
def test_chunked_ragged_prompts_match_reference(models, scheme, kv_dtype):
    stats, _ = _serve_both(models, RAGGED_PROMPTS, 5, 32, chunk_size=4,
                           scheme=scheme, kv_dtype=kv_dtype)
    assert stats["completed"] == len(RAGGED_PROMPTS)
    assert stats["mixed_steps"] > 0


@pytest.mark.parametrize("scheme", POOL_SCHEMES)
def test_cached_prefixes_match_reference(models, scheme):
    prompts = _shared_prompts()
    stats, _ = _serve_both(models, prompts, 4, 48, chunk_size=4,
                           scheme=scheme)
    assert stats["prefix_hits"] == 3
    assert stats["prefix_hit_tokens"] == 3 * len(SHARED)
    total = sum(map(len, prompts))
    assert stats["prefill_tokens"] + stats["prefix_hit_tokens"] == total


def test_second_request_zero_dispatches_for_cached_chunks(models):
    p_len, c = 13, 4
    prompt = [1 + i % 7 for i in range(p_len)]
    hit = (p_len - 1) // BS * BS
    stats, (r1, r2) = _serve_both(models, [prompt, prompt], 3, 32,
                                  chunk_size=c)
    assert r1.generated == r2.generated
    assert stats["prefill_chunks"] == -(-p_len // c) + -(-(p_len - hit) // c)
    assert stats["prefill_tokens"] == 2 * p_len - hit
    assert stats["prefix_hit_tokens"] == hit


def test_pool_pressure_evicts_cache_before_requests(models):
    stats, _ = _serve_both(models, _shared_prompts(), 4, 6, max_batch=2,
                           chunk_size=4, era_freq=1, cleanup_freq=1)
    assert stats["prefix_evictions"] >= 1


@pytest.mark.parametrize("scheme", POOL_SCHEMES)
def test_last_sharer_retires_exactly_once(scheme):
    """N threads release their reference to every shared block at once:
    one retire per block, whichever thread is last, and the pool drains."""
    n_threads, n_blocks = 6, 16
    pool = BlockPool(n_blocks, scheme=scheme, max_threads=n_threads + 1,
                     era_freq=1, cleanup_freq=10_000)
    t0 = pool.register_thread()
    blocks = pool.alloc_blocks(n_blocks, t0)
    for blk in blocks:
        for _ in range(n_threads - 1):
            pool.add_sharer(blk)
        assert blk.sharers.load() == n_threads
    tids = [t0] + [pool.register_thread() for _ in range(n_threads - 1)]
    barrier = threading.Barrier(n_threads)

    def releaser(tid):
        barrier.wait()
        for blk in blocks:
            pool.release_block(blk, tid)

    threads = [threading.Thread(target=releaser, args=(tid,))
               for tid in tids]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert sum(pool.smr.retire_count) == n_blocks
    assert all(blk.sharers.load() == 0 for blk in blocks)
    for _ in range(8):
        if pool.unreclaimed() == 0:
            break
        pool.advance_eras(t0)
        pool.cleanup_all()
    assert pool.unreclaimed() == 0
    assert pool.free_blocks == n_blocks
