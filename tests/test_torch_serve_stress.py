"""The 4-worker serving stresses of ``test_chunked_prefill.py`` and
``test_prefix_cache.py`` on the port, held against ``repro``.

Four ``ServeRuntime`` workers on a 2-shard pool, under each of the four
pool schemes (the reference runs WFE alone), on the reference's smoke
stablelm-3b with its weights carried over by ``from_jax_params``:

* prefill chunks and decode batches interleaved (ragged prompts, chunk 4,
  blocks of 4): the tokens of ``repro.serve.ServeEngine`` on the same
  prompts, every prompt token prefilled or served from the prefix cache,
  at least one chunk per request;
* prompts sharing a block-aligned prefix, repeated: the tokens of the
  reference's engine with caching off, and hits on the sharded caches.

Both end with zero unreclaimed blocks and every pool slot free: a block
shared by several requests retires once, when its last sharer drops it
(a second retire would trip the pool's double-free assertion).
"""

import jax
import numpy as np
import pytest

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import build_model
from repro.serve import ServeEngine as RefEngine
from repro_torch.configs import get_smoke_config
from repro_torch.models.params import from_jax_params
from repro_torch.serve import ServeEngine, ServeRuntime

pytestmark = pytest.mark.stress

POOL_SCHEMES = ("WFE", "HE", "EBR", "2GEIBR")
#: ragged on purpose: no length is a multiple of chunk_size=4 OR
#: block_size=4 (except by accident of the 1-token prompt)
RAGGED_PROMPTS = [[5, 9, 2], [11, 3, 8, 1, 6], [7], [2, 4, 6, 8, 10, 12, 14],
                  [9, 9, 1, 5, 3, 2, 8, 7, 4], [13, 1]]
N_NEW = 5
CHUNK = 4
BS = 4
SHARED = [1 + j % 13 for j in range(8)]  # a block-aligned shared prefix


def _prompts(n=4, tail=5):
    """n prompts sharing SHARED, diverging in a ragged tail."""
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


def _reference_tokens(models, prompts, new, **kw):
    """``repro``'s single-worker engine on ``prompts``."""
    ref_cfg, _, ref_params, _ = models
    engine = RefEngine(ref_cfg, ref_params, block_size=BS, max_batch=4,
                       chunk_size=CHUNK, era_freq=2, cleanup_freq=2, **kw)
    tid = engine.pool.register_thread()
    reqs = [engine.submit(p, new) for p in prompts]
    engine.run(tid)
    assert all(r.done for r in reqs)
    return [list(r.generated) for r in reqs]


@pytest.fixture(scope="module")
def ragged_tokens(models):
    return _reference_tokens(models, RAGGED_PROMPTS * 3, N_NEW, n_blocks=64)


@pytest.fixture(scope="module")
def uncached_tokens(models):
    """The reference's oracle: the shared-prefix prompts, caching off."""
    return _reference_tokens(models, _prompts(), 4, n_blocks=48,
                             prefix_caching=False)


def _serve(models, prompts, new, n_blocks, scheme):
    """``prompts`` on the port's engine, 2 shards, 4 workers."""
    _, cfg, _, params = models
    engine = ServeEngine(cfg, params, n_blocks=n_blocks, block_size=BS,
                         max_batch=4, n_shards=2, max_threads=8,
                         max_inflight=8, chunk_size=CHUNK, scheme=scheme,
                         era_freq=2, cleanup_freq=2, device="cpu")
    reqs = [engine.submit(p, new) for p in prompts]
    stats = ServeRuntime(engine, n_workers=4).serve()
    assert stats["completed"] == len(prompts)
    assert stats["unreclaimed"] == 0
    assert engine.pool.free_blocks == n_blocks, "stress run leaked slots"
    return stats, [r.generated for r in reqs]


@pytest.mark.parametrize("scheme", POOL_SCHEMES)
def test_stress_prefill_decode_interleaved_4_workers(models, ragged_tokens,
                                                     scheme):
    """Prefill chunks and decode batches interleaved under 4 workers on a
    sharded pool: the reference's tokens, full reclamation."""
    prompts = RAGGED_PROMPTS * 3  # enough to keep all phases in flight
    stats, tokens = _serve(models, prompts, N_NEW, 64, scheme)
    assert tokens == ragged_tokens
    # token conservation: every prompt token is either prefilled or served
    # from the prefix cache (repeated prompts share block-aligned runs);
    # eviction re-runs only ADD work
    total = sum(map(len, prompts))
    assert stats["prefill_tokens"] + stats["prefix_hit_tokens"] >= total
    # every request still needs >= 1 chunk (a hit never covers the final
    # prompt token: its logits yield the first generated token)
    assert stats["prefill_chunks"] >= len(prompts)


@pytest.mark.parametrize("scheme", POOL_SCHEMES)
def test_stress_shared_prefixes_4_workers_sharded(models, uncached_tokens,
                                                  scheme):
    """Repeated shared-prefix prompts across 4 workers on a sharded pool:
    the uncached tokens, hits on the per-shard caches, exactly-once
    retirement and full reclamation."""
    reps = 3
    stats, tokens = _serve(models, _prompts() * reps, 4, 96, scheme)
    assert tokens == uncached_tokens * reps
    # per-shard caches: at least the same-shard repeats must hit
    assert stats["prefix_hits"] > 0
