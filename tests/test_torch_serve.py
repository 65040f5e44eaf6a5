"""The port's model functions, paged steps and serving engine held against
``repro`` on the CPU.

Weights come from one reference pytree carried over by ``from_jax_params``;
inputs come from a NumPy seed.  Tolerances: per-function 1e-5 (fp32, the
two frameworks sum in different orders), step logits 2e-3 (as
test_blocks_serve holds paged against contiguous), engine tokens exact.
fp32 matmuls stay at full precision: ``allow_tf32`` is off (it only
matters on the card, where these tests do not run).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import attention as ref_attention
from repro.models import build_model
from repro.models import layers as ref_layers
from repro.serve import ServeEngine as RefEngine
from repro.serve import paged_model as ref_paged
from repro_torch.configs import get_smoke_config
from repro_torch.models import attention, layers
from repro_torch.models.params import from_jax_params, init_params
from repro_torch.serve import (ServeEngine, init_pools, paged_decode_step,
                               paged_prefill_chunk)

torch.backends.cuda.matmul.allow_tf32 = False

TOL = 1e-5


@pytest.fixture(scope="module")
def models():
    ref_cfg = ref_smoke_config("stablelm-3b")
    cfg = get_smoke_config("stablelm-3b")
    ref_params = build_model(ref_cfg).init(jax.random.key(0))
    params = from_jax_params(cfg, jax.tree.map(np.asarray, ref_params),
                             device="cpu")
    return ref_cfg, cfg, ref_params, params


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


def _block(tree, g=0):
    return jax.tree.map(lambda a: a[g], tree["groups"]["b0_attn"])


def _tblock(tree, g=0):
    return {k: {n: t[g] for n, t in sub.items()}
            for k, sub in tree["groups"]["b0_attn"].items()}


def test_param_tree_matches_reference(models):
    """init_params and the bridge build the reference's key/shape tree;
    matmul weights are stored in cfg.dtype, norms in param_dtype."""
    ref_cfg, cfg, ref_params, params = models
    want = jax.tree_util.tree_flatten_with_path(ref_params)[0]
    mine = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    for tree in (params, mine):
        got = {}

        def walk(node, path=()):
            if isinstance(node, dict):
                for k, v in node.items():
                    walk(v, path + (k,))
            else:
                got[path] = node

        walk(tree)
        assert set(got) == {tuple(p.key for p in path) for path, _ in want}
        for path, arr in want:
            t = got[tuple(p.key for p in path)]
            assert tuple(t.shape) == arr.shape
            assert torch.isfinite(t).all()
    assert mine["groups"]["b0_attn"]["mix"]["wq"].dtype == cfg.dtype
    assert mine["final_norm"]["scale"].dtype == cfg.param_dtype


@pytest.mark.parametrize("norm_kind", ["layernorm", "rmsnorm"])
def test_norm_matches(models, norm_kind):
    ref_cfg, cfg, _, _ = models
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    p = {"scale": rng.standard_normal(cfg.d_model).astype(np.float32) * 0.1,
         "bias": rng.standard_normal(cfg.d_model).astype(np.float32) * 0.1}
    got = layers.apply_norm(cfg.scaled(norm_kind=norm_kind),
                            {k: torch.from_numpy(v) for k, v in p.items()},
                            torch.from_numpy(x))
    want = ref_layers.apply_norm(ref_cfg.scaled(norm_kind=norm_kind),
                                 {k: jnp.asarray(v) for k, v in p.items()},
                                 jnp.asarray(x))
    _close(got, want)


def test_embed_matmul_unembed_match(models):
    ref_cfg, cfg, ref_params, params = models
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, cfg.vocab_size, (2, 6)).astype(np.int32)
    x_ref = ref_layers.embed_tokens(ref_cfg, ref_params["embed"],
                                    jnp.asarray(tokens))
    x = layers.embed_tokens(cfg, params["embed"], torch.from_numpy(tokens))
    _close(x, x_ref)
    w = _block(ref_params)["mix"]["wq"]
    _close(layers.matmul(x, _tblock(params)["mix"]["wq"]),
           ref_layers.matmul(x_ref, w))
    _close(layers.unembed(cfg, params["head"], x),
           ref_layers.unembed(ref_cfg, ref_params["head"], x_ref))


@pytest.mark.parametrize("mlp_kind", ["swiglu", "geglu", "gelu"])
def test_mlp_matches(models, mlp_kind):
    ref_cfg, cfg, _, _ = models
    rng = np.random.default_rng(3)
    d, f = cfg.d_model, cfg.d_ff
    names = ("wi_gate", "wi_up", "wo") if mlp_kind != "gelu" else ("wi", "wo")
    p = {n: (rng.standard_normal((f, d) if n == "wo" else (d, f)) * 0.1
             ).astype(np.float32) for n in names}
    x = rng.standard_normal((2, 4, d)).astype(np.float32)
    got = layers.apply_mlp(cfg.scaled(mlp_kind=mlp_kind),
                           {k: torch.from_numpy(v) for k, v in p.items()},
                           torch.from_numpy(x))
    want = ref_layers.apply_mlp(ref_cfg.scaled(mlp_kind=mlp_kind),
                                {k: jnp.asarray(v) for k, v in p.items()},
                                jnp.asarray(x))
    _close(got, want)


def test_rope_and_qkv_match(models):
    ref_cfg, cfg, ref_params, params = models
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    pos = (rng.integers(0, 40, (2, 1)) + np.arange(5)).astype(np.int32)
    hx = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    _close(layers.apply_rope(torch.from_numpy(hx), torch.from_numpy(pos),
                             cfg.rope_theta),
           ref_layers.apply_rope(jnp.asarray(hx), jnp.asarray(pos),
                                 ref_cfg.rope_theta))
    got = attention._qkv(cfg, _tblock(params)["mix"], torch.from_numpy(x),
                         torch.from_numpy(pos))
    want = ref_attention._qkv(ref_cfg, _block(ref_params)["mix"],
                              jnp.asarray(x), jnp.asarray(pos))
    for g, w in zip(got, want):
        _close(g, w)


# ------------------------------------------------------------ paged steps
def test_paged_steps_match_reference(models):
    """A ragged mixed chunk (rows of 8, 3 and 1 valid tokens over different
    contexts) and a decode step: logits and the written pools agree."""
    ref_cfg, cfg, ref_params, params = models
    rng = np.random.default_rng(5)
    bs, n_blocks, c = 4, 24, 8
    b = 3
    tables = rng.permutation(n_blocks)[: b * 6].reshape(b, 6).astype(np.int32)
    ctx = np.array([0, 5, 9])
    chunk_lens = np.array([8, 3, 1], np.int32)
    tokens = rng.integers(0, cfg.vocab_size, (b, c)).astype(np.int32)
    positions = (ctx[:, None] + np.minimum(np.arange(c)[None, :],
                                           chunk_lens[:, None] - 1)
                 ).astype(np.int32)
    # both packages start from the same random pools (prior context)
    shape = (cfg.n_layers, n_blocks, bs, cfg.n_kv_heads, cfg.resolved_head_dim)
    k0 = rng.standard_normal(shape).astype(np.float32)
    v0 = rng.standard_normal(shape).astype(np.float32)
    ref_pools = {"k": jnp.asarray(k0), "v": jnp.asarray(v0)}
    pools = init_pools(cfg, n_blocks, bs, device="cpu")
    pools["k"].copy_(torch.from_numpy(k0))
    pools["v"].copy_(torch.from_numpy(v0))
    lg_ref, ref_pools = ref_paged.paged_prefill_chunk(
        ref_cfg, ref_params, ref_pools, jnp.asarray(tables),
        jnp.asarray(tokens), jnp.asarray(positions), jnp.asarray(chunk_lens))
    lg, pools = paged_prefill_chunk(
        cfg, params, pools, torch.from_numpy(tables), torch.from_numpy(tokens),
        torch.from_numpy(positions), torch.from_numpy(chunk_lens))
    _close(lg, lg_ref, 2e-3)
    _close(pools["k"], ref_pools["k"], 2e-3)
    _close(pools["v"], ref_pools["v"], 2e-3)
    # one decode token per row after each row's last valid position
    last = positions[np.arange(b), chunk_lens - 1]
    dpos = (last + 1).astype(np.int32)
    dtok = rng.integers(0, cfg.vocab_size, (b,)).astype(np.int32)
    lg_ref, ref_pools = ref_paged.paged_decode_step(
        ref_cfg, ref_params, ref_pools, jnp.asarray(tables),
        jnp.asarray(dpos + 1), jnp.asarray(dtok), jnp.asarray(dpos))
    lg, pools = paged_decode_step(
        cfg, params, pools, torch.from_numpy(tables),
        torch.from_numpy(dpos + 1), torch.from_numpy(dtok),
        torch.from_numpy(dpos))
    _close(lg, lg_ref, 2e-3)
    _close(pools["k"], ref_pools["k"], 2e-3)


def test_init_pools_rejects_unknown_kv_dtype(models):
    """(As test_kv_int8.py:137; the other kv_dtype cases are in
    test_torch_int8.)"""
    _, cfg, _, _ = models
    with pytest.raises(ValueError, match="kv_dtype"):
        init_pools(cfg, 4, 4, kv_dtype="int4", device="cpu")


# ------------------------------------------------------------ engine
def _example_trace():
    """The ``examples/serve_engine.py`` model and trace: 24 prompts on 48
    blocks of size 4."""
    dims = dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=384,
                vocab_size=1024)
    ref_cfg = ref_smoke_config("stablelm-3b").scaled(**dims)
    cfg = get_smoke_config("stablelm-3b").scaled(**dims)
    prompts = [[(7 * i + j) % cfg.vocab_size for j in range(1 + i % 9)]
               for i in range(24)]
    return ref_cfg, cfg, prompts


def test_engine_tokens_match_reference():
    """Both engines serve the example trace to identical greedy tokens and
    drain to zero unreclaimed blocks with every block free."""
    ref_cfg, cfg, prompts = _example_trace()
    ref_params = build_model(ref_cfg).init(jax.random.key(0))
    params = from_jax_params(cfg, jax.tree.map(np.asarray, ref_params),
                             device="cpu")
    outs, stats = [], []
    for make in (lambda: RefEngine(ref_cfg, ref_params, n_blocks=48,
                                   block_size=4, max_batch=8, scheme="WFE",
                                   era_freq=4, cleanup_freq=4),
                 lambda: ServeEngine(cfg, params, n_blocks=48, block_size=4,
                                     max_batch=8, scheme="WFE", era_freq=4,
                                     cleanup_freq=4, device="cpu")):
        engine = make()
        tid = engine.pool.register_thread()
        reqs = [engine.submit(p, max_new_tokens=12) for p in prompts]
        st = engine.run(tid)
        assert st["completed"] == 24
        assert engine.pool.unreclaimed() == 0
        assert engine.pool.free_blocks == 48
        outs.append([r.generated for r in reqs])
        stats.append(st)
    assert outs[0] == outs[1]
    assert stats[0] == stats[1]
    assert 0 < engine.compile_cache_size() <= stats[1]["steps"]


def test_engine_forced_slow_path(models):
    """Engine correctness with WFE's slow path forced and every cleanup on
    the batched torch scan."""
    _, cfg, _, params = models
    engine = ServeEngine(cfg, params, n_blocks=32, block_size=4, max_batch=4,
                         cleanup_backend="torch", vectorized_threshold=1,
                         era_freq=1, cleanup_freq=1, max_attempts=1,
                         device="cpu")
    tid = engine.pool.register_thread()
    reqs = [engine.submit([3, 1, 4], 4) for _ in range(3)]
    stats = engine.run(tid)
    assert stats["completed"] == 3
    assert all(len(r.generated) == 4 for r in reqs)
    assert engine.pool.smr.stats()["slow_paths"] > 0
    assert engine.pool.unreclaimed() == 0 and engine.pool.free_blocks == 32


def test_engine_defaults_to_cuda(models):
    """With no device the engine runs on CUDA, and raises where there is
    none rather than carrying on on the CPU."""
    _, cfg, _, params = models
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default would succeed")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(cfg, params, n_blocks=8, block_size=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_pools(cfg, 4, 4)
    with pytest.raises(NotImplementedError):
        ServeEngine(cfg, params, n_blocks=8, block_size=4, n_shards=2,
                    device="cpu")
