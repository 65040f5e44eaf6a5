"""The dense archs the paged engine serves, held against ``repro`` on the CPU.

starcoder2-3b and -7b (LayerNorm with bias, GELU-tanh MLP, GQA), gemma-7b
(GeGLU, a tied head, sqrt(d_model) input scaling, head_dim 256 at full
width) and pixtral-12b's text decoder (SwiGLU, rope theta 1e9, and a patch
frontend that the paged steps never read).  For each, on its smoke config:
the parameter tree carried from the reference, the full-width parameter
count without allocating, the paged steps' logits, and the engine's greedy
tokens.  Gemma's smoke config at head_dim 256 holds the paged steps at the
head dim of the full model.

Weights come from one reference pytree carried over by
``from_jax_params``; inputs from a NumPy seed.  Tolerances: step logits
2e-3 in f32 (as ``test_torch_serve``), engine tokens and stats exact.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import build_model
from repro.serve import ServeEngine as RefEngine
from repro.serve import paged_model as ref_paged
from repro_torch.configs import ALL_ARCHS, get_config, get_smoke_config
from repro_torch.models.params import _shapes, from_jax_params, init_params
from repro_torch.serve import (ServeEngine, init_pools, paged_decode_step,
                               paged_prefill_chunk)

torch.backends.cuda.matmul.allow_tf32 = False

NEW_ARCHS = ("starcoder2-3b", "starcoder2-7b", "gemma-7b", "pixtral-12b")
#: parameters of each full-width model, from ``jax.eval_shape`` of the
#: reference's init
FULL_PARAMS = {"starcoder2-3b": 3_180_705_792,
               "starcoder2-7b": 7_399_351_296,
               "gemma-7b": 8_537_680_896,
               "pixtral-12b": 12_273_996_800}


def test_registry_lists_the_served_archs():
    """Of the registry's ten archs, the paged engine serves these five."""
    from repro_torch.serve.paged_model import _check_paged_support

    served = []
    for arch in ALL_ARCHS:
        try:
            _check_paged_support(get_smoke_config(arch))
            served.append(arch)
        except (NotImplementedError, ValueError):
            pass
    assert tuple(served) == ("stablelm-3b",) + NEW_ARCHS


def _models(arch, **scale):
    ref_cfg = ref_smoke_config(arch).scaled(**scale)
    cfg = get_smoke_config(arch).scaled(**scale)
    ref_params = build_model(ref_cfg).init(jax.random.key(0))
    params = from_jax_params(cfg, jax.tree.map(np.asarray, ref_params),
                             device="cpu")
    return ref_cfg, cfg, ref_params, params


def _flat(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (k,)))
        return out
    return {path: tree}


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_param_tree_matches_reference(arch):
    """from_jax_params and init_params give the reference's keys, shapes
    and (at the f32 smoke size) dtypes, pixtral's frontend included; the
    carried values are the reference's."""
    ref_cfg, cfg, ref_params, params = _models(arch)
    want = _flat(jax.tree.map(np.asarray, ref_params))
    mine = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    for tree in (params, mine):
        got = _flat(tree)
        assert set(got) == set(want)
        for path, arr in want.items():
            t = got[path]
            assert tuple(t.shape) == arr.shape, path
            assert t.dtype == torch.float32 and arr.dtype == np.float32
            assert torch.isfinite(t).all()
    for path, arr in want.items():
        np.testing.assert_array_equal(_flat(params)[path].numpy(), arr)
    assert (("frontend", "proj") in want) == (arch == "pixtral-12b")
    assert (("final_norm", "bias") in want) == (cfg.norm_kind == "layernorm")
    assert (("head", "kernel") in want) == (not cfg.tie_embeddings)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_full_width_param_count(arch):
    """The port's full-width tree, built from shapes only, counts the
    parameters of ``jax.eval_shape`` of the reference's init, leaf by
    leaf; nothing is allocated on either side."""
    ref_tree = jax.eval_shape(build_model(ref_config(arch)).init,
                              jax.random.key(0))
    want = {tuple(p.key for p in path): leaf.shape for path, leaf
            in jax.tree_util.tree_flatten_with_path(ref_tree)[0]}
    got = {path: spec[0] for path, spec in _flat(_shapes(get_config(arch)))
           .items()}
    assert got == want
    count = sum(math.prod(s) for s in got.values())
    assert count == FULL_PARAMS[arch]


def _step_inputs(cfg, rng, n_blocks, bs, b, c):
    tables = rng.permutation(n_blocks)[: b * 6].reshape(b, 6).astype(np.int32)
    ctx = np.array([0, 5, 9])[:b]
    chunk_lens = np.array([c, 3, 1], np.int32)[:b]
    tokens = rng.integers(0, cfg.vocab_size, (b, c)).astype(np.int32)
    positions = (ctx[:, None] + np.minimum(np.arange(c)[None, :],
                                           chunk_lens[:, None] - 1)
                 ).astype(np.int32)
    return tables, chunk_lens, tokens, positions


def _hold_paged_steps(ref_cfg, cfg, ref_params, params, seed):
    """A ragged mixed chunk (rows of 8, 3 and 1 valid tokens over different
    contexts), then a decode step: the logits agree within 2e-3, and so do
    the written pools (float pools)."""
    rng = np.random.default_rng(seed)
    bs, n_blocks, c, b = 4, 24, 8, 3
    tables, chunk_lens, tokens, positions = _step_inputs(cfg, rng, n_blocks,
                                                         bs, b, c)
    shape = (cfg.n_layers, n_blocks, bs, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    k0 = rng.standard_normal(shape).astype(np.float32)
    v0 = rng.standard_normal(shape).astype(np.float32)
    ref_pools = {"k": jnp.asarray(k0), "v": jnp.asarray(v0)}
    pools = init_pools(cfg, n_blocks, bs, device="cpu")
    pools["k"].copy_(torch.from_numpy(k0))
    pools["v"].copy_(torch.from_numpy(v0))
    j, t = jnp.asarray, torch.from_numpy
    lg_ref, ref_pools = ref_paged.paged_prefill_chunk(
        ref_cfg, ref_params, ref_pools, j(tables), j(tokens), j(positions),
        j(chunk_lens))
    lg, pools = paged_prefill_chunk(cfg, params, pools, t(tables), t(tokens),
                                    t(positions), t(chunk_lens))
    close = dict(rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(lg.numpy(), np.asarray(lg_ref), **close)
    np.testing.assert_allclose(pools["k"].numpy(), np.asarray(ref_pools["k"]),
                               **close)
    np.testing.assert_allclose(pools["v"].numpy(), np.asarray(ref_pools["v"]),
                               **close)
    last = positions[np.arange(b), chunk_lens - 1]
    dpos = (last + 1).astype(np.int32)
    dtok = rng.integers(0, cfg.vocab_size, (b,)).astype(np.int32)
    lg_ref, ref_pools = ref_paged.paged_decode_step(
        ref_cfg, ref_params, ref_pools, j(tables), j(dpos + 1), j(dtok),
        j(dpos))
    lg, pools = paged_decode_step(cfg, params, pools, t(tables),
                                  t(dpos + 1), t(dtok), t(dpos))
    np.testing.assert_allclose(lg.numpy(), np.asarray(lg_ref), **close)
    np.testing.assert_allclose(pools["k"].numpy(), np.asarray(ref_pools["k"]),
                               **close)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_paged_steps_match_reference(arch):
    _hold_paged_steps(*_models(arch), seed=len(arch))


def test_paged_steps_at_head_dim_256_match_reference():
    """gemma-7b's head dim on its smoke config, on both sides."""
    models = _models("gemma-7b", head_dim=256)
    assert models[1].resolved_head_dim == 256
    _hold_paged_steps(*models, seed=256)


PROMPTS = [[(5 * i + j) % 256 for j in range(1 + (3 * i) % 11)]
           for i in range(6)]


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_engine_tokens_match_reference(arch):
    """Both engines serve one seeded trace (6 prompts of 1-11 tokens, 5 new
    tokens each, chunked prefill) to identical greedy tokens and stats and
    drain to zero unreclaimed blocks with every block free."""
    ref_cfg, cfg, ref_params, params = _models(arch)
    kw = dict(n_blocks=32, block_size=4, max_batch=4, chunk_size=4,
              scheme="WFE", era_freq=2, cleanup_freq=2)
    outs, stats = [], []
    for make in (lambda: RefEngine(ref_cfg, ref_params, **kw),
                 lambda: ServeEngine(cfg, params, device="cpu", **kw)):
        engine = make()
        tid = engine.pool.register_thread()
        reqs = [engine.submit(p, max_new_tokens=5) for p in PROMPTS]
        st = engine.run(tid)
        assert st["completed"] == len(PROMPTS)
        assert engine.pool.unreclaimed() == 0
        assert engine.pool.free_blocks == 32
        outs.append([r.generated for r in reqs])
        stats.append(st)
    assert outs[0] == outs[1]
    assert stats[0] == stats[1]


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_serving_cli_serves_each_arch(arch, capsys):
    """``python -m repro_torch.launch.serve --arch <arch> --device cpu``
    serves its requests to completion and drains."""
    from repro_torch.launch.serve import main

    assert main(["--arch", arch, "--device", "cpu", "--requests", "4"]) == 0
    out = capsys.readouterr().out
    assert "completed=4" in out and "'unreclaimed': 0" in out
