"""The port's paged latent (MLA) decode held against ``repro`` on the CPU,
and the serving refusals of the archs the paged engine does not take.

The paged step is the reference's own check
(``test_blocks_serve.py:261``): the prefill's latents are copied into
pages through permuted block tables, then one paged decode step runs
against the contiguous ``decode_step``.  Here both packages do it from the
same weights (the reference's init, carried over) and seeded tokens: the
port's paged logits agree with the reference's paged logits within 1e-4
and with its own contiguous decode within 2e-3, over several steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import build_model as ref_build
from repro.serve.paged_model import init_mla_pools as ref_init_mla_pools
from repro.serve.paged_model import paged_mla_decode_step as ref_paged_mla
from repro_torch.configs import get_smoke_config
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import build_model, from_jax_params, init_params
from repro_torch.serve import (ServeEngine, init_mla_pools,
                               paged_mla_decode_step)

torch.backends.cuda.matmul.allow_tf32 = False

ARCH = "deepseek-v2-236b"


@pytest.fixture(scope="module")
def models():
    ref_cfg, cfg = ref_smoke_config(ARCH), get_smoke_config(ARCH)
    ref_params = ref_build(ref_cfg).init(jax.random.key(0))
    params = from_jax_params(cfg, jax.tree.map(np.asarray, ref_params),
                             device="cpu")
    return ref_cfg, cfg, ref_params, params


def _fill(lat, cache, tables, s, bs):
    """Copy each layer's first s latent rows (c_kv ‖ k_rope) into the pages
    the tables name (lat: (L, N, bs, r + dr), NumPy)."""
    b = tables.shape[0]
    c = cache["groups"]["b0_attn"]
    rows = np.concatenate([np.asarray(c["c_kv"])[:, :, :s],
                           np.asarray(c["k_rope"])[:, :, :s]], -1)
    for l in range(lat.shape[0]):
        lat[l, tables[:, :s // bs]] = rows[l].reshape(b, s // bs, bs, -1)
    return lat


def test_paged_mla_decode_matches_reference(models):
    ref_cfg, cfg, ref_params, params = models
    b, s, bs, n_blocks, steps = 2, 8, 4, 16, 3
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, (b, s + steps)).astype(np.int32)
    tables = rng.permutation(n_blocks)[:b * 4].reshape(b, 4).astype(np.int32)
    _, ref_cache = ref_build(ref_cfg).prefill(
        ref_params, jnp.asarray(toks[:, :s]), max_len=s + steps)
    lat = _fill(np.asarray(ref_init_mla_pools(ref_cfg, n_blocks, bs)["lat"]
                           ).copy(), ref_cache, tables, s, bs)
    ref_pools = {"lat": jnp.asarray(lat)}
    pools = {"lat": torch.from_numpy(lat.copy())}

    model = build_model(cfg)
    _, cache = model.prefill(params, torch.from_numpy(toks[:, :s]),
                             max_len=s + steps)
    for i in range(steps):
        pos = np.full((b,), s + i, np.int32)
        args = (tables, pos + 1, toks[:, s + i], pos)
        want, ref_pools = ref_paged_mla(ref_cfg, ref_params, ref_pools,
                                        *map(jnp.asarray, args))
        got, pools = paged_mla_decode_step(cfg, params, pools,
                                           *map(torch.from_numpy, args))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4, err_msg=f"step {i}")
        dense, cache = model.decode_step(params, cache,
                                         torch.from_numpy(toks[:, s + i]),
                                         torch.from_numpy(pos))
        np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=2e-3,
                                   atol=2e-3, err_msg=f"step {i}")
    np.testing.assert_allclose(pools["lat"].numpy(),
                               np.asarray(ref_pools["lat"]), rtol=1e-4,
                               atol=1e-4)


def test_init_mla_pools_refuses_as_the_reference(models):
    ref_cfg, cfg, _, _ = models
    for init, c, kw in ((init_mla_pools, cfg, dict(device="cpu")),
                        (ref_init_mla_pools, ref_cfg, {})):
        with pytest.raises(NotImplementedError, match="int8"):
            init(c, 4, 4, kv_dtype="int8", **kw)
        with pytest.raises(ValueError, match="kv_dtype"):
            init(c, 4, 4, kv_dtype="fp64", **kw)
    pools = init_mla_pools(cfg, 5, 4, kv_dtype="bf16", device="cpu")
    assert pools["lat"].shape == (cfg.n_layers, 5, 4,
                                  cfg.kv_lora_rank + cfg.rope_head_dim)
    assert pools["lat"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch,error", [
    ("deepseek-v2-236b", NotImplementedError),
    ("whisper-small", NotImplementedError),
    ("mixtral-8x7b", ValueError),
    ("recurrentgemma-2b", ValueError),
    ("xlstm-350m", ValueError),
])
def test_serving_refuses_unpaged_archs(arch, error, capsys):
    """The engine refuses MLA, encoder-decoder and non-``attn`` archs with a
    message before building a pool, and the serving CLI exits with one, as
    the reference's does."""
    cfg = get_smoke_config(arch)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(error, match=cfg.name):
        ServeEngine(cfg, params, device="cpu")
    with pytest.raises(SystemExit, match="paged engine serves"):
        serve_main(["--arch", arch, "--device", "cpu"])
