"""The port's model zoo (``repro_torch.models``) held against ``repro.models``
on the CPU, for all ten archs' smoke configs (f32).

Weights come from one reference pytree (``build_model(cfg).init(key(0))``)
carried over by ``from_jax_params``; tokens, patch embeddings and frames
from a NumPy seed.  The reference runs once per arch (forward, loss,
prefill and two decode steps, shared by the tests through a module
fixture).  Tolerances: 1e-4 against the reference (the two packages sum in
different orders; the RG-LRU scan combines in another order), 2e-3 for the
port's own prefill and decode against its forward (the reference's
``test_arch_smoke`` identity).  Parameter counts are held exactly at the
full configs, and the flash route of every attention call of a prefill
and a decode step is held against the table of ``models.attention``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ALL_ARCHS as REF_ARCHS
from repro.configs import get_config as ref_config
from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import build_model as ref_build
from repro.models import perf_flags as ref_flags
from repro_torch.configs import ALL_ARCHS, get_config, get_smoke_config
from repro_torch.models import (attention, build_model, count_params,
                                from_jax_params, init_params, perf_flags)
from repro_torch.models.params import leaves

torch.backends.cuda.matmul.allow_tf32 = False

B, S = 2, 16
REF_TOL = dict(rtol=1e-4, atol=1e-4)
OWN_TOL = dict(rtol=2e-3, atol=2e-3)
#: the archs the model zoo brought to the port (the others were served
#: already; their trees are held in test_torch_archs.py)
NEW_ARCHS = ("recurrentgemma-2b", "deepseek-v2-236b", "mixtral-8x7b",
             "xlstm-350m", "whisper-small")


def _extras(cfg, rng):
    """Seeded patch embeddings or frames, as test_arch_smoke.py:22."""
    extra = {}
    if cfg.frontend == "patches":
        extra["patch_embeds"] = 0.02 * rng.standard_normal(
            (B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "frames":
        extra["frames"] = 0.02 * rng.standard_normal(
            (B, cfg.encoder_ctx, cfg.d_model)).astype(np.float32)
    return extra


def _both(extra):
    return ({k: jnp.asarray(v) for k, v in extra.items()},
            {k: torch.from_numpy(v) for k, v in extra.items()})


def _pos(p, lib):
    if lib is torch:
        return torch.full((B,), p, dtype=torch.int32)
    return jnp.full((B,), p, jnp.int32)


def _models(arch, **scale):
    ref_cfg = ref_smoke_config(arch).scaled(**scale)
    cfg = get_smoke_config(arch).scaled(**scale)
    ref_params = ref_build(ref_cfg).init(jax.random.key(0))
    params = from_jax_params(cfg, jax.tree.map(np.asarray, ref_params),
                             device="cpu")
    return ref_cfg, cfg, ref_params, params


@pytest.fixture(scope="module")
def rig():
    """Per arch: both models, the seeded inputs and the reference's
    forward, loss, prefill and two decode steps, computed once."""
    cache = {}

    def get(arch):
        if arch not in cache:
            ref_cfg, cfg, ref_params, params = _models(arch)
            rng = np.random.default_rng(len(arch))
            toks = rng.integers(0, cfg.vocab_size, (B, S + 2)).astype(np.int32)
            labels = rng.integers(0, cfg.vocab_size, (B, S + 2)).astype(
                np.int32)
            labels[0, :3] = -1  # padding
            extra = _extras(cfg, rng)
            jx, _ = _both(extra)
            ref = ref_build(ref_cfg)
            out = {"forward": np.asarray(ref.forward(ref_params,
                                                     jnp.asarray(toks), jx)),
                   "loss": float(ref.loss(ref_params, {
                       "tokens": jnp.asarray(toks),
                       "labels": jnp.asarray(labels), **jx}))}
            lg, c = ref.prefill(ref_params, jnp.asarray(toks[:, :S]),
                                max_len=S + 4, extra=jx)
            out["prefill"] = np.asarray(lg)
            for i in range(2):
                lg, c = ref.decode_step(ref_params, c,
                                        jnp.asarray(toks[:, S + i]),
                                        _pos(S + i, jnp))
                out[f"decode{i}"] = np.asarray(lg)
            cache[arch] = dict(ref_cfg=ref_cfg, cfg=cfg,
                               ref_params=ref_params, params=params,
                               toks=toks, labels=labels, extra=extra,
                               ref=out)
        return cache[arch]

    return get


def _port_prefill_decode(cfg, params, toks, extra):
    """The port's prefill of S tokens and two decode steps' logits."""
    model = build_model(cfg)
    _, tx = _both(extra)
    t = torch.from_numpy(toks)
    lg, cache = model.prefill(params, t[:, :S], max_len=S + 4, extra=tx)
    out = [lg]
    for i in range(2):
        lg, cache = model.decode_step(params, cache, t[:, S + i],
                                      _pos(S + i, torch))
        out.append(lg)
    return [o.numpy() for o in out]


def _fields(cfg):
    """Config fields, dtypes by their name (``float32`` on both sides)."""
    def name(v):
        return getattr(v, "__name__", str(v).split(".")[-1])
    return {f.name: name(getattr(cfg, f.name))
            for f in dataclasses.fields(cfg)}


def test_registry_and_configs_match_reference():
    """ALL_ARCHS is the reference's, in its order, and every full and smoke
    config has the reference's fields (dtypes by name)."""
    assert ALL_ARCHS == REF_ARCHS
    for arch in ALL_ARCHS:
        assert _fields(get_config(arch)) == _fields(ref_config(arch))
        assert _fields(get_smoke_config(arch)) == \
            _fields(ref_smoke_config(arch))


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_param_tree_matches_reference(arch):
    """from_jax_params and init_params give the reference's keys and shapes;
    the carried values are the reference's; in bf16 the leaves the
    reference reads in f32 stay f32 and the rest are stored in bf16."""
    ref_cfg, cfg, ref_params, params = _models(arch)
    want = {tuple(p.key for p in path): np.asarray(leaf) for path, leaf
            in jax.tree_util.tree_flatten_with_path(ref_params)[0]}
    got = dict(leaves(params))
    assert set(got) == set(want)
    for path, arr in want.items():
        np.testing.assert_array_equal(got[path].numpy(), arr)
    bf16 = init_params(cfg.scaled(dtype=torch.bfloat16),
                       torch.Generator().manual_seed(0), device="cpu")
    f32_names = {"scale", "bias", "lam", "b_a", "b_i", "conv_b", "r_gates",
                 "b_gates", "b_if", "skip_scale", "norm_kv", "norm_q"}
    for path, t in leaves(bf16):
        assert tuple(t.shape) == want[path].shape, path
        assert torch.isfinite(t.float()).all(), path
        assert t.dtype == (torch.float32 if path[-1] in f32_names
                           else torch.bfloat16), path


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_counts_match_reference(arch):
    """Total and active parameter counts of the FULL config, from the shape
    tree alone, equal the reference's (jax.eval_shape of its init)."""
    cfg, ref = get_config(arch), ref_config(arch)
    assert count_params(cfg) == ref.param_count() == cfg.param_count()
    assert count_params(cfg, active_only=True) == \
        ref.active_param_count() == cfg.active_param_count()


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_forward_and_loss_match_reference(rig, arch):
    r = rig(arch)
    model = build_model(r["cfg"])
    _, tx = _both(r["extra"])
    toks = torch.from_numpy(r["toks"])
    logits = model.forward(r["params"], toks, tx)
    assert logits.shape == (B, S + 2, r["cfg"].vocab_size)
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), r["ref"]["forward"], **REF_TOL)
    loss = model.loss(r["params"], {"tokens": toks,
                                    "labels": torch.from_numpy(r["labels"]),
                                    **tx})
    np.testing.assert_allclose(float(loss), r["ref"]["loss"], **REF_TOL)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_prefill_and_decode_match_reference(rig, arch):
    r = rig(arch)
    got = _port_prefill_decode(r["cfg"], r["params"], r["toks"], r["extra"])
    for name, lg in zip(("prefill", "decode0", "decode1"), got):
        np.testing.assert_allclose(lg, r["ref"][name], **REF_TOL,
                                   err_msg=f"{arch}: {name}")


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_prefill_and_decode_match_own_forward(rig, arch):
    """decode_step(prefill(x[:s]), x[s]) == forward(x[:s+2])[:, s], the
    identity of test_arch_smoke.py:94-119, on the port alone."""
    r = rig(arch)
    _, tx = _both(r["extra"])
    full = build_model(r["cfg"]).forward(
        r["params"], torch.from_numpy(r["toks"]), tx).numpy()
    got = _port_prefill_decode(r["cfg"], r["params"], r["toks"], r["extra"])
    for i, lg in enumerate(got):
        np.testing.assert_allclose(lg, full[:, S - 1 + i], **OWN_TOL,
                                   err_msg=f"{arch}: step {i}")


def test_windowed_decode_ring_buffer():
    """mixtral's ring cache (S 24 > window 16): the port's decode past the
    window matches its forward, and the reference's decode."""
    ref_cfg, cfg, ref_params, params = _models("mixtral-8x7b")
    s, w = 24, cfg.window
    assert s > w
    toks = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (B, s + 1)).astype(np.int32)
    ref = ref_build(ref_cfg)
    _, rc = ref.prefill(ref_params, jnp.asarray(toks[:, :s]), max_len=s)
    want, _ = ref.decode_step(ref_params, rc, jnp.asarray(toks[:, s]),
                              _pos(s, jnp))
    model = build_model(cfg)
    t = torch.from_numpy(toks)
    full = model.forward(params, t).numpy()
    _, cache = model.prefill(params, t[:, :s], max_len=s)
    assert cache["groups"]["b0_swa"]["k"].shape[2] == w  # ring slots
    lg, _ = model.decode_step(params, cache, t[:, s], _pos(s, torch))
    np.testing.assert_allclose(lg.numpy(), full[:, s], **OWN_TOL)
    np.testing.assert_allclose(lg.numpy(), np.asarray(want), **REF_TOL)


@pytest.mark.parametrize("arch", ["stablelm-3b", "mixtral-8x7b",
                                  "deepseek-v2-236b"])
def test_one_hot_cache_update_matches_reference(rig, arch):
    """``scatter_cache_update=False`` (the one-hot blend: full GQA, ring
    GQA, MLA latents) on both sides gives the scatter's logits."""
    r = rig(arch)
    prev_ref = ref_flags.set_flags(scatter_cache_update=False)
    prev = perf_flags.set_flags(scatter_cache_update=False)
    try:
        jx, _ = _both(r["extra"])
        ref = ref_build(r["ref_cfg"])
        lg, c = ref.prefill(r["ref_params"], jnp.asarray(r["toks"][:, :S]),
                            max_len=S + 4, extra=jx)
        want = []
        for i in range(2):
            lg, c = ref.decode_step(r["ref_params"], c,
                                    jnp.asarray(r["toks"][:, S + i]),
                                    _pos(S + i, jnp))
            want.append(np.asarray(lg))
        got = _port_prefill_decode(r["cfg"], r["params"], r["toks"],
                                   r["extra"])
    finally:
        ref_flags.set_flags(**prev_ref)
        perf_flags.set_flags(**prev)
    for i in range(2):
        np.testing.assert_allclose(got[1 + i], want[i], **REF_TOL)
        np.testing.assert_allclose(got[1 + i], r["ref"][f"decode{i}"],
                                   **REF_TOL)


def _expected_routes(cfg, t, decode):
    """(kernel, plain) flash calls on the card for a prefill of t tokens
    (or one decode step): the table of ``models.attention``."""
    n_attn = cfg.n_groups * sum(k in ("attn", "local_attn", "swa")
                                for k in cfg.block_pattern)
    windowed = any(k in ("local_attn", "swa") for k in cfg.block_pattern)
    if cfg.is_encoder_decoder:  # cross-attention is always plain
        return ((0, cfg.n_layers) if decode else
                (cfg.n_encoder_layers + cfg.n_layers, cfg.n_layers))
    if decode:
        return 0, 0
    if cfg.use_mla or (windowed and t > cfg.window):
        return 0, n_attn
    return n_attn, 0


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_flash_routes_follow_the_table(monkeypatch, arch):
    """Every flash_attention call of the port's prefill (at T within and
    past a window) and of a decode step, routed as on the card
    (``flash_route`` with device type "cuda"), gives the table's counts;
    on the CPU every call counts as plain."""
    cfg = get_smoke_config(arch)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    calls = []
    real = attention.flash_route

    def record(device_type, *args, **kw):
        calls.append((args, kw))
        return real(device_type, *args, **kw)

    monkeypatch.setattr(attention, "flash_route", record)
    model = build_model(cfg)
    rng = np.random.default_rng(1)
    extra = {k: torch.from_numpy(v) for k, v in _extras(cfg, rng).items()}
    lengths = [8, 24] if cfg.window else [16]
    for t in lengths:
        for decode in (False, True):
            toks = torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (B, t + 1)).astype(np.int32))
            if not decode:
                calls.clear()
                plain0 = attention.FLASH_ROUTES["plain"].n
                kernel0 = attention.FLASH_ROUTES["kernel"].n
                _, cache = model.prefill(params, toks[:, :t], max_len=t + 1,
                                         extra=extra)
            else:
                calls.clear()
                plain0 = attention.FLASH_ROUTES["plain"].n
                kernel0 = attention.FLASH_ROUTES["kernel"].n
                model.decode_step(params, cache, toks[:, t], _pos(t, torch))
            on_card = [real("cuda", *a, **kw) for a, kw in calls]
            got = (on_card.count("kernel"), on_card.count("plain"))
            assert got == _expected_routes(cfg, t, decode), (t, decode)
            assert attention.FLASH_ROUTES["kernel"].n == kernel0
            assert attention.FLASH_ROUTES["plain"].n - plain0 == len(calls)


@pytest.mark.parametrize("facts,route", [
    (dict(), "kernel"),
    (dict(device_type="cpu"), "plain"),
    (dict(arange_positions=False), "plain"),
    (dict(k_shape=(2, 32, 2, 64), v_shape=(2, 32, 2, 64)), "plain"),
    (dict(window=63), "plain"),
    (dict(window=64), "kernel"),
    (dict(v_shape=(2, 64, 2, 32)), "plain"),           # Dv != D (MLA)
    (dict(q_shape=(2, 64, 4, 320), k_shape=(2, 64, 2, 320),
          v_shape=(2, 64, 2, 320)), "plain"),         # D > 256
    (dict(dtype=torch.float16), "plain"),
    (dict(dtype=None), "plain"),                       # mixed dtypes
    (dict(scale=0.5), "plain"),
    (dict(dtype=torch.bfloat16, scale=1 / 8), "kernel"),
])
def test_flash_route_function(facts, route):
    """The route is a pure function of call-site facts and shapes."""
    kw = dict(device_type="cuda", dtype=torch.float32, q_shape=(2, 64, 4, 64),
              k_shape=(2, 64, 2, 64), v_shape=(2, 64, 2, 64),
              arange_positions=True, window=None, scale=None)
    kw.update(facts)
    args = [kw.pop(k) for k in ("device_type", "dtype", "q_shape", "k_shape",
                                "v_shape")]
    assert attention.flash_route(*args, **kw) == route
