"""``layers.matmul``'s products on one device in bf16, held against the
reference's ``matmul`` (``repro.models.layers``: a dot with
``preferred_element_type=f32``, cast once at the end).

* ``matmul(x, w, dtype=torch.float32)`` on bf16 activations is the
  unrounded f32 product: within f32 summation order of the reference's
  ``matmul(..., dtype=jnp.float32)`` (1e-6 of the largest |product|), at
  the RG-LRU gate's width (2560) too; its gradients within one bf16 ulp
  of ``jax.grad``'s;
* an output dtype other than the activation's gets one cast of the f32
  product (x f32, ``dtype=bfloat16``), and a call with no ``dtype`` keeps
  the plain bf16 product;
* the bf16 smoke configs of recurrentgemma-2b and xlstm-350m run
  ``forward`` to finite logits with every gate pre-activation (the
  ``dtype=float32`` products: RG-LRU's ``w_a``/``w_i``, the mLSTM's
  ``w_if``, the sLSTM's ``w_gates``) held to the reference's ``matmul`` on
  the same operands;
* the flags and registries the reference exports: ``perf_flags`` with
  ``bf16_collective_matmul`` and ``optimized()``, ``configs.all_configs()``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_configs as ref_all_configs
from repro.models import perf_flags as ref_flags
from repro.models.layers import matmul as ref_matmul
from repro_torch import configs
from repro_torch.configs import get_smoke_config
from repro_torch.models import build_model, layers, perf_flags, rglru, xlstm


def _case(shape_x, shape_w, seed=0, scale=0.02):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(shape_x).astype(np.float32)
                         ).to(torch.bfloat16)
    w = torch.from_numpy((rng.standard_normal(shape_w) * scale
                          ).astype(np.float32))
    return x, w


def _ref(x, w, dtype):
    return np.asarray(ref_matmul(jnp.asarray(x.float().numpy(), jnp.bfloat16),
                                 jnp.asarray(w.float().numpy()), dtype=dtype),
                      np.float32)


def _close_f32(got, want, rel=1e-6):
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("shape_x,shape_w", [
    ((4, 64, 2560), (2560, 2560)),  # recurrentgemma-2b's gate width
    ((2, 7, 96), (96, 40)),
    ((33, 128), (128, 24)),
])
def test_f32_output_is_the_unrounded_product(shape_x, shape_w):
    x, w = _case(shape_x, shape_w)
    got = layers.matmul(x, w, dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == (*shape_x[:-1],
                                                        shape_w[1])
    want = _ref(x, w, jnp.float32)
    _close_f32(got.numpy(), want)
    # the product rounded to bf16 first (the port's old route) is far off
    rounded = torch.matmul(x, w.to(x.dtype)).float().numpy()
    assert np.abs(rounded - want).max() > 100 * 1e-6 * np.abs(want).max()


def _bf16_ulp(a):
    a = np.maximum(np.abs(a), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(a)) - 7)


def test_f32_output_gradients_match_jax_grad():
    x, w = _case((3, 16, 256), (256, 64), seed=1)
    gout = np.random.default_rng(2).standard_normal((3, 16, 64)).astype(
        np.float32)
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    layers.matmul(xg, wg, dtype=torch.float32).backward(torch.from_numpy(gout))
    rdx, rdw = jax.grad(lambda a, b: jnp.sum(
        ref_matmul(a, b, dtype=jnp.float32) * gout), (0, 1))(
        jnp.asarray(x.float().numpy(), jnp.bfloat16), jnp.asarray(w.numpy()))
    assert xg.grad.dtype == torch.bfloat16 and wg.grad.dtype == torch.float32
    for got, want in ((xg.grad.float().numpy(), np.asarray(rdx, np.float32)),
                      (wg.grad.numpy(), np.asarray(rdw, np.float32))):
        ulp = _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
        assert (np.abs(got - want) <= ulp).all()


def test_other_output_dtypes_cast_the_f32_product_once():
    x, w = _case((5, 64), (64, 32), seed=3)
    xf = x.float()
    got = layers.matmul(xf, w, dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, torch.matmul(xf, w).to(torch.bfloat16),
                               rtol=0, atol=0)
    # no explicit dtype: the plain bf16 product (one rounding of an f32 sum)
    plain = layers.matmul(x, w)
    assert plain.dtype == torch.bfloat16
    torch.testing.assert_close(plain, torch.matmul(x, w.to(x.dtype)),
                               rtol=0, atol=0)


@pytest.mark.parametrize("arch,module,weights", [
    ("recurrentgemma-2b", rglru, {"w_a", "w_i"}),
    ("xlstm-350m", xlstm, {"w_if", "w_gates"}),
])
def test_bf16_smoke_forward_holds_its_gates(monkeypatch, arch, module,
                                            weights):
    """Every ``dtype=float32`` product of a bf16 forward is held to the
    reference's ``matmul`` on the same operands (the weights named here are
    the ones that reach it)."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=torch.bfloat16)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    seen = []

    def recording(x, w, dtype=None):
        out = layers.matmul(x, w, dtype=dtype)
        if dtype is torch.float32:
            seen.append((x.detach().clone(), w.detach().clone(),
                         out.detach().clone()))
        return out

    monkeypatch.setattr(module, "matmul", recording)
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 16)))
    with torch.no_grad():
        logits = model.forward(params, toks)
    assert torch.isfinite(logits.float()).all()
    names = {k for k, v in _named(params)
             if any(v.shape == w.shape and torch.equal(v.float(), w.float())
                    for _, w, _ in seen)}
    assert weights <= names, (weights, names)
    for x, w, out in seen:
        assert x.dtype == torch.bfloat16 and out.dtype == torch.float32
        _close_f32(out.numpy(), _ref(x, w, jnp.float32))


def _named(tree):
    """(name, leaf) of every leaf, a stacked (layers, in, out) leaf once
    per layer."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named(v)
        else:
            for i in range(v.shape[0]) if v.ndim == 3 else (None,):
                yield k, (v if i is None else v[i])


def test_flags_and_optimized_match_the_reference():
    assert perf_flags.FLAGS == ref_flags.FLAGS
    prev, ref_prev = perf_flags.optimized(), ref_flags.optimized()
    try:
        assert prev == ref_prev
        assert perf_flags.FLAGS == ref_flags.FLAGS
        assert all(perf_flags.FLAGS.values())
    finally:
        perf_flags.set_flags(**prev)
        ref_flags.set_flags(**ref_prev)
    assert perf_flags.FLAGS["bf16_collective_matmul"] is False


def test_all_configs_match_the_reference():
    got, want = configs.all_configs(), ref_all_configs()
    assert list(got) == list(want) == list(configs.ALL_ARCHS)
    assert "all_configs" in configs.__all__
    for name, cfg in got.items():
        assert cfg is configs.get_config(name)
        assert cfg.name == want[name].name
        assert cfg.n_layers == want[name].n_layers
        assert cfg.d_model == want[name].d_model
