"""The port's MoE layer (``repro_torch.models.moe``) held against
``repro.models.moe`` on the CPU, at the deepseek-v2 and mixtral smoke
configs with the capacity lowered so that tokens overflow.

Weights come from the reference's init carried over by ``from_jax_params``;
activations and router logits from a NumPy seed.  The kept assignments
are held against a NumPy model of the reference's rule (a stable sort by
expert keeps, for each expert, its first ``capacity`` assignments in
(token, choice) order), and the outputs against the reference's within
1e-5 (f32; the two sum in different orders).  In bf16, where JAX on the
CPU cannot run the reference's f32-output dot, the expert products are
held to a model of the reference's rounding points.  The dense paged steps
take a MoE FFN, as the reference's do.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import build_model as ref_build
from repro.models import moe as ref_moe
from repro.serve import paged_model as ref_paged
from repro_torch.configs import get_smoke_config
from repro_torch.models import from_jax_params, moe
from repro_torch.serve import init_pools, paged_decode_step, paged_prefill_chunk

torch.backends.cuda.matmul.allow_tf32 = False

TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = ("deepseek-v2-236b", "mixtral-8x7b")


def _layer(arch, **scale):
    """(ref cfg, cfg, the reference's and the port's layer-0 MoE params)."""
    ref_cfg = ref_smoke_config(arch).scaled(**scale)
    cfg = get_smoke_config(arch).scaled(**scale)
    ref_params = ref_build(ref_cfg).init(jax.random.key(0))
    params = from_jax_params(cfg, jax.tree.map(np.asarray, ref_params),
                             device="cpu")
    kind = f"b0_{cfg.block_pattern[0]}"
    ref_p = jax.tree.map(lambda a: a[0], ref_params["groups"][kind]["mlp"])
    p = jax.tree.map(lambda a: a[0], params["groups"][kind]["mlp"])
    return ref_cfg, cfg, ref_p, p


def _x(cfg, b, s, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)


def _kept_model(top_e, n_experts, capacity):
    """The reference's capacity rule in NumPy: (token, choice) pairs kept."""
    seen = np.zeros(n_experts, int)
    kept = set()
    for t, row in enumerate(top_e):
        for j, ex in enumerate(row):
            if seen[ex] < capacity:
                kept.add((t, j))
            seen[ex] += 1
    return kept


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("capacity_factor", [0.5, 1.0])
def test_overflowing_capacity_keeps_the_reference_assignments(
        arch, capacity_factor):
    ref_cfg, cfg, ref_p, p = _layer(arch, capacity_factor=capacity_factor)
    x = _x(cfg, 3, 40, seed=len(arch))
    want = np.asarray(ref_moe.apply_moe(ref_cfg, ref_p, jnp.asarray(x)))
    xt = torch.from_numpy(x)
    got = moe.apply_moe(cfg, p, xt)
    np.testing.assert_allclose(got.numpy(), want, **TOL)

    t = 3 * 40
    cap = moe.capacity_for(cfg, t)
    assert cap == min(max(8, -(-int(capacity_factor * t * cfg.top_k
                                    / cfg.n_experts) // 8) * 8),
                      t * cfg.top_k)
    _, _, top_e = moe.route(cfg, p, xt.reshape(t, -1))
    order, slot, keep = moe.assign(top_e, cfg.n_experts, cap)
    flat = order.numpy()
    kept = {(i // cfg.top_k, i % cfg.top_k) for i in flat[keep.numpy()]}
    assert kept == _kept_model(top_e.numpy(), cfg.n_experts, cap)
    assert len(kept) < t * cfg.top_k  # tokens did overflow
    # kept slots are distinct rows of the buffer; dropped ones the spare
    s = slot.numpy()
    assert len(set(s[keep.numpy()])) == len(kept)
    assert (s[~keep.numpy()] == cfg.n_experts * cap).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_explicit_capacity_matches_reference(arch):
    ref_cfg, cfg, ref_p, p = _layer(arch)
    x = _x(cfg, 2, 24, seed=3)
    for cap in (1, 8, 1000):
        want = ref_moe.apply_moe(ref_cfg, ref_p, jnp.asarray(x), capacity=cap)
        got = moe.apply_moe(cfg, p, torch.from_numpy(x), capacity=cap)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _bf16_model(cfg, p, x, round_gating=False):
    """The reference's rounding points in bf16, expert by expert: f32
    router, gate and up products of bf16 operands, silu on them
    unrounded (``round_gating``: rounded to bf16 first, the planted
    fault), the gated product and the down projection rounded to bf16,
    each token's weighted outputs summed in f32 and rounded once."""
    b, s, d = x.shape
    t, k, bf = b * s, cfg.top_k, torch.bfloat16
    xf = x.reshape(t, d).float()
    w = {n: p[n].to(bf).float() for n in ("router", "wi_gate", "wi_up", "wo")}
    top_p, top_e = torch.topk(torch.softmax(xf @ w["router"], -1), k, -1)
    top_p = top_p / top_p.sum(-1, keepdim=True)
    kept = _kept_model(top_e.numpy(), cfg.n_experts,
                       moe.capacity_for(cfg, t))
    out = torch.zeros((t, d))
    for tok, j in sorted(kept):
        ex = int(top_e[tok, j])
        g, u = xf[tok] @ w["wi_gate"][ex], xf[tok] @ w["wi_up"][ex]
        if round_gating:
            g, u = g.to(bf).float(), u.to(bf).float()
        h = (torch.nn.functional.silu(g) * u).to(bf).float()
        y = (h @ w["wo"][ex]).to(bf)
        out[tok] += (y * top_p[tok, j].to(bf)).float()
    return out.to(bf).reshape(b, s, d)


#: bf16 outputs: relative RMS error limit against ``_bf16_model``.  Sums in
#: another order flip a share of the bf16 roundings by one step (one step
#: is about 1.1e-3 in relative RMS); gate and up rounded to bf16 before
#: silu give about 4.7e-3
BF16_REL_RMS = 2.5e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_expert_products_are_f32(arch):
    """In bf16 the expert products are f32 products, as with the
    reference's default ``preferred_element_type`` (``moe.py:154``; JAX on
    the CPU cannot run that dot in bf16): the port's routed experts are
    within BF16_REL_RMS of a model of its rounding points, and the model
    with gate and up rounded to bf16 is not."""
    _, cfg, _, p = _layer(arch, d_model=256, d_ff=128, n_shared_experts=0)
    xt = torch.from_numpy(_x(cfg, 4, 32, seed=7)).to(torch.bfloat16)
    want = _bf16_model(cfg, p, xt).float()

    def rel(got):
        return ((got.float() - want).norm() / want.norm()).item()

    got = moe.apply_moe(cfg, p, xt)
    assert got.dtype == torch.bfloat16
    assert rel(got) <= BF16_REL_RMS
    assert rel(_bf16_model(cfg, p, xt, round_gating=True)) > BF16_REL_RMS


def test_shared_experts_match_reference():
    """deepseek's shared expert adds in, and more of them widen it."""
    ref_cfg, cfg, ref_p, p = _layer("deepseek-v2-236b", n_shared_experts=2,
                                    capacity_factor=0.5)
    assert "shared" in p and p["shared"]["wo"].shape[0] == 2 * cfg.d_ff
    x = _x(cfg, 2, 16, seed=5)
    want = ref_moe.apply_moe(ref_cfg, ref_p, jnp.asarray(x))
    got = moe.apply_moe(cfg, p, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_router_aux_loss_matches_reference(arch):
    cfg = get_smoke_config(arch)
    rng = np.random.default_rng(11)
    logits = rng.standard_normal((64, cfg.n_experts)).astype(np.float32)
    top_e = np.argsort(-logits, axis=-1)[:, :cfg.top_k].astype(np.int32)
    want = ref_moe.router_aux_loss(ref_smoke_config(arch),
                                   jnp.asarray(logits), jnp.asarray(top_e))
    got = moe.router_aux_loss(cfg, torch.from_numpy(logits),
                              torch.from_numpy(top_e))
    np.testing.assert_allclose(float(got), float(want), **TOL)


def test_combine_is_deterministic():
    """The combine sums each token's k outputs in a fixed order: two calls
    give the same bits."""
    _, cfg, _, p = _layer("deepseek-v2-236b", capacity_factor=0.5)
    x = torch.from_numpy(_x(cfg, 4, 32, seed=9))
    assert torch.equal(moe.apply_moe(cfg, p, x), moe.apply_moe(cfg, p, x))


def test_dense_paged_steps_take_moe_ffns():
    """mixtral's MoE FFN on full attention (the window dropped) goes through
    the paged prefill chunk and decode step, as the reference's do."""
    scale = dict(block_pattern=("attn",), window=None)
    ref_cfg = ref_smoke_config("mixtral-8x7b").scaled(**scale)
    cfg = get_smoke_config("mixtral-8x7b").scaled(**scale)
    ref_params = ref_build(ref_cfg).init(jax.random.key(0))
    params = from_jax_params(cfg, jax.tree.map(np.asarray, ref_params),
                             device="cpu")
    rng = np.random.default_rng(4)
    b, c, bs, n_blocks = 2, 6, 4, 16
    tables = rng.permutation(n_blocks)[:b * 4].reshape(b, 4).astype(np.int32)
    tokens = rng.integers(0, cfg.vocab_size, (b, c)).astype(np.int32)
    positions = np.tile(np.arange(c, dtype=np.int32), (b, 1))
    j, t = jnp.asarray, torch.from_numpy
    ref_pools = ref_paged.init_pools(ref_cfg, n_blocks, bs)
    pools = init_pools(cfg, n_blocks, bs, device="cpu")
    want, ref_pools = ref_paged.paged_prefill_chunk(
        ref_cfg, ref_params, ref_pools, j(tables), j(tokens), j(positions))
    got, pools = paged_prefill_chunk(cfg, params, pools, t(tables),
                                     t(tokens), t(positions))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    dtok = rng.integers(0, cfg.vocab_size, (b,)).astype(np.int32)
    dpos = np.full((b,), c, np.int32)
    want, _ = ref_paged.paged_decode_step(ref_cfg, ref_params, ref_pools,
                                          j(tables), j(dpos + 1), j(dtok),
                                          j(dpos))
    got, _ = paged_decode_step(cfg, params, pools, t(tables), t(dpos + 1),
                               t(dtok), t(dpos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
