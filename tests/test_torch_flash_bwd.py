"""The tensor-core flash backward's algebra and rounding, on the CPU.

The CUDA tiles (``csrc/flash_attention_bwd.cu``, variant ``"tile"``) cannot
run here, so this file holds a plain PyTorch model of them: the same key
and query tiles as the kernel's walks, P = exp(S scale - lse) recomputed
from the forward's row log-sum-exp, Delta = rowsum(dO * O) with the
forward's output in the input's dtype, P and dS rounded to bf16 before
their products, every sum in f32, dK and dV summed over each kv head's G
query heads.

* In f32 with no rounding the model is held against ``jax.vjp`` of the
  reference's chunked attention (``repro/models/attention.py:70``) within
  1e-5 (f32 sums in another order), where the key chunk divides T.
* With bf16 inputs and its rounding points the model is held against
  ``ref.flash_attention_bwd_ref`` (autograd through the plain forward, f32
  inside) within the limits ``chip_smoke.py`` phase 8(a) holds the kernel
  to: rtol 2e-2 plus 4 bf16 ulps of max |want|, relative RMS 5e-3.
* Two planted faults of the model must fail those limits: the causal mask
  dropped in the dK/dV walk, and the ragged last key tile skipped.

Inputs come from a NumPy seed.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import flash_attention as ref_flash
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.ref import flash_attention_bwd_ref, flash_attention_ref

BF16, F32 = torch.bfloat16, torch.float32


def _tiles(d):
    """(keys of a dQ walk's K/V tile, keys of a dK/dV block, queries of a
    dK/dV walk's tile): ``BwdShape`` of ``csrc/flash_attention_bwd.cu``."""
    split = 2 if d > 128 else 1
    return (32 if d > 128 else 64), 64 // split, (64 if d // split <= 80
                                                  else 32)


def tile_bwd_model(q, k, v, do, *, causal, rounded=True, fault=None):
    """dQ, dK, dV as the tile backward computes them, in q's dtype.
    ``rounded``: P and dS rounded to bf16 before their products.
    ``fault``: None, ``"dkdv unmasked"`` (the causal mask dropped in the
    dK/dV walk) or ``"tail tile skipped"`` (each walk stops at the last
    whole key tile)."""
    b, t, h, d = q.shape
    g = h // k.shape[2]
    scale = 1.0 / math.sqrt(d)
    qf, dof = q.float(), do.float()
    kf, vf = (x.float().repeat_interleave(g, 2) for x in (k, v))
    pos = torch.arange(t)
    vis = (pos[None, :] <= pos[:, None] if causal
           else torch.ones((t, t), dtype=torch.bool))
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    lse = torch.logsumexp(torch.where(vis, s, -math.inf), -1)       # (b,h,t)
    out = flash_attention_ref(q, k, v, causal=causal)   # the forward's output
    delta = torch.einsum("bqhd,bqhd->bhq", dof, out.float())
    rnd = ((lambda x: x.to(BF16).float()) if rounded
           else (lambda x: x))  # noqa: E731

    def p_ds(q0, q1, k0, k1, mask):
        s = torch.einsum("bqhd,bkhd->bhqk", qf[:, q0:q1], kf[:, k0:k1]) * scale
        p = torch.exp(s - lse[..., q0:q1, None])
        if mask:
            p = torch.where(vis[q0:q1, k0:k1], p, 0.0)
        dp = torch.einsum("bqhd,bkhd->bhqk", dof[:, q0:q1], vf[:, k0:k1])
        return rnd(p), rnd(p * (dp - delta[..., q0:q1, None]))

    kq, kb, qt = _tiles(d)
    tail = fault == "tail tile skipped"
    # dK, dV: a block per key tile walks the query tiles that see it
    dk, dv = torch.zeros_like(qf), torch.zeros_like(qf)
    for k0 in range(0, t // kb * kb if tail else t, kb):
        k1 = min(t, k0 + kb)
        for q0 in range(k0 // qt * qt if causal else 0, t, qt):
            q1 = min(t, q0 + qt)
            p, ds = p_ds(q0, q1, k0, k1, causal and fault != "dkdv unmasked")
            dv[:, k0:k1] += torch.einsum("bhqk,bqhd->bkhd", p, dof[:, q0:q1])
            dk[:, k0:k1] += torch.einsum("bhqk,bqhd->bkhd", ds, qf[:, q0:q1])
    # dQ: a block per 64 query rows walks the key tiles up to its last row
    dq = torch.zeros_like(qf)
    for q0 in range(0, t, 64):
        q1 = min(t, q0 + 64)
        kend = q1 if causal else t
        stop = kend // kq * kq if tail and kend == t else kend
        for k0 in range(0, stop, kq):
            _, ds = p_ds(q0, q1, k0, min(kend, k0 + kq), causal)
            dq[:, q0:q1] += torch.einsum("bhqk,bkhd->bqhd", ds,
                                         kf[:, k0:min(kend, k0 + kq)])
    dk, dv = (x.reshape(b, t, -1, g, d).sum(3) for x in (dk * scale, dv))
    return tuple(x.to(q.dtype) for x in (dq * scale, dk, dv))


def _limits(got, want):
    """(within phase 8(a)'s bf16 limits, relative RMS error)."""
    got, want = got.float(), want.float()
    top = want.abs().max().item()
    atol = 4 * 2.0 ** (math.floor(math.log2(max(top, 1e-30))) - 7)
    rms = ((got - want).norm() / want.norm().clamp(min=1e-30)).item()
    return (torch.allclose(got, want, rtol=2e-2, atol=atol)
            and rms <= 5e-3), rms


def _inputs(b, t, h, kh, d, dtype, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(dtype) for s in ((b, t, h, d), (b, t, kh, d), (b, t, kh, d),
                                 (b, t, h, d))]


# ============================================== the f32 model vs jax.vjp
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,t,h,kh,d", [
    (2, 96, 4, 2, 16),    # GQA 2, two 64-key tiles, the second ragged
    (1, 80, 3, 1, 32),    # MQA
    (1, 40, 2, 2, 144),   # D past 128: 32-key tiles, split warps
])
def test_tile_model_f32_matches_reference_vjp(b, t, h, kh, d, causal):
    """The model without rounding, in f32, against ``jax.vjp`` of the
    reference's attention (its key chunk divides T: where it does not, the
    reference's non-causal mask lets its zero pad keys in)."""
    q, k, v, do = (x.numpy() for x in _inputs(b, t, h, kh, d, F32, seed=t + d))
    pos = jnp.broadcast_to(jnp.arange(t)[None], (b, t))
    _, vjp = jax.vjp(lambda q_, k_, v_: ref_flash(
        q_, k_, v_, pos, pos, causal=causal, q_chunk=16, kv_chunk=8),
        *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(do))
    got = tile_bwd_model(*(torch.from_numpy(x) for x in (q, k, v, do)),
                         causal=causal, rounded=False)
    for g_, w in zip(got, want):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


# ==================================== the bf16 model within 8(a)'s limits
#: (B, T, H, KH, D, causal): GQA 4, MQA, D 48/80/128/256, ragged T
MODEL_SHAPES = [
    (2, 100, 8, 2, 48, True),     # GQA 4, D off the tile dims, ragged
    (1, 130, 4, 1, 80, True),     # MQA at stablelm-3b's D
    (1, 130, 4, 1, 80, False),
    (1, 150, 8, 2, 128, True),    # GQA 4 at starcoder2-3b's D
    (2, 70, 2, 2, 128, False),
    (1, 100, 2, 2, 256, True),    # gemma-7b's D: 32-key tiles
    (1, 77, 4, 1, 256, False),    # MQA, D 256, ragged
]


@pytest.mark.parametrize("b,t,h,kh,d,causal", MODEL_SHAPES)
def test_tile_model_holds_the_bf16_limits(b, t, h, kh, d, causal):
    """bf16 inputs, P and dS rounded to bf16, f32 sums: within phase 8(a)'s
    limits of the plain version (f32 inside, its forward output unrounded
    in Delta), so the rounding points leave room under them."""
    q, k, v, do = _inputs(b, t, h, kh, d, BF16, seed=b * t + d)
    got = tile_bwd_model(q, k, v, do, causal=causal)
    want = flash_attention_bwd_ref(q, k, v, do, causal=causal)
    for name, g_, w in zip("qkv", got, want):
        ok, rms = _limits(g_, w)
        assert g_.dtype == BF16 and g_.shape == w.shape
        assert ok, f"d{name}: relative RMS {rms:.3e}"
        assert rms > 0  # the rounding is seen


@pytest.mark.parametrize("fault,b,t,h,kh,d,causal", [
    ("dkdv unmasked", 1, 130, 4, 1, 80, True),
    ("dkdv unmasked", 1, 100, 2, 2, 256, True),
    ("tail tile skipped", 2, 100, 8, 2, 48, True),
    ("tail tile skipped", 1, 77, 4, 1, 256, False),
    ("tail tile skipped", 2, 70, 2, 2, 128, False),
])
def test_tile_model_planted_faults_fail(fault, b, t, h, kh, d, causal):
    """A model with a planted fault fails the same limits."""
    q, k, v, do = _inputs(b, t, h, kh, d, BF16, seed=b * t + d)
    got = tile_bwd_model(q, k, v, do, causal=causal, fault=fault)
    want = flash_attention_bwd_ref(q, k, v, do, causal=causal)
    assert not all(_limits(g_, w)[0] for g_, w in zip(got, want))


def test_tile_model_f32_is_exact_without_rounding():
    """Without its rounding points the model is the plain version within
    f32 rounding, so the bf16 test above measures the rounding alone."""
    q, k, v, do = _inputs(1, 90, 6, 2, 80, F32, seed=5)
    got = tile_bwd_model(q, k, v, do, causal=True, rounded=False)
    want = flash_attention_bwd_ref(q, k, v, do, causal=True)
    for g_, w in zip(got, want):
        torch.testing.assert_close(g_, w, rtol=1e-5, atol=1e-5)


# ============================================================== routing
@pytest.mark.parametrize("dtype,d,want", [
    (BF16, 80, "tile"), (BF16, 64, "tile"), (BF16, 128, "tile"),
    (BF16, 256, "tile"),
    (F32, 80, "cuda_core"), (F32, 256, "cuda_core"), (F32, 64, "cuda_core"),
    (BF16, 48, "cuda_core"), (BF16, 96, "cuda_core"),
    (BF16, 160, "cuda_core"), (BF16, 32, "cuda_core"),
    (torch.float16, 80, "cuda_core"),
])
def test_choose_bwd_variant(dtype, d, want):
    assert fa.choose_bwd_variant(dtype, d) == want


@pytest.mark.parametrize("b,t,kh,g,d,want", [
    (1, 2048, 32, 1, 80, 1),    # stablelm-3b: MHA never splits
    (1, 2048, 16, 1, 256, 1),   # gemma-7b
    (4, 1500, 12, 1, 64, 1),    # whisper's encoder
    (1, 2048, 2, 12, 128, 4),   # starcoder2-3b: 64 blocks -> 256, 3 heads each
    (1, 4096, 2, 12, 128, 3),   # 128 blocks -> 384
    (1, 2048, 4, 9, 128, 3),    # starcoder2-7b: 128 blocks, 3 heads each
    (1, 2048, 8, 4, 128, 2),    # pixtral-12b: 256 blocks, just short
    (8, 2048, 8, 4, 128, 1),    # enough blocks
    (1, 300, 2, 12, 128, 12),   # few key tiles: one head a split
    (1, 2048, 1, 10, 256, 5),   # MQA 10 at D 256: 64 blocks -> 320
])
def test_bwd_splits(b, t, kh, g, d, want):
    got = fa.bwd_splits(b, t, kh, g, d)
    assert got == want
    per = -(-g // got)
    assert (got - 1) * per < g  # no split is empty


@pytest.mark.parametrize("dtype,d,variant", [
    (F32, 80, "tile"), (BF16, 96, "tile"), (BF16, 80, "wgmma")])
def test_forced_route_refuses_what_it_does_not_take(dtype, d, variant):
    """A forced variant is checked before the operands and any launch: the
    tile refuses f32 and head dims it is not built for, and an unknown
    name is refused."""
    q, k, v, do = _inputs(1, 8, 2, 2, d, dtype, seed=0)
    lse = torch.zeros((1, 2, 8))
    with pytest.raises(ValueError, match="tile backward takes|not one of"):
        fa.flash_attention_bwd(q, k, v, q, do, lse, variant=variant)
