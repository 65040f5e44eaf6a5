"""The f32 flash backward tile's order of operations, on the CPU.

The CUDA tile (``csrc/flash_attention_bwd.cu``, variant ``"cuda_core"``)
cannot run here, so ``ref.flash_attention_bwd_f32_tile_ref`` models it: the
forward's output and log-sum-exp from the f32 forward tile's model, Delta
= rowsum(dO * O), P = 2^(S scale log2 e - lse log2 e) masked by select, dQ
over key tiles of ``f32_bwd_tile_rows`` keys, dK and dV over each kv head's
query heads in order and their query tiles, every sum in f32.

* The model is held against ``jax.vjp`` of the reference's chunked
  attention (``repro/models/attention.py:70``) within 1e-5 relative RMS
  error (f32 sums in another order), at D 16 (padded to 64 on the card),
  64, 80, 128 and 256, G 1, 4 and 12, causal and not, ragged T.  Non-causal
  cases take a key chunk that divides T: where it does not, the reference
  lets its zero pad keys into the softmax.
* The model is held against the plain version ``ref.flash_attention_bwd_ref``
  within the f32 limits ``chip_smoke.py`` phase 8(a) holds the kernel to
  (rtol 1e-4 plus 1e-5 of max |want|, relative RMS 1e-5), and bf16 inputs
  within its bf16 limits; the two planted faults must fail them.
* The routing (``choose_bwd_variant``) and the f32 tile's GQA splits.

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
from repro_torch.kernels.ref import (f32_bwd_tile_rows,
                                     flash_attention_bwd_f32_tile_ref,
                                     flash_attention_bwd_ref)

BF16, F32 = torch.bfloat16, torch.float32


def _inputs(b, t, h, kh, d, dtype, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(dtype) for s in ((b, t, h, d), (b, t, kh, d), (b, t, kh, d),
                                 (b, t, h, d))]


def _rel_rms(got, want):
    got, want = got.float(), want.float()
    return ((got - want).norm() / want.norm().clamp(min=1e-30)).item()


def _limits(got, want, dtype):
    """Phase 8(a)'s limits of one gradient: f32 within rtol 1e-4 plus 1e-5
    of max |want| and relative RMS 1e-5; bf16 within rtol 2e-2 plus 4 bf16
    ulps of max |want| and relative RMS 5e-3."""
    got, want = got.float(), want.float()
    top = want.abs().max().item()
    if dtype == BF16:
        atol = 4 * 2.0 ** (math.floor(math.log2(max(top, 1e-30))) - 7)
        rtol, rel = 2e-2, 5e-3
    else:
        atol, rtol, rel = 1e-5 * top, 1e-4, 1e-5
    return (torch.allclose(got, want, rtol=rtol, atol=atol)
            and _rel_rms(got, want) <= rel)


# ============================================== the model vs jax.vjp
#: (B, T, H, KH, D, causal, the reference's key chunk)
VJP_CASES = [
    (2, 130, 4, 4, 16, True, 16),     # D 16 (pads to 64), G 1, ragged
    (2, 64, 12, 1, 16, False, 8),     # G 12, non-causal
    (1, 130, 8, 2, 64, True, 16),     # G 4
    (1, 300, 4, 4, 64, False, 12),    # ragged tiles of 32, non-causal
    (1, 130, 12, 1, 80, True, 16),    # G 12 at stablelm-3b's D
    (1, 130, 4, 1, 80, False, 10),    # MQA, non-causal
    (1, 300, 24, 2, 128, True, 32),   # starcoder2-3b's G 12, 16-key tiles
    (1, 300, 8, 2, 128, False, 20),
    (1, 130, 4, 4, 256, True, 16),    # gemma-7b's D
    (2, 100, 4, 1, 256, False, 10),   # MQA at D 256, non-causal
]


@pytest.mark.parametrize("b,t,h,kh,d,causal,kv_chunk", VJP_CASES)
def test_f32_tile_model_matches_reference_vjp(b, t, h, kh, d, causal,
                                              kv_chunk):
    q, k, v, do = (x.numpy() for x in _inputs(b, t, h, kh, d, F32,
                                              seed=t + h + d))
    pos = jnp.broadcast_to(jnp.arange(t)[None], (b, t))
    _, vjp = jax.vjp(lambda q_, k_, v_: ref_flash(
        q_, k_, v_, pos, pos, causal=causal, q_chunk=16, kv_chunk=kv_chunk),
        *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(do))
    got = flash_attention_bwd_f32_tile_ref(
        *(torch.from_numpy(x) for x in (q, k, v, do)), causal=causal)
    for name, g_, w in zip("qkv", got, want):
        w = torch.from_numpy(np.array(w))
        assert g_.dtype == F32 and g_.shape == w.shape
        assert _rel_rms(g_, w) <= 1e-5, f"d{name}"


# ==================================== the model vs the plain version
#: (B, T, H, KH, D, causal): phase 8(a)'s shapes cut in T and H, ragged
PLAIN_CASES = [
    (1, 200, 8, 8, 80, True),      # stablelm-3b
    (1, 150, 12, 1, 128, True),    # starcoder2-3b's G 12
    (1, 100, 4, 4, 256, True),     # gemma-7b
    (2, 150, 4, 4, 64, False),     # whisper-small's encoder, ragged tail
    (2, 100, 8, 2, 48, True),      # bf16 off the tile's head dims
]


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("b,t,h,kh,d,causal", PLAIN_CASES)
def test_f32_tile_model_holds_the_plain_limits(b, t, h, kh, d, causal,
                                               dtype):
    """In f32 and on bf16 inputs (widened exactly, gradients rounded once
    to bf16) the model is within phase 8(a)'s limits of the plain
    version."""
    q, k, v, do = _inputs(b, t, h, kh, d, dtype, seed=b * t + d)
    got = flash_attention_bwd_f32_tile_ref(q, k, v, do, causal=causal)
    want = flash_attention_bwd_ref(q, k, v, do, causal=causal)
    for name, g_, w in zip("qkv", got, want):
        assert g_.dtype == dtype and g_.shape == w.shape
        assert _limits(g_, w, dtype), f"d{name}: {_rel_rms(g_, w):.3e}"


@pytest.mark.parametrize("fault,b,t,h,kh,d,causal", [
    ("dkdv unmasked", 1, 200, 8, 8, 80, True),
    ("dkdv unmasked", 1, 150, 12, 1, 128, True),
    ("tail tile skipped", 2, 150, 4, 4, 64, False),
    ("tail tile skipped", 1, 100, 4, 4, 256, True),
    ("tail tile skipped", 1, 200, 8, 8, 80, True),
])
def test_f32_tile_model_planted_faults_fail(fault, b, t, h, kh, d, causal):
    q, k, v, do = _inputs(b, t, h, kh, d, F32, seed=b * t + d)
    got = flash_attention_bwd_f32_tile_ref(q, k, v, do, causal=causal,
                                           fault=fault)
    want = flash_attention_bwd_ref(q, k, v, do, causal=causal)
    assert not all(_limits(g_, w, F32) for g_, w in zip(got, want))


def test_f32_tile_model_takes_the_forward_it_is_given():
    """``out`` and ``lse`` given: the plain forward's instead of the f32
    tile's model give the same gradients within f32 rounding."""
    q, k, v, do = _inputs(1, 90, 6, 2, 80, F32, seed=5)
    qf = q.reshape(1, 90, 2, 3, 80)
    s = torch.einsum("btkgd,bskd->bkgts", qf, k) / math.sqrt(80)
    pos = torch.arange(90)
    s = torch.where(pos[None, :] <= pos[:, None], s, -math.inf)
    lse = torch.logsumexp(s, -1).reshape(1, 6, 90)
    out = torch.einsum("bkgts,bskd->btkgd", torch.softmax(s, -1), v)
    given = flash_attention_bwd_f32_tile_ref(q, k, v, do, out=out.reshape(
        1, 90, 6, 80), lse=lse)
    own = flash_attention_bwd_f32_tile_ref(q, k, v, do)
    for a, c in zip(given, own):
        torch.testing.assert_close(a, c, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d,rows", [(16, 32), (64, 32), (80, 32), (96, 16),
                                    (128, 16), (160, 16), (256, 16)])
def test_f32_tile_rows(d, rows):
    """32-row tiles up to D 80, 16 where D pads to 128 or 256."""
    assert f32_bwd_tile_rows(d) == rows


# ============================================================== routing
@pytest.mark.parametrize("d", [16, 32, 48, 64, 80, 96, 128, 160, 256])
def test_f32_takes_the_f32_tile_at_every_head_dim(d):
    assert fa.choose_bwd_variant(F32, d) == "cuda_core"
    want = "tile" if d in fa.TILE_HEAD_DIMS else "cuda_core"
    assert fa.choose_bwd_variant(BF16, d) == want


@pytest.mark.parametrize("b,t,kh,g,d,want", [
    (1, 2048, 32, 1, 80, 1),    # stablelm-3b: MHA never splits
    (2, 64, 32, 1, 80, 1),      # phase 8b's short grid
    (1, 2048, 2, 12, 128, 12),  # starcoder2-3b: 64 blocks -> 768
    (1, 2048, 4, 9, 128, 9),    # starcoder2-7b: 128 blocks -> 1152
    (1, 2048, 8, 4, 128, 4),    # pixtral-12b: 256 blocks -> 1024
    (1, 2048, 1, 10, 256, 10),  # MQA 10 at D 256: 64-key blocks
    (4, 2048, 8, 4, 128, 2),    # 1024 blocks: just short
    (8, 2048, 8, 4, 128, 1),    # enough blocks
])
def test_f32_tile_bwd_splits(b, t, kh, g, d, want):
    got = fa.bwd_splits(b, t, kh, g, d, "cuda_core")
    assert got == want
    per = -(-g // got)
    assert (got - 1) * per < g  # no split is empty


def test_wide_is_the_f32_tiles_alone():
    """``wide`` picks the f32 tile's CTAs; the tensor-core tile refuses it
    before any operand check or launch."""
    q, k, v, do = _inputs(1, 8, 2, 2, 80, BF16, seed=0)
    with pytest.raises(ValueError, match="wide applies"):
        fa.flash_attention_bwd(q, k, v, q, do, torch.zeros((1, 2, 8)),
                               variant="tile", wide=True)
