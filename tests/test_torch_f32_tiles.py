"""The plain model of the f32 attention tile (``csrc/attention_f32.cuh``),
on the CPU.

The CUDA tile cannot run here, so this file pins the algebra it computes:
``kernels.ref.paged_attention_f32_tile_ref`` and
``flash_attention_f32_tile_ref`` walk the keys in the tile's K/V tiles
(``F32_TILE_KEYS``), take each row's max once per tile, rescale l and O
once per tile, and widen int8 pages as ``code * scale`` in f32.  They are
held against the Pallas kernels ``repro.kernels.paged_attention.
paged_attention_chunk`` and ``repro.kernels.flash_attention.
flash_attention_tpu`` in interpret mode, on the same NumPy-seeded inputs,
within 1e-5 (the two sum in other orders and exponentiate in other bases).
Within the model, the bounded against the unbounded walk, fused int8
against dequantized pools and NaN in dead slots are held bitwise.  On the
card the kernel is held against this model (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase 2).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_tpu
from repro.kernels.paged_attention import \
    paged_attention_chunk as pallas_chunk
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels.quant import dequantize_pool
from repro_torch.kernels.ref import (F32_TILE_KEYS,
                                     flash_attention_f32_tile_ref,
                                     flash_attention_ref,
                                     paged_attention_chunk_ref,
                                     paged_attention_f32_tile_ref)

F32, BF16, F16, I8 = torch.float32, torch.bfloat16, torch.float16, torch.int8
TOL = 1e-5
POOLS = {"f32": (F32, jnp.float32), "bf16": (BF16, jnp.bfloat16),
         "f16": (F16, jnp.float16)}


# ================================================== paged K/V
def _case(b, c, kh, g, d, bs, nblk, seed, pool="f32"):
    """Seeded operands as NumPy arrays (f32, or int8 codes with (N, KH)
    scales): a permuted table with slots past the live bound, ragged
    contexts that end mid-page, the exact live bound."""
    rng = np.random.default_rng(seed)
    n = b * nblk + 2
    q = rng.standard_normal((b, c, kh, g, d)).astype(np.float32)
    if pool == "int8":
        k, v = (rng.integers(-127, 128, (n, bs, kh, d)).astype(np.int8)
                for _ in range(2))
        ksc, vsc = (rng.uniform(0.005, 0.05, (n, kh)).astype(np.float32)
                    for _ in range(2))
    else:
        k, v = (rng.standard_normal((n, bs, kh, d)).astype(np.float32)
                for _ in range(2))
        ksc = vsc = None
    tables = rng.permutation(n)[: b * nblk].reshape(b, nblk).astype(np.int32)
    ctx = rng.integers(0, nblk * bs - c + 1, (b, 1))
    qpos = (ctx + np.arange(c)[None, :]).astype(np.int32)
    live = (qpos.max(axis=1) // bs + 1).astype(np.int32)
    return dict(q=q, k=k, v=v, ksc=ksc, vsc=vsc, tables=tables, qpos=qpos,
                live=live, pool=pool)


def _torch(case):
    t = {k: torch.from_numpy(a) if isinstance(a, np.ndarray) else a
         for k, a in case.items()}
    if case["pool"] in POOLS:
        dtype = POOLS[case["pool"]][0]
        t["k"], t["v"] = t["k"].to(dtype), t["v"].to(dtype)
    return t


def _pallas(case):
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    k, v = j(case["k"]), j(case["v"])
    if case["pool"] in POOLS:  # the same rounding of the draw as torch's
        k, v = (x.astype(POOLS[case["pool"]][1]) for x in (k, v))
    return np.asarray(pallas_chunk(
        j(case["q"]), k, v, j(case["tables"]), j(case["qpos"]),
        j(case["live"]), j(case["ksc"]), j(case["vsc"]), interpret=True))


def _model(t, live="live", **kw):
    return paged_attention_f32_tile_ref(
        t["q"], t["k"], t["v"], t["tables"], t["qpos"],
        None if live is None else t[live], k_scales=t["ksc"],
        v_scales=t["vsc"], **kw)


# (B, C, KH, G, D, bs, nblk)
PAGED_SHAPES = [
    (2, 20, 2, 1, 80, 16, 6),    # stablelm-3b head dim, a chunk mid-page
    (2, 8, 2, 4, 64, 8, 9),      # GQA G 4: 32 rows
    (1, 17, 2, 2, 128, 16, 4),   # head dim 128
    (2, 20, 2, 1, 256, 16, 6),   # gemma-7b head dim 256
    (3, 1, 2, 4, 80, 16, 8),     # decode rows < 16
    (2, 6, 1, 3, 72, 4, 20),     # D 72 (no whole 16-byte bf16 rows), bs 4
]


@pytest.mark.parametrize("pool", ["f32", "bf16", "f16", "int8"])
@pytest.mark.parametrize("shape", PAGED_SHAPES)
def test_paged_model_matches_pallas(shape, pool):
    case = _case(*shape, seed=sum(shape) + len(pool), pool=pool)
    got = _model(_torch(case)).numpy()
    np.testing.assert_allclose(got, _pallas(case), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("shape", PAGED_SHAPES[:4])
def test_paged_model_wide_pages(shape):
    """Pages of 128 and 256 keys, wider than a K/V tile: the tile gathers
    key by key, so a page spans several tiles."""
    b, c, kh, g, d, _, _ = shape
    for bs, nblk in ((128, 3), (256, 2)):
        case = _case(b, c, kh, g, d, bs, nblk, seed=bs + d)
        got = _model(_torch(case)).numpy()
        np.testing.assert_allclose(got, _pallas(case), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("pool", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("shape", PAGED_SHAPES)
def test_paged_model_bounded_equals_unbounded(shape, pool):
    b, c, kh, g, d, bs, nblk = shape
    t = _torch(_case(*shape, seed=sum(shape) + 3, pool=pool))
    t["full"] = torch.full_like(t["live"], nblk)
    want = _model(t)
    assert torch.equal(want, _model(t, live="full"))
    assert torch.equal(want, _model(t, live=None))


@pytest.mark.parametrize("pool", ["f32", "f16", "int8"])
@pytest.mark.parametrize("shape", PAGED_SHAPES[:4])
def test_paged_model_never_reads_dead_slots(shape, pool):
    """NaN in the pages (and, for int8, the scales) of every table slot
    past the live bound reaches nothing (the chunks start at position 0,
    so each table has dead slots)."""
    t = _torch(_case(*shape, seed=sum(shape) + 5, pool=pool))
    nblk, bs = shape[-1], shape[-2]
    t["qpos"] = t["qpos"] - t["qpos"][:, :1]
    t["live"] = (t["qpos"].max(dim=1).values // bs + 1).to(torch.int32)
    want = _model(t)
    dead = torch.arange(nblk)[None, :] >= t["live"][:, None].long()
    ids = t["tables"][dead].long()
    assert ids.numel()
    if pool == "int8":
        t["ksc"], t["vsc"] = t["ksc"].clone(), t["vsc"].clone()
        t["ksc"][ids] = math.nan
        t["vsc"][ids] = math.nan
    else:
        t["k"], t["v"] = t["k"].clone(), t["v"].clone()
        t["k"][ids] = math.nan
        t["v"][ids] = math.nan
    got = _model(t)
    assert torch.equal(got, want) and torch.isfinite(got).all()


@pytest.mark.parametrize("shape", PAGED_SHAPES)
def test_paged_model_int8_fused_equals_dequantized(shape):
    """Widening a code as ``code * scale`` in f32 is ``dequantize_pool``:
    the fused walk and the walk over dequantized pools agree bitwise."""
    t = _torch(_case(*shape, seed=sum(shape) + 7, pool="int8"))
    mat = dict(t, k=dequantize_pool(t["k"], t["ksc"]),
               v=dequantize_pool(t["v"], t["vsc"]), ksc=None, vsc=None)
    assert torch.equal(_model(t), _model(mat))


def test_paged_model_all_masked_row_is_zero():
    t = _torch(_case(2, 5, 2, 2, 64, 8, 4, seed=9))
    t["live"] = torch.tensor([0, 4], dtype=torch.int32)
    got = _model(t)
    assert not got[0].any() and torch.isfinite(got).all()
    torch.testing.assert_close(
        got, paged_attention_chunk_ref(t["q"], t["k"], t["v"], t["tables"],
                                       t["qpos"], t["live"]),
        rtol=TOL, atol=TOL)


def test_paged_model_bf16_query():
    """A bf16 query (the f32 tile takes it over fp16 pages): read as f32,
    the output rounded once to bf16."""
    case = _case(2, 20, 2, 1, 80, 16, 6, seed=41, pool="f16")
    case["q"] = np.array(jnp.asarray(case["q"]).astype(jnp.bfloat16)
                         .astype(jnp.float32))
    t = _torch(case)
    got = paged_attention_f32_tile_ref(
        t["q"].to(BF16), t["k"], t["v"], t["tables"], t["qpos"], t["live"])
    assert got.dtype == BF16
    want = _pallas(case)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0 ** -8,
                               atol=1e-5)


# ================================================== dense K/V
def _qkv(b, t, h, kh, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, t, h, d), (b, t, kh, d), (b, t, kh, d))]


# (B, T, H, KH, D, causal)
FLASH_SHAPES = [
    (2, 128, 4, 4, 64, True),     # MHA
    (1, 128, 4, 2, 80, True),     # GQA G 2 at stablelm-3b's head dim
    (2, 64, 8, 2, 128, False),    # non-causal GQA G 4
    (1, 64, 4, 1, 256, True),     # MQA at D 256
    (2, 128, 2, 2, 64, False),    # non-causal MHA
    (1, 64, 4, 4, 256, False),    # non-causal D 256
]


@pytest.mark.parametrize("b,t,h,kh,d,causal", FLASH_SHAPES)
def test_flash_model_matches_pallas(b, t, h, kh, d, causal):
    arrays = _qkv(b, t, h, kh, d, seed=t + h + d)
    want = np.asarray(flash_attention_tpu(
        *(jnp.asarray(a) for a in arrays), causal=causal, cq=64, ck=64,
        interpret=True))
    got = flash_attention_f32_tile_ref(
        *(torch.from_numpy(a) for a in arrays), causal=causal)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("t,d", [(100, 80), (70, 256), (33, 64)])
def test_flash_model_ragged_t(t, d):
    """Any T: causal rows never see a later position, so T rows equal the
    first T rows of the Pallas kernel on inputs padded to 128."""
    arrays = _qkv(1, 128, 4, 2, d, seed=t + d)
    want = np.asarray(flash_attention_tpu(
        *(jnp.asarray(a) for a in arrays), causal=True, cq=64, ck=64,
        interpret=True))[:, :t]
    q, k, v = (torch.from_numpy(np.ascontiguousarray(a[:, :t]))
               for a in arrays)
    got = flash_attention_f32_tile_ref(q, k, v, causal=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_model_lse(causal):
    """The log-sum-exp in natural logs of the scaled scores, (B, H, T):
    what the f32 backward reads."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 70, 4, 2, 80, seed=5))
    out, lse = flash_attention_f32_tile_ref(q, k, v, causal=causal,
                                            with_lse=True)
    s = torch.einsum("bthd,bshd->bhts", q, k.repeat_interleave(2, 2)) \
        / math.sqrt(80)
    if causal:
        s = s.masked_fill(torch.ones(70, 70).triu(1).bool(), -math.inf)
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), rtol=TOL,
                               atol=TOL)
    torch.testing.assert_close(out, flash_attention_ref(q, k, v,
                                                        causal=causal),
                               rtol=TOL, atol=TOL)


def test_tile_keys_and_routes():
    """The model walks the kernel's 32-key tiles, and the f32 query takes
    the f32 tile in both kernels."""
    assert F32_TILE_KEYS == 32
    assert fa.choose_variant(F32, 64) == "cuda_core"
    assert pa.choose_variant(F32, F32, 256, 80, 16) == "cuda_core"
