"""CUDA kernels of ``repro_torch.kernels`` held against their plain PyTorch
versions on the card.  Needs a CUDA device and nvcc; skips without them.

This file imports no JAX (the machine with the card has none), so it runs
there alone:  PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances: fp32 1e-4 (the kernel and the plain version sum in different
orders and use different exp paths); bf16 2e-2 (the output is rounded to
bf16, and the tensor-core tiles also round P to bf16 for the P V product:
about one bf16 ulp).  Bounded vs unbounded walks, NaN-poisoned dead pages
and scales, the fused int8 kernel against the f32 kernel on dequantized
pools, and the era scan are held bitwise.  Every variant of the paged
kernel (``choose_variant``: split-KV walk, tensor-core tile, CUDA-core
walk) is swept over C, G, D and bs, and the split-KV walk and the tile
are also held against the plain models of their own algebra in ``ref``.
The split-KV walk keeps scores, P and partials in f32, so its bf16 output
is held to one bf16 rounding step (rtol 2**-7) and, in f32, to its model
within 1e-5.
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.core.era_table import _can_delete_numpy, batched_can_delete
from repro_torch.kernels import era_scan, flash_attention, paged_attention
from repro_torch.kernels.quant import dequantize_pool
from repro_torch.kernels.ref import (INF_ERA32, era_scan_interval_ref,
                                     flash_attention_ref,
                                     paged_attention_chunk_int8_ref,
                                     paged_attention_chunk_ref,
                                     paged_attention_ref,
                                     paged_attention_split_ref,
                                     paged_attention_tile_ref)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(b, c, kh, g, d, bs, nblk, dtype, dev, seed):
    rng = np.random.default_rng(seed)
    n = b * nblk + 2
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    q = t(rng.standard_normal((b, c, kh, g, d)).astype(np.float32)).to(dtype)
    k = t(rng.standard_normal((n, bs, kh, d)).astype(np.float32)).to(dtype)
    v = t(rng.standard_normal((n, bs, kh, d)).astype(np.float32)).to(dtype)
    tables = t(rng.permutation(n)[: b * nblk].reshape(b, nblk).astype(np.int32))
    ctx = rng.integers(0, nblk * bs - c + 1, (b, 1))
    qpos = t((ctx + np.arange(c)[None, :]).astype(np.int32))
    live = (qpos.max(dim=1).values // bs + 1).to(torch.int32)
    return q, k, v, tables, qpos, live


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,c,kh,g,d,bs,nblk", [
    (8, 1, 32, 1, 80, 16, 16),    # stablelm-3b decode
    (3, 40, 32, 1, 80, 16, 8),    # stablelm-3b chunk, ragged
    (2, 5, 2, 4, 64, 8, 4),       # GQA G = 4
    (1, 3, 1, 2, 128, 4, 3),      # head_dim 128
])
def test_kernel_matches_plain(dev, dtype, tol, b, c, kh, g, d, bs, nblk):
    q, k, v, tables, qpos, live = _case(b, c, kh, g, d, bs, nblk, dtype, dev,
                                        seed=b * c + d)
    n0 = paged_attention.LAUNCHES.n
    got = paged_attention.paged_attention_chunk(q, k, v, tables, qpos, live)
    torch.cuda.synchronize()
    assert paged_attention.LAUNCHES.n == n0 + 1
    want = paged_attention_chunk_ref(q, k, v, tables, qpos, live)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    full = torch.full_like(live, nblk)
    unbounded = paged_attention.paged_attention_chunk(q, k, v, tables, qpos,
                                                      full)
    assert torch.equal(got, unbounded)


def test_kernel_all_masked_row_is_zero(dev):
    q, k, v, tables, qpos, _ = _case(2, 3, 2, 2, 64, 4, 4, torch.float32, dev,
                                     seed=7)
    live = torch.tensor([0, 4], dtype=torch.int32, device=dev)
    got = paged_attention.paged_attention_chunk(q, k, v, tables, qpos, live)
    assert not got[0].any()
    torch.testing.assert_close(
        got, paged_attention_chunk_ref(q, k, v, tables, qpos, live),
        rtol=1e-4, atol=1e-4)


def test_kernel_never_reads_dead_slots(dev):
    q, k, v, tables, qpos, live = _case(4, 6, 4, 1, 80, 16, 8, torch.float32,
                                        dev, seed=29)
    out1 = paged_attention.paged_attention_chunk(q, k, v, tables, qpos, live)
    dead = torch.arange(tables.shape[1], device=dev)[None, :] >= live[:, None]
    k2, v2 = k.clone(), v.clone()
    k2[tables[dead].long()] = math.nan
    v2[tables[dead].long()] = math.nan
    out2 = paged_attention.paged_attention_chunk(q, k2, v2, tables, qpos,
                                                 live)
    assert torch.equal(out1, out2)
    assert torch.isfinite(out2).all()


def test_decode_wrapper_equals_chunk(dev):
    q, k, v, tables, qpos, live = _case(3, 1, 2, 2, 64, 4, 4, torch.float32,
                                        dev, seed=5)
    lengths = qpos[:, 0] + 1
    dec = paged_attention.paged_attention(q[:, 0].contiguous(), k, v, tables,
                                          lengths, live)
    chunk = paged_attention.paged_attention_chunk(q, k, v, tables, qpos, live)
    assert torch.equal(dec, chunk[:, 0])
    torch.testing.assert_close(
        dec, paged_attention_ref(q[:, 0], k, v, tables, lengths, live),
        rtol=1e-4, atol=1e-4)


def _int8_pools(k, v, dev, seed):
    """Int8 codes and (N, KH) scales of the shapes of k and v."""
    rng = np.random.default_rng(seed)
    n, _, kh, _ = k.shape
    codes = [torch.from_numpy(rng.integers(-127, 128, tuple(k.shape)).astype(
        np.int8)).to(dev) for _ in range(2)]
    scales = [torch.from_numpy(rng.uniform(0.005, 0.05, (n, kh)).astype(
        np.float32)).to(dev) for _ in range(2)]
    return codes[0], codes[1], scales[0], scales[1]


INT8_SHAPES = [
    (8, 1, 32, 1, 80, 16, 16),    # stablelm-3b decode
    (3, 40, 32, 1, 80, 16, 8),    # stablelm-3b chunk, ragged
    (3, 4, 2, 2, 64, 8, 5),       # test_kernels.py:368
    (1, 8, 2, 1, 128, 4, 7),      # head_dim 128
]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,c,kh,g,d,bs,nblk", INT8_SHAPES)
def test_int8_kernel_matches_plain(dev, dtype, tol, b, c, kh, g, d, bs, nblk):
    q, k, v, tables, qpos, live = _case(b, c, kh, g, d, bs, nblk, dtype, dev,
                                        seed=b * c + d + 1)
    kq, vq, ksc, vsc = _int8_pools(k, v, dev, seed=b + c)
    n0, n8 = paged_attention.LAUNCHES.n, paged_attention.LAUNCHES_Q8.n
    got = paged_attention.paged_attention_chunk(q, kq, vq, tables, qpos, live,
                                                ksc, vsc)
    torch.cuda.synchronize()
    assert (paged_attention.LAUNCHES.n, paged_attention.LAUNCHES_Q8.n) == \
        (n0, n8 + 1)
    want = paged_attention_chunk_int8_ref(q, kq, vq, ksc, vsc, tables, qpos,
                                          live)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("b,c,kh,g,d,bs,nblk", INT8_SHAPES)
def test_int8_fused_equals_f32_kernel_on_dequantized_pools(
        dev, b, c, kh, g, d, bs, nblk):
    """(As test_kernels.py:372.)  Dequantizing at staging is one f32
    multiply, the same as ``dequantize_pool``: the outputs are equal."""
    q, k, v, tables, qpos, live = _case(b, c, kh, g, d, bs, nblk,
                                        torch.float32, dev, seed=b + d)
    kq, vq, ksc, vsc = _int8_pools(k, v, dev, seed=c + nblk)
    fused = paged_attention.paged_attention_chunk(q, kq, vq, tables, qpos,
                                                  live, ksc, vsc)
    mat = paged_attention.paged_attention_chunk(
        q, dequantize_pool(kq, ksc), dequantize_pool(vq, vsc), tables, qpos,
        live)
    assert torch.equal(fused, mat)


def test_int8_dead_slot_scales_never_read(dev):
    """(As test_kernels.py:428.)  NaN scales past each request's bound."""
    q, k, v, tables, qpos, live = _case(4, 6, 4, 1, 80, 16, 8, torch.float32,
                                        dev, seed=31)
    kq, vq, ksc, vsc = _int8_pools(k, v, dev, seed=31)
    out1 = paged_attention.paged_attention_chunk(q, kq, vq, tables, qpos,
                                                 live, ksc, vsc)
    dead = torch.arange(tables.shape[1], device=dev)[None, :] >= live[:, None]
    ksc2, vsc2 = ksc.clone(), vsc.clone()
    ksc2[tables[dead].long()] = math.nan
    vsc2[tables[dead].long()] = math.nan
    out2 = paged_attention.paged_attention_chunk(q, kq, vq, tables, qpos,
                                                 live, ksc2, vsc2)
    assert torch.equal(out1, out2)
    assert torch.isfinite(out2).all()


@pytest.mark.parametrize("pool_dtype", [torch.float16, torch.bfloat16])
def test_half_pools_under_f32_query(dev, pool_dtype):
    """Pools of another type than the query: converted to f32 at staging,
    so the kernel equals the f32 kernel on the pools made f32."""
    q, k, v, tables, qpos, live = _case(3, 40, 32, 1, 80, 16, 8,
                                        torch.float32, dev, seed=3)
    kp, vp = k.to(pool_dtype), v.to(pool_dtype)
    got = paged_attention.paged_attention_chunk(q, kp, vp, tables, qpos, live)
    assert got.dtype == torch.float32
    f32 = paged_attention.paged_attention_chunk(q, kp.float(), vp.float(),
                                                tables, qpos, live)
    assert torch.equal(got, f32)
    torch.testing.assert_close(
        got, paged_attention_chunk_ref(q, kp, vp, tables, qpos, live),
        rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,t,h,kh,d,causal", [
    (2, 256, 4, 4, 64, True),     # test_kernels.py:474 (MHA)
    (1, 256, 4, 2, 64, True),     # GQA g=2
    (2, 128, 8, 1, 128, True),    # MQA
    (2, 128, 2, 2, 64, False),    # non-causal (:495)
    (1, 300, 32, 32, 80, True),   # stablelm-3b heads, ragged T
    (1, 200, 24, 2, 128, True),   # starcoder2-3b heads, ragged T
])
def test_flash_kernel_matches_plain(dev, dtype, tol, b, t, h, kh, d, causal):
    rng = np.random.default_rng(t + h)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(dev).to(dtype)
               for s in ((b, t, h, d), (b, t, kh, d), (b, t, kh, d)))
    n0 = flash_attention.LAUNCHES.n
    got = flash_attention.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.LAUNCHES.n == n0 + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = flash_attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


# ------------------------------------------- the variants, swept by shape
def _variant_case(b, c, kh, g, d, bs, nblk, pool, dev, seed):
    """Operands over ``pool`` pages ("bf16", "int8", "f32") with a bf16
    query (f32 for f32 pages), and the variant the wrapper picks."""
    qdt = torch.float32 if pool == "f32" else torch.bfloat16
    kvdt = {"bf16": torch.bfloat16, "f32": torch.float32}.get(pool)
    q, k, v, tables, qpos, live = _case(b, c, kh, g, d, bs, nblk, qdt, dev,
                                        seed)
    ksc = vsc = None
    if pool == "int8":
        k, v, ksc, vsc = _int8_pools(k, v, dev, seed)
    else:
        k, v = k.to(kvdt), v.to(kvdt)
    variant = paged_attention.choose_variant(qdt, k.dtype, c * g, d, bs)
    return (q, k, v, tables, qpos, live, ksc, vsc), variant


def _tolerance(variant, dtype):
    """(rtol, atol) of a variant's output against the plain version: f32
    1e-4; the split-KV walk's bf16 output one bf16 rounding step (its
    scores, P and partials are f32); the tile's 2e-2 (P rounded to bf16)."""
    if dtype == torch.float32:
        return 1e-4, 1e-4
    return (2.0 ** -7, 1e-4) if variant == "split" else (2e-2, 2e-2)


def _check_model(args, variant, nblk):
    """The split-KV walk against ``paged_attention_split_ref`` (within
    1e-5 in f32, one bf16 step in bf16), the tile against
    ``paged_attention_tile_ref`` (2e-2)."""
    q, k, v, tables, qpos, live, ksc, vsc = args
    got = paged_attention.paged_attention_chunk(*args)
    if variant == "split":
        pps, nsplit = paged_attention.split_plan(nblk, k.shape[1])
        model = paged_attention_split_ref(
            q, k, v, tables, qpos, live, pages_per_split=pps,
            n_splits=nsplit, k_scales=ksc, v_scales=vsc)
        rtol, atol = ((1e-5, 1e-5) if q.dtype == torch.float32
                      else _tolerance(variant, q.dtype))
    else:
        model = paged_attention_tile_ref(q, k, v, tables, qpos, live,
                                         k_scales=ksc, v_scales=vsc)
        rtol, atol = 2e-2, 2e-2
    torch.testing.assert_close(got.float(), model.float(), rtol=rtol,
                               atol=atol)


def _check_variant(args, variant, nblk, dev):
    """Against plain; against the model of its algebra (split-KV walk and
    tile); bounded == unbounded bitwise; NaN-poisoned dead pages and
    scales unread; the variant's counter bumped once."""
    q, k, v, tables, qpos, live, ksc, vsc = args
    rtol, atol = _tolerance(variant, q.dtype)
    ctr = paged_attention.VARIANT_LAUNCHES[variant]
    n0 = ctr.n
    got = paged_attention.paged_attention_chunk(*args)
    torch.cuda.synchronize()
    assert ctr.n == n0 + 1
    want = paged_attention_chunk_ref(q, k, v, tables, qpos, live,
                                     k_scales=ksc, v_scales=vsc)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)
    if variant in ("split", "tile"):
        _check_model(args, variant, nblk)
    full = torch.full_like(live, nblk)
    assert torch.equal(got, paged_attention.paged_attention_chunk(
        q, k, v, tables, qpos, full, ksc, vsc))
    dead = torch.arange(nblk, device=dev)[None, :] >= live[:, None]
    ids = tables[dead].long()
    if ids.numel():
        kp, vp = k.clone(), v.clone()
        if ksc is None:
            kp[ids] = math.nan
            vp[ids] = math.nan
        else:
            ksc, vsc = ksc.clone(), vsc.clone()
            ksc[ids] = math.nan
            vsc[ids] = math.nan
        poisoned = paged_attention.paged_attention_chunk(
            q, kp, vp, tables, qpos, live, ksc, vsc)
        assert torch.equal(got, poisoned)
    assert torch.isfinite(got).all()


# stablelm-3b width (KH 32, G 1, D 80, bs 16): decode, short and long chunks
@pytest.mark.parametrize("pool", ["bf16", "int8", "f32"])
@pytest.mark.parametrize("c", [1, 2, 15, 16, 17, 64, 256])
def test_variants_stablelm_width(dev, pool, c):
    nblk = (c + 200) // 16 + 2
    args, variant = _variant_case(2, c, 32, 1, 80, 16, nblk, pool, dev,
                                  seed=c + len(pool))
    assert variant == ("split" if c < 16 else
                       "cuda_core" if pool == "f32" else "tile")
    _check_variant(args, variant, nblk, dev)


@pytest.mark.parametrize("pool", ["bf16", "int8"])
@pytest.mark.parametrize("c", [1, 2, 20])
@pytest.mark.parametrize("g,d,bs", [(g, d, bs) for g in (1, 4, 12)
                                    for d in (64, 80, 128) for bs in (8, 16)])
def test_variants_gqa_head_dim_block_size(dev, pool, c, g, d, bs):
    nblk = (c + 90) // bs + 2
    args, variant = _variant_case(2, c, 2, g, d, bs, nblk, pool, dev,
                                  seed=c * g + d + bs)
    assert variant == ("split" if c * g < 16 else "tile")
    _check_variant(args, variant, nblk, dev)


@pytest.mark.parametrize("pool,c", [("bf16", 1), ("int8", 1), ("f32", 1),
                                    ("bf16", 40), ("int8", 40), ("f32", 40)])
def test_variants_all_masked_row_is_zero(dev, pool, c):
    """A request with no live slot (live 0) writes 0, in every variant."""
    args, variant = _variant_case(2, c, 4, 1, 80, 16, 6, pool, dev, seed=c)
    q, k, v, tables, qpos, _, ksc, vsc = args
    live = torch.tensor([0, 6], dtype=torch.int32, device=dev)
    got = paged_attention.paged_attention_chunk(q, k, v, tables, qpos, live,
                                                ksc, vsc)
    assert not got[0].any()
    assert torch.isfinite(got).all()


def test_split_decode_of_a_wide_table_equals_narrow(dev):
    """The split boundaries follow the table width only: the same contexts
    through a table of 128 slots and one of 16 agree within fp32."""
    args, variant = _variant_case(4, 1, 8, 1, 80, 16, 16, "f32", dev, seed=3)
    q, k, v, tables, qpos, live, _, _ = args
    wide = torch.zeros((4, 128), dtype=torch.int32, device=dev)
    wide[:, :16] = tables
    a = paged_attention.paged_attention_chunk(q, k, v, tables, qpos, live)
    b = paged_attention.paged_attention_chunk(q, k, v, wide, qpos, live)
    torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("b,t,h,kh,d", [
    (1, 300, 32, 32, 80),     # stablelm-3b heads, ragged T
    (1, 4096, 32, 32, 80),    # stablelm-3b prefill
    (1, 4096, 24, 2, 128),    # starcoder2-3b prefill (GQA 12)
    (2, 300, 8, 1, 64),       # MQA, ragged T
])
def test_flash_tile_bf16_causal(dev, b, t, h, kh, d):
    rng = np.random.default_rng(t + h + d)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(dev).to(torch.bfloat16)
               for s in ((b, t, h, d), (b, t, kh, d), (b, t, kh, d)))
    ctr = flash_attention.VARIANT_LAUNCHES["tile"]
    n0 = ctr.n
    got = flash_attention.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert ctr.n == n0 + 1
    want = flash_attention_ref(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("r,s", [(1, 1), (300, 700), (4096, 512), (257, 3)])
def test_era_scan_bit_identical(dev, r, s):
    rng = np.random.default_rng(r + s)
    alloc = rng.integers(0, 120, r).astype(np.int32)
    retire = (alloc + rng.integers(0, 60, r)).astype(np.int32)
    lo = rng.integers(0, 200, s).astype(np.int32)
    hi = np.where(rng.random(s) < 0.5, lo,
                  lo + rng.integers(0, 40, s)).astype(np.int32)
    lo[rng.random(s) < 0.4] = INF_ERA32
    want = _can_delete_numpy(alloc, retire, lo, hi)
    t = [torch.from_numpy(a).to(dev) for a in (alloc, retire, lo, hi)]
    got = era_scan.era_scan_interval(*t).cpu().numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(era_scan_interval_ref(*t).cpu().numpy(),
                                  want)
    np.testing.assert_array_equal(
        batched_can_delete(alloc, retire, lo, hi, backend="cuda"), want)
