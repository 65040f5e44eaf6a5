"""CUDA kernels of ``repro_torch.kernels`` held against their plain PyTorch
versions on the card.  Needs a CUDA device and nvcc; skips without them.

This file imports no JAX (the machine with the card has none), so it runs
there alone:  PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances: fp32 1e-4 (the kernel and the plain version sum in different
orders and use different exp paths); bf16 2e-2 (the output is rounded to
bf16, and the tensor-core tiles also round P to bf16 for the P V product:
about one bf16 ulp).  Bounded vs unbounded walks, NaN-poisoned dead pages
and scales, the fused int8 kernel against the f32 kernel on dequantized
pools, and the era scan are held bitwise: at every chip_smoke shape,
reservation form (points, intervals, EBR's open form, empty slots), both
row tiles (reached by R) and boundary era, through the kernel and through the ``cuda``
backend's pinned round trip (also from four threads at once), and on each
pool scheme's own mirrors.  Every variant of the paged
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
from torch_era_cases import FORMS, sample_case

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


# ------------------------------------------------ era scan, redesigned
ERA_SHAPES = [(4096, 512, 0.05), (4096, 5120, 0.05), (64, 64, 0.05),
              (65536, 5120, 0.05), (65536, 5120, 0.5)]
ERA_FORMS = [("point",), ("interval",), ("open",), FORMS]
#: the kernel takes four rows per lane from this many retired rows on
#: (``kWideRows`` in csrc/era_scan.cu), one below it
WIDE_ROWS = 33792


def _era_check(dev, alloc, retire, lo, hi):
    """The kernel, the plain version and the ``cuda`` backend's round
    trip, each bitwise against the NumPy backend."""
    want = _can_delete_numpy(alloc, retire, lo, hi)
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
         for a in (alloc, retire, lo, hi)]
    got = era_scan.era_scan_interval(*t).cpu().numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(era_scan_interval_ref(*t).cpu().numpy(),
                                  want)
    got = batched_can_delete(alloc, retire, lo, hi, backend="cuda")
    assert got.dtype == np.bool_
    np.testing.assert_array_equal(got, want)
    return want


@pytest.mark.parametrize("forms", ERA_FORMS, ids="+".join)
@pytest.mark.parametrize("r,s,valid", ERA_SHAPES + [
    (WIDE_ROWS - 1, 5120, 0.5), (WIDE_ROWS, 5120, 0.5)])
def test_era_scan_shapes_and_forms(dev, r, s, valid, forms):
    """The chip_smoke shapes and both sides of the row-tile threshold,
    each reservation form alone and all mixed; both deletable and kept
    rows occur."""
    args = sample_case(r, s, valid, seed=r + s, forms=forms)
    want = _era_check(dev, *args)
    assert want.any() and not want.all()


E0, EMAX, INF = 0, INF_ERA32 - 1, INF_ERA32


@pytest.mark.parametrize("r,s", [(0, 0), (0, 5), (1, 0), (1, 1), (5, 0),
                                 (0, 1), (1, 2049), (33, 1), (129, 4097),
                                 (WIDE_ROWS, 1), (WIDE_ROWS + 33, 2049)])
@pytest.mark.parametrize("fill", ["empty", "conflict", "boundary"])
def test_era_scan_edges(dev, r, s, fill):
    """R or S of 0 and 1, tiles and chunks cut ragged at both row tiles,
    every slot empty, every row in conflict, and the boundary eras 0,
    INT32_MAX - 1 and lo = INT32_MAX."""
    rng = np.random.default_rng(r * 7919 + s)
    if fill == "empty":
        alloc = rng.integers(0, INF, r).astype(np.int32)
        retire = np.maximum(alloc, rng.integers(0, INF, r)).astype(np.int32)
        lo = np.full(s, INF, np.int32)
        hi = rng.integers(0, INF, s).astype(np.int32)
    elif fill == "conflict":  # one open slot from era 0 pins every row
        alloc = rng.integers(0, 100, r).astype(np.int32)
        retire = alloc + rng.integers(0, 100, r).astype(np.int32)
        lo = np.full(s, INF, np.int32)
        hi = np.full(s, INF, np.int32)
        if s:
            lo[-1], hi[-1] = E0, EMAX
    else:
        eras = np.array([E0, 1, EMAX - 1, EMAX], np.int32)
        alloc = rng.choice(eras, r)
        retire = np.maximum(alloc, rng.choice(eras, r)).astype(np.int32)
        lo = rng.choice(np.append(eras, INF), s).astype(np.int32)
        hi = np.maximum(lo, rng.choice(np.append(eras, INF), s)).astype(
            np.int32)
    want = _era_check(dev, alloc, retire, lo, hi)
    if fill == "empty" or s == 0:
        assert want.all()
    elif fill == "conflict":
        assert not want.any()


def test_era_scan_boundary_pairs(dev):
    """Every (alloc, retire) against every (lo, hi) over the boundary
    eras, one slot at a time and all slots at once, at both row tiles
    (the rows repeated past the threshold)."""
    eras = [E0, 1, EMAX - 1, EMAX]
    rows = [(a, b) for a in eras for b in eras if a <= b]
    alloc = np.array([a for a, _ in rows], np.int32)
    retire = np.array([b for _, b in rows], np.int32)
    slots = [(l, h) for l in eras + [INF] for h in eras + [INF] if l <= h]
    lo = np.array([l for l, _ in slots], np.int32)
    hi = np.array([h for _, h in slots], np.int32)
    for l, h in slots:
        _era_check(dev, alloc, retire, np.array([l], np.int32),
                   np.array([h], np.int32))
    _era_check(dev, alloc, retire, lo, hi)
    reps = -(-WIDE_ROWS // len(rows))
    wide = _era_check(dev, np.tile(alloc, reps), np.tile(retire, reps),
                      lo[::-1].copy(), hi[::-1].copy())
    assert len(wide) >= WIDE_ROWS


def test_era_scan_pinned_route_threads(dev):
    """Four threads scan through the pinned round trip at once, each on
    its own inputs and sizes (the staging buffers grow under them); each
    gets its own correct mask, and a mask handed back is not overwritten
    by the next scan."""
    import threading

    cases = [sample_case(r, s, v, seed=i)
             for i, (r, s, v) in enumerate([(64, 64, 0.5), (4096, 512, 0.05),
                                            (20000, 3000, 0.5),
                                            (300, 5120, 0.2)])]
    wants = [_can_delete_numpy(*c) for c in cases]
    errors, kept = [], []

    def scan(i):
        try:
            for _ in range(20):
                got = batched_can_delete(*cases[i], backend="cuda")
                if not np.array_equal(got, wants[i]):
                    errors.append(i)
                kept.append((i, got))
        except Exception as e:  # pragma: no cover - failure path
            errors.append(e)

    ts = [threading.Thread(target=scan, args=(i,)) for i in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert not errors, errors[:3]
    assert len(kept) == 80
    for i, got in kept:
        np.testing.assert_array_equal(got, wants[i])


@pytest.mark.parametrize("scheme", ["WFE", "Crystalline", "HE", "EBR",
                                    "2GEIBR"])
def test_era_scan_scheme_mirrors(dev, scheme):
    """Each pool scheme's own reservation mirrors, after a seeded history:
    the cuda backend's mask equals the numpy backend's per thread and in
    the fused all-thread scan, and both drains free the same blocks."""
    from repro_torch.core import make_scheme
    from repro_torch.core.atomics import AtomicRef, PtrView
    from repro_torch.core.smr_base import Block

    class Node(Block):
        __slots__ = ()

    kw = ({"epoch_freq": 2} if scheme in ("EBR", "2GEIBR")
          else {"era_freq": 2})
    smrs = [make_scheme(scheme, max_threads=4, cleanup_freq=10 ** 9, **kw)
            for _ in range(2)]
    rng = np.random.default_rng(11)
    script = [(int(rng.integers(4)), int(rng.integers(2)), rng.random())
              for _ in range(400)]
    for smr in smrs:
        tids = [smr.register_thread() for _ in range(4)]
        cells = [AtomicRef(None) for _ in range(2)]
        for t, c, op in script:
            if op < 0.35:
                smr.start_op(tids[t])
                cells[c].store(smr.alloc_block(Node, tids[t]))
            elif op < 0.6 and cells[c].load() is not None:
                smr.start_op(tids[t])
                smr.get_protected(PtrView(cells[c]), c, tids[t])
            elif op < 0.9 and cells[c].load() is not None:
                blk = cells[c].load()
                cells[c].store(None)
                smr.retire(blk, tids[t])
            else:
                smr.end_op(tids[t])
    numpy_smr, cuda_smr = smrs
    for tid in range(4):
        np.testing.assert_array_equal(cuda_smr.deletable_mask(tid, "cuda"),
                                      numpy_smr.deletable_mask(tid, "numpy"))
    n0 = era_scan.LAUNCHES.n
    assert (cuda_smr.cleanup_batch_all("cuda")
            == numpy_smr.cleanup_batch_all("numpy"))
    assert era_scan.LAUNCHES.n > n0
    assert cuda_smr.stats() == numpy_smr.stats()


# ------------------------------------------------- sharded engine, streams
SHARD_PROMPTS = [[5, 9, 2], [11, 3, 8, 1], [7], [2, 4], [9, 9, 1], [13],
                 [3, 1, 4, 1, 5, 9, 2, 6], [8, 8]]


def _sharded_engine(dev, **kw):
    """The reduced stablelm-3b config on 2 shards of the card."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    from repro_torch.serve import ServeEngine

    cfg = get_smoke_config("stablelm-3b")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    kw = {**dict(n_blocks=32, block_size=4, max_batch=4, chunk_size=4,
                 n_shards=2, era_freq=1, cleanup_freq=1), **kw}
    return ServeEngine(cfg, params, device=dev, **kw)


def test_each_shard_steps_on_its_own_stream(dev, monkeypatch):
    """Every step of shard s runs on shard s's stream, which is neither the
    other shard's nor the default stream, and both shards' pools take
    writes; the run completes and drains."""
    from repro_torch.serve import engine as engine_mod

    engine = _sharded_engine(dev)
    seen = []
    for name in ("paged_decode_step", "paged_prefill_chunk"):
        def wrapped(cfg, params, pools, *args, _real=getattr(engine_mod,
                                                             name)):
            seen.append((pools["k"].data_ptr(),
                         torch.cuda.current_stream(dev).cuda_stream))
            return _real(cfg, params, pools, *args)

        monkeypatch.setattr(engine_mod, name, wrapped)
    tid = engine.pool.register_thread()
    reqs = [engine.submit(p, 5) for p in SHARD_PROMPTS]
    stats = engine.run(tid)
    assert stats["completed"] == len(reqs)
    assert engine.pool.unreclaimed() == 0 and engine.pool.free_blocks == 32
    shard_of = {p["k"].data_ptr(): s
                for s, p in enumerate(engine._shard_pools)}
    streams = {}
    for ptr, stream in seen:
        streams.setdefault(shard_of[ptr], set()).add(stream)
    own = [s.cuda_stream for s in engine._streams]
    assert streams == {0: {own[0]}, 1: {own[1]}}
    assert own[0] != own[1]
    assert torch.cuda.default_stream(dev).cuda_stream not in own
    for pools in engine._shard_pools:
        assert pools["k"].abs().sum().item() > 0, "a shard took no write"


def test_exception_after_launch_leaves_stream_idle(dev, monkeypatch):
    """A decode step that raises after its launches (with more device work
    queued behind them) has synchronized its shard's stream by the time
    the exception reaches the caller: a reaped reservation never races a
    queued read."""
    from repro_torch.serve import engine as engine_mod

    engine = _sharded_engine(dev)
    # the queued work is long enough to be still running when queried
    probe = engine._streams[0]
    with torch.cuda.stream(probe):
        torch.cuda._sleep(200_000_000)
    assert not probe.query(), "the sleep ended before the query"
    probe.synchronize()
    real = engine_mod.paged_decode_step

    def failing(*args):
        out = real(*args)
        torch.cuda._sleep(200_000_000)
        raise RuntimeError("device fault after the launches")

    monkeypatch.setattr(engine_mod, "paged_decode_step", failing)
    tid = engine.pool.register_thread()
    for p in SHARD_PROMPTS:
        engine.submit(p, 5)
    with pytest.raises(RuntimeError, match="after the launches"):
        for _ in range(1000):
            engine.step(tid)
    shard = engine.take_orphaned_plan(tid).shard
    assert engine._streams[shard].query(), "the shard's stream still busy"


def test_runtime_on_two_shards(dev):
    """Two workers on two shards of the card: every request completes with
    its full token count, the pool drains, both workers step."""
    from repro_torch.serve import ServeRuntime

    engine = _sharded_engine(dev, max_threads=8, max_inflight=4)
    reqs = [engine.submit(p, 6) for p in SHARD_PROMPTS * 2]
    stats = ServeRuntime(engine, n_workers=2).serve()
    assert stats["completed"] == len(reqs) and stats["unreclaimed"] == 0
    assert all(len(r.generated) == 6 for r in reqs)
    assert engine.pool.free_blocks == 32
    assert {r.shard for r in reqs} == {0, 1}


def test_launch_counts_from_threads(dev):
    """4 threads x 1000 era-scan launches count 4000 launches."""
    import threading

    t = [torch.tensor(a, dtype=torch.int32, device=dev)
         for a in ([1, 2], [3, 4], [2, 9], [2, 9])]
    barrier = threading.Barrier(4)

    def launch():
        barrier.wait()
        for _ in range(1000):
            era_scan.era_scan_interval(*t)

    n0 = era_scan.LAUNCHES.n
    threads = [threading.Thread(target=launch) for _ in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not any(th.is_alive() for th in threads)
    torch.cuda.synchronize()
    assert era_scan.LAUNCHES.n - n0 == 4000


def test_int8_scale_pools_are_per_shard(dev):
    """With int8 pages each shard has its own scale pools, sized to its
    slots plus the scratch slot; both take writes; the run drains."""
    engine = _sharded_engine(dev, kv_dtype="int8")
    sizes = engine._shard_sizes
    ptrs = set()
    for pools, size in zip(engine._shard_pools, sizes):
        assert pools["k"].dtype == torch.int8
        for name in ("k_scale", "v_scale"):
            assert pools[name].shape[1] == size + 1
            ptrs.add(pools[name].data_ptr())
    assert len(ptrs) == 4
    tid = engine.pool.register_thread()
    reqs = [engine.submit(p, 5) for p in SHARD_PROMPTS]
    stats = engine.run(tid)
    assert stats["completed"] == len(reqs)
    assert engine.pool.unreclaimed() == 0
    for pools in engine._shard_pools:
        assert pools["k_scale"].max().item() > 0, "a shard's scales unused"
