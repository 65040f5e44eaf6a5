"""CUDA kernels of ``repro_torch.kernels`` held against their plain PyTorch
versions on the card.  Needs a CUDA device and nvcc; skips without them.

This file imports no JAX (the machine with the card has none), so it runs
there alone:  PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances: fp32 1e-4 (the kernel and the plain version sum in different
orders and use different exp paths); bf16 2e-2 (the output is rounded to
bf16, and the tensor-core tiles also round P to bf16 for the P V product:
about one bf16 ulp); whisper's encoder, whose outputs are far smaller,
is held to limits from its own magnitudes.  Bounded vs unbounded walks, NaN-poisoned dead pages
and scales, the fused int8 kernel against the f32 kernel on dequantized
pools, and the era scan are held bitwise: at every chip_smoke shape,
reservation form (points, intervals, EBR's open form, empty slots), both
row tiles (reached by R) and boundary era, through the kernel and through the ``cuda``
backend's pinned round trip (also from four threads at once), and on each
pool scheme's own mirrors.  Every variant of the paged
kernel (``choose_variant``: split-KV walk, tensor-core tile, f32 tile) is
swept over C, G, D and bs, and each is also held against the plain model
of its own algebra in ``ref``.  The f32 tile (``cuda_core`` in both
kernels) is held to its model within rtol 1e-6 plus 1e-5 of the largest
|output| (one bf16 step for a bf16 output) over every route the variant
tables send it, two calls give the same bits, and its K/V copies in 16
bytes, 4 bytes or element by element (row sizes that divide no further)
are each reached.
The split-KV walk keeps scores, P and partials in f32, so its bf16 output
is held to one bf16 rounding step (rtol 2**-7) and, in f32, to its model
within 1e-5.  Head dim 256 (gemma-7b) is swept in every variant over every
pool type, and flash at D 256 in both its variants.  The flash backward is
held in both its variants (the tensor-core tile, and the f32 tile on f32
and on widened bf16 inputs) to phase 8(a)'s limits, and its determinism
and the f32 tile's 64-row and one-warp CTAs bitwise.  The engine's dispatch
is run with the CUDA sync debug mode at "error" while its lock is held.
The engine's compiled steps (one CUDA graph per shard and signature) give
the eager steps' tokens and launch counts bitwise, with bf16 and int8
pages, over decode, mixed and prefill steps; the packed mixed step
replays the eager one's ids bitwise and matches the chunk step on the
plan's ragged rows within the bf16 limit; the ``pools`` setter and
``clear_compile_caches()`` drop the graphs; a capture holds while another
thread waits on the shard's stream, scans eras and frees pinned memory.
The trainer's compiled step (one CUDA graph per step signature) leaves
the eager step's parameters, optimizer state and metrics at 1 and 2
microbatches with and without remat, with its launch counts; its metrics
are copies; a restored state drops the old graph and captures anew; a
capture that fails raises.
"""

import math
import threading

import numpy as np
import pytest
import torch

from repro_torch.core.era_table import _can_delete_numpy, batched_can_delete
from repro_torch.kernels import era_scan, flash_attention, paged_attention
from repro_torch.kernels.quant import dequantize_pool
from repro_torch.kernels.ref import (INF_ERA32, era_scan_interval_ref,
                                     flash_attention_f32_tile_ref,
                                     flash_attention_ref,
                                     paged_attention_chunk_int8_ref,
                                     paged_attention_chunk_ref,
                                     paged_attention_f32_tile_ref,
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
    (8, 1, 16, 1, 256, 16, 16),   # gemma-7b decode
    (3, 40, 16, 1, 256, 16, 8),   # gemma-7b chunk, ragged
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
@pytest.mark.parametrize("c", [1, 40])
def test_half_pools_under_f32_query_d256(dev, pool_dtype, c):
    """At D 256, decode (the split-KV walk) and a chunk (the CUDA-core
    walk): half pools equal the f32 pools made from them, bitwise."""
    q, k, v, tables, qpos, live = _case(3, c, 16, 1, 256, 16, 8,
                                        torch.float32, dev, seed=c + 256)
    kp, vp = k.to(pool_dtype), v.to(pool_dtype)
    got = paged_attention.paged_attention_chunk(q, kp, vp, tables, qpos, live)
    f32 = paged_attention.paged_attention_chunk(q, kp.float(), vp.float(),
                                                tables, qpos, live)
    assert torch.equal(got, f32)


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
    (1, 300, 16, 16, 256, True),  # gemma-7b heads, ragged T
    (2, 130, 8, 2, 256, False),   # D 256, GQA, non-causal
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
    kvdt = {"bf16": torch.bfloat16, "f32": torch.float32,
            "f16": torch.float16}.get(pool)
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


def _f32_model_close(got, model):
    """The f32 tile against its model: rtol 1e-6 (one bf16 step for a bf16
    output), and 1e-5 of the largest |output| for outputs near zero (the
    two sum each product in another order)."""
    rtol = 1e-6 if got.dtype == torch.float32 else 2.0 ** -7
    model = model.float()
    torch.testing.assert_close(got.float(), model, rtol=rtol,
                               atol=1e-5 * model.abs().max().item())


def _check_model(args, variant, nblk):
    """The split-KV walk against ``paged_attention_split_ref`` (within
    1e-5 in f32, one bf16 step in bf16), the tile against
    ``paged_attention_tile_ref`` (2e-2), the f32 tile against
    ``paged_attention_f32_tile_ref`` (``_f32_model_close``)."""
    q, k, v, tables, qpos, live, ksc, vsc = args
    got = paged_attention.paged_attention_chunk(*args)
    if variant == "cuda_core":
        _f32_model_close(got, paged_attention_f32_tile_ref(
            q, k, v, tables, qpos, live, k_scales=ksc, v_scales=vsc))
        return
    if variant == "split":
        pps, nsplit = paged_attention.split_plan(
            nblk, k.shape[1], q.shape[-1])
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
    """Against plain; against the model of its variant's algebra; bounded
    == unbounded bitwise; NaN-poisoned dead pages and scales unread; the
    variant's counter bumped once."""
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


# gemma-7b width (KH 16, G 1, D 256, bs 16): decode, short and long chunks
@pytest.mark.parametrize("pool", ["bf16", "int8", "f32", "f16"])
@pytest.mark.parametrize("c", [1, 2, 15, 16, 17, 64, 256])
def test_variants_gemma_width(dev, pool, c):
    nblk = (c + 200) // 16 + 2
    args, variant = _variant_case(2, c, 16, 1, 256, 16, nblk, pool, dev,
                                  seed=c + 7 * len(pool))
    assert variant == ("split" if c < 16 else
                       "tile" if pool in ("bf16", "int8") else "cuda_core")
    _check_variant(args, variant, nblk, dev)


# D 256 under GQA and other block sizes: splits of 64 keys in every pool
# type, so a 64-token page is one page a split
@pytest.mark.parametrize("pool", ["bf16", "int8", "f32", "f16"])
@pytest.mark.parametrize("c", [1, 20])
@pytest.mark.parametrize("g,bs", [(1, 8), (4, 16), (12, 16), (2, 64)])
def test_variants_d256_gqa_block_size(dev, pool, c, g, bs):
    nblk = (c + 300) // bs + 2
    args, variant = _variant_case(2, c, 2, g, 256, bs, nblk, pool, dev,
                                  seed=c * g + bs + 256)
    want = ("split" if c * g < 16 else
            "tile" if pool in ("bf16", "int8") else "cuda_core")
    assert variant == want
    _check_variant(args, variant, nblk, dev)


@pytest.mark.parametrize("pool,c", [("bf16", 1), ("int8", 1), ("f32", 1),
                                    ("bf16", 40), ("int8", 40), ("f32", 40)])
def test_variants_d256_all_masked_row_is_zero(dev, pool, c):
    """A request with no live slot (live 0) writes 0 at D 256 too."""
    args, variant = _variant_case(2, c, 4, 1, 256, 16, 6, pool, dev,
                                  seed=c + 1)
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


# ------------------------------------------- the f32 tile, every route
# (q, pool, B, C, KH, G, D, bs, nblk): each shape ``choose_variant`` sends
# to ``cuda_core``
F32_TILE_ROUTES = [
    ("bf16", "bf16", 2, 20, 2, 1, 72, 16, 6),    # D 72: no tensor-core tile
    ("bf16", "bf16", 2, 20, 2, 1, 96, 16, 6),    # D 96
    ("bf16", "int8", 2, 20, 2, 2, 72, 16, 6),    # int8 rows of 72 bytes
    ("bf16", "f16", 2, 40, 4, 1, 80, 16, 8),     # fp16 pages under bf16
    ("bf16", "f32", 2, 40, 4, 1, 80, 16, 8),     # f32 pages under bf16
    ("bf16", "bf16", 2, 1, 4, 1, 80, 256, 3),    # a page of 256 keys
    ("f32", "f32", 2, 1, 4, 1, 256, 128, 4),     # a page of 128 at D 256
    ("bf16", "bf16", 3, 1, 2, 4, 72, 16, 8),     # rows < 16 at D 72
    ("bf16", "bf16", 2, 3, 2, 1, 33, 8, 6),      # 66-byte rows: by element
    ("f32", "f32", 2, 3, 2, 1, 33, 8, 6),        # 132-byte rows: 4 bytes
    ("f32", "f32", 2, 40, 4, 1, 80, 16, 8),      # f32 chunk
    ("f32", "int8", 2, 40, 4, 1, 80, 16, 8),     # int8 pages under f32
    ("f32", "bf16", 2, 40, 2, 4, 128, 16, 8),    # GQA G 4, D 128
    ("f32", "f32", 2, 256, 2, 1, 256, 16, 20),   # gemma-7b chunk width
    ("f32", "f16", 9, 256, 4, 1, 80, 16, 24),    # 144 CTAs: 64 rows a CTA
]


@pytest.mark.parametrize("qd,pool,b,c,kh,g,d,bs,nblk", F32_TILE_ROUTES)
def test_f32_tile_routes(dev, qd, pool, b, c, kh, g, d, bs, nblk):
    """Against plain (1e-4 f32, 2e-2 bf16) and the f32 model; two calls
    the same bits; bounded == unbounded; dead pages and scales unread."""
    qdt = torch.float32 if qd == "f32" else torch.bfloat16
    q, k, v, tables, qpos, live = _case(b, c, kh, g, d, bs, nblk, qdt, dev,
                                        seed=b * c + d + bs)
    ksc = vsc = None
    if pool == "int8":
        k, v, ksc, vsc = _int8_pools(k, v, dev, seed=d + bs)
    else:
        kvdt = {"bf16": torch.bfloat16, "f16": torch.float16,
                "f32": torch.float32}[pool]
        k, v = k.to(kvdt), v.to(kvdt)
    assert paged_attention.choose_variant(qdt, k.dtype, c * g, d, bs) == \
        "cuda_core"
    args = (q, k, v, tables, qpos, live, ksc, vsc)
    _check_variant(args, "cuda_core", nblk, dev)
    got = paged_attention.paged_attention_chunk(*args)
    assert torch.equal(got, paged_attention.paged_attention_chunk(*args))


@pytest.mark.parametrize("b,c,kh,g,d,bs,nblk", [
    (2, 40, 4, 1, 80, 16, 8), (2, 20, 2, 2, 72, 16, 6),
    (9, 256, 2, 1, 256, 16, 20), (2, 1, 4, 1, 80, 256, 3)])
def test_f32_tile_int8_fused_equals_dequantized(dev, b, c, kh, g, d, bs,
                                                nblk):
    """Under an f32 query the f32 tile widens a code as __fmul_rn(code,
    scale), ``dequantize_pool``'s rounding: fused int8 equals the f32
    pools bitwise, through the 16-byte and the 4-byte copies."""
    q, k, v, tables, qpos, live = _case(b, c, kh, g, d, bs, nblk,
                                        torch.float32, dev, seed=b + c + d)
    kq, vq, ksc, vsc = _int8_pools(k, v, dev, seed=bs + d)
    assert paged_attention.choose_variant(torch.float32, torch.int8, c * g,
                                          d, bs) == "cuda_core"
    fused = paged_attention.paged_attention_chunk(q, kq, vq, tables, qpos,
                                                  live, ksc, vsc)
    mat = paged_attention.paged_attention_chunk(
        q, dequantize_pool(kq, ksc), dequantize_pool(vq, vsc), tables, qpos,
        live)
    assert torch.equal(fused, mat)


# (B, T, H, KH, D, causal)
F32_FLASH_ROUTES = [
    (2, 1500, 12, 12, 64, False),   # whisper-small's encoder, f32 group
    (2, 64, 32, 8, 128, True),      # mixtral-8x7b's f32 group: 16-row CTAs
    (2, 64, 10, 1, 256, True),      # recurrentgemma-2b's f32 group
    (1, 300, 32, 32, 80, True),     # stablelm-3b heads, ragged T
    (2, 130, 8, 2, 256, False),     # D 256, GQA, non-causal, ragged
    (1, 77, 4, 2, 33, True),        # odd D: 4-byte copies
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,kh,d,causal", F32_FLASH_ROUTES + [
    (1, 200, 8, 2, 96, True), (2, 100, 4, 4, 32, False)])
def test_f32_tile_flash(dev, dtype, b, t, h, kh, d, causal):
    """The flash kernel's f32 tile (f32 at every D; bf16 where the
    tensor-core tile is not built) against plain and its model, the
    log-sum-exp the backward reads against the model's, two calls the same
    bits."""
    if flash_attention.choose_variant(dtype, d) != "cuda_core":
        pytest.skip("the tensor-core tile's route")
    rng = np.random.default_rng(t + h + d)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(dev).to(dtype)
               for s in ((b, t, h, d), (b, t, kh, d), (b, t, kh, d)))
    ctr = flash_attention.VARIANT_LAUNCHES["cuda_core"]
    n0 = ctr.n
    out, lse = flash_attention._forward(q, k, v, causal, with_lse=True)
    torch.cuda.synchronize()
    assert ctr.n == n0 + 1
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(
        out.float(), flash_attention_ref(q, k, v, causal=causal).float(),
        rtol=tol, atol=tol)
    want, want_lse = flash_attention_f32_tile_ref(q, k, v, causal=causal,
                                                  with_lse=True)
    _f32_model_close(out, want)
    torch.testing.assert_close(lse, want_lse, rtol=1e-6, atol=1e-5)
    assert torch.equal(out, flash_attention.flash_attention(q, k, v,
                                                            causal=causal))


@pytest.mark.parametrize("b,t,h,kh,d", [
    (1, 300, 32, 32, 80),     # stablelm-3b heads, ragged T
    (1, 4096, 32, 32, 80),    # stablelm-3b prefill
    (1, 4096, 24, 2, 128),    # starcoder2-3b prefill (GQA 12)
    (2, 300, 8, 1, 64),       # MQA, ragged T
    (1, 4096, 16, 16, 256),   # gemma-7b prefill
    (1, 300, 32, 8, 256),     # D 256, GQA 4, ragged T
    (2, 1024, 32, 8, 128),    # mixtral-8x7b prefill (GQA 4)
    (1, 4096, 32, 8, 128),    # mixtral-8x7b prefill at its window
    (2, 1024, 10, 1, 256),    # recurrentgemma-2b local attention (MQA 10)
    (1, 2048, 10, 1, 256),    # recurrentgemma-2b at its window
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
    writes; the run completes and drains.  A step called while a graph is
    captured is on the shard's capture stream (its replays run on the
    shard's stream)."""
    from repro_torch.serve import engine as engine_mod

    engine = _sharded_engine(dev)
    seen = []
    for name in ("paged_decode_step", "paged_prefill_chunk"):
        def wrapped(cfg, params, pools, *args, _real=getattr(engine_mod,
                                                             name)):
            seen.append((pools["k"].data_ptr(),
                         torch.cuda.current_stream(dev).cuda_stream,
                         torch.cuda.is_current_stream_capturing()))
            return _real(cfg, params, pools, *args)

        monkeypatch.setattr(engine_mod, name, wrapped)
    tid = engine.pool.register_thread()
    reqs = [engine.submit(p, 5) for p in SHARD_PROMPTS]
    stats = engine.run(tid)
    assert stats["completed"] == len(reqs)
    assert engine.pool.unreclaimed() == 0 and engine.pool.free_blocks == 32
    shard_of = {p["k"].data_ptr(): s
                for s, p in enumerate(engine._shard_pools)}
    streams, captures = {}, {}
    for ptr, stream, capturing in seen:
        (captures if capturing else streams).setdefault(
            shard_of[ptr], set()).add(stream)
    own = [s.cuda_stream for s in engine._streams]
    assert streams == {0: {own[0]}, 1: {own[1]}}
    assert captures == {s: {c.cuda_stream}
                        for s, c in enumerate(engine._capture_streams)}
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


# ------------------------------------------------ compiled steps (graphs)
LAUNCH_COUNTERS = {"float": paged_attention.LAUNCHES,
                   "int8": paged_attention.LAUNCHES_Q8,
                   **paged_attention.VARIANT_LAUNCHES}


def _smoke_engine(dev, **kw):
    """The bf16 smoke stablelm-3b on one shard of the card, with the era
    scan on the card."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    from repro_torch.serve import ServeEngine

    cfg = get_smoke_config("stablelm-3b").scaled(dtype=torch.bfloat16)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    kw = {**dict(n_blocks=48, block_size=4, max_batch=4, chunk_size=8,
                 era_freq=1, cleanup_freq=1, use_kernel=True), **kw}
    return ServeEngine(cfg, params, device=dev, **kw)


def _serve_counted(engine, eager=False):
    """Serve SHARD_PROMPTS x 3 (6 new tokens each) on one thread, the launch
    counts zeroed just before; returns (tokens, launches, plan kinds)."""
    import contextlib

    from repro_torch.serve.engine import _eager_steps

    kinds = []
    real = engine._run_step

    def spy(plan, *args):
        kinds.append(plan.kind)
        return real(plan, *args)

    engine._run_step = spy
    for ctr in LAUNCH_COUNTERS.values():
        ctr.n = 0
    with _eager_steps() if eager else contextlib.nullcontext():
        tid = engine.pool.register_thread()
        reqs = [engine.submit(p * 3, 6) for p in SHARD_PROMPTS]
        stats = engine.run(tid)
    torch.cuda.synchronize()
    assert stats["completed"] == len(reqs)
    assert engine.pool.unreclaimed() == 0
    del engine._run_step
    return ([r.generated for r in reqs],
            {k: ctr.n for k, ctr in LAUNCH_COUNTERS.items()}, set(kinds))


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_graph_steps_equal_eager(dev, kv_dtype):
    """Decode, mixed and prefill steps replayed from their graphs emit the
    eager steps' greedy tokens bitwise with the same launch counts, and
    the engine holds one graph per signature."""
    compiled = _smoke_engine(dev, kv_dtype=kv_dtype)
    got = _serve_counted(compiled)
    want = _serve_counted(_smoke_engine(dev, kv_dtype=kv_dtype), eager=True)
    assert {"prefill", "mixed", "decode"} <= got[2] == want[2]
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[1]["int8" if kv_dtype else "float"] > 0
    assert len(compiled._graphs) == compiled.compile_cache_size() > 0


def test_pools_setter_and_clear_drop_graphs(dev):
    """The ``pools`` setter drops shard 0's graphs (they write the old
    pages) and keeps shard 1's; ``clear_compile_caches()`` drops every
    graph and pool; a later run captures again."""
    engine = _sharded_engine(dev, n_blocks=48, chunk_size=8)
    tid = engine.pool.register_thread()
    for p in SHARD_PROMPTS:
        engine.submit(p * 3, 6)
    engine.run(tid)
    shards = {s for s, _ in engine._graphs}
    assert shards == {0, 1}
    n1 = sum(s == 1 for s, _ in engine._graphs)
    engine.pools = engine.pools
    assert {s for s, _ in engine._graphs} == {1}
    assert len(engine._graphs) == n1
    assert engine._graph_pools[0] is None
    for p in SHARD_PROMPTS:
        engine.submit(p[::-1] * 3, 6)
    assert engine.run(tid)["completed"] == 2 * len(SHARD_PROMPTS)
    assert {s for s, _ in engine._graphs} == {0, 1}
    assert engine.clear_compile_caches()
    assert not engine._graphs and engine.compile_cache_size() == 0
    assert engine._graph_pools == [None, None]
    reqs = [engine.submit(p, 4) for p in SHARD_PROMPTS]
    engine.run(tid)
    assert all(len(r.generated) == 4 for r in reqs)
    assert {key for _, key in engine._graphs} == engine._shapes
    assert engine.compile_cache_size() > 0


def test_capture_while_another_thread_syncs(dev):
    """While a worker captures a step's graph (under the dispatch lock),
    another thread does what a second worker does meanwhile: waits on an
    event of the shard's stream, runs cleanup and an era scan on the card
    (which synchronizes its stream), and frees a pinned buffer copied on
    the shard's stream.  Every capture survives, and the run emits the
    eager run's tokens."""
    from repro_torch.kernels import ops

    want = _serve_counted(_smoke_engine(dev), eager=True)
    engine = _smoke_engine(dev)
    fired = []
    sample = engine._sample

    def second_worker(shard):
        stream = engine._streams[shard]
        done = torch.cuda.Event()
        done.record(stream)
        done.synchronize()
        engine.pool.cleanup_all()
        era = np.arange(4, dtype=np.int32)
        mask = ops.can_delete_blocks_interval(era, era + 2, era[:2],
                                              era[:2] + 1, device=dev)
        with torch.cuda.stream(stream):
            staged = torch.arange(64, dtype=torch.int32).pin_memory()
            on_card = staged.to(dev, non_blocking=True)
        done.record(stream)
        done.synchronize()
        del staged  # its free records an event on the shard's stream
        return mask, on_card

    def capturing_sample(step, shard, args):
        if torch.cuda.is_current_stream_capturing():
            out = []
            th = threading.Thread(
                target=lambda: out.append(second_worker(shard)))
            th.start()
            th.join(timeout=120)
            fired.append(not th.is_alive() and len(out) == 1)
        return sample(step, shard, args)

    engine._sample = capturing_sample
    got = _serve_counted(engine)
    assert fired and all(fired)
    assert len(fired) == len(engine._graphs)
    assert got[0] == want[0] and got[1] == want[1]


# ------------------------------------------ no host sync under the lock
class _NoSyncLock:
    """The engine's dispatch lock, with the CUDA sync debug mode at
    "error" while it is held: a host sync under it raises."""

    def __init__(self, lock):
        self._lock = lock

    def __enter__(self):
        self._lock.acquire()
        torch.cuda.set_sync_debug_mode("error")

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode(0)
        self._lock.release()


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_dispatch_makes_no_host_sync(dev, kv_dtype):
    """Every step of a bf16 engine, prefill and mixed ones included, runs
    under its dispatch lock without a host sync, with bf16 and with int8
    pages, and emits the tokens of the same engine run unwatched."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    from repro_torch.serve import ServeEngine

    cfg = get_smoke_config("stablelm-3b").scaled(dtype=torch.bfloat16)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    outs = []
    for watched in (False, True):
        engine = ServeEngine(cfg, params, n_blocks=48, block_size=4,
                             max_batch=4, chunk_size=8, kv_dtype=kv_dtype,
                             era_freq=1, cleanup_freq=1, device=dev)
        kinds = []
        real = engine._run_step

        def spy(plan, *args, _real=real, _kinds=kinds):
            _kinds.append(plan.kind)
            return _real(plan, *args)

        engine._run_step = spy
        if watched:
            engine._dispatch_lock = _NoSyncLock(engine._dispatch_lock)
        tid = engine.pool.register_thread()
        reqs = [engine.submit(p * 3, 6) for p in SHARD_PROMPTS]
        stats = engine.run(tid)
        assert stats["completed"] == len(reqs)
        assert engine.pool.unreclaimed() == 0
        assert {"prefill", "mixed", "decode"} <= set(kinds), kinds
        outs.append([r.generated for r in reqs])
    assert outs[0] == outs[1]


def test_packed_mixed_step_replays_eager_and_ragged(dev):
    """Every mixed plan of a bf16 engine runs the packed step (decode slots
    and the chunk's bucket on one token axis): replayed from its graph it
    gives the eager packed step's ids bitwise, and its logits match the
    chunk step on the plan's ragged (B, C) rows within the bf16 limit."""
    from repro_torch.serve.paged_model import (paged_mixed_step,
                                               paged_prefill_chunk)

    engine = _smoke_engine(dev)
    cfg, params = engine.cfg, engine.params
    real = engine._run_step
    seen = {"mixed": 0, "replayed": 0}

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    def spy(plan, step, arrays, b):
        if step is not paged_mixed_step:
            return real(plan, step, arrays, b)
        assert arrays[0].shape[0] == engine.max_batch + 1
        torch.cuda.synchronize()
        pools = engine._shard_pools[plan.shard]
        eager = {k: v.clone() for k, v in pools.items()}
        lg, _ = paged_mixed_step(cfg, params, eager,
                                 *[None if a is None else t(a)
                                   for a in arrays])
        ragged = {k: v.clone() for k, v in pools.items()}
        lg_ragged, _ = paged_prefill_chunk(
            cfg, params, ragged, t(plan.tables), t(plan.tokens),
            t(plan.positions), t(plan.chunk_lens))
        want = torch.argmax(lg, -1)[:b].cpu().numpy()
        close = torch.allclose(lg[:b], lg_ragged, rtol=2e-2, atol=2e-2)
        torch.cuda.synchronize()
        key = engine._signature(plan.kind, arrays)
        seen["replayed"] += int((plan.shard, key) in engine._graphs)
        ids = real(plan, step, arrays, b)
        assert np.array_equal(ids, want)
        assert close, (lg[:b] - lg_ragged).abs().max().item()
        seen["mixed"] += 1
        return ids

    engine._run_step = spy
    tid = engine.pool.register_thread()
    reqs = [engine.submit(p * 3, 6) for p in SHARD_PROMPTS * 2]
    stats = engine.run(tid)
    assert stats["completed"] == len(reqs)
    assert engine.pool.unreclaimed() == 0
    assert seen["mixed"] > 0 and seen["replayed"] > 0, seen


def _scaled_close(got, want, rel_rms=7e-3) -> bool:
    """Within rtol 1e-2 plus 4 bf16 ulps of max |want| elementwise, and a
    relative RMS error within ``rel_rms``: a limit from the shape's own
    magnitudes, for outputs far below 2e-2."""
    got, want = got.float(), want.float()
    ulp = 2.0 ** (math.floor(math.log2(want.abs().max().item())) - 7)
    return (torch.allclose(got, want, rtol=1e-2, atol=4 * ulp)
            and ((got - want).norm() / want.norm()).item() <= rel_rms)


def _attend(q, k, v):
    """Non-causal attention in f32 over any number of keys, rounded."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / 8.0
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1),
                        v.float()).to(q.dtype)


@pytest.mark.parametrize("b,t", [(1, 1500), (2, 1500), (1, 100)])
def test_flash_tile_bf16_whisper_encoder(dev, b, t):
    """whisper-small's encoder self-attention: 12 heads of 64, non-causal,
    over 1500 frames (not a multiple of the 64-key tile).  |out| is about
    0.04 here, so the limit is the shape's own; the last tile broken on
    purpose (its pad keys unmasked, or dropped) must fail it."""
    rng = np.random.default_rng(t + b)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, t, 12, 64)).astype(
        np.float32)).to(dev).to(torch.bfloat16) for _ in range(3))
    got = flash_attention.flash_attention(q, k, v, causal=False)
    want = flash_attention_ref(q, k, v, causal=False)
    assert _scaled_close(got, want)
    cut = t - t % 64
    z = k.new_zeros((b, 64 - t % 64, 12, 64))
    assert not _scaled_close(_attend(q, torch.cat([k, z], 1),
                                     torch.cat([v, z], 1)), want)
    assert not _scaled_close(_attend(q, k[:, :cut], v[:, :cut]), want)


# ------------------------------------------------- the model zoo on the card
ZOO_ARCHS = ("recurrentgemma-2b", "stablelm-3b", "starcoder2-3b",
             "starcoder2-7b", "gemma-7b", "deepseek-v2-236b", "mixtral-8x7b",
             "xlstm-350m", "pixtral-12b", "whisper-small")


def _zoo_routes(cfg, t):
    """(kernel, plain) flash calls of a T-token forward on the card: the
    table of ``models.attention``."""
    n_attn = cfg.n_groups * sum(k in ("attn", "local_attn", "swa")
                                for k in cfg.block_pattern)
    if cfg.is_encoder_decoder:
        return cfg.n_encoder_layers + cfg.n_layers, cfg.n_layers
    windowed = any(k in ("local_attn", "swa") for k in cfg.block_pattern)
    if cfg.use_mla or (windowed and t > cfg.window):
        return 0, n_attn
    return n_attn, 0


@pytest.mark.parametrize("t", [8, 24])
@pytest.mark.parametrize("arch", ZOO_ARCHS)
def test_zoo_forward_routes_and_matches_plain(dev, arch, t):
    """A smoke-size f32 forward on the card takes the flash kernel where
    the route table says (counted by ``FLASH_ROUTES`` and the kernel's own
    launches) and matches the same forward on the CPU, where every call
    takes the plain route."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import attention, build_model, init_params

    cfg = get_smoke_config(arch)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(t)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, t)).astype(
        np.int32))
    extra = {}
    if cfg.frontend == "frames":
        extra["frames"] = torch.from_numpy(0.02 * rng.standard_normal(
            (2, cfg.encoder_ctx, cfg.d_model)).astype(np.float32))
    model = build_model(cfg)
    want = model.forward(params, toks, extra)
    to = lambda tree: {k: to(v) for k, v in tree.items()} \
        if isinstance(tree, dict) else tree.to(dev)  # noqa: E731
    k0, p0 = (attention.FLASH_ROUTES[r].n for r in ("kernel", "plain"))
    n0 = flash_attention.LAUNCHES.n
    got = model.forward(to(params), toks.to(dev), to(extra))
    torch.cuda.synchronize()
    routes = (attention.FLASH_ROUTES["kernel"].n - k0,
              attention.FLASH_ROUTES["plain"].n - p0)
    assert routes == _zoo_routes(cfg, t)
    assert flash_attention.LAUNCHES.n - n0 == routes[0]
    torch.testing.assert_close(got.cpu(), want, rtol=1e-3, atol=1e-3)


def test_zoo_kernel_route_raises_without_fallback(dev, monkeypatch):
    """A launch error of the flash kernel reaches the caller: the route
    catches nothing and never runs the plain version instead."""
    from repro_torch.kernels import build as kbuild
    from repro_torch.models import attention

    def fail(err, name):
        raise RuntimeError(f"{name}: injected launch failure")

    monkeypatch.setattr(kbuild, "check", fail)
    q = torch.zeros((1, 8, 2, 64), device=dev)
    pos = torch.arange(8, device=dev)[None]
    p0 = attention.FLASH_ROUTES["plain"].n
    with pytest.raises(RuntimeError, match="injected"):
        attention.flash_attention(q, q, q, pos, pos, arange_positions=True)
    assert attention.FLASH_ROUTES["plain"].n == p0


# ------------------------------------------------ flash backward (training)
#: (B, T, H, KH, D, causal): chip_smoke phase 8(a)'s shapes and small
#: ragged ones (T not a multiple of the 64- or 32-row tile, D off the tile
#: dims, GQA and MQA, and the tile's GQA split)
BWD_SHAPES = [
    (1, 2048, 32, 32, 80, True),   # stablelm-3b training microbatch
    (1, 2048, 24, 2, 128, True),   # starcoder2-3b (G 12)
    (1, 2048, 16, 16, 256, True),  # gemma-7b (D 256)
    (4, 1500, 12, 12, 64, False),  # whisper-small encoder, ragged tail
    (2, 100, 8, 2, 48, True),      # GQA 4, D off the tile dims, ragged
    (1, 77, 4, 1, 160, False),     # MQA, D 160 (32-row tiles), ragged
    (3, 3, 2, 2, 32, True),        # three tokens, one partial tile
    (2, 100, 8, 2, 64, True),      # GQA 4 on the tile, ragged
    (1, 77, 4, 1, 80, False),      # MQA on the tile, ragged
    (1, 300, 24, 2, 128, True),    # G 12 over few key tiles: the split
    (2, 130, 8, 2, 256, True),     # GQA at D 256: split warps
]
#: (dtype, variant, shape): every shape in f32 on the f32 tile, and in bf16
#: on the f32 tile and, at the tile's head dims, on the tensor-core tile
BWD_CASES = [
    pytest.param(dtype, variant, *shape,
                 id=f"{variant}-{str(dtype)[6:]}-" + "-".join(map(str, shape)))
    for shape in BWD_SHAPES
    for dtype in (torch.bfloat16, torch.float32)
    for variant in ("tile", "cuda_core")
    if variant == "cuda_core"
    or flash_attention.choose_bwd_variant(dtype, shape[4]) == "tile"]


def _bwd_limit(got, want, dtype):
    """The phase 8(a) limits: bf16 within rtol 2e-2 plus 4 ulps of max
    |want| and relative RMS 5e-3; f32 within rtol 1e-4 plus 1e-5 of max
    |want| and relative RMS 1e-5."""
    got, want = got.float(), want.float()
    top = want.abs().max().item()
    if dtype == torch.bfloat16:
        atol = 4 * 2.0 ** (math.floor(math.log2(max(top, 1e-30))) - 7)
        rtol, rel = 2e-2, 5e-3
    else:
        atol, rtol, rel = 1e-5 * top, 1e-4, 1e-5
    rms = ((got - want).norm() / want.norm().clamp(min=1e-30)).item()
    return torch.allclose(got, want, rtol=rtol, atol=atol) and rms <= rel


def _bwd_inputs(b, t, h, kh, d, dtype, dev, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(dev).to(dtype)
            for s in ((b, t, h, d), (b, t, kh, d), (b, t, kh, d),
                      (b, t, h, d))]


@pytest.mark.parametrize("dtype,variant,b,t,h,kh,d,causal", BWD_CASES)
def test_flash_bwd_matches_plain(dev, dtype, variant, b, t, h, kh, d,
                                 causal):
    """The CUDA backward against ``flash_attention_bwd_ref`` (autograd
    through the plain forward): through ``FlashAttentionFn`` where the
    variant is the one ``choose_bwd_variant`` picks, else forced through
    ``flash_attention_bwd``'s ``variant`` (the f32 tile on bf16 inputs at
    the tensor-core tile's head dims), which the routing leaves as it
    is."""
    from repro_torch.kernels.ref import flash_attention_bwd_ref

    q, k, v, do = _bwd_inputs(b, t, h, kh, d, dtype, dev, seed=t + h + d)
    n0, f0 = flash_attention.BWD_LAUNCHES.n, flash_attention.LAUNCHES.n
    v0 = flash_attention.BWD_VARIANT_LAUNCHES[variant].n
    if variant == flash_attention.choose_bwd_variant(dtype, d):
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        out = flash_attention.flash_attention(*leaves, causal=causal)
        got = torch.autograd.grad(out, leaves, do)
    else:
        out, lse = flash_attention._forward(q, k, v, causal, with_lse=True)
        got = flash_attention.flash_attention_bwd(q, k, v, out, do, lse,
                                                  causal=causal,
                                                  variant=variant)
    torch.cuda.synchronize()
    assert flash_attention.BWD_LAUNCHES.n == n0 + 1
    assert flash_attention.BWD_VARIANT_LAUNCHES[variant].n == v0 + 1
    assert flash_attention.LAUNCHES.n == f0 + 1
    want = flash_attention_bwd_ref(q, k, v, do, causal=causal)
    for g, w, x in zip(got, want, (q, k, v)):
        assert g.dtype == dtype and g.shape == x.shape
        assert torch.isfinite(g).all()
        assert _bwd_limit(g, w, dtype)


@pytest.mark.parametrize("variant,splits", [("tile", None), ("tile", 1),
                                            ("cuda_core", None)])
@pytest.mark.parametrize("b,t,h,kh,d,causal", [
    (1, 2048, 32, 32, 80, True), (1, 300, 24, 2, 128, True),
    (2, 130, 8, 2, 256, False), (4, 1500, 12, 12, 64, False)])
def test_flash_bwd_is_deterministic(dev, variant, splits, b, t, h, kh, d,
                                    causal):
    """No atomics: two calls on the same bf16 inputs give the same bits,
    on the tile with its GQA split and without it, and on the f32 tile."""
    q, k, v, do = _bwd_inputs(b, t, h, kh, d, torch.bfloat16, dev, seed=d)
    out, lse = flash_attention._forward(q, k, v, causal, with_lse=True)
    kw = dict(causal=causal, variant=variant)
    if splits is not None:
        kw["splits"] = splits
    first = flash_attention.flash_attention_bwd(q, k, v, out, do, lse, **kw)
    again = flash_attention.flash_attention_bwd(q, k, v, out, do, lse, **kw)
    for a, c in zip(first, again):
        assert torch.equal(a, c)


@pytest.mark.parametrize("splits", [None, 1])
@pytest.mark.parametrize("b,t,h,kh,d,causal", [
    (2, 64, 32, 32, 80, True),    # phase 8b's short grid: one-warp CTAs
    (1, 2048, 32, 32, 80, True),  # stablelm-3b: 64-row CTAs
    (1, 300, 24, 2, 128, True),   # G 12: the GQA split
    (2, 130, 8, 2, 256, False),   # D 256: 8-row warps
    (3, 3, 2, 2, 16, True),       # three tokens, D padded to 64
    (4, 1500, 12, 12, 64, False)])
def test_flash_bwd_f32_tile_bits(dev, splits, b, t, h, kh, d, causal):
    """The f32 tile: two calls on the same f32 inputs give the same bits,
    and 64-row and one-warp CTAs give the same bits, with the grid's GQA
    split and without it."""
    q, k, v, do = _bwd_inputs(b, t, h, kh, d, torch.float32, dev, seed=d)
    out, lse = flash_attention._forward(q, k, v, causal, with_lse=True)
    kw = dict(causal=causal, variant="cuda_core", splits=splits)
    first = flash_attention.flash_attention_bwd(q, k, v, out, do, lse, **kw)
    again = flash_attention.flash_attention_bwd(q, k, v, out, do, lse, **kw)
    wide = flash_attention.flash_attention_bwd(q, k, v, out, do, lse,
                                               wide=True, **kw)
    narrow = flash_attention.flash_attention_bwd(q, k, v, out, do, lse,
                                                 wide=False, **kw)
    for a, c, w, n in zip(first, again, wide, narrow):
        assert torch.equal(a, c) and torch.equal(w, n) and torch.equal(a, w)


def test_flash_bwd_routes_by_dtype(dev):
    """Autograd's backward takes the tile for bf16 at D 80 and the f32
    tile for f32, counted in ``BWD_VARIANT_LAUNCHES``."""
    for dtype, want in ((torch.bfloat16, "tile"),
                        (torch.float32, "cuda_core")):
        q, k, v, do = _bwd_inputs(1, 96, 4, 4, 80, dtype, dev, seed=3)
        before = {n: c.n for n, c in
                  flash_attention.BWD_VARIANT_LAUNCHES.items()}
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        out = flash_attention.flash_attention(*leaves, causal=True)
        torch.autograd.grad(out, leaves, do)
        torch.cuda.synchronize()
        after = {n: c.n for n, c in
                 flash_attention.BWD_VARIANT_LAUNCHES.items()}
        assert {n: after[n] - before[n] for n in after} == {
            n: int(n == want) for n in after}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,t,h,kh,d,causal", [
    (1, 300, 32, 32, 80, True), (2, 130, 8, 2, 256, False),
    (2, 100, 8, 2, 48, True)])
def test_flash_forward_with_lse_is_the_same(dev, dtype, b, t, h, kh, d,
                                            causal):
    """The forward writes the rows' log-sum-exp only when asked; its output
    is the same bits either way, and the log-sum-exp is the plain one."""
    q, k, v, _ = _bwd_inputs(b, t, h, kh, d, dtype, dev, seed=t)
    out, lse = flash_attention._forward(q, k, v, causal, with_lse=True)
    bare = flash_attention.flash_attention(q, k, v, causal=causal)
    assert torch.equal(out, bare)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                     k.float().repeat_interleave(h // kh, 2)) / math.sqrt(d)
    if causal:
        pos = torch.arange(t, device=dev)
        s = torch.where(pos[None, :] <= pos[:, None], s, -math.inf)
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), rtol=1e-5,
                               atol=1e-4)


def test_flash_bwd_refuses_bad_operands(dev):
    q, k, v, do = _bwd_inputs(1, 16, 4, 2, 32, torch.float32, dev, seed=1)
    out, lse = flash_attention._forward(q, k, v, True, with_lse=True)
    with pytest.raises(ValueError, match="lse"):
        flash_attention.flash_attention_bwd(q, k, v, out, do, lse.double())
    with pytest.raises(ValueError, match="dout"):
        flash_attention.flash_attention_bwd(q, k, v, out, do[:, :8], lse)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention.flash_attention_bwd(q, k, v, out, do.cpu(), lse)


@pytest.mark.parametrize("remat", [False, True])
def test_train_step_on_the_card(dev, remat):
    """A smoke-size f32 train step on the card: every master leaf gets a
    gradient (none left at zero: the kernel route keeps the graph), it
    matches the CPU's within 1e-3 of each leaf's largest, the flash
    forward and backward launch once per layer (twice forward with
    remat), and the step updates every parameter and drops the grads."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.models import attention, build_model
    from repro_torch.train import AdamWConfig, make_train_step
    from repro_torch.train.optim import adamw_init, tree_items, tree_map
    from repro_torch.train.trainer import bind_grads

    cfg = get_smoke_config("stablelm-3b").scaled(remat=remat)
    model = build_model(cfg)
    base = model.init(torch.Generator().manual_seed(0), device="cpu",
                      master=True)
    batch = {k: torch.from_numpy(v) for k, v in
             SyntheticLMData(cfg.vocab_size, 24, 2).batch_at(0).items()}
    grads = {}
    for d in ("cpu", dev):
        params = tree_map(lambda x: x.to(d, copy=True), base)
        live = bind_grads(params)
        k0, b0 = attention.FLASH_ROUTES["kernel"].n, \
            flash_attention.BWD_LAUNCHES.n
        model.loss(live, {k: v.to(d) for k, v in batch.items()}).backward()
        if d == dev:
            torch.cuda.synchronize()
            fwd = attention.FLASH_ROUTES["kernel"].n - k0
            assert fwd == cfg.n_layers * (2 if remat else 1)
            assert flash_attention.BWD_LAUNCHES.n - b0 == cfg.n_layers
        grads[str(d)] = [(path, p.grad.cpu()) for path, p in
                         tree_items(params)]
    for (path, g), (_, w) in zip(grads[str(dev)], grads["cpu"]):
        assert g.abs().max() > 0, path
        torch.testing.assert_close(g, w, rtol=1e-3,
                                   atol=1e-3 * w.abs().max().item(),
                                   msg="/".join(path))
    params = tree_map(lambda x: x.to(dev, copy=True), base)
    state = {"params": params, "opt": adamw_init(params)}
    state, m = make_train_step(model, AdamWConfig(lr=1e-2, warmup_steps=1))(
        state, batch)
    assert torch.isfinite(m["loss"]) and int(state["opt"]["step"]) == 1
    for (path, p), (_, p0) in zip(tree_items(state["params"]),
                                  tree_items(base)):
        assert p.grad is None and p.is_cuda
        assert not torch.equal(p.cpu(), p0), path


# ------------------------------------------ the trainer's compiled step
def _train_counters() -> dict:
    """The flash forward's and backward's launch counters, by route."""
    from repro_torch.models import attention

    return {"kernel": attention.FLASH_ROUTES["kernel"],
            "plain": attention.FLASH_ROUTES["plain"],
            "forward": flash_attention.LAUNCHES,
            "backward": flash_attention.BWD_LAUNCHES,
            **{f"backward {k}": c
               for k, c in flash_attention.BWD_VARIANT_LAUNCHES.items()}}


def _smoke_trainer(dev, n=1, remat=False, **kw):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.train import AdamWConfig, Trainer

    cfg = get_smoke_config("stablelm-3b").scaled(num_microbatches=n,
                                                 remat=remat)
    return Trainer(build_model(cfg), AdamWConfig(lr=1e-2, warmup_steps=2,
                                                 total_steps=50),
                   device=dev, **kw)


def _smoke_data(trainer):
    from repro_torch.data import SyntheticLMData

    return SyntheticLMData(trainer.model.cfg.vocab_size, 24, 4)


def _train_counted(dev, n, remat, eager, steps=5):
    """``steps`` Trainer steps of the smoke stablelm-3b from seed 0, compiled
    or under ``_eager_steps()``, the launch counts zeroed just before.
    Returns (trainer, state, metrics, counts)."""
    import contextlib

    from repro_torch.train.trainer import _eager_steps

    trainer = _smoke_trainer(dev, n, remat)
    state = trainer.init(torch.Generator(device=dev).manual_seed(0))
    counters = _train_counters()
    for ctr in counters.values():
        ctr.n = 0
    metrics = []
    with _eager_steps() if eager else contextlib.nullcontext():
        state = trainer.run(state, _smoke_data(trainer).stream(0),
                            steps=steps,
                            on_metrics=lambda i, m: metrics.append(m))
    torch.cuda.synchronize()
    return trainer, state, metrics, {k: c.n for k, c in counters.items()}


def _state_leaves(state):
    from repro_torch.train.optim import tree_leaves

    return [x.detach().cpu() for x in tree_leaves(state)]


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("n", [1, 2])
def test_compiled_trainer_equals_eager(dev, n, remat):
    """Five steps replayed from one CUDA graph leave the parameters, m, v
    and step, and give the metrics, of five eager steps: bitwise where two
    eager runs are bitwise, else within 1e-5; the flash forward and
    backward launch as often (each replay adds what its capture tallied,
    the backward's launches from autograd's device thread included), one
    graph per signature."""
    trainer, state, metrics, counts = _train_counted(dev, n, remat, False)
    want = _train_counted(dev, n, remat, True)
    again = _train_counted(dev, n, remat, True)
    got, ref, ref2 = (_state_leaves(x) for x in (state, want[1], again[1]))
    bitwise = (all(torch.equal(a, b) for a, b in zip(ref, ref2))
               and want[2] == again[2])
    if bitwise:
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
        assert metrics == want[2]
    else:
        for a, b in zip(got, ref):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
        for m, w in zip(metrics, want[2]):
            for k in w:
                assert m[k] == pytest.approx(w[k], rel=1e-5), k
    layers = trainer.model.cfg.n_layers
    per_step = layers * n
    assert counts == want[3]
    assert counts["forward"] == counts["kernel"] == 5 * per_step * (
        2 if remat else 1)
    assert counts["backward"] == counts["backward cuda_core"] == 5 * per_step
    assert counts["plain"] == 0
    step_fn = trainer._step_fn
    assert step_fn._cache_size() == len(step_fn._graphs) == 1
    (graph,) = step_fn._graphs.values()
    assert graph.tally.counts[flash_attention.BWD_LAUNCHES] == per_step


def test_compiled_metrics_are_copies(dev):
    """Each step's returned metrics stay as they were after the next step
    (the graph's own outputs are overwritten at each replay)."""
    trainer = _smoke_trainer(dev)
    state = trainer.init(torch.Generator(device=dev).manual_seed(0))
    it = _smoke_data(trainer).stream(0)
    out = []
    for _ in range(4):
        state, m = trainer._step_fn(state, next(it))
        out.append((m, {k: v.clone() for k, v in m.items()}))
    torch.cuda.synchronize()
    assert len(trainer._step_fn._graphs) == 1
    for m, snap in out:
        assert all(torch.equal(m[k], snap[k]) for k in snap)
    losses = [float(m["loss"]) for m, _ in out]
    assert len(set(losses)) == len(losses), losses


def test_compiled_trainer_after_restore(dev, tmp_path):
    """``Checkpointer.restore`` returns new tensors: the compiled step drops
    the graph of the old state (nothing keeps it alive) and captures anew,
    ``_cache_size()`` unchanged, and trains the restored state to what the
    eager step trains it to."""
    import gc
    import weakref

    from repro_torch.train.checkpoint import Checkpointer
    from repro_torch.train.optim import tree_leaves
    from repro_torch.train.trainer import _eager_steps

    ckpt = Checkpointer(str(tmp_path / "ck"), sync=True)
    trainer = _smoke_trainer(dev, checkpointer=ckpt, checkpoint_every=2)
    data = _smoke_data(trainer)
    state = trainer.init(torch.Generator(device=dev).manual_seed(0))
    state = trainer.run(state, data.stream(0), steps=3)
    size = trainer._step_fn._cache_size()
    # the graph's own metrics, in its pool: gone with the graph
    old = weakref.ref(next(iter(trainer._step_fn._graphs.values()))
                      .metrics["loss"])
    restored, start = ckpt.restore(state), ckpt.restore(state)
    assert int(restored["opt"]["step"]) == 2
    first = weakref.ref(tree_leaves(state)[0])
    del state
    restored = trainer.run(restored, data.stream(2), steps=3)
    gc.collect()
    assert old() is None and first() is None
    assert trainer._step_fn._cache_size() == size == 1
    assert len(trainer._step_fn._graphs) == 1
    with _eager_steps():
        want = _smoke_trainer(dev).run(start, data.stream(2), steps=3)
    for a, b in zip(_state_leaves(restored), _state_leaves(want)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    assert int(restored["opt"]["step"]) == 5


def test_failed_train_capture_raises(dev):
    """A step the capture refuses (a host sync in it) raises at its first
    dispatch, after its eager warm-up; nothing falls back, no graph is
    kept, and the card goes on working."""
    trainer = _smoke_trainer(dev)
    state = trainer.init(torch.Generator(device=dev).manual_seed(0))
    real = trainer._step_fn._step

    def syncing(state, batch):
        state, metrics = real(state, batch)
        float(metrics["loss"])  # a host sync: fine eagerly, not captured
        return state, metrics

    trainer._step_fn._step = syncing
    batch = _smoke_data(trainer).batch_at(0)
    with pytest.raises(RuntimeError):
        trainer._step_fn(state, batch)
    assert not trainer._step_fn._graphs
    torch.cuda.synchronize()
    assert int(state["opt"]["step"]) == 1
    assert torch.isfinite(torch.ones(4, device=dev).sum())


# ------------------------------------------------- point scan, mesh, merge
@pytest.mark.parametrize("r", [1, 300, 1000])
@pytest.mark.parametrize("t,h", [(4, 2), (512, 10)])
def test_can_delete_blocks_on_the_card(dev, r, t, h):
    """``kernels.can_delete_blocks`` (the point form) on CUDA tensors: the
    kernel, one launch a call, bitwise its plain version and the NumPy
    backend; ``use_kernel=False`` runs the plain version on the card."""
    from repro_torch.kernels import can_delete_blocks
    from repro_torch.kernels.ref import era_scan_ref

    rng = np.random.default_rng(r + t * h)
    alloc = rng.integers(0, 100, r).astype(np.int32)
    retire = (alloc + rng.integers(0, 50, r)).astype(np.int32)
    res = rng.integers(0, 160, (t, h)).astype(np.int32)
    res[rng.random((t, h)) < 0.5] = INF_ERA32
    a, b, c = (torch.from_numpy(x).to(dev) for x in (alloc, retire, res))
    n0 = era_scan.LAUNCHES.n
    got = can_delete_blocks(a, b, c, use_kernel=True)
    assert era_scan.LAUNCHES.n == n0 + 1 and got.is_cuda
    plain = can_delete_blocks(a, b, c)
    assert era_scan.LAUNCHES.n == n0 + 1 and plain.is_cuda
    want = _can_delete_numpy(alloc, retire, res.ravel(), res.ravel())
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    np.testing.assert_array_equal(plain.cpu().numpy(), want)
    np.testing.assert_array_equal(era_scan_ref(a, b, c).cpu().numpy(), want)


@pytest.fixture
def nccl_mesh(dev):
    """A 1x1 ("data", "model") mesh on a one-rank NCCL group."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_smoke_mesh

    mesh = make_smoke_mesh(dev)
    assert dist.get_backend() == "nccl"
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_per_shard_launches_the_kernels(nccl_mesh, dtype):
    """DTensor q, k, v on the one-rank NCCL mesh go through ``local_map``
    to the kernel route: the forward and backward kernels launch, and the
    output and gradients are the plain-tensor kernel call's bits."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.models import attention
    from repro_torch.sharding.axes import axis_rules

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    b, t, h, kh, d = 2, 256, 8, 2, 80
    arrs = [torch.randn(s, generator=gen, device=dev).to(dtype)
            for s in ((b, t, h, d), (b, t, kh, d), (b, t, kh, d))]
    gout = torch.randn((b, t, h, d), generator=gen, device=dev).to(dtype)
    pos = torch.arange(t, device=dev)[None].expand(b, t)
    plain = [x.clone().requires_grad_() for x in arrs]
    want = attention.flash_attention(*plain, pos, pos, causal=True,
                                     arange_positions=True)
    (want.float() * gout.float()).sum().backward()
    dts = [distribute_tensor(x, nccl_mesh, [Shard(0), Replicate()])
           .requires_grad_() for x in arrs]
    k0, p0 = attention.FLASH_ROUTES["kernel"].n, \
        attention.FLASH_ROUTES["plain"].n
    f0, b0 = flash_attention.LAUNCHES.n, flash_attention.BWD_LAUNCHES.n
    with axis_rules(nccl_mesh):
        out = attention.flash_attention(*dts, pos, pos, causal=True,
                                        arange_positions=True)
        (out.to_local().float() * gout.float()).sum().backward()
    torch.cuda.synchronize()
    assert attention.FLASH_ROUTES["kernel"].n == k0 + 1
    assert attention.FLASH_ROUTES["plain"].n == p0
    assert flash_attention.LAUNCHES.n == f0 + 1
    assert flash_attention.BWD_LAUNCHES.n == b0 + 1
    assert torch.equal(out.to_local(), want)
    for x, p in zip(dts, plain):
        assert torch.equal(x.grad.to_local(), p.grad)


def test_merged_era_on_the_card(nccl_mesh):
    """``merged_era`` over NCCL: a CUDA int64 in, the (one-rank) maximum
    out on the same device; a Python int in, an int out."""
    from repro_torch.core.distributed_eras import merged_era

    t = torch.tensor([41], dtype=torch.int64, device="cuda")
    got = merged_era(t)
    assert got.is_cuda and got.tolist() == [41] and t.tolist() == [41]
    assert merged_era(7) == 7


def _f32_order(k):
    """The spread of an f32 sum of k terms in another order, of the
    largest |value|: 2 sqrt(k) u, u = 2**-24."""
    return 2 * math.sqrt(k) * 2.0 ** -24


def _exact_err(got, want):
    return ((got.detach().cpu().double() - want).abs().max()
            / want.abs().max()).item()


@pytest.mark.parametrize("shape_x,shape_w", [((4, 64, 2560), (2560, 2560)),
                                             ((33, 96), (96, 40))])
def test_matmul_f32_output_on_the_card(dev, shape_x, shape_w):
    """``layers.matmul(x, w, dtype=float32)`` on bf16 activations is a bf16
    GEMM with f32 output: against the exact (f64) product of the same
    operands within f32 accumulation order (``_f32_order`` of K), as the
    f32 product of the upcast operands is (what the reference's
    ``preferred_element_type=f32`` dot computes, held to it on the CPU by
    ``test_torch_matmul_precision.py``), at recurrentgemma-2b's gate width
    too; a product rounded to bf16 is far outside it.  Its gradients run
    (the GEMM has no autograd of its own) within one bf16 step of the
    CPU's largest magnitude."""
    from repro_torch.models import layers

    gen = torch.Generator().manual_seed(0)
    x = torch.randn(*shape_x, generator=gen).to(torch.bfloat16)
    w = torch.randn(*shape_w, generator=gen) * 0.02
    g = torch.randn(*shape_x[:-1], shape_w[1], generator=gen)
    xd, wd = x.to(dev).requires_grad_(), w.to(dev).requires_grad_()
    got = layers.matmul(xd, wd, dtype=torch.float32)
    assert got.dtype == torch.float32
    exact = x.double() @ w.to(torch.bfloat16).double()
    limit = _f32_order(shape_w[0])
    assert _exact_err(got, exact) <= limit
    assert _exact_err(torch.matmul(x, w.to(torch.bfloat16)), exact) > \
        10 * limit
    got.backward(g.to(dev))
    xc, wc = x.clone().requires_grad_(), w.clone().requires_grad_()
    layers.matmul(xc, wc, dtype=torch.float32).backward(g)
    for a, b in ((xd.grad, xc.grad), (wd.grad, wc.grad)):
        assert a.dtype == b.dtype
        assert (a.cpu().float() - b.float()).abs().max() <= \
            2 ** -7 * b.float().abs().max()


def test_moe_expert_product_on_the_card(dev):
    """The MoE expert product's batched f32 product (``layers.product``,
    a bf16 ``torch.bmm`` with f32 output) within f32 accumulation order of
    the exact product, with gradients."""
    from repro_torch.models import layers

    gen = torch.Generator().manual_seed(1)
    a = torch.randn(4, 96, 256, generator=gen).to(torch.bfloat16)
    b = (torch.randn(4, 256, 512, generator=gen) * 0.05).to(torch.bfloat16)
    ad, bd = a.to(dev).requires_grad_(), b.to(dev).requires_grad_()
    got = layers.product(ad, bd, batched=True)
    assert got.dtype == torch.float32
    assert _exact_err(got, a.double() @ b.double()) <= _f32_order(256)
    got.sum().backward()
    assert ad.grad.dtype == bd.grad.dtype == torch.bfloat16
    assert torch.isfinite(ad.grad).all() and torch.isfinite(bd.grad).all()


def test_a_span_holds_its_kernel_on_the_profile_clock(dev):
    """The program's spans and the device trace share one clock: a span
    around a kernel launch and a ``synchronize``, under a CUDA profile,
    contains that kernel's device interval mapped through
    ``trace_start_ns`` within 50 us."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import obs

    a = torch.randn(2048, 2048, device=dev)
    torch.mm(a, a)
    torch.cuda.synchronize()
    obs.clear()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            with obs.span("launch"):
                torch.mm(a, a)
                torch.cuda.synchronize()
    start = prof.profiler.kineto_results.trace_start_ns()
    held = [((s.t0_ns - start) / 1e3, (s.t1_ns - start) / 1e3)
            for s in obs.records("launch")]
    obs.clear()
    kernels = [e.time_range for e in prof.events()
               if e.device_type.name == "CUDA"]
    assert len(held) == 3 and len(kernels) >= 3
    for k in kernels:
        assert any(a - 50 <= k.start and k.end <= b + 50 for a, b in held), \
            (k.start, k.end, held)
