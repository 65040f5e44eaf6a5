"""The paged and flash attention kernels' variants, on the CPU.

The CUDA kernels cannot run here, so this file pins what surrounds them
and the algebra they compute:

- the variant choosers of ``kernels.paged_attention`` and
  ``kernels.flash_attention`` (which kernel each shape takes);
- the split plan of the split-KV decode walk (its boundaries depend on the
  table width, bs and D, never on ``num_live_blocks``);
- the plain models in ``kernels.ref`` of the split-KV walk with its
  combine, and of the tensor-core tile's int8 scale folding, held against
  ``repro.kernels.paged_attention.paged_attention_chunk`` in interpret
  mode on the same NumPy-seeded inputs.

Tolerances: the f32 split walk 1e-5 (the reference sums in another order);
the tile model 2e-2, since it rounds P to bf16 for the P V product where
the TPU kernel keeps P in f32 (a bf16 rounding is 2^-8 relative).  Empty
splits, the bounded against the unbounded walk and the fused int8 split
against materialized pages are held bitwise.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import \
    paged_attention_chunk as pallas_chunk
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels.quant import dequantize_pool
from repro_torch.kernels.ref import (SPLIT_EMPTY_M, combine_splits_ref,
                                     paged_attention_split_ref,
                                     paged_attention_tile_ref,
                                     split_kv_partials_ref)

BF16, F32, F16, I8 = torch.bfloat16, torch.float32, torch.float16, torch.int8


# ======================================================= variant choosers
@pytest.mark.parametrize("q_dtype,kv_dtype,c,g,d,bs,want", [
    (BF16, BF16, 1, 1, 80, 16, "split"),      # stablelm-3b decode
    (BF16, I8, 1, 1, 80, 16, "split"),        # int8 pages, decode
    (F32, F32, 1, 1, 80, 16, "split"),        # every q type decodes split
    (F32, I8, 1, 1, 80, 16, "split"),
    (BF16, F16, 1, 1, 80, 16, "split"),
    (BF16, BF16, 15, 1, 80, 16, "split"),     # C*G = 15: still split
    (BF16, BF16, 16, 1, 80, 16, "tile"),      # C*G = 16: the tile
    (BF16, BF16, 256, 1, 80, 16, "tile"),     # mixed / prefill chunk
    (BF16, I8, 256, 1, 80, 16, "tile"),
    (BF16, BF16, 1, 12, 128, 16, "split"),    # G = 12 decode: 12 rows
    (BF16, BF16, 2, 12, 128, 16, "tile"),     # 24 rows
    (BF16, BF16, 3, 4, 64, 8, "split"),       # 12 rows
    (BF16, BF16, 4, 4, 64, 8, "tile"),        # 16 rows
    (F32, F32, 256, 1, 80, 16, "cuda_core"),  # f32 q chunk: the exact path
    (F32, I8, 40, 1, 80, 16, "cuda_core"),
    (BF16, F16, 256, 1, 80, 16, "cuda_core"),  # fp16 pages under bf16 q
    (BF16, F32, 64, 1, 80, 16, "cuda_core"),
    (BF16, BF16, 256, 1, 96, 16, "cuda_core"),  # no tile built at D 96
    (BF16, BF16, 1, 1, 72, 16, "cuda_core"),  # rows not whole 16-byte chunks
    (BF16, BF16, 1, 1, 80, 256, "cuda_core"),  # a page wider than a split
    (BF16, BF16, 1, 1, 256, 16, "split"),     # gemma-7b decode
    (BF16, I8, 1, 1, 256, 16, "split"),
    (F32, F32, 1, 1, 256, 16, "split"),       # 64-key splits
    (F32, F32, 1, 1, 256, 128, "cuda_core"),  # a page wider than those
    (BF16, BF16, 1, 1, 256, 128, "cuda_core"),  # in every pool type
    (BF16, I8, 1, 1, 256, 64, "split"),
    (BF16, BF16, 256, 1, 256, 16, "tile"),    # gemma-7b mixed chunk
    (BF16, I8, 256, 1, 256, 16, "tile"),
    (F32, F32, 256, 1, 256, 16, "cuda_core"),
    (BF16, F16, 256, 1, 256, 16, "cuda_core"),
    (BF16, BF16, 1, 12, 128, 16, "split"),    # starcoder2-3b decode
    (BF16, BF16, 1, 9, 128, 16, "split"),     # starcoder2-7b decode
    (BF16, BF16, 256, 9, 128, 16, "tile"),
])
def test_paged_variant_chooser(q_dtype, kv_dtype, c, g, d, bs, want):
    assert pa.choose_variant(q_dtype, kv_dtype, c * g, d, bs) == want


@pytest.mark.parametrize("dtype,d,want", [
    (BF16, 80, "tile"), (BF16, 128, "tile"), (BF16, 64, "tile"),
    (F32, 80, "cuda_core"), (BF16, 96, "cuda_core"), (BF16, 32, "cuda_core"),
    (BF16, 256, "tile"), (F32, 256, "cuda_core"), (BF16, 192, "cuda_core"),
])
def test_flash_variant_chooser(dtype, d, want):
    assert fa.choose_variant(dtype, d) == want


@pytest.mark.parametrize("nblk,bs,want", [
    (128, 16, (8, 16)),   # the engine's table bucket at block size 16
    (16, 16, (8, 2)),
    (1, 16, (8, 1)),
    (5, 8, (16, 1)),
    (40, 8, (16, 3)),
    (70, 4, (32, 3)),
    (7, 128, (1, 7)),
])
def test_split_plan(nblk, bs, want):
    pps, nsplit = pa.split_plan(nblk, bs, 128)
    assert (pps, nsplit) == want
    assert pps * bs <= pa.SPLIT_KEYS
    assert (nsplit - 1) * pps < nblk <= nsplit * pps


@pytest.mark.parametrize("d,want", [(64, 128), (80, 128), (128, 128),
                                    (256, 64)])
def test_split_keys(d, want):
    """128 keys a split wherever f32 K and V fit in shared memory beside
    the split's f32 rows, 64 at D 256; every pool type fits the cut."""
    keys = pa.split_keys(d)
    assert keys == want
    for dtype in (F32, BF16, F16, I8):
        assert pa._split_smem(keys, d, dtype.itemsize) <= pa.MAX_SMEM_BYTES
    if keys < pa.SPLIT_KEYS:
        assert pa._split_smem(2 * keys, d, 4) > pa.MAX_SMEM_BYTES


@pytest.mark.parametrize("nblk,bs,d,want", [
    (128, 16, 256, (4, 32)),   # gemma-7b, the engine's bucket
    (128, 16, 128, (8, 16)),
    (5, 64, 256, (1, 5)),
    (9, 8, 256, (8, 2)),
])
def test_split_plan_keys(nblk, bs, d, want):
    """The plan cuts at ``split_keys(d)`` keys: 64 at D 256."""
    pps, nsplit = pa.split_plan(nblk, bs, d)
    assert (pps, nsplit) == want
    assert pps * bs <= pa.split_keys(d)
    assert (nsplit - 1) * pps < nblk <= nsplit * pps


def test_cuda_core_limit_raises():
    """The f32 tile's one limit is D <= 256: it gathers keys one by one
    into its K/V tiles, so a page of any size is taken."""
    with pytest.raises(ValueError, match="head_dim"):
        pa._check_limits(272)
    for d, bs in ((128, 256), (80, 16), (256, 16), (256, 128), (72, 512)):
        assert pa.choose_variant(F32, F32, 256, d, bs) == "cuda_core"
        pa._check_limits(d)


# ============================================== shared seeded inputs
def _case(b, c, kh, g, d, bs, nblk, seed, int8=False):
    """Seeded NumPy operands: q, pools (f32 or int8 codes with (N, KH)
    scales), a permuted table, ragged contexts that end mid-page, and the
    exact live bound."""
    rng = np.random.default_rng(seed)
    n = b * nblk + 2
    q = rng.standard_normal((b, c, kh, g, d)).astype(np.float32)
    if int8:
        k = rng.integers(-127, 128, (n, bs, kh, d)).astype(np.int8)
        v = rng.integers(-127, 128, (n, bs, kh, d)).astype(np.int8)
        ksc = rng.uniform(0.005, 0.05, (n, kh)).astype(np.float32)
        vsc = rng.uniform(0.005, 0.05, (n, kh)).astype(np.float32)
    else:
        k = rng.standard_normal((n, bs, kh, d)).astype(np.float32)
        v = rng.standard_normal((n, bs, kh, d)).astype(np.float32)
        ksc = vsc = None
    tables = rng.permutation(n)[: b * nblk].reshape(b, nblk).astype(np.int32)
    ctx = rng.integers(0, nblk * bs - c + 1, (b, 1))
    qpos = (ctx + np.arange(c)[None, :]).astype(np.int32)
    live = (qpos.max(axis=1) // bs + 1).astype(np.int32)
    return dict(q=q, k=k, v=v, ksc=ksc, vsc=vsc, tables=tables, qpos=qpos,
                live=live)


def _torch(case):
    return {k: None if a is None else torch.from_numpy(a)
            for k, a in case.items()}


def _pallas(case, q=None):
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    return np.asarray(pallas_chunk(
        j(case["q"] if q is None else q), j(case["k"]), j(case["v"]),
        j(case["tables"]), j(case["qpos"]), j(case["live"]), j(case["ksc"]),
        j(case["vsc"]), interpret=True))


def _plan(t):
    """The kernel's split plan for these operands."""
    return pa.split_plan(t["tables"].shape[1], t["k"].shape[1],
                         t["q"].shape[-1])


def _split(t, live="live", **kw):
    pps, nsplit = _plan(t)
    return paged_attention_split_ref(
        t["q"], t["k"], t["v"], t["tables"], t["qpos"],
        None if live is None else t[live], pages_per_split=pps,
        n_splits=nsplit, k_scales=t["ksc"], v_scales=t["vsc"], **kw)


# (B, C, KH, G, D, bs, nblk): every one takes the split variant
SPLIT_SHAPES = [
    (2, 1, 4, 1, 80, 16, 20),    # stablelm-3b head dim, decode, 3 splits
    (3, 2, 2, 4, 64, 8, 40),     # GQA, C = 2: 8 rows, 3 splits
    (2, 1, 2, 12, 128, 4, 70),   # G = 12 (starcoder2-3b), 3 splits
    (2, 15, 2, 1, 64, 8, 36),    # C = 15, contexts end mid-page
    (2, 1, 4, 1, 256, 16, 20),   # gemma-7b head dim: 64-key splits
    (2, 3, 2, 4, 256, 8, 24),    # D 256, GQA, 12 rows
]


# ====================================================== split-KV walk
@pytest.mark.parametrize("shape", SPLIT_SHAPES)
def test_split_walk_matches_reference(shape):
    b, c, kh, g, d, bs, nblk = shape
    assert pa.choose_variant(F32, F32, c * g, d, bs) == "split"
    case = _case(*shape, seed=sum(shape))
    got = _split(_torch(case)).numpy()
    np.testing.assert_allclose(got, _pallas(case), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", SPLIT_SHAPES[:2] + SPLIT_SHAPES[4:])
def test_split_walk_int8_matches_reference(shape):
    case = _case(*shape, seed=sum(shape) + 1, int8=True)
    got = _split(_torch(case)).numpy()
    np.testing.assert_allclose(got, _pallas(case), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", SPLIT_SHAPES)
def test_empty_splits_are_bitwise_noops(shape):
    """A split past the bound is (-1e30, 0, 0), and folding more such
    splits into the combine changes no bit."""
    case = _case(*shape, seed=sum(shape) + 2)
    t = _torch(case)
    pps, nsplit = _plan(t)
    m, l, acc = split_kv_partials_ref(
        t["q"], t["k"], t["v"], t["tables"], t["qpos"], t["live"],
        pages_per_split=pps, n_splits=nsplit)
    first_empty = -(-t["live"].long() // pps)           # (B,)
    for bi in range(m.shape[0]):
        s0 = int(first_empty[bi])
        assert torch.all(m[bi, :, :, s0:] == SPLIT_EMPTY_M)
        assert not l[bi, :, :, s0:].any() and not acc[bi, :, :, s0:].any()
    pad = 3
    m2 = torch.cat([m, torch.full(m.shape[:-1] + (pad,), SPLIT_EMPTY_M)], -1)
    l2 = torch.cat([l, torch.zeros(l.shape[:-1] + (pad,))], -1)
    acc2 = torch.cat([acc, torch.zeros(acc.shape[:-2] + (pad, acc.shape[-1]))],
                     -2)
    assert torch.equal(combine_splits_ref(m, l, acc),
                       combine_splits_ref(m2, l2, acc2))


@pytest.mark.parametrize("shape", SPLIT_SHAPES)
def test_split_walk_bounded_equals_unbounded(shape):
    b, c, kh, g, d, bs, nblk = shape
    case = _case(*shape, seed=sum(shape) + 3)
    t = _torch(case)
    t["full"] = torch.full_like(t["live"], nblk)
    bounded = _split(t)
    assert torch.equal(bounded, _split(t, live="full"))
    assert torch.equal(bounded, _split(t, live=None))


def test_split_boundaries_ignore_num_live():
    """The same inputs with two live bounds: the plan is one, and every
    split below the smaller bound has the same partials, bit for bit."""
    case = _case(2, 1, 2, 4, 64, 8, 40, seed=11)
    t = _torch(case)
    pps, nsplit = pa.split_plan(40, 8, 64)
    t["qpos"] = torch.tensor([[300], [250]], dtype=torch.int32)
    a = split_kv_partials_ref(t["q"], t["k"], t["v"], t["tables"], t["qpos"],
                              torch.tensor([38, 32], dtype=torch.int32),
                              pages_per_split=pps, n_splits=nsplit)
    bnd = split_kv_partials_ref(t["q"], t["k"], t["v"], t["tables"],
                                t["qpos"],
                                torch.tensor([20, 20], dtype=torch.int32),
                                pages_per_split=pps, n_splits=nsplit)
    whole = 20 // pps  # splits wholly below both bounds
    for x, y in zip(a, bnd):
        assert torch.equal(x[..., :whole], y[..., :whole]) if x.ndim == 4 \
            else torch.equal(x[..., :whole, :], y[..., :whole, :])


def test_split_never_reads_dead_pages():
    case = _case(3, 1, 2, 4, 64, 8, 40, seed=13)
    t = _torch(case)
    want = _split(t)
    dead = torch.arange(40)[None, :] >= t["live"][:, None].long()
    t["k"][t["tables"][dead].long()] = math.nan
    t["v"][t["tables"][dead].long()] = math.nan
    got = _split(t)
    assert torch.equal(got, want) and torch.isfinite(got).all()


def test_split_int8_fused_equals_materialized():
    """Dequantizing as the split reads (code * scale) is the same f32 value
    as ``dequantize_pool``: the walks agree bitwise, as the kernel's do."""
    case = _case(2, 1, 2, 4, 64, 8, 40, seed=17, int8=True)
    t = _torch(case)
    mat = dict(t, k=dequantize_pool(t["k"], t["ksc"]),
               v=dequantize_pool(t["v"], t["vsc"]), ksc=None, vsc=None)
    assert torch.equal(_split(t), _split(mat))


def test_decode_selector_on_cpu_matches_split_model():
    """The decode selector's plain version and the split-KV model compute
    one function (f32, 1e-5)."""
    case = _case(3, 1, 4, 2, 80, 16, 20, seed=19)
    t = _torch(case)
    lengths = t["qpos"][:, 0] + 1
    got = ops.paged_decode_attention(t["q"][:, 0], t["k"], t["v"],
                                     t["tables"], lengths, t["live"])
    torch.testing.assert_close(got, _split(t)[:, 0], rtol=1e-5, atol=1e-5)


# ========================================== tensor-core tile's algebra
TILE_SHAPES = [
    (2, 20, 4, 1, 80, 16, 6),    # stablelm-3b head dim, chunk mid-page
    (2, 8, 2, 4, 64, 8, 9),      # GQA: 32 rows
    (1, 17, 2, 2, 128, 16, 4),   # head dim 128
    (2, 20, 2, 1, 256, 16, 6),   # head dim 256 (gemma-7b), 32-key tiles
]


@pytest.mark.parametrize("shape", TILE_SHAPES)
def test_tile_int8_folding_matches_reference(shape):
    """Codes into the product exactly, the k scale on S's columns, the v
    scale on P's columns before P is rounded to bf16: within 2e-2 of the
    int8 reference."""
    b, c, kh, g, d, bs, nblk = shape
    assert pa.choose_variant(BF16, I8, c * g, d, bs) == "tile"
    case = _case(*shape, seed=sum(shape) + 5, int8=True)
    q = case["q"].astype(jnp.bfloat16).astype(np.float32)
    case["q"] = q
    t = _torch(case)
    got = paged_attention_tile_ref(
        t["q"].to(BF16), t["k"], t["v"], t["tables"], t["qpos"], t["live"],
        k_scales=t["ksc"], v_scales=t["vsc"]).float().numpy()
    np.testing.assert_allclose(got, _pallas(case), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("shape", TILE_SHAPES)
def test_tile_bf16_pages_match_reference(shape):
    case = _case(*shape, seed=sum(shape) + 7)
    for key in ("q", "k", "v"):  # the tile's operands are bf16
        case[key] = case[key].astype(jnp.bfloat16).astype(np.float32)
    t = _torch(case)
    got = paged_attention_tile_ref(
        t["q"].to(BF16), t["k"].to(BF16), t["v"].to(BF16), t["tables"],
        t["qpos"], t["live"]).float().numpy()
    np.testing.assert_allclose(got, _pallas(case), rtol=2e-2, atol=2e-2)


def test_tile_model_bounded_equals_unbounded_and_skips_dead_pages():
    case = _case(2, 20, 2, 1, 80, 16, 6, seed=23, int8=True)
    t = _torch(case)
    args = lambda tt, live: (  # noqa: E731
        tt["q"].to(BF16), tt["k"], tt["v"], tt["tables"], tt["qpos"], live)
    kw = dict(k_scales=t["ksc"], v_scales=t["vsc"])
    want = paged_attention_tile_ref(*args(t, t["live"]), **kw)
    full = torch.full_like(t["live"], 6)
    assert torch.equal(want, paged_attention_tile_ref(*args(t, full), **kw))
    dead = torch.arange(6)[None, :] >= t["live"][:, None].long()
    ksc, vsc = t["ksc"].clone(), t["vsc"].clone()
    ksc[t["tables"][dead].long()] = math.nan
    vsc[t["tables"][dead].long()] = math.nan
    got = paged_attention_tile_ref(*args(t, t["live"]), k_scales=ksc,
                                   v_scales=vsc)
    assert torch.equal(got, want) and torch.isfinite(got).all()


def test_tile_model_d256_bounded_equals_unbounded_and_skips_dead_pages():
    """At D 256, bf16 and int8 pages: the bounded and the unbounded walk
    agree bitwise, and NaN in the pages and scales of dead slots reaches
    nothing."""
    for int8 in (False, True):
        case = _case(2, 20, 2, 1, 256, 16, 6, seed=29, int8=int8)
        t = _torch(case)
        if not int8:
            t["k"], t["v"] = t["k"].to(BF16), t["v"].to(BF16)
        args = lambda tt, live: (  # noqa: E731
            tt["q"].to(BF16), tt["k"], tt["v"], tt["tables"], tt["qpos"],
            live)
        kw = dict(k_scales=t["ksc"], v_scales=t["vsc"])
        want = paged_attention_tile_ref(*args(t, t["live"]), **kw)
        full = torch.full_like(t["live"], 6)
        assert torch.equal(want,
                           paged_attention_tile_ref(*args(t, full), **kw))
        assert torch.equal(want, paged_attention_tile_ref(*args(t, None),
                                                          **kw))
        dead = torch.arange(6)[None, :] >= t["live"][:, None].long()
        ids = t["tables"][dead].long()
        k, v = t["k"].clone(), t["v"].clone()
        if int8:
            kw = dict(k_scales=t["ksc"].clone(), v_scales=t["vsc"].clone())
            kw["k_scales"][ids] = math.nan
            kw["v_scales"][ids] = math.nan
        else:
            k[ids] = math.nan
            v[ids] = math.nan
        got = paged_attention_tile_ref(*args(dict(t, k=k, v=v), t["live"]),
                                       **kw)
        assert torch.equal(got, want) and torch.isfinite(got).all()


def test_split_int8_fused_equals_materialized_at_d256():
    """At D 256 too: the int8 walk cuts the same splits as the f32 walk
    over the dequantized pools, and agrees with it bitwise."""
    case = _case(2, 1, 4, 1, 256, 16, 20, seed=31, int8=True)
    t = _torch(case)
    mat = dict(t, k=dequantize_pool(t["k"], t["ksc"]),
               v=dequantize_pool(t["v"], t["vsc"]), ksc=None, vsc=None)
    assert _plan(t) == _plan(mat)
    assert torch.equal(_split(t), _split(mat))
