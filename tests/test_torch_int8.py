"""Int8 KV pages of the port held against ``repro`` on the CPU.

The quantization helpers of ``repro_torch.kernels.quant`` against
``repro.kernels.quant`` (bitwise, codes and scales); the int8 plain
attention against the Pallas kernel in interpret mode (2e-5, as
test_kernels.py:402 holds it against its oracle); ``init_pools`` and the
paged steps in int8 and fp16 against ``repro.serve.paged_model`` (logits
2e-3, as test_torch_serve holds the fp steps); and the int8 engine against
the reference's on the ``_run_engine`` trace of test_kv_int8.py (greedy
tokens identical).

Inputs come from a NumPy seed and feed both packages.  fp32 matmuls stay
at full precision: ``allow_tf32`` is off (it only matters on the card,
where these tests do not run).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.kernels import quant as ref_quant
from repro.kernels.paged_attention import \
    paged_attention_chunk as pallas_chunk
from repro.models import build_model
from repro.serve import ServeEngine as RefEngine
from repro.serve import paged_model as ref_paged
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops, quant
from repro_torch.kernels.ref import (paged_attention_chunk_int8_ref,
                                     paged_attention_chunk_ref,
                                     paged_attention_int8_ref,
                                     paged_attention_ref)
from repro_torch.models.params import from_jax_params
from repro_torch.serve import (ServeEngine, init_pools, paged_decode_step,
                               paged_prefill_chunk)

torch.backends.cuda.matmul.allow_tf32 = False

TOL = 2e-5
DROP = 2**30  # the reference's drop sentinel (paged_model._DROP_BLOCK)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# ==================================================== quant helpers
def _codes(rng, shape):
    return rng.integers(-127, 128, shape).astype(np.int8)


def test_dequantize_and_quantize_rows_bitwise():
    rng = np.random.default_rng(0)
    pool = _codes(rng, (6, 4, 3, 16))
    scales = rng.uniform(0.005, 0.05, (6, 3)).astype(np.float32)
    scales[2] = 0.0  # a never-written block
    np.testing.assert_array_equal(
        quant.dequantize_pool(*_t(pool, scales)).numpy(),
        np.asarray(ref_quant.dequantize_pool(jnp.asarray(pool),
                                             jnp.asarray(scales))))
    x = (rng.standard_normal((6, 4, 3, 16)) * 2).astype(np.float32)
    x[2] = 0.0
    row_scales = (np.abs(x).max(-1) / 127.0).astype(np.float32)
    got = quant.quantize_rows(*_t(x, row_scales))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ref_quant.quantize_rows(
            jnp.asarray(x), jnp.asarray(row_scales))))


def test_requantize_blocks_bitwise():
    """Grown, unchanged and zero scales re-code as the reference does."""
    rng = np.random.default_rng(1)
    blocks = _codes(rng, (5, 4, 2, 16))
    old = rng.uniform(0.005, 0.05, (5, 2)).astype(np.float32)
    new = (old * rng.uniform(1.0, 3.0, (5, 2))).astype(np.float32)
    new[1] = old[1]          # unchanged: the identity
    old[3] = new[3] = 0.0    # never written
    old[4, 0] = 0.0          # first write into an empty block
    got = quant.requantize_blocks(*_t(blocks, old, new)).numpy()
    want = np.asarray(ref_quant.requantize_blocks(
        jnp.asarray(blocks), jnp.asarray(old), jnp.asarray(new)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[1], blocks[1])


@pytest.mark.parametrize("seed", range(4))
def test_scatter_quantized_bitwise(seed):
    """One scatter of a (B, C) chunk: duplicate destination blocks, padded
    rows (the reference's drop sentinel; left out of the port's call),
    scales that grow and scales that start at zero.  Codes and scales
    equal the reference's bit for bit, and the port writes in place."""
    rng = np.random.default_rng(seed)
    n, bs, kh, d, b, c = 6, 4, 3, 16, 3, 5
    pool = _codes(rng, (n, bs, kh, d))
    scales = rng.uniform(0.005, 0.05, (n, kh)).astype(np.float32)
    pool[0], scales[0] = 0, 0.0  # a fresh block: zero scale, zero codes
    toks = (rng.standard_normal((b, c, kh, d))
            * rng.uniform(0.2, 8.0, (b, c, kh, 1))).astype(np.float32)
    # each row fills consecutive offsets of a few blocks: several rows land
    # in one block, and the padded tail of each row writes nothing
    start = rng.integers(0, n * bs - c, b)
    pos = start[:, None] + np.arange(c)[None, :]
    blk, off = (pos // bs).astype(np.int32), (pos % bs).astype(np.int32)
    chunk_lens = np.array([c, 2, 1])[rng.permutation(b)]
    valid = np.arange(c)[None, :] < chunk_lens[:, None]
    # rows of different requests never share a (block, offset): where two
    # random rows overlap, the later one is padded out as well
    seen, keep = set(), np.zeros_like(valid)
    for i, j in zip(*np.nonzero(valid)):
        if (blk[i, j], off[i, j]) not in seen:
            seen.add((blk[i, j], off[i, j]))
            keep[i, j] = True
    ref_pool, ref_scales = ref_quant.scatter_quantized(
        jnp.asarray(pool), jnp.asarray(scales),
        jnp.asarray(np.where(keep, blk, DROP).astype(np.int32)),
        jnp.asarray(off), jnp.asarray(toks), jnp.int32(DROP))
    tp, ts = _t(pool.copy(), scales.copy())
    vb, vc = np.nonzero(keep)
    quant.scatter_quantized(tp, ts, torch.from_numpy(blk[vb, vc]).long(),
                            torch.from_numpy(off[vb, vc]).long(),
                            torch.from_numpy(toks[vb, vc]))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(ref_scales))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(ref_pool))
    assert (ts.numpy() >= scales).all()      # the running max only grows
    assert (ts.numpy() > scales).any()       # and this input grows one


def test_scatter_quantized_explicit_dest_matches_unique():
    """Passing the destinations with duplicates (the decode step's
    ``dest=blk``) writes the same bytes as the unique set."""
    rng = np.random.default_rng(9)
    pool = _codes(rng, (4, 4, 2, 8))
    scales = rng.uniform(0.005, 0.05, (4, 2)).astype(np.float32)
    blk = torch.tensor([3, 3, 1, 3])
    off = torch.tensor([0, 0, 2, 0])
    row = (rng.standard_normal((1, 2, 8)) * 5).astype(np.float32)
    toks = torch.from_numpy(np.concatenate([row, row, row * 0.5, row]))
    a, sa = _t(pool.copy(), scales.copy())
    b, sb = _t(pool.copy(), scales.copy())
    quant.scatter_quantized(a, sa, blk, off, toks)
    quant.scatter_quantized(b, sb, blk, off, toks, dest=blk)
    assert torch.equal(a, b) and torch.equal(sa, sb)


# ============================================== int8 plain attention
def _int8_case(b, c, kh, g, d, bs, nblk, seed):
    rng = np.random.default_rng(seed)
    n = b * nblk + 2
    q = rng.standard_normal((b, c, kh, g, d)).astype(np.float32)
    kq, vq = _codes(rng, (n, bs, kh, d)), _codes(rng, (n, bs, kh, d))
    ksc = rng.uniform(0.005, 0.05, (n, kh)).astype(np.float32)
    vsc = rng.uniform(0.005, 0.05, (n, kh)).astype(np.float32)
    tables = rng.permutation(n)[: b * nblk].reshape(b, nblk).astype(np.int32)
    ctx = rng.integers(0, nblk * bs - c + 1, (b, 1))
    qpos = (ctx + np.arange(c)[None, :]).astype(np.int32)
    live = (qpos.max(axis=1) // bs + 1).astype(np.int32)
    return q, kq, vq, ksc, vsc, tables, qpos, live


def _pallas_q8(q, kq, vq, ksc, vsc, tables, qpos, live):
    return np.asarray(pallas_chunk(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq), jnp.asarray(tables),
        jnp.asarray(qpos), jnp.asarray(live), jnp.asarray(ksc),
        jnp.asarray(vsc), interpret=True))


INT8_SHAPES = [
    # b, c, kh, g, d, bs, nblk (test_kernels.py:367-370)
    (3, 4, 2, 2, 64, 8, 5),     # ragged contexts mid-prompt
    (2, 1, 1, 4, 64, 16, 4),    # C == 1 (decode-as-chunk)
    (1, 8, 2, 1, 128, 4, 7),    # chunk wider than a block
]


@pytest.mark.parametrize("b,c,kh,g,d,bs,nblk", INT8_SHAPES)
def test_int8_plain_matches_pallas(b, c, kh, g, d, bs, nblk):
    case = _int8_case(b, c, kh, g, d, bs, nblk, seed=b * 31 + c + nblk)
    q, kq, vq, ksc, vsc, tables, qpos, live = case
    got = paged_attention_chunk_int8_ref(*_t(*case)).numpy()
    np.testing.assert_allclose(got, _pallas_q8(*case), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("b,c,kh,g,d,bs,nblk", INT8_SHAPES)
def test_int8_fused_equals_materialized_bitwise(b, c, kh, g, d, bs, nblk):
    """The plain version dequantizes only the pages it gathers; that equals
    the fp plain version on ``dequantize_pool`` pools bit for bit (the
    property test_kernels.py:372 holds for the Pallas kernel)."""
    q, kq, vq, ksc, vsc, tables, qpos, live = _t(*_int8_case(
        b, c, kh, g, d, bs, nblk, seed=b * 31 + c + nblk))
    fused = paged_attention_chunk_int8_ref(q, kq, vq, ksc, vsc, tables,
                                           qpos, live)
    mat = paged_attention_chunk_ref(q, quant.dequantize_pool(kq, ksc),
                                    quant.dequantize_pool(vq, vsc), tables,
                                    qpos, live)
    assert torch.equal(fused, mat)
    # the selector takes the same path on CPU tensors
    assert torch.equal(ops.paged_chunk_attention(q, kq, vq, tables, qpos,
                                                 live, ksc, vsc), fused)


def test_int8_num_live_blocks_spans_one_to_nblk():
    """Every bound depth 1..nblk, including bounds below the causal range
    (as test_kernels.py:405)."""
    b, c, kh, g, d, bs, nblk = 2, 3, 2, 2, 64, 4, 6
    q, kq, vq, ksc, vsc, tables, _, _ = _int8_case(b, c, kh, g, d, bs, nblk,
                                                   seed=13)
    qpos = np.repeat((nblk * bs - c + np.arange(c, dtype=np.int32))[None, :],
                     b, axis=0)
    for live in range(1, nblk + 1):
        nl = np.full((b,), live, np.int32)
        case = (q, kq, vq, ksc, vsc, tables, qpos, nl)
        got = paged_attention_chunk_int8_ref(*_t(*case)).numpy()
        np.testing.assert_allclose(got, _pallas_q8(*case), rtol=TOL,
                                   atol=TOL, err_msg=f"{live=}")


def test_int8_dead_slot_scales_never_read():
    """NaN scales (and codes) past a request's bound change nothing (as
    test_kernels.py:428)."""
    b, c, kh, g, d, bs, nblk = 1, 2, 2, 2, 64, 4, 5
    q, kq, vq, ksc, vsc, _, _, _ = _int8_case(b, c, kh, g, d, bs, nblk,
                                              seed=31)
    tables = np.arange(nblk, dtype=np.int32)[None, :]
    live = 2
    qpos = (live * bs - c + np.arange(c, dtype=np.int32))[None, :]
    nl = np.full((b,), live, np.int32)
    out1 = paged_attention_chunk_int8_ref(*_t(q, kq, vq, ksc, vsc, tables,
                                              qpos, nl))
    ksc2, vsc2 = ksc.copy(), vsc.copy()
    ksc2[live:] = np.nan
    vsc2[live:] = np.nan
    out2 = paged_attention_chunk_int8_ref(*_t(q, kq, vq, ksc2, vsc2, tables,
                                              qpos, nl))
    assert torch.equal(out1, out2)
    assert torch.isfinite(out2).all()
    # the decode form too
    lengths = torch.tensor([live * bs], dtype=torch.int32)
    args = _t(q[:, 0], kq, vq)
    d1 = paged_attention_int8_ref(*args, *_t(ksc, vsc, tables), lengths)
    d2 = paged_attention_int8_ref(*args, *_t(ksc2, vsc2, tables), lengths)
    assert torch.equal(d1, d2)


def test_int8_scale_errors_carry_reference_messages():
    """(As test_kernels.py:455.)  Also: scales beside a float pool are
    refused, since the kernel has no such variant."""
    q, kq, vq, ksc, vsc, tables, qpos, _ = _t(*_int8_case(
        1, 1, 1, 1, 64, 4, 2, seed=7))
    with pytest.raises(ValueError, match="int8 pools need"):
        ops.paged_chunk_attention(q, kq, vq, tables, qpos)
    with pytest.raises(ValueError, match="given together"):
        ops.paged_chunk_attention(q, kq, vq, tables, qpos, None, ksc, None)
    with pytest.raises(ValueError, match="int8 pools need"):
        paged_attention_ref(q[:, 0], kq, vq, tables, qpos[:, 0] + 1)
    with pytest.raises(ValueError, match="go with int8 pools"):
        ops.paged_chunk_attention(q, kq.float(), vq.float(), tables, qpos,
                                  None, ksc, vsc)


# ==================================================== pools and steps
@pytest.fixture(scope="module")
def models():
    ref_cfg = ref_smoke_config("stablelm-3b")
    cfg = get_smoke_config("stablelm-3b")
    ref_params = build_model(ref_cfg).init(jax.random.key(0))
    params = from_jax_params(cfg, jax.tree.map(np.asarray, ref_params),
                             device="cpu")
    return ref_cfg, cfg, ref_params, params


def test_init_pools_kv_dtype_validation(models):
    """(As test_kv_int8.py:124.)"""
    _, cfg, _, _ = models
    kh = cfg.n_kv_heads
    pools = init_pools(cfg, 6, 4, kv_dtype="int8", device="cpu")
    assert pools["k"].dtype == torch.int8 and pools["v"].dtype == torch.int8
    for s in ("k_scale", "v_scale"):
        assert tuple(pools[s].shape) == (cfg.n_layers, 6, kh)
        assert pools[s].dtype == torch.float32
    fp16 = init_pools(cfg, 6, 4, kv_dtype="fp16", device="cpu")
    assert fp16["k"].dtype == torch.float16 and "k_scale" not in fp16
    default = init_pools(cfg, 6, 4, device="cpu")
    assert default["k"].dtype == cfg.dtype and "k_scale" not in default
    with pytest.raises(ValueError, match="kv_dtype"):
        init_pools(cfg, 6, 4, kv_dtype="int4", device="cpu")


def _step_case(cfg, kv_dtype, rng):
    """Random prior pools of ``kv_dtype`` and a ragged mixed chunk (rows of
    8, 3 and 1 valid tokens over different contexts)."""
    bs, n_blocks, c, b = 4, 24, 8, 3
    tables = rng.permutation(n_blocks)[: b * 6].reshape(b, 6).astype(np.int32)
    ctx = np.array([0, 5, 9])
    chunk_lens = np.array([8, 3, 1], np.int32)
    tokens = rng.integers(0, cfg.vocab_size, (b, c)).astype(np.int32)
    positions = (ctx[:, None] + np.minimum(np.arange(c)[None, :],
                                           chunk_lens[:, None] - 1)
                 ).astype(np.int32)
    shape = (cfg.n_layers, n_blocks, bs, cfg.n_kv_heads, cfg.resolved_head_dim)
    pools = {}
    if kv_dtype == "int8":
        sshape = shape[:2] + shape[3:4]
        for name in ("k", "v"):
            pools[name] = _codes(rng, shape)
            pools[name + "_scale"] = rng.uniform(0.005, 0.05, sshape).astype(
                np.float32)
    else:
        for name in ("k", "v"):
            pools[name] = rng.standard_normal(shape).astype(np.float16)
    return tables, tokens, positions, chunk_lens, pools


def _pools_equal(pools, ref_pools):
    for name, t in pools.items():
        got, want = t.float().numpy(), np.asarray(ref_pools[name], np.float32)
        if t.dtype == torch.int8:
            np.testing.assert_array_equal(got, want, err_msg=name)
        elif name.endswith("_scale"):
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=0,
                                       err_msg=name)
        else:
            np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3,
                                       err_msg=name)


@pytest.mark.parametrize("kv_dtype", ["int8", "fp16"])
def test_paged_steps_match_reference(models, kv_dtype):
    """A ragged mixed chunk, then a decode step, over int8 (or fp16) pools
    under the fp32 smoke config: logits agree within 2e-3; int8 codes
    after each step are equal; fp16 pages agree within 2e-3.

    Scales are held to 1e-6 relative, not bitwise: a scale is the absmax of
    a K/V row over 127, and the two frameworks compute those rows (norm,
    matmul, RoPE) with last-bit differences, which is why the fp pages are
    held to a tolerance at all.  On the same rows the quantization is
    bitwise equal (``test_scatter_quantized_bitwise``)."""
    ref_cfg, cfg, ref_params, params = models
    rng = np.random.default_rng(5)
    tables, tokens, positions, chunk_lens, init = _step_case(cfg, kv_dtype,
                                                             rng)
    ref_pools = {k: jnp.asarray(v) for k, v in init.items()}
    pools = init_pools(cfg, 24, 4, kv_dtype=kv_dtype, device="cpu")
    for name, arr in init.items():
        pools[name].copy_(torch.from_numpy(arr))
    lg_ref, ref_pools = ref_paged.paged_prefill_chunk(
        ref_cfg, ref_params, ref_pools, jnp.asarray(tables),
        jnp.asarray(tokens), jnp.asarray(positions), jnp.asarray(chunk_lens))
    lg, pools = paged_prefill_chunk(
        cfg, params, pools, *_t(tables, tokens, positions, chunk_lens))
    np.testing.assert_allclose(lg.numpy(), np.asarray(lg_ref), rtol=2e-3,
                               atol=2e-3)
    _pools_equal(pools, ref_pools)
    b = tables.shape[0]
    dpos = (positions[np.arange(b), chunk_lens - 1] + 1).astype(np.int32)
    dtok = rng.integers(0, cfg.vocab_size, (b,)).astype(np.int32)
    lg_ref, ref_pools = ref_paged.paged_decode_step(
        ref_cfg, ref_params, ref_pools, jnp.asarray(tables),
        jnp.asarray(dpos + 1), jnp.asarray(dtok), jnp.asarray(dpos))
    lg, pools = paged_decode_step(cfg, params, pools,
                                  *_t(tables, dpos + 1, dtok, dpos))
    np.testing.assert_allclose(lg.numpy(), np.asarray(lg_ref), rtol=2e-3,
                               atol=2e-3)
    _pools_equal(pools, ref_pools)


# ============================================================ engine
BS = 4
SHARED = [1 + j % 13 for j in range(8)]  # block-aligned shared prefix


def _run_engine(make, prompts, n_new):
    """test_kv_int8.py's ``_run_engine``: 48 blocks of 4, max_batch 4,
    chunk 4, era and cleanup every 2."""
    engine = make(n_blocks=48, block_size=BS, max_batch=4, chunk_size=4,
                  era_freq=2, cleanup_freq=2)
    tid = engine.pool.register_thread()
    reqs = [engine.submit(p, n_new) for p in prompts]
    stats = engine.run(tid)
    assert stats["completed"] == len(prompts)
    assert engine.pool.unreclaimed() == 0
    assert engine.pool.free_blocks == 48
    return [r.generated for r in reqs], stats


def _port(cfg, params, **kw):
    return lambda **e: ServeEngine(cfg, params, device="cpu", **e, **kw)


PROMPTS = [[2 + (i * 5 + j) % 11 for j in range(3 + i % 4)] for i in range(4)]


def test_engine_int8_tokens_match_reference(models):
    """Both engines in int8 mode give identical greedy tokens on the trace
    of test_kv_int8.py:296 and drain with every block free."""
    ref_cfg, cfg, ref_params, params = models
    ref_toks, ref_stats = _run_engine(
        lambda **e: RefEngine(ref_cfg, ref_params, kv_dtype="int8", **e),
        PROMPTS, 6)
    toks, stats = _run_engine(_port(cfg, params, kv_dtype="int8"), PROMPTS, 6)
    assert toks == ref_toks
    assert stats["completed"] == ref_stats["completed"] == 4


def test_engine_int8_cached_equals_uncached(models):
    """(As test_kv_int8.py:308.)  Prefix caching in int8 mode gives the
    uncached tokens, with real hits."""
    _, cfg, _, params = models
    prompts = [SHARED + [2 + (i * 5 + j) % 11 for j in range(5)]
               for i in range(4)]
    off, _ = _run_engine(_port(cfg, params, kv_dtype="int8",
                               prefix_caching=False), prompts, 4)
    on, stats = _run_engine(_port(cfg, params, kv_dtype="int8"), prompts, 4)
    assert on == off
    assert stats["prefix_hits"] == 3, stats
    assert stats["prefix_hit_tokens"] == 3 * len(SHARED)


def test_engine_int8_vs_fp32_match_rate(models):
    """(As test_kv_int8.py:288.)  The floor only catches a broken dequant
    path; near-tie argmaxes may flip under quantization."""
    _, cfg, _, params = models
    fp, _ = _run_engine(_port(cfg, params), PROMPTS, 6)
    q8, _ = _run_engine(_port(cfg, params, kv_dtype="int8"), PROMPTS, 6)
    match = sum(a == b for x, y in zip(fp, q8) for a, b in zip(x, y))
    assert match / (6 * len(PROMPTS)) >= 0.5, (fp, q8)


def test_engine_fp16_pages_match_reference(models):
    """``kv_dtype="fp16"`` under the fp32 smoke config serves (it raised
    before int8 pages were ported) and gives the reference's tokens."""
    ref_cfg, cfg, ref_params, params = models
    ref_toks, _ = _run_engine(
        lambda **e: RefEngine(ref_cfg, ref_params, kv_dtype="fp16", **e),
        PROMPTS, 6)
    make = _port(cfg, params, kv_dtype="fp16")
    toks, _ = _run_engine(make, PROMPTS, 6)
    assert toks == ref_toks


def test_engine_rejects_unknown_kv_dtype(models):
    """(As test_kv_int8.py:141.)"""
    _, cfg, _, params = models
    with pytest.raises(ValueError, match="kv_dtype"):
        ServeEngine(cfg, params, n_blocks=8, block_size=BS, max_batch=2,
                    kv_dtype="int4", device="cpu")
    engine = ServeEngine(cfg, params, n_blocks=8, block_size=BS, max_batch=2,
                         kv_dtype="int8", device="cpu")
    assert engine.kv_dtype == "int8"
    assert engine.pools["k_scale"].shape[1] == 8 + 1  # + the scratch slot
