"""The port's plain kernel versions (``repro_torch.kernels``) held against the
Pallas kernels of ``repro.kernels``, run in interpret mode as the reference's
own tests run them, and against the NumPy cleanup backend.

Inputs come from a NumPy seed and feed both packages.  Tolerance: 1e-5 in
fp32 (the two sum in different orders).  The all-masked row is held to the
Pallas kernel (0), where the reference's jnp oracle differs.  The CUDA
kernels are held to these plain versions on the card (``test_torch_cuda``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.era_table import _can_delete_numpy
from repro.kernels.era_scan import era_scan_interval as pallas_era_scan
from repro.kernels.paged_attention import paged_attention as pallas_decode
from repro.kernels.paged_attention import \
    paged_attention_chunk as pallas_chunk
from repro_torch.kernels import era_scan, ops, paged_attention
from repro_torch.kernels.ref import (INF_ERA32, era_scan_interval_ref,
                                     paged_attention_chunk_ref,
                                     paged_attention_ref)

TOL = 1e-5


def _case(b, c, kh, g, d, bs, nblk, seed):
    rng = np.random.default_rng(seed)
    n = b * nblk + 2
    q = rng.standard_normal((b, c, kh, g, d)).astype(np.float32)
    k = rng.standard_normal((n, bs, kh, d)).astype(np.float32)
    v = rng.standard_normal((n, bs, kh, d)).astype(np.float32)
    tables = rng.permutation(n)[: b * nblk].reshape(b, nblk).astype(np.int32)
    ctx = rng.integers(0, nblk * bs - c + 1, (b, 1))
    qpos = (ctx + np.arange(c)[None, :]).astype(np.int32)
    return q, k, v, tables, qpos


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _pallas(q, k, v, tables, qpos, live=None):
    out = pallas_chunk(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       jnp.asarray(tables), jnp.asarray(qpos),
                       None if live is None else jnp.asarray(live),
                       interpret=True)
    return np.asarray(out)


SHAPES = [
    # b, c, kh, g, d, bs, nblk
    (2, 1, 2, 1, 80, 4, 4),     # decode-as-chunk, head_dim 80, MHA (G = 1)
    (3, 4, 2, 2, 64, 8, 5),     # GQA G = 2, ragged contexts mid-prompt
    (1, 8, 1, 1, 80, 4, 7),     # chunk wider than a block, head_dim 80
    (2, 1, 1, 4, 64, 16, 4),    # C == 1, G = 4
]


@pytest.mark.parametrize("b,c,kh,g,d,bs,nblk", SHAPES)
def test_plain_chunk_matches_pallas(b, c, kh, g, d, bs, nblk):
    q, k, v, tables, qpos = _case(b, c, kh, g, d, bs, nblk, seed=b + c + d)
    got = paged_attention_chunk_ref(*_t(q, k, v, tables, qpos)).numpy()
    np.testing.assert_allclose(got, _pallas(q, k, v, tables, qpos),
                               rtol=TOL, atol=TOL)
    # a ragged bound below the causal range: the kernel never reads past it
    live = np.maximum(1, qpos.max(axis=1) // bs + 1 - np.arange(b) % 2)
    live = live.astype(np.int32)
    got = paged_attention_chunk_ref(*_t(q, k, v, tables, qpos, live)).numpy()
    np.testing.assert_allclose(got, _pallas(q, k, v, tables, qpos, live),
                               rtol=TOL, atol=TOL)


def test_all_masked_rows_return_zero():
    """A request with no live slot gets 0, as the TPU kernel's max(l, 1e-30)
    guard gives; its neighbour is unaffected."""
    q, k, v, tables, qpos = _case(2, 3, 2, 2, 64, 4, 4, seed=7)
    live = np.array([0, 4], np.int32)
    got = paged_attention_chunk_ref(*_t(q, k, v, tables, qpos, live)).numpy()
    want = _pallas(q, k, v, tables, qpos, live)
    assert not want[0].any() and not got[0].any()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("b,c,kh,g,d,bs,nblk", SHAPES[1:3])
def test_bounded_walk_bitwise_equals_unbounded(b, c, kh, g, d, bs, nblk):
    """The exact bound and the degenerate walk-everything bound give the
    same bits (as test_kernels.py:238 holds for the Pallas kernel)."""
    q, k, v, tables, qpos = _case(b, c, kh, g, d, bs, nblk, seed=11)
    exact = (qpos.max(axis=1) // bs + 1).astype(np.int32)
    full = np.full((b,), nblk, np.int32)
    bounded = paged_attention_chunk_ref(*_t(q, k, v, tables, qpos, exact))
    unbounded = paged_attention_chunk_ref(*_t(q, k, v, tables, qpos, full))
    derived = paged_attention_chunk_ref(*_t(q, k, v, tables, qpos))
    assert torch.equal(bounded, unbounded)
    assert torch.equal(bounded, derived)


def test_nan_dead_slots_never_read():
    """NaN over every pool block past a request's bound changes nothing
    (as test_kernels.py:306)."""
    b, c, kh, g, d, bs, nblk = 1, 2, 2, 2, 64, 4, 5
    q, k, v, _, _ = _case(b, c, kh, g, d, bs, nblk, seed=29)
    tables = np.arange(nblk, dtype=np.int32)[None, :]
    live = 2
    qpos = (live * bs - c + np.arange(c, dtype=np.int32))[None, :]
    nl = np.full((b,), live, np.int32)
    out1 = paged_attention_chunk_ref(*_t(q, k, v, tables, qpos, nl))
    k2, v2 = k.copy(), v.copy()
    k2[live:] = np.nan
    v2[live:] = np.nan
    out2 = paged_attention_chunk_ref(*_t(q, k2, v2, tables, qpos, nl))
    assert torch.equal(out1, out2)
    assert torch.isfinite(out2).all()
    np.testing.assert_allclose(out2.numpy(), _pallas(q, k2, v2, tables, qpos,
                                                     nl), rtol=TOL, atol=TOL)


def test_decode_wrapper_equals_chunk():
    """The C == 1 decode form equals the explicit decode-as-chunk call and
    the Pallas decode wrapper (as test_kernels.py:332)."""
    b, kh, g, d, bs, nblk = 3, 2, 2, 64, 4, 4
    rng = np.random.default_rng(5)
    q, k, v, tables, _ = _case(b, 1, kh, g, d, bs, nblk, seed=5)
    q = q[:, 0]
    lengths = rng.integers(1, nblk * bs + 1, (b,)).astype(np.int32)
    live = ((lengths - 1) // bs + 1).astype(np.int32)
    dec = paged_attention_ref(*_t(q, k, v, tables, lengths, live))
    chunk = paged_attention_chunk_ref(*_t(q[:, None], k, v, tables,
                                          (lengths - 1)[:, None], live))
    assert torch.equal(dec, chunk[:, 0])
    want = np.asarray(pallas_decode(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), jnp.asarray(tables),
                                    jnp.asarray(lengths), jnp.asarray(live),
                                    interpret=True))
    np.testing.assert_allclose(dec.numpy(), want, rtol=TOL, atol=TOL)


# ------------------------------------------------------------- era scan
def _intervals(seed):
    rng = np.random.default_rng(seed)
    r = int(rng.integers(1, 400))
    s = int(rng.integers(1, 700))
    alloc = rng.integers(0, 120, r).astype(np.int32)
    retire = (alloc + rng.integers(0, 60, r)).astype(np.int32)
    lo = rng.integers(0, 200, s).astype(np.int32)
    hi = np.where(rng.random(s) < 0.5, lo,
                  lo + rng.integers(0, 40, s)).astype(np.int32)
    lo[rng.random(s) < 0.4] = INF_ERA32
    return alloc, retire, lo, hi


@pytest.mark.parametrize("seed", range(6))
def test_plain_era_scan_matches_numpy_and_pallas(seed):
    args = _intervals(seed)
    got = era_scan_interval_ref(*_t(*args)).numpy()
    np.testing.assert_array_equal(got, _can_delete_numpy(*args))
    want = np.asarray(pallas_era_scan(*map(jnp.asarray, args),
                                      interpret=True))
    np.testing.assert_array_equal(got, want)


def test_plain_era_scan_boundary_eras():
    alloc = np.array([5, 5, 5, 5], np.int32)
    retire = np.array([10, 10, 10, 10], np.int32)
    for era, deletable in [(5, False), (10, False), (4, True), (11, True),
                           (INF_ERA32, True)]:
        lo = np.array([era], np.int32)
        got = era_scan_interval_ref(*_t(alloc, retire, lo, lo)).numpy()
        assert bool(got.all()) == deletable, era
        want = np.asarray(pallas_era_scan(*map(jnp.asarray,
                                               (alloc, retire, lo, lo)),
                                          interpret=True))
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------- dispatch
def test_selectors_dispatch_on_device():
    """A CPU tensor goes to the plain version; a device with neither a
    kernel nor a plain version raises."""
    q, k, v, tables, qpos = _case(2, 3, 2, 1, 80, 4, 4, seed=3)
    tq = _t(q, k, v, tables, qpos)
    torch.testing.assert_close(ops.paged_chunk_attention(*tq),
                               paged_attention_chunk_ref(*tq), rtol=0, atol=0)
    args = _intervals(1)
    np.testing.assert_array_equal(
        ops.can_delete_blocks_interval(*args, device="cpu"),
        _can_delete_numpy(*args))
    with pytest.raises(ValueError, match="meta"):
        ops.paged_chunk_attention(*(t.to("meta") for t in tq))


def test_kernel_wrappers_take_cuda_tensors_only():
    """The kernel wrappers never fall back to the plain version: a CPU
    tensor is refused before any launch, and nothing is counted."""
    q, k, v, tables, qpos = _t(*_case(1, 2, 2, 1, 80, 4, 2, seed=4))
    before = paged_attention.LAUNCHES.n, era_scan.LAUNCHES.n
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention.paged_attention_chunk(q, k, v, tables, qpos)
    a = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        era_scan.era_scan_interval(a, a, a, a)
    assert (paged_attention.LAUNCHES.n, era_scan.LAUNCHES.n) == before
