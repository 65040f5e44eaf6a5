"""CUDA kernels of ``repro_torch.kernels`` held against their plain PyTorch
versions on the card.  Needs a CUDA device and nvcc; skips without them.

This file imports no JAX (the machine with the card has none), so it runs
there alone:  PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances: fp32 1e-4 (the kernel and the plain version sum in different
orders and use different exp paths); bf16 2e-2 (both compute in f32 from
the same bf16 inputs and round the output to bf16: one bf16 ulp).  Bounded
vs unbounded walks and the era scan are held bitwise.
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.core.era_table import _can_delete_numpy, batched_can_delete
from repro_torch.kernels import era_scan, paged_attention
from repro_torch.kernels.ref import (INF_ERA32, era_scan_interval_ref,
                                     paged_attention_chunk_ref,
                                     paged_attention_ref)

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
