"""The port's plain dense flash attention (``repro_torch.kernels.ref``)
held against the Pallas kernel ``flash_attention_tpu`` run in interpret
mode, as the reference's own tests run it (test_kernels.py:471-507).

Inputs come from a NumPy seed and feed both packages (bf16 inputs are the
same bits on both sides: both round the f32 draw to nearest even).
Tolerances are the reference's: 2e-5 in f32 (the two sum in different
orders) and 3e-2 in bf16 (the output rounds to bf16).  The CUDA kernel is
held to this plain version on the card (``test_torch_cuda``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_tpu
from repro_torch.kernels import flash_attention, ops
from repro_torch.kernels.ref import flash_attention_ref

torch.backends.cuda.matmul.allow_tf32 = False


def _qkv(b, t, h, kh, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, t, h, d), (b, t, kh, d), (b, t, kh, d))]


def _both(arrays, dtype):
    """The same values as jnp arrays and torch tensors of ``dtype``."""
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(dtype) for a in arrays])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,kh,d,cq,ck", [
    (2, 256, 4, 4, 64, 128, 128),   # MHA
    (1, 256, 4, 2, 64, 64, 128),    # GQA g=2
    (2, 128, 8, 1, 128, 128, 64),   # MQA
])
def test_plain_flash_matches_pallas(b, t, h, kh, d, cq, ck, dtype):
    (jq, jk, jv), (q, k, v) = _both(_qkv(b, t, h, kh, d, seed=t + h), dtype)
    want = flash_attention_tpu(jq, jk, jv, causal=True, cq=cq, ck=ck,
                               interpret=True)
    got = flash_attention_ref(q, k, v, causal=True)
    assert got.dtype == dtype and got.shape == (b, t, h, d)
    tol = 3e-2 if dtype == torch.bfloat16 else 2e-5
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def test_plain_flash_noncausal():
    (jq, jk, jv), (q, k, v) = _both(_qkv(2, 128, 2, 2, 64, seed=9),
                                    torch.float32)
    want = flash_attention_tpu(jq, jk, jv, causal=False, cq=64, ck=64,
                               interpret=True)
    got = flash_attention_ref(q, k, v, causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_plain_flash_ragged_t():
    """The port takes any T; the TPU kernel needs T to divide by its chunks.
    Causal rows never see a later position, so a T of 100 equals the
    first 100 rows of the Pallas kernel on inputs padded to 128."""
    t, pad = 100, 128
    arrays = _qkv(1, pad, 4, 2, 80, seed=3)
    (jq, jk, jv), _ = _both(arrays, torch.float32)
    want = np.asarray(flash_attention_tpu(jq, jk, jv, causal=True, cq=64,
                                          ck=64, interpret=True))[:, :t]
    q, k, v = (torch.from_numpy(np.ascontiguousarray(a[:, :t]))
               for a in arrays)
    np.testing.assert_allclose(flash_attention_ref(q, k, v).numpy(), want,
                               rtol=2e-5, atol=2e-5)


def test_flash_selector_dispatch_and_wrapper_refuses_cpu():
    """The selector sends a CPU tensor to the plain version; the kernel
    wrapper refuses it before any launch and counts nothing."""
    _, (q, k, v) = _both(_qkv(1, 16, 4, 2, 32, seed=1), torch.float32)
    assert torch.equal(ops.flash_attention(q, k, v, causal=False),
                       flash_attention_ref(q, k, v, causal=False))
    before = flash_attention.LAUNCHES.n
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention.flash_attention(q, k, v)
    assert flash_attention.LAUNCHES.n == before
    with pytest.raises(ValueError, match="meta"):
        ops.flash_attention(*(x.to("meta") for x in (q, k, v)))
