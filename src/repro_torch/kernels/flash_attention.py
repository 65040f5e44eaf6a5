"""Dense GQA flash attention (forward): the CUDA kernel.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
``flash_attention_tpu`` (:83).  q (B, T, H, D) attends over k/v
(B, T, KH, D), causally or not, with an online softmax; query head
``kh * G + g`` reads kv head ``kh``.  The TPU kernel's ``cq``/``ck`` are
its tiling and have no counterpart here: the CUDA kernel picks its own
tiles and takes any T.  ``csrc/flash_attention.cu`` holds two variants
(design and what bounds each on an H100 are in its header), and
:func:`choose_variant` picks one: ``"tile"``, the tensor-core tile of
``csrc/attention_tile.cuh`` for bf16 at D 64, 80, 128 or 256, or
``"cuda_core"``, the exact f32 walk (and bf16 at any other D).  This
module checks the operands and launches the chosen variant on the current
CUDA stream.  Its plain PyTorch version is ``flash_attention_ref``.

The model zoo's attention (``models.attention.flash_attention``) launches
it on CUDA for the self-attention of ``forward``, ``prefill`` and the
whisper encoder wherever its route table allows (equal q and k lengths
from ``arange`` positions, no window cut, Dv == D <= 256); the paged
serving steps do not call it.
"""

from __future__ import annotations

import math

import torch

from . import build
from .ref import flash_attention_ref

__all__ = ["flash_attention", "flash_attention_ref", "choose_variant",
           "LAUNCHES", "VARIANT_LAUNCHES"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
#: head dims the tensor-core tile is instantiated for
TILE_HEAD_DIMS = (64, 80, 128, 256)

#: launches of the kernel (``LAUNCHES.n``), bumped once per call
LAUNCHES = build.Counter()
#: launches per variant: ``tile`` and ``cuda_core``
VARIANT_LAUNCHES = {name: build.Counter() for name in ("tile", "cuda_core")}


def choose_variant(dtype: torch.dtype, d: int) -> str:
    """``"tile"`` for bf16 at a head dim the tile is built for, else
    ``"cuda_core"``."""
    if dtype == torch.bfloat16 and d in TILE_HEAD_DIMS:
        return "tile"
    return "cuda_core"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q (B,T,H,D), k/v (B,T,KH,D) CUDA tensors of one dtype (f32 or bf16),
    H a multiple of KH, D <= 256.  Returns (B,T,H,D) in q's dtype."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.ndim != 4 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 4-D tensor, got "
                             f"{tuple(t.shape)}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} must be {q.dtype}, got {t.dtype}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"dtype {q.dtype} not supported; one of "
                         f"{list(_DTYPES)}")
    b, t, h, d = q.shape
    kh = k.shape[2]
    if (k.shape != v.shape or k.shape[:2] != (b, t) or k.shape[3] != d
            or h % kh != 0):
        raise ValueError(f"k/v {tuple(k.shape)}, {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)} (H must divide by KH)")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} exceeds the kernel's {MAX_HEAD_DIM}")
    out = torch.empty_like(q)
    if b == 0 or t == 0:
        return out
    lib = build.library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    variant = choose_variant(q.dtype, d)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    scale = float(1.0 / math.sqrt(d))
    if variant == "tile":
        err = lib.flash_attention_tile(*ptrs, b, t, h, kh, d, int(causal),
                                       scale, stream)
    else:
        err = lib.flash_attention(_DTYPES[q.dtype], *ptrs, b, t, h, kh, d,
                                  int(causal), scale, stream)
    build.check(err, f"flash_attention ({variant})")
    VARIANT_LAUNCHES[variant].bump()
    LAUNCHES.bump()
    return out
