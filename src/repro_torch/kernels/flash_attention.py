"""Dense GQA flash attention, forward and backward: the CUDA kernels.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
``flash_attention_tpu`` (:83).  q (B, T, H, D) attends over k/v
(B, T, KH, D), causally or not, with an online softmax; query head
``kh * G + g`` reads kv head ``kh``.  The TPU kernel's ``cq``/``ck`` are
its tiling and have no counterpart here: the CUDA kernel picks its own
tiles and takes any T.  ``csrc/flash_attention.cu`` holds two variants
(design and what bounds each on an H100 are in its header), and
:func:`choose_variant` picks one: ``"tile"``, the tensor-core tile of
``csrc/attention_tile.cuh`` for bf16 at D 64, 80, 128 or 256, or
``"cuda_core"``, the exact f32 tile of ``csrc/attention_f32.cuh``
(register-blocked FMA products on the CUDA cores; f32, and bf16 at any
other D).  Its plain PyTorch version is ``flash_attention_ref``, and
``ref.flash_attention_f32_tile_ref`` models the f32 tile's order of
operations.

The TPU kernel has no backward (the reference differentiates its jnp
chunked attention); the port's gradient is ``csrc/flash_attention_bwd.cu``
(dQ, dK, dV from q, k, v, the output, dO and the forward's row
log-sum-exp), whose plain version is ``ref.flash_attention_bwd_ref``.  It
has two variants too, picked by :func:`choose_bwd_variant`: ``"tile"``,
tensor-core tiles (``mma.sync`` fed by ``cp.async``) for bf16 at D 64, 80,
128 or 256, which round P and dS to bf16 for their products and keep S,
dP, the exponentials and every sum in f32; or ``"cuda_core"``, the exact
f32 tile (f32, and bf16 at any other D): the forward's register-blocked
FMA micro-tiles (``csrc/attention_f32.cuh``) in a dQ kernel over (position,
group) rows and a dK/dV kernel over a kv head's keys, 32-key (16 at D 128
and 256) tiles through a ``cp.async`` ring, exponentials in log2 units,
nothing below f32; ``ref.flash_attention_bwd_f32_tile_ref`` models its
order.  Neither uses atomics, so two calls on the same inputs give the
same bits.  Where a GQA grid has too few dK/dV blocks to fill the card,
:func:`bwd_splits` spreads each kv head's query heads over several blocks
whose f32 partials one more kernel sums in a fixed order.
:func:`flash_attention` runs through :class:`FlashAttentionFn` when
autograd needs its gradient (grad enabled and an input requiring grad):
the forward then also writes the log-sum-exp, and the backward launches
the CUDA backward.  Otherwise it launches the forward alone, without the
log-sum-exp; the output is the same bits either way.

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

__all__ = ["flash_attention", "flash_attention_bwd", "flash_attention_ref",
           "FlashAttentionFn", "choose_variant", "choose_bwd_variant",
           "bwd_splits", "LAUNCHES", "VARIANT_LAUNCHES", "BWD_LAUNCHES",
           "BWD_VARIANT_LAUNCHES"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
#: head dims the tensor-core tile is instantiated for
TILE_HEAD_DIMS = (64, 80, 128, 256)

#: launches of the kernel (``LAUNCHES.n``), bumped once per call
LAUNCHES = build.Counter()
#: launches per variant: ``tile`` and ``cuda_core`` (the f32 tile)
VARIANT_LAUNCHES = {name: build.Counter() for name in ("tile", "cuda_core")}
#: launches of the backward (``BWD_LAUNCHES.n``), bumped once per call
#: (its kernels, ``csrc/flash_attention_bwd.cu``, launch together)
BWD_LAUNCHES = build.Counter()
#: backward launches per variant: ``tile`` and ``cuda_core``
BWD_VARIANT_LAUNCHES = {name: build.Counter()
                        for name in ("tile", "cuda_core")}
#: dK/dV blocks the backward tile's grid should have (two per SM of an
#: H100) before :func:`bwd_splits` spreads a kv head's query heads
BWD_TARGET_BLOCKS = 264
#: the same for the f32 tile: four waves of two CTAs an SM, over which a
#: causal grid's unequal blocks (heaviest first) even out
BWD_F32_TARGET_BLOCKS = 4 * 264


def choose_variant(dtype: torch.dtype, d: int) -> str:
    """``"tile"`` for bf16 at a head dim the tile is built for, else
    ``"cuda_core"``."""
    if dtype == torch.bfloat16 and d in TILE_HEAD_DIMS:
        return "tile"
    return "cuda_core"


def choose_bwd_variant(dtype: torch.dtype, d: int) -> str:
    """The backward's variant: ``"tile"`` (tensor cores) for bf16 at the
    tile's head dims, else ``"cuda_core"`` (the f32 tile)."""
    return choose_variant(dtype, d)


def bwd_splits(b: int, t: int, kh: int, g: int, d: int,
               variant: str = "tile") -> int:
    """Blocks each kv head's G query heads are spread over in the
    ``variant``'s dK/dV grid: 1 where (key tiles x KH x B) blocks reach
    the variant's target (``BWD_TARGET_BLOCKS``, the f32 tile's
    ``BWD_F32_TARGET_BLOCKS``), else enough to (nearly) reach it, each
    split taking ceil(G / splits) heads and none empty."""
    f32 = variant == "cuda_core"
    # keys a dK/dV block: the tile's BwdShape::kKVKeys, the f32 tile's 64
    keys = 64 if d <= 128 or f32 else 32
    target = BWD_F32_TARGET_BLOCKS if f32 else BWD_TARGET_BLOCKS
    blocks = -(-t // keys) * kh * b
    if g == 1 or blocks >= target:
        return 1
    per = -(-g // min(g, -(-target // blocks)))
    return -(-g // per)


def _check(q, k, v, **more):
    """The operands' checks: CUDA, contiguous, 4-D, one dtype of f32 or
    bf16, k and v (B, T, KH, D) against q (B, T, H, D), H a multiple of
    KH, D <= 256; ``more`` names other tensors of q's shape."""
    for name, t in (("q", q), ("k", k), ("v", v), *more.items()):
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
    for name, x in more.items():
        if x.shape != q.shape:
            raise ValueError(f"{name} {tuple(x.shape)} must match q "
                             f"{tuple(q.shape)}")


def _forward(q, k, v, causal: bool, with_lse: bool):
    """Launch the forward; returns (out, lse or None), lse f32 (B, H, T)."""
    _check(q, k, v)
    b, t, h, d = q.shape
    kh = k.shape[2]
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, t), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if b == 0 or t == 0:
        return out, lse
    lib = build.library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    variant = choose_variant(q.dtype, d)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if with_lse else None)
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
    return out, lse


def flash_attention_bwd(q, k, v, out, dout, lse, *, causal: bool = True,
                        variant: str | None = None,
                        splits: int | None = None,
                        wide: bool | None = None):
    """dQ, dK, dV of :func:`flash_attention` (the CUDA backward): q, out and
    dout (B,T,H,D), k/v (B,T,KH,D) CUDA tensors of one dtype, lse the
    forward's f32 (B, H, T).  Returns (dq, dk, dv) in q's dtype.
    ``variant`` (default :func:`choose_bwd_variant`), ``splits`` (default
    :func:`bwd_splits`) and, for the f32 tile, ``wide`` (64-row CTAs, or
    one warp's rows; default: as the grid fills the card) force a route,
    to compare routes on the same inputs; a variant that does not take the
    inputs raises."""
    b, t, h, d = q.shape
    if variant is None:
        variant = choose_bwd_variant(q.dtype, d)
    if variant not in BWD_VARIANT_LAUNCHES:
        raise ValueError(f"variant {variant!r} is not one of "
                         f"{list(BWD_VARIANT_LAUNCHES)}")
    if variant == "tile" and choose_bwd_variant(q.dtype, d) != "tile":
        raise ValueError(f"the tile backward takes bf16 at head dims "
                         f"{TILE_HEAD_DIMS}, got {q.dtype} at {d}")
    if variant == "tile" and wide is not None:
        raise ValueError("wide applies to the f32 tile (cuda_core) only")
    _check(q, k, v, out=out, dout=dout)
    kh = k.shape[2]
    if (lse.dtype != torch.float32 or lse.shape != (b, h, t)
            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError(f"lse must be a contiguous f32 {(b, h, t)} tensor on "
                         f"{q.device}, got {lse.dtype} {tuple(lse.shape)}")
    if splits is None:
        splits = bwd_splits(b, t, kh, h // kh, d, variant)
    if not 1 <= splits <= h // kh:
        raise ValueError(f"splits must be in 1..{h // kh}, got {splits}")
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    if b == 0 or t == 0:
        return dq, dk, dv
    delta = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    lib = build.library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = [x.data_ptr() for x in (q, k, v, out, dout, lse, delta, dq, dk,
                                   dv)]
    scale = float(1.0 / math.sqrt(d))
    part = (torch.empty((2 * splits, *k.shape), dtype=torch.float32,
                        device=q.device) if splits > 1 else None)
    ptrs.append(part.data_ptr() if part is not None else None)
    if variant == "tile":
        err = lib.flash_attention_bwd_tile(*ptrs, splits, b, t, h, kh, d,
                                           int(causal), scale, stream)
    else:
        err = lib.flash_attention_bwd(_DTYPES[q.dtype], *ptrs, splits, b, t,
                                      h, kh, d, int(causal), scale,
                                      -1 if wide is None else int(wide),
                                      stream)
    build.check(err, f"flash_attention_bwd ({variant})")
    BWD_VARIANT_LAUNCHES[variant].bump()
    BWD_LAUNCHES.bump()
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """The CUDA forward with the CUDA backward as its gradient.  The forward
    saves q, k, v, the output and the row log-sum-exp; the backward
    launches ``flash_attention_bwd``.  Both check their operands as
    :func:`flash_attention` does and raise on what the kernels do not
    take."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        out, lse = _forward(q, k, v, causal, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout.contiguous(), lse,
                                         causal=ctx.causal)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q (B,T,H,D), k/v (B,T,KH,D) CUDA tensors of one dtype (f32 or bf16),
    H a multiple of KH, D <= 256.  Returns (B,T,H,D) in q's dtype, with
    the CUDA backward as its gradient where autograd needs one."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return FlashAttentionFn.apply(q, k, v, causal)
    return _forward(q, k, v, causal, with_lse=False)[0]
