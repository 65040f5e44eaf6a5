"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for an H100).

Run from the repository root:  python3 chip_smoke.py

Phases, each printing its own line; any failure exits non-zero:

1. Build every CUDA kernel from ``src/repro_torch/kernels/csrc`` with nvcc
   for sm_90a (one nvcc per source, started together) and print the card's
   name and power limit.
2. Hold each kernel variant against its plain PyTorch version at main-path
   shapes (stablelm-3b: KH 32, G 1, head_dim 80, block_size 16), time
   kernel, plain version and the PyTorch library yardstick, and compute
   each kernel's bound (the least time the card could take for the same
   work): paged attention over bf16/f32 and over int8 pools at decode
   (the split-KV walk) and at a mixed step (the tensor-core tile; the f32
   query's CUDA-core walk), also in the engine's own mixed layout (decode
   rows padded to the chunk bucket); the era scan; dense flash attention
   at the stablelm-3b and starcoder2-3b prefill shapes.  The split-KV walk
   and the tile are also held against the plain models of their own
   algebra (``ref.paged_attention_split_ref``, ``paged_attention_tile_ref``).
   ``ms`` is the time per eager call (host launch cost included where it
   exceeds the device work), ``device_ms`` that of one CUDA-graph replay
   of the same calls (the device time of their kernels).
3. Serve a seeded 32-request trace on the full-width stablelm-3b engine in
   bf16 (WFE, use_kernel=True) and check the serving invariants, that the
   path's kernels were launched, and that decode steps took the split-KV
   walk and mixed and prefill steps the tensor-core tile (launches printed
   by variant and by plan kind); then (3b) the same trace on the same
   weights with int8 KV pages.  Then check the model step against the
   plain path on the CPU at full width and reduced depth.
4. A WFE forced-slow-path run at reduced depth.

The line before the last is the ``kernels`` JSON line; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device the script exits
non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# fp32 products at full precision in every comparison below
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

#: H100 SXM published peaks (dense): HBM bytes/s, bf16 tensor FLOP/s, f32
#: FLOP/s outside the tensor cores, and int32 ops/s on the CUDA cores (half
#: as many INT32 as FP32 lanes per SM and one op per lane per clock, against
#: two FLOPs per FP32 FMA: 67 / 4 TOP/s)
HBM_BPS = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12, torch.int32: 16.75e12}

SEED = 0
FAILED: list = []


def phase(name: str, ok: bool, detail: str = "") -> None:
    print(f"[{'PASS' if ok else 'FAIL'}] {name}" + (f": {detail}" if detail else ""),
          flush=True)
    if not ok:
        FAILED.append(name)


def time_ms(fn, reps: int = 20, warmup: int = 3, graph: bool = False) -> float:
    """Time per call from CUDA events around ``reps`` eager calls (the
    host's launch overhead counts wherever it exceeds the device work).
    With ``graph`` the ``reps`` calls are captured once into a CUDA graph
    and one replay is timed: the device time of the calls' kernels."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(reps):
                fn()
        g.replay()
        torch.cuda.synchronize()
        start.record()
        g.replay()
        end.record()
    else:
        start.record()
        for _ in range(reps):
            fn()
        end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def gpu_name_and_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else \
        f"nvidia-smi failed: {out.stderr.strip()}"


# ------------------------------------------------------------ phase 2: kernels
def attention_case(dtype, b, c, nblk, layers, dev, int8=False,
                   engine_mixed=False):
    """Main-path-shaped operands: (layers, N, bs, KH, D) pools (one pool per
    layer, rotated so consecutive launches read other pages, as the layer
    loop does), random permuted tables, ragged contexts.  ``int8`` makes
    the pools int8 codes with (layers, N, KH) f32 scales.  The draws are
    seeded by the shape, so every pool type of one shape gets the same
    tables, contexts and q: their times compare like with like.

    ``engine_mixed`` lays the rows out as the engine's mixed step does
    (``ServeEngine._dispatch_mixed``): the first b - 1 rows are decode rows
    whose c columns all sit at the row's decode position (the pad columns
    clamp to it) and only column 0 is read; the last row is a c-token
    chunk.  ``read`` (B, C) marks the rows the step reads."""
    from repro_torch.configs import get_config

    cfg = get_config("stablelm-3b")
    kh, d, g, bs = cfg.n_kv_heads, cfg.resolved_head_dim, 1, 16
    n = b * nblk + 1
    gen = torch.Generator(device=dev).manual_seed(SEED + 1000 * b + c)
    k = torch.randn((layers, n, bs, kh, d), generator=gen, device=dev).to(dtype)
    v = torch.randn((layers, n, bs, kh, d), generator=gen, device=dev).to(dtype)
    q = torch.randn((b, c, kh, g, d), generator=gen, device=dev).to(dtype)
    perm = torch.randperm(n - 1, generator=gen, device=dev)[: b * nblk]
    tables = perm.reshape(b, nblk).to(torch.int32).contiguous()
    # ragged contexts up to the trace's longest request (1024 + 64 tokens)
    hi = min(nblk * bs, 1088) - c
    ctx = torch.randint(0, hi + 1, (b, 1), generator=gen, device=dev)
    cols = torch.arange(c, device=dev)[None, :]
    qpos = (ctx + cols).to(torch.int32)
    read = torch.ones((b, c), dtype=torch.bool, device=dev)
    if engine_mixed:
        qpos[:-1] = ctx[:-1].to(torch.int32)
        read[:-1] = cols == 0
    live = (qpos.max(dim=1).values // bs + 1).to(torch.int32)
    case = dict(k=k, v=v, q=q, tables=tables, qpos=qpos, live=live, bs=bs,
                scale=1.0 / math.sqrt(d), ksc=None, vsc=None, read=read)
    if int8:
        shape, sshape = k.shape, k.shape[:2] + (kh,)
        case["k"], case["v"] = (
            torch.randint(-127, 128, shape, generator=gen, device=dev,
                          dtype=torch.int8) for _ in range(2))
        case["ksc"], case["vsc"] = (
            0.005 + 0.045 * torch.rand(sshape, generator=gen, device=dev)
            for _ in range(2))
    return case


def _layer(case, l):
    """Layer ``l``'s (k_pool, v_pool, k_scales, v_scales) of a case."""
    ksc, vsc = case["ksc"], case["vsc"]
    return (case["k"][l], case["v"][l], None if ksc is None else ksc[l],
            None if vsc is None else vsc[l])


def attention_bound_ms(case) -> tuple:
    """Least time for the work: bytes (q, the live K/V pages at the pool's
    element size, their scales for int8 pools, tables, positions, output)
    over HBM, or 4*D flops per visible (query, key) pair over the query
    type's peak; the larger of the two.  Only the rows the step reads
    (``case["read"]``) count: q and output rows, and their pairs."""
    q, k, tables, qpos, live, bs = (case["q"], case["k"], case["tables"],
                                    case["qpos"], case["live"], case["bs"])
    b, c, kh, g, d = q.shape
    read = case["read"]
    n_read = int(read.sum())
    page = bs * kh * d * k.element_size()
    if case["ksc"] is not None:
        page += kh * case["ksc"].element_size()  # one scale per kv head
    nbytes = (2 * n_read * kh * g * d * q.element_size()
              + 2 * int(live.sum()) * page
              + 4 * (tables.numel() + qpos.numel() + live.numel()))
    visible = torch.minimum(qpos.long() + 1, (live.long() * bs)[:, None])
    flops = 4 * d * g * kh * int(visible[read].sum())
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = flops / PEAK_OPS[q.dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _dense(pool, scales, ids, dtype):
    """Pages ``ids`` (B, w) of a pool as dense (B, KH, w * bs, D) in
    ``dtype``; int8 pages dequantized (code * scale) on the way."""
    pages = pool[ids]                                  # (B, w, bs, KH, D)
    if scales is not None:
        pages = pages.float() * scales[ids][:, :, None, :, None]
    b, w, bs, kh, d = pages.shape
    return (pages.to(dtype).reshape(b, w * bs, kh, d).transpose(1, 2)
            .contiguous())


def sdpa_ms(case, layers) -> tuple:
    """One scaled_dot_product_attention call over the same work, eager and
    replayed from a CUDA graph: the pages are gathered into dense (B, H, S,
    D) K/V of q's dtype first, int8 pages dequantized (neither is timed)."""
    import torch.nn.functional as F

    q, tables, qpos, live, bs = (case["q"], case["tables"], case["qpos"],
                                 case["live"], case["bs"])
    b, c, kh, g, d = q.shape
    w = int(live.max())
    ids = tables[:, :w].long()
    ks, vs = [], []
    for l in range(layers):
        kp, vp, ksc, vsc = _layer(case, l)
        ks.append(_dense(kp, ksc, ids, q.dtype))
        vs.append(_dense(vp, vsc, ids, q.dtype))
    qd = q[:, :, :, 0].transpose(1, 2).contiguous()  # (B, H, C, D)
    kvpos = torch.arange(w * bs, device=q.device)
    mask = ((kvpos[None, None, :] <= qpos[:, :, None])
            & (kvpos[None, None, :] < (live * bs)[:, None, None]))[:, None]
    it = [0]

    def call():
        l = it[0] % layers
        it[0] += 1
        F.scaled_dot_product_attention(qd, ks[l], vs[l], attn_mask=mask,
                                       scale=case["scale"])

    return time_ms(call), time_ms(call, graph=True)


def time_attention(case, layers, tag) -> dict:
    """Kernel, plain version and SDPA over a case, each launch reading the
    next layer's pools as the layer loop does; the bound from the case.
    These comparison launches are taken off the launch counts."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels.ref import paged_attention_chunk_ref

    q, tables, qpos, live, scale = (case["q"], case["tables"], case["qpos"],
                                    case["live"], case["scale"])
    it = [0]

    def layer():
        it[0] += 1
        return _layer(case, (it[0] - 1) % layers)

    def kern():
        kp, vp, ksc, vsc = layer()
        pa.paged_attention_chunk(q, kp, vp, tables, qpos, live, ksc, vsc,
                                 scale=scale)

    def plain():
        kp, vp, ksc, vsc = layer()
        paged_attention_chunk_ref(q, kp, vp, tables, qpos, live, scale=scale,
                                  k_scales=ksc, v_scales=vsc)

    saved = _save_counts()
    ms = time_ms(kern)
    device_ms = time_ms(kern, graph=True)
    plain_ms = time_ms(plain, reps=5, warmup=1)
    lib_ms, lib_device_ms = sdpa_ms(case, layers)
    _restore_counts(saved)
    bound, by = attention_bound_ms(case)
    dense = " (dense K/V, dequantized untimed)" if case["ksc"] is not None else ""
    print(f"  {tag} [{case_variant(case)}]: kernel {ms:.4f} ms (graph replay "
          f"{device_ms:.4f} ms), plain {plain_ms:.4f} ms, sdpa{dense} "
          f"{lib_ms:.4f} ms (graph replay {lib_device_ms:.4f} ms), bound "
          f"{bound:.4f} ms ({by}) on {gpu_name_and_limit()}", flush=True)
    return dict(ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, library_ms=lib_ms,
                library_device_ms=lib_device_ms, variant=case_variant(case))


def case_variant(case) -> str:
    from repro_torch.kernels import paged_attention as pa

    b, c, kh, g, d = case["q"].shape
    return pa.choose_variant(case["q"].dtype, case["k"].dtype, c * g, d,
                             case["bs"])


def tolerance(variant, dtype) -> tuple:
    """(rtol, atol) of a paged variant against the plain version: f32
    1e-4; the split-KV walk's bf16 output one bf16 rounding step (its
    scores, P and partials are f32); the tile's 2e-2 (P rounded to bf16)."""
    if dtype == torch.float32:
        return 1e-4, 1e-4
    return (2.0 ** -7, 1e-4) if variant == "split" else (2e-2, 2e-2)


def check_model(case, got, layer=0) -> tuple:
    """The kernel's output ``got`` over layer ``layer`` against the plain
    model of its variant's algebra: the split-KV walk within 1e-5 in f32
    and one bf16 step in bf16, the tile within 2e-2.  Returns (ok, detail);
    the CUDA-core walk has no model of its own (ok, "")."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels.ref import (paged_attention_split_ref,
                                         paged_attention_tile_ref)

    variant = case_variant(case)
    kp, vp, ksc, vsc = _layer(case, layer)
    q, tables, qpos, live = (case["q"], case["tables"], case["qpos"],
                             case["live"])
    if variant == "split":
        pps, nsplit = pa.split_plan(tables.shape[1], case["bs"])
        model = paged_attention_split_ref(
            q, kp, vp, tables, qpos, live, pages_per_split=pps,
            n_splits=nsplit, scale=case["scale"], k_scales=ksc, v_scales=vsc)
        rtol, atol = ((1e-5, 1e-5) if q.dtype == torch.float32
                      else tolerance(variant, q.dtype))
    elif variant == "tile":
        model = paged_attention_tile_ref(q, kp, vp, tables, qpos, live,
                                         scale=case["scale"], k_scales=ksc,
                                         v_scales=vsc)
        rtol, atol = 2e-2, 2e-2
    else:
        return True, ""
    err = (got.float() - model.float()).abs().max().item()
    ok = torch.allclose(got.float(), model.float(), rtol=rtol, atol=atol)
    name = ("paged_attention_split_ref" if variant == "split"
            else "paged_attention_tile_ref")
    return ok, (f", against {name} max_abs_err={err:.3e} (rtol {rtol:.3g} "
                f"atol {atol:.3g})")


def _save_counts():
    """Every attention launch count, so comparison launches can be taken
    off again."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa

    counters = [pa.LAUNCHES, pa.LAUNCHES_Q8, fa.LAUNCHES,
                *pa.VARIANT_LAUNCHES.values(), *fa.VARIANT_LAUNCHES.values()]
    return [(ctr, ctr.n) for ctr in counters]


def _restore_counts(saved) -> None:
    for ctr, n in saved:
        ctr.n = n


def check_attention(dtype, b, c, nblk, dev, engine_mixed=False):
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels.ref import paged_attention_chunk_ref

    layers = 8
    case = attention_case(dtype, b, c, nblk, layers, dev,
                          engine_mixed=engine_mixed)
    q, tables, qpos, live, scale = (case["q"], case["tables"], case["qpos"],
                                    case["live"], case["scale"])
    k0, v0 = case["k"][0], case["v"][0]
    got = pa.paged_attention_chunk(q, k0, v0, tables, qpos, live, scale=scale)
    want = paged_attention_chunk_ref(q, k0, v0, tables, qpos, live,
                                     scale=scale)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    rtol, atol = tolerance(case_variant(case), dtype)
    close = torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol)
    model_ok, model_detail = check_model(case, got)
    # bounded walk == unbounded walk, bitwise
    full = torch.full_like(live, nblk)
    unb = pa.paged_attention_chunk(q, k0, v0, tables, qpos, full, scale=scale)
    bitwise = torch.equal(got, unb)
    # NaN-poisoned dead table slots never reach the output
    kp, vp = k0.clone(), v0.clone()
    dead = torch.arange(nblk, device=dev)[None, :] >= live[:, None]
    dead_ids = tables[dead].long()
    kp[dead_ids] = float("nan")
    vp[dead_ids] = float("nan")
    poisoned = pa.paged_attention_chunk(q, kp, vp, tables, qpos, live,
                                        scale=scale)
    nan_safe = torch.equal(got, poisoned) and bool(torch.isfinite(got).all())
    del kp, vp
    tag = (f"paged_attention {str(dtype).split('.')[-1]} B={b} C={c} "
           f"nblk={nblk}" + (" engine mixed layout" if engine_mixed else ""))
    phase(f"{tag} vs plain", close and model_ok and bitwise and nan_safe,
          f"max_abs_err={err:.3e} (rtol {rtol:.3g} atol {atol:.3g})"
          f"{model_detail}, bounded==unbounded {bitwise}, NaN dead slots "
          f"unread {nan_safe}")
    row = dict(max_abs_err=err, **time_attention(case, layers, tag))
    if engine_mixed:
        row.update(time_pad_fix(case, layers, tag))
    return row


def time_pad_fix(case, layers, tag) -> float:
    """The engine's mixed step with its pad columns at position -1 (the
    rows the step discards see no key), as ROADMAP Queue 2 proposes: what
    the padded rows cost is the difference from the step as it is."""
    from repro_torch.kernels import paged_attention as pa

    qpos = torch.where(case["read"], case["qpos"], -1).to(torch.int32)
    it = [0]

    def kern():
        kp, vp, ksc, vsc = _layer(case, it[0] % layers)
        it[0] += 1
        pa.paged_attention_chunk(case["q"], kp, vp, case["tables"], qpos,
                                 case["live"], ksc, vsc, scale=case["scale"])

    saved = _save_counts()
    ms = time_ms(kern)
    device_ms = time_ms(kern, graph=True)
    _restore_counts(saved)
    print(f"  {tag}, pad columns at position -1: kernel {ms:.4f} ms (graph "
          f"replay {device_ms:.4f} ms)", flush=True)
    return dict(pad_at_minus_one_ms=ms, pad_at_minus_one_device_ms=device_ms)


def check_attention_int8(b, c, nblk, dev, engine_mixed=False):
    """The fused-dequant kernel over int8 pools: bf16 q against the plain
    version; f32 q against the f32 kernel on the dequantized pools,
    bitwise; NaN scales in dead table slots never read."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels.quant import dequantize_pool
    from repro_torch.kernels.ref import paged_attention_chunk_int8_ref

    layers = 8
    case = attention_case(torch.bfloat16, b, c, nblk, layers, dev, int8=True,
                          engine_mixed=engine_mixed)
    q, tables, qpos, live, scale = (case["q"], case["tables"], case["qpos"],
                                    case["live"], case["scale"])
    kq, vq, ksc, vsc = _layer(case, 0)
    got = pa.paged_attention_chunk(q, kq, vq, tables, qpos, live, ksc, vsc,
                                   scale=scale)
    want = paged_attention_chunk_int8_ref(q, kq, vq, ksc, vsc, tables, qpos,
                                          live, scale=scale)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    rtol, atol = tolerance(case_variant(case), q.dtype)
    close = torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol)
    model_ok, model_detail = check_model(case, got)
    qf = q.float()
    fused = pa.paged_attention_chunk(qf, kq, vq, tables, qpos, live, ksc,
                                     vsc, scale=scale)
    mat = pa.paged_attention_chunk(qf, dequantize_pool(kq, ksc),
                                   dequantize_pool(vq, vsc), tables, qpos,
                                   live, scale=scale)
    bitwise = torch.equal(fused, mat)
    del mat
    dead = torch.arange(nblk, device=dev)[None, :] >= live[:, None]
    dead_ids = tables[dead].long()
    ksc2, vsc2 = ksc.clone(), vsc.clone()
    ksc2[dead_ids] = float("nan")
    vsc2[dead_ids] = float("nan")
    poisoned = pa.paged_attention_chunk(q, kq, vq, tables, qpos, live, ksc2,
                                        vsc2, scale=scale)
    nan_safe = torch.equal(got, poisoned) and bool(torch.isfinite(got).all())
    tag = (f"paged_attention int8 pools, bf16 q, B={b} C={c} nblk={nblk}"
           + (" engine mixed layout" if engine_mixed else ""))
    phase(f"{tag} vs plain", close and model_ok and bitwise and nan_safe,
          f"max_abs_err={err:.3e} (rtol {rtol:.3g} atol {atol:.3g})"
          f"{model_detail}, f32 q fused == f32 kernel on dequantized pools "
          f"{bitwise}, NaN dead scales unread {nan_safe}")
    row = dict(max_abs_err=err, **time_attention(case, layers, tag))
    if engine_mixed:
        row.update(time_pad_fix(case, layers, tag))
    return row


def check_flash(b, t, h, kh, d, dtype, causal, gen, dev, tol, tag):
    """Dense flash attention against its plain version, timed beside
    ``scaled_dot_product_attention(enable_gqa=True)`` and its bound: 4 * D
    flops per visible (query, key) pair and head at the input type's peak,
    or q, k, v and out once over HBM."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_attention_ref

    q = torch.randn((b, t, h, d), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, t, kh, d), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, t, kh, d), generator=gen, device=dev).to(dtype)
    got = fa.flash_attention(q, k, v, causal=causal)
    want = flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    close = torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
    finite = bool(torch.isfinite(got).all())
    del want
    name = (f"flash_attention {tag}: {str(dtype).split('.')[-1]} "
            f"{'causal' if causal else 'non-causal'} B={b} T={t} H={h} "
            f"KH={kh} D={d}")
    phase(f"{name} vs plain", close and finite and got.shape == q.shape,
          f"max_abs_err={err:.3e} (tol {tol}), finite={finite}")
    saved = _save_counts()
    kern = lambda: fa.flash_attention(q, k, v, causal=causal)  # noqa: E731
    ms = time_ms(kern, reps=10, warmup=2)
    device_ms = time_ms(kern, reps=10, warmup=2, graph=True)
    plain_ms = time_ms(lambda: flash_attention_ref(q, k, v, causal=causal),
                       reps=3, warmup=1)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))  # (B, heads, T, D)
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=causal, enable_gqa=True)
    lib_ms = time_ms(lib)
    lib_device_ms = time_ms(lib, graph=True)
    _restore_counts(saved)  # comparison launches do not count
    pairs = t * (t + 1) // 2 if causal else t * t
    t_ops = 4 * d * h * b * pairs / PEAK_OPS[dtype] * 1e3
    t_bytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size() \
        / HBM_BPS * 1e3
    bound, by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    variant = fa.choose_variant(dtype, d)
    print(f"  {name} [{variant}]: kernel {ms:.4f} ms (graph replay "
          f"{device_ms:.4f} ms), plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} "
          f"ms (graph replay {lib_device_ms:.4f} ms), bound {bound:.4f} ms "
          f"({by}) on {gpu_name_and_limit()}", flush=True)
    return dict(max_abs_err=err, ms=ms, device_ms=device_ms,
                plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=lib_ms, library_device_ms=lib_device_ms,
                variant=variant)


def check_era_scan(r, s, gen, dev):
    from repro_torch.core.era_table import _can_delete_numpy, batched_can_delete
    from repro_torch.kernels import era_scan as es
    from repro_torch.kernels.ref import INF_ERA32, era_scan_interval_ref

    rng = np.random.default_rng(SEED)
    alloc = rng.integers(0, 1000, r).astype(np.int32)
    retire = (alloc + rng.integers(0, 100, r)).astype(np.int32)
    lo = rng.integers(0, 1100, s).astype(np.int32)
    hi = np.where(rng.random(s) < 0.5, lo, lo + rng.integers(0, 40, s)
                  ).astype(np.int32)
    lo[rng.random(s) < 0.95] = INF_ERA32  # mostly empty slots, as in serving
    want = _can_delete_numpy(alloc, retire, lo, hi)
    t = [torch.from_numpy(a).to(dev) for a in (alloc, retire, lo, hi)]
    got = es.era_scan_interval(*t).cpu().numpy()
    backend = batched_can_delete(alloc, retire, lo, hi, backend="cuda")
    ok = np.array_equal(got, want) and np.array_equal(backend, want)
    phase(f"era_scan R={r} S={s} vs numpy", ok,
          f"bit-identical {ok}, {int(want.sum())} of {r} deletable")
    saved = es.LAUNCHES.n
    ms = time_ms(lambda: es.era_scan_interval(*t), reps=50)
    device_ms = time_ms(lambda: es.era_scan_interval(*t), reps=50, graph=True)
    plain_ms = time_ms(lambda: era_scan_interval_ref(*t), reps=20)
    t0 = time.perf_counter()
    for _ in range(20):
        batched_can_delete(alloc, retire, lo, hi, backend="cuda")
    backend_ms = (time.perf_counter() - t0) / 20 * 1e3
    t0 = time.perf_counter()
    for _ in range(20):
        batched_can_delete(alloc, retire, lo, hi, backend="numpy")
    numpy_ms = (time.perf_counter() - t0) / 20 * 1e3
    es.LAUNCHES.n = saved
    nbytes = 4 * (2 * r + 2 * s) + r
    ops = 4 * r * s  # three compares and one OR per (block, slot) pair
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = ops / PEAK_OPS[torch.int32] * 1e3
    bound, by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    print(f"  era_scan R={r} S={s}: kernel {ms:.4f} ms (graph replay "
          f"{device_ms:.4f} ms), plain {plain_ms:.4f} ms, bound {bound:.6f} ms ({by}); cuda backend from NumPy "
          f"mirrors {backend_ms:.4f} ms (host clock), numpy backend "
          f"{numpy_ms:.4f} ms (host clock)", flush=True)
    return dict(max_abs_err=float(np.abs(got.astype(int) - want.astype(int)).max()),
                ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, library_ms=None,
                library_device_ms=None)


# ------------------------------------------------------------ phase 3: engine
def trace(n_req: int, lo: int, hi: int, vocab: int, salt: int = 0):
    """Seeded prompts: lengths from SEED, tokens from (SEED, salt), so two
    salts give the same lengths and share no cached prefix."""
    lens = np.random.default_rng(SEED).integers(lo, hi + 1, n_req)
    rng = np.random.default_rng([SEED, salt])
    return [rng.integers(0, vocab, int(n)).tolist() for n in lens]


def serve_full_width(dev):
    """Phases 3 and 3b: the seeded trace on full-width stablelm-3b, with
    bf16 pages and then, on the same weights, int8 pages.  Returns each
    run's launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    cfg = get_config("stablelm-3b")  # full width, 32 layers, bf16
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    params = init_params(cfg, gen, device=dev)
    n_params = sum(t.numel() for t in _leaves(params))
    torch.cuda.synchronize()
    print(f"  stablelm-3b full width: {n_params} params in {cfg.dtype}, "
          f"init {time.perf_counter() - t0:.1f} s", flush=True)
    launches, toks = serve_trace(cfg, params, dev, kv_dtype=None)
    launches_q8, toks_q8 = serve_trace(cfg, params, dev, kv_dtype="int8")
    match = sum(a == b for x, y in zip(toks, toks_q8) for a, b in zip(x, y))
    total = sum(map(len, toks))
    # random weights: near-tie argmaxes flip freely, so no floor is set
    print(f"  int8 vs bf16 pages, greedy token match: {match}/{total} "
          f"({match / total:.3f})", flush=True)
    del params
    torch.cuda.empty_cache()
    return launches, launches_q8


def serve_trace(cfg, params, dev, kv_dtype):
    """Serve the 32-request trace with ``kv_dtype`` pages (None: the model's
    bf16) and check the serving invariants and that the path launched its
    kernels and no other attention kernel.  Returns (launch counts,
    generated tokens per request)."""
    from repro_torch.kernels import era_scan as es
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.serve import ServeEngine

    n_blocks, bs, new = 2048, 16, 64
    engine = ServeEngine(cfg, params, n_blocks=n_blocks, block_size=bs,
                         max_batch=8, chunk_size=256, scheme="WFE",
                         use_kernel=True, kv_dtype=kv_dtype, device=dev)
    tid = engine.pool.register_thread()
    prompts = trace(32, 64, 1024, cfg.vocab_size)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    by_kind, wrong, unwrap = variants_by_plan_kind(engine)
    # the main path's launch counts: zeroed just before, read just after
    pa.LAUNCHES.n = pa.LAUNCHES_Q8.n = es.LAUNCHES.n = 0
    for ctr in pa.VARIANT_LAUNCHES.values():
        ctr.n = 0
    t0 = time.perf_counter()
    reqs = [engine.submit(p, max_new_tokens=new) for p in prompts]
    stats = engine.run(tid)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"paged_attention_chunk": pa.LAUNCHES.n,
                "paged_attention_chunk_int8": pa.LAUNCHES_Q8.n,
                "era_scan_interval": es.LAUNCHES.n}
    variants = {k: ctr.n for k, ctr in pa.VARIANT_LAUNCHES.items()}
    unwrap()
    attn = ("paged_attention_chunk_int8" if kv_dtype == "int8"
            else "paged_attention_chunk")
    path = {attn, "era_scan_interval"}
    gen_tokens = sum(len(r.generated) for r in reqs)
    toks_ok = all(len(r.generated) == new and
                  all(0 <= t < cfg.vocab_size for t in r.generated)
                  for r in reqs)
    # decode steps take the split-KV walk and its combine and nothing
    # else, mixed and prefill steps the tensor-core tile (a chunk of fewer
    # than 16 columns takes the split walk); no call off its variant, no
    # CUDA-core walk
    kinds_ok = (not wrong and set(by_kind) == {"decode", "mixed", "prefill"}
                and by_kind["decode"]["split"] > 0
                and by_kind["decode"]["tile"] == 0
                and by_kind["mixed"]["tile"] > 0
                and by_kind["prefill"]["tile"] > 0
                and all(v["cuda_core"] == 0 for v in by_kind.values()))
    ok = (stats["completed"] == 32 and engine.pool.unreclaimed() == 0
          and engine.pool.free_blocks == n_blocks and toks_ok and kinds_ok
          and all((n > 0) == (k in path) for k, n in launches.items()))
    steps = stats["steps"]
    label = kv_dtype or "bf16"
    phase(f"serve stablelm-3b full width, {label} pages, 32 requests", ok,
          f"completed={stats['completed']} unreclaimed="
          f"{engine.pool.unreclaimed()} free_blocks={engine.pool.free_blocks}"
          f"/{n_blocks} launches={launches} steps={steps} "
          f"prompt_tokens={sum(map(len, prompts))} generated={gen_tokens}")
    print(f"  launches by variant ({label} pages): {variants}; by plan "
          f"kind: {by_kind}; plans off their expected variant: {wrong}",
          flush=True)
    kv_bytes = sum(t.numel() * t.element_size() for t in engine.pools.values())
    print(f"  serve ({label} pages): {dt:.3f} s wall, {gen_tokens / dt:.2f} "
          f"output tokens/s, {dt / steps * 1e3:.2f} ms/step over {steps} "
          f"steps ({stats['mixed_steps']} mixed), peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, KV pools "
          f"{kv_bytes / 2**30:.3f} GiB = "
          f"{kv_bytes / ((n_blocks + 1) * bs):.0f} B/token (scales included) "
          f"on {gpu_name_and_limit()}", flush=True)
    profile_window(engine, tid, cfg)
    generated = [r.generated for r in reqs]
    del engine
    torch.cuda.empty_cache()
    return dict({k: launches[k] for k in sorted(path)}, by_kind=by_kind,
                **variants), generated


def variants_by_plan_kind(engine):
    """Record which paged-attention variants each wrapper call launched,
    by the kind of the plan it ran in: ``engine.execute_plan`` (on the
    instance) notes the kind, and a wrapper around
    ``paged_attention.paged_attention_chunk`` reads the variant counters
    around the call and holds what moved against ``choose_variant`` of the
    shapes the call was given.  Returns ({kind: {variant: launches}},
    [calls that launched another variant], a function that removes both
    wrappers), the first two filled as the engine runs."""
    from repro_torch.kernels import paged_attention as pa

    by_kind: dict = {}
    wrong: list = []
    kind = [None]
    run_plan, chunk = engine.execute_plan, pa.paged_attention_chunk

    def execute_plan(plan, tid):
        kind[0] = plan.kind
        by_kind.setdefault(plan.kind, dict.fromkeys(pa.VARIANT_LAUNCHES, 0))
        return run_plan(plan, tid)

    def paged_attention_chunk(q, k_pool, *args, **kwargs):
        before = {k: ctr.n for k, ctr in pa.VARIANT_LAUNCHES.items()}
        out = chunk(q, k_pool, *args, **kwargs)
        used = {k for k, ctr in pa.VARIANT_LAUNCHES.items()
                if ctr.n > before[k]}
        counts = by_kind.setdefault(kind[0],
                                    dict.fromkeys(pa.VARIANT_LAUNCHES, 0))
        for k in used:
            counts[k] += pa.VARIANT_LAUNCHES[k].n - before[k]
        b, c, kh, g, d = q.shape
        want = pa.choose_variant(q.dtype, k_pool.dtype, c * g, d,
                                 k_pool.shape[1])
        if used != ({"split", "combine"} if want == "split" else {want}):
            wrong.append((kind[0], tuple(q.shape), want, sorted(used)))
        return out

    def unwrap():
        del engine.execute_plan  # the class's own again
        pa.paged_attention_chunk = chunk

    engine.execute_plan = execute_plan
    pa.paged_attention_chunk = paged_attention_chunk
    return by_kind, wrong, unwrap


def _window(engine, tid, cfg, salt):
    """Serve 8 requests (256-768-token prompts, 16 new tokens) through the
    engine's own tick/execute_plan, timing each step on the host clock by
    plan kind.  Returns (wall seconds, {kind: [seconds]})."""
    for p in trace(8, 256, 768, cfg.vocab_size, salt):
        engine.submit(p, max_new_tokens=16)
    by_kind: dict = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10_000):
        if not (engine.sched.pending() or engine.sched.active):
            break
        plan = engine.sched.tick(tid)
        if plan is None:
            engine.pool.cleanup_all()
            continue
        ts = time.perf_counter()
        engine.execute_plan(plan, tid)
        by_kind.setdefault(plan.kind, []).append(time.perf_counter() - ts)
    engine.drain(tid)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, by_kind


def profile_window(engine, tid, cfg):
    """Where the time goes: one 8-request window timed by step kind without
    the profiler, then the same lengths (other tokens) under torch.profiler
    for the device time by kernel; the device's idle share is 1 - device
    time / the unprofiled window's wall time."""
    from torch.profiler import ProfilerActivity, profile

    wall, by_kind = _window(engine, tid, cfg, salt=1)
    kinds = ", ".join(f"{k}: {len(v)} steps, mean {np.mean(v) * 1e3:.2f} ms"
                      for k, v in sorted(by_kind.items()))
    print(f"  window: {wall:.3f} s wall; {kinds}", flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _window(engine, tid, cfg, salt=2)
    names: dict = {}
    groups = {"paged_attention kernel": 0.0,
              "paged_attention int8 kernel": 0.0, "split combine": 0.0,
              "era_scan kernel": 0.0,
              "GEMM (cuBLAS)": 0.0, "copies": 0.0, "other kernels": 0.0}
    for evt in prof.key_averages():
        if evt.device_type.name != "CUDA":  # host ops: their kernels count
            continue                        # as events of their own
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        name = evt.key.lower()
        names[evt.key[:60]] = names.get(evt.key[:60], 0.0) + us
        if "split_combine" in name:
            groups["split combine"] += us
        elif "paged_" in name and "signed char" in name:
            groups["paged_attention int8 kernel"] += us
        elif "paged_" in name:
            groups["paged_attention kernel"] += us
        elif "era_scan_kernel" in name:
            groups["era_scan kernel"] += us
        elif "memcpy" in name or "memset" in name:
            groups["copies"] += us
        elif any(t in name for t in ("gemm", "xmma", "cutlass", "sm90_", "nvjet")):
            groups["GEMM (cuBLAS)"] += us
        else:
            groups["other kernels"] += us
    busy = sum(groups.values()) / 1e6
    if busy == 0:
        print("  profile: device time not measured (no CUDA events)")
        return
    shares = ", ".join(f"{k} {v / 1e6:.3f} s ({v / 1e6 / wall:.1%})"
                       for k, v in groups.items())
    print(f"  device time by kind (profiled window) against the unprofiled "
          f"{wall:.3f} s: {shares}; device busy {busy / wall:.1%}, idle "
          f"{1 - busy / wall:.1%}", flush=True)
    top = sorted(names.items(), key=lambda kv: -kv[1])[:8]
    print("  top device kernels: " + "; ".join(
        f"{k} {v / 1e3:.1f} ms" for k, v in top), flush=True)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def step_matches_cpu(dev):
    """Full-width, 2-layer fp32 model: one prefill chunk and one decode
    step on the card (CUDA kernels) against the same step on the CPU
    (plain versions), from the same weights and pools."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serve import init_pools, paged_decode_step, paged_prefill_chunk

    cfg = get_config("stablelm-3b").scaled(n_layers=2, dtype=torch.float32)
    params = init_params(cfg, torch.Generator().manual_seed(SEED), device="cpu")
    bs, n = 16, 16
    prompt = torch.tensor([trace(1, 100, 100, cfg.vocab_size)[0]],
                          dtype=torch.int32)
    c = prompt.shape[1]
    tables = torch.arange(8, dtype=torch.int32)[None, :]
    pos = torch.arange(c, dtype=torch.int32)[None, :]
    out = {}
    for d in ("cpu", dev):
        p = {k: _to(v, d) for k, v in params.items()}
        pools = init_pools(cfg, n, bs, device=d)
        lg1, _ = paged_prefill_chunk(cfg, p, pools, tables.to(d),
                                     prompt.to(d), pos.to(d))
        nxt = torch.argmax(lg1, dim=-1).to(torch.int32)
        lg2, _ = paged_decode_step(
            cfg, p, pools, tables.to(d), torch.tensor([c + 1], dtype=torch.int32, device=d),
            nxt.to(d), torch.tensor([c], dtype=torch.int32, device=d))
        out[str(d)] = (lg1.cpu(), lg2.cpu())
    (a1, a2), (b1, b2) = out["cpu"], out[str(dev)]
    err = max((a1 - b1).abs().max().item(), (a2 - b2).abs().max().item())
    finite = bool(torch.isfinite(b1).all() and torch.isfinite(b2).all())
    shape_ok = b1.shape == (1, cfg.vocab_size) and b2.shape == (1, cfg.vocab_size)
    tol = 2e-3
    phase("full-width 2-layer fp32 step: CUDA vs CPU plain path",
          err <= tol and finite and shape_ok,
          f"max_abs_err={err:.3e} (tol {tol}), finite={finite}")


def _to(tree, d):
    if isinstance(tree, dict):
        return {k: _to(v, d) for k, v in tree.items()}
    return tree.to(d)


def forced_slow_path(dev):
    from repro_torch.configs import get_config
    from repro_torch.kernels import era_scan as es
    from repro_torch.models import init_params
    from repro_torch.serve import ServeEngine

    cfg = get_config("stablelm-3b").scaled(n_layers=2)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                         device=dev)
    engine = ServeEngine(cfg, params, n_blocks=64, block_size=16, max_batch=4,
                         chunk_size=64, scheme="WFE", use_kernel=True,
                         device=dev, vectorized_threshold=1, era_freq=1,
                         cleanup_freq=1, max_attempts=1)
    tid = engine.pool.register_thread()
    before = es.LAUNCHES.n
    reqs = [engine.submit(p, 8) for p in trace(8, 16, 96, cfg.vocab_size)]
    stats = engine.run(tid)
    slow = engine.pool.smr.stats()["slow_paths"]
    scans = es.LAUNCHES.n - before
    ok = (stats["completed"] == len(reqs) and slow > 0 and scans > 0
          and engine.pool.unreclaimed() == 0 and engine.pool.free_blocks == 64)
    phase("WFE forced slow path, 2 layers", ok,
          f"completed={stats['completed']} slow_paths={slow} "
          f"era_scan launches={scans} unreclaimed={engine.pool.unreclaimed()}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    lib = build.build(verbose=True)
    phase("build", True, f"{lib.name} in {time.perf_counter() - t0:.1f} s "
          f"from {len(build.sources())} sources")
    print(gpu_name_and_limit(), flush=True)

    gen = torch.Generator(device=dev).manual_seed(SEED)
    attn = {}
    for dtype in (torch.float32, torch.bfloat16):
        # decode (C == 1, B == max_batch) and a mixed step (max_batch + 1
        # rows of one 256-token chunk bucket); table width bucket 128
        for b, c in ((8, 1), (9, 256)):
            attn[(dtype, c)] = check_attention(dtype, b, c, 128, dev)
    for b, c in ((8, 1), (9, 256)):
        attn[("int8", c)] = check_attention_int8(b, c, 128, dev)
    # the engine's own mixed step: 8 decode rows padded to the 256-column
    # bucket at their decode positions, and one 256-token chunk
    attn[(torch.bfloat16, "engine")] = check_attention(
        torch.bfloat16, 9, 256, 128, dev, engine_mixed=True)
    attn[("int8", "engine")] = check_attention_int8(9, 256, 128, dev,
                                                    engine_mixed=True)
    torch.cuda.empty_cache()
    # dense flash attention: prefill of stablelm-3b (MHA, D 80) and of
    # starcoder2-3b (GQA 24 / 2, D 128; src/repro/configs/starcoder2_3b.py),
    # and an f32 non-causal GQA case
    flash = check_flash(1, 4096, 32, 32, 80, torch.bfloat16, True, gen, dev,
                        2e-2, "stablelm-3b prefill")
    flash_gqa = check_flash(1, 4096, 24, 2, 128, torch.bfloat16, True, gen,
                            dev, 2e-2, "starcoder2-3b prefill")
    check_flash(2, 1024, 8, 2, 64, torch.float32, False, gen, dev, 1e-4,
                "GQA")
    torch.cuda.empty_cache()
    scan = check_era_scan(4096, 512, gen, dev)
    check_era_scan(4096, 5120, gen, dev)  # kernel_bench.py:38 (T 512 x H 10)
    check_era_scan(64, 64, gen, dev)      # the engine's scans: 8 threads x 8 slots
    torch.cuda.empty_cache()

    launches, launches_q8 = serve_full_width(dev)
    step_matches_cpu(dev)
    forced_slow_path(dev)

    # one row per (kernel, main-path shape) under the kernel's own name;
    # the first row of each name is at the shape earlier versions of this
    # line reported (decode, bf16 q), ``case`` and ``variant`` say which
    # shape and kernel variant a row is.  ``launches``: that variant's
    # launches in the serving run whose path it is on (bf16 or int8 pages);
    # flash attention and the f32 query's paths are on no serving path
    paged = "src/repro_torch/kernels/csrc/paged_attention.cu"
    rows = [
        ("paged_attention_chunk", 148, "decode B 8 C 1, bf16 q",
         launches["split"], attn[(torch.bfloat16, 1)]),
        ("paged_attention_chunk", 148, "mixed B 9 C 256, bf16 q",
         launches["tile"], attn[(torch.bfloat16, 256)]),
        ("paged_attention_chunk", 148, "engine mixed step, bf16 q",
         launches["by_kind"]["mixed"]["tile"],
         attn[(torch.bfloat16, "engine")]),
        ("paged_attention_chunk", 148, "decode B 8 C 1, f32 q", 0,
         attn[(torch.float32, 1)]),
        ("paged_attention_chunk", 148, "mixed B 9 C 256, f32 q",
         launches["cuda_core"], attn[(torch.float32, 256)]),
        ("paged_attention_chunk_int8", 129, "decode B 8 C 1, bf16 q",
         launches_q8["split"], attn[("int8", 1)]),
        ("paged_attention_chunk_int8", 129, "mixed B 9 C 256, bf16 q",
         launches_q8["tile"], attn[("int8", 256)]),
        ("paged_attention_chunk_int8", 129, "engine mixed step, bf16 q",
         launches_q8["by_kind"]["mixed"]["tile"], attn[("int8", "engine")]),
    ]
    kernels = [dict(name=name, route="cuda", source=paged,
                    replaces=f"src/repro/kernels/paged_attention.py:{line}",
                    launches=n, case=case, **row)
               for name, line, case, n, row in rows]
    kernels[0]["launches_combine"] = launches["combine"]
    kernels[3]["on_main_path"] = kernels[4]["on_main_path"] = False
    kernels[5]["launches_combine"] = launches_q8["combine"]
    flash_src = dict(route="cuda",
                     source="src/repro_torch/kernels/csrc/flash_attention.cu",
                     replaces="src/repro/kernels/flash_attention.py:83",
                     launches=0, on_main_path=False)
    kernels += [
        dict(name="era_scan_interval", route="cuda",
             source="src/repro_torch/kernels/csrc/era_scan.cu",
             replaces="src/repro/kernels/era_scan.py:96",
             launches=launches["era_scan_interval"], case="R 4096 S 512",
             **scan),
        dict(name="flash_attention", case="stablelm-3b prefill", **flash_src,
             **flash),
        dict(name="flash_attention", case="starcoder2-3b prefill",
             **flash_src, **flash_gqa),
    ]
    if FAILED:
        print(f"chip_smoke: FAILED phases: {FAILED}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
