"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for an H100).

Run from the repository root:  python3 chip_smoke.py

Phases, each printing its own line; any failure exits non-zero:

1. Build every CUDA kernel from ``src/repro_torch/kernels/csrc`` with nvcc
   for sm_90a (one nvcc per source, started together) and print the card's
   name and power limit.
2. The era scan at five shapes (``ERA_SHAPES``: R 4096 x S 512 and
   x S 5120, R 64 x S 64, R 65536 x S 5120 with 5% and 50% of the slots
   valid), every reservation form in one slot vector: the kernel, its
   plain version and the ``cuda`` backend the pool calls, each bitwise
   against the NumPy backend; eager, graph-replay and pool-call times,
   and its bound over valid pairs and over all pairs.
   Then hold each kernel variant against its plain PyTorch version at main-path
   shapes (stablelm-3b: KH 32, G 1, head_dim 80, block_size 16), time
   kernel, plain version and the PyTorch library yardstick, and compute
   each kernel's bound (the least time the card could take for the same
   work): paged attention over bf16/f32 and over int8 pools at decode
   (the split-KV walk) and at a mixed step (the tensor-core tile; the f32
   query's CUDA-core walk), also in the engine's own mixed layout (decode
   rows padded to the chunk bucket); dense flash attention at the
   stablelm-3b and starcoder2-3b prefill shapes.  The split-KV walk
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
   weights with int8 KV pages; then (3c) the 8-request profile-window
   trace once under each pool scheme (WFE, Crystalline, HE, EBR, 2GEIBR),
   bf16 pages: each completes 8/8, drains, launches the era scan and emits
   the WFE run's greedy tokens.
4. The sharded engine and the multi-worker runtime on the same weights,
   with phase 3's engine split over 2 shards of 1024 blocks (each with its
   own device pool, scratch slot and CUDA stream), every launch count
   zeroed just before a run and read just after.  A run on one thread
   holds each paged-attention call's launched variant against
   ``choose_variant`` of its shapes; a run with several workers holds the
   launch counts against the tally of those picks.
   4a one worker: the 32-request trace with bf16 pages, then the 8-request
      window with int8 pages; each completes at full length, drains, steps
      both shards, launches split + combine on decode plans and the tile on
      mixed and prefill plans and the era scan; token match against phase
      3 printed;
   output tokens/s on the window for 1 x 1, 1 x 2, 2 x 2 and 4 x 2 workers
      x shards, then again in reverse order;
   4b every freed slot poisoned (K = NaN, V = 1e30) on a side stream at the
      earliest reuse: one worker emits the clean run's tokens exactly, two
      workers fail no request and sample only from finite logits;
   4c ``ServeRuntime`` with 2 workers on the 32-request trace and 4 on the
      window: every worker productive, no failed row; the era scan with the
      most valid slots printed;
   4d chaos (``CHAOS_SPEC``) on the 32 requests: 3 crashes, 3 respawns, a
      requeue, exactly one failed request, the rest complete, the pool
      drains; recovery p50;
   the device's idle share of the window with 2 workers (union of device
      intervals);
   4e ``Frontend(ServeRuntime(engine, n_workers=2))`` over the full-width
      2-shard engine in this process: an SSE stream, a disconnect and a
      DELETE cancellation, then the rolling drain, with the kernels'
      launches held; then ``python -m repro_torch.serve.frontend
      --selftest`` and ``python -m repro_torch.launch.serve --requests 8``
      with ``--shards 2 --workers 2``, each in a process of its own at the
      reference's smoke size, on CUDA by default.
5. The model step against the plain path on the CPU at full width and
   reduced depth, and a WFE forced-slow-path run at reduced depth.

The line before the last is the ``kernels`` JSON line (each row with
``launches_runtime``, its launches in 4c's 2-worker run); the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device the script exits
non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import threading
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


#: the era scan's shapes (retired rows R, slots S, share of valid slots):
#: R 4096 x S 512 and R 4096 x S 5120 (kernel_bench.py:38, T 512 x H 10)
#: as before, R 64 x S 64 (the engine's scans: 8 threads x 8 slots), and
#: R 65536 x S 5120, the "tens of thousands of retiring blocks per tick" of
#: repro/kernels/era_scan.py:3-6, with 5% and 50% of the slots valid
ERA_SHAPES = ((4096, 512, 0.05), (4096, 5120, 0.05), (64, 64, 0.05),
              (65536, 5120, 0.05), (65536, 5120, 0.5))


def era_cases() -> dict:
    """The era-scan inputs of every shape, NumPy int32, from
    ``tests/torch_era_cases.py`` (every reservation form in one slot
    vector)."""
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_era_cases import sample_case

    return {shape: sample_case(*shape, seed=SEED) for shape in ERA_SHAPES}


def _host_ms(fn, reps: int) -> float:
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


#: int32 instructions one pair of a retired row and a slot needs: two
#: compares (ISETP, the second taking the first's predicate as its AND
#: input) and half a three-input predicate OR (one PLOP3 folds two pairs
#: into a row's conflict bit), as in the scan's compiled inner loop
#: (``cuobjdump -sass`` of the built library)
ERA_PAIR_OPS = 2.5


def check_era_scan(case, dev):
    """The era scan at one shape: the kernel, the plain version and the
    ``cuda`` backend from the NumPy mirrors, each bitwise against the
    NumPy backend; timed eager (``ms``), from a CUDA-graph replay
    (``device_ms``), and through the backend the pool calls (``pool_ms``,
    host clock) beside the ``numpy`` backend.  Two bounds, at
    ``ERA_PAIR_OPS`` int32 operations per pair: pairs of a retired row and
    a VALID slot (``bound_ms``, the work the function needs), and pairs of
    a row and any slot (``bound_all_pairs_ms``, the count before the
    redesign); bytes (each input read once, the mask written once) bound
    neither."""
    from repro_torch.core.era_table import (_can_delete_numpy,
                                            batched_can_delete)
    from repro_torch.kernels import era_scan as es
    from repro_torch.kernels.ref import INF_ERA32, era_scan_interval_ref

    alloc, retire, lo, hi = case
    r, s = len(alloc), len(lo)
    valid = int(np.count_nonzero(lo != INF_ERA32))
    want = _can_delete_numpy(alloc, retire, lo, hi)
    t = [torch.from_numpy(a).to(dev) for a in (alloc, retire, lo, hi)]
    saved = es.LAUNCHES.n
    kern = lambda: es.era_scan_interval(*t)  # noqa: E731
    got = kern().cpu().numpy()
    backend = batched_can_delete(alloc, retire, lo, hi, backend="cuda")
    plain = era_scan_interval_ref(*t).cpu().numpy()
    ok = all(np.array_equal(x, want) for x in (got, backend, plain))
    phase(f"era_scan R={r} S={s} ({valid} valid) vs numpy", ok,
          f"bit-identical {ok} (kernel, cuda backend, plain), "
          f"{int(want.sum())} of {r} deletable")
    ms = time_ms(kern, reps=50)
    device_ms = time_ms(kern, reps=50, graph=True)
    plain_ms = time_ms(lambda: era_scan_interval_ref(*t), reps=10)
    big = r * s > 10 ** 7
    pool_ms = _host_ms(lambda: batched_can_delete(alloc, retire, lo, hi,
                                                  backend="cuda"), 50)
    numpy_ms = _host_ms(lambda: batched_can_delete(alloc, retire, lo, hi,
                                                   backend="numpy"),
                        3 if big else 20)
    es.LAUNCHES.n = saved  # comparison launches do not count
    nbytes = 4 * (2 * r + 2 * s) + r
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = ERA_PAIR_OPS * r * valid / PEAK_OPS[torch.int32] * 1e3
    t_all = ERA_PAIR_OPS * r * s / PEAK_OPS[torch.int32] * 1e3
    bound, by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    print(f"  era_scan R={r} S={s} valid={valid}: kernel {ms:.4f} ms (graph "
          f"replay {device_ms:.4f} ms), plain {plain_ms:.4f} ms, bound "
          f"{bound:.3e} ms ({by}, valid pairs; {t_all:.3e} ms over all "
          f"pairs, {t_bytes:.3e} ms of bytes); pool call (cuda backend from "
          f"NumPy mirrors) {pool_ms:.4f} ms, numpy backend {numpy_ms:.4f} ms "
          f"(host clock) on {gpu_name_and_limit()}", flush=True)
    err = np.abs(np.stack([got, backend]).astype(int) - want.astype(int))
    return dict(max_abs_err=float(err.max(initial=0)), ms=ms,
                device_ms=device_ms, pool_ms=pool_ms, numpy_ms=numpy_ms,
                plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                bound_all_pairs_ms=t_all, library_ms=None,
                library_device_ms=None, valid_slots=valid)


def era_scan_phase(dev, cases) -> list:
    rows = []
    for shape, case in cases.items():
        r, s, v = shape
        rows.append(dict(case=f"R {r} S {s}, {v:.0%} valid slots",
                         **check_era_scan(case, dev)))
    torch.cuda.empty_cache()
    return rows


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
    bf16 = serve_trace(cfg, params, dev, kv_dtype=None)
    int8 = serve_trace(cfg, params, dev, kv_dtype="int8")
    # random weights: near-tie argmaxes flip freely, so no floor is set
    print(f"  int8 vs bf16 pages, greedy token match: "
          f"{token_match(bf16['tokens'], int8['tokens'])}", flush=True)
    schemes = serve_schemes(cfg, params, dev)
    runtime = serve_runtime_phase(cfg, params, dev, bf16, int8)
    del params
    torch.cuda.empty_cache()
    return bf16["launches"], int8["launches"], schemes, runtime


def token_match(want, got) -> str:
    """'matching/total (share)' of two runs' greedy tokens, request by
    request."""
    match = sum(a == b for x, y in zip(want, got) for a, b in zip(x, y))
    total = sum(map(len, want))
    return f"{match}/{total} ({match / total:.3f})"


#: the pool schemes of the reference (tests/test_serve_runtime.py:25); HP
#: is refused by the pool and Leak never frees, so neither serves
POOL_SCHEMES = ("WFE", "Crystalline", "HE", "EBR", "2GEIBR")


def serve_schemes(cfg, params, dev) -> dict:
    """Phase 3c: the 8-request profile-window trace (prompts of 256-768
    tokens, 16 new tokens each) on the same full-width weights with bf16
    pages and ``use_kernel=True``, once under each pool scheme at the
    engine's defaults.  Each run must complete 8/8, drain to zero
    unreclaimed blocks with every block free, launch the era scan and the
    paged-attention kernel (counts zeroed just before the run, read just
    after), and emit the WFE run's greedy tokens: the scheme decides when
    a page is reused, never what a step computes.  Returns each scheme's
    era-scan launches and its largest scan's (rows, valid slots)."""
    from repro_torch.kernels import era_scan as es
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels.ref import INF_ERA32
    from repro_torch.serve import ServeEngine

    n_blocks = 2048
    scans: list = []
    scan = ops.can_delete_blocks_interval

    def recorded(alloc, retire, lo, hi, **kwargs):
        if len(alloc):  # an empty scan launches nothing
            scans.append((len(alloc), int(np.count_nonzero(
                np.asarray(lo) != INF_ERA32))))
        return scan(alloc, retire, lo, hi, **kwargs)

    out, first = {}, None
    ops.can_delete_blocks_interval = recorded  # the era table's lookup
    try:
        for scheme in POOL_SCHEMES:
            engine = ServeEngine(cfg, params, n_blocks=n_blocks,
                                 block_size=16, max_batch=8, chunk_size=256,
                                 scheme=scheme, use_kernel=True, device=dev)
            tid = engine.pool.register_thread()
            scans.clear()
            es.LAUNCHES.n = pa.LAUNCHES.n = pa.LAUNCHES_Q8.n = 0
            wall, by_kind, reqs = _window(engine, tid, cfg, salt=1)
            scan_n, attn_n = es.LAUNCHES.n, pa.LAUNCHES.n
            toks = [r.generated for r in reqs]
            first = toks if first is None else first
            stats = engine.sched.stats
            largest = max(scans, default=(0, 0))
            gen = sum(map(len, toks))
            ok = (stats["completed"] == 8 and engine.pool.unreclaimed() == 0
                  and engine.pool.free_blocks == n_blocks and scan_n > 0
                  and attn_n > 0 and pa.LAUNCHES_Q8.n == 0
                  and len(scans) == scan_n and toks == first
                  and all(len(t) == 16 for t in toks))
            phase(f"serve stablelm-3b full width, {scheme}, 8 requests", ok,
                  f"completed={stats['completed']} unreclaimed="
                  f"{engine.pool.unreclaimed()} free_blocks="
                  f"{engine.pool.free_blocks}/{n_blocks} era_scan launches="
                  f"{scan_n} paged_attention launches={attn_n} tokens == "
                  f"WFE run's {toks == first}")
            kinds = ", ".join(f"{k}: {len(v)} steps, mean "
                              f"{np.mean(v) * 1e3:.2f} ms"
                              for k, v in sorted(by_kind.items()))
            print(f"  {scheme}: largest scan {largest[0]} retired rows x "
                  f"{largest[1]} valid slots over {len(scans)} scans; host "
                  f"clock (spreads widely between calls): {gen / wall:.2f} "
                  f"output tokens/s, {wall:.3f} s wall; {kinds}", flush=True)
            out[scheme] = dict(era_scan_launches=scan_n,
                               largest_scan=list(largest))
            del engine
            torch.cuda.empty_cache()
    finally:
        ops.can_delete_blocks_interval = scan
    return out


def serve_trace(cfg, params, dev, kv_dtype):
    """Serve the 32-request trace with ``kv_dtype`` pages (None: the model's
    bf16) and check the serving invariants and that the path launched its
    kernels and no other attention kernel.  Returns the launch counts, the
    generated tokens per request, output tokens/s and the profile
    window's tokens."""
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
    log = PlanLog(engine, per_call=True)  # one thread: per-call variants
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
    log.close()
    by_kind = log.by_kind()
    attn = ("paged_attention_chunk_int8" if kv_dtype == "int8"
            else "paged_attention_chunk")
    path = {attn, "era_scan_interval"}
    gen_tokens = sum(len(r.generated) for r in reqs)
    toks_ok = all(len(r.generated) == new and
                  all(0 <= t < cfg.vocab_size for t in r.generated)
                  for r in reqs)
    # decode steps take the split-KV walk and its combine and nothing
    # else, mixed and prefill steps the tensor-core tile (a chunk of fewer
    # than 16 columns takes the split walk); each call launched the
    # variant ``choose_variant`` gives its shapes, and no CUDA-core walk ran
    kinds_ok = (set(by_kind) == {"decode", "mixed", "prefill"}
                and set(by_kind["decode"]) == {"split"}
                and _counts_ok(dict(by_kind=by_kind, launches=variants,
                                    wrong=log.wrong),
                               ("decode", "mixed", "prefill")))
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
    print(f"  launches by variant ({label} pages): {variants}; calls by "
          f"plan kind and variant: {by_kind}; calls off their variant: "
          f"{log.wrong[:4]}", flush=True)
    kv_bytes = sum(t.numel() * t.element_size() for t in engine.pools.values())
    print(f"  serve ({label} pages): {dt:.3f} s wall, {gen_tokens / dt:.2f} "
          f"output tokens/s, {dt / steps * 1e3:.2f} ms/step over {steps} "
          f"steps ({stats['mixed_steps']} mixed), peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, KV pools "
          f"{kv_bytes / 2**30:.3f} GiB = "
          f"{kv_bytes / ((n_blocks + 1) * bs):.0f} B/token (scales included) "
          f"on {gpu_name_and_limit()}", flush=True)
    window = profile_window(engine, tid, cfg)
    generated = [r.generated for r in reqs]
    del engine
    torch.cuda.empty_cache()
    return dict(launches=dict({k: launches[k] for k in sorted(path)},
                              by_kind=by_kind, **variants),
                tokens=generated, tok_s=gen_tokens / dt, window=window)


class PlanLog:
    """What the workers ran, recorded from any thread: plans by (kind,
    shard); paged-attention calls by (plan kind, variant), the variant being
    what ``choose_variant`` gives for the call's shapes (the launch counts
    are held to these tallies); with ``check_finite``, one flag per step
    saying whether all its logits were finite.  ``close()`` removes every
    wrapper.

    With ``per_call`` (one thread only: the counters then move for no other
    call) each call's variant is the one it launched, read from the variant
    counters around it, and a call that launched anything but
    ``choose_variant``'s pick for its shapes (split: one split and one
    combine) goes into ``wrong``."""

    def __init__(self, engine, check_finite: bool = False,
                 per_call: bool = False):
        from repro_torch.kernels import paged_attention as pa
        from repro_torch.serve import engine as engine_mod

        self._engine, self._pa, self._engine_mod = engine, pa, engine_mod
        self._lock = threading.Lock()
        self._kind = threading.local()
        self.plans: dict = {}
        self.calls: dict = {}
        self.wrong: list = []
        self._flags: list = []
        self._chunk = pa.paged_attention_chunk
        self._steps = {name: getattr(engine_mod, name)
                       for name in ("paged_decode_step", "paged_prefill_chunk")}
        run_plan = engine.execute_plan

        def execute_plan(plan, tid):
            self._kind.value = plan.kind
            self._add(self.plans, (plan.kind, plan.shard))
            return run_plan(plan, tid)

        def paged_attention_chunk(q, k_pool, *args, **kwargs):
            b, c, kh, g, d = q.shape
            want = pa.choose_variant(q.dtype, k_pool.dtype, c * g, d,
                                     k_pool.shape[1])
            kind = getattr(self._kind, "value", None)
            if not per_call:
                self._add(self.calls, (kind, want))
                return self._chunk(q, k_pool, *args, **kwargs)
            before = {k: ctr.n for k, ctr in pa.VARIANT_LAUNCHES.items()}
            out = self._chunk(q, k_pool, *args, **kwargs)
            moved = {k: ctr.n - before[k]
                     for k, ctr in pa.VARIANT_LAUNCHES.items()
                     if ctr.n != before[k]}
            expect = ({"split": 1, "combine": 1} if want == "split"
                      else {want: 1})
            self._add(self.calls, (kind, want if moved == expect
                                   else "+".join(sorted(moved)) or "none"))
            if moved != expect:
                self.wrong.append((kind, tuple(q.shape), want, moved))
            return out

        engine.execute_plan = execute_plan
        pa.paged_attention_chunk = paged_attention_chunk
        if check_finite:
            for name, step in self._steps.items():
                def checked(*args, _step=step):
                    logits, pools = _step(*args)
                    flag = torch.isfinite(logits).all()
                    with self._lock:
                        self._flags.append(flag)
                    return logits, pools

                setattr(engine_mod, name, checked)

    def _add(self, table, key) -> None:
        with self._lock:
            table[key] = table.get(key, 0) + 1

    def close(self) -> None:
        del self._engine.execute_plan  # the class's own again
        self._pa.paged_attention_chunk = self._chunk
        for name, step in self._steps.items():
            setattr(self._engine_mod, name, step)

    def all_finite(self) -> bool:
        """Every logged step's logits finite (read after the run, whose
        steps have all been waited for)."""
        return (not self._flags
                or bool(torch.stack(self._flags).all().item()))

    def by_kind(self) -> dict:
        out: dict = {}
        for (kind, variant), n in sorted(self.calls.items(), key=str):
            counts = out.setdefault(kind, {})
            counts[variant] = counts.get(variant, 0) + n
        return out


def _window(engine, tid, cfg, salt):
    """Serve 8 requests (256-768-token prompts, 16 new tokens) through the
    engine's own tick/execute_plan, timing each step on the host clock by
    plan kind.  Returns (wall seconds, {kind: [seconds]}, the requests)."""
    reqs = [engine.submit(p, max_new_tokens=16)
            for p in trace(8, 256, 768, cfg.vocab_size, salt)]
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
    return time.perf_counter() - t0, by_kind, reqs


def profile_window(engine, tid, cfg):
    """Where the time goes: one 8-request window timed by step kind without
    the profiler, then the same lengths (other tokens) under torch.profiler
    for the device time by kernel; the device's idle share is 1 - device
    time / the unprofiled window's wall time.  Returns the unprofiled
    window's tokens."""
    from torch.profiler import ProfilerActivity, profile

    wall, by_kind, reqs = _window(engine, tid, cfg, salt=1)
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
        return [r.generated for r in reqs]
    shares = ", ".join(f"{k} {v / 1e6:.3f} s ({v / 1e6 / wall:.1%})"
                       for k, v in groups.items())
    print(f"  device time by kind (profiled window) against the unprofiled "
          f"{wall:.3f} s: {shares}; device busy {busy / wall:.1%}, idle "
          f"{1 - busy / wall:.1%}", flush=True)
    top = sorted(names.items(), key=lambda kv: -kv[1])[:8]
    print("  top device kernels: " + "; ".join(
        f"{k} {v / 1e3:.1f} ms" for k, v in top), flush=True)
    return [r.generated for r in reqs]


# ------------------------------------------------------------ phase 4: runtime
#: phase 4's engine is phase 3's (WFE, use_kernel=True, 2048 blocks of 16
#: tokens, max_batch 8, chunk 256) split over two shards of 1024 blocks,
#: each with its own device pool, scratch slot and CUDA stream
SHARDS = 2
#: 4d: one crash at each crash point and one poisoned row (serve/faults.py)
CHAOS_SPEC = ("crash_at=before_tick:3|after_reservation:7|after_dispatch:11,"
              "poison_at=5")


def poison_on_free(engine, dev) -> list:
    """Wrap each shard pool's ``_on_free`` (taken by every block at its
    allocation): before a freed slot goes back on the free stack, its pages
    in every layer get K = NaN and V = 1e30, written on a side stream that
    is synchronized before the wrapper returns: the earliest the slot can be
    reused.  The side stream is not ordered after the shard's stream, so a
    step still reading the page would read the poison.  Returns a
    one-element list counting the poisoned slots."""
    side = torch.cuda.Stream(device=dev)
    lock = threading.Lock()
    count = [0]
    for s, pool in enumerate(engine.pool.shards):
        def on_free(index, _s=s, _free=pool._on_free, _base=pool.first_block):
            pages = engine._shard_pools[_s]
            local = index - _base  # shard-local slot id
            with torch.cuda.stream(side):
                pages["k"][:, local] = float("nan")
                pages["v"][:, local] = 1e30
            side.synchronize()
            with lock:
                count[0] += 1
            _free(index)

        pool._on_free = on_free
    return count


def _device_busy(prof) -> tuple:
    """(sum of device kernel and copy times, union of their intervals), in
    seconds, from a profiler trace: the union counts a moment at which two
    streams both run once."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type.name == "CUDA")
    total = sum(b - a for a, b in spans)
    union, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            union += b - max(a, end)
            end = b
    return total / 1e6, union / 1e6


def sharded_engine(cfg, params, dev, workers, *, shards=SHARDS,
                   kv_dtype=None, faults=False):
    """The phase 4 engine for ``workers`` workers, with the CLI's
    ``max_threads`` headroom (respawns take fresh tids when faults are
    armed)."""
    from repro_torch.serve import ServeEngine

    return ServeEngine(cfg, params, n_blocks=2048, block_size=16,
                       max_batch=8, chunk_size=256, scheme="WFE",
                       use_kernel=True, kv_dtype=kv_dtype, n_shards=shards,
                       max_threads=max(16 if faults else 8, workers + 2),
                       max_inflight=max(4, workers), device=dev)


def serve_sharded(cfg, params, dev, prompts, new, *, workers,
                  shards=SHARDS, kv_dtype=None, spec=None, poison=False,
                  check_finite=False, profile=False, scans=None) -> dict:
    """Serve ``prompts`` (``new`` tokens each) on the phase 4 engine (on
    ``shards`` shards) with ``workers`` workers: ``engine.run`` for one
    worker without faults, else ``ServeRuntime``.  Launch counts are zeroed just before the run and read
    just after.  ``spec`` arms a ``FaultInjector``; ``poison`` wraps the
    frees (``poison_on_free``); ``profile`` runs under torch.profiler;
    ``scans`` (a list) is cleared first and collects the run's era scans.
    Returns what the run produced (a copy of ``scans`` included); the
    engine is freed."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as profiler

    from repro_torch.kernels import era_scan as es
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.serve import FaultInjector, FaultSpec, ServeRuntime

    engine = sharded_engine(cfg, params, dev, workers, shards=shards,
                            kv_dtype=kv_dtype, faults=spec is not None)
    injector = None
    if spec is not None:
        injector = FaultInjector(FaultSpec.parse(spec))
        engine.set_fault_injector(injector)
    poisoned = poison_on_free(engine, dev) if poison else [0]
    single = workers == 1 and spec is None  # engine.run on this thread
    log = PlanLog(engine, check_finite, per_call=single)
    reqs = [engine.submit(p, new) for p in prompts]
    counters = [pa.LAUNCHES, pa.LAUNCHES_Q8, es.LAUNCHES,
                *pa.VARIANT_LAUNCHES.values()]
    torch.cuda.synchronize()
    for ctr in counters:
        ctr.n = 0
    if scans is not None:
        scans.clear()
    prof = (profiler(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            if profile else contextlib.nullcontext())
    runtime = None if single else ServeRuntime(engine, n_workers=workers)
    t0 = time.perf_counter()
    with prof:
        if runtime is None:
            stats = engine.run(engine.pool.register_thread())
            stats.update(unreclaimed=engine.pool.unreclaimed(),
                         worker_steps=[stats["steps"]])
        else:
            stats = runtime.serve()
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"paged_attention_chunk": pa.LAUNCHES.n,
                "paged_attention_chunk_int8": pa.LAUNCHES_Q8.n,
                "era_scan_interval": es.LAUNCHES.n,
                **{k: ctr.n for k, ctr in pa.VARIANT_LAUNCHES.items()}}
    log.close()
    out = dict(stats=stats, dt=dt, tokens=[r.generated for r in reqs],
               states=[r.state for r in reqs], launches=launches,
               plans=log.plans, by_kind=log.by_kind(), wrong=log.wrong,
               finite=log.all_finite(), free_blocks=engine.pool.free_blocks,
               scans=list(scans or ()),
               poisoned=poisoned[0],
               generated=sum(len(r.generated) for r in reqs))
    if runtime is not None:
        out.update(respawns=runtime.n_respawns,
                   recovery=list(runtime.recovery_latencies))
    if injector is not None:
        out["crashes"] = injector.n_crashes
    if profile:
        out["busy_sum"], out["busy_union"] = _device_busy(prof)
    del engine, runtime, log
    torch.cuda.empty_cache()
    return out


def _counts_ok(run, expect_kinds) -> bool:
    """The launch counts agree with the logged calls (a split launch is
    one split and one combine), no CUDA-core walk ran, no call logged per
    call launched off its variant, and each plan kind in ``expect_kinds``
    called its variant: decode the split-KV walk, mixed and prefill the
    tile."""
    by_kind, n = run["by_kind"], run["launches"]
    split = sum(v.get("split", 0) for v in by_kind.values())
    tile = sum(v.get("tile", 0) for v in by_kind.values())
    want = {"decode": "split", "mixed": "tile", "prefill": "tile"}
    return (not run["wrong"] and n["split"] == n["combine"] == split
            and n["tile"] == tile and n["cuda_core"] == 0
            and all(by_kind.get(k, {}).get(want[k], 0) > 0
                    for k in expect_kinds))


def _both_shards(run) -> bool:
    return {s for _, s in run["plans"]} == set(range(SHARDS))


def _full(run, n_req, new, failed=0) -> bool:
    """``n_req`` requests: all but ``failed`` complete at full length, the
    pool drains to zero unreclaimed with every block free."""
    st = run["stats"]
    done = [t for t, state in zip(run["tokens"], run["states"])
            if state == "done"]
    return (st["completed"] == n_req - failed == len(done)
            and st.get("failed", 0) == failed
            and all(len(t) == new for t in done)
            and st["unreclaimed"] == 0 and run["free_blocks"] == 2048)


def _summary(run) -> str:
    st = run["stats"]
    return (f"completed={st['completed']} failed={st.get('failed', 0)} "
            f"unreclaimed={st['unreclaimed']} free_blocks="
            f"{run['free_blocks']}/2048 steps={st['steps']} worker_steps="
            f"{st['worker_steps']} plans by (kind, shard)="
            f"{dict(sorted(run['plans'].items()))} launches={run['launches']}")


def guarded(name: str, fn, *args, **kwargs):
    """Run one sub-phase; an exception fails it (printed) and returns None,
    so the later sub-phases still run and report."""
    try:
        return fn(*args, **kwargs)
    except Exception:  # a failed sub-phase must not hide the others
        import traceback

        traceback.print_exc()
        phase(name, False, "raised")
        return None


def serve_runtime_phase(cfg, params, dev, bf16, int8) -> dict:
    """Phase 4: the sharded engine and the multi-worker runtime on the card,
    on phase 3's full-width weights.  ``bf16``/``int8`` are phase 3's
    one-shard runs (tokens, tokens/s, window tokens).  Returns the kernels'
    launches in the 2-worker runtime run (4c) and the throughput table."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import INF_ERA32

    prompts = trace(32, 64, 1024, cfg.vocab_size)
    window = trace(8, 256, 768, cfg.vocab_size, salt=1)
    scans: list = []
    scan = ops.can_delete_blocks_interval

    def recorded(alloc, retire, lo, hi, **kwargs):
        if len(alloc):  # an empty scan launches nothing
            scans.append((len(alloc), int(np.count_nonzero(
                np.asarray(lo) != INF_ERA32))))
        return scan(alloc, retire, lo, hi, **kwargs)

    ops.can_delete_blocks_interval = recorded
    out: dict = {}
    t_phase = time.perf_counter()
    try:
        run = lambda k, **kw: serve_sharded(  # noqa: E731
            cfg, params, dev, prompts, 64, workers=k, scans=scans, **kw)
        win = lambda k, **kw: serve_sharded(  # noqa: E731
            cfg, params, dev, window, 16, workers=k, scans=scans, **kw)

        # 4a: one worker, two shards, bf16 then int8 pages
        a = guarded("4a", run, 1)
        if a is not None:
            phase("4a serve stablelm-3b full width, 2 shards, 1 worker, bf16 "
                  "pages, 32 requests",
                  _full(a, 32, 64) and _both_shards(a)
                  and _counts_ok(a, ("decode", "mixed", "prefill"))
                  and a["launches"]["era_scan_interval"] > 0
                  and a["launches"]["paged_attention_chunk_int8"] == 0,
                  _summary(a))
            print(f"  4a launches by plan kind: {a['by_kind']}; greedy token "
                  f"match against phase 3's one-shard run: "
                  f"{token_match(bf16['tokens'], a['tokens'])}", flush=True)
        a8 = guarded("4a int8", win, 1, kv_dtype="int8")
        if a8 is not None:
            phase("4a serve stablelm-3b full width, 2 shards, 1 worker, int8 "
                  "pages, 8 requests",
                  _full(a8, 8, 16) and _both_shards(a8)
                  and _counts_ok(a8, ("decode",))
                  and a8["launches"]["paged_attention_chunk"] == 0
                  and a8["launches"]["paged_attention_chunk_int8"] > 0
                  and a8["launches"]["era_scan_interval"] > 0, _summary(a8))
            print(f"  4a int8 greedy token match against phase 3b's one-shard"
                  f" window: {token_match(int8['window'], a8['tokens'])}",
                  flush=True)

        # throughput on the window, workers x shards, then in reverse order
        points = ((1, 1), (1, SHARDS), (2, SHARDS), (4, SHARDS))
        rates: dict = {}
        first: dict = {}
        for k, shards in points + points[::-1]:
            name = f"throughput K={k} x {shards} shards, 8 requests"
            r = guarded(name, win, k, shards=shards)
            if r is None:
                continue
            ok = _full(r, 8, 16) and _counts_ok(r, ("decode",))
            phase(name, ok, _summary(r))
            if ok:
                rates.setdefault((k, shards), []).append(
                    r["generated"] / r["dt"])
                first.setdefault((k, shards), r)
        print("  output tokens/s (host clock, the 8-request window, 16 new "
              "tokens each), workers x shards, first pass then the reverse "
              "pass: " + "; ".join(
                  f"{k} x {s}: " + ", ".join(f"{v:.2f}" for v in vs)
                  for (k, s), vs in sorted(rates.items()))
              + f" on {gpu_name_and_limit()}", flush=True)
        out["rates"] = rates

        # 4b: poison every freed page at the earliest reuse; the clean run
        # is the throughput pass's first 1 x 2 (the same single-threaded
        # plans)
        clean = first.get((1, SHARDS))
        p1 = guarded("4b poison", win, 1, poison=True, check_finite=True)
        if p1 is not None:
            same = clean is not None and p1["tokens"] == clean["tokens"]
            phase("4b poison on free, 1 worker, 2 shards: the clean run's "
                  "tokens", _full(p1, 8, 16) and p1["finite"]
                  and p1["poisoned"] > 0 and same,
                  f"{p1['poisoned']} slots poisoned, tokens == clean run's "
                  f"{same}, finite logits {p1['finite']}")
        p2 = guarded("4b poison 2 workers", win, 2, poison=True,
                     check_finite=True)
        if p2 is not None:
            phase("4b poison on free, 2 workers, 2 shards",
                  _full(p2, 8, 16) and p2["finite"] and p2["poisoned"] > 0,
                  f"{p2['poisoned']} slots poisoned, finite logits "
                  f"{p2['finite']}; " + _summary(p2))

        # 4c: the runtime, 2 workers on the 32 requests, 4 on the window
        # (the throughput pass's first 4 x 2 run)
        for k, n_req, new, kinds in ((2, 32, 64, ("decode", "mixed")),
                                     (4, 8, 16, ("decode",))):
            c = guarded(f"4c K={k}", run, k) if k == 2 \
                else first.get((4, SHARDS))
            if c is None:
                continue
            seen = c["scans"]
            most = max(seen, key=lambda x: (x[1], x[0]), default=(0, 0))
            phase(f"4c ServeRuntime K={k}, 2 shards, bf16 pages, {n_req} "
                  "requests",
                  _full(c, n_req, new) and _both_shards(c)
                  and all(n > 0 for n in c["stats"]["worker_steps"])
                  and _counts_ok(c, kinds)
                  and c["launches"]["era_scan_interval"] == len(seen) > 0,
                  _summary(c))
            print(f"  4c K={k}: {len(seen)} era scans, the most valid slots "
                  f"{most[1]} (x {most[0]} retired rows), the most rows "
                  f"{max(seen, default=(0, 0))[0]}; launches by plan kind: "
                  f"{c['by_kind']}", flush=True)
            if k == 2:
                out["launches_runtime"] = dict(c["launches"],
                                               by_kind=c["by_kind"])
                out["largest_scan"] = list(most)
                print("  output tokens/s (host clock, 32 requests x 64 "
                      f"tokens, one run each): 1 x 1 {bf16['tok_s']:.2f} "
                      "(phase 3), 1 x 2 "
                      + (f"{a['generated'] / a['dt']:.2f}" if a else "none")
                      + f" (4a), 2 x 2 {c['generated'] / c['dt']:.2f} (4c) "
                      f"on {gpu_name_and_limit()}", flush=True)

        # 4d: chaos
        d = guarded("4d", run, 2, spec=CHAOS_SPEC)
        if d is not None:
            lat = sorted(d["recovery"])
            p50 = f"{lat[len(lat) // 2] * 1e3:.2f} ms" if lat else "none"
            phase("4d chaos, K=2, 2 shards: " + CHAOS_SPEC,
                  _full(d, 32, 64, failed=1) and d["crashes"] == 3
                  and d["respawns"] == 3
                  and d["stats"]["crash_requeues"] >= 1,
                  f"crashes={d['crashes']} respawns={d['respawns']} "
                  f"crash_requeues={d['stats']['crash_requeues']} "
                  f"recovery p50 {p50} over {len(lat)}; " + _summary(d))

        # idle share of the window with 2 workers on 2 shards, against the
        # throughput pass's first unprofiled 2 x 2 run
        two = first.get((2, SHARDS))
        if two is not None:
            guarded("idle K=2", runtime_idle, cfg, params, dev, window, 2,
                    two["dt"])

        # 4e: the front end over this engine, in this process
        guarded("4e front end full width", frontend_full_width, cfg, params,
                dev, window)
    finally:
        ops.can_delete_blocks_interval = scan
    t_sub = time.perf_counter()
    # 4e: the front end's selftest and the CLI, each in a process of its own
    guarded("4e", entry_points)
    print(f"  phase 4: {t_sub - t_phase:.1f} s in this process, "
          f"{time.perf_counter() - t_sub:.1f} s for the subprocesses",
          flush=True)
    return out


def runtime_idle(cfg, params, dev, window, workers, wall) -> None:
    """The device's idle share with ``workers`` workers on 2 shards: the
    8-request window under torch.profiler against ``wall``, the seconds of
    the same run unprofiled; busy is the union of the device's kernel and
    copy intervals (two streams may run at once; their sum is printed
    too)."""
    prof = serve_sharded(cfg, params, dev, window, 16, workers=workers,
                         profile=True)
    busy_sum, busy = prof["busy_sum"], prof["busy_union"]
    if busy == 0:
        print(f"  idle K={workers}: device time not measured (no CUDA "
              "events)", flush=True)
        return
    print(f"  idle K={workers}, 2 shards, 8-request window: "
          f"{wall:.3f} s wall unprofiled ({prof['dt']:.3f} s "
          f"profiled), device busy (union of intervals) {busy:.3f} s = "
          f"{busy / wall:.1%}, idle {1 - busy / wall:.1%}; sum "
          f"of device times {busy_sum:.3f} s on {gpu_name_and_limit()}",
          flush=True)


def frontend_full_width(cfg, params, dev, window) -> None:
    """4e at full width: ``Frontend(ServeRuntime(engine, n_workers=2))`` in
    this process over the phase 4 engine (bf16 pages, 2 shards), its
    workers persistent.  Over HTTP: one request streamed to its end, one
    cancelled by disconnecting after two tokens, one DELETE-cancelled after
    its first; then the rolling drain.  Launch counts are zeroed just
    before the front end starts and read after the drain: decode plans
    launch split + combine, the prompts' chunks the tile, no CUDA-core
    walk, and the era scan runs."""
    import asyncio

    from repro_torch.kernels import era_scan as es
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.serve import Frontend, ServeRuntime
    from repro_torch.serve.frontend import _http_json, _post_generate, _read_sse

    engine = sharded_engine(cfg, params, dev, 2)
    log = PlanLog(engine)
    frontend = Frontend(ServeRuntime(engine, n_workers=2,
                                     max_steps_per_worker=1_000_000), port=0)
    counters = [pa.LAUNCHES, pa.LAUNCHES_Q8, es.LAUNCHES,
                *pa.VARIANT_LAUNCHES.values()]
    torch.cuda.synchronize()
    for ctr in counters:
        ctr.n = 0

    async def drive() -> dict:
        port = await frontend.start()
        got: dict = {}
        # one request streamed to its end
        status, reader, writer = await _post_generate(
            port, {"prompt": window[0], "max_new_tokens": 16})
        events = await _read_sse(reader)
        writer.close()
        toks = [d for e, d in events if e == "token"]
        done = [d for e, d in events if e == "done"]
        got["streamed"] = ("200" in status and len(toks) == 16
                           and [t["index"] for t in toks] == list(range(16))
                           and all(0 <= t["token"] < cfg.vocab_size
                                   for t in toks)
                           and bool(done) and done[0]["state"] == "done")
        # cancelled by disconnecting after two tokens
        status, reader, writer = await _post_generate(
            port, {"prompt": window[1], "max_new_tokens": 64})
        events = await _read_sse(reader, until_tokens=2)
        writer.close()
        got["disconnected"] = ("200" in status and
                               sum(e == "token" for e, _ in events) == 2)
        # DELETE-cancelled after its first token
        status, reader, writer = await _post_generate(
            port, {"prompt": window[2], "max_new_tokens": 64})
        events = await _read_sse(reader, until_tokens=1)
        rid = next(d["id"] for e, d in events if e == "start")
        del_status, body = await _http_json(port, "DELETE",
                                            f"/v1/requests/{rid}")
        tail = await _read_sse(reader)
        writer.close()
        done = [d for e, d in tail if e == "done"]
        got["deleted"] = ("200" in status and "200" in del_status
                          and body["cancelled"] and bool(done)
                          and done[0]["state"] == "cancelled")
        got["cancel_latency_ms"] = done[0]["cancel_latency_ms"] if done \
            else None
        t0 = time.monotonic()
        while time.monotonic() - t0 < 60.0:  # quiescence, then the drain
            _, health = await _http_json(port, "GET", "/healthz")
            if health["pending"] == 0 and health["active"] == 0:
                break
            await asyncio.sleep(0.05)
        got["stats"] = await frontend.shutdown(deadline_s=30.0)
        return got

    try:
        got = asyncio.run(drive())
    finally:
        log.close()
        if frontend.runtime.running:  # drive() failed before its drain
            frontend.runtime.drain(deadline_s=10.0)
    torch.cuda.synchronize()
    n = {"era_scan_interval": es.LAUNCHES.n,
         "paged_attention_chunk_int8": pa.LAUNCHES_Q8.n,
         **{k: ctr.n for k, ctr in pa.VARIANT_LAUNCHES.items()}}
    st = got["stats"]
    ok = (got["streamed"] and got["disconnected"] and got["deleted"]
          and st["unreclaimed"] == 0 and st["cancelled"] >= 2
          and st["completed"] >= 1 and engine.pool.free_blocks == 2048
          and n["split"] == n["combine"] > 0 and n["tile"] > 0
          and n["cuda_core"] == 0 and n["paged_attention_chunk_int8"] == 0
          and n["era_scan_interval"] > 0
          and _counts_ok(dict(by_kind=log.by_kind(), launches=n,
                              wrong=log.wrong), ("decode",)))
    phase("4e front end over full-width stablelm-3b, 2 shards, 2 workers: "
          "stream, disconnect, DELETE, rolling drain", ok,
          f"streamed {got['streamed']} disconnected {got['disconnected']} "
          f"deleted {got['deleted']} (cancel latency "
          f"{got['cancel_latency_ms']} ms) completed={st['completed']} "
          f"cancelled={st['cancelled']} unreclaimed={st['unreclaimed']} "
          f"free_blocks={engine.pool.free_blocks}/2048 worker_steps="
          f"{st['worker_steps']} launches={n} by plan kind={log.by_kind()}")
    del engine, frontend
    torch.cuda.empty_cache()


def entry_points() -> None:
    """4e: the front end's selftest and the serving CLI at the reference's
    smoke size, each in a process of its own, on the default device
    (CUDA), started together."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmds = {
        "frontend --selftest": [sys.executable, "-m",
                                "repro_torch.serve.frontend", "--selftest",
                                "--shards", "2", "--workers", "2"],
        "launch.serve": [sys.executable, "-m", "repro_torch.launch.serve",
                         "--shards", "2", "--workers", "2", "--requests",
                         "8"],
    }
    procs = {name: subprocess.Popen(cmd, cwd=ROOT, env=env, text=True,
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT)
             for name, cmd in cmds.items()}
    t0 = time.perf_counter()
    for name, proc in procs.items():
        try:
            log, _ = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
        want = ("selftest: PASS" if name.startswith("frontend")
                else "completed=8")
        ok = proc.returncode == 0 and want in log
        tail = " | ".join(line for line in log.splitlines()
                          if want.split(":")[0].split("=")[0] in line
                          or "drained" in line)[-400:]
        phase(f"4e {name} --shards 2 --workers 2 on CUDA (smoke size)", ok,
              f"rc={proc.returncode} after {time.perf_counter() - t0:.1f} s: "
              f"{tail}")
        if not ok:
            print(log[-3000:], flush=True)


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
    era_rows = era_scan_phase(dev, era_cases())

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

    launches, launches_q8, schemes, runtime = serve_full_width(dev)
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
         launches["by_kind"].get("mixed", {}).get("tile", 0),
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
         launches_q8["by_kind"].get("mixed", {}).get("tile", 0),
         attn[("int8", "engine")]),
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
    # the era scan's rows, the first at R 4096 S 512; ``launches``: the bf16
    # serving run's, ``launches_by_scheme``: phase 3c's
    kernels += [
        dict(name="era_scan_interval", route="cuda",
             source="src/repro_torch/kernels/csrc/era_scan.cu",
             replaces="src/repro/kernels/era_scan.py:96",
             launches=launches["era_scan_interval"],
             launches_by_scheme={k: v["era_scan_launches"]
                                 for k, v in schemes.items()}, **row)
        for row in era_rows]
    kernels += [
        dict(name="flash_attention", case="stablelm-3b prefill", **flash_src,
             **flash),
        dict(name="flash_attention", case="starcoder2-3b prefill",
             **flash_src, **flash_gqa),
    ]
    # ``launches_runtime``: each row's launches in phase 4c's 2-worker run
    # on 2 shards (bf16 pages), by the row's variant and, for the engine's
    # mixed step, by plan kind
    rt = runtime.get("launches_runtime")
    for row in kernels:
        if rt is None:
            n = None
        elif row["name"] == "era_scan_interval":
            n = rt["era_scan_interval"]
        elif row["name"] != "paged_attention_chunk" or "f32" in row["case"]:
            n = 0  # int8 pages, f32 queries and flash are off this run
        elif row["case"].startswith("engine"):
            n = rt["by_kind"].get("mixed", {}).get("tile", 0)
        else:
            n = rt[row["variant"]]
        row["launches_runtime"] = n
        if row["name"] == "era_scan_interval":
            row["largest_scan_runtime"] = runtime.get("largest_scan")
    kernels[0]["launches_runtime_combine"] = rt and rt["combine"]
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
