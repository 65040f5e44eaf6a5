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
   query's f32 tile), also in the engine's own mixed layout (decode
   rows padded to the chunk bucket); the same decode and mixed shapes at
   gemma-7b's head dim 256 (KH 16, G 1) over bf16 and int8 pages and with
   an f32 query, and at starcoder2-3b's grouped heads (KH 2, G 12, D 128);
   dense flash attention at the stablelm-3b, starcoder2-3b and gemma-7b
   prefill shapes, and at phase 7's: mixtral-8x7b (GQA 32 / 8, D 128) at
   B 4 T 1024 and B 1 T 4096, recurrentgemma-2b (MQA 10 / 1, D 256) at
   B 4 T 1024 and B 1 T 2048, whisper-small's encoder (12 heads of 64,
   non-causal, B 4 T 1500, held to limits from its own magnitudes, which
   two planted faults of its ragged last tile must fail); the f32 tile
   (``csrc/attention_f32.cuh``) at phase 7's f32 group shapes
   (mixtral-8x7b and recurrentgemma-2b at B 2 T 64, whisper-small's
   encoder at B 2 T 1500).  The split-KV walk, the tile and the f32 tile
   are also held against the plain models of their own algebra
   (``ref.paged_attention_split_ref``, ``paged_attention_tile_ref``,
   ``paged_attention_f32_tile_ref`` and ``flash_attention_f32_tile_ref``,
   the last two within ``F32_MODEL_RTOL`` and ``F32_MODEL_FLOOR``), and
   the f32 flash rows give the same bits on two calls.
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
   4a' stablelm-3b at full width, 8 layers, in f32: the window with one
      worker on 1 shard, on 2 shards, and on 1 shard with the requests
      submitted in reverse order (the control); the greedy token matches
      against the 1-shard run printed.
5. The model step against the plain path on the CPU at full width and
   reduced depth, and a WFE forced-slow-path run at reduced depth.
6. One arch resident at a time, starcoder2-3b, starcoder2-7b, gemma-7b and
   pixtral-12b (its text decoder): full-width bf16 weights from a seeded
   generator (the parameter count checked), the 8-request window on one
   shard with phase 3's engine and limits, decode plans on the split-KV
   walk and mixed and prefill plans on the tile, each call's variant held
   against ``choose_variant`` (gemma-7b also with int8 pages); output
   tokens/s and ms per step by plan kind printed; then the model zoo's
   prefill of 4096 tokens on the same weights (one flash kernel call per
   layer, none plain; stablelm-3b's at the end of phase 4), then phase
   5's model step at the arch's full width and 2 layers.
7. The model zoo (``repro_torch.models``) at full width, one arch
   resident at a time, seeded random weights: deepseek-v2-236b (8 of 60
   layers), mixtral-8x7b (24 of 32), recurrentgemma-2b, xlstm-350m and
   whisper-small (full depth).  Per arch: (a) one group of the block
   pattern in f32 (whisper: 2 decoder and 2 encoder layers; MoE at the
   drop-free capacity of the smoke configs), prefill of 64 tokens at B 2
   and two ``decode_step``s against ``forward`` within 2e-3, the flash
   routes of the run held to the table and every kernel launch on the
   f32 tile (deepseek
   also: the prefill's latents copied into ``init_mla_pools`` pages of 16
   through permuted tables, 8 ``paged_mla_decode_step``s against
   ``decode_step`` within 2e-3); (b) in bf16 at the depth above, the
   parameter count, the first layer's routed experts (MoE archs) at the
   prefill and decode shapes against an f32-product plain version
   (``moe_plain``), a prefill of B 4 seeded prompts of 1024 tokens
   (deepseek 512; whisper 256 over 1500 frames) and 32 greedy
   ``decode_step``s: finite logits and the flash routes of the table in
   ``models.attention`` exactly (``FLASH_ROUTES`` zeroed just before,
   read just after, the kernel's launches equal to its route's calls);
   prefill ms, decode ms per step, tokens/s and peak memory printed;
   deepseek's paged greedy token match printed; (c) mixtral and
   recurrentgemma: a prefill at B 1 of exactly the window (kernel) and
   of the window + 512 (the plain banded route), timed.
8. Training (``repro_torch.train``).  (a) The flash backward
   (``FlashAttentionFn``'s gradient, ``csrc/flash_attention_bwd.cu``)
   against its plain version (autograd through the plain forward) at
   stablelm-3b B 1 T 2048 (bf16 and f32), starcoder2-3b's G 12,
   gemma-7b's D 256 (B 1 T 2048) and whisper-small's non-causal encoder
   (B 4 T 1500, a ragged last tile), held to limits from the gradients'
   magnitudes that two planted faults (the causal mask dropped in dK and
   dV; the ragged last key tile skipped) must fail; the forward the same
   bits with and without its log-sum-exp output; timed beside SDPA's
   backward and its bound.  At each bf16 shape both variants are held and
   timed in the same run: the tensor-core tile (the route) and the f32
   tile on the widened inputs (forced), each two calls the same bits; at
   starcoder2-3b also the tile without its GQA split.  The f32 rows
   (stablelm-3b, starcoder2-3b, gemma-7b, whisper's encoder) take the f32
   tile, each two calls the same bits, held to the f32 limits that the
   two planted faults must fail; at 8b's short grid and two more the f32
   tile's 64-row and one-warp CTAs give the same bits.  (b) stablelm-3b
   at full width, 2 layers, f32: one ``make_train_step`` step on the card
   against the same step on the CPU, and with 1 and 2 microbatches, every
   backward call on the f32 tile; (b') the same 2 layers trained on the
   card alone at B 1 x S 2048 (ms a step, the backward's share of device
   time in one profiled step, every backward launch on the f32 tile).
   (c) The slice: full-width,
   full-depth stablelm-3b in bf16 with f32 master weights and AdamW
   states, remat on, global batch 8 x 2048 in 8 microbatches, 6 steps from
   ``PrefetchingLoader(SyntheticLMData)``: finite losses and grad norms,
   every attention call on the kernel route (32 layers x 8 microbatches x
   2 a step, remat recomputing) and 32 x 8 backward launches a step, all
   on the tensor-core tile and none on the f32 tile, the prefetcher drained
   after ``close``; ms/step, tokens/s, peak memory and
   the share of 6 N D at the bf16 peak printed; then one more step under
   torch.profiler: device time by kind and the idle share.  (d) The
   restart drill at
   the smoke config on CUDA (a failure injected at step 12 of 20, one
   restart from the manifest), then ``python -m
   repro_torch.launch.train --steps 20`` as a subprocess on CUDA.
9. The mesh layer (``repro_torch.sharding``, ``launch.mesh``), once 8c's
   state is freed.  (a) ``kernels.can_delete_blocks`` (point
   reservations) on CUDA tensors at ``tests/test_kernels.py:44``'s shapes
   and its protected-interval cases: the era-scan kernel, one launch a
   call, bitwise its plain version and the NumPy backend; timed at
   R 1000 x 5120 slots with its bound (a row of the kernels line).  Then a
   one-rank NCCL group and ``make_smoke_mesh``: (b) 8c's training (the
   same seed, config and first batches) with the f32 masters as DTensors
   laid out by ``sharding_tree(params_axes())`` and the accumulators
   pinned by ``grad_shardings``, under ``axis_rules``, 3 steps: losses
   within 1e-5 relative of 8c's (bitwise printed), the flash kernel
   forward and backward per shard through ``local_map`` (512 forward
   launches and 256 tile-backward launches a step, no plain route);
   ms/step and peak memory beside 8c's; one more step with
   ``bf16_weight_gather`` within 1e-2 of 8c's fourth loss, and one
   profiled step (the device's busy and idle share); (c)
   ``reshard_state`` onto the same mesh keeps every bit, ``merged_era``
   and ``device_merge_all`` over NCCL, ``compressed_all_reduce`` of 8b's
   cut's gradients bitwise ``dequantize(quantize(g + r))``, and the k = 1
   rings of ``ag_matmul``/``rs_matmul`` equal the product; each timed.
   The group is destroyed and the phase's seconds printed.
10. The launch tooling (``repro_torch.launch``), after phase 9; nothing of
   it runs on the card but the examples.  (a) 8c's configuration as a
   dry-run cell (``ShapeSpec("8c", 2048, 8, "train")`` of full-width,
   full-depth stablelm-3b, f32 masters, AdamW, remat) on a 1x1 mesh of a
   one-rank fake group, meta tensors: its state's bytes must equal 8c's
   live state on the card (params, m, v, step) and all its argument bytes
   that state plus 8c's batch, exactly; its FLOPs printed beside 6 N D, its
   peak beside 8c's ``max_memory_allocated``, its roofline bound beside
   8c's measured step (the measured roofline fraction).  (b) ``python -m
   repro_torch.launch.dryrun --cells`` ``DRYRUN_CELLS`` ``--mesh both`` in a
   process of its own (a fake 512-rank group): every cell ok but whisper's
   ``long_500k``, skipped with the reference's reason; then ``python -m
   repro_torch.launch.report`` on its JSONL (the tables printed), and the
   sweep again, which must skip every done cell.  (c) The four
   ``examples/torch_*.py`` on CUDA, each in a process of its own, exiting
   0 with their last line.  The phase's seconds printed.

The line before the last is the ``kernels`` JSON line (each row with
``launches_runtime``, its launches in 4c's 2-worker run; the rows of
another arch name it in ``arch`` and take ``launches`` from its phase 6
window; flash attention's rows take theirs from the model zoo's prefill of
their arch, its f32 rows from phase 7's f32 group; the backward's rows,
one per variant, and the forward's training row take theirs from 8c; the
point form's row from 9a); the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device the script exits
non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import gc
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


def free_device_memory() -> None:
    """Collect unreachable Python objects, then return the allocator's
    cached blocks to the card: a finished phase's engine or weights can sit
    in a reference cycle, which holds its tensors until the cyclic
    collector runs, and a later phase's full-width weights need that
    memory."""
    gc.collect()
    torch.cuda.empty_cache()


def gpu_name_and_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else \
        f"nvidia-smi failed: {out.stderr.strip()}"


# ------------------------------------------------------------ phase 2: kernels
def attention_case(dtype, b, c, nblk, layers, dev, int8=False,
                   engine_mixed=False, arch="stablelm-3b"):
    """Main-path-shaped operands of ``arch``'s attention (its KH, G and D):
    (layers, N, bs, KH, D) pools (one pool per
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

    cfg = get_config(arch)
    kh, d, bs = cfg.n_kv_heads, cfg.resolved_head_dim, 16
    g = cfg.n_heads // kh
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
    # (B, H, C, D), query head kh * G + g on kv head kh
    qd = q.permute(0, 2, 3, 1, 4).reshape(b, kh * g, c, d).contiguous()
    kvpos = torch.arange(w * bs, device=q.device)
    mask = ((kvpos[None, None, :] <= qpos[:, :, None])
            & (kvpos[None, None, :] < (live * bs)[:, None, None]))[:, None]
    it = [0]

    def call():
        l = it[0] % layers
        it[0] += 1
        F.scaled_dot_product_attention(qd, ks[l], vs[l], attn_mask=mask,
                                       scale=case["scale"], enable_gqa=g > 1)

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


#: the f32 tile against the plain model of its order (``ref.*_f32_tile_ref``):
#: elementwise rtol 1e-6, with an absolute floor of 1e-5 of the largest
#: |output| for the outputs near zero (the two sum each product in another
#: order: about 1e-7 of the output's scale over a long walk); a bf16 output
#: one bf16 rounding step
F32_MODEL_RTOL, F32_MODEL_FLOOR = 1e-6, 1e-5


def f32_model_close(got, model, name) -> tuple:
    """(within the f32 model limits, detail) of a kernel output against
    the f32 tile's model."""
    rtol = F32_MODEL_RTOL if got.dtype == torch.float32 else 2.0 ** -7
    got, model = got.float(), model.float()
    atol = F32_MODEL_FLOOR * model.abs().max().item()
    err = (got - model).abs().max().item()
    ok = torch.allclose(got, model, rtol=rtol, atol=atol)
    return ok, (f", against {name} max_abs_err={err:.3e} (rtol {rtol:.3g} "
                f"atol {atol:.3g})")


def check_model(case, got, layer=0) -> tuple:
    """The kernel's output ``got`` over layer ``layer`` against the plain
    model of its variant's algebra: the split-KV walk within 1e-5 in f32
    and one bf16 step in bf16, the tile within 2e-2, the f32 tile within
    ``f32_model_close``.  Returns (ok, detail)."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels.ref import (paged_attention_f32_tile_ref,
                                         paged_attention_split_ref,
                                         paged_attention_tile_ref)

    variant = case_variant(case)
    kp, vp, ksc, vsc = _layer(case, layer)
    q, tables, qpos, live = (case["q"], case["tables"], case["qpos"],
                             case["live"])
    if variant == "cuda_core":
        model = paged_attention_f32_tile_ref(
            q, kp, vp, tables, qpos, live, scale=case["scale"], k_scales=ksc,
            v_scales=vsc)
        return f32_model_close(got, model, "paged_attention_f32_tile_ref")
    if variant == "split":
        pps, nsplit = pa.split_plan(tables.shape[1], case["bs"],
                                    q.shape[-1])
        model = paged_attention_split_ref(
            q, kp, vp, tables, qpos, live, pages_per_split=pps,
            n_splits=nsplit, scale=case["scale"], k_scales=ksc, v_scales=vsc)
        rtol, atol = ((1e-5, 1e-5) if q.dtype == torch.float32
                      else tolerance(variant, q.dtype))
    else:
        model = paged_attention_tile_ref(q, kp, vp, tables, qpos, live,
                                         scale=case["scale"], k_scales=ksc,
                                         v_scales=vsc)
        rtol, atol = 2e-2, 2e-2
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

    counters = [pa.LAUNCHES, pa.LAUNCHES_Q8, fa.LAUNCHES, fa.BWD_LAUNCHES,
                *pa.VARIANT_LAUNCHES.values(), *fa.VARIANT_LAUNCHES.values(),
                *fa.BWD_VARIANT_LAUNCHES.values()]
    return [(ctr, ctr.n) for ctr in counters]


def _restore_counts(saved) -> None:
    for ctr, n in saved:
        ctr.n = n


def check_attention(dtype, b, c, nblk, dev, engine_mixed=False,
                    arch="stablelm-3b"):
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels.ref import paged_attention_chunk_ref

    layers = 8
    case = attention_case(dtype, b, c, nblk, layers, dev,
                          engine_mixed=engine_mixed, arch=arch)
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
           f"nblk={nblk}" + (" engine mixed layout" if engine_mixed else "")
           + _arch_tag(arch, case))
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


def _arch_tag(arch, case) -> str:
    """' (gemma-7b: KH 16 G 1 D 256)' for an arch other than stablelm-3b."""
    if arch == "stablelm-3b":
        return ""
    _, _, kh, g, d = case["q"].shape
    return f" ({arch}: KH {kh} G {g} D {d})"


def check_attention_int8(b, c, nblk, dev, engine_mixed=False,
                         arch="stablelm-3b"):
    """The fused-dequant kernel over int8 pools: bf16 q against the plain
    version; f32 q against the f32 kernel on the dequantized pools,
    bitwise; NaN scales in dead table slots never read."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels.quant import dequantize_pool
    from repro_torch.kernels.ref import paged_attention_chunk_int8_ref

    layers = 8
    case = attention_case(torch.bfloat16, b, c, nblk, layers, dev, int8=True,
                          engine_mixed=engine_mixed, arch=arch)
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
           + (" engine mixed layout" if engine_mixed else "")
           + _arch_tag(arch, case))
    phase(f"{tag} vs plain", close and model_ok and bitwise and nan_safe,
          f"max_abs_err={err:.3e} (rtol {rtol:.3g} atol {atol:.3g})"
          f"{model_detail}, f32 q fused == f32 kernel on dequantized pools "
          f"{bitwise}, NaN dead scales unread {nan_safe}")
    row = dict(max_abs_err=err, **time_attention(case, layers, tag))
    if engine_mixed:
        row.update(time_pad_fix(case, layers, tag))
    return row


#: bf16 flash at a non-causal shape with small outputs (whisper-small's
#: encoder: |out| about 0.04 over 1500 keys) is held to its own
#: magnitudes: elementwise within rtol 1e-2 plus 4 bf16 ulps of max |want|,
#: and a relative RMS error (||got - want|| / ||want||) within this.  The
#: tile's rounding of P gives about 2.5e-3; the ragged last tile's pad
#: keys left unmasked scale every output by about 1.5% (1.4e-2), which
#: the elementwise limit alone does not see
FLASH_REL_RMS = 7e-3


def flash_scaled_close(got, want, rel_rms=FLASH_REL_RMS) -> tuple:
    """(within the limits above, detail) of got against want."""
    got, want = got.float(), want.float()
    ulp = 2.0 ** (math.floor(math.log2(want.abs().max().item())) - 7)
    close = torch.allclose(got, want, rtol=1e-2, atol=4 * ulp)
    rms = ((got - want).norm() / want.norm()).item()
    return (close and rms <= rel_rms,
            f"rel_rms={rms:.3e} (limit {rel_rms}), atol 4 ulp = {4 * ulp:.3e}"
            f" + rtol 1e-2: {close}")


def _attend(q, k, v):
    """Non-causal GQA attention in f32, rounded to q's dtype (for the
    planted faults, whose keys differ from the queries in number)."""
    g = q.shape[2] // k.shape[2]
    k, v = (x.float().repeat_interleave(g, 2) for x in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k) / math.sqrt(q.shape[-1])
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1),
                        v).to(q.dtype)


def flash_tail_faults(q, k, v, want, name) -> None:
    """The ragged last K/V tile broken on purpose, from the plain version:
    its pad keys unmasked (zero keys and values up to the tile multiple)
    and the partial tile dropped.  Each must fail ``flash_scaled_close``,
    or the check could not see a fault of the tile."""
    t = k.shape[1]
    keys = 64 if k.shape[-1] <= 128 else 32  # the tile's keys per K/V tile
    cut = t - t % keys
    assert cut < t, "no partial tile at this T"
    z = k.new_zeros((k.shape[0], keys - t % keys) + k.shape[2:])
    faults = {"unmasked pad keys": _attend(q, torch.cat([k, z], 1),
                                           torch.cat([v, z], 1)),
              "dropped tail tile": _attend(q, k[:, :cut], v[:, :cut])}
    seen = {n: not flash_scaled_close(f, want)[0] for n, f in faults.items()}
    phase(f"{name}: planted faults of the last tile fail the check",
          all(seen.values()),
          "; ".join(f"{n}: {flash_scaled_close(f, want)[1]}"
                    for n, f in faults.items()))


def check_flash(b, t, h, kh, d, dtype, causal, gen, dev, tol, tag,
                scaled=False):
    """Dense flash attention against its plain version, timed beside
    ``scaled_dot_product_attention(enable_gqa=True)`` and its bound: 4 * D
    flops per visible (query, key) pair and head at the input type's peak,
    or q, k, v and out once over HBM.  ``scaled``: held by
    ``flash_scaled_close`` instead of ``tol``, with planted tail faults."""
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
    if scaled:
        close, limit = flash_scaled_close(got, want)
    else:
        close = torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
        limit = f"tol {tol}"
    finite = bool(torch.isfinite(got).all())
    name = (f"flash_attention {tag}: {str(dtype).split('.')[-1]} "
            f"{'causal' if causal else 'non-causal'} B={b} T={t} H={h} "
            f"KH={kh} D={d}")
    model_ok, model_detail = True, ""
    if fa.choose_variant(dtype, d) == "cuda_core":
        from repro_torch.kernels.ref import flash_attention_f32_tile_ref

        model_ok, model_detail = f32_model_close(
            got, flash_attention_f32_tile_ref(q, k, v, causal=causal),
            "flash_attention_f32_tile_ref")
        same = torch.equal(got, fa.flash_attention(q, k, v, causal=causal))
        model_ok = model_ok and same
        model_detail += f", two calls the same bits {same}"
    phase(f"{name} vs plain",
          close and model_ok and finite and got.shape == q.shape,
          f"max_abs_err={err:.3e} ({limit}){model_detail}, finite={finite}")
    if scaled:
        flash_tail_faults(q, k, v, want, name)
    del want
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
    free_device_memory()
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
    t3d = time.perf_counter()
    guarded("3d scheduler policies", serve_policies, cfg, params, dev,
            schemes["WFE"]["tokens"])
    print(f"  phase 3d: {time.perf_counter() - t3d:.1f} s", flush=True)
    runtime = serve_runtime_phase(cfg, params, dev, bf16, int8)
    zoo = guarded("model zoo stablelm-3b prefill", zoo_dense_prefill, cfg,
                  params, dev)
    del params
    free_device_memory()
    return bf16["launches"], int8["launches"], schemes, runtime, zoo


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
                               largest_scan=list(largest), tokens=toks)
            del engine
            free_device_memory()
    finally:
        ops.can_delete_blocks_interval = scan
    return out


def latency(reqs) -> str:
    """p50/p95 of the requests' time to first token and time per output
    token (``Request.ttft``/``tpot``, host clock, submit to token), in
    ms."""
    out = []
    for name in ("ttft", "tpot"):
        got = [getattr(r, name) for r in reqs]
        got = np.array([v for v in got if v is not None]) * 1e3
        out.append(f"{name.upper()} p50 {np.percentile(got, 50):.2f} ms, "
                   f"p95 {np.percentile(got, 95):.2f} ms" if len(got)
                   else f"{name.upper()} none")
    return "; ".join(out) + f" ({len(reqs)} requests, host clock)"


def watch_victims(sched) -> list:
    """(requester's SLO class, victim's class) of every preemption the
    scheduler's shedding ladder picks from here on."""
    pick, pairs = sched._pick_victim, []

    def watched(exclude, shard=None):
        victim = pick(exclude, shard=shard)
        if victim is not None:
            pairs.append((exclude.slo, victim.slo))
        return victim

    sched._pick_victim = watched
    return pairs


def policy_window(cfg, params, dev, *, n_blocks=2048, **engine_kw) -> dict:
    """3c's 8-request window (``_window``, salt 1) on phase 3's engine
    settings with ``engine_kw`` on top, each paged-attention call's
    variant held against ``choose_variant`` (one thread), launch counts
    zeroed just before and read just after."""
    from repro_torch.kernels import era_scan as es
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.serve import ServeEngine

    engine = ServeEngine(cfg, params, n_blocks=n_blocks, block_size=16,
                         max_batch=8, chunk_size=256, use_kernel=True,
                         device=dev, **engine_kw)
    tid = engine.pool.register_thread()
    log = PlanLog(engine, per_call=True)
    counters = [pa.LAUNCHES, es.LAUNCHES, *pa.VARIANT_LAUNCHES.values()]
    for ctr in counters:
        ctr.n = 0
    wall, _, reqs = _window(engine, tid, cfg, salt=1)
    launches = {"paged_attention_chunk": pa.LAUNCHES.n,
                "era_scan_interval": es.LAUNCHES.n,
                **{k: ctr.n for k, ctr in pa.VARIANT_LAUNCHES.items()}}
    log.close()
    out = dict(stats=dict(engine.sched.stats), wall=wall, reqs=reqs,
               tokens=[r.generated for r in reqs], launches=launches,
               by_kind=log.by_kind(), wrong=log.wrong,
               drained=(engine.pool.unreclaimed() == 0
                        and engine.pool.free_blocks == n_blocks))
    del engine, log
    free_device_memory()
    return out


def _window_ok(run, f32=False) -> bool:
    """8/8 at 16 tokens, drained, the paged kernel and the era scan
    launched, and every call on ``choose_variant``'s pick: bf16 decode on
    the split walk and mixed and prefill on the tile (``_counts_ok``), f32
    on the f32 split walk and the f32 tile."""
    kinds = tuple(k for k in ("decode", "mixed", "prefill")
                  if k in run["by_kind"])
    n = run["launches"]
    variants_ok = (not run["wrong"] and "decode" in kinds
                   and (n["cuda_core"] > 0 if f32 else
                        _counts_ok(run, kinds)))
    return (run["stats"]["completed"] == 8 and run["drained"]
            and all(len(t) == 16 for t in run["tokens"])
            and n["paged_attention_chunk"] > 0 and n["era_scan_interval"] > 0
            and variants_ok)


def _window_summary(run) -> str:
    st = run["stats"]
    return (f"completed={st['completed']} drained={run['drained']} "
            f"steps={st['steps']} mixed_steps={st['mixed_steps']} "
            f"launches={run['launches']} calls by plan kind and variant="
            f"{run['by_kind']} calls off their variant={run['wrong'][:4]}")


def serve_policies(cfg, params, dev, mixed_tokens) -> None:
    """Phase 3d: the scheduler's other paths on phase 3's weights and
    engine (WFE, ``use_kernel=True``, blocks of 16, max_batch 8, chunk
    256, bf16 pages).  (1) ``bucket_policy="pow2"`` on the 8-request
    window: its tokens must equal 3c's WFE run (``maxlen`` buckets).  (2)
    ``sched_policy="prefill_first"`` on the window: complete and drained,
    each call on its variant; its token match against 3c's ``mixed`` run
    is printed, not held (batch composition moves bf16 tokens).  (3) At 8
    layers in f32, ``prefill_first`` against ``mixed`` on the window,
    token for token.  (4) SLO classes under pressure: the 32-request trace
    with every third request in the batch class on a 256-block pool (a
    request needs up to 68): all complete at full length, interactive
    requesters shed batch ones and a batch requester sheds no interactive
    one, and the pool drains.  Each run prints its TTFT and TPOT p50/p95
    (by class for the SLO run)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import era_scan as es
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import init_params
    from repro_torch.serve import ServeEngine

    pow2 = policy_window(cfg, params, dev, bucket_policy="pow2")
    phase("3d pow2 buckets, 8 requests", _window_ok(pow2)
          and pow2["tokens"] == mixed_tokens,
          f"tokens == 3c's maxlen run {pow2['tokens'] == mixed_tokens}; "
          + _window_summary(pow2))
    print(f"  3d pow2: {latency(pow2['reqs'])}", flush=True)

    first = policy_window(cfg, params, dev, sched_policy="prefill_first")
    phase("3d prefill_first, bf16, 8 requests", _window_ok(first)
          and first["stats"]["mixed_steps"] == 0, _window_summary(first))
    print(f"  3d prefill_first bf16: greedy token match against 3c's mixed "
          f"run {token_match(mixed_tokens, first['tokens'])} (not held: "
          f"batch composition moves bf16 tokens); {latency(first['reqs'])}",
          flush=True)
    del pow2, first

    cfg8 = get_config("stablelm-3b").scaled(n_layers=8, dtype=torch.float32)
    params8 = init_params(cfg8, torch.Generator(device=dev).manual_seed(SEED),
                          device=dev)
    runs = {policy: policy_window(cfg8, params8, dev, sched_policy=policy)
            for policy in ("mixed", "prefill_first")}
    del params8
    free_device_memory()
    same = runs["mixed"]["tokens"] == runs["prefill_first"]["tokens"]
    phase("3d prefill_first against mixed, f32, 8 layers, 8 requests",
          same and all(_window_ok(r, f32=True) for r in runs.values()),
          f"tokens equal {same} "
          f"({token_match(runs['mixed']['tokens'], runs['prefill_first']['tokens'])}); "
          + "; ".join(f"{k}: {_window_summary(r)}" for k, r in runs.items()))
    for policy, run in runs.items():
        print(f"  3d {policy} f32 8 layers: {latency(run['reqs'])}",
              flush=True)
    del runs

    n_blocks, new = 256, 64
    engine = ServeEngine(cfg, params, n_blocks=n_blocks, block_size=16,
                         max_batch=8, chunk_size=256, use_kernel=True,
                         device=dev)
    victims = watch_victims(engine.sched)
    tid = engine.pool.register_thread()
    prompts = trace(32, 64, 1024, cfg.vocab_size)
    for ctr in (pa.LAUNCHES, es.LAUNCHES):
        ctr.n = 0
    t0 = time.perf_counter()
    reqs = [engine.submit(p, max_new_tokens=new,
                          slo="batch" if i % 3 == 0 else "interactive")
            for i, p in enumerate(prompts)]
    stats = engine.run(tid)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"paged_attention_chunk": pa.LAUNCHES.n,
                "era_scan_interval": es.LAUNCHES.n}
    drained = (engine.pool.unreclaimed() == 0
               and engine.pool.free_blocks == n_blocks)
    ok = (stats["completed"] == 32 and drained
          and all(len(r.generated) == new for r in reqs)
          and stats["batch_evictions"] > 0
          and ("interactive", "batch") in victims
          and ("batch", "interactive") not in victims
          and all(n > 0 for n in launches.values()))
    shed = {pair: victims.count(pair) for pair in sorted(set(victims))}
    phase("3d SLO classes on a 256-block pool, 32 requests", ok,
          f"completed={stats['completed']} drained={drained} evictions="
          f"{stats['evictions']} batch_evictions={stats['batch_evictions']} "
          f"preemptions by (requester, victim) class={shed} steps="
          f"{stats['steps']} launches={launches}")
    for slo in ("interactive", "batch"):
        print(f"  3d SLO run, {slo}: "
              f"{latency([r for r in reqs if r.slo == slo])}", flush=True)
    gen = sum(len(r.generated) for r in reqs)
    print(f"  3d SLO run: {wall:.3f} s wall, {gen / wall:.2f} output "
          f"tokens/s (host clock) on {gpu_name_and_limit()}", flush=True)
    del engine
    free_device_memory()


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
    # variant ``choose_variant`` gives its shapes, and no f32 tile ran
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
    print(f"  serve ({label} pages), 32 requests: {latency(reqs)}",
          flush=True)
    window = profile_window(engine, tid, cfg)
    generated = [r.generated for r in reqs]
    del engine
    free_device_memory()
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
    free_device_memory()
    return out


def _counts_ok(run, expect_kinds) -> bool:
    """The launch counts agree with the logged calls (a split launch is
    one split and one combine), no f32 tile ran, no call logged per
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


def shard_tokens(dev) -> dict:
    """Phase 4a': stablelm-3b at full width and 8 layers, in f32 and then
    in bf16, the 8-request window with one worker on 1 shard and on 2
    shards, and on 1 shard again with the requests submitted in reverse
    order (the same requests in other batches and plan shapes: the control
    for what batch composition alone changes).  f32 queries take the f32
    split and the f32 tile, bf16 ones the bf16 split and the
    tensor-core tile (phase 4a's path).  Each run must complete at full
    length and drain; the greedy token matches are printed by type, with
    no floor."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        label = str(dtype).split(".")[-1]
        cfg = get_config("stablelm-3b").scaled(n_layers=8, dtype=dtype)
        params = init_params(cfg,
                             torch.Generator(device=dev).manual_seed(SEED),
                             device=dev)
        window = trace(8, 256, 768, cfg.vocab_size, salt=1)
        runs = {}
        for name, shards, prompts in (("1 shard", 1, window),
                                      ("2 shards", SHARDS, window),
                                      ("1 shard, reversed", 1, window[::-1])):
            r = guarded(f"4a' {label} {name}", serve_sharded, cfg, params,
                        dev, prompts, 16, workers=1, shards=shards)
            if r is None:
                continue
            if prompts is not window:
                r["tokens"] = r["tokens"][::-1]
            phase(f"4a' serve stablelm-3b full width, 8 layers, {label}, "
                  f"{name}, 1 worker, 8 requests", _full(r, 8, 16),
                  _summary(r))
            runs[name] = r
        if len(runs) == 3:
            one = runs["1 shard"]["tokens"]
            out[label] = m = {
                "2 shards": token_match(one, runs["2 shards"]["tokens"]),
                "1 shard reversed": token_match(
                    one, runs["1 shard, reversed"]["tokens"])}
            print(f"  4a' {label} greedy token match against the 1-shard "
                  f"run: 2 shards {m['2 shards']}; 1 shard with the "
                  f"requests submitted in reverse order "
                  f"{m['1 shard reversed']}", flush=True)
        del params
        free_device_memory()
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
    launch split + combine, the prompts' chunks the tile, no f32 tile,
    and the era scan runs."""
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
    free_device_memory()


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


def step_matches_cpu(dev, arch="stablelm-3b"):
    """Full-width, 2-layer fp32 model: one prefill chunk and one decode
    step on the card (CUDA kernels) against the same step on the CPU
    (plain versions), from the same weights and pools.  The weights of
    another arch than stablelm-3b are drawn on the card and copied over
    (drawing them on the CPU takes longer)."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serve import init_pools, paged_decode_step, paged_prefill_chunk

    cfg = get_config(arch).scaled(n_layers=2, dtype=torch.float32)
    if arch == "stablelm-3b":
        params = init_params(cfg, torch.Generator().manual_seed(SEED),
                             device="cpu")
    else:
        params = _to(init_params(
            cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev),
            "cpu")
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
    name = "" if arch == "stablelm-3b" else f" {arch}"
    phase(f"full-width{name} 2-layer fp32 step: CUDA vs CPU plain path",
          err <= tol and finite and shape_ok,
          f"max_abs_err={err:.3e} (tol {tol}), finite={finite}")
    del params, out
    free_device_memory()


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


# ------------------------------------------------------------ phase 6: archs
#: the dense archs served besides stablelm-3b, and their parameters at full
#: width (tests/test_torch_archs.py holds the same counts against
#: ``jax.eval_shape`` of the reference's init)
ARCH_PARAMS = {"starcoder2-3b": 3_180_705_792, "starcoder2-7b": 7_399_351_296,
               "gemma-7b": 8_537_680_896, "pixtral-12b": 12_273_996_800}
#: the archs whose grouped heads at D 128 phase 2 holds (KH 2 / 4 / 8, G
#: 12 / 9 / 4)
GQA_ARCHS = ("starcoder2-3b", "starcoder2-7b", "pixtral-12b")


def serve_arch_window(cfg, params, dev, kv_dtype=None) -> dict:
    """The phase 3 engine (WFE, use_kernel=True, 2048 blocks of 16, max
    batch 8, chunk 256, one shard) serving the 8-request window (prompts of
    256-768 tokens, 16 new tokens) of ``cfg`` with ``kv_dtype`` pages.
    Launch counts are zeroed just before and read just after; each
    paged-attention call's launched variant is held against
    ``choose_variant``.  Checks phase 3's limits and returns the launch
    counts (by kind, variant and, under ``by_kind``, by plan kind)."""
    from repro_torch.kernels import era_scan as es
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.serve import ServeEngine

    n_blocks = 2048
    engine = ServeEngine(cfg, params, n_blocks=n_blocks, block_size=16,
                         max_batch=8, chunk_size=256, scheme="WFE",
                         use_kernel=True, kv_dtype=kv_dtype, device=dev)
    tid = engine.pool.register_thread()
    log = PlanLog(engine, per_call=True)
    torch.cuda.synchronize()
    pa.LAUNCHES.n = pa.LAUNCHES_Q8.n = es.LAUNCHES.n = 0
    for ctr in pa.VARIANT_LAUNCHES.values():
        ctr.n = 0
    wall, by_kind_s, reqs = _window(engine, tid, cfg, salt=1)
    launches = {"paged_attention_chunk": pa.LAUNCHES.n,
                "paged_attention_chunk_int8": pa.LAUNCHES_Q8.n,
                "era_scan_interval": es.LAUNCHES.n}
    variants = {k: ctr.n for k, ctr in pa.VARIANT_LAUNCHES.items()}
    log.close()
    by_kind = log.by_kind()
    attn = ("paged_attention_chunk_int8" if kv_dtype == "int8"
            else "paged_attention_chunk")
    path = {attn, "era_scan_interval"}
    stats = engine.sched.stats
    toks = [r.generated for r in reqs]
    kinds_ok = (set(by_kind) == {"decode", "mixed", "prefill"}
                and set(by_kind["decode"]) == {"split"}
                and _counts_ok(dict(by_kind=by_kind, launches=variants,
                                    wrong=log.wrong),
                               ("decode", "mixed", "prefill")))
    ok = (stats["completed"] == 8 and all(len(t) == 16 for t in toks)
          and all(0 <= t < cfg.vocab_size for x in toks for t in x)
          and engine.pool.unreclaimed() == 0
          and engine.pool.free_blocks == n_blocks and kinds_ok
          and all((n > 0) == (k in path) for k, n in launches.items()))
    label = kv_dtype or "bf16"
    phase(f"6 serve {cfg.name} full width, {label} pages, 8 requests", ok,
          f"completed={stats['completed']} unreclaimed="
          f"{engine.pool.unreclaimed()} free_blocks={engine.pool.free_blocks}"
          f"/{n_blocks} launches={launches} variants={variants}; calls by "
          f"plan kind and variant: {by_kind}; calls off their variant: "
          f"{log.wrong[:4]}")
    gen = sum(map(len, toks))
    kinds = ", ".join(f"{k}: {len(v)} steps, mean {np.mean(v) * 1e3:.2f} ms"
                      for k, v in sorted(by_kind_s.items()))
    kv_bytes = sum(t.numel() * t.element_size() for t in engine.pools.values())
    print(f"  {cfg.name} ({label} pages): {gen / wall:.2f} output tokens/s "
          f"(host clock), {wall:.3f} s wall; {kinds}; KV pools "
          f"{kv_bytes / 2**30:.3f} GiB; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on "
          f"{gpu_name_and_limit()}", flush=True)
    del engine, log
    free_device_memory()
    return dict(launches, by_kind=by_kind, **variants)


def serve_archs(dev) -> dict:
    """Phase 6, one arch resident at a time: full-width bf16 weights from a
    seeded generator (the parameter count held against ``ARCH_PARAMS``),
    the 8-request window on one shard (gemma-7b also with int8 pages),
    then the model step at full width and 2 layers against the plain path
    on the CPU.  Returns each run's launches by arch (and page type)."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    out = {}
    for arch, want in ARCH_PARAMS.items():
        t0 = time.perf_counter()
        cfg = get_config(arch)
        torch.cuda.reset_peak_memory_stats()
        params = guarded(f"6 {arch} init", init_params, cfg,
                         torch.Generator(device=dev).manual_seed(SEED),
                         device=dev)
        if params is None:
            continue
        n_params = sum(t.numel() for t in _leaves(params))
        torch.cuda.synchronize()
        phase(f"6 {arch} full width: parameter count", n_params == want,
              f"{n_params} params in {cfg.dtype} (want {want}), "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB peak "
              f"after init")
        for kv in (None, "int8") if arch == "gemma-7b" else (None,):
            launches = guarded(f"6 serve {arch} {kv or 'bf16'}",
                               serve_arch_window, cfg, params, dev, kv)
            if launches is not None:
                out[(arch, kv or "bf16")] = launches
        zoo = guarded(f"6 {arch} model-zoo prefill", zoo_dense_prefill, cfg,
                      params, dev)
        if zoo is not None:
            out[(arch, "zoo")] = zoo
        del params
        free_device_memory()
        guarded(f"6 {arch} step", step_matches_cpu, dev, arch)
        print(f"  phase 6 {arch}: {time.perf_counter() - t0:.1f} s",
              flush=True)
    return out


# ------------------------------------------------------------ phase 7: zoo
#: phase 7's archs and their depth on the card (None: the full depth): the
#: deepest stack that leaves at least 10 GiB of the 80 free.  At 4 and 16
#: layers the bf16 runs peaked at 36.07 and 48.14 GiB (H100 80GB HBM3,
#: 700 W), weights included, so deepseek-v2-236b keeps 8 of its 60 layers
#: (7.4 GiB each: about 66 GiB) and mixtral-8x7b 24 of 32 (2.7 GiB each:
#: about 70 GiB)
ZOO_DEPTH = {"deepseek-v2-236b": 8, "mixtral-8x7b": 24,
             "recurrentgemma-2b": None, "xlstm-350m": None,
             "whisper-small": None}
#: the f32 consistency run's depth: one group of the block pattern
#: (whisper: 2 decoder and 2 encoder layers)
ZOO_F32_LAYERS = {"deepseek-v2-236b": 2, "mixtral-8x7b": 2,
                  "recurrentgemma-2b": 13, "xlstm-350m": 8,
                  "whisper-small": 2}
#: bf16 prompt lengths (default 1024; whisper's are decoder tokens over
#: 1500 frames), at batch ZOO_BATCH, then ZOO_NEW greedy decode steps
ZOO_PROMPT = {"deepseek-v2-236b": 512, "whisper-small": 256}
ZOO_BATCH, ZOO_NEW = 4, 32
#: each arch's parameters at full width and depth, total and active
#: (tests/test_torch_models.py holds ``count_params`` to the reference's)
ZOO_PARAMS = {"deepseek-v2-236b": (239_375_569_920, 21_376_619_520),
              "mixtral-8x7b": (46_702_792_704, 12_879_925_248),
              "recurrentgemma-2b": (2_894_574_080, 2_894_574_080),
              "xlstm-350m": (476_862_632, 476_862_632),
              "whisper-small": (285_974_016, 285_974_016)}
#: paged latent decode: block size and steps
MLA_BLOCK, MLA_STEPS = 16, 8


def zoo_counters():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import attention

    return {"kernel": attention.FLASH_ROUTES["kernel"],
            "plain": attention.FLASH_ROUTES["plain"],
            "launches": fa.LAUNCHES}


def zoo_zero() -> None:
    """Zero the flash routes and the flash kernel's launch counts."""
    from repro_torch.kernels import flash_attention as fa

    torch.cuda.synchronize()
    for ctr in (*zoo_counters().values(), *fa.VARIANT_LAUNCHES.values()):
        ctr.n = 0


def zoo_read() -> dict:
    torch.cuda.synchronize()
    return {k: ctr.n for k, ctr in zoo_counters().items()}


def expected_routes(cfg, t: int, decode: bool = False) -> tuple:
    """(kernel, plain) flash calls of one prefill of t tokens (or of one
    decode step) on the card: the route table of ``models.attention``."""
    n_attn = cfg.n_groups * sum(k in ("attn", "local_attn", "swa")
                                for k in cfg.block_pattern)
    if cfg.is_encoder_decoder:  # cross-attention takes the plain route
        return ((0, cfg.n_layers) if decode else
                (cfg.n_encoder_layers + cfg.n_layers, cfg.n_layers))
    if decode:
        return 0, 0
    windowed = any(k in ("local_attn", "swa") for k in cfg.block_pattern)
    if cfg.use_mla or (windowed and t > cfg.window):
        return 0, n_attn
    return n_attn, 0


def _zoo_inputs(cfg, b, t, gen, dev):
    toks = torch.randint(0, cfg.vocab_size, (b, t), generator=gen,
                         device=dev, dtype=torch.int32)
    extra = {}
    if cfg.frontend == "frames":
        extra["frames"] = 0.02 * torch.randn(
            (b, cfg.encoder_ctx, cfg.d_model), generator=gen, device=dev)
    return toks, extra


def _routes_ok(got, want) -> bool:
    return ((got["kernel"], got["plain"]) == tuple(want)
            and got["launches"] == got["kernel"])


def zoo_dense_prefill(cfg, params, dev) -> dict:
    """The model zoo's prefill of a served dense arch at B 1 and T 4096 on
    its resident bf16 weights: one flash kernel call per layer and none
    on the plain route.  Returns the counts."""
    from repro_torch.models import build_model

    gen = torch.Generator(device=dev).manual_seed(SEED)
    toks, _ = _zoo_inputs(cfg, 1, 4096, gen, dev)
    zoo_zero()
    t0 = time.perf_counter()
    logits, _ = build_model(cfg).prefill(params, toks)
    finite = bool(torch.isfinite(logits).all())
    got = zoo_read()
    wall = time.perf_counter() - t0
    want = expected_routes(cfg, 4096)
    phase(f"model zoo {cfg.name} prefill B 1 T 4096, flash routes",
          finite and _routes_ok(got, want),
          f"routes {got} (want kernel, plain = {want}), finite={finite}, "
          f"{wall * 1e3:.1f} ms (host clock) on {gpu_name_and_limit()}")
    return got


def _mla_pages(cfg, cache, b, s, total, gen, dev):
    """``init_mla_pools`` pages of MLA_BLOCK tokens holding every layer's
    first s latent rows (c_kv ‖ k_rope) of ``cache``, written through
    permuted, non-contiguous block tables sized for ``total`` tokens.
    Returns (pools, tables)."""
    from repro_torch.serve import init_mla_pools

    assert s % MLA_BLOCK == 0
    per = -(-total // MLA_BLOCK)
    n_blocks = b * per + 8
    pools = init_mla_pools(cfg, n_blocks, MLA_BLOCK, device=dev)
    tables = torch.randperm(n_blocks, generator=gen, device=dev)[
        :b * per].reshape(b, per).to(torch.int32)
    c = cache["groups"]["b0_attn"]
    rows = torch.cat([c["c_kv"][:, :, :s], c["k_rope"][:, :, :s]], -1)
    full = tables[:, :s // MLA_BLOCK].long()
    for l in range(rows.shape[0]):
        pools["lat"][l][full] = rows[l].reshape(
            b, s // MLA_BLOCK, MLA_BLOCK, -1).to(pools["lat"].dtype)
    return pools, tables


def zoo_f32(arch, dev) -> int:
    """One group of the block pattern in f32 at full width: prefill of 64
    tokens at B 2 and two decode_steps against forward (the identity and
    tolerance of tests/test_arch_smoke.py:94-119).  MoE configs take the
    drop-free capacity of the reference's smoke configs (capacity factor
    E / k), since dropping depends on the co-batch.  For MLA, the prefill's
    latents are copied into pages and MLA_STEPS paged_mla_decode_steps run
    against decode_step on the same tokens.  Returns the flash kernel's
    ``cuda_core`` (f32 tile) launches of the run (counts zeroed just before
    it)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import build_model, init_params
    from repro_torch.serve import paged_mla_decode_step

    cfg = get_config(arch)
    over = dict(n_layers=ZOO_F32_LAYERS[arch], dtype=torch.float32)
    if cfg.is_encoder_decoder:
        over["n_encoder_layers"] = 2
    if cfg.is_moe:
        over["capacity_factor"] = cfg.n_experts / cfg.top_k
    cfg = cfg.scaled(**over)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = init_params(cfg, gen, device=dev)
    model = build_model(cfg)
    b, s = 2, 64
    steps = MLA_STEPS if cfg.use_mla else 2
    toks, extra = _zoo_inputs(cfg, b, s + steps, gen, dev)
    zoo_zero()
    full = model.forward(params, toks[:, :s + 2], extra)
    lg, cache = model.prefill(params, toks[:, :s], max_len=s + steps,
                              extra=extra)
    errs = [(lg - full[:, s - 1]).abs().max()]
    finite = [torch.isfinite(full).all()]
    if cfg.use_mla:
        pools, tables = _mla_pages(cfg, cache, b, s, s + steps, gen, dev)
    paged = []
    for i in range(steps):
        pos = torch.full((b,), s + i, dtype=torch.int32, device=dev)
        if cfg.use_mla:
            lp, pools = paged_mla_decode_step(cfg, params, pools, tables,
                                              pos + 1, toks[:, s + i], pos)
        lg, cache = model.decode_step(params, cache, toks[:, s + i], pos)
        if i < 2:
            errs.append((lg - full[:, s + i]).abs().max())
        if cfg.use_mla:
            paged.append((lp - lg).abs().max())
        finite.append(torch.isfinite(lg).all())
    got = zoo_read()
    variants = {n: c.n for n, c in fa.VARIANT_LAUNCHES.items()}
    err = max(e.item() for e in errs)
    fin = all(bool(f) for f in finite)
    tol = 2e-3
    layers = f"{cfg.n_layers} layers" + (
        f" + {cfg.n_encoder_layers} encoder" if cfg.is_encoder_decoder
        else "")
    want = tuple(map(sum, zip(expected_routes(cfg, s + 2),
                              expected_routes(cfg, s),
                              *[expected_routes(cfg, s, True)] * steps)))
    phase(f"7 {arch} f32 at full width ({layers}): prefill + 2 "
          f"decode_steps vs forward", err <= tol and fin
          and _routes_ok(got, want) and variants["tile"] == 0,
          f"max_abs_err={err:.3e} (tol {tol}), finite={fin}; flash routes "
          f"{got} (want {want}), by variant {variants}")
    if cfg.use_mla:
        perr = max(e.item() for e in paged)
        phase(f"7 {arch} f32 paged latent decode ({MLA_STEPS} steps, block "
              f"{MLA_BLOCK}, permuted tables) vs decode_step", perr <= tol,
              f"max_abs_err={perr:.3e} (tol {tol})")
    del params, cache, full
    free_device_memory()
    return variants["cuda_core"]


def moe_plain(cfg, p, x, round_gating=False):
    """``apply_moe``'s routed experts on x (B, S, d), computed expert by
    expert over its kept assignments, independently of the port's
    dispatch: an f32 router product, top-k renormalized, each expert
    keeping its first ``capacity`` assignments in (token, choice) order;
    f32 gate and up products, their gated product and the down projection
    rounded to x's dtype, each token's weighted outputs summed in f32 and
    rounded once.  ``round_gating`` rounds gate and up to x's dtype first
    (a planted fault: the gating precision the reference does not use)."""
    import torch.nn.functional as F

    b, s, d = x.shape
    t, e, k, wdt = b * s, cfg.n_experts, cfg.top_k, x.dtype
    xf = x.reshape(t, d)
    probs = torch.softmax(xf.float() @ p["router"].to(wdt).float(), -1)
    top_p, top_e = torch.topk(probs, k, -1)
    top_p = (top_p / top_p.sum(-1, keepdim=True)).reshape(-1)
    cap = int(cfg.capacity_factor * t * k / e)
    cap = min(max(8, -(-cap // 8) * 8), t * k)
    flat = top_e.reshape(-1)
    onehot = F.one_hot(flat, e)
    keep = ((onehot.cumsum(0) - onehot) * onehot).sum(-1) < cap
    out = torch.zeros((t * k, d), dtype=torch.float32, device=x.device)
    for ex in flat[keep].unique().tolist():
        idx = torch.nonzero((flat == ex) & keep).squeeze(1)
        xe = xf[idx // k].float()
        g = xe @ p["wi_gate"][ex].to(wdt).float()
        u = xe @ p["wi_up"][ex].to(wdt).float()
        if round_gating:
            g, u = g.to(wdt).float(), u.to(wdt).float()
        h = (F.silu(g) * u).to(wdt)
        y = (h.float() @ p["wo"][ex].to(wdt).float()).to(wdt)
        out[idx] = (y * top_p[idx, None].to(wdt)).float()
    return out.reshape(t, k, d).sum(1).to(wdt).reshape(b, s, d)


#: bf16 ``apply_moe`` against ``moe_plain``: relative RMS error limit.  The
#: two share their rounding points; their f32 sums differ in order (the
#: port's GEMMs take bf16 operands with f32 output, the plain version f32
#: operands), by about 1e-5, which flips a share of the bf16 roundings of
#: the gated product and the output by one step: about 1.1e-3 on an H100
#: (one bf16 rounding step is about 1.1e-3 in relative RMS).  Gate and up
#: rounded to bf16 before silu, the planted fault, give about 4.7e-3
MOE_REL_RMS = 2.5e-3


def check_moe_bf16(cfg, params, dev) -> None:
    """The first layer's routed experts in bf16 at phase 7's prefill and
    decode shapes (B 4 x the prompt, B 4 x 1) against ``moe_plain``, and
    the planted fault of bf16 gating, which must fail the limit."""
    from repro_torch.models import moe
    from repro_torch.models.layers import index_tree

    routed = cfg.scaled(n_shared_experts=0)
    p = index_tree(params["groups"][f"b0_{cfg.block_pattern[0]}"]["mlp"], 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    rel = lambda a, w: ((a.float() - w.float()).norm()  # noqa: E731
                        / w.float().norm()).item()
    for s in (ZOO_PROMPT.get(cfg.name, 1024), 1):
        x = torch.randn((ZOO_BATCH, s, cfg.d_model), generator=gen,
                        device=dev).to(cfg.dtype)
        got = moe.apply_moe(routed, p, x)
        want = moe_plain(routed, p, x)
        err, fault = rel(got, want), rel(moe_plain(routed, p, x, True), want)
        phase(f"7 {cfg.name} bf16 MoE B {ZOO_BATCH} x {s} vs the f32-product"
              f" plain version", err <= MOE_REL_RMS < fault
              and bool(torch.isfinite(got).all()),
              f"rel_rms={err:.3e} (limit {MOE_REL_RMS}); bf16 gating "
              f"(planted fault) {fault:.3e}")


def zoo_window(cfg, params, dev) -> dict:
    """Prefills at B 1 of exactly the window (the flash kernel on every
    windowed layer) and of the window + 512 (the plain banded route),
    timed.  Returns both runs' counts and ms."""
    from repro_torch.models import build_model

    model = build_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    out = {}
    for t in (cfg.window, cfg.window + 512):
        toks, _ = _zoo_inputs(cfg, 1, t, gen, dev)
        model.prefill(params, toks[:, :256])  # warm the shapes' kernels
        zoo_zero()
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, toks)
        finite = bool(torch.isfinite(logits).all())
        got = zoo_read()
        ms = (time.perf_counter() - t0) * 1e3
        want = expected_routes(cfg, t)
        route = "kernel" if t <= cfg.window else "plain banded"
        phase(f"7 {cfg.name} prefill B 1 T {t} ({route} route)",
              finite and _routes_ok(got, want),
              f"routes {got} (want kernel, plain = {want}), {ms:.1f} ms "
              f"(host clock) on {gpu_name_and_limit()}")
        out[t] = dict(got, ms=ms)
        del cache
    return out


def zoo_bf16(arch, dev) -> dict:
    """The arch in bf16 at ZOO_DEPTH: the parameter count, a prefill of
    ZOO_BATCH seeded prompts and ZOO_NEW greedy decode steps with the
    flash routes held to the table; the window prefills (mixtral,
    recurrentgemma); deepseek's paged greedy decode against the
    contiguous one (printed).  Returns the counts."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, count_params, init_params
    from repro_torch.serve import paged_mla_decode_step

    full_cfg = get_config(arch)
    depth = ZOO_DEPTH[arch]
    cfg = full_cfg if depth is None else full_cfg.scaled(n_layers=depth)
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2**30  # by earlier phases
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    params = init_params(cfg, gen, device=dev)
    n = sum(t.numel() for t in _leaves(params))
    torch.cuda.synchronize()
    counts = (count_params(full_cfg), count_params(full_cfg, True))
    phase(f"7 {arch} parameters", counts == ZOO_PARAMS[arch]
          and n == count_params(cfg),
          f"full: {counts[0]} (active {counts[1]}; want {ZOO_PARAMS[arch]});"
          f" resident {n} at {cfg.n_layers} of {full_cfg.n_layers} layers in "
          f"{cfg.dtype}, peak {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB ({held:.2f} GiB held before), init "
          f"{time.perf_counter() - t0:.1f} s")
    if cfg.is_moe:
        guarded(f"7 {arch} bf16 MoE", check_moe_bf16, cfg, params, dev)
    model = build_model(cfg)
    b, t = ZOO_BATCH, ZOO_PROMPT.get(arch, 1024)
    toks, extra = _zoo_inputs(cfg, b, t, gen, dev)
    model.prefill(params, toks[:1, :128], extra={k: v[:1] for k, v in
                                                 extra.items()})  # warm up
    zoo_zero()
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, toks, max_len=t + ZOO_NEW,
                                  extra=extra)
    pre = zoo_read()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    if cfg.use_mla:  # pages before decode_step writes the cache in place
        pools, tables = _mla_pages(cfg, cache, b, t, t + MLA_STEPS, gen, dev)
    finite = torch.isfinite(logits).all()
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    first = tok
    dense = []
    t0 = time.perf_counter()
    for i in range(ZOO_NEW):
        pos = torch.full((b,), t + i, dtype=torch.int32, device=dev)
        logits, cache = model.decode_step(params, cache, tok, pos)
        finite &= torch.isfinite(logits).all()
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        dense.append(tok)
    dec = zoo_read()
    decode_s = time.perf_counter() - t0
    dec = {k: dec[k] - pre[k] for k in dec}
    want_pre = expected_routes(cfg, t)
    want_dec = tuple(ZOO_NEW * n for n in expected_routes(cfg, t, True))
    fin = bool(finite)
    phase(f"7 {arch} bf16 at {cfg.n_layers} layers: prefill B {b} x {t} "
          f"+ {ZOO_NEW} greedy decode_steps", fin and _routes_ok(pre, want_pre)
          and _routes_ok(dec, want_dec),
          f"finite={fin}; prefill routes {pre} (want {want_pre}); decode "
          f"routes {dec} (want {want_dec})")
    # a decode step reads every weight of the stack and the head at least
    # once (MoE: the capacity floor of 8 slots gives every expert a
    # buffer); not the encoder, the position tables or an untied
    # embedding table, of which it gathers B rows
    skip = {"encoder", "dec_pos", "frontend"} | (
        set() if cfg.tie_embeddings else {"embed"})
    bound_ms = sum(t.numel() * t.element_size() for k, v in params.items()
                   if k not in skip for t in _leaves(v)) / HBM_BPS * 1e3
    print(f"  7 {arch} bf16, {cfg.n_layers} layers, B {b}: prefill {t} "
          f"tokens {prefill_ms:.1f} ms, decode {decode_s / ZOO_NEW * 1e3:.2f}"
          f" ms/step (weight-read bound {bound_ms:.2f} ms), "
          f"{b * ZOO_NEW / decode_s:.1f} tokens/s (host clock), "
          f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"({held:.2f} GiB held before) on {gpu_name_and_limit()}",
          flush=True)
    out = {"prefill": pre, "decode": dec, "prefill_ms": prefill_ms,
           "decode_ms": decode_s / ZOO_NEW * 1e3}
    if cfg.use_mla:
        tok, match = first, 0
        for i in range(min(MLA_STEPS, ZOO_NEW)):
            pos = torch.full((b,), t + i, dtype=torch.int32, device=dev)
            lp, pools = paged_mla_decode_step(cfg, params, pools, tables,
                                              pos + 1, tok, pos)
            tok = torch.argmax(lp, dim=-1).to(torch.int32)
            match += int((tok == dense[i]).sum())
        print(f"  7 {arch} bf16 paged latent decode: greedy token match "
              f"{match}/{b * MLA_STEPS} against decode_step (not held)",
              flush=True)
        del pools
    del cache, logits
    if cfg.window is not None:
        out["window"] = guarded(f"7 {arch} window", zoo_window, cfg, params,
                                dev)
    del params
    free_device_memory()
    return out


def f32_products(dev) -> None:
    """``layers.matmul(x, w, dtype=float32)`` on bf16 activations at
    recurrentgemma-2b's gate width (x (4, 64, 2560), w (2560, 2560) x
    0.02, seeded): a bf16 GEMM with f32 output.  Against the exact (f64)
    product of the same bf16 operands it must be within f32 accumulation
    order, 2 sqrt(K) u of the largest |product| (u = 2**-24: 6.0e-6 at K
    2560), as the f32 product of the upcast operands on the CPU (the
    reference's ``preferred_element_type=f32`` dot) is; both errors are
    printed beside the bf16-rounded product's.  Its gradients against the
    CPU's within one bf16 step (2**-7) of their largest magnitude, and the
    MoE expert product's batched form (K 256) within the same order.
    Prints the GEMM's time beside the bf16-output one's (CUDA events)."""
    from repro_torch.models import layers

    gen = torch.Generator().manual_seed(SEED)
    x = torch.randn(4, 64, 2560, generator=gen).to(torch.bfloat16)
    w = torch.randn(2560, 2560, generator=gen) * 0.02
    g = torch.randn(4, 64, 2560, generator=gen)
    xd, wd = x.to(dev).requires_grad_(), w.to(dev).requires_grad_()
    got = layers.matmul(xd, wd, dtype=torch.float32)
    got.backward(g.to(dev))
    wb = w.to(torch.bfloat16)
    exact = x.double() @ wb.double()
    scale = exact.abs().max().item()

    def order(k):  # f32 accumulation order over k terms, of the largest
        return 2 * math.sqrt(k) * 2.0 ** -24

    def err(a, want=exact):
        return (a.detach().cpu().double() - want).abs().max().item() / \
            want.abs().max().item()

    card, cpu = err(got), err(x.float() @ wb.float())
    rounded = err(torch.matmul(x, wb))
    xc, wc = x.clone().requires_grad_(), w.clone().requires_grad_()
    layers.matmul(xc, wc, dtype=torch.float32).backward(g)

    def rel(a, b):  # largest |a - b| over the largest |b|
        a, b = a.float().cpu(), b.float().cpu()
        return ((a - b).abs().max() / b.abs().max()).item()

    # on the card the f32 cotangent enters the bf16 GEMM rounded (the
    # CPU's product keeps it f32)
    dx_rel, dw_rel = rel(xd.grad, xc.grad), rel(wd.grad, wc.grad)
    rows = torch.randn(4, 96, 256, generator=gen).to(torch.bfloat16)
    ew = (torch.randn(4, 256, 512, generator=gen) * 0.05).to(torch.bfloat16)
    bmm = err(layers.product(rows.to(dev), ew.to(dev), batched=True),
              rows.double() @ ew.double())
    ok = (got.dtype == torch.float32 and card <= order(2560)
          and bmm <= order(256) and max(dx_rel, dw_rel) <= 2 ** -7)
    a, b = x.to(dev).reshape(-1, 2560), wb.to(dev)
    f32_ms = time_ms(lambda: torch.mm(a, b, out_dtype=torch.float32))
    bf16_ms = time_ms(lambda: torch.mm(a, b))
    phase("7 f32-output products on the card", ok,
          f"matmul against the exact product, of max |product| {scale:.3f}: "
          f"card {card:.2e}, CPU f32 {cpu:.2e}, rounded to bf16 {rounded:.2e}"
          f" (limit {order(2560):.2e}); batched {bmm:.2e} (limit "
          f"{order(256):.2e}); gradients against the CPU's, relative to "
          f"their largest: dx {dx_rel:.2e}, dw {dw_rel:.2e} (limit 2**-7); "
          f"GEMM (256 x 2560 x 2560) f32 output {f32_ms:.4f} ms against bf16"
          f" output {bf16_ms:.4f} ms (eager) on {gpu_name_and_limit()}")


def zoo_phase(dev) -> dict:
    """Phase 7, one arch resident at a time: the f32 consistency run, then
    the bf16 run at ZOO_DEPTH.  Returns the bf16 runs' counts by arch,
    with the f32 run's f32-tile flash launches under ``f32_cuda_core``."""
    out = {}
    guarded("7 f32-output products", f32_products, dev)
    for arch in ZOO_DEPTH:
        t0 = time.perf_counter()
        f32 = guarded(f"7 {arch} f32", zoo_f32, arch, dev)
        res = guarded(f"7 {arch} bf16", zoo_bf16, arch, dev)
        out[arch] = dict(res or {}, f32_cuda_core=f32 or 0)
        print(f"  phase 7 {arch}: {time.perf_counter() - t0:.1f} s",
              flush=True)
    return out


# ------------------------------------------------------------ phase 8: train
#: bf16 flash backward limits, from the gradients' own magnitudes: each of
#: dQ, dK and dV elementwise within rtol 2e-2 plus 4 bf16 ulps of its max
#: |want|, and its relative RMS error within this.  The kernel measured
#: at most 1.4e-3 (the forward's output rounded to bf16 enters Delta; the
#: plain version keeps it f32), the planted faults 0.14 and above (H100
#: 80GB HBM3, 700 W)
BWD_REL_RMS = 5e-3
#: f32: the same within f32 rounding of sums in another order
BWD_REL_RMS_F32 = 1e-5
#: the training slice: global batch, sequence, steps
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 2048, 6


def bwd_close(got, want, dtype) -> tuple:
    """(within the limits above, detail) of one gradient."""
    got, want = got.float(), want.float()
    top = want.abs().max().item()
    rel = BWD_REL_RMS if dtype == torch.bfloat16 else BWD_REL_RMS_F32
    if dtype == torch.bfloat16:
        atol, rtol = 4 * 2.0 ** (math.floor(math.log2(max(top, 1e-30))) - 7), 2e-2
    else:
        atol, rtol = 1e-5 * top, 1e-4
    close = torch.allclose(got, want, rtol=rtol, atol=atol)
    rms = ((got - want).norm() / want.norm().clamp(min=1e-30)).item()
    return close and rms <= rel, f"rel_rms={rms:.3e} (limit {rel:g}), " \
        f"max_err={(got - want).abs().max().item():.3e} (atol {atol:.2e} " \
        f"+ rtol {rtol:g}): {close}"


def _bwd_plain(q, k, v, do, causal, fault=None):
    """dQ, dK, dV in f32 from the backward's algebra, with ``fault``: None,
    ``"dkdv unmasked"`` (the causal mask dropped in dK and dV) or
    ``"tail tile skipped"`` (the keys of the last ragged 64-key tile left
    out of every gradient)."""
    b, t, h, d = q.shape
    kh = k.shape[2]
    g = h // kh
    qf, dof = q.float(), do.float()
    kf, vf = (x.float().repeat_interleave(g, 2) for x in (k, v))
    scale = 1.0 / math.sqrt(d)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    pos = torch.arange(t, device=q.device)
    mask = (pos[None, :] <= pos[:, None]) if causal else \
        torch.ones((t, t), dtype=torch.bool, device=q.device)
    lse = torch.logsumexp(torch.where(mask, s, -math.inf), -1, keepdim=True)
    p_all = torch.exp(s - lse)
    p = torch.where(mask, p_all, 0.0)
    o = torch.einsum("bhqk,bkhd->bqhd", p, vf)
    delta = torch.einsum("bqhd,bqhd->bhq", dof, o)[..., None]
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    pk = p_all if fault == "dkdv unmasked" else p
    if fault == "tail tile skipped":
        keep = pos < t - t % 64
        p = pk = torch.where(keep, p, 0.0)
    ds, dsk = p * (dp - delta), pk * (dp - delta)
    dq = scale * torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = scale * torch.einsum("bhqk,bqhd->bkhd", dsk, qf)
    dv = torch.einsum("bhqk,bqhd->bkhd", pk, dof)
    dk, dv = (x.reshape(b, t, kh, g, d).sum(3) for x in (dk, dv))
    return dq, dk, dv


def check_flash_bwd(b, t, h, kh, d, dtype, causal, gen, dev, tag,
                    faults=()):
    """The flash backward (``FlashAttentionFn``'s gradient) against its
    plain version (autograd through the plain forward), timed beside
    SDPA's backward on the same tensors and its bound: 10 D flops per
    visible (query, key) pair and head at the input type's peak, or q, k,
    v, o, dO, lse and the three gradients once over HBM.  Where the route
    takes the tensor-core tile (bf16), the f32 tile (``cuda_core``) is
    forced through ``flash_attention_bwd``'s ``variant`` on the same
    inputs (widened in shared memory), held to the same limits and timed
    in the same run (at a GQA split, the tile also unsplit).  Also: the forward's output the same bits with and without
    the log-sum-exp, the log-sum-exp against the plain one, two calls of
    each variant the same bits.  ``faults``: planted faults of
    ``_bwd_plain`` that must fail the limits.  Returns a row per variant."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_attention_bwd_ref

    q = torch.randn((b, t, h, d), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, t, kh, d), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, t, kh, d), generator=gen, device=dev).to(dtype)
    do = torch.randn((b, t, h, d), generator=gen, device=dev).to(dtype)
    name = (f"flash_attention_bwd {tag}: {str(dtype).split('.')[-1]} "
            f"{'causal' if causal else 'non-causal'} B={b} T={t} H={h} "
            f"KH={kh} D={d}")
    saved = _save_counts()
    route = fa.choose_bwd_variant(dtype, d)
    variants = [route] + [x for x in fa.BWD_VARIANT_LAUNCHES if x != route
                          and route == "tile"]
    out, lse = fa._forward(q, k, v, causal, with_lse=True)
    bare = fa.flash_attention(q, k, v, causal=causal)
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    n0, r0 = fa.BWD_LAUNCHES.n, fa.BWD_VARIANT_LAUNCHES[route].n
    got = torch.autograd.grad(fa.flash_attention(*leaves, causal=causal),
                              leaves, do)
    torch.cuda.synchronize()
    through_fn = (fa.BWD_LAUNCHES.n == n0 + 1
                  and fa.BWD_VARIANT_LAUNCHES[route].n == r0 + 1)
    want = flash_attention_bwd_ref(q, k, v, do, causal=causal)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                     k.float().repeat_interleave(h // kh, 2)) / math.sqrt(d)
    if causal:
        pos = torch.arange(t, device=dev)
        s = torch.where(pos[None, :] <= pos[:, None], s, -math.inf)
    lse_err = (lse - torch.logsumexp(s, -1)).abs().max().item()
    del s
    same = torch.equal(out, bare)
    lse_ok = lse_err <= (1e-4 if dtype == torch.bfloat16 else 1e-5)
    errs = {}
    for variant in variants:
        if variant != route:
            got = fa.flash_attention_bwd(q, k, v, out, do, lse,
                                         causal=causal, variant=variant)
        again = fa.flash_attention_bwd(q, k, v, out, do, lse, causal=causal,
                                       variant=variant)
        bits = all(torch.equal(a, c) for a, c in zip(got, again))
        checks = [bwd_close(g_, w_, dtype) for g_, w_ in zip(got, want)]
        finite = all(bool(torch.isfinite(g_).all()) for g_ in got)
        errs[variant] = max((g_.float() - w_.float()).abs().max().item()
                            for g_, w_ in zip(got, want))
        how = ("through FlashAttentionFn" if variant == route
               else "forced through variant=")
        phase(f"{name} [{variant}] vs plain",
              all(c for c, _ in checks) and finite and same and lse_ok
              and through_fn and bits,
              "; ".join(f"d{n}: {det}" for n, (_, det) in zip("qkv", checks))
              + f"; two calls the same bits: {bits}; forward with lse == "
              f"without: {same}; lse max_err {lse_err:.2e}; {how}: "
              f"{through_fn}")
        del got, again
    for fault in faults:
        bad = _bwd_plain(q, k, v, do, causal, fault)
        seen = [bwd_close(g_, w_, dtype) for g_, w_ in zip(bad, want)]
        phase(f"{name}: planted fault ({fault}) fails the limits",
              not all(c for c, _ in seen),
              "; ".join(f"d{n}: {det}" for n, (_, det) in zip("qkv", seen)))
        del bad
    del want
    times = {}
    for variant in variants:
        kern = lambda: fa.flash_attention_bwd(  # noqa: E731
            q, k, v, out, do, lse, causal=causal, variant=variant)
        times[variant] = (time_ms(kern, reps=5, warmup=1),
                          time_ms(kern, reps=5, warmup=1, graph=True))
    unsplit = None
    if route == "tile" and fa.bwd_splits(b, t, kh, h // kh, d) > 1:
        unsplit = time_ms(lambda: fa.flash_attention_bwd(
            q, k, v, out, do, lse, causal=causal, splits=1), reps=5, warmup=1)
    plain_ms = time_ms(lambda: flash_attention_bwd_ref(q, k, v, do,
                                                       causal=causal),
                       reps=2, warmup=1)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                             enable_gqa=True)
    dot = do.transpose(1, 2)
    lib_ms = time_ms(lambda: torch.autograd.grad(
        lib_out, (qt, kt, vt), dot, retain_graph=True), reps=5, warmup=1)
    del lib_out
    _restore_counts(saved)  # comparison launches do not count
    pairs = t * (t + 1) // 2 if causal else t * t
    t_ops = 10 * d * h * b * pairs / PEAK_OPS[dtype] * 1e3
    t_bytes = ((5 * q.numel() + 4 * k.numel()) * q.element_size()
               + lse.numel() * 4) / HBM_BPS * 1e3
    bound, by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    rows = {}
    for variant in variants:
        ms, device_ms = times[variant]
        rows[variant] = dict(max_abs_err=errs[variant], ms=ms,
                             device_ms=device_ms, plain_ms=plain_ms,
                             bound_ms=bound, bound_by=by, library_ms=lib_ms,
                             variant=variant)
        extra = ""
        if variant == "tile" and unsplit is not None:
            rows[variant]["ms_unsplit"] = unsplit
            extra = (f" ({fa.bwd_splits(b, t, kh, h // kh, d)} splits; "
                     f"unsplit {unsplit:.4f} ms)")
        print(f"  {name} [{variant}]: kernel {ms:.4f} ms{extra} (graph "
              f"replay {device_ms:.4f} ms), plain {plain_ms:.4f} ms, sdpa "
              f"backward {lib_ms:.4f} ms, bound {bound:.4f} ms ({by}) on "
              f"{gpu_name_and_limit()}", flush=True)
    return rows


def check_f32_bwd_ctas(gen, dev) -> None:
    """The f32 tile's 64-row and one-warp CTAs give the same bits (the
    grid picks one by how it fills the card): at 8b's short grid (B 2 T 64
    H 32 D 80), at starcoder2-3b's G 12 over a short T (its GQA split) and
    at D 256 non-causal.  These comparison launches do not count."""
    from repro_torch.kernels import flash_attention as fa

    saved = _save_counts()
    for b, t, h, kh, d, causal in ((2, 64, 32, 32, 80, True),
                                   (1, 300, 24, 2, 128, True),
                                   (2, 130, 8, 2, 256, False)):
        q, do = (torch.randn((b, t, h, d), generator=gen, device=dev)
                 for _ in range(2))
        k, v = (torch.randn((b, t, kh, d), generator=gen, device=dev)
                for _ in range(2))
        out, lse = fa._forward(q, k, v, causal, with_lse=True)
        got = [fa.flash_attention_bwd(q, k, v, out, do, lse, causal=causal,
                                      variant="cuda_core", wide=w)
               for w in (True, False)]
        same = all(torch.equal(a, c) for a, c in zip(*got))
        phase(f"8a f32 tile: 64-row and one-warp CTAs the same bits, f32 "
              f"{'causal' if causal else 'non-causal'} B={b} T={t} H={h} "
              f"KH={kh} D={d} ({fa.bwd_splits(b, t, kh, h // kh, d, 'cuda_core')}"
              f" splits)", same, f"dQ, dK, dV equal: {same}")
    _restore_counts(saved)


def flash_bwd_phase(gen, dev) -> dict:
    """8(a): the backward at phase 2's flash shapes at the training length
    (stablelm-3b, starcoder2-3b's G 12, gemma-7b's D 256) and
    whisper-small's non-causal encoder over 1500 frames (a ragged last
    tile), each in bf16 and f32; the two planted faults in both types; the
    f32 tile's CTA widths bitwise; and the forward at the training
    microbatch's shape for the kernels line."""
    f32, bf16 = torch.float32, torch.bfloat16
    rows = {
        "stablelm-3b": check_flash_bwd(1, 2048, 32, 32, 80, bf16, True, gen,
                                       dev, "stablelm-3b train",
                                       faults=("dkdv unmasked",)),
        "stablelm-3b f32": check_flash_bwd(1, 2048, 32, 32, 80, f32, True,
                                           gen, dev, "stablelm-3b train",
                                           faults=("dkdv unmasked",)),
        "starcoder2-3b": check_flash_bwd(1, 2048, 24, 2, 128, bf16, True,
                                         gen, dev, "starcoder2-3b"),
        "starcoder2-3b f32": check_flash_bwd(1, 2048, 24, 2, 128, f32, True,
                                             gen, dev, "starcoder2-3b"),
        "gemma-7b": check_flash_bwd(1, 2048, 16, 16, 256, bf16, True, gen,
                                    dev, "gemma-7b"),
        "gemma-7b f32": check_flash_bwd(1, 2048, 16, 16, 256, f32, True, gen,
                                        dev, "gemma-7b"),
        "whisper-small": check_flash_bwd(4, 1500, 12, 12, 64, bf16, False,
                                         gen, dev, "whisper-small encoder",
                                         faults=("tail tile skipped",)),
        "whisper-small f32": check_flash_bwd(4, 1500, 12, 12, 64, f32, False,
                                             gen, dev,
                                             "whisper-small encoder",
                                             faults=("tail tile skipped",)),
    }
    check_f32_bwd_ctas(gen, dev)
    rows["forward"] = check_flash(1, TRAIN_SEQ, 32, 32, 80, torch.bfloat16,
                                  True, gen, dev, 2e-2,
                                  "stablelm-3b train microbatch")
    free_device_memory()
    return rows


def _update_rel(p1, p0, ref1) -> float:
    """||(p1 - p0) - (ref1 - p0)|| / ||ref1 - p0|| over every leaf."""
    num = den = 0.0
    for a, z, r in zip(p1, p0, ref1):
        a, z, r = a.double().cpu(), z.double(), r.double().cpu()
        num += ((a - z) - (r - z)).square().sum().item()
        den += (r - z).square().sum().item()
    return math.sqrt(num / max(den, 1e-300))


def train_step_matches_cpu(dev) -> None:
    """8(b): stablelm-3b at full width, 2 layers, f32, remat on, B 2 S 64:
    one ``make_train_step`` step on the card (flash forward and backward
    kernels) against the same step on the CPU (plain route), from the same
    seeded master weights; then the card's step with 1 and 2 microbatches.
    Limits: loss and grad norm within 1e-4 relative; the parameter update
    (new - old, every leaf) within 1e-2 in relative L2: Adam's first step
    moves each element by about lr * sign(g), so elements whose gradient is
    near 0 and flips sign between two summation orders move by up to 2 lr
    (the share of such elements is printed)."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import build_model, init_params
    from repro_torch.train import AdamWConfig, make_train_step
    from repro_torch.train.optim import adamw_init, tree_leaves, tree_map

    cfg = get_config("stablelm-3b").scaled(n_layers=2, dtype=torch.float32)
    base = init_params(cfg, torch.Generator().manual_seed(SEED),
                       device="cpu", master=True)
    p0 = tree_leaves(base)
    batch = SyntheticLMData(cfg.vocab_size, 64, 2, seed=SEED).batch_at(0)
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    out = {}
    for d, n in (("cpu", 1), ("cuda", 1), ("cuda", 2)):
        c = cfg.scaled(num_microbatches=n)
        params = tree_map(lambda x: x.to(d, copy=True), base)
        state = {"params": params, "opt": adamw_init(params)}
        b0 = fa.BWD_LAUNCHES.n
        v0 = {x: ctr.n for x, ctr in fa.BWD_VARIANT_LAUNCHES.items()}
        state, m = make_train_step(build_model(c), opt)(state, batch)
        out[(d, n)] = (float(m["loss"]), float(m["grad_norm"]),
                       tree_leaves(state["params"]),
                       fa.BWD_LAUNCHES.n - b0,
                       {x: ctr.n - v0[x]
                        for x, ctr in fa.BWD_VARIANT_LAUNCHES.items()})
        del state
    loss0, gn0, ref1, _, _ = out[("cpu", 1)]

    def agree(key):
        loss, gn, p1, _, _ = out[key]
        rel = _update_rel(p1, p0, ref1)
        moved = sum(((a.cpu() - r.cpu()).abs() > opt.lr / 10).sum().item()
                    for a, r in zip(p1, ref1))
        ok = (abs(loss - loss0) <= 1e-4 * abs(loss0)
              and abs(gn - gn0) <= 1e-4 * abs(gn0) and rel <= 1e-2)
        return ok, (f"loss {loss:.6f} vs {loss0:.6f}, grad_norm {gn:.6f} vs "
                    f"{gn0:.6f}, update rel L2 {rel:.3e} (limit 1e-2), "
                    f"elements off by more than lr/10: {moved} of "
                    f"{sum(x.numel() for x in p0)}")

    # f32: every backward call on the f32 tile, none on the tensor cores
    ok, detail = agree(("cuda", 1))
    bwd, by = out[("cuda", 1)][3:]
    phase("8b full-width 2-layer f32 train step: CUDA vs CPU plain path",
          ok and bwd == cfg.n_layers == by["cuda_core"] and by["tile"] == 0,
          detail + f", backward launches {bwd} (by variant {by})")
    ok, detail = agree(("cuda", 2))
    bwd, by = out[("cuda", 2)][3:]
    phase("8b the same step on CUDA with 2 microbatches", ok
          and bwd == 2 * cfg.n_layers == by["cuda_core"] and by["tile"] == 0,
          detail + f", backward launches {bwd} (by variant {by})")
    del out, base
    free_device_memory()


#: 8(b'): 8b's 2-layer f32 configuration trained on the card at B 1 x
#: this sequence, for this many steps (the first one warms up)
F32_TRAIN_SEQ, F32_TRAIN_STEPS = 2048, 3


def train_f32_step(dev) -> dict:
    """8(b'): 8b's configuration (stablelm-3b at full width, 2 layers, f32,
    remat) trained on the card alone at B 1 x S 2048: the f32 tile on a
    training path end to end.  Counts zeroed just before the steps and
    read just after: every backward launch on the f32 tile (one a layer
    and step), none on the tensor-core tile.  ms a step (the mean of all
    but the first), then one more step profiled for the backward's share
    of device time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import build_model
    from repro_torch.train import AdamWConfig, Trainer

    cfg = get_config("stablelm-3b").scaled(n_layers=2, dtype=torch.float32,
                                           num_microbatches=1)
    trainer = Trainer(build_model(cfg), AdamWConfig(lr=1e-4, warmup_steps=1,
                                                    total_steps=10),
                      device=dev)
    state = trainer.init(torch.Generator(device=dev).manual_seed(SEED))
    data = SyntheticLMData(cfg.vocab_size, F32_TRAIN_SEQ, 1, seed=SEED)
    metrics, stamps = [], []
    counters = {"backward": fa.BWD_LAUNCHES,
                **{f"backward {k}": c
                   for k, c in fa.BWD_VARIANT_LAUNCHES.items()}}
    torch.cuda.synchronize()
    for ctr in counters.values():
        ctr.n = 0
    t0 = time.perf_counter()

    def on_metrics(step, m):
        metrics.append(m)
        stamps.append(time.perf_counter())

    state = trainer.run(state, (data.batch_at(i) for i in range(
        F32_TRAIN_STEPS)), steps=F32_TRAIN_STEPS, on_metrics=on_metrics)
    torch.cuda.synchronize()
    counts = {k: ctr.n for k, ctr in counters.items()}
    steps = [float(x) for x in np.diff([t0] + stamps) * 1e3]
    steady = float(np.mean(steps[1:]))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        trainer.run(state, iter([data.batch_at(F32_TRAIN_STEPS)]), steps=1)
        torch.cuda.synchronize()
    share = print_device_time("8b'", prof, steady)
    n = cfg.n_layers * F32_TRAIN_STEPS
    want = {"backward": n, "backward cuda_core": n, "backward tile": 0}
    finite = all(math.isfinite(m["loss"]) for m in metrics)
    phase(f"8b' full-width 2-layer stablelm-3b f32 train on the card, B 1 x "
          f"S {F32_TRAIN_SEQ}, {F32_TRAIN_STEPS} steps",
          finite and counts == want,
          f"losses {[round(m['loss'], 4) for m in metrics]}, counts "
          f"{counts} (want {want})")
    print(f"  8b': ms/step {[round(x, 2) for x in steps]} (mean after the "
          f"first {steady:.2f}), flash backward "
          f"{'not measured' if share is None else f'{share:.1%}'} of the "
          f"device's busy time on {gpu_name_and_limit()}", flush=True)
    del state, trainer
    free_device_memory()
    return dict(counts=counts, ms_per_step=steady, bwd_share=share)


def train_slice(dev) -> dict:
    """8(c): full-width, full-depth stablelm-3b, bf16 with f32 masters and
    AdamW states, remat on, global batch 8 x 2048 in 8 microbatches, 6
    steps from ``PrefetchingLoader(SyntheticLMData)``.  Counts zeroed just
    before the steps and read just after; ms/step, tokens/s, peak memory
    and the share of 6 N D at the bf16 peak printed; then one more step
    profiled (``profile_train_step``)."""
    from repro_torch.configs import get_config
    from repro_torch.data import PrefetchingLoader, SyntheticLMData
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import build_model, count_params
    from repro_torch.models import attention
    from repro_torch.train import AdamWConfig, Trainer

    cfg = get_config("stablelm-3b")
    n_params = count_params(cfg)
    trainer = Trainer(build_model(cfg), AdamWConfig(lr=1e-4, warmup_steps=2,
                                                    total_steps=100),
                      device=dev)
    state = trainer.init(torch.Generator(device=dev).manual_seed(SEED))
    loader = PrefetchingLoader(SyntheticLMData(cfg.vocab_size, TRAIN_SEQ,
                                               TRAIN_BATCH, seed=SEED))
    metrics, stamps = [], []
    counters = {"kernel": attention.FLASH_ROUTES["kernel"],
                "plain": attention.FLASH_ROUTES["plain"],
                "forward": fa.LAUNCHES, "backward": fa.BWD_LAUNCHES,
                "backward tile": fa.BWD_VARIANT_LAUNCHES["tile"],
                "backward cuda_core": fa.BWD_VARIANT_LAUNCHES["cuda_core"]}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for ctr in counters.values():
        ctr.n = 0
    t0 = time.perf_counter()

    def on_metrics(step, m):
        metrics.append(m)
        stamps.append(time.perf_counter())

    trainer.run(state, loader, steps=TRAIN_STEPS, on_metrics=on_metrics)
    torch.cuda.synchronize()
    counts = {k: ctr.n for k, ctr in counters.items()}
    peak_bytes = torch.cuda.max_memory_allocated()
    peak = peak_bytes / 2 ** 30
    # the live state (params, m, v, step) and one step's batch on the card,
    # for phase 10a
    storages = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                for t in _leaves(state)}
    state_bytes = sum(storages.values())
    batch_bytes = sum(np.asarray(v).nbytes for v in
                      loader.data.batch_at(TRAIN_STEPS).values())
    loader.close()
    left = loader.unreclaimed()
    steps = [float(x) for x in np.diff([t0] + stamps) * 1e3]
    steady = float(np.mean(steps[1:]))
    profile_train_step(trainer, state, loader.data.batch_at(TRAIN_STEPS),
                       steady)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    mfu = 6 * n_params * tokens / (steady / 1e3) / PEAK_OPS[torch.bfloat16]
    per_step = cfg.n_layers * cfg.num_microbatches
    want = {"kernel": 2 * per_step * TRAIN_STEPS, "plain": 0,
            "forward": 2 * per_step * TRAIN_STEPS,
            "backward": per_step * TRAIN_STEPS,
            "backward tile": per_step * TRAIN_STEPS, "backward cuda_core": 0}
    finite = all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
                 for m in metrics)
    ok = (finite and len(metrics) == TRAIN_STEPS and counts == want
          and left == 0)
    phase(f"8c full-width stablelm-3b ({n_params} parameters) bf16 train, "
          f"f32 masters, remat, {TRAIN_BATCH} x {TRAIN_SEQ} in "
          f"{cfg.num_microbatches} microbatches, {TRAIN_STEPS} steps", ok,
          f"losses {[round(m['loss'], 4) for m in metrics]}, grad norms "
          f"{[round(m['grad_norm'], 3) for m in metrics]}, counts {counts} "
          f"(want {want}), prefetch unreclaimed after close {left}")
    print(f"  8c: ms/step {[round(x, 1) for x in steps]} (steady mean "
          f"{steady:.1f}), {tokens / (steady / 1e3):.1f} tokens/s, peak "
          f"{peak:.2f} GiB, 6 N D share of the bf16 peak {mfu:.4f} on "
          f"{gpu_name_and_limit()}", flush=True)
    del state, trainer
    free_device_memory()
    return dict(counts=counts, ms_per_step=steady, peak_gib=peak,
                peak_bytes=peak_bytes, state_bytes=state_bytes,
                batch_bytes=batch_bytes, n_params=n_params,
                losses=[m["loss"] for m in metrics])


def profile_train_step(trainer, state, batch, step_ms) -> None:
    """Where a training step's time goes: one more step under
    torch.profiler, device time by kind against the unprofiled steady
    step; the device's idle share is 1 - busy / that step."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        trainer.run(state, iter([batch]), steps=1)
        torch.cuda.synchronize()
    print_device_time("8c", prof, step_ms)


def device_time_by_kind(prof) -> tuple:
    """(device microseconds by kind, by kernel name) of a training trace:
    the flash backward's kernels, the flash forward's, cuBLAS GEMMs,
    copies and the rest."""
    groups = {"flash backward": 0.0, "flash forward": 0.0,
              "GEMM (cuBLAS)": 0.0, "copies": 0.0, "other kernels": 0.0}
    names: dict = {}
    for evt in prof.key_averages():
        if evt.device_type.name != "CUDA":
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        names[evt.key[:60]] = names.get(evt.key[:60], 0.0) + us
        name = evt.key.lower()
        if any(t in name for t in ("dkdv_tile_kernel", "dq_tile_kernel",
                                   "split_sum_kernel", "dkdv_f32_kernel",
                                   "dq_f32_kernel", "delta_kernel")):
            groups["flash backward"] += us
        elif "flash_tile_kernel" in name or "flash_f32_kernel" in name:
            groups["flash forward"] += us
        elif "memcpy" in name or "memset" in name:
            groups["copies"] += us
        elif any(t in name for t in ("gemm", "xmma", "cutlass", "sm90_",
                                     "nvjet")):
            groups["GEMM (cuBLAS)"] += us
        else:
            groups["other kernels"] += us
    return groups, names


def print_device_time(tag, prof, step_ms) -> float:
    """Print one profiled step's device time by kind against an unprofiled
    step of ``step_ms``, its busy and idle shares and its top kernels;
    returns the flash backward's share of the device's busy time (None
    where the trace has no device time)."""
    groups, names = device_time_by_kind(prof)
    _, busy = _device_busy(prof)
    wall = step_ms / 1e3
    if busy == 0:
        print(f"  {tag} profile: device time not measured (no CUDA events)")
        return None
    shares = ", ".join(f"{k} {v / 1e6:.3f} s ({v / 1e6 / wall:.1%})"
                       for k, v in groups.items())
    print(f"  {tag} device time by kind (one profiled step) against the "
          f"unprofiled {wall:.3f} s step: {shares}; device busy (union of "
          f"intervals) {busy:.3f} s = {busy / wall:.1%}, idle "
          f"{1 - busy / wall:.1%}", flush=True)
    top = sorted(names.items(), key=lambda kv: -kv[1])[:10]
    print(f"  {tag} top device kernels: " + "; ".join(
        f"{k} {v / 1e3:.1f} ms" for k, v in top), flush=True)
    return groups["flash backward"] / 1e6 / busy


def restart_drill(dev) -> None:
    """8(d): the smoke config on CUDA, a sync ``Checkpointer``, an injected
    failure at step 12 of 20: ``run_with_restarts`` reaches step 20 with
    one restart and at most one unreclaimed snapshot generation; then the
    training CLI as a subprocess on CUDA."""
    import tempfile

    from repro_torch.configs import get_smoke_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.models import build_model
    from repro_torch.train import AdamWConfig, Trainer
    from repro_torch.train.checkpoint import Checkpointer
    from repro_torch.train.fault_tolerance import run_with_restarts

    cfg = get_smoke_config("stablelm-3b").scaled(num_microbatches=2)
    data = SyntheticLMData(cfg.vocab_size, 16, 4)
    armed = {"on": True}

    def batches(step):
        s = step
        while True:
            if armed["on"] and s == 12:
                armed["on"] = False
                raise RuntimeError("injected node failure")
            yield data.batch_at(s)
            s += 1

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = Checkpointer(os.path.join(tmp, "drill"), sync=True)
        trainer = Trainer(build_model(cfg), AdamWConfig(lr=1e-2,
                                                        warmup_steps=2,
                                                        total_steps=50),
                          checkpointer=ckpt, checkpoint_every=5, device=dev)
        state = trainer.init(torch.Generator(device=dev).manual_seed(SEED))
        restarts = []
        state = run_with_restarts(trainer, state, batches, total_steps=20,
                                  chunk=10, on_restart=lambda n, e:
                                  restarts.append(str(e)))
        step = int(state["opt"]["step"])
        left = ckpt.unreclaimed_generations()
        on_card = all(x.is_cuda for x in _leaves(state["params"]))
        phase("8d restart drill on CUDA (smoke config)",
              step == 20 and restarts == ["injected node failure"]
              and left <= 1 and on_card,
              f"step {step}, restarts {restarts}, unreclaimed generations "
              f"{left}, state on the card {on_card}")
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--steps",
             "20", "--ckpt-dir", os.path.join(tmp, "cli")], cwd=ROOT,
            env=env, capture_output=True, text=True, timeout=300)
        log = proc.stdout + proc.stderr
        ok = (proc.returncode == 0 and "done: 20 steps" in log
              and "device=cuda" in log)
        phase("8d python -m repro_torch.launch.train --steps 20 on CUDA", ok,
              " | ".join(line for line in log.splitlines()
                         if line.startswith(("arch=", "loss", "done")))[-400:])
        if not ok:
            print(log[-3000:], flush=True)


def train_phase(dev) -> dict:
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    t8 = time.perf_counter()
    rows = flash_bwd_phase(gen, dev)
    train_step_matches_cpu(dev)
    rows["train f32"] = guarded("8b' f32 training", train_f32_step, dev) or {}
    rows["train"] = guarded("8c training slice", train_slice, dev) or {}
    restart_drill(dev)
    print(f"  phase 8: {time.perf_counter() - t8:.1f} s", flush=True)
    return rows


# ------------------------------------------------------------ phase 9: mesh
def point_scan(dev) -> dict:
    """9(a): ``kernels.can_delete_blocks`` (the point form, the reference's
    ``era_scan`` :124) on CUDA tensors at ``tests/test_kernels.py:44``'s
    shapes (R 1, 7, 256, 300, 1000 x T, H 4 x 2, 64 x 10, 512 x 10, half
    the slots empty) and its protected-interval cases (:97): the kernel,
    one launch a call, bitwise its plain version (``ref.era_scan_ref``) and
    the NumPy backend.  The row is timed at R 1000 x 5120 slots, with the
    bound of phase 2's rows (``ERA_PAIR_OPS`` a valid pair; bytes: each
    input read once, the mask written once)."""
    from repro_torch.core.era_table import _can_delete_numpy
    from repro_torch.kernels import can_delete_blocks
    from repro_torch.kernels import era_scan as es
    from repro_torch.kernels.ref import INF_ERA32, era_scan_ref

    rng = np.random.default_rng(SEED + 9)
    cases = []
    for r in (1, 7, 256, 300, 1000):
        for t, h in ((4, 2), (64, 10), (512, 10)):
            alloc = rng.integers(0, 100, r).astype(np.int32)
            retire = (alloc + rng.integers(0, 50, r)).astype(np.int32)
            res = rng.integers(0, 160, (t, h)).astype(np.int32)
            res[rng.random((t, h)) < 0.5] = INF_ERA32
            cases.append((alloc, retire, res))
    five, ten = np.full(3, 5, np.int32), np.full(3, 10, np.int32)
    guard = [(five, ten, np.array(res, np.int32))
             for res in ([[7, INF_ERA32]], [[5]], [[10]], [[4]], [[11]])]
    guard_want = [False, False, False, True, True]  # every block's fate
    bad, steps = [], []
    es.LAUNCHES.n = 0
    for i, (alloc, retire, res) in enumerate(cases + guard):
        t = [torch.from_numpy(x).to(dev) for x in (alloc, retire, res)]
        n0 = es.LAUNCHES.n
        got = can_delete_blocks(*t, use_kernel=True).cpu().numpy()
        steps.append(es.LAUNCHES.n - n0)
        want = _can_delete_numpy(alloc, retire, res.ravel(), res.ravel())
        plain = era_scan_ref(*t).cpu().numpy()
        if i >= len(cases):
            want_all = guard_want[i - len(cases)]
            ok = bool(want.all() if want_all else not want.any())
        else:
            ok = True
        if not (ok and np.array_equal(got, want)
                and np.array_equal(plain, want)):
            bad.append(i)
    launches = es.LAUNCHES.n
    n = len(cases) + len(guard)
    phase("9a can_delete_blocks (point reservations) on CUDA vs plain and "
          "numpy", not bad and steps == [1] * n and launches == n,
          f"{n} calls ({len(cases)} shapes of test_kernels.py:44, "
          f"{len(guard)} protected-interval cases), bit-identical "
          f"{not bad} (failed {bad}), launches {launches}")
    alloc, retire, res = cases[-1]  # R 1000, T 512 x H 10
    t = [torch.from_numpy(x).to(dev) for x in (alloc, retire, res)]
    kern = lambda: can_delete_blocks(*t, use_kernel=True)  # noqa: E731
    ms = time_ms(kern, reps=50)
    device_ms = time_ms(kern, reps=50, graph=True)
    plain_ms = time_ms(lambda: era_scan_ref(*t), reps=10)
    es.LAUNCHES.n = launches  # timing launches do not count
    r, s = len(alloc), res.size
    valid = int(np.count_nonzero(res != INF_ERA32))
    t_bytes = (4 * (2 * r + s) + r) / HBM_BPS * 1e3
    t_ops = ERA_PAIR_OPS * r * valid / PEAK_OPS[torch.int32] * 1e3
    bound, by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                             "operations")
    print(f"  9a can_delete_blocks R={r} T x H=512 x 10 ({valid} valid): "
          f"kernel {ms:.4f} ms (graph replay {device_ms:.4f} ms), plain "
          f"{plain_ms:.4f} ms, bound {bound:.3e} ms ({by}) on "
          f"{gpu_name_and_limit()}", flush=True)
    return dict(case="point reservations (`can_delete_blocks`), R 1000, "
                "T 512 x H 10", launches=launches, max_abs_err=0.0 if not bad
                else 1.0, ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, library_ms=None,
                library_device_ms=None, valid_slots=valid)


def mesh_train(dev, mesh, ref: dict):
    """9(b): 8c's training on the one-rank NCCL mesh: the same seeded f32
    masters as DTensors laid out by ``sharding_tree(params_axes())``, the
    gradient accumulators pinned to the same placements
    (``grad_shardings``), under ``axis_rules``; 3 steps of 8c's batches
    (``SyntheticLMData`` from 8c's seed) against 8c's first 3 losses
    (1e-5 relative; bitwise expected: a 1x1 mesh runs the same local
    ops), the flash routes and launches of 8c a step; then one step with
    ``bf16_weight_gather`` on against 8c's fourth loss (1e-2), and one
    profiled step (device busy and idle share).  Returns the state (for
    9c's reshard)."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import attention, build_model
    from repro_torch.models.perf_flags import set_flags
    from repro_torch.sharding.axes import axis_rules, sharding_tree
    from repro_torch.train import AdamWConfig, make_train_step
    from repro_torch.train.optim import adamw_init, tree_map

    cfg = get_config("stablelm-3b")
    model = build_model(cfg)
    axes = model.params_axes()
    params = model.init(torch.Generator(device=dev).manual_seed(SEED),
                        device=dev, master=True)
    placements = sharding_tree(params, axes, mesh)
    params = tree_map(lambda t, pl: distribute_tensor(t, mesh, pl), params,
                      placements)
    state = {"params": params, "opt": adamw_init(params)}
    step = make_train_step(model, AdamWConfig(lr=1e-4, warmup_steps=2,
                                              total_steps=100),
                           grad_shardings=placements)
    data = SyntheticLMData(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=SEED)
    counters = {"kernel": attention.FLASH_ROUTES["kernel"],
                "plain": attention.FLASH_ROUTES["plain"],
                "forward": fa.LAUNCHES, "backward": fa.BWD_LAUNCHES,
                "backward tile": fa.BWD_VARIANT_LAUNCHES["tile"],
                "backward cuda_core": fa.BWD_VARIANT_LAUNCHES["cuda_core"]}
    losses, ms = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for ctr in counters.values():
        ctr.n = 0
    with axis_rules(mesh):
        for i in range(3):
            t0 = time.perf_counter()
            state, m = step(state, data.batch_at(i))
            losses.append(float(m["loss"]))
            ms.append((time.perf_counter() - t0) * 1e3)
        counts = {k: ctr.n for k, ctr in counters.items()}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        prev = set_flags(bf16_weight_gather=True)
        try:
            state, m = step(state, data.batch_at(3))
            gather_loss = float(m["loss"])
        finally:
            set_flags(**prev)
        # where the mesh step's time goes: one more step under the profiler
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            state, m = step(state, data.batch_at(4))
            float(m["loss"])
            torch.cuda.synchronize()
        _, busy = _device_busy(prof)
    per_step = cfg.n_layers * cfg.num_microbatches
    want = {"kernel": 6 * per_step, "plain": 0, "forward": 6 * per_step,
            "backward": 3 * per_step, "backward tile": 3 * per_step,
            "backward cuda_core": 0}
    ref_losses = ref.get("losses", [])
    diff = max((abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)),
               default=float("inf"))
    bitwise = losses == ref_losses[:3]
    phase(f"9b full-width stablelm-3b bf16 train on the 1x1 NCCL mesh "
          f"(DTensor masters, grad_shardings), 3 steps of 8c's batches",
          len(ref_losses) >= 4 and diff <= 1e-5 and counts == want,
          f"losses {losses} vs 8c {ref_losses[:3]}: largest relative "
          f"difference {diff:.3e}, bitwise equal {bitwise}; counts {counts} "
          f"(want {want})")
    rel = abs(gather_loss - ref_losses[3]) / abs(ref_losses[3]) \
        if len(ref_losses) >= 4 else float("inf")
    phase("9b one step with bf16_weight_gather on",
          math.isfinite(gather_loss) and rel <= 1e-2,
          f"loss {gather_loss} vs 8c's step 4 {ref_losses[3:4]} (flag off): "
          f"relative {rel:.3e} (limit 1e-2)")
    steady = float(np.mean(ms[1:]))
    wall = steady / 1e3
    print(f"  9b: ms/step {[round(x, 1) for x in ms]} (steady mean "
          f"{steady:.1f}; 8c {ref.get('ms_per_step', float('nan')):.1f}), "
          f"peak {peak:.2f} GiB (8c {ref.get('peak_gib', float('nan')):.2f}); "
          f"one profiled step: device busy (union of intervals) {busy:.3f} s "
          f"= {busy / wall:.1%} of the unprofiled step, idle "
          f"{1 - busy / wall:.1%} on {gpu_name_and_limit()}", flush=True)
    return state, axes


def _host_timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def mesh_collectives(dev, mesh, state, axes) -> None:
    """9(c): the collectives on the one-rank NCCL group, each timed (host
    clock around a synchronised call): ``reshard_state`` of 9b's state from
    the 1x1 mesh back onto it keeps every bit; ``merged_era`` of a CUDA
    int64 and ``device_merge_all`` over a 2-shard ``ShardedEraDomain``
    (every clock to the maximum, none back); ``compressed_all_reduce`` of
    the gradient tree of 8b's cut (stablelm-3b at full width, 2 layers,
    f32) bitwise ``dequantize(quantize(g + r))`` without the group;
    ``ag_matmul``/``rs_matmul`` at k = 1 bitwise the product."""
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_config
    from repro_torch.core import make_scheme
    from repro_torch.core.distributed_eras import ShardedEraDomain, merged_era
    from repro_torch.data import SyntheticLMData
    from repro_torch.models import build_model
    from repro_torch.sharding.gradient_compression import (
        apply_error_feedback, compressed_all_reduce, dequantize)
    from repro_torch.sharding.overlap import ag_matmul, rs_matmul
    from repro_torch.train.fault_tolerance import reshard_state
    from repro_torch.train.optim import tree_leaves, tree_map
    from repro_torch.train.trainer import bind_grads

    moved, ms = _host_timed(lambda: reshard_state(state["params"], axes,
                                                  mesh))
    pairs = list(zip(tree_leaves(moved), tree_leaves(state["params"])))
    same = all(isinstance(a, DTensor) and a.device_mesh == mesh
               and a.placements == b.placements
               and torch.equal(a.to_local(), b.to_local()) for a, b in pairs)
    phase("9c reshard_state 1x1 -> 1x1 keeps every bit", same,
          f"{len(pairs)} leaves in {ms:.2f} ms")
    del moved, pairs

    era = torch.tensor([123], dtype=torch.int64, device=dev)
    got, ms = _host_timed(lambda: merged_era(era))
    smrs = [make_scheme("WFE", max_threads=2, era_freq=1, cleanup_freq=1)
            for _ in range(2)]
    smrs[1].global_era.fa_add(5)
    dom = ShardedEraDomain(smrs)
    before = dom.locals
    m, ms_dom = _host_timed(dom.device_merge_all)
    after = dom.locals
    phase("9c merged_era and device_merge_all over NCCL",
          got.is_cuda and got.tolist() == [123] and m == max(before)
          and after == [max(before)] * 2
          and all(a >= b for a, b in zip(after, before)),
          f"merged_era {got.tolist()} in {ms:.3f} ms; clocks {before} -> "
          f"{after} in {ms_dom:.3f} ms")

    cfg = get_config("stablelm-3b").scaled(n_layers=2, dtype=torch.float32)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED),
                        device=dev, master=True)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in SyntheticLMData(
        cfg.vocab_size, 64, 2, seed=SEED).batch_at(0).items()}
    model.loss(bind_grads(params), batch).backward()
    grads = tree_map(lambda p: p.grad, params)
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    resid = tree_map(lambda g: 1e-3 * torch.randn(
        g.shape, generator=gen, device=dev), grads)
    (mean, new_r), ms = _host_timed(lambda: compressed_all_reduce(
        grads, None, resid))
    ok = True
    for g, r, a, nr in zip(*(tree_leaves(x) for x in (grads, resid, mean,
                                                       new_r))):
        q, scale, want_r = apply_error_feedback(g, r)
        ok = ok and torch.equal(a, dequantize(q, scale)) \
            and torch.equal(nr, want_r)
    n = sum(g.numel() for g in tree_leaves(grads))
    phase("9c compressed_all_reduce over NCCL of 8b's cut's gradients", ok,
          f"{n} elements in {len(tree_leaves(grads))} leaves, bitwise "
          f"dequantize(quantize(g + r)) and its residual {ok}, {ms:.2f} ms")
    del params, grads, resid, mean, new_r

    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    x = torch.randn((2048, cfg.d_model), generator=gen, device=dev)
    w = torch.randn((cfg.d_model, cfg.d_ff), generator=gen, device=dev)
    want = torch.matmul(x, w)
    ag, ms_ag = _host_timed(lambda: ag_matmul(x, w))
    rs, ms_rs = _host_timed(lambda: rs_matmul(x, w))
    _, ms_mm = _host_timed(lambda: torch.matmul(x, w))
    phase("9c ag_matmul / rs_matmul at k = 1 equal the product",
          torch.equal(ag, want) and torch.equal(rs, want),
          f"(2048 x {cfg.d_model}) @ ({cfg.d_model} x {cfg.d_ff}) f32: "
          f"ag {ms_ag:.3f} ms, rs {ms_rs:.3f} ms, torch.matmul {ms_mm:.3f} "
          f"ms")


def mesh_phase(dev, ref: dict) -> dict:
    """Phase 9: the point-form scan (9a), then a one-rank NCCL group and the
    1x1 smoke mesh for training on DTensor masters (9b) and the
    collectives (9c); the group is destroyed at the end."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_smoke_mesh

    t9 = time.perf_counter()
    row = guarded("9a point-form era scan", point_scan, dev)
    mesh = make_smoke_mesh(dev)
    try:
        phase("9 one-rank mesh", dist.get_backend() == "nccl"
              and mesh.mesh_dim_names == ("data", "model"),
              f"backend {dist.get_backend()}, mesh {tuple(mesh.shape)} "
              f"{mesh.mesh_dim_names}")
        got = guarded("9b mesh training", mesh_train, dev, mesh, ref)
        if got is not None:
            state, axes = got
            guarded("9c collectives", mesh_collectives, dev, mesh, state,
                    axes)
            del state, got
    finally:
        dist.destroy_process_group()
    free_device_memory()
    print(f"  phase 9: {time.perf_counter() - t9:.1f} s on "
          f"{gpu_name_and_limit()}", flush=True)
    return row


# --------------------------------------------------------- phase 10: launch
#: the dry run's cells of 10b (one arch per kind and the skipped long_500k
#: of a full-attention arch), on both production meshes
DRYRUN_CELLS = ("stablelm-3b:train_4k,stablelm-3b:prefill_32k,"
                "stablelm-3b:decode_32k,deepseek-v2-236b:decode_32k,"
                "whisper-small:long_500k")
#: the examples of 10c, with their arguments and last line
EXAMPLES = {
    "torch_quickstart.py": ([], "quickstart OK"),
    "torch_serve_engine.py": ([], "serve_engine OK"),
    "torch_train_lm.py": (["--steps", "40"],
                          "train_lm OK (failure injected + recovered, "
                          "loss decreased)"),
    "torch_wfe_schemes_tour.py": ([], "amortized reclamation."),
}


def dryrun_slice(ref: dict) -> None:
    """10(a): 8c's configuration (full-width, full-depth stablelm-3b, bf16
    with f32 masters, AdamW, remat, B 8 x S 2048 in 8 microbatches) as a
    dry-run cell on a 1x1 mesh of a one-rank fake group: its argument
    bytes against 8c's live state and batch on the card (exactly), its
    FLOPs against 6 N D, its peak against 8c's ``max_memory_allocated``,
    and its roofline bound against 8c's measured step."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.launch.dryrun import fake_world, run_cell
    from repro_torch.launch.hlo_analysis import argument_bytes
    from repro_torch.launch.specs import build_cell
    from repro_torch.sharding.axes import axis_rules

    shape = ShapeSpec("8c", TRAIN_SEQ, TRAIN_BATCH, "train")
    fake_world(1)
    try:
        mesh = DeviceMesh("cuda", torch.arange(1).reshape(1, 1),
                          mesh_dim_names=("data", "model"))
        rec = run_cell("stablelm-3b", "8c", False, shape=shape, mesh=mesh,
                       verbose=False)
        with axis_rules(mesh):
            cell = build_cell(get_config("stablelm-3b"), shape, mesh)
        state_bytes = argument_bytes(cell.args[0])
    finally:
        dist.destroy_process_group()
    ok = rec["status"] == "ok"
    mem, ro = rec.get("memory", {}), rec.get("roofline", {})
    want = ref.get("state_bytes", -1) + ref.get("batch_bytes", -1)
    phase("10a 8c as a dry-run cell (1x1 mesh, meta tensors): argument "
          "bytes = 8c's live state + batch on the card",
          ok and state_bytes == ref.get("state_bytes")
          and mem.get("argument_bytes") == want,
          f"state {state_bytes} (8c {ref.get('state_bytes')}), all "
          f"arguments {mem.get('argument_bytes')} (8c's state + batch "
          f"{want}); {rec.get('error', '')}")
    if not ok:
        return
    flops, mfl = rec["cost"]["flops_per_device"], ro["model_flops"]
    measured_s = ref.get("ms_per_step", float("nan")) / 1e3
    print(f"  10a: predicted {flops:.6e} FLOPs a step against 6 N D "
          f"{mfl:.6e} (ratio {flops / mfl:.4f}; N {ref.get('n_params')}, "
          f"D {TRAIN_BATCH * TRAIN_SEQ}); predicted peak "
          f"{mem['peak_bytes'] / 2**30:.2f} GiB against 8c's "
          f"max_memory_allocated {ref.get('peak_gib', float('nan')):.2f} "
          f"GiB (ratio {mem['peak_bytes'] / ref.get('peak_bytes', 1):.4f}); "
          f"bound_step_time {ro['bound_step_time_s'] * 1e3:.1f} ms "
          f"({ro['dominant']}: compute {ro['compute_s'] * 1e3:.1f}, memory "
          f"{ro['memory_s'] * 1e3:.1f}, collective "
          f"{ro['collective_s'] * 1e3:.1f}) against 8c's measured "
          f"{measured_s * 1e3:.1f} ms: measured roofline fraction "
          f"{ro['bound_step_time_s'] / measured_s:.4f}; the cell's own "
          f"roofline_fraction {ro['roofline_fraction']:.4f} "
          f"(analysis {rec['analyze_s']} s) on {gpu_name_and_limit()}",
          flush=True)


def _run(cmd, timeout: int = 600):
    out = subprocess.run(cmd, cwd=ROOT, text=True, capture_output=True,
                         timeout=timeout,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    return out.returncode, out.stdout, out.stderr


def dryrun_sweep() -> None:
    """10(b): the sweep CLI on ``DRYRUN_CELLS`` on both production meshes
    of a 512-rank fake group, in a process of its own; the report of its
    JSONL; the same sweep again, which must skip every done cell."""
    import tempfile

    out = Path(tempfile.mkdtemp(prefix="chip_smoke_dryrun_")) / "cells.jsonl"
    sweep = [sys.executable, "-m", "repro_torch.launch.dryrun", "--cells",
             DRYRUN_CELLS, "--mesh", "both", "--out", str(out)]
    t0 = time.perf_counter()
    rc, log, err = _run(sweep)
    rows = [json.loads(line) for line in open(out)] if out.exists() else []
    reason = ("long_500k needs sub-quadratic attention; whisper-small is "
              "full-attention (DESIGN.md §4)")
    want = {(c.split(":")[0], c.split(":")[1], m)
            for c in DRYRUN_CELLS.split(",") for m in ("16x16", "2x16x16")}
    got = {(r["arch"], r["shape"], r["mesh"]): r for r in rows}
    statuses_ok = set(got) == want and all(
        (r["status"] == "skipped" and r.get("reason") == reason)
        if r["shape"] == "long_500k" else r["status"] == "ok"
        for r in got.values())
    def tag(key, r):
        took = f" {r['analyze_s']} s" if r["status"] == "ok" else ""
        return f"{key[0]}:{key[1]}@{key[2]} {r['status']}{took}"

    phase("10b dryrun --mesh both on 5 cells", rc == 0 and statuses_ok,
          f"rc={rc}, {len(rows)} records in {time.perf_counter() - t0:.1f} "
          f"s: " + ", ".join(tag(k, r) for k, r in sorted(got.items())))
    if rc != 0 or not statuses_ok:
        print(log[-3000:] + err[-3000:], flush=True)
    rc2, report, err2 = _run([sys.executable, "-m",
                              "repro_torch.launch.report", str(out)])
    phase("10b report", rc2 == 0 and "### Roofline" in report,
          f"rc={rc2}" + ("" if rc2 == 0 else f": {err2[-2000:]}"))
    print(report, flush=True)
    rc3, again, err3 = _run(sweep)
    n_after = len(open(out).readlines()) if out.exists() else -1
    phase("10b the sweep again skips every done cell",
          rc3 == 0 and again.count(": skipped") == len(want)
          and n_after == len(rows),
          f"rc={rc3}, {again.count(': skipped')} of {len(want)} skipped, "
          f"{n_after} records")


def examples_on_card() -> None:
    """10(c): the four ``examples/torch_*.py`` on CUDA, each in a process
    of its own, started together."""
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [sys.executable, str(ROOT / "examples" / name), *args], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), text=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for name, (args, _) in EXAMPLES.items()}
    for name, proc in procs.items():
        try:
            log, _ = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
        last = EXAMPLES[name][1]
        lines = log.strip().splitlines()
        ok = proc.returncode == 0 and bool(lines) and lines[-1] == last
        phase(f"10c examples/{name} on CUDA", ok,
              f"rc={proc.returncode} after {time.perf_counter() - t0:.1f} s: "
              + " | ".join(lines[-3:])[-400:])
        if not ok:
            print(log[-3000:], flush=True)


def launch_phase(ref: dict) -> None:
    """Phase 10: the launch tooling and the examples, after phase 9."""
    t10 = time.perf_counter()
    guarded("10a dry-run cell of 8c", dryrun_slice, ref)
    guarded("10b dry-run sweep", dryrun_sweep)
    guarded("10c examples", examples_on_card)
    print(f"  phase 10: {time.perf_counter() - t10:.1f} s on "
          f"{gpu_name_and_limit()}", flush=True)


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
    free_device_memory()
    # the other archs' shapes (phase 6 serves them): gemma-7b's head dim
    # 256 (KH 16, G 1) over bf16 and int8 pages, and an f32 query (the
    # 64-key split-KV walk and the f32 tile); the grouped heads at
    # D 128 of starcoder2-3b (KH 2, G 12), starcoder2-7b (KH 4, G 9) and
    # pixtral-12b (KH 8, G 4)
    for b, c in ((8, 1), (9, 256)):
        for dtype in (torch.bfloat16, torch.float32):
            attn[("gemma-7b", dtype, c)] = check_attention(
                dtype, b, c, 128, dev, arch="gemma-7b")
        attn[("gemma-7b", "int8", c)] = check_attention_int8(
            b, c, 128, dev, arch="gemma-7b")
        for arch in GQA_ARCHS:
            attn[(arch, torch.bfloat16, c)] = check_attention(
                torch.bfloat16, b, c, 128, dev, arch=arch)
        free_device_memory()
    # dense flash attention: prefill of stablelm-3b (MHA, D 80) and of
    # starcoder2-3b (GQA 24 / 2, D 128; src/repro/configs/starcoder2_3b.py),
    # and an f32 non-causal GQA case
    flash = check_flash(1, 4096, 32, 32, 80, torch.bfloat16, True, gen, dev,
                        2e-2, "stablelm-3b prefill")
    flash_gqa = check_flash(1, 4096, 24, 2, 128, torch.bfloat16, True, gen,
                            dev, 2e-2, "starcoder2-3b prefill")
    # gemma-7b prefill (MHA 16 / 16, D 256; src/repro/configs/gemma_7b.py)
    flash_gemma = check_flash(1, 4096, 16, 16, 256, torch.bfloat16, True, gen,
                              dev, 2e-2, "gemma-7b prefill")
    free_device_memory()
    # phase 7's shapes: mixtral-8x7b (GQA 32 / 8, D 128) at phase 7's prompt
    # and at its window, recurrentgemma-2b's local attention (MQA 10 / 1,
    # D 256) likewise, and whisper-small's encoder (12 heads of 64,
    # non-causal over 1500 frames)
    flash_zoo = {
        ("mixtral-8x7b", 1024): check_flash(
            4, 1024, 32, 8, 128, torch.bfloat16, True, gen, dev, 2e-2,
            "mixtral-8x7b prefill"),
        ("mixtral-8x7b", 4096): check_flash(
            1, 4096, 32, 8, 128, torch.bfloat16, True, gen, dev, 2e-2,
            "mixtral-8x7b prefill at the window"),
        ("recurrentgemma-2b", 1024): check_flash(
            4, 1024, 10, 1, 256, torch.bfloat16, True, gen, dev, 2e-2,
            "recurrentgemma-2b prefill"),
        ("recurrentgemma-2b", 2048): check_flash(
            1, 2048, 10, 1, 256, torch.bfloat16, True, gen, dev, 2e-2,
            "recurrentgemma-2b prefill at the window"),
        ("whisper-small", 1500): check_flash(
            4, 1500, 12, 12, 64, torch.bfloat16, False, gen, dev, None,
            "whisper-small encoder", scaled=True),
    }
    # the f32 tile at phase 7's f32 group shapes (B 2, prefill of 64
    # tokens; whisper's encoder over its 1500 frames)
    flash_f32 = {
        "mixtral-8x7b": check_flash(2, 64, 32, 8, 128, torch.float32, True,
                                    gen, dev, 1e-4, "mixtral-8x7b f32 group"),
        "recurrentgemma-2b": check_flash(
            2, 64, 10, 1, 256, torch.float32, True, gen, dev, 1e-4,
            "recurrentgemma-2b f32 group"),
        "whisper-small": check_flash(
            2, 1500, 12, 12, 64, torch.float32, False, gen, dev, 1e-4,
            "whisper-small f32 group encoder"),
    }
    free_device_memory()

    launches, launches_q8, schemes, runtime, zoo_stablelm = \
        serve_full_width(dev)
    t4 = time.perf_counter()
    shard_tokens(dev)
    print(f"  phase 4a': {time.perf_counter() - t4:.1f} s", flush=True)
    step_matches_cpu(dev)
    forced_slow_path(dev)
    archs = serve_archs(dev)
    t7 = time.perf_counter()
    zoo = zoo_phase(dev)
    print(f"  phase 7: {time.perf_counter() - t7:.1f} s", flush=True)
    train = train_phase(dev)
    point_row = mesh_phase(dev, train.get("train", {}))
    launch_phase(train.get("train", {}))

    # one row per (kernel, main-path shape) under the kernel's own name;
    # the first row of each name is at the shape earlier versions of this
    # line reported (decode, bf16 q), ``case`` and ``variant`` say which
    # shape and kernel variant a row is.  ``launches``: that variant's
    # launches in the serving run whose path it is on (bf16 or int8 pages);
    # the f32 query's paths are on no serving path; flash attention's rows
    # take their launches from the model zoo's prefills (phases 3, 6, 7)
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
    # the other archs' rows, ``launches`` from their phase 6 windows: a
    # decode row counts the decode plans' split calls, a mixed row every
    # tile call (mixed and prefill plans)
    def decode(arch, kv="bf16"):
        return archs.get((arch, kv), {}).get("by_kind", {}).get(
            "decode", {}).get("split", 0)

    def tile(arch, kv="bf16"):
        return archs.get((arch, kv), {}).get("tile", 0)

    rows += [
        ("paged_attention_chunk", 148, "gemma-7b decode B 8 C 1, bf16 q",
         decode("gemma-7b"), attn[("gemma-7b", torch.bfloat16, 1)]),
        ("paged_attention_chunk", 148, "gemma-7b mixed B 9 C 256, bf16 q",
         tile("gemma-7b"), attn[("gemma-7b", torch.bfloat16, 256)]),
        ("paged_attention_chunk", 148, "gemma-7b decode B 8 C 1, f32 q", 0,
         attn[("gemma-7b", torch.float32, 1)]),
        ("paged_attention_chunk", 148, "gemma-7b mixed B 9 C 256, f32 q", 0,
         attn[("gemma-7b", torch.float32, 256)]),
        ("paged_attention_chunk_int8", 129, "gemma-7b decode B 8 C 1, bf16 q",
         decode("gemma-7b", "int8"), attn[("gemma-7b", "int8", 1)]),
        ("paged_attention_chunk_int8", 129,
         "gemma-7b mixed B 9 C 256, bf16 q", tile("gemma-7b", "int8"),
         attn[("gemma-7b", "int8", 256)]),
    ]
    for arch in GQA_ARCHS:
        rows += [
            ("paged_attention_chunk", 148, f"{arch} decode B 8 C 1, bf16 q",
             decode(arch), attn[(arch, torch.bfloat16, 1)]),
            ("paged_attention_chunk", 148, f"{arch} mixed B 9 C 256, bf16 q",
             tile(arch), attn[(arch, torch.bfloat16, 256)]),
        ]
    kernels = [dict(name=name, route="cuda", source=paged,
                    replaces=f"src/repro/kernels/paged_attention.py:{line}",
                    launches=n, case=case, **row)
               for name, line, case, n, row in rows]
    for row in kernels[8:]:
        row["arch"] = row["case"].split()[0]
        if " f32 q" in row["case"]:
            row["on_main_path"] = False
    kernels[0]["launches_combine"] = launches["combine"]
    kernels[3]["on_main_path"] = kernels[4]["on_main_path"] = False
    kernels[5]["launches_combine"] = launches_q8["combine"]
    flash_src = dict(route="cuda",
                     source="src/repro_torch/kernels/csrc/flash_attention.cu",
                     replaces="src/repro/kernels/flash_attention.py:83")

    def zoo_launches(arch, t=None):
        """The flash kernel's launches in phase 7's bf16 prefill of
        ``arch`` (its window prefill at B 1 when t is given); for a
        served dense arch, in its model-zoo prefill (phases 3 and 6)."""
        if arch == "stablelm-3b":
            return (zoo_stablelm or {}).get("launches", 0)
        if arch in ARCH_PARAMS:
            return archs.get((arch, "zoo"), {}).get("launches", 0)
        res = zoo.get(arch, {})
        if t is not None:
            return ((res.get("window") or {}).get(t) or {}).get(
                "launches", 0)
        return res.get("prefill", {}).get("launches", 0)

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
    # phase 9a's row: the point form at test_kernels.py's largest shape,
    # ``launches`` from 9a's calls
    if point_row is not None:
        kernels.append(dict(name="era_scan_interval", route="cuda",
                            source="src/repro_torch/kernels/csrc/era_scan.cu",
                            replaces="src/repro/kernels/era_scan.py:96",
                            **point_row))
    kernels += [
        dict(name="flash_attention", case="stablelm-3b prefill", **flash_src,
             launches=zoo_launches("stablelm-3b"), **flash),
        dict(name="flash_attention", case="starcoder2-3b prefill",
             arch="starcoder2-3b", **flash_src,
             launches=zoo_launches("starcoder2-3b"), **flash_gqa),
        dict(name="flash_attention", case="gemma-7b prefill", arch="gemma-7b",
             **flash_src, launches=zoo_launches("gemma-7b"), **flash_gemma),
    ]
    for (arch, t), row in flash_zoo.items():
        at_window = t in (4096, 2048)
        case = (f"{arch} encoder B 4 T {t}, non-causal (the prefill's "
                f"launches: encoder and decoder self-attention)"
                if arch == "whisper-small" else
                f"{arch} prefill B {1 if at_window else 4} T {t}")
        kernels.append(dict(name="flash_attention", case=case, arch=arch,
                            **flash_src,
                            launches=zoo_launches(arch, t if at_window
                                                  else None), **row))
    # the f32 tile's rows: launches of phase 7's f32 group of the arch
    # (its forward, prefill and decode steps)
    for arch, row in flash_f32.items():
        case = ("whisper-small f32 group encoder B 2 T 1500, non-causal"
                if arch == "whisper-small" else
                f"{arch} f32 group prefill B 2 T 64")
        kernels.append(dict(name="flash_attention", case=case, arch=arch,
                            **flash_src, launches=zoo.get(arch, {}).get(
                                "f32_cuda_core", 0), **row))
    # phase 8's rows: the backward at each shape, ``launches`` from the
    # training slice (8c) for its shape and 0 elsewhere; the forward at the
    # slice's microbatch shape, ``launches`` from 8c (remat runs it twice)
    counts = train.get("train", {}).get("counts", {})
    bwd_src = dict(route="cuda", replaces=flash_src["replaces"],
                   source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu")
    bwd_cases = {
        "stablelm-3b": "stablelm-3b train microbatch B 1 T 2048, bf16 causal",
        "stablelm-3b f32": "stablelm-3b B 1 T 2048, f32 causal (8b' trains "
                           "at this shape)",
        "starcoder2-3b": "starcoder2-3b B 1 T 2048 (G 12, D 128), bf16 causal",
        "starcoder2-3b f32": "starcoder2-3b B 1 T 2048 (G 12, D 128), f32 "
                             "causal",
        "gemma-7b": "gemma-7b B 1 T 2048 (D 256), bf16 causal",
        "gemma-7b f32": "gemma-7b B 1 T 2048 (D 256), f32 causal",
        "whisper-small": "whisper-small encoder B 4 T 1500, bf16 non-causal",
        "whisper-small f32": "whisper-small encoder B 4 T 1500, f32 "
                             "non-causal",
    }
    # one row per variant: the tile where bf16 routes to it, and the f32
    # tile (f32's route, and bf16's control, timed in the same run);
    # ``launches`` by variant from 8c, and for stablelm-3b's f32 row from
    # 8b' (its f32 training path, counted on its own)
    f32_counts = train.get("train f32", {}).get("counts", {})
    for key, case in bwd_cases.items():
        for variant, timed in train[key].items():
            n = 0
            if key == "stablelm-3b":
                n = counts.get(f"backward {variant}", 0)
            elif key == "stablelm-3b f32":
                n = f32_counts.get(f"backward {variant}", 0)
            row = dict(name="flash_attention_bwd", case=case, **bwd_src,
                       launches=n, **timed)
            if key == "stablelm-3b f32":
                row.update(launches_from="8b'", on_main_path=False)
            elif key != "stablelm-3b":
                row.update(arch=key.split()[0], on_main_path=False)
            elif variant != "tile":
                row.update(on_main_path=False)
            kernels.append(row)
    kernels.append(dict(name="flash_attention",
                        case="stablelm-3b train microbatch B 1 T 2048 "
                        "(8c: forward and remat recompute)", **flash_src,
                        launches=counts.get("forward", 0),
                        **train["forward"]))
    # ``launches_runtime``: each row's launches in phase 4c's 2-worker run
    # on 2 shards (bf16 pages), by the row's variant and, for the engine's
    # mixed step, by plan kind
    rt = runtime.get("launches_runtime")
    for row in kernels:
        if rt is None:
            n = None
        elif row["name"] == "era_scan_interval":
            n = rt["era_scan_interval"]
        elif (row["name"] != "paged_attention_chunk" or "f32" in row["case"]
              or "arch" in row):
            n = 0  # int8 pages, f32 queries, other archs and flash are off
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
