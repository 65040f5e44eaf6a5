"""Per-layer quantities of a serving run, shared by the metric readers in
``bench/metrics`` (each reader is one line over these)."""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from . import weights
from .common import HBM_BPS, PEAK_BF16, load_module, BENCH
from .trace import Trace, idle_pct

_PAGED = load_module(BENCH / "rooflines" / "paged_attn.py",
                     "bench_roofline_paged_attn")


def shape(arch: dict, bs: int) -> dict:
    h = arch["n_heads"]
    return {"heads": h, "kv_heads": arch["n_kv_heads"],
            "head_dim": arch.get("head_dim") or arch["d_model"] // h,
            "bs": bs}


def host_ms_per_step(run) -> Optional[float]:
    steps = run.window_steps()
    if not steps:
        return None
    return 1e3 * sum(s.tick_s + s.complete_s for s in steps) / len(steps)


def cleanup_ms_per_step(run) -> Optional[float]:
    steps = run.window_steps()
    if not steps:
        return None
    return 1e3 * sum(s.cleanup_s for s in steps) / len(steps)


def model_flops(arch: dict, bs: int, step) -> float:
    """2 x non-embedding parameters per token computed (the head counted
    once per row, for the one token each row unembeds), plus attention's
    QK and PV over the contexts served, for the live rows of one step."""
    d, v, L = arch["d_model"], arch["vocab_size"], arch["n_layers"]
    layer_params = weights.count(arch) - d * v
    tokens = int(np.sum(step.q))
    ops, _ = _PAGED.work(step.q, step.ctx, **shape(arch, bs))
    return 2.0 * layer_params * tokens + 2.0 * d * v * len(step.q) + L * ops


def mfu_pct(run) -> Optional[float]:
    steps = run.window_steps()
    if not steps:
        return None
    bs = run.deploy["block_size"]
    flops = sum(model_flops(run.arch, bs, s) for s in steps)
    secs = sum((s.t1 - s.t0) - s.complete_s for s in steps)
    return 100.0 * flops / (secs * PEAK_BF16)


def trace(run) -> Optional[Trace]:
    if getattr(run, "_trace", None) is None and run.profile is not None:
        t0, t1 = run.prof_window
        run._trace = Trace(run.profile, t1 - t0)
    return getattr(run, "_trace", None)


def paged_attn_roofline_pct(run) -> Optional[float]:
    tr = trace(run)
    if tr is None:
        return None
    kernel_s = tr.time_of(_PAGED.KERNELS)
    if kernel_s <= 0:
        return None
    bs = run.deploy["block_size"]
    kv_bytes = 1 if run.deploy["kv_dtype"] == "int8" else 2
    bound = sum(_PAGED.bound_s(s.q, s.ctx, peak_ops=PEAK_BF16,
                               hbm_bps=HBM_BPS, kv_bytes=kv_bytes,
                               kv_pages=s.kv_pages(bs),
                               **shape(run.arch, bs))
                for s in run.steps if s.profiled)
    return 100.0 * bound * run.arch["n_layers"] / kernel_s


def idle(run) -> Optional[float]:
    return idle_pct(trace(run))


def prefix_hit_share_pct(run) -> Optional[float]:
    hits = run.stats_after["prefix_hit_tokens"] - \
        run.stats_before["prefix_hit_tokens"]
    sent = sum(len(s.prompt) for s in run.sent)
    if sent == 0 or hits <= 0:
        return None
    return 100.0 * hits / sent


def captures_in_window(run) -> float:
    return float(run.captures_after - run.captures_before)
