"""Roofline terms of a dry-run cell (``repro.launch.roofline``), with the
constants of one NVIDIA H100 SXM.

Three terms per (arch x shape x mesh), in seconds:

    compute    = FLOPs_per_device / PEAK_FLOPS       (989 TFLOP/s bf16 dense)
    memory     = bytes_per_device / HBM_BW           (3.35 TB/s)
    collective = wire_bytes_per_device / LINK_BW     (450 GB/s)

The counts come from ``hlo_analysis.analyze`` over the step's dispatched
aten ops (per device: the local ops DTensor runs).  There is no HLO text to
parse, so :func:`wire_bytes` takes each collective's kind, bytes and group
size as the analysis records them, and applies the reference's ring model
(``repro/launch/roofline.py:104-109``):

    all-reduce      2·S·(g-1)/g        collective-permute  S
    all-gather, reduce-scatter, all-to-all     S·(g-1)/g

MODEL_FLOPS = 6·N·D (train), 2·N·D (prefill), 2·N·B (decode), with N the
active parameters of an MoE; MODEL_FLOPS / (FLOPs_per_device x devices)
flags remat and redundant work.  Every figure here is analytic: H100
constants, not a measurement.
"""

from __future__ import annotations

from typing import Dict, Optional

# ------------------------------------------------------- hardware constants
# NVIDIA H100 SXM5 datasheet: 989 TFLOP/s dense bf16 tensor-core peak,
# 3.35 TB/s HBM3, NVLink 4 at 900 GB/s per GPU over both directions (450
# GB/s each way).
PEAK_FLOPS = 989e12  # bf16 dense, per card
HBM_BW = 3.35e12  # bytes/s per card
LINK_BW = 450e9  # bytes/s per card, one direction of NVLink 4

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all", "collective-permute")


def wire_bytes(kind: str, nbytes: float, group: int) -> float:
    """Ring-model bytes one device sends for a collective of ``kind`` over
    ``nbytes`` (the larger of its input and result) in a group of
    ``group`` devices."""
    g = max(group, 1)
    if kind == "all-reduce":
        return 2 * nbytes * (g - 1) / g
    if kind == "collective-permute":
        return float(nbytes)
    return nbytes * (g - 1) / g


def roofline_terms(flops_per_dev: float, bytes_per_dev: float,
                   collectives: Dict[str, Dict]) -> Dict[str, float]:
    wire = sum(r["wire_bytes"] for r in collectives.values())
    return {
        "compute_s": flops_per_dev / PEAK_FLOPS,
        "memory_s": bytes_per_dev / HBM_BW,
        "collective_s": wire / LINK_BW,
        "wire_bytes_per_dev": wire,
    }


def dominant_term(terms: Dict[str, float]) -> str:
    kinds = {k: terms[k] for k in ("compute_s", "memory_s", "collective_s")}
    return max(kinds, key=kinds.get)


def model_flops(cfg, shape, n_active: Optional[int] = None) -> float:
    """6·N·D with D = tokens processed by the step."""
    n = n_active if n_active is not None else cfg.param_count()
    if shape.kind == "train":
        d = shape.global_batch * shape.seq_len
        return 6.0 * n * d
    if shape.kind == "prefill":
        d = shape.global_batch * shape.seq_len
        return 2.0 * n * d  # forward only
    return 2.0 * n * shape.global_batch  # decode: 1 token/request, fwd only


def mfu_fraction(model_fl: float, flops_per_dev: float, chips: int,
                 terms: Dict[str, float]) -> Dict[str, float]:
    """Useful-FLOPs fraction of the roofline-limited step time."""
    step_time = max(terms["compute_s"], terms["memory_s"],
                    terms["collective_s"])
    total = flops_per_dev * chips
    return {
        "useful_flops_ratio": model_fl / total if total else 0.0,
        "bound_step_time_s": step_time,
        "model_flops_time_s": model_fl / (chips * PEAK_FLOPS),
        "roofline_fraction": (model_fl / (chips * PEAK_FLOPS)) / step_time
        if step_time else 0.0,
    }
