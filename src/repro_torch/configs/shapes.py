"""Assigned input shapes (``repro.configs.shapes``), uniform across the 10
LM-family architectures.

``train_4k``/``prefill_32k`` drive the train step / prefill;
``decode_32k``/``long_500k`` drive one decode step (one new token against a
KV cache of seq_len).  long_500k requires sub-quadratic attention — the
full-attention archs skip it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def cell_is_runnable(cfg, shape: ShapeSpec) -> bool:
    """The (arch × shape) applicability rule from the assignment."""
    if shape.name == "long_500k":
        return cfg.supports_long_context
    return True
