"""Names, files and arithmetic shared by every cell.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration and a traffic mix.  Everything that belongs to one item lives
in a file of its own, found by its name:

* ``bench/configs/<config>.json``: the configuration as it is run;
* ``bench/traffic/<traffic>.json``: the mix's parameters, whose ``kind``
  names its generator ``bench/traffic/<kind>.py``;
* ``bench/e2e/<metric>.py`` and ``bench/metrics/<metric>.py``: one reader
  per end-to-end or per-layer metric, ``read(run) -> float | None``;
* ``bench/rooflines/<kernel>.py``: a kernel family's operations and bytes.
"""

from __future__ import annotations

import importlib.util
import json
import math
import statistics
import sys
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

#: published dense peaks of one H100 SXM (NVIDIA's data sheet): HBM bytes/s
#: and bf16 tensor-core FLOP/s; copied from chip_smoke.py (HBM_BPS,
#: PEAK_OPS[bfloat16])
HBM_BPS = 3.35e12
PEAK_BF16 = 989e12

#: top-level module names the measured process may not hold: JAX, its
#: libraries and the JAX package (``repro``; ``repro_torch`` is the port)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell(name: str, root: Path = ROOT) -> dict:
    """The ``workloads`` entry called ``name``."""
    for w in manifest(root)["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_file(name: str) -> Path:
    return BENCH / "configs" / f"{name}.json"


def traffic_file(name: str) -> Path:
    return BENCH / "traffic" / f"{name}.json"


def load_module(path: Path, name: Optional[str] = None):
    """Import the Python file at ``path`` (names may hold dots)."""
    mod_name = name or "bench_" + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def generator(kind: str):
    return load_module(BENCH / "traffic" / f"{kind}.py")


def reader(folder: str, metric: str):
    """``bench/<folder>/<metric>.py``'s ``read`` function."""
    return load_module(BENCH / folder / f"{metric}.py").read


def roofline(kernel: str):
    return load_module(BENCH / "rooflines" / f"{kernel}.py")


def metrics_of(cell_name: str, kind: str, root: Path = ROOT) -> List[dict]:
    """The ``end_to_end`` (kind) or ``per_layer`` metrics a cell reports:
    those that list it under ``workloads``, or list no cells at all."""
    out = []
    for m in manifest(root)[kind]:
        cells = m.get("workloads")
        if cells is None or cell_name in cells:
            out.append(m)
    return out


# ------------------------------------------------------------- arithmetic
def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank ``q`` percentile (0 < q <= 100): the smallest value
    with at least q% of the values at or below it.  ``inf`` stands for a
    request that failed, which misses every limit."""
    if not values:
        raise ValueError("percentile of no values")
    s = sorted(values)
    k = max(1, math.ceil(q / 100.0 * len(s)))
    return s[k - 1]


def spread(values: Sequence[float]) -> float:
    """Distance between the first and third quartile over the median
    (``statistics.quantiles``' default method)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def union_length(spans: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals: a moment covered by
    two intervals counts once.  After ``chip_smoke.py``'s ``_device_busy``."""
    total, end = 0.0, -math.inf
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def idle_gaps(spans: Iterable[Tuple[float, float]], lo: float, hi: float
              ) -> List[Tuple[float, float]]:
    """The [start, end) gaps inside [lo, hi) that no interval covers."""
    gaps, cur = [], lo
    for a, b in sorted(spans):
        if a > cur:
            gaps.append((cur, min(a, hi)))
        cur = max(cur, b)
        if cur >= hi:
            break
    if cur < hi:
        gaps.append((cur, hi))
    return [(a, b) for a, b in gaps if b > a]


def rate(count: float, seconds: float) -> float:
    if seconds <= 0:
        raise ValueError("a rate over no time")
    return count / seconds


def forbidden_modules(modules: Iterable[str] = None) -> List[str]:
    """Names in ``sys.modules`` (or ``modules``) whose top-level name, the
    part before the first dot, is one of ``FORBIDDEN_MODULES``, compared
    whole: ``repro_torch`` passes, ``repro.models`` does not."""
    names = sys.modules.keys() if modules is None else modules
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN_MODULES)
