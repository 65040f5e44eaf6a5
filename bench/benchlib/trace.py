"""Reductions of a ``torch.profiler`` trace of a bounded sub-window: device
time (the union of kernel and copy intervals), kernel time by name, and
the idle gaps labelled by the harness span the host was in."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .common import idle_gaps, union_length

#: host spans the harness records (``bench.<name>``), innermost first when
#: they nest: cleanup runs inside complete, complete inside step
SPANS = ("cleanup", "complete", "tick", "step")


class Trace:
    """Device intervals and harness spans of one profiled sub-window, in
    seconds on the profiler's clock; ``window_s`` is its host-clock
    length."""

    def __init__(self, prof, window_s: float):
        self.window_s = window_s
        self.kernels: List[Tuple[str, float, float]] = []
        self.spans: List[Tuple[str, float, float]] = []
        for e in prof.events():
            a, b = e.time_range.start / 1e6, e.time_range.end / 1e6
            if e.name.startswith("bench."):
                # a harness span; the profiler also files a copy of it on
                # the device's timeline, which is no device work
                if e.device_type.name != "CUDA":
                    self.spans.append((e.name[6:], a, b))
            elif e.device_type.name == "CUDA":
                self.kernels.append((e.name, a, b))

    @property
    def busy_s(self) -> float:
        return union_length((a, b) for _, a, b in self.kernels)

    def time_of(self, names) -> float:
        """Summed device time of kernels whose name holds any of
        ``names``."""
        return sum(b - a for n, a, b in self.kernels
                   if any(k in n for k in names))

    def by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for n, a, b in self.kernels:
            out[n] = out.get(n, 0.0) + (b - a)
        return out

    def gaps(self) -> List[Tuple[str, float]]:
        """Every idle gap between the first and last device interval, with
        the innermost harness span covering its middle (``idle``: none)."""
        if not self.kernels:
            return []
        lo = min(a for _, a, _ in self.kernels)
        hi = max(b for _, _, b in self.kernels)
        out = []
        for a, b in idle_gaps(((a, b) for _, a, b in self.kernels), lo, hi):
            mid = (a + b) / 2
            inside = [n for n, s, e in self.spans if s <= mid < e]
            label = next((n for n in SPANS if n in inside), "idle")
            out.append((label, b - a))
        return out

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.by_name().items(), key=lambda kv: -kv[1])[:top]
        by_label: Dict[str, float] = {}
        for label, dt in self.gaps():
            by_label[label] = by_label.get(label, 0.0) + dt
        edge = self.window_s - (self._span() if self.kernels else 0.0)
        if edge > 0:
            by_label["window_edges"] = by_label.get("window_edges", 0.0) + edge
        gaps = sorted(by_label.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:120], s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in gaps]}

    def _span(self) -> float:
        lo = min(a for _, a, _ in self.kernels)
        hi = max(b for _, _, b in self.kernels)
        return hi - lo


def idle_pct(tr: Optional[Trace]) -> Optional[float]:
    if tr is None or tr.window_s <= 0 or not tr.kernels:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
