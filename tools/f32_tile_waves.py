"""The f32 attention tile's rate against the number of waves of its grid.

Times ``flash_attention`` in f32 at whisper-small's encoder shape (H 12,
D 64, T 1500, non-causal; 24 CTAs of 64 rows per (batch row, head)) for
batch sizes 1, 2, 3, 4 and 11, by CUDA-graph replay, and prints each time
with its rate against the card's 67 TFLOP/s f32 peak (4 * D flops a
(query, key) pair).  At B 11 the grid is 3168 CTAs, 8 waves of three CTAs
an SM, so the tail is small and the rate is the tile's steady state; at
B 2 (phase 7's shape) the 576 CTAs fill 1.45 waves.  Then it runs the B 11
call for two seconds and samples the SM clock and power with ``nvidia-smi``.

Run on the card from the repository root:
    python3 tools/f32_tile_waves.py
"""

from __future__ import annotations

import subprocess
import sys
import threading
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

PEAK_F32 = 67e12
BATCHES = (1, 2, 3, 4, 11)


def graph_ms(fn, reps: int = 10) -> float:
    """Time per call of one CUDA-graph replay of ``reps`` calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("f32_tile_waves: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import flash_attention as fa

    dev = torch.device("cuda")
    print(smi("name,power.limit"), flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    t, h, d = 1500, 12, 64
    call = None
    for b in BATCHES:
        q, k, v = (torch.randn((b, t, h, d), generator=gen, device=dev)
                   for _ in range(3))
        call = (lambda q=q, k=k, v=v:
                fa.flash_attention(q, k, v, causal=False))
        ms = graph_ms(call)
        rate = 4 * d * h * b * t * t / (ms * 1e-3)
        ctas = -(-t // 64) * h * b
        print(f"B {b}: {ctas} CTAs, {ms:.4f} ms, {rate / 1e12:.1f} TFLOP/s "
              f"({rate / PEAK_F32:.1%} of 67)", flush=True)
    samples, stop = [], threading.Event()

    def sample():
        while not stop.is_set():
            samples.append(smi("clocks.sm,power.draw"))
            time.sleep(0.2)

    sampler = threading.Thread(target=sample)
    sampler.start()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 2.0:
        for _ in range(20):
            call()
        torch.cuda.synchronize()
    stop.set()
    sampler.join()
    mid = len(samples) // 2
    print("SM clock, power under the B 11 load:", samples[mid:mid + 3],
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
