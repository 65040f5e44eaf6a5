"""Scheme comparison tour on the PyTorch/CUDA port
(``examples/wfe_schemes_tour.py`` on ``repro_torch``): run the same
linked-list workload under every reclamation scheme and show the paper's
key trade-off live — throughput vs bounded memory vs progress guarantee.
After each workload a quiescent drain scans every retire list at once on
the card (the era-scan kernel; ``--device cpu``: its plain PyTorch
version).

Run:  PYTHONPATH=src python examples/torch_wfe_schemes_tour.py [--device cpu]
"""

import argparse
import random
import threading
import time
from typing import Dict, List

from repro_torch import resolve_device
from repro_torch.core import SCHEMES, make_scheme
from repro_torch.core.datastructures import HarrisMichaelList


# ---- the workload loop of benchmarks/common.py (which imports the JAX
# package), kept here for the list --------------------------------------
def scheme_kwargs(name: str, n_threads: int, v: int = 30) -> dict:
    if name in ("WFE", "HE", "Crystalline"):
        return {"era_freq": max(1, n_threads * v // 10),
                "cleanup_freq": 30}
    if name in ("EBR", "2GEIBR"):
        return {"epoch_freq": max(1, n_threads * v // 10),
                "cleanup_freq": 30}
    if name in ("HP",):
        return {"cleanup_freq": 30}
    return {}


def run_kv_workload(scheme: str, n_threads: int, backend: str, *,
                    duration: float = 0.4, get_ratio: float = 0.5,
                    prefill: int = 2000, key_range: int = 4000,
                    seed: int = 0) -> Dict[str, float]:
    """Mixed insert/delete/get workload on the Harris-Michael list, then
    one quiescent batched drain on ``backend``."""
    smr = make_scheme(scheme, max_threads=n_threads + 1,
                      **scheme_kwargs(scheme, n_threads))
    ds = HarrisMichaelList(smr)
    tid0 = smr.register_thread()
    rng = random.Random(seed)
    for _ in range(prefill):
        ds.insert(rng.randrange(key_range), "v", tid0)

    ops = [0] * n_threads
    unreclaimed_samples: List[int] = []
    stop = threading.Event()
    start = threading.Barrier(n_threads + 1)

    def worker(w: int) -> None:
        tid = smr.register_thread()
        r = random.Random(seed * 997 + w)
        start.wait()
        n = 0
        while not stop.is_set():
            key = r.randrange(key_range)
            p = r.random()
            if p < get_ratio:
                ds.get(key, tid)
            elif p < get_ratio + (1 - get_ratio) / 2:
                ds.insert(key, "v", tid)
            else:
                ds.delete(key, tid)
            n += 1
        ops[w] = n

    threads = [threading.Thread(target=worker, args=(w,))
               for w in range(n_threads)]
    for t in threads:
        t.start()
    start.wait()
    t0 = time.monotonic()
    while time.monotonic() - t0 < duration:
        unreclaimed_samples.append(smr.unreclaimed())
        time.sleep(duration / 10)
    stop.set()
    for t in threads:
        t.join()
    elapsed = time.monotonic() - t0
    smr.cleanup_batch_all(backend)
    total = sum(ops)
    return {
        "mops": total / elapsed / 1e6,
        "avg_unreclaimed": (sum(unreclaimed_samples)
                            / max(len(unreclaimed_samples), 1)),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    dev = resolve_device(ap.parse_args().device)
    backend = "cuda" if dev.type == "cuda" else "torch"
    print(f"{'scheme':>12s} {'wait-free':>10s} {'bounded-mem':>12s} "
          f"{'Mops/s':>8s} {'unreclaimed':>12s}")
    for scheme in ("WFE", "Crystalline", "HE", "HP", "EBR", "2GEIBR",
                   "Leak"):
        cls = SCHEMES[scheme]
        r = run_kv_workload(scheme, 2, backend, duration=0.3, get_ratio=0.5,
                            prefill=300, key_range=600)
        print(f"{scheme:>12s} {str(cls.wait_free):>10s} "
              f"{str(cls.bounded_memory):>12s} {r['mops']:>8.4f} "
              f"{r['avg_unreclaimed']:>12.1f}")
    print("\nWFE pairs wait-free=True with bounded-mem=True — the paper's")
    print("contribution; Crystalline (same authors) keeps that pairing and")
    print("batches retirement, trading a small pending slack for cheaper,")
    print("amortized reclamation.")


if __name__ == "__main__":
    main()
