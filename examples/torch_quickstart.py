"""Quickstart on the PyTorch/CUDA port (``examples/quickstart.py`` on
``repro_torch``): the paper's API in 60 lines.

1. WFE-protected Treiber stack (paper Fig. 2) under concurrent churn;
2. the forced-slow-path stress the paper uses in §5;
3. the serving adaptation in miniature: a WFE-managed KV block pool whose
   batched cleanup runs the era-scan kernel on the card (``--device cpu``:
   its plain PyTorch version).

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""

import argparse
import threading

from repro_torch import resolve_device
from repro_torch.blocks import BlockPool
from repro_torch.core import make_scheme
from repro_torch.core.datastructures import TreiberStack

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None, help="torch device (default: cuda)")
backend = "cuda" if resolve_device(ap.parse_args().device).type == "cuda" \
    else "torch"

# ---- 1. a wait-free-reclaimed lock-free stack ------------------------------
smr = make_scheme("WFE", max_threads=4, era_freq=4, cleanup_freq=4)
stack = TreiberStack(smr)


def worker(n):
    tid = smr.register_thread()
    for i in range(2000):
        stack.push((n, i), tid)
        stack.pop(tid)
    for _ in range(8):
        smr.flush(tid)


threads = [threading.Thread(target=worker, args=(n,)) for n in range(3)]
for t in threads:
    t.start()
for t in threads:
    t.join()
print("stack churn:", smr.stats())
assert smr.stats()["unreclaimed"] <= 64  # strictly bounded (paper Thm. 4)

# ---- 2. forced slow path (paper §5 stress) ---------------------------------
stress = make_scheme("WFE", max_threads=2, max_attempts=1,
                     era_freq=1, cleanup_freq=1)
s2 = TreiberStack(stress)
tid = stress.register_thread()
for i in range(200):
    s2.push(i, tid)
    s2.pop(tid)
print("forced slow path:", stress.stats())
assert stress.stats()["slow_paths"] > 0

# ---- 3. the serving adaptation: era-reclaimed KV block pool ----------------
# every cleanup takes the batched scan (threshold 1) on ``backend``
pool = BlockPool(16, era_freq=1, cleanup_freq=1, cleanup_backend=backend,
                 vectorized_threshold=1)
t0 = pool.register_thread()
t1 = pool.register_thread()
blocks = [pool.alloc(t0) for _ in range(4)]
pool.protect_step(slot=0, tid=t1)  # an in-flight device step
for b in blocks:
    pool.retire(b, t0)
pool.cleanup(t0)
assert pool.free_blocks == 12, "reserved step must pin retired blocks"
pool.release_step(slot=0, tid=t1)  # step completed
pool.cleanup(t0)
assert pool.free_blocks == 16
print("block pool:", pool.stats())
print("quickstart OK")
