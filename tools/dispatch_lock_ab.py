"""A/B of the serving engine's dispatch lock, on one CUDA card, in one
call.

Run from the repository root on a machine with a card:

    python3 tools/dispatch_lock_ab.py

Full-width stablelm-3b (seeded random bf16 weights) serves
``chip_smoke.py``'s 32-request trace (64 new tokens each) on phase 4's
engine, 2 shards, through ``ServeRuntime`` with K = 2 and K = 4 workers,
two ways:

* ``engine``: ``ServeEngine`` as it is — every step launched under one
  lock shared by the shards;
* ``per-shard locks``: that lock swapped, on the engine instance only,
  for one that takes the lock of the shard whose plan is being launched
  (the reference's layout), so two workers launch on two shards at once.

For each K the runs go engine, per-shard, per-shard, engine, after one
warm-up run.  Each prints output tokens/s on the host clock (submit to
drained, as ``chip_smoke.py`` phase 4 times it), its steps and that every
request completed and the pool drained; the exit code is non-zero if one
did not.
"""

from __future__ import annotations

import sys
import threading
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


class ShardLocks:
    """A stand-in for the engine's dispatch lock that takes one lock per
    shard: ``_run_step`` is wrapped to note the plan's shard in a
    thread-local before it enters the lock."""

    def __init__(self, engine):
        self._locks = [threading.Lock() for _ in engine._streams]
        self._shard = threading.local()
        run_step = engine._run_step

        def _run_step(plan, step, arrays, b):
            self._shard.value = plan.shard
            return run_step(plan, step, arrays, b)

        engine._run_step = _run_step
        engine._dispatch_lock = self

    def __enter__(self):
        self._locks[self._shard.value].acquire()
        return self

    def __exit__(self, *exc):
        self._locks[self._shard.value].release()
        return False


def main() -> int:
    import torch

    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    if not torch.cuda.is_available():
        print("dispatch_lock_ab: no CUDA device", file=sys.stderr)
        return 2
    per_shard = [False]
    build = cs.sharded_engine

    def sharded_engine(*args, **kwargs):  # the engine serve_sharded runs
        engine = build(*args, **kwargs)
        if per_shard[0]:
            ShardLocks(engine)
        return engine

    cs.sharded_engine = sharded_engine
    print(cs.gpu_name_and_limit(), flush=True)
    dev = torch.device("cuda")
    cfg = get_config("stablelm-3b")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(cs.SEED),
                         device=dev)
    torch.cuda.synchronize()
    prompts = cs.trace(32, 64, 1024, cfg.vocab_size)
    cs.serve_sharded(cfg, params, dev, prompts, 64, workers=2)  # warm-up
    ok = True
    for k in (2, 4):
        for name in ("engine", "per-shard locks", "per-shard locks",
                     "engine"):
            per_shard[0] = name != "engine"
            r = cs.serve_sharded(cfg, params, dev, prompts, 64, workers=k)
            st = r["stats"]
            done = st["completed"] == 32 and st["unreclaimed"] == 0
            ok &= done
            print(f"K={k} {name}: {r['generated'] / r['dt']:.2f} output "
                  f"tokens/s, {r['dt']:.2f} s, {st['steps']} steps, worker "
                  f"steps {st['worker_steps']}, completed and drained "
                  f"{done}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
