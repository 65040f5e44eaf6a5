"""End-to-end SERVING driver on the PyTorch/CUDA port
(``examples/serve_engine.py`` on ``repro_torch``): a small dense LM served
with continuous batching over the WFE-reclaimed paged KV-cache block
pool, batched requests of mixed lengths, pool pressure (evictions).  On
the card by default (the paged-attention kernel reads the pages);
``--device cpu`` runs the plain PyTorch path.

Run:  PYTHONPATH=src python examples/torch_serve_engine.py [--device cpu]
"""

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_smoke_config
from repro_torch.models import build_model
from repro_torch.serve import ServeEngine


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    dev = resolve_device(ap.parse_args().device)
    cfg = get_smoke_config("stablelm-3b").scaled(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=384,
        vocab_size=1024)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    print(f"serving {cfg.param_count()/1e6:.2f}M-param model; "
          "WFE-managed paged KV cache")

    # deliberately small pool -> exercises eviction under load
    engine = ServeEngine(cfg, params, n_blocks=48, block_size=4,
                         max_batch=8, scheme="WFE",
                         era_freq=4, cleanup_freq=4, device=dev)
    tid = engine.pool.register_thread()

    prompts = [[(7 * i + j) % cfg.vocab_size for j in range(1 + i % 9)]
               for i in range(24)]
    t0 = time.time()
    reqs = [engine.submit(p, max_new_tokens=12) for p in prompts]
    stats = engine.run(tid)
    dt = time.time() - t0

    done = sum(r.done for r in reqs)
    toks = sum(len(r.generated) for r in reqs)
    print(f"completed {done}/{len(reqs)} requests, {toks} tokens "
          f"in {dt:.1f}s ({toks/dt:.1f} tok/s)")
    print(f"scheduler: {stats}")
    print(f"pool:      {engine.pool.stats()}")
    assert done == len(reqs)
    assert engine.pool.free_blocks == 48, "pool leak"
    sample = reqs[0]
    print(f"sample: prompt={sample.prompt} -> {sample.generated}")
    print("serve_engine OK")


if __name__ == "__main__":
    main()
