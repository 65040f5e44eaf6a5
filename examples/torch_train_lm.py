"""End-to-end training example on the PyTorch/CUDA port
(``examples/train_lm.py`` on ``repro_torch``): a small LM, a few hundred
steps, with async checkpointing (WFE-reclaimed snapshot generations), an
injected mid-run failure, and automatic restart from the manifest.  On
the card by default; ``--device cpu`` runs the plain PyTorch path.

Run:  PYTHONPATH=src python examples/torch_train_lm.py [--steps 200] \\
          [--bigger] [--device cpu]

``--bigger`` selects a ~100M-parameter config (for the card; the default
is sized so a few hundred steps finish in minutes on a CPU).
"""

import argparse
import tempfile
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_smoke_config
from repro_torch.data import PrefetchingLoader, SyntheticLMData
from repro_torch.models import build_model
from repro_torch.train import AdamWConfig, Trainer
from repro_torch.train.checkpoint import Checkpointer
from repro_torch.train.fault_tolerance import run_with_restarts


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--bigger", action="store_true",
                    help="~100M-param config (the card)")
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a failure at this step (default steps//2)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    cfg = get_smoke_config("stablelm-3b")
    if args.bigger:  # ~100M params
        cfg = cfg.scaled(n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
                         d_ff=2048, vocab_size=32_768)
    else:  # CPU-friendly: ~1.6M params
        cfg = cfg.scaled(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                         d_ff=512, vocab_size=2048)
    cfg = cfg.scaled(num_microbatches=1)
    model = build_model(cfg)
    print(f"model: {cfg.param_count()/1e6:.2f}M params, "
          f"{cfg.n_layers}L d={cfg.d_model}")

    data = SyntheticLMData(cfg.vocab_size, args.seq, args.batch)
    loader = PrefetchingLoader(data, depth=2)  # era-reclaimed prefetch
    fail_at = args.fail_at if args.fail_at is not None else args.steps // 2
    armed = {"on": True}

    with tempfile.TemporaryDirectory() as ckpt_dir:
        ckpt = Checkpointer(ckpt_dir, sync=True, keep_last=2)
        opt = AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=args.steps)
        trainer = Trainer(model, opt, checkpointer=ckpt, checkpoint_every=25,
                          device=dev)
        state = trainer.init(torch.Generator(device=dev).manual_seed(0))

        losses = []
        orig_run = trainer.run

        def run_logged(state, batches, *, steps):
            def on_metrics(step, m):
                losses.append(m["loss"])
                if armed["on"] and step == fail_at:
                    armed["on"] = False
                    raise RuntimeError(f"injected failure at step {step}")
                if step % 25 == 0:
                    print(f"  step {step:4d}  loss {m['loss']:.4f}  "
                          f"lr {m['lr']:.2e}")
            return orig_run(state, batches, steps=steps,
                            on_metrics=on_metrics)

        trainer.run = run_logged
        t0 = time.time()
        state = run_with_restarts(
            trainer, state, lambda s: data.stream(s),
            total_steps=args.steps, chunk=args.steps,
            on_restart=lambda n, e: print(f"  RESTART #{n}: {e} — resuming "
                                          f"from the last manifest"))
        dt = time.time() - t0
        print(f"trained to step {int(state['opt']['step'])} in {dt:.1f}s "
              f"({dt/args.steps:.2f}s/step)")
        first, last = losses[0], sum(losses[-10:]) / 10
        print(f"loss: {first:.3f} -> {last:.3f}")
        assert last < first, "loss did not decrease"
        ckpt.close()
    loader.close()
    print("train_lm OK (failure injected + recovered, loss decreased)")


if __name__ == "__main__":
    main()
