"""Training driver (``repro.launch.train``), on the CUDA device by default
(``--device cpu`` runs the plain PyTorch path on the CPU).

``--smoke`` (the default, and the only mode the flag allows): the REDUCED
config of the selected arch runs real steps with checkpointing and
restart.  The full-config mesh dry run is ``repro_torch.launch.dryrun``
(``python -m repro_torch.launch.dryrun --arch ... --shape train_4k``).
Weights are random, from generator seed 0 on the device.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b \
      --steps 50 --batch 8 --seq 64 --ckpt-dir /tmp/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 20
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import ALL_ARCHS, get_config, get_smoke_config
from repro_torch.data import SyntheticLMData
from repro_torch.models import build_model
from repro_torch.train import AdamWConfig, Trainer
from repro_torch.train.checkpoint import Checkpointer
from repro_torch.train.fault_tolerance import run_with_restarts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ALL_ARCHS, default="stablelm-3b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.batch % cfg.num_microbatches:
        cfg = cfg.scaled(num_microbatches=1)
    model = build_model(cfg)
    n = cfg.param_count()
    print(f"arch={cfg.name} params={n/1e6:.1f}M "
          f"(smoke={args.smoke}) steps={args.steps} device={dev}")

    extras = {}
    if cfg.frontend == "patches":
        extras["patch_embeds"] = (cfg.n_frontend_tokens, cfg.d_model)
    if cfg.frontend == "frames":
        extras["frames"] = (cfg.encoder_ctx, cfg.d_model)
    data = SyntheticLMData(cfg.vocab_size, args.seq, args.batch,
                           extras=extras)
    opt = AdamWConfig(lr=args.lr, warmup_steps=max(2, args.steps // 20),
                      total_steps=args.steps)
    ckpt = Checkpointer(args.ckpt_dir, sync=False) if args.ckpt_dir else None
    trainer = Trainer(model, opt, checkpointer=ckpt,
                      checkpoint_every=args.ckpt_every if ckpt else 0,
                      device=dev)
    state = trainer.init(torch.Generator(device=dev).manual_seed(0))
    if ckpt is not None:
        restored = ckpt.restore(state)
        if restored is not None:
            state = restored
            print(f"resumed from step {int(state['opt']['step'])}")

    t0 = time.time()
    losses = []

    def log(step, m):
        losses.append(m["loss"])
        if step % args.log_every == 0:
            dt = time.time() - t0
            print(f"step {step:5d}  loss {m['loss']:.4f}  "
                  f"lr {m['lr']:.2e}  gnorm {m['grad_norm']:.3f}  "
                  f"({dt/max(len(losses), 1):.2f}s/step)")

    orig_run = trainer.run
    trainer.run = lambda st, batches, *, steps: orig_run(
        st, batches, steps=steps, on_metrics=log)
    state = run_with_restarts(
        trainer, state, lambda s: data.stream(s),
        total_steps=int(state["opt"]["step"]) + args.steps, chunk=args.steps,
        on_restart=lambda n, e: print(f"RESTART #{n}: {e}"))
    if ckpt is not None:
        ckpt.close()
    if losses:
        print(f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    print(f"done: {args.steps} steps in {time.time()-t0:.1f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
