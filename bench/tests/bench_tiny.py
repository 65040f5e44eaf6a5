"""A tiny configuration and mix for the benchmark's CPU tests: the serving
driver runs end to end on the port's plain CPU path at this size."""

import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH), str(BENCH.parent / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

#: the widest served-token gap the tiny model's bf16 engine may show
#: against the f32 reference (it reads 0 on seeds 1-3; the fp8 control
#: reads 0.04-0.24 there)
TINY_MAX_GAP = 0.02

CFG = {"arch": {"name": "tiny", "family": "dense", "n_layers": 2,
                "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "d_ff": 128,
                "vocab_size": 256, "block_pattern": ["attn"],
                "mlp_kind": "swiglu", "norm_kind": "layernorm",
                "rope_theta": 10000.0, "dtype": "bfloat16"},
       "norm_eps": 1e-6,
       "serve": {"n_blocks": 256, "block_size": 16, "max_batch": 4,
                 "chunk_size": 32, "scheme": "WFE", "use_kernel": True,
                 "kv_dtype": "bf16", "n_workers": 1,
                 "check": {"tokens": 60, "max_gap": TINY_MAX_GAP}}}

MIX = {"kind": "open_loop", "rate_per_s": 6, "salt": 1,
       "prompt": {"dist": "lognormal", "median": 24, "sigma": 1.0,
                  "min": 4, "max": 64},
       "output": {"dist": "lognormal", "median": 8, "sigma": 0.5,
                  "min": 2, "max": 16},
       "drain_s": 30}


#: the tiny mix behind shared system prompts
SHARED = dict(MIX, prefixes={"count": 3, "length": 32, "zipf_s": 1.1},
              prompt={"dist": "uniform", "min": 4, "max": 24})


def serve_run(seed: int, seconds: float = 1.5, mix=None):
    """One serving run of the tiny cell on the CPU, the look for a card
    skipped."""
    import torch
    from benchlib import common, serve
    mix = MIX if mix is None else mix
    gen = common.generator(mix["kind"])
    return serve.run("tiny.chat", CFG, mix, gen, seed=seed, seconds=seconds,
                     trace=False, device=torch.device("cpu"),
                     t_start=time.monotonic())


#: the tiny trainer's limits: its bf16 steps read at most 4e-4 (loss),
#: 3e-3 (first gradient) and 7e-4 (change) against the f32 reference on
#: seeds 1-2; half the batch left out reads 0.015, 0.17 and 0.15 there
TRAIN_CFG = {"arch": dict(CFG["arch"], n_kv_heads=4), "norm_eps": 1e-6,
             "train": {"microbatches": 2, "remat": True, "profile_steps": 2,
                       "adamw": {"lr": 1e-3, "beta1": 0.9, "beta2": 0.95,
                                 "eps": 1e-8, "weight_decay": 0.1,
                                 "grad_clip": 1.0, "warmup_steps": 2,
                                 "total_steps": 100, "min_lr_ratio": 0.1},
                       "check": {"loss_gap": 3e-3, "grad_gap": 3e-2,
                                 "change_gap": 2e-2}}}
TRAIN_MIX = {"kind": "lm_batches", "batch": 4, "seq": 32, "zipf_a": 1.3}


def train_run(seed: int, seconds: float = 0.5):
    import torch
    from benchlib import common, train
    gen = common.generator(TRAIN_MIX["kind"])
    return train.run("tiny.train", TRAIN_CFG, TRAIN_MIX, gen, seed=seed,
                     seconds=seconds, trace=False, device=torch.device("cpu"),
                     t_start=time.monotonic())
