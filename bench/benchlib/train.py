"""The training driver: one run of a training cell against ``repro_torch``.

Set-up builds one ``Trainer`` (the compiled step: one CUDA graph per step
signature) over the configuration's model, f32 master weights drawn from
the seed and a fresh AdamW state, fed by the port's ``PrefetchingLoader``
over the mix's seeded batches, and drives it through its first three
steps, the first of which runs eagerly and captures the graph.  The first
gradient (from AdamW's first moment after step 1) and the parameters'
change after step 3 are read per leaf there.  The window then runs the
same trainer, on the same state and feed, step after step for
``seconds``.  After the window the program's state is freed and the f32
reference (``reference.train_steps``) repeats the first three steps from
the same weights and batches."""

from __future__ import annotations

import gc
import math
import statistics
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from . import reference, weights
from .common import PEAK_BF16, load_module, BENCH
from .serve import arch_config

_FLASH = load_module(BENCH / "rooflines" / "flash.py", "bench_roofline_flash")


@dataclass
class TrainRun:
    cell: str
    arch: dict
    train: dict
    setup_s: float
    t0: float
    t1: float
    tokens_per_step: int
    window_steps: List[float]  # end of each step completed in the window
    step_starts: List[float]
    losses: List[float]  # the program's losses, every step
    grad1: Dict[str, float]
    change: Dict[str, float]
    first_step_s: float
    capture_s: float
    profile: object = None
    prof_window: Optional[list] = None
    prof_steps: int = 0
    unprofiled_s: List[float] = field(default_factory=list)


def _norms(tree) -> Dict[str, float]:
    return {"/".join(p): float(t.float().norm()) for p, t in
            reference._flat(tree)}


def run(cell_name: str, cfg_file: dict, traffic: dict, gen, *, seed: int,
        seconds: float, trace: bool, device, t_start: float) -> TrainRun:
    from repro_torch.data import PrefetchingLoader
    from repro_torch.models import build_model
    from repro_torch.train import AdamWConfig, Trainer
    from repro_torch.train.optim import adamw_init

    arch, tr = cfg_file["arch"], cfg_file["train"]
    cfg = arch_config(dict(arch, num_microbatches=tr["microbatches"],
                           remat=bool(tr["remat"])))
    params = weights.make_params(arch, seed, device, dtype=torch.float32)
    state = {"params": params, "opt": adamw_init(params)}
    trainer = Trainer(build_model(cfg), AdamWConfig(**tr["adamw"]),
                      device=device)
    loader = PrefetchingLoader(gen.Data(traffic, seed, arch["vocab_size"]))
    p0 = {p: t.detach().to("cpu", copy=True)
          for p, t in reference._flat(params)}
    losses: List[float] = []
    stamps: List[float] = []

    def on_metrics(step, m):
        stamps.append(time.monotonic())
        losses.append(m["loss"])

    t_first = time.monotonic()
    trainer.run(state, loader, steps=1, on_metrics=on_metrics)
    first_step_s = time.monotonic() - t_first
    b1 = tr["adamw"]["beta1"]
    grad1 = {k: n / (1 - b1) for k, n in _norms(state["opt"]["m"]).items()}
    trainer.run(state, loader, steps=2, on_metrics=on_metrics)
    change = {}
    with torch.no_grad():
        for path, t in reference._flat(state["params"]):
            change["/".join(path)] = float(
                (t - p0[path].to(t.device)).float().norm())
    del p0
    tokens = int(traffic["batch"]) * int(traffic["seq"])
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    t0 = time.monotonic()
    t_end = t0 + seconds
    prof = prof_window = None
    prof_steps = 0
    prof_at = t0 + 0.4 * seconds
    done: List[float] = []
    starts: List[float] = []
    unprofiled: List[float] = []
    while True:
        profiling = trace and prof is None and prof_steps == 0 and \
            time.monotonic() >= prof_at
        if profiling:
            from torch.profiler import ProfilerActivity, profile
            torch.cuda.synchronize()
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.start()
            torch.cuda.synchronize()
            prof_window = [time.perf_counter(), None]
        s0 = time.monotonic()
        with (torch.profiler.record_function("bench.step") if profiling
              else _null()):
            trainer.run(state, loader, steps=int(tr.get("profile_steps", 2))
                        if profiling else 1, on_metrics=on_metrics)
        s1 = time.monotonic()
        if profiling:
            torch.cuda.synchronize()
            prof_window[1] = time.perf_counter()
            prof.stop()
            prof_steps = int(tr.get("profile_steps", 2))
        else:
            unprofiled.append(s1 - s0)
        if s1 > t_end:
            break
        starts.append(s0)
        done.append(s1)
    loader.close()
    run_ = TrainRun(cell_name, arch, tr, setup_s=t0 - t_start, t0=t0,
                    t1=t_end, tokens_per_step=tokens,
                    window_steps=done, step_starts=starts,
                    losses=losses, grad1=grad1, change=change,
                    first_step_s=first_step_s,
                    capture_s=float(getattr(trainer._step_fn,
                                            "capture_seconds", 0.0)),
                    profile=prof, prof_window=prof_window,
                    prof_steps=prof_steps, unprofiled_s=unprofiled)
    run_.seed = seed
    run_.traffic = traffic
    run_.gen = gen
    del state, trainer, params, loader
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return run_


class _null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


# ----------------------------------------------------------------- layers
def step_flops(arch: dict, traffic: dict) -> float:
    """Model FLOPs of one step: 6 x non-embedding parameters x tokens, plus
    causal attention's forward (4 D per pair and head) and backward
    (10 D)."""
    d, v = arch["d_model"], arch["vocab_size"]
    n = weights.count(arch, ("dense",)) + weights.count(arch, ("norm",))
    tokens = int(traffic["batch"]) * int(traffic["seq"])
    h = arch["n_heads"]
    hd = arch.get("head_dim") or d // h
    s = int(traffic["seq"])
    att = arch["n_layers"] * int(traffic["batch"]) * (
        _FLASH.forward_ops(s, h, hd) + _FLASH.backward_ops(s, h, hd))
    return 6.0 * n * tokens + att


def mfu_pct(run: TrainRun) -> Optional[float]:
    if not run.unprofiled_s:
        return None
    step_s = statistics.median(run.unprofiled_s)
    return 100.0 * step_flops(run.arch, run.traffic) / (step_s * PEAK_BF16)


def flash_roofline_pct(run: TrainRun) -> Optional[float]:
    from .layers import trace
    tr = trace(run)
    if tr is None:
        return None
    kernel_s = tr.time_of(_FLASH.KERNELS_FWD + _FLASH.KERNELS_BWD)
    if kernel_s <= 0:
        return None
    a = run.arch
    h = a["n_heads"]
    hd = a.get("head_dim") or a["d_model"] // h
    s = int(run.traffic["seq"])
    seqs = a["n_layers"] * int(run.traffic["batch"]) * run.prof_steps
    fwd_calls = seqs * (2 if run.train["remat"] else 1)
    ops = (fwd_calls * _FLASH.forward_ops(s, h, hd)
           + seqs * _FLASH.backward_ops(s, h, hd))
    return 100.0 * ops / PEAK_BF16 / kernel_s


# ------------------------------------------------------------ correctness
def checks(run: TrainRun, seed: int, cfg_file: dict,
           **fault) -> dict:
    """The numbers that decide ``correct``, each with its limit: the three
    steps' worst relative loss gap, and, by the worst leaf, the gap between
    the program's and the reference's norms of the first clipped gradient
    and of the change after three steps, each over the larger of that
    leaf's reference norm and the median leaf's.  Leaves whose reference
    gradient is under a thousandth of the median leaf's are left out of
    the change (round-off moves them under AdamW)."""
    arch, tr = cfg_file["arch"], cfg_file["train"]
    lim = tr["check"]
    dev = torch.device("cuda", 0) if torch.cuda.is_available() \
        else torch.device("cpu")
    params0 = weights.make_params(arch, seed, dev, dtype=torch.float32)
    batches = [run.gen.batch_at(run.traffic, seed, i, arch["vocab_size"])
               for i in range(3)]
    t0 = time.perf_counter()
    ref = reference.train_steps(arch, params0, batches, tr["adamw"],
                                eps=cfg_file["norm_eps"],
                                microbatches=tr["microbatches"], **fault)
    run.reference_s = time.perf_counter() - t0
    del params0
    run.ref = ref
    gaps = compare({"losses": run.losses[:3], "grad1": run.grad1,
                    "change": run.change}, ref)
    bad = sum(1 for x in run.losses if not math.isfinite(x))
    return {"nonfinite_losses": (bad, 0),
            "loss_gap": (gaps["loss_gap"], float(lim["loss_gap"])),
            "grad_gap": (gaps["grad_gap"], float(lim["grad_gap"])),
            "change_gap": (gaps["change_gap"], float(lim["change_gap"]))}


def compare(got: dict, ref: dict) -> dict:
    """The three gaps of ``got`` (losses, per-leaf first-gradient and
    change norms) from the reference's ``ref`` (see ``checks``)."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in
                   zip(got["losses"], ref["losses"]))
    g_med = statistics.median(ref["grad1"].values())
    grad_gap = max(abs(got["grad1"][k] - r) / max(r, g_med)
                   for k, r in ref["grad1"].items())
    keep = [k for k, g in ref["grad1"].items() if g >= 1e-3 * g_med]
    c_med = statistics.median(ref["change"][k] for k in keep)
    change_gap = max(abs(got["change"][k] - ref["change"][k])
                     / max(ref["change"][k], c_med) for k in keep)
    worst = max(keep, key=lambda k: abs(got["change"][k] - ref["change"][k])
                / max(ref["change"][k], c_med))
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap, "change_worst_leaf": worst}


def is_correct(c: dict) -> bool:
    return c["nonfinite_losses"][0] == 0 and all(
        c[k][0] <= c[k][1] for k in ("loss_gap", "grad_gap", "change_gap"))


def attempted(run: TrainRun) -> int:
    return len(run.losses)


def n_failed(run: TrainRun) -> int:
    return sum(1 for x in run.losses if not math.isfinite(x))


def report(run: TrainRun) -> List[str]:
    steps = [b - a for a, b in zip(run.step_starts, run.window_steps)]
    return [f"steps {len(run.losses)} (window {len(run.window_steps)}, "
            f"profiled {run.prof_steps}); first step {run.first_step_s:.3f} "
            f"s, capture {run.capture_s:.3f} s, setup {run.setup_s:.3f} s",
            f"window step s median "
            f"{statistics.median(run.unprofiled_s) if run.unprofiled_s else float('nan'):.4f}"
            f"; losses {[round(x, 5) for x in run.losses[:4]]} ... "
            f"{[round(x, 5) for x in run.losses[-2:]]}"]
