"""Where the host time of a training step on a one-rank mesh goes, on one
CUDA card, in one call.

Run from the repository root on a machine with a card:

    python3 tools/mesh_step_profile.py [REPORT]

Full-width stablelm-3b in bf16 with f32 masters, remat, AdamW and a
global batch of 8 x 2048 in 8 microbatches (``chip_smoke.py`` phase 8c's
step, seeded random weights), three ways in this order, each from fresh
masters: ``plain`` (plain tensors, no mesh), ``mesh`` (DTensor masters
laid out by ``sharding_tree(params_axes())`` on the one-rank NCCL smoke
mesh, ``grad_shardings`` and ``axis_rules``, as phase 9b runs it), and
``plain`` again.  Each takes one warm-up step, then 2 timed steps (host
clock, the step ends on reading its loss), then one step under
``torch.profiler`` (host activity, every thread: autograd runs the
backward on its own).  From that step it prints:

* ``ops``: the top-level aten ops the step called (an op called by no
  other recorded op), and ``ops_ms``, the host time inside them.  On
  DTensors each such op's time holds DTensor's dispatch (sharding
  propagation, any redistribution, wrapping) around the local op it
  runs, so the mesh's ``ops_ms`` less the plain step's is what DTensor's
  dispatch costs on the host;
* ``collectives``: the recorded NCCL/c10d calls;
* ``host_ms_outside_ops``: the profiled step's wall time less ``ops_ms``
  (Python, autograd's engine, hooks; on one thread at a time);
* ``device_busy_ms``: the union of the card's kernel intervals.

Given a path ``REPORT``, it writes there the 30 ops with the most host
time of each profiled step.  Its last line is one JSON object with every
number above and the card's name and power limit.
The profiler slows the host, so its shares are read against the
profiled step's own wall time; the timed steps run without it.
"""

from __future__ import annotations

import io
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke  # noqa: E402


def _top_level(prof) -> tuple:
    """(top-level aten ops, their host ms, collective calls) of a host
    profile: an op is top-level when no recorded aten op encloses it."""
    n, us, coll = 0, 0.0, 0
    for ev in prof.events():
        name = ev.name
        if "nccl" in name.lower() or name.startswith("c10d"):
            coll += 1
        if not name.startswith("aten::"):
            continue
        parent = ev.cpu_parent
        while parent is not None and not parent.name.startswith("aten::"):
            parent = parent.cpu_parent
        if parent is None:
            n += 1
            us += ev.cpu_time_total
    return n, us / 1e3, coll


def run(kind: str, dev, mesh, report: io.StringIO) -> dict:
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.models import build_model
    from repro_torch.sharding.axes import axis_rules, sharding_tree
    from repro_torch.train import AdamWConfig, make_train_step
    from repro_torch.train.optim import adamw_init, tree_map

    cfg = get_config("stablelm-3b")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(
        chip_smoke.SEED), device=dev, master=True)
    placements = None
    if kind == "mesh":
        placements = sharding_tree(params, model.params_axes(), mesh)
        params = tree_map(lambda t, pl: distribute_tensor(t, mesh, pl),
                          params, placements)
    state = {"params": params, "opt": adamw_init(params)}
    step = make_train_step(model, AdamWConfig(lr=1e-4, warmup_steps=2,
                                              total_steps=100),
                           grad_shardings=placements)
    data = SyntheticLMData(cfg.vocab_size, chip_smoke.TRAIN_SEQ,
                           chip_smoke.TRAIN_BATCH, seed=chip_smoke.SEED)
    ms = []
    with axis_rules(mesh if kind == "mesh" else None):
        for i in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, data.batch_at(i))
            loss = float(m["loss"])
            ms.append((time.perf_counter() - t0) * 1e3)
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            state, m = step(state, data.batch_at(4))
            float(m["loss"])
            torch.cuda.synchronize()
        profiled = (time.perf_counter() - t0) * 1e3
    n_ops, ops_ms, coll = _top_level(prof)
    _, busy = chip_smoke._device_busy(prof)
    report.write(f"==== {kind}: profiled step {profiled:.1f} ms\n")
    report.write(prof.key_averages().table(sort_by="cpu_time_total",
                                           row_limit=30))
    report.write("\n")
    del state, step
    torch.cuda.empty_cache()
    return {"kind": kind, "ms_per_step": ms[1:], "warm_ms": ms[0],
            "last_loss": loss, "profiled_ms": profiled, "ops": n_ops,
            "ops_ms": ops_ms, "collectives": coll,
            "host_ms_outside_ops": profiled - ops_ms,
            "device_busy_ms": busy * 1e3}


def main() -> int:
    if not torch.cuda.is_available():
        print("mesh_step_profile: no CUDA device", file=sys.stderr)
        return 2
    import torch.distributed as dist

    from repro_torch.kernels import build
    from repro_torch.launch.mesh import make_smoke_mesh

    dev = torch.device("cuda")
    build.build()
    card = chip_smoke.gpu_name_and_limit()
    mesh = make_smoke_mesh(dev)
    report = io.StringIO()
    try:
        rows = [run(kind, dev, mesh, report)
                for kind in ("plain", "mesh", "plain")]
    finally:
        dist.destroy_process_group()
    if len(sys.argv) > 1:
        out = Path(sys.argv[1])
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(report.getvalue())
    for r in rows:
        print(f"{r['kind']}: ms/step {r['ms_per_step']} (warm-up "
              f"{r['warm_ms']:.1f}); profiled {r['profiled_ms']:.1f} ms: "
              f"{r['ops']} top-level ops, {r['ops_ms']:.1f} ms of host time "
              f"in them ({r['ops_ms'] / max(r['ops'], 1) * 1e3:.1f} us "
              f"each), {r['host_ms_outside_ops']:.1f} ms outside them, "
              f"{r['collectives']} collective calls; device busy "
              f"{r['device_busy_ms']:.1f} ms", flush=True)
    print(card)
    print(json.dumps({"card": card, "runs": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
