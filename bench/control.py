"""The readings a serving cell's ``max_gap`` limit is set from, in one
process: the program's widest served-token gap on many seeds (the lower
reading), and the controls' (the upper reading).

    python3 bench/control.py --workload <cell> --seeds 1,2,3 --seconds 20 \\
        [--control-seeds 3] [--int8-seeds 3]

One engine at the cell's deployment is built and warmed once.  For each
seed the weights are redrawn from it into the same tensors (the captured graphs
read them in place), the cell's mix is sent for ``--seconds`` at the
cell's own load and served to completion, and a run's sample of served
tokens is judged against the float32 reference.  On the first
``--control-seeds`` seeds the same positions are also read under the
control, the reference with every product in float8 e4m3 (``reference.py``):
the gap of the token it puts first.  ``--int8-seeds`` then rebuilds the
engine with the program's own int8 pages and reads their served gaps.
Prints one JSON line per reading.  The benchmark's own runs do not run
this."""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent / "src"))

import run as bench_run  # noqa: E402,F401  (sets the cache directories)


def redraw(arch: dict, params: dict, seed: int) -> None:
    """New weights from ``seed`` in place, leaf by leaf (the engine's
    graphs read these tensors; a second full set would not fit beside the
    pool), from the distributions of ``weights.make_params``."""
    import torch
    from benchlib import weights
    gen = torch.Generator(device=params["embed"]["table"].device)
    gen.manual_seed(int(seed) % (2 ** 63))
    for path, shape, kind in weights.shapes(arch):
        t = weights.leaf(params, path)
        t.normal_(generator=gen)
        if kind == "dense":
            t.mul_(1.0 / math.sqrt(shape[-2]))
        elif kind == "norm":
            t.mul_(0.1)


def readings(cell, cfg_file, traffic, gen, dev, seeds, seconds, *,
             kv_dtype=None, control_seeds=0):
    import torch
    from benchlib import serve, weights
    from repro_torch.serve.runtime import ServeRuntime
    cfg_file = json.loads(json.dumps(cfg_file))
    if kv_dtype is not None:
        cfg_file["serve"]["kv_dtype"] = kv_dtype
    arch, d = cfg_file["arch"], cfg_file["serve"]
    params = weights.make_params(arch, seeds[0], dev)
    engine = serve.build_engine(cfg_file, params, dev)
    serve.warm_up(engine, serve.signatures(gen.length_space(traffic),
                                           bs=d["block_size"],
                                           chunk=d["chunk_size"]),
                  np.random.default_rng(seeds[0] + 7), arch["vocab_size"])
    runtime = ServeRuntime(engine, n_workers=d.get("n_workers", 1))
    tokens = int(d["check"]["tokens"])
    fill_tid = (engine.pool.register_thread()
                if getattr(gen, "preload", None) else None)
    for i, seed in enumerate(seeds):
        if i > 0:
            redraw(arch, params, seed)
        torch.cuda.synchronize()
        preload = getattr(gen, "preload", None)
        if preload is not None:  # each window's drain clears the cache
            serve.fill_prefix_cache(engine, preload(traffic, seed,
                                                    arch["vocab_size"]),
                                    tid=fill_tid)
        reqs = gen.requests(traffic, seed, seconds, arch["vocab_size"])
        run = serve.serve_window(cell["name"], cfg_file, traffic, gen, engine,
                                 reqs, seconds=seconds, trace=False,
                                 device=dev, t_start=time.monotonic(),
                                 runtime=runtime)
        picked = serve.sample(run, seed, tokens,
                              int(d["check"].get("requests", 4)))
        t0 = time.perf_counter()
        gaps = serve.served_gaps(arch, params, picked, cfg_file["norm_eps"])
        ref_s = time.perf_counter() - t0
        out = {"seed": seed, "path": kv_dtype or d["kv_dtype"],
               "sent": len(run.sent), "failed": len(serve.failed(run)),
               "sampled_requests": len(picked),
               "sampled_tokens": sum(s.max_new for s in picked),
               "max_gap": max(gaps) if gaps else None, "gaps": gaps,
               "reference_s": ref_s, "unreclaimed": run.unreclaimed}
        if i < control_seeds:
            ctl = serve.served_gaps(arch, params, picked, cfg_file["norm_eps"],
                                    quant="fp8")
            out["control_fp8_max_gap"] = max(ctl) if ctl else None
            out["control_fp8_gaps"] = ctl
        print(json.dumps(out), flush=True)
    serve.free_engine(engine)
    del params


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--int8-seeds", type=int, default=0)
    args = p.parse_args(argv)
    import torch
    from benchlib import common
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = common.cell(args.workload)
    cfg_file = common.load_json(common.config_file(cell["config"]))
    traffic = common.load_json(common.traffic_file(cell["traffic"]))
    gen = common.generator(traffic["kind"])
    dev = torch.device("cuda", 0)
    seeds = [int(x) for x in args.seeds.split(",")]
    print(json.dumps({"card": torch.cuda.get_device_name(0)}), flush=True)
    readings(cell, cfg_file, traffic, gen, dev, seeds, args.seconds,
             control_seeds=args.control_seeds)
    if args.int8_seeds:
        torch.cuda.empty_cache()
        readings(cell, cfg_file, traffic, gen, dev, seeds[:args.int8_seeds],
                 args.seconds, kv_dtype="int8")
    return 0


if __name__ == "__main__":
    sys.exit(main())
