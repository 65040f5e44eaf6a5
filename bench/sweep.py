"""Find a serving cell's knee: the highest fixed arrival rate whose backlog
does not grow, in one process (one set-up, one warm-up).

    python3 bench/sweep.py --workload <cell> --seed <n> --seconds <s> \\
        --rates 1.5,2,2.5,3,3.5

For each rate the cell's mix is sent open-loop for ``--seconds``; the
backlog is read from the requests' stamps, and the rate grows the backlog when the least-squares slope of the
backlog over the window's second half exceeds ``--growth`` of the rate.
Requests still unfinished ``--drain`` seconds after a window are
cancelled before the next rate.  Prints one JSON line per rate, then the
knee.  The backlog counted is of requests waiting for their first token:
one still decoding is served, and a long output keeps it in the house
well past a short window even under the knee."""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent / "src"))

import run as bench_run  # noqa: E402,F401  (sets the cache directories)


def backlog_slope(sent, t0: float, t1: float) -> float:
    """Least-squares slope (requests/s) over the second half of [t0, t1)
    of the requests sent and still waiting for their first token: under
    the knee it levels off at rate x TTFT, above it it grows."""
    ts = np.linspace(t0 + (t1 - t0) / 2, t1, 40)
    subs = np.array([s.submitted for s in sent])
    firsts = np.array([s.req.t_first if s.req is not None and
                       s.req.t_first is not None else np.inf for s in sent])
    waiting = [(subs <= t).sum() - (firsts <= t).sum() for t in ts]
    return float(np.polyfit(ts - ts[0], waiting, 1)[0])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--growth", type=float, default=0.05)
    p.add_argument("--drain", type=float, default=30.0)
    args = p.parse_args(argv)
    import torch
    from benchlib import common, serve, weights
    from repro_torch.serve.runtime import ServeRuntime
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = common.cell(args.workload)
    cfg_file = common.load_json(common.config_file(cell["config"]))
    traffic = dict(common.load_json(common.traffic_file(cell["traffic"])))
    traffic["drain_s"] = args.drain
    gen = common.generator(traffic["kind"])
    dev = torch.device("cuda", 0)
    arch, d = cfg_file["arch"], cfg_file["serve"]
    params = weights.make_params(arch, args.seed, dev)
    engine = serve.build_engine(cfg_file, params, dev)
    serve.warm_up(engine, serve.signatures(gen.length_space(traffic),
                                           bs=d["block_size"],
                                           chunk=d["chunk_size"]),
                  np.random.default_rng(args.seed + 7), arch["vocab_size"])
    runtime = ServeRuntime(engine, n_workers=d.get("n_workers", 1))
    print(json.dumps({"setup_s": time.monotonic() - T_START,
                      "card": torch.cuda.get_device_name(0)}), flush=True)
    knee = None
    preload = getattr(gen, "preload", None)
    fill_tid = engine.pool.register_thread() if preload else None
    for r in [float(x) for x in args.rates.split(",")]:
        if preload is not None:  # each window's drain clears the cache
            serve.fill_prefix_cache(engine, preload(traffic, args.seed,
                                                    arch["vocab_size"]),
                                    tid=fill_tid)
        reqs = gen.requests(traffic, args.seed, args.seconds,
                            arch["vocab_size"], rate=r)
        run = serve.serve_window(cell["name"], cfg_file, traffic, gen, engine,
                                 reqs, seconds=args.seconds, trace=False,
                                 device=dev, t_start=T_START, runtime=runtime)
        slope = backlog_slope(run.sent, run.t0, run.t1)
        out = {"rate": r, "sent": len(run.sent),
               "unfinished_at_close": sum(
                   1 for s in run.sent if s.req is None or s.req.t_last is None
                   or s.req.state != "done" or s.req.t_last > run.t1),
               "backlog_slope": slope,
               "grows": slope > args.growth * r,
               "failed": len(serve.failed(run)),
               "steps": len(run.window_steps())}
        for name in ("ttft_p95_ms", "tpot_p95_ms"):
            out[name] = common.reader("e2e", name)(run)
        print(json.dumps(out), flush=True)
        if not out["grows"]:
            knee = r
    print(json.dumps({"knee": knee, "rates": args.rates}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
