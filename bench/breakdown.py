"""One run of a cell, then where its time went by the program's own spans
and stamps (``repro_torch.obs``, ``Request.t_admit``/``t_prefill``).

    python3 bench/breakdown.py --workload <cell> --seed <n> --seconds <s> \
        [--trace 0|1] [--record 0|1]

Runs the cell as ``bench/run.py`` does and prints its result line, then
one line ``breakdown <json>``:

* ``idle_ms`` (``--trace 1``): the profiled sub-window's device-idle time
  between its first and last device interval, by the path of the
  innermost program span covering each gap's middle
  (``engine.step/sched.complete/pool.cleanup``; ``none``: no span);
* serving: per step kind, the steps' count and median ``engine.step`` and
  the mean time a step spends in each span under it (by path), the mean
  ``sched.tick`` per step and the summed ``worker.park``; and the TTFT
  of the window's requests (with ``--trace 1``, those the stamp waits
  read: due ``spans.MARGIN_S`` before the profiler's start) split at
  their stamps: from due to submission,
  submission to admission (queue wait), admission to the first prefill
  chunk planned (prefill wait), and that to the first token (the rest),
  for the request at the p95 rank and as the mean over the requests at
  or above it;
* training: per step the ``train.data``, ``train.step`` and
  ``train.metrics`` times.

Spans are those of the profiled sub-window, or with ``--record 1``
(``obs.enable()`` over the whole run) and ``--trace 0`` those of the
whole window.  ``--trace 1 --record 1`` against ``--record 0`` gives the
cost of recording (``host_ms_per_step.tpot`` reads the steps before the
profiled sub-window).  Run on the card by hand, never by a check.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

from benchlib import common, spans  # noqa: E402

#: ``bench/run.py``: its import sets the caches and puts ``src`` on the path
RUN = common.load_module(HERE / "run.py", "bench_run")


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=1)
    p.add_argument("--record", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _path(p, by_id, stop=None) -> str:
    names = []
    while p is not None and p is not stop:
        names.append(p.name)
        p = by_id.get(p.parent)
    return "/".join(reversed(names))


def idle_ms(run) -> dict:
    got = spans.profiled_gaps(run)
    if got is None:
        return {}
    gaps, _, sp, inner = got
    by_id = {p.id: p for p in sp}
    out: dict = {}
    for a, b in gaps:
        p = inner.at((a + b) / 2)
        label = "none" if p is None else _path(p, by_id)
        out[label] = out.get(label, 0.0) + 1e3 * (b - a)
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def recorded(run) -> list:
    """The program's spans of the profiled sub-window, on the profile's
    clock; without a profile those of the whole window, on a clock from
    its start."""
    if getattr(run, "profile", None) is not None:
        return spans.spans(run) or []
    off = time.time_ns() - time.monotonic_ns()
    lo, hi = int(run.t0 * 1e9) + off, int(run.t1 * 1e9) + off
    return [spans.Placed(r, lo) for r in spans.program_records() or []
            if lo <= r.t0_ns <= hi]


def steps_ms(run) -> dict:
    """Per step kind: count, median step, mean ms a step in each span
    under it (by path from the step)."""
    sp = recorded(run)
    by_id = {p.id: p for p in sp}

    def step_of(p):
        while p is not None and p.name != "engine.step":
            p = by_id.get(p.parent)
        return p

    out: dict = {}
    steps = [p for p in sp if p.name == "engine.step"]
    for kind in sorted({p.attrs.get("kind") for p in steps}):
        mine = [p for p in steps if p.attrs.get("kind") == kind]
        ids = {p.id for p in mine}
        under: dict = {}
        for p in sp:
            s = step_of(by_id.get(p.parent))
            if s is not None and s.id in ids:
                key = _path(p, by_id, stop=s)
                under[key] = under.get(key, 0.0) + p.seconds
        out[kind] = {"n": len(mine),
                     "median_ms": 1e3 * statistics.median(
                         p.seconds for p in mine),
                     "mean_ms_under": {k: 1e3 * v / len(mine) for k, v in
                                       sorted(under.items())}}
    n = max(1, len(steps))
    out["sched.tick_mean_ms_per_step"] = 1e3 * sum(
        p.seconds for p in sp if p.name == "sched.tick") / n
    out["worker.park_ms"] = 1e3 * sum(
        p.seconds for p in sp if p.name == "worker.park")
    return out


def ttft_split(run) -> dict:
    """The window's TTFTs (due to first token, as ``ttft_p95_ms`` times
    them) split at each request's stamps, ms."""
    rows = []
    cut = spans.profile_start(run) - spans.MARGIN_S
    for s in run.sent:
        if s.due >= cut:
            continue
        r = s.req
        if r is None or not s.stamps or getattr(r, "t_prefill", None) is None:
            rows.append((math.inf, None))
            continue
        parts = {"to_submit": s.submitted - s.due,
                 "queue_wait": r.t_admit - r.t_submit,
                 "prefill_wait": r.t_prefill - r.t_admit,
                 "rest": s.stamps[0] - r.t_prefill}
        rows.append((s.stamps[0] - s.due,
                     {k: 1e3 * v for k, v in parts.items()}))
    if not rows:
        return {}
    rows.sort(key=lambda x: x[0])
    k = max(1, math.ceil(0.95 * len(rows)))
    tail = [p for _, p in rows[k - 1:] if p is not None]
    out = {"n": len(rows), "ttft_p95_ms": 1e3 * rows[k - 1][0],
           "at_p95": rows[k - 1][1]}
    if tail:
        out["tail_mean"] = {key: statistics.fmean(p[key] for p in tail)
                            for key in tail[0]}
    return out


def train_ms(run) -> dict:
    sp = recorded(run)
    return {name: [1e3 * p.seconds for p in sp if p.name == name]
            for name in ("train.data", "train.step", "train.metrics")}


def main(argv=None) -> int:
    args = parse(argv)
    cell = common.cell(args.workload)
    cfg_file = common.load_json(common.config_file(cell["config"]))
    traffic = common.load_json(common.traffic_file(cell["traffic"]))
    import torch
    if not torch.cuda.is_available():
        RUN.log("no CUDA device: the breakdown runs on the card only")
        return 2
    gen = common.generator(traffic["kind"])
    training = getattr(gen, "LOOP", None) == "train"
    if training:
        from benchlib import train as driver
    else:
        from benchlib import serve as driver
    recording = contextlib.nullcontext()
    if args.record:
        from repro_torch import obs
        recording = obs.enable()
    with recording:
        run = driver.run(cell["name"], cfg_file, traffic, gen,
                         seed=args.seed, seconds=args.seconds,
                         trace=bool(args.trace),
                         device=torch.device("cuda", 0), t_start=T_START)
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": 1, "memory_peak_bytes": int(
               torch.cuda.max_memory_allocated(torch.device("cuda", 0)))}
    rc = RUN.finish(cell["name"], driver, run, cfg_file, args.seed,
                    bool(args.trace), dev)
    out = {"cell": cell["name"], "seed": args.seed, "trace": args.trace,
           "record": args.record, "idle_ms": idle_ms(run)}
    if training:
        out["train_ms"] = train_ms(run)
    else:
        out["steps"] = steps_ms(run)
        out["ttft"] = ttft_split(run)
    print("breakdown " + json.dumps(out), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
