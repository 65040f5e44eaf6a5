"""Run one cell of the benchmark of ``repro_torch`` on this machine's card.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``workloads`` in ``BENCHMARK.json``; its
configuration and traffic mix are found by name under ``bench/configs``
and ``bench/traffic``.  Set-up (weights from the seed, the engine or
trainer at the configuration's deployment, the warm-up) counts in
``setup_s``; then the window measures for ``--seconds``.  With
``--trace 0`` the last line of standard output holds the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics and the
device's busy time over a profiled sub-window.  The numbers that decide
``correct`` are printed beside their limits, last on standard error and
under ``checks`` at the end of the result.

Without a CUDA card (or with fewer than the cell asks for), without the
port's sources, or if JAX or the JAX package was imported, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(ROOT / "src"))

# every build and kernel cache at a fixed place inside the checkout; the
# port's own CUDA build goes to src/repro_torch/kernels/_build
_CACHE = ROOT / ".bench_cache"
os.environ["TRITON_CACHE_DIR"] = str(_CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(_CACHE / "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = str(_CACHE / "nv")
os.environ["USE_FLAX"] = "0"


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def read_metrics(cell_name: str, run, trace: bool) -> dict:
    from benchlib import common
    kind, folder = (("per_layer", "metrics") if trace
                    else ("end_to_end", "e2e"))
    out = {}
    for m in common.metrics_of(cell_name, kind):
        value = common.reader(folder, m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    args = parse(argv)
    from benchlib import common
    try:
        cell = common.cell(args.workload)
        cfg_file = common.load_json(common.config_file(cell["config"]))
        traffic = common.load_json(common.traffic_file(cell["traffic"]))
    except (OSError, KeyError, ValueError) as e:
        log(f"cannot read cell {args.workload!r}: {e!r}")
        return 2
    import torch
    if not torch.cuda.is_available():
        log("no CUDA device: the benchmark runs on the card only")
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        log(f"{cell['name']} needs {cell['chips']} cards, "
            f"{torch.cuda.device_count()} present")
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        log(f"the system under test (repro_torch, under src/) is missing: {e}")
        return 2
    gen = common.generator(traffic["kind"])
    device = torch.device("cuda", 0)
    if getattr(gen, "LOOP", None) == "train":
        from benchlib import train as driver
    else:
        from benchlib import serve as driver
    run = driver.run(cell["name"], cfg_file, traffic, gen, seed=args.seed,
                     seconds=args.seconds, trace=bool(args.trace),
                     device=device, t_start=T_START)
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": 1,
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}
    return finish(cell["name"], driver, run, cfg_file, args.seed,
                  bool(args.trace), dev)


def finish(cell_name: str, driver, run, cfg_file: dict, seed: int,
           trace: bool, dev: dict) -> int:
    """Judge the run, read its metrics and print its result line; exit
    code 0.  Where JAX or the JAX package is in ``sys.modules``, before
    the checks or after everything that runs once the window has closed
    (the reference, the metric readers, the trace), print no result."""
    from benchlib import common
    if refuse_forbidden(common):
        return 3
    for line in driver.report(run):
        log(line)
    checks = driver.checks(run, seed, cfg_file)
    correct = driver.is_correct(checks)
    metrics = read_metrics(cell_name, run, trace)
    result = {"correct": bool(correct), "attempted": driver.attempted(run),
              "failed": driver.n_failed(run), "metrics": metrics,
              "device": dev}
    if trace:
        from benchlib.layers import trace as trace_of
        tr = trace_of(run)
        if tr is None or tr.busy_s <= 0:
            log("the profiled sub-window holds no device time")
            return 4
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        result["breakdown"] = tr.breakdown()
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    log(f"reference {getattr(run, 'reference_s', 0.0):.3f} s")
    for k, (v, lim) in checks.items():
        log(f"check {k}: {v} (limit {lim})")
    if refuse_forbidden(common):
        return 3
    print(json.dumps(result), flush=True)
    return 0


def refuse_forbidden(common) -> bool:
    bad = common.forbidden_modules()
    if bad:
        log("JAX or the JAX package was imported: " + ", ".join(bad))
    return bool(bad)

if __name__ == "__main__":
    sys.exit(main())
