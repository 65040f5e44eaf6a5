"""The readings a training configuration's ``check`` limits are set
from, in one process: the program's gaps from the float32 reference on
many seeds (the lower readings), and the control's and a planted fault's
(the upper readings).

    python3 bench/train_control.py --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 3]

For each seed the cell's trainer is built from the seed and driven through
its first three steps and one more, then freed, and the reference repeats
the three steps (``train.checks``).  On the first ``--control-seeds`` seeds
two more reference runs are judged against the float32 one, as the program
is: the reference with every product in float8 e4m3 (the control), and the
reference with half of each step's microbatches left out and the mean
taken over the rest (a fault).  A step that leaves its state unchanged
reads 1 on ``change_gap`` and needs no run.  Prints one JSON line per
seed.  The benchmark's own runs do not run this."""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent / "src"))

import run as bench_run  # noqa: E402,F401  (sets the cache directories)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", type=int, default=3)
    args = p.parse_args(argv)
    import torch
    from benchlib import common, reference, train, weights
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = common.cell(args.workload)
    cfg_file = common.load_json(common.config_file(cell["config"]))
    traffic = common.load_json(common.traffic_file(cell["traffic"]))
    gen = common.generator(traffic["kind"])
    dev = torch.device("cuda", 0)
    arch, tr = cfg_file["arch"], cfg_file["train"]
    print(json.dumps({"card": torch.cuda.get_device_name(0)}), flush=True)
    for i, seed in enumerate(int(x) for x in args.seeds.split(",")):
        run = train.run(cell["name"], cfg_file, traffic, gen, seed=seed,
                        seconds=0.0, trace=False, device=dev,
                        t_start=time.monotonic())
        c = train.checks(run, seed, cfg_file)
        out = {"seed": seed, "program": {k: v for k, (v, _) in c.items()},
               "first_step_s": run.first_step_s,
               "reference_s": run.reference_s,
               "losses": run.losses[:4], "ref_losses": run.ref["losses"]}
        if i < args.control_seeds:
            params0 = weights.make_params(arch, seed, dev, dtype=torch.float32)
            batches = [gen.batch_at(traffic, seed, k, arch["vocab_size"])
                       for k in range(3)]
            for name, kw in (("control_fp8", {"quant": "fp8"}),
                             ("fault_half_batch",
                              {"used_microbatches": tr["microbatches"] // 2})):
                low = reference.train_steps(
                    arch, params0, batches, tr["adamw"],
                    eps=cfg_file["norm_eps"],
                    microbatches=tr["microbatches"], **kw)
                out[name] = train.compare(low, run.ref)
            del params0
        print(json.dumps(out), flush=True)
        del run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
