"""A/B of the era scan between this checkout and another source tree, on
one CUDA card, in one call.

Run from the repository root, with the other tree (a parent commit, say)
unpacked into a directory that ``.gitignore`` lists:

    mkdir -p .archive/parent
    git archive <parent> | tar -x -C .archive/parent
    python3 tools/era_scan_ab.py .archive/parent/src

Each run is a fresh process that imports ``repro_torch`` from one tree,
builds its kernels and runs ``chip_smoke.check_era_scan`` (kernel, plain
version and ``cuda`` backend bitwise against NumPy; eager, graph-replay
and pool-call times; both bounds) on the same seeded inputs, made by this
checkout's ``tests/torch_era_cases.py``: chip_smoke's shapes, and both
sides of the kernel's row-tile threshold (R 33791 and 33792, S 5120, 50%
valid).  The runs go other, this, this, other, so drift in the card's
clocks falls on both trees alike.  Each run ends on one JSON line; the
last line sums them up, and the exit code is non-zero if any run failed.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

#: both sides of the row-tile threshold (``kWideRows`` in csrc/era_scan.cu)
TILE_SHAPES = ((33791, 5120, 0.5), (33792, 5120, 0.5))


def run(src: str) -> int:
    """One tree's era-scan rows, printed as one JSON line."""
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs  # puts this checkout's src/ on sys.path

    sys.path.insert(0, str(Path(src).resolve()))  # ahead of this checkout's
    sys.path.insert(0, str(ROOT / "tests"))
    import repro_torch
    from repro_torch.kernels import build
    from torch_era_cases import sample_case

    if not torch.cuda.is_available():
        print("era_scan_ab: no CUDA device", file=sys.stderr)
        return 2
    build.build()
    dev = torch.device("cuda")
    rows = []
    for r, s, v in cs.ERA_SHAPES + TILE_SHAPES:
        row = cs.check_era_scan(sample_case(r, s, v, seed=cs.SEED), dev)
        rows.append(dict(case=f"R {r} S {s}, {v:.0%} valid slots", **row))
    print(json.dumps({"src": str(Path(repro_torch.__file__).parent),
                      "rows": rows}), flush=True)
    return 1 if cs.FAILED else 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="the other tree's src/ directory")
    ap.add_argument("--run", action="store_true",
                    help="time the tree given alone (one run of the A/B)")
    args = ap.parse_args()
    if args.run:
        return run(args.other)
    this = str(ROOT / "src")
    order = [("other", args.other), ("this", this), ("this", this),
             ("other", args.other)]
    runs, failed = [], []
    for name, src in order:
        proc = subprocess.run([sys.executable, __file__, src, "--run"],
                              stdout=subprocess.PIPE, text=True)
        print(proc.stdout, end="", flush=True)
        lines = proc.stdout.strip().splitlines()
        if proc.returncode != 0 or not lines:
            failed.append(name)
            continue
        runs.append((name, json.loads(lines[-1])["rows"]))
    summary = {}
    for name, rows in runs:
        for row in rows:
            cell = summary.setdefault(row["case"], {})
            for key in ("ms", "device_ms", "pool_ms"):
                cell.setdefault(f"{name}_{key}", []).append(row[key])
            cell["bound_ms"] = row["bound_ms"]
    print(json.dumps({"era_scan_ab": summary, "failed": failed}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
