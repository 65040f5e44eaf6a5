"""Render a dry run's JSONL (``launch.dryrun --out``) into tables
(``repro.launch.report``).  The roofline figures are analytic, from the
H100 constants of ``launch.roofline``.

  PYTHONPATH=src python -m repro_torch.launch.report results/dryrun.jsonl
"""

from __future__ import annotations

import json
import sys
from typing import Dict, List


def load(path: str) -> List[Dict]:
    rows = []
    with open(path) as f:
        for line in f:
            rows.append(json.loads(line))
    # keep the latest record per cell
    latest = {}
    for r in rows:
        latest[(r["arch"], r["shape"], r["mesh"])] = r
    return list(latest.values())


def fmt_bytes(b) -> str:
    return f"{b/2**30:.2f}"


def dryrun_table(rows: List[Dict]) -> str:
    """The reference's table, with the analysis's wall time in place of
    its lower and compile times."""
    out = ["| arch | shape | mesh | status | live GiB/dev | analyze s |",
           "|---|---|---|---|---|---|"]
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"], r["mesh"])):
        if r["status"] == "ok":
            live = fmt_bytes(r["memory"].get("live_bytes_per_device", 0))
            out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | ok | "
                       f"{live} | {r['analyze_s']} |")
        else:
            why = r.get("reason", r.get("error", ""))[:60]
            out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                       f"{r['status']} | — | {why} |")
    return "\n".join(out)


def roofline_table(rows: List[Dict]) -> str:
    out = ["| arch | shape | compute s | memory s | collective s | "
           "dominant | MODEL_FLOPS | useful ratio | roofline frac |",
           "|---|---|---|---|---|---|---|---|---|"]
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"])):
        if r["status"] != "ok" or r["mesh"] != "16x16":
            continue
        ro = r.get("roofline", {})
        if "compute_s" not in ro:
            continue
        out.append(
            f"| {r['arch']} | {r['shape']} | {ro['compute_s']:.3f} | "
            f"{ro['memory_s']:.3f} | {ro['collective_s']:.3f} | "
            f"{ro['dominant'].replace('_s', '')} | "
            f"{ro.get('model_flops', 0):.2e} | "
            f"{ro.get('useful_flops_ratio', 0):.3f} | "
            f"{ro.get('roofline_fraction', 0):.4f} |")
    return "\n".join(out)


def pick_hillclimb_cells(rows: List[Dict]) -> List[Dict]:
    ok = [r for r in rows if r["status"] == "ok" and r["mesh"] == "16x16"
          and "roofline" in r and "compute_s" in r["roofline"]]
    worst_frac = min(ok, key=lambda r: r["roofline"].get(
        "roofline_fraction", 1))
    most_coll = max(ok, key=lambda r: r["roofline"]["collective_s"]
                    / max(r["roofline"]["compute_s"], 1e-9))
    return [worst_frac, most_coll]


def main(argv=None) -> int:
    path = (argv or sys.argv[1:])[0] if (argv or sys.argv[1:]) \
        else "results/dryrun.jsonl"
    rows = load(path)
    n_ok = sum(r["status"] == "ok" for r in rows)
    n_skip = sum(r["status"] == "skipped" for r in rows)
    n_fail = len(rows) - n_ok - n_skip
    print(f"## Dry-run summary: {n_ok} ok / {n_skip} skipped / "
          f"{n_fail} failed (of {len(rows)} cells)\n")
    print("### Dry-run table\n")
    print(dryrun_table(rows))
    print("\n### Roofline (single-pod 16x16, H100 constants)\n")
    print(roofline_table(rows))
    picks = pick_hillclimb_cells(rows)
    print("\n### Suggested hillclimb cells")
    for p in picks:
        print(f"- {p['arch']} × {p['shape']} "
              f"(dominant {p['roofline']['dominant']}, fraction "
              f"{p['roofline'].get('roofline_fraction', 0):.4f})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
