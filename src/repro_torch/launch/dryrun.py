"""Multi-pod dry run (``repro.launch.dryrun``): build and run every
(arch x shape x mesh) cell on meta tensors, and count what each device
would do.

For each cell, ``specs.build_cell`` lays the abstract arguments out as meta
DTensors on the production mesh, (16, 16) single-pod or (2, 16, 16)
multi-pod, of a ``fake`` process group of 512 ranks that this process
opens where none is open (the counterpart of the reference's
``--xla_force_host_platform_device_count=512``); then
``hlo_analysis.analyze`` runs the step once and counts rank 0's local
ops.  Nothing is allocated and no kernel runs, so the dry run needs no
card.  Success shows that the layouts are coherent: every op finds a
sharding, every redistribution a collective, and the counts give the
per-device footprint, FLOPs, bytes and collectives that feed
``roofline``.

Attention takes the plain chunked route on meta tensors
(``models.attention.flash_route`` sends every call there, as the device
type is ``meta``).  That is the algorithm the reference's dry run lowers,
which never reaches a Pallas kernel either, so the counts are of the
reference's algorithm; each record says so (``"attention"``).

The production meshes are ``launch.mesh.make_production_mesh``'s CUDA
meshes: a CUDA ``DeviceMesh`` opens over the fake group on a host without
a card, and the meta arguments never touch it.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-7b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --cells all \\
      --mesh both --out results/dryrun.jsonl   # resumable
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Optional

from repro_torch.configs import ALL_ARCHS, SHAPES, cell_is_runnable, get_config
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import (dominant_term, mfu_fraction,
                                         model_flops, roofline_terms)

WORLD = 512  # ranks of the fake world: the multi-pod mesh's devices
ATTENTION = "plain route (meta)"


def fake_world(size: int = WORLD) -> None:
    """Open a ``fake`` process group of ``size`` ranks (this process rank
    0) where none is open: collectives return at once and move nothing."""
    import torch.distributed as dist

    if not dist.is_initialized():
        # importing it registers torch's ``fake`` backend
        from torch.testing._internal.distributed.fake_pg import FakeStore

        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=size)


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             *, verbose: bool = True, flags: Optional[dict] = None,
             shape=None, mesh=None) -> dict:
    """One cell's record.  ``shape`` (a ``ShapeSpec``) and ``mesh`` (a
    ``DeviceMesh``) replace ``SHAPES[shape_name]`` and the production
    mesh where given."""
    from repro_torch.models import perf_flags

    shape = shape or SHAPES[shape_name]
    rec = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "kind": shape.kind, "status": "skipped",
        "flags": {k: v for k, v in (flags or {}).items() if v},
    }
    if mesh is not None:
        rec["mesh"] = "x".join(map(str, mesh.shape))
    prev = perf_flags.set_flags(**(flags or {}))
    try:
        return _run_cell_inner(get_config(arch), shape, multi_pod, rec,
                               mesh, verbose)
    finally:
        perf_flags.set_flags(**prev)


def _run_cell_inner(cfg, shape, multi_pod, rec, mesh, verbose) -> dict:
    from repro_torch.launch.hlo_analysis import analyze
    from repro_torch.launch.specs import build_cell
    from repro_torch.sharding.axes import axis_rules

    arch = rec["arch"]
    if not cell_is_runnable(cfg, shape):
        rec["reason"] = ("long_500k needs sub-quadratic attention; "
                         f"{arch} is full-attention (DESIGN.md §4)")
        return rec

    if mesh is None:
        fake_world()
        mesh = make_production_mesh(multi_pod=multi_pod)
    n_dev = mesh.size()
    t0 = time.time()
    try:
        with axis_rules(mesh):
            cell = build_cell(cfg, shape, mesh)
            prof = analyze(cell.step, *cell.args)
    except Exception as e:  # noqa: BLE001 — report, don't crash the sweep
        rec.update(status="FAILED", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc(limit=8))
        return rec

    rec.update(status="ok", analyze_s=round(time.time() - t0, 1),
               n_devices=n_dev, attention=ATTENTION,
               description=cell.description, memory=prof["memory"])
    flops = prof["flops_per_device"]
    coll = prof["collectives"]
    rec["cost"] = {"flops_per_device": flops,
                   "bytes_per_device": prof["bytes_per_device"]}
    rec["collectives"] = coll
    terms = roofline_terms(flops, prof["bytes_per_device"], coll)
    rec["roofline"] = terms
    rec["roofline"]["dominant"] = dominant_term(terms)
    n_active = cfg.active_param_count() if cfg.is_moe else None
    mfl = model_flops(cfg, shape, n_active)
    rec["roofline"].update(model_flops=mfl,
                           **mfu_fraction(mfl, flops, n_dev, terms))
    if verbose:
        _print_cell(rec)
    return rec


def _print_cell(rec: dict) -> None:
    print(f"== {rec['arch']} × {rec['shape']} on {rec['mesh']} "
          f"[{rec['status']}] ==")
    if rec["status"] != "ok":
        print("   ", rec.get("reason") or rec.get("error"))
        return
    mem = rec["memory"]
    print(f"   per-device: args {mem['argument_bytes']/2**30:.2f} GiB, "
          f"peak {mem['peak_bytes']/2**30:.2f} GiB")
    ro = rec["roofline"]
    print(f"   roofline (H100, analytic): compute {ro['compute_s']*1e3:.2f} "
          f"ms | memory {ro['memory_s']*1e3:.2f} ms | "
          f"collective {ro['collective_s']*1e3:.2f} ms "
          f"-> {ro['dominant']}  "
          f"(roofline fraction {ro.get('roofline_fraction', 0):.3f})")
    print(f"   analyze {rec['analyze_s']}s", flush=True)


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ALL_ARCHS)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--cells", default=None,
                    help="'all' or comma list arch:shape")
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="single")
    ap.add_argument("--out", default=None, help="JSONL output (resumable)")
    ap.add_argument("--opt", default=None,
                    help="comma list of perf flags to enable, or 'all'")
    args = ap.parse_args(argv)

    from repro_torch.models.perf_flags import FLAGS as _ALL_FLAGS
    flags = {}
    if args.opt == "all":
        flags = {k: True for k in _ALL_FLAGS}
    elif args.opt:
        flags = {k: True for k in args.opt.split(",")}

    cells = []
    if args.cells == "all":
        for a in ALL_ARCHS:
            for s in SHAPES:
                cells.append((a, s))
    elif args.cells:
        for item in args.cells.split(","):
            a, s = item.split(":")
            cells.append((a, s))
    else:
        assert args.arch and args.shape, "--arch/--shape or --cells required"
        cells = [(args.arch, args.shape)]

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    done = set()
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        if os.path.exists(args.out):
            with open(args.out) as f:
                for line in f:
                    r = json.loads(line)
                    if r.get("status") in ("ok", "skipped"):
                        done.add((r["arch"], r["shape"], r["mesh"]))

    failures = 0
    for a, s in cells:
        for mp in meshes:
            mesh_name = "2x16x16" if mp else "16x16"
            if (a, s, mesh_name) in done:
                print(f"done {a} × {s} on {mesh_name}: skipped")
                continue
            rec = run_cell(a, s, mp, flags=flags)
            failures += rec["status"] == "FAILED"
            if rec["status"] == "FAILED":
                print(f"FAILED {a} × {s} on {mesh_name}: {rec['error']}")
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
