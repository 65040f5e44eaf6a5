"""The dry run's counts against the reference's compiled XLA program, cell
by cell, on the CPU.

Run from the repository root (needs JAX and the reference package, as the
tests do; no card):

    PYTHONPATH=src python3 tools/dryrun_vs_xla.py

Every (arch x kind) cell at the reference's tiny-mesh size (seq 32, batch
4, a 1-device mesh, as ``tests/test_torch_launch_*.py`` hold them): the
port's ``hlo_analysis.analyze`` over the step's dispatched ops on meta
tensors, against ``repro.launch.hlo_analysis.analyze`` of the compiled
cell.  It prints a markdown table of FLOPs and bytes per device, each with
the port / XLA ratio.  The FLOPs are the tests' parity; the bytes differ
by design: eager runs every op on its own and charges its operands and
output, where XLA charges each fused instruction's output twice.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import torch
from jax.sharding import Mesh
from torch.distributed.device_mesh import DeviceMesh

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_smoke_config as ref_smoke_config
from repro.launch.hlo_analysis import analyze as ref_analyze
from repro.launch.specs import build_cell as ref_build_cell
from repro.sharding.axes import axis_rules as ref_axis_rules
from repro_torch.configs import ALL_ARCHS, SHAPES, get_smoke_config
from repro_torch.launch.dryrun import fake_world
from repro_torch.launch.hlo_analysis import analyze
from repro_torch.launch.specs import build_cell
from repro_torch.sharding.axes import axis_rules

KINDS = ("train_4k", "prefill_32k", "decode_32k")
B, T = 4, 32


def port_counts(arch: str, kind: str, mesh) -> tuple:
    shape = dataclasses.replace(SHAPES[kind], seq_len=T, global_batch=B)
    with axis_rules(mesh):
        cell = build_cell(get_smoke_config(arch), shape, mesh)
        res = analyze(cell.step, *cell.args)
    return res["flops_per_device"], res["bytes_per_device"]


def xla_counts(arch: str, kind: str, mesh) -> tuple:
    shape = dataclasses.replace(REF_SHAPES[kind], seq_len=T, global_batch=B)
    with mesh, ref_axis_rules(mesh):
        cell = ref_build_cell(ref_smoke_config(arch), shape, mesh)
        compiled = jax.jit(cell.step, in_shardings=cell.in_shardings,
                           donate_argnums=cell.donate_argnums).lower(
                               *cell.args).compile()
    res = ref_analyze(compiled.as_text(), 1)
    return res["flops_per_device"], res["bytes_per_device"]


def main() -> int:
    fake_world(1)
    mesh = DeviceMesh("cpu", torch.arange(1).reshape(1, 1),
                      mesh_dim_names=("data", "model"))
    jmesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                 ("data", "model"))
    print("| arch | kind | FLOPs port | FLOPs XLA | ratio | bytes port | "
          "bytes XLA | ratio |")
    print("|---|---|---|---|---|---|---|---|")
    for arch in ALL_ARCHS:
        for kind in KINDS:
            fp, bp = port_counts(arch, kind, mesh)
            fx, bx = xla_counts(arch, kind, jmesh)
            print(f"| {arch} | {kind} | {fp:.0f} | {fx:.0f} | "
                  f"{fp / fx:.4f} | {bp:.0f} | {bx:.0f} | {bp / bx:.2f} |",
                  flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
