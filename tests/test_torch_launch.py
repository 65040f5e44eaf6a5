"""The port's launch tooling (``repro_torch.launch.{specs,dryrun,
hlo_analysis,roofline,report}``), held against ``repro.launch``.

* the dispatched-op analysis: a Python loop of 10 matmuls and a 5 x 3
  nested loop count every trip exactly (ports of
  ``test_sharding_launch.py``'s loop tests); ``models.loops.counted_range``
  on meta tensors counts what the full loop counts on the CPU, forward and
  backward, in a microbatched train step too;
* the roofline on H100 constants, the ring model's wire bytes, and
  ``model_flops`` equal to the reference's for all ten archs x four shapes;
* cells on fake process groups, in a subprocess of their own (an xdist
  worker may already hold a gloo group): ``build_cell`` for train, prefill
  and decode on a 1x1 mesh; per-device argument bytes on a (2, 2) mesh
  against the reference's shard shapes on a (2, 2) JAX mesh of 4 forced
  host devices (its own subprocess) for all ten archs x three kinds; a
  cell with its weights sharded on "model" counts half the 1x1 FLOPs (a
  count of the global ops would not); the train cell on (2, 2) counts
  collectives;
* the CLI: a resumable ``--out`` that skips done cells, ``long_500k``
  skipped with the reference's reason, and the report's tables.

FLOP and argument-tree parity at smoke size on one device is in
``test_torch_launch_parity.py``; serving steps with real values on a
(2, 2) gloo mesh in ``test_torch_mesh_decode.py``.
"""

import json
import os
import re
import subprocess
import sys
import textwrap

import pytest
import torch

from repro.configs import ALL_ARCHS as REF_ARCHS
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_config
from repro.launch import roofline as ref_roofline
from repro_torch.configs import ALL_ARCHS, SHAPES, get_config, get_smoke_config
from repro_torch.launch import roofline
from repro_torch.launch.hlo_analysis import analyze
from repro_torch.models import build_model
from repro_torch.models.loops import counted_range
from repro_torch.train import AdamWConfig
from repro_torch.train.optim import adamw_init
from repro_torch.train.trainer import make_train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
KINDS = ("train_4k", "prefill_32k", "decode_32k")
B, T = 4, 32  # the reference's tiny-mesh cell size


def _env():
    return {**os.environ, "PYTHONPATH": SRC}


# the port on a fake world of 4 ranks: cells on (1, 1), (1, 2) and (2, 2)
_PORT = textwrap.dedent("""
    import dataclasses, json, sys, torch
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.configs import ALL_ARCHS, SHAPES, get_smoke_config
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.hlo_analysis import analyze, argument_bytes
    from repro_torch.launch.specs import build_cell
    from repro_torch.sharding.axes import axis_rules

    fake_world(4)
    names = ("data", "model")
    meshes = {s: DeviceMesh("cpu", torch.arange(s[0] * s[1]).reshape(s),
                            mesh_dim_names=names)
              for s in ((1, 1), (1, 2), (2, 2))}
    res = {"args22": {}, "one": {}}

    def cell(arch, kind, mesh):
        shape = dataclasses.replace(SHAPES[kind], seq_len=32, global_batch=4)
        return build_cell(get_smoke_config(arch), shape, mesh)

    for arch in ALL_ARCHS:
        for kind in ("train_4k", "prefill_32k", "decode_32k"):
            with axis_rules(meshes[(2, 2)]):
                c = cell(arch, kind, meshes[(2, 2)])
            res["args22"][f"{arch}:{kind}"] = argument_bytes(*c.args)
    for kind in ("train_4k", "prefill_32k", "decode_32k"):
        with axis_rules(meshes[(1, 1)]):
            c = cell("stablelm-3b", kind, meshes[(1, 1)])
            res["one"][kind] = analyze(c.step, *c.args)
    for s in ((1, 1), (1, 2)):
        with axis_rules(meshes[s]):
            c = cell("stablelm-3b", "prefill_32k", meshes[s])
            res[f"prefill{s[0]}x{s[1]}"] = analyze(c.step, *c.args)
    with axis_rules(meshes[(2, 2)]):
        c = cell("stablelm-3b", "train_4k", meshes[(2, 2)])
        res["train22"] = analyze(c.step, *c.args)
    json.dump(res, open(sys.argv[1], "w"))
    print("PORT_OK")
""")

# the reference's per-device argument bytes on a (2, 2) mesh of 4 forced
# host devices: each argument's shard shape under its in_sharding
_JAX4 = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses, json, math, sys
    import jax, numpy as np
    from jax.sharding import Mesh
    from repro.configs import ALL_ARCHS, SHAPES, get_smoke_config
    from repro.launch.specs import build_cell
    from repro.sharding.axes import axis_rules

    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    out = {}
    for arch in ALL_ARCHS:
        for kind in ("train_4k", "prefill_32k", "decode_32k"):
            shape = dataclasses.replace(SHAPES[kind], seq_len=32,
                                        global_batch=4)
            with mesh, axis_rules(mesh):
                c = build_cell(get_smoke_config(arch), shape, mesh)
            total = 0
            for a, s in zip(jax.tree.leaves(c.args),
                            jax.tree.leaves(c.in_shardings)):
                total += (math.prod(s.shard_shape(a.shape))
                          * np.dtype(a.dtype).itemsize)
            out[f"{arch}:{kind}"] = total
    json.dump(out, open(sys.argv[1], "w"))
    print("JAX4_OK")
""")


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    """Both subprocesses, run side by side."""
    tmp = tmp_path_factory.mktemp("launch")
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", code, str(tmp / f"{name}.json")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env(), cwd=ROOT) for name, code in (("port", _PORT),
                                                  ("jax4", _JAX4))}
    out = {}
    for name, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=300)
        assert f"{name.upper()}_OK" in stdout, stdout + "\n" + stderr[-3000:]
        out[name] = json.load(open(tmp / f"{name}.json"))
    return out


# ============================================================ the analysis
def _meta(*shape):
    return torch.empty(shape, device="meta")


def test_python_loop_counts_every_trip():
    def f(x, w):
        for _ in range(10):
            x = torch.tanh(x @ w)
        return x

    res = analyze(f, _meta(64, 64), _meta(64, 64))
    assert res["flops_per_device"] == 2 * 64 ** 3 * 10


def test_nested_loops_count_every_trip():
    def f(x, w):
        for _ in range(5):
            for _ in range(3):
                x = torch.tanh(x @ w)
        return x

    res = analyze(f, _meta(32, 32), _meta(32, 32))
    assert res["flops_per_device"] == 2 * 32 ** 3 * 15


def _recurrence(h, w, xs):
    """h_t = tanh(h_{t-1} @ w + x_t) over xs' rows, then the mean of the
    states; forward and backward."""
    outs = []
    for i in counted_range(xs.shape[0], xs):
        h = torch.tanh(h @ w + xs[i])
        outs.append(h)
    outs += outs[-1:] * (xs.shape[0] - len(outs))
    torch.stack(outs).mean().backward()


@pytest.mark.parametrize("trips", [2, 3, 17])
def test_counted_range_on_meta_counts_the_full_loop(trips):
    """Two trips on meta tensors stand for all of them, gradients too:
    the FLOPs of every trip run on the CPU."""
    def run(dev):
        w = torch.zeros(16, 16, device=dev, requires_grad=True)
        xs = torch.zeros(trips, 8, 16, device=dev, requires_grad=True)
        return analyze(_recurrence, torch.zeros(8, 16, device=dev), w, xs)

    meta, cpu = run("meta"), run("cpu")
    assert meta["flops_per_device"] == cpu["flops_per_device"] > 0
    # bytes: the gradient of a leaf every trip reads (w, xs) accumulates
    # twice on meta tensors, once a trip on the CPU
    assert meta["bytes_per_device"] <= cpu["bytes_per_device"]


@pytest.mark.parametrize("arch", ["stablelm-3b", "xlstm-350m"])
def test_microbatched_train_step_on_meta_counts_every_microbatch(arch):
    """4 microbatches (two run on meta tensors) and, in xlstm, the sLSTM's
    steps: the meta FLOPs equal the CPU's; bytes within 10% below (a
    leaf's gradient accumulates once a trip on the CPU, twice on meta)."""
    cfg = get_smoke_config(arch).scaled(num_microbatches=4)
    model = build_model(cfg)
    step = make_train_step(model, AdamWConfig())

    def counts(dev):
        if dev == "meta":
            params = model.abstract_params(master=True)
        else:
            params = model.init(torch.Generator().manual_seed(0),
                                device=dev, master=True)
        state = {"params": params, "opt": adamw_init(params)}
        toks = torch.zeros((B, T), dtype=torch.int32, device=dev)
        res = analyze(step, state, {"tokens": toks, "labels": toks})
        return res["flops_per_device"], res["bytes_per_device"]

    (flops, nbytes), (cpu_flops, cpu_bytes) = counts("meta"), counts("cpu")
    assert flops == cpu_flops
    if arch == "stablelm-3b":  # no loop inside a microbatch at T 32
        assert nbytes == cpu_bytes
    else:  # the sLSTM's recurrent weights' gradient accumulates twice
        assert 0.9 * cpu_bytes <= nbytes <= cpu_bytes


# ============================================================ the roofline
def test_roofline_terms_and_dominance_on_h100_constants():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == (
        989e12, 3.35e12, 450e9)
    coll = {"all-reduce": {"wire_bytes": 450e9}}  # 1 s at link bw
    terms = roofline.roofline_terms(989e12 * 2, 3.35e12 * 0.5, coll)
    assert terms["compute_s"] == pytest.approx(2.0)
    assert terms["memory_s"] == pytest.approx(0.5)
    assert terms["collective_s"] == pytest.approx(1.0)
    assert roofline.dominant_term(terms) == "compute_s"


@pytest.mark.parametrize("kind,want", [
    ("all-reduce", 2 * 1024 * 3 / 4), ("all-gather", 1024 * 3 / 4),
    ("reduce-scatter", 1024 * 3 / 4), ("all-to-all", 1024 * 3 / 4),
    ("collective-permute", 1024)])
def test_wire_bytes_ring_model(kind, want):
    """The reference's ring formulas (``roofline.py:104-109``)."""
    assert roofline.wire_bytes(kind, 1024, 4) == want


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_model_flops_match_the_reference(arch):
    assert ALL_ARCHS == REF_ARCHS
    cfg, ref = get_config(arch), ref_config(arch)
    n = cfg.active_param_count() if cfg.is_moe else None
    n_ref = ref.active_param_count() if ref.is_moe else None
    for name in SHAPES:
        assert roofline.model_flops(cfg, SHAPES[name], n) == \
            ref_roofline.model_flops(ref, REF_SHAPES[name], n_ref)


def test_launch_holds_no_tpu_constant():
    """The v5e figures (197 TFLOP/s, 819 GB/s, 50 GB/s links) stay in the
    reference."""
    for name in ("specs", "dryrun", "hlo_analysis", "roofline", "report"):
        text = open(os.path.join(SRC, "repro_torch", "launch",
                                 f"{name}.py")).read()
        for const in ("197e12", "819e9", "50e9", "v5e", "TPU"):
            assert not re.search(rf"(?<![\w.]){const}", text), (name, const)


# ============================================================ cells
@pytest.mark.parametrize("kind", KINDS)
def test_build_cell_runs_on_a_one_device_mesh(cells, kind):
    res = cells["port"]["one"][kind]
    assert res["flops_per_device"] > 0
    assert res["memory"]["peak_bytes"] >= res["memory"]["argument_bytes"] > 0
    assert sum(r["count"] for r in res["collectives"].values()) == 0


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_argument_bytes_per_device_on_2x2_match_the_reference(cells, arch):
    for kind in KINDS:
        key = f"{arch}:{kind}"
        assert cells["port"]["args22"][key] == cells["jax4"][key], key


def test_weights_sharded_on_model_halve_the_flops(cells):
    """stablelm-3b's prefill on a (1, 2) mesh: every matmul weight shards
    on "model", so each device does half the 1x1 work; a count of the
    global-shape ops DTensor sees would report the 1x1 figure."""
    one = cells["port"]["prefill1x1"]["flops_per_device"]
    two = cells["port"]["prefill1x2"]["flops_per_device"]
    assert two == one / 2


def test_train_cell_on_2x2_counts_collectives(cells):
    coll = cells["port"]["train22"]["collectives"]
    assert sum(r["count"] for r in coll.values()) > 0
    assert sum(r["wire_bytes"] for r in coll.values()) > 0
    # per device: a quarter of the 1x1 step's FLOPs (batch and weights
    # both split in two)
    assert cells["port"]["train22"]["flops_per_device"] == \
        cells["port"]["one"]["train_4k"]["flops_per_device"] / 4


# ============================================================ the CLI
def test_dryrun_cli_resumes_skips_long_context_and_reports(tmp_path):
    out = tmp_path / "dryrun.jsonl"
    argv = [sys.executable, "-m", "repro_torch.launch.dryrun", "--cells",
            "stablelm-3b:decode_32k,whisper-small:long_500k", "--mesh",
            "single", "--out", str(out)]
    first = subprocess.run(argv, capture_output=True, text=True, env=_env(),
                           cwd=ROOT, timeout=300)
    assert first.returncode == 0, first.stdout + first.stderr[-3000:]
    rows = [json.loads(line) for line in open(out)]
    by_arch = {r["arch"]: r for r in rows}
    assert by_arch["stablelm-3b"]["status"] == "ok"
    assert by_arch["stablelm-3b"]["attention"] == "plain route (meta)"
    assert by_arch["stablelm-3b"]["n_devices"] == 256
    skipped = by_arch["whisper-small"]
    assert skipped["status"] == "skipped"
    assert skipped["reason"] == ("long_500k needs sub-quadratic attention; "
                                 "whisper-small is full-attention "
                                 "(DESIGN.md §4)")
    again = subprocess.run(argv, capture_output=True, text=True, env=_env(),
                           cwd=ROOT, timeout=300)
    assert again.returncode == 0
    assert again.stdout.count(": skipped") == 2, again.stdout
    assert len(open(out).readlines()) == 2
    report = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.report", str(out)],
        capture_output=True, text=True, env=_env(), cwd=ROOT, timeout=120)
    assert report.returncode == 0, report.stderr
    assert "1 ok / 1 skipped / 0 failed" in report.stdout
    assert "| stablelm-3b | decode_32k | 16x16 | ok |" in report.stdout
    assert "| stablelm-3b | decode_32k | " in report.stdout.split(
        "### Roofline")[1]
