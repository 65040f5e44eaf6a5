"""FLOP and argument parity of the launch tooling at the reference's
tiny-mesh size (seq 32, batch 4, a 1-device mesh) for all ten archs x
{train, prefill, decode}: the port's ``hlo_analysis.analyze`` over the
step's dispatched ops against the reference's ``analyze(compiled.as_text(),
1)``, and the port's abstract arguments against the reference's
``cell.args``, leaf for leaf in shape and dtype, their bytes equal to XLA's
``argument_size_in_bytes``.  The smoke configs are f32 throughout, so no
leaf's dtype differs on purpose.

The port runs in a subprocess on a one-rank ``fake`` process group (an
xdist worker may already hold a gloo group); the reference's cells compile
in two more subprocesses beside it, each on half the archs, with
``keep_unused=True`` so that XLA's argument bytes count every argument (by
default ``jax.jit`` drops the arguments a step never reads: pixtral's
patch projection and whisper's encoder in decode).
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro_torch.configs import ALL_ARCHS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KINDS = ("train_4k", "prefill_32k", "decode_32k")

#: relative limit of the port's FLOPs against the reference's; an arch not
#: named here must match exactly.  The banded archs (mixtral-8x7b's sliding
#: window 16, recurrentgemma-2b's local window 8, both below one 32-key
#: chunk at T 32) walk the one key chunk twice: the reference's positions
#: are constants, so XLA proves both visits read the same chunk and
#: computes their score dot once, where eager computes it twice.  xlstm's
#: train cell: XLA's backward of the mLSTM chunk also differentiates the
#: carried state no output reads (one more (B·H, 32, 32) @ (32, 32) product
#: a layer), which autograd skips.
FLOP_LIMITS = {"mixtral-8x7b": 0.02, "recurrentgemma-2b": 0.01,
               "xlstm-350m": 0.025}

_PORT = textwrap.dedent("""
    import dataclasses, json, sys, torch
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.configs import SHAPES, get_smoke_config
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.hlo_analysis import analyze
    from repro_torch.launch.specs import build_cell
    from repro_torch.sharding.axes import axis_rules
    from torch.utils._pytree import tree_flatten_with_path, keystr

    fake_world(1)
    mesh = DeviceMesh("cpu", torch.arange(1).reshape(1, 1),
                      mesh_dim_names=("data", "model"))
    out = {}
    for arch in sys.argv[2].split(","):
        for kind in ("train_4k", "prefill_32k", "decode_32k"):
            shape = dataclasses.replace(SHAPES[kind], seq_len=32,
                                        global_batch=4)
            with axis_rules(mesh):
                cell = build_cell(get_smoke_config(arch), shape, mesh)
                res = analyze(cell.step, *cell.args)
            leaves, _ = tree_flatten_with_path(cell.args)
            out[f"{arch}:{kind}"] = {
                "flops": res["flops_per_device"],
                "argument_bytes": res["memory"]["argument_bytes"],
                "leaves": [[keystr(p), list(x.shape),
                            str(x.dtype).replace("torch.", "")]
                           for p, x in leaves]}
    json.dump(out, open(sys.argv[1], "w"))
    print("PORT_OK")
""")



_REF = textwrap.dedent("""
    import dataclasses, json, sys
    import jax, numpy as np
    from jax.sharding import Mesh
    from repro.configs import SHAPES, get_smoke_config
    from repro.launch.hlo_analysis import analyze
    from repro.launch.specs import build_cell
    from repro.sharding.axes import axis_rules

    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    out = {}
    for arch in sys.argv[2].split(","):
        for kind in ("train_4k", "prefill_32k", "decode_32k"):
            shape = dataclasses.replace(SHAPES[kind], seq_len=32,
                                        global_batch=4)
            with mesh, axis_rules(mesh):
                cell = build_cell(get_smoke_config(arch), shape, mesh)
                compiled = jax.jit(
                    cell.step, in_shardings=cell.in_shardings,
                    donate_argnums=cell.donate_argnums,
                    keep_unused=True).lower(*cell.args).compile()
            leaves, _ = jax.tree_util.tree_flatten_with_path(cell.args)
            out[f"{arch}:{kind}"] = {
                "flops": analyze(compiled.as_text(), 1)["flops_per_device"],
                "argument_bytes": int(
                    compiled.memory_analysis().argument_size_in_bytes),
                "leaves": [[jax.tree_util.keystr(p), list(x.shape),
                            str(np.dtype(x.dtype))] for p, x in leaves]}
    json.dump(out, open(sys.argv[1], "w"))
    print("REF_OK")
""")


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    """(port, reference) results keyed "arch:kind"; three subprocesses
    side by side."""
    tmp = tmp_path_factory.mktemp("parity")
    half = len(ALL_ARCHS) // 2
    jobs = {"port": (_PORT, ALL_ARCHS, "PORT_OK"),
            "ref0": (_REF, ALL_ARCHS[:half], "REF_OK"),
            "ref1": (_REF, ALL_ARCHS[half:], "REF_OK")}
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", code, str(tmp / f"{name}.json"),
         ",".join(archs)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")})
        for name, (code, archs, _) in jobs.items()}
    out = {}
    for name, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=600)
        assert jobs[name][2] in stdout, stdout + "\n" + stderr[-3000:]
        out.update({(name == "port", k): v for k, v in
                    json.load(open(tmp / f"{name}.json")).items()})
    return out


def _leaf_shapes(leaves) -> dict:
    """Key path -> (shape, dtype) of every leaf."""
    return {path: (tuple(shape), dtype) for path, shape, dtype in leaves}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_flops_match_the_reference(cells, arch, kind):
    port = cells[(True, f"{arch}:{kind}")]["flops"]
    ref = cells[(False, f"{arch}:{kind}")]["flops"]
    assert port > 0
    assert port == pytest.approx(ref, rel=FLOP_LIMITS.get(arch, 0.0))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_argument_tree_and_bytes_match_the_reference(cells, arch, kind):
    port = cells[(True, f"{arch}:{kind}")]
    ref = cells[(False, f"{arch}:{kind}")]
    assert _leaf_shapes(port["leaves"]) == _leaf_shapes(ref["leaves"])
    assert port["argument_bytes"] == ref["argument_bytes"]
