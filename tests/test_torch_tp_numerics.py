"""Tensor-parallel numerics of the port's products in bf16, held against
``repro``: where a contraction's partial sums cross the mesh, they are
summed in f32 and rounded once, unless ``bf16_collective_matmul`` is on.

Three subprocesses run side by side:

* four gloo ranks on a (2, 2) ("data", "model") mesh
  (``tests/torch_tp_worker.py``): a row-parallel ``layers.matmul``, the
  input gradient of a column-parallel one and the MoE expert product (its
  output and weight gradient), with the flag off and on, beside the same
  products as DTensor computes them alone (bf16 partials) and the
  one-device port;
* the reference on 4 forced host devices: ``repro.models.layers.matmul``
  and the MoE expert einsum (``repro/models/moe.py:156``, with its
  ``preferred_element_type``; its bf16 values enter as f32, as the CPU
  backend runs no batched bf16 dot with f32 output) jitted under the same
  layouts, and the
  reference's bf16 train step of stablelm-3b's smoke config as its
  ``launch.specs`` cell on a (2, 2) mesh, compiled with the flag off and
  on: the element type of every all-reduce that sums a ``dot``'s output,
  counted with the trip counts of the loops around it, read from the
  program right after SPMD partitioning (the CPU backend's later
  ``all-reduce-promotion`` pass turns every bf16 all-reduce into f32, so
  ``compiled.as_text()`` shows f32 in both settings);
* the port's op analysis (``launch.hlo_analysis``) of the same cell on a
  fake 4-rank world: ``product_dtypes`` of its all-reduces.

Limits: with the flag off, within 1 bf16 ulp of the reference and of the
one-device port at every element (the MoE product's f32 output within
f32 summation order, 1e-6 of its largest magnitude); with the flag on,
bitwise the bf16 products DTensor computes by itself.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
B, S, K, N = 4, 8, 512, 64  # row: x (B, S, K) @ w (K, N)
G, E, C, D, F = 4, 4, 8, 32, 48  # MoE: buf (G, E, C, D), w (E, D, F)


def _bf16_values(a):
    """``a`` rounded to bf16 (round to nearest even), kept as f32."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.view(np.float32)


def _inputs():
    rng = np.random.default_rng(7)
    inp = {"row_x": rng.standard_normal((B, S, K)),
           "row_w": rng.standard_normal((K, N)) * 0.05,
           "col_x": rng.standard_normal((B, S, N)),
           "col_w": rng.standard_normal((N, K)) * 0.05,
           "col_g": rng.standard_normal((B, S, K)),
           "moe_buf": rng.standard_normal((G, E, C, D)),
           "moe_w": rng.standard_normal((E, D, F)) * 0.2,
           "moe_g": rng.standard_normal((G, E, C, F))}
    # every input is a bf16 value, so both packages see the same operands
    return {k: _bf16_values(v) for k, v in inp.items()}


_JAX4 = textwrap.dedent("""
    import os, sys
    dump = sys.argv[3]
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                               f"--xla_dump_to={dump} "
                               "--xla_dump_hlo_pass_re=spmd-partitioning")
    import dataclasses, glob, json, re
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from repro.configs import SHAPES, get_smoke_config
    from repro.launch.hlo_analysis import HloModule
    from repro.launch.specs import build_cell
    from repro.models.layers import matmul
    from repro.models.perf_flags import set_flags
    from repro.sharding.axes import axis_rules

    inp = dict(np.load(sys.argv[1]))
    bf = lambda k: jnp.asarray(inp[k], jnp.bfloat16)
    mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
    sh = lambda *spec: NamedSharding(mesh, P(*spec))
    out = {}
    with mesh:
        out["row"] = jax.jit(matmul, in_shardings=(
            sh("data", None, "model"), sh("model")))(bf("row_x"),
                                                     bf("row_w"))
        col_dx = jax.jit(jax.grad(
            lambda x, w, g: jnp.sum(matmul(x, w).astype(jnp.float32) * g)),
            in_shardings=(sh("data"), sh(None, "model"),
                          sh("data", None, "model")))
        out["col_dx"] = col_dx(bf("col_x"), bf("col_w"),
                               jnp.asarray(inp["col_g"]))

        def experts(buf, w):  # the expression at repro/models/moe.py:156
            return jnp.einsum("gecd,edf->gecf", buf, w.astype(buf.dtype),
                              preferred_element_type=jnp.float32)

        # the CPU backend runs no batched bf16 x bf16 -> f32 dot, so the
        # bf16 values enter as f32 (the same products, summed in f32); the
        # weight gradient's cast to bf16 (the transpose of w.astype) is
        # applied here
        moe, vjp = jax.vjp(jax.jit(experts, in_shardings=(
            sh("data", "model"), sh("model"))), jnp.asarray(inp["moe_buf"]),
            jnp.asarray(inp["moe_w"]))
        out["moe"] = moe
        out["moe_dw"] = vjp(jnp.asarray(inp["moe_g"]))[1].astype(
            jnp.bfloat16)
    np.savez(sys.argv[2], **{k: np.asarray(v, np.float32)
                             for k, v in out.items()})

    # the all-reduces of the bf16 train cell, by the flag
    cfg = dataclasses.replace(get_smoke_config("stablelm-3b"),
                              dtype=jnp.bfloat16)
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=16,
                                global_batch=4)
    counts = {}
    for flag in (False, True):
        set_flags(bf16_collective_matmul=flag)
        with mesh, axis_rules(mesh):
            c = build_cell(cfg, shape, mesh)
            jax.jit(c.step, in_shardings=c.in_shardings).lower(
                *c.args).compile()
        path = sorted(glob.glob(f"{dump}/*after_spmd-partitioning*"),
                      key=os.path.getmtime)[-1]
        text = open(path).read()
        os.rename(path, path + f".{flag}")

        def trips(m):  # a loop's trip count: its condition's bound
            cond = m.group(2)
            body = text[text.find(f"%{cond} "):]
            body = body[:body.find("\\n}")]
            n = re.search(r"constant\\((\\d+)\\)", body).group(1)
            return m.group(1) + ', backend_config={"known_trip_count":' \\
                f'{{"n":"{n}"}}}}'
        text = re.sub(r"( while\\(.*?condition=%([\\w.\\-]+))", trips, text)
        mod = HloModule(text)
        per = {}
        for comp, instrs in mod.computations.items():
            made = {i.name: i.op for i in instrs}
            for ins in instrs:
                if (ins.op == "all-reduce"
                        and made.get(ins.operands[0]) == "dot"):
                    dt = ins.result_shapes[0][0]
                    per[dt] = per.get(dt, 0) + mod.multipliers.get(comp, 0)
        counts[str(flag)] = per
    json.dump(counts, open(sys.argv[2] + ".json", "w"))
    print("JAX4_OK")
""")

_PORT_OPS = textwrap.dedent("""
    import dataclasses, json, sys, torch
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.configs import SHAPES, get_smoke_config
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.hlo_analysis import analyze
    from repro_torch.launch.specs import build_cell
    from repro_torch.models.perf_flags import set_flags
    from repro_torch.sharding.axes import axis_rules

    fake_world(4)
    mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                      mesh_dim_names=("data", "model"))
    cfg = dataclasses.replace(get_smoke_config("stablelm-3b"),
                              dtype=torch.bfloat16)
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=16,
                                global_batch=4)
    counts = {}
    for flag in (False, True):
        set_flags(bf16_collective_matmul=flag)
        with axis_rules(mesh):
            c = build_cell(cfg, shape, mesh)
            res = analyze(c.step, *c.args)
        counts[str(flag)] = res["collectives"]["all-reduce"]
    json.dump(counts, open(sys.argv[1], "w"))
    print("PORT_OK")
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    inp = _inputs()
    np.savez(tmp / "inputs.npz", **inp)
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    procs = {
        "TP": [sys.executable, os.path.join(ROOT, "tests",
                                            "torch_tp_worker.py"), str(tmp)],
        "JAX4": [sys.executable, "-c", _JAX4, str(tmp / "inputs.npz"),
                 str(tmp / "jax4.npz"), str(tmp / "dump")],
        "PORT": [sys.executable, "-c", _PORT_OPS, str(tmp / "port.json")],
    }
    procs = {k: subprocess.Popen(v, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True, env=env,
                                 cwd=ROOT) for k, v in procs.items()}
    for name, proc in procs.items():
        try:
            stdout, stderr = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for p in procs.values():
                p.kill()
            raise
        assert f"{name}_OK" in stdout, stdout + "\n" + stderr[-3000:]
    return {"inp": inp,
            "ranks": [dict(np.load(tmp / f"rank{r}.npz"))
                      for r in range(WORLD)],
            "ref": dict(np.load(tmp / "jax4.npz")),
            "ref_counts": json.load(open(tmp / "jax4.npz.json")),
            "port_counts": json.load(open(tmp / "port.json"))}


def _bf16_ulp(a):
    """The spacing of bf16 values at |a| (8 significant bits)."""
    a = np.maximum(np.abs(a), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(a)) - 7)


def _within_ulps(got, want, n=1):
    """At most n bf16 ulps apart at every element (the ulp at the larger
    of the two magnitudes)."""
    ulp = _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
    return np.abs(got - want) <= n * ulp


PRODUCTS = ("row", "col_dx", "moe", "moe_dw")


@pytest.mark.parametrize("name", PRODUCTS)
def test_flag_off_sums_f32_partials_as_the_reference(runs, name):
    ref = runs["ref"][name]
    one = runs["ranks"][0][f"one:{name}"]
    for r, res in enumerate(runs["ranks"]):
        got = res[f"off:{name}"]
        assert got.shape == ref.shape
        if name == "moe":  # an f32 output: summation order only
            assert str(res["off:moe_dtype"]) == "torch.float32"
            scale = np.abs(ref).max()
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * scale)
            np.testing.assert_allclose(got, one, rtol=0, atol=1e-6 * scale)
            continue
        for want, what in ((ref, "reference"), (one, "one device")):
            ok = _within_ulps(got, want)
            assert ok.all(), (f"rank {r} {name} vs {what}: "
                              f"{(~ok).sum()} of {ok.size} elements more "
                              "than 1 bf16 ulp apart, largest "
                              f"{np.abs(got - want).max()}")


@pytest.mark.parametrize("name", ("row", "col_dx", "moe"))
def test_flag_on_is_the_bf16_partial_path_bitwise(runs, name):
    for res in runs["ranks"]:
        np.testing.assert_array_equal(res[f"on:{name}"],
                                      res[f"on:{name}_dtensor"])
    if name == "moe":
        assert str(runs["ranks"][0]["on:moe_dtype"]) == "torch.bfloat16"


def test_bf16_partials_differ_from_the_f32_sum(runs):
    """The control: DTensor's own bf16 partial sums of the row-parallel
    product are more than 1 ulp off the reference somewhere, so the limit
    above can fail."""
    res = runs["ranks"][0]
    assert not _within_ulps(res["off:row_dtensor"], runs["ref"]["row"]).all()


@pytest.mark.parametrize("flag", ("False", "True"))
def test_product_all_reduce_dtypes_follow_the_reference(runs, flag):
    """Every all-reduce that sums a product's partials, by element type,
    counted over the step: the port's op analysis against the reference's
    partitioned program (its loops' bodies times their trips)."""
    ref = {k: int(v) for k, v in runs["ref_counts"][flag].items()}
    port = runs["port_counts"][flag]["product_dtypes"]
    assert port == ref
    want = {"False": {"f32"}, "True": {"bf16", "f32"}}[flag]
    assert set(port) == want
