"""The port's collectives and DTensor execution on four gloo ranks on the
CPU, held against ``repro``.

One subprocess (``tests/torch_multirank_worker.py``) runs four ranks
joined by a ``FileStore`` (no port: parallel test workers cannot collide)
under its own timeout, so a hang fails instead of stalling the run.  It
computes, on seeded NumPy inputs written here:

* ``ag_matmul``/``rs_matmul`` at k = 4 (the reference test's shapes and
  limits: rtol/atol 2e-5 against x @ w);
* ``merged_era`` of 10 r + 3 on rank r (the max, 33, on every rank);
* ``compressed_all_reduce`` of per-rank gradients and residuals, held
  bitwise against the reference's ``compressed_psum`` under ``shard_map``
  on 4 forced host devices (a subprocess of its own, as the reference's
  multi-device tests run);
* the group-local MoE dispatch: mixtral-8x7b's smoke MoE layer at
  capacity factor 0.5 (tokens dropped) on the (2, 2) mesh, G = 2 with a
  capacity per group, against the reference's ``apply_moe`` under a (2, 2)
  ``("data", "model")`` mesh in that JAX subprocess, at the SPMD limits;
* ``reshard_state`` from a (4,) to a (2, 2) mesh: every leaf keeps its
  full value and takes ``sharding_tree``'s placements;
* SPMD equivalence: ``forward`` and ``lm_loss`` of stablelm-3b,
  mixtral-8x7b (group-local MoE dispatch at G = 2) and recurrentgemma-2b
  smoke configs with DTensor parameters laid out by ``sharding_tree`` on a
  (2, 2) ("data", "model") mesh under ``axis_rules``, against the
  one-device port run and the reference's numbers: logits rtol/atol 2e-4,
  loss rtol 2e-5, as ``test_spmd_equivalence.py`` holds the reference;
* the flash wrapper on DTensors (``local_map``, one local call a rank):
  output and gradients against the one-device call within 1e-5, with kv
  heads sharded beside the query heads, kv heads replicated (KH 1 does not
  divide the model axis: q's heads take k's layout) and a sequence
  sharding (gathered);
* one ``make_train_step`` step of stablelm-3b (two microbatches) on
  DTensor masters, the accumulators pinned to the FSDP layout by
  ``grad_shardings``, against the one-device step within 1e-5.
"""

import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import build_model as ref_build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
SPMD_ARCHS = ("stablelm-3b", "mixtral-8x7b", "recurrentgemma-2b")
B, S = 4, 16
#: the group-local dispatch case: mixtral's smoke MoE layer with tokens
#: dropped (G = 2 groups of 32 tokens, 8 slots an expert for 16 assignments
#: on average)
MOE_CAPACITY_FACTOR = 0.5


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _inputs():
    rng = np.random.default_rng(0)
    inp = {"x": rng.standard_normal((32, 16)).astype(np.float32),
           "w": rng.standard_normal((16, 24)).astype(np.float32),
           "sw": rng.standard_normal((8, 6)).astype(np.float32),
           "sb": rng.standard_normal((8,)).astype(np.float32)}
    for r in range(WORLD):
        for k, shape in (("a", (7, 5)), ("b", (33,))):
            inp[f"g{r}_{k}"] = (rng.standard_normal(shape) * (r + 1)
                                ).astype(np.float32)
            inp[f"r{r}_{k}"] = (rng.standard_normal(shape) * 0.01
                                ).astype(np.float32)
    for name, (h, kh) in {"gqa_heads": (4, 2), "kv_replicated": (4, 1),
                          "seq": (4, 2)}.items():
        b, t, d = 4, 12, 8
        for x, shape in (("q", (b, t, h, d)), ("k", (b, t, kh, d)),
                         ("v", (b, t, kh, d)), ("gout", (b, t, h, d))):
            inp[f"flash:{name}:{x}"] = rng.standard_normal(shape).astype(
                np.float32)
    cfg = ref_smoke_config("mixtral-8x7b")
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    for name, shape in (("router", (d, e)), ("wi_gate", (e, d, f)),
                        ("wi_up", (e, d, f)), ("wo", (e, f, d)),
                        ("x", (B, S, d)), ("gout", (B, S, d))):
        inp[f"moe:{name}"] = (rng.standard_normal(shape)
                              / np.sqrt(shape[-2] if name[0] == "w" or
                                        name == "router" else 1)
                              ).astype(np.float32)
    inp["moe:capacity_factor"] = np.array(MOE_CAPACITY_FACTOR)
    ref = {}
    for i, arch in enumerate(SPMD_ARCHS):
        cfg = ref_smoke_config(arch)
        model = ref_build(cfg)
        params = model.init(jax.random.key(i))
        toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int64)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        ref[f"{arch}:logits"] = np.asarray(model.forward(params,
                                                         batch["tokens"]))
        ref[f"{arch}:loss"] = float(model.loss(params, batch))
        inp.update(_flat(jax.tree.map(np.asarray, params), f"{arch}/"))
        inp[f"{arch}:tokens"] = toks
    return inp, ref


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("multirank")
    inp, ref = _inputs()
    np.savez(out / "inputs.npz", **inp)
    res = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tests",
                                      "torch_multirank_worker.py"),
         str(out)], capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")},
        cwd=ROOT)
    assert "MULTIRANK_OK" in res.stdout, res.stdout + "\n" + res.stderr
    per_rank = [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]
    return inp, ref, per_rank, out


def test_ag_matmul_and_rs_matmul(ranks):
    inp, _, per_rank, _ = ranks
    want = inp["x"] @ inp["w"]
    m, p = want.shape
    for r, res in enumerate(per_rank):
        np.testing.assert_allclose(
            res["ag"], want[:, r * p // WORLD:(r + 1) * p // WORLD],
            rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(
            res["rs"], want[r * m // WORLD:(r + 1) * m // WORLD],
            rtol=2e-5, atol=2e-5)


def test_merged_era_is_the_max(ranks):
    _, _, per_rank, _ = ranks
    assert [int(res["era"]) for res in per_rank] == [33] * WORLD


_JAX4 = textwrap.dedent("""
    import dataclasses, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, PartitionSpec as P

    from repro.configs import get_smoke_config
    from repro.models.moe import apply_moe
    from repro.sharding.axes import axis_rules
    from repro.sharding.gradient_compression import compressed_psum
    from repro.sharding.overlap import shard_map

    inp = dict(np.load(sys.argv[1]))
    mesh = Mesh(np.array(jax.devices()).reshape(4), ("dp",))
    g = {k: jnp.stack([inp[f"g{r}_{k}"] for r in range(4)]) for k in "ab"}
    r = {k: jnp.stack([inp[f"r{r}_{k}"] for r in range(4)]) for k in "ab"}

    def f(g, r):
        mean, nr = compressed_psum({k: v[0] for k, v in g.items()}, "dp",
                                   {k: v[0] for k, v in r.items()})
        return ({k: v[None] for k, v in mean.items()},
                {k: v[None] for k, v in nr.items()})

    mean, nr = shard_map(f, mesh=mesh, in_specs=(P("dp"), P("dp")),
                         out_specs=(P("dp"), P("dp")))(g, r)
    # the group-local MoE dispatch under a (2, 2) mesh: G = 2
    cfg = dataclasses.replace(get_smoke_config("mixtral-8x7b"),
                              capacity_factor=float(
                                  inp["moe:capacity_factor"]))
    p = {k: jnp.asarray(inp[f"moe:{k}"])
         for k in ("router", "wi_gate", "wi_up", "wo")}
    mesh22 = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
    x, gout = jnp.asarray(inp["moe:x"]), jnp.asarray(inp["moe:gout"])
    with mesh22, axis_rules(mesh22):
        moe = jax.jit(lambda p, x: apply_moe(cfg, p, x))(p, x)
        dp, dx = jax.jit(jax.grad(lambda p, x: jnp.sum(
            apply_moe(cfg, p, x) * gout), argnums=(0, 1)))(p, x)
    np.savez(sys.argv[2], **{f"mean_{k}": np.asarray(v)
                             for k, v in mean.items()},
             **{f"resid_{k}": np.asarray(v) for k, v in nr.items()},
             moe=np.asarray(moe), moe_dx=np.asarray(dx),
             **{f"moe_d{k}": np.asarray(v) for k, v in dp.items()})
    print("JAX4_OK")
""")


@pytest.fixture(scope="module")
def jax4(ranks):
    """The reference's multi-device results on 4 forced host devices."""
    out = ranks[3]
    res = subprocess.run(
        [sys.executable, "-c", _JAX4, str(out / "inputs.npz"),
         str(out / "jax4.npz")], capture_output=True, text=True,
        timeout=300, env={**os.environ, "PYTHONPATH": os.path.join(ROOT,
                                                                   "src")},
        cwd=ROOT)
    assert "JAX4_OK" in res.stdout, res.stdout + "\n" + res.stderr
    return dict(np.load(out / "jax4.npz"))


def test_compressed_all_reduce_matches_compressed_psum(ranks, jax4):
    _, _, per_rank, _ = ranks
    want = jax4
    for r, got in enumerate(per_rank):
        for k in "ab":
            np.testing.assert_array_equal(got[f"mean_{k}"],
                                          want[f"mean_{k}"][r])
            np.testing.assert_array_equal(got[f"resid_{k}"],
                                          want[f"resid_{k}"][r])


def test_reshard_state_keeps_values_and_takes_placements(ranks):
    _, _, per_rank, _ = ranks
    for res in per_rank:
        assert bool(res["reshard_ok"]), res["reshard_w_placements"]
        assert bool(res["reshard_again_ok"])
    # ("mlp", "embed") on (data 2, model 2): dim 0 over "model"
    assert str(per_rank[0]["reshard_w_placements"]) == \
        "(Replicate(), Shard(dim=0))"


def test_group_local_moe_dispatch_matches_reference(ranks, jax4):
    """Per-group capacity and drops: the port's G = 2 dispatch on the mesh
    equals the reference's G = 2 dispatch, forward and gradients, and
    differs from the global (G = 1) dispatch, so the per-group drop rule
    is what is held."""
    _, _, per_rank, _ = ranks
    for res in per_rank:
        assert int(res["moe:groups"]) == 2
        for x in ("", "_dx", "_drouter", "_dwi_gate", "_dwi_up", "_dwo"):
            np.testing.assert_allclose(res[f"moe:out{x}"], jax4[f"moe{x}"],
                                       rtol=2e-4, atol=2e-4, err_msg=x)
        assert np.abs(res["moe:one_out"] - jax4["moe"]).max() > 1e-2
    assert str(per_rank[0]["moe:placements"]) == \
        "(Shard(dim=0), Replicate())"


@pytest.mark.parametrize("arch", SPMD_ARCHS)
def test_spmd_forward_and_loss_match(ranks, arch):
    _, ref, per_rank, _ = ranks
    for res in per_rank:
        got, one = res[f"{arch}:logits"], res[f"{arch}:one_logits"]
        np.testing.assert_allclose(got, one, rtol=2e-4, atol=2e-4,
                                   err_msg=f"{arch}: sharded vs one device")
        np.testing.assert_allclose(got, ref[f"{arch}:logits"], rtol=2e-4,
                                   atol=2e-4,
                                   err_msg=f"{arch}: sharded vs reference")
        np.testing.assert_allclose(float(res[f"{arch}:loss"]),
                                   float(res[f"{arch}:one_loss"]), rtol=2e-5)
        np.testing.assert_allclose(float(res[f"{arch}:loss"]),
                                   ref[f"{arch}:loss"], rtol=2e-5)
    # the logits stayed sharded: batch over "data", vocab over "model"
    assert str(per_rank[0][f"{arch}:logits_placements"]) == \
        "(Shard(dim=0), Shard(dim=2))"


@pytest.mark.parametrize("case", ["gqa_heads", "kv_replicated", "seq"])
def test_flash_gradients_through_local_map_match_one_device(ranks, case):
    _, _, per_rank, _ = ranks
    want = {"gqa_heads": "(Shard(dim=0), Shard(dim=2))",
            "kv_replicated": "(Shard(dim=0), Replicate())",
            "seq": "(Replicate(), Replicate())"}[case]
    for res in per_rank:
        assert int(res[f"flash:{case}:calls"]) == 1  # one local call a rank
        assert str(res[f"flash:{case}:placements"]) == want
        for x in ("out", "dq", "dk", "dv"):
            np.testing.assert_allclose(res[f"flash:{case}:{x}"],
                                       res[f"flash:{case}:one_{x}"],
                                       rtol=1e-5, atol=1e-5,
                                       err_msg=f"{case} {x}")


def test_train_step_with_grad_shardings_matches_one_device(ranks):
    _, _, per_rank, _ = ranks
    for res in per_rank:
        np.testing.assert_allclose(float(res["train:loss"]),
                                   float(res["train:one_loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(res["train:grad_norm"]),
                                   float(res["train:one_grad_norm"]),
                                   rtol=1e-5)
        assert float(res["train:max_param_diff"]) <= 1e-5
        # the layouts were really sharded, and the pinned accumulators
        # differ from the masters' placements on some leaves
        assert int(res["train:sharded_leaves"]) > 0
        assert int(res["train:fsdp_differs"]) > 0
