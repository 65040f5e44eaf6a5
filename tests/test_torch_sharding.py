"""The port's sharding layer (``repro_torch.sharding``, the zoo's logical
axes, the shape cells, the point-form era scan and the era clock's device
merge) held against ``repro`` on the CPU.

Specs are compared as tuples (the port's ``Spec`` against the reference's
``PartitionSpec``), leaf by leaf, exactly.  The quantizer is compared
bitwise.  Meshes are shape-only stand-ins (both packages' resolution reads
only the axis names and sizes), except the one-rank gloo groups.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh, PartitionSpec as P

from repro.configs import ALL_ARCHS, SHAPES as REF_SHAPES
from repro.configs import cell_is_runnable as ref_cell_is_runnable
from repro.configs import get_config as ref_get_config
from repro.core import make_scheme as ref_make_scheme
from repro.core.distributed_eras import DistributedEraClock as RefClock
from repro.kernels import can_delete_blocks as ref_can_delete_blocks
from repro.models import build_model as ref_build
from repro.sharding import gradient_compression as ref_gc
from repro.sharding.axes import DEFAULT_RULES as REF_RULES
from repro.sharding.axes import logical_to_spec as ref_logical_to_spec
from repro.sharding.axes import spec_tree_for_params as ref_spec_tree
from repro.sharding.axes import zero_shard_spec as ref_zero_shard_spec

from repro_torch.configs import SHAPES, cell_is_runnable, get_config
from repro_torch.core import make_scheme
from repro_torch.core.distributed_eras import (DistributedEraClock,
                                               ShardedEraDomain, merged_era)
from repro_torch.kernels import can_delete_blocks, era_scan, ref
from repro_torch.launch.mesh import (PRODUCTION_SHAPES, make_production_mesh,
                                     make_smoke_mesh)
from repro_torch.models import build_model
from repro_torch.sharding import gradient_compression as gc
from repro_torch.sharding.axes import (DEFAULT_RULES, Spec, logical_to_spec,
                                       spec_tree_for_params, zero_shard_spec)

INF = 2**31 - 1

MESHES = PRODUCTION_SHAPES


class FakeMesh:
    """Shape-only mesh stand-in: ``shape`` maps axis names to sizes."""

    def __init__(self, shape):
        self.shape = dict(shape)


def _flat(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (k,)))
        return out
    return {path: tree}


@pytest.fixture
def one_rank_gloo(tmp_path):
    """A one-rank gloo group on a FileStore (no port: parallel test workers
    cannot collide)."""
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


# ============================================================ logical axes
def test_default_rules_equal_reference():
    assert {k: list(v) for k, v in DEFAULT_RULES.items()} == \
        {k: list(v) for k, v in REF_RULES.items()}


def test_logical_to_spec_basics():
    """test_sharding_launch.py:34: size-1 axes are never assigned."""
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    assert logical_to_spec(("batch", "embed"), (8, 16), mesh) == Spec()
    assert tuple(logical_to_spec(("batch", "embed"), (8, 16), mesh)) == \
        tuple(ref_logical_to_spec(("batch", "embed"), (8, 16), mesh)) == ()


# names, dims and mesh sizes of test_sharding_launch.py:47-83
NAMES = sorted(DEFAULT_RULES) + ["nonexistent", None]
DIMS = [1, 3, 8, 16, 24, 160, 256]


def _random_cases(n, seed):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        axes = {"data": int(rng.choice([2, 4, 16])),
                "model": int(rng.choice([2, 8, 16]))}
        if rng.random() < 0.3:
            axes = {"pod": int(rng.choice([1, 2])), **axes}
        ndim = int(rng.integers(1, 5))
        names = tuple(NAMES[int(i)] for i in rng.integers(0, len(NAMES),
                                                          ndim))
        shape = tuple(int(rng.choice(DIMS)) for _ in range(ndim))
        yield axes, names, shape


@pytest.mark.parametrize("seed", range(5))
def test_logical_to_spec_matches_reference(seed):
    """100 seeded (mesh, names, shape) cases per seed: the reference's spec,
    and its properties (divisible, no mesh axis reused, trailing Nones
    trimmed)."""
    for axes, names, shape in _random_cases(100, seed):
        mesh = FakeMesh(axes)
        got = logical_to_spec(names, shape, mesh)
        want = ref_logical_to_spec(names, shape, mesh)
        assert tuple(got) == tuple(want), (axes, names, shape, got, want)
        assert not got or got[-1] is not None
        used = []
        for entry, dim in zip(got, shape):
            if entry is None:
                continue
            ax = entry if isinstance(entry, tuple) else (entry,)
            assert dim % math.prod(axes[a] for a in ax) == 0
            used += list(ax)
        assert len(used) == len(set(used))


def test_composite_batch_axis_degrades_without_pod():
    assert logical_to_spec(("batch",), (64,), FakeMesh(MESHES["2x16x16"])) \
        == (("pod", "data"),)
    assert logical_to_spec(("batch",), (64,), FakeMesh(MESHES["16x16"])) \
        == ("data",)


def test_zero_shard_spec_cases():
    """test_sharding_launch.py:81's three cases, against the reference."""
    mesh = FakeMesh({"data": 16, "model": 16})
    cases = [((None, "model"), (3072, 24576), ("data", "model")),
             ((), (7,), ()),
             (("data", None), (32, 32), ("data", None))]
    for spec, shape, want in cases:
        got = zero_shard_spec(Spec(*spec), shape, mesh)
        assert tuple(got) == want
        assert tuple(got) == tuple(ref_zero_shard_spec(P(*spec), shape, mesh))


@functools.lru_cache(maxsize=None)
def _ref_abstract(arch):
    model = ref_build(ref_get_config(arch))
    return model, model.abstract_params()


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_and_cache_specs_match_reference(arch, mesh_name):
    """``spec_tree_for_params`` over ``params_axes()`` and over
    ``cache_axes()``, full config, leaf by leaf against the reference's on a
    shape-only production mesh."""
    mesh = FakeMesh(MESHES[mesh_name])
    model = build_model(get_config(arch))
    ref_model, ref_abstract = _ref_abstract(arch)
    got = _flat(spec_tree_for_params(model.abstract_params(),
                                     model.params_axes(), mesh))
    want = _flat(ref_spec_tree(ref_abstract, ref_model.params_axes(), mesh))
    assert got.keys() == want.keys()
    for k in got:
        assert tuple(got[k]) == tuple(want[k]), (k, got[k], want[k])
    b, s = 128, 32768
    cache = model.init_cache(b, s, device="meta")
    ref_cache = jax.eval_shape(lambda: ref_model.init_cache(b, s))
    c_got = _flat(spec_tree_for_params(cache, model.cache_axes(), mesh))
    c_want = _flat(ref_spec_tree(ref_cache, ref_model.cache_axes(), mesh))
    assert c_got.keys() == c_want.keys()
    for k in c_got:
        assert tuple(c_got[k]) == tuple(c_want[k]), (k, c_got[k], c_want[k])


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_axes_trees_and_abstract_params_match_reference(arch):
    """``params_axes``/``cache_axes`` equal the reference's; every axes
    tuple has its leaf's rank; ``abstract_params`` has ``jax.eval_shape``'s
    tree and shapes, allocates nothing (``meta``), and takes the
    reference's dtypes in the training storage (``master=True``) and
    ``storage_dtype``'s otherwise."""
    from repro_torch.models.params import _shapes, storage_dtype

    cfg = get_config(arch)
    model = build_model(cfg)
    ref_model, ref_abstract = _ref_abstract(arch)
    axes = _flat(model.params_axes())
    assert axes == {k: tuple(v) for k, v in
                    _flat(ref_model.params_axes()).items()}
    ref_flat = _flat(ref_abstract)
    kinds = _flat(_shapes(cfg))
    for master in (False, True):
        got = _flat(model.abstract_params(master=master))
        assert got.keys() == ref_flat.keys() == axes.keys()
        for k, leaf in got.items():
            assert leaf.device.type == "meta"
            assert tuple(leaf.shape) == tuple(ref_flat[k].shape), k
            assert len(axes[k]) == leaf.ndim, k
            assert leaf.dtype == storage_dtype(cfg, kinds[k][1], master), k
            if master:
                assert str(leaf.dtype).split(".")[-1] == \
                    str(ref_flat[k].dtype), k
    assert _flat(model.cache_axes()) == {
        k: tuple(v) for k, v in _flat(ref_model.cache_axes()).items()}
    cache = _flat(model.init_cache(2, 8, device="meta"))
    c_axes = _flat(model.cache_axes())
    assert c_axes.keys() == cache.keys()
    assert all(len(c_axes[k]) == cache[k].ndim for k in cache)


def test_shapes_and_cell_rule_match_reference():
    assert {k: tuple(vars(v).values()) for k, v in SHAPES.items()} == \
        {k: tuple(vars(v).values()) for k, v in REF_SHAPES.items()}
    for arch in ALL_ARCHS:
        for name in SHAPES:
            assert cell_is_runnable(get_config(arch), SHAPES[name]) == \
                ref_cell_is_runnable(ref_get_config(arch), REF_SHAPES[name])


# ============================================================ compression
def _grads(seed, shapes=((7, 5), (33,), (2, 3, 4))):
    rng = np.random.default_rng(seed)
    out = [rng.standard_normal(s).astype(np.float32) * 3 for s in shapes]
    # ties: values at exact half-steps of the scale (127 / 127 = 1)
    out.append(np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, -126.5],
                        np.float32))
    return out


def test_quantize_matches_reference_bitwise():
    for g in _grads(0):
        r = np.random.default_rng(1).standard_normal(g.shape).astype(
            np.float32) * 0.01
        q, scale = gc.quantize(torch.from_numpy(g))
        rq, rscale = ref_gc.quantize(jnp.asarray(g))
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
        assert scale.item() == float(rscale)
        np.testing.assert_array_equal(
            gc.dequantize(q, scale).numpy(),
            np.asarray(ref_gc.dequantize(rq, rscale)))
        q2, s2, nr = gc.apply_error_feedback(torch.from_numpy(g),
                                             torch.from_numpy(r))
        rq2, rs2, rnr = ref_gc.apply_error_feedback(jnp.asarray(g),
                                                    jnp.asarray(r))
        np.testing.assert_array_equal(q2.numpy(), np.asarray(rq2))
        assert s2.item() == float(rs2)
        np.testing.assert_array_equal(nr.numpy(), np.asarray(rnr))
    # round half to even at the ties
    q, _ = gc.quantize(torch.from_numpy(_grads(0)[-1]))
    assert q.tolist() == [127, 0, 2, 2, 0, -2, 4, -126]


def test_quantize_roundtrip_error_bounded():
    """test_train_data.py:188."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(128)
                         .astype(np.float32) * 3.0)
    q, s = gc.quantize(x)
    err = (gc.dequantize(q, s) - x).abs()
    assert err.max().item() <= s.item() * 0.5 + 1e-6


def test_error_feedback_converges():
    """test_train_data.py:195: EF-SGD on a quadratic converges with
    int8-compressed gradients."""
    target = torch.tensor([0.7, -1.3, 2.1, 0.0])
    w = torch.zeros(4)
    residual = torch.zeros(4)
    for _ in range(400):
        g = 2 * (w - target)
        q, s, residual = gc.apply_error_feedback(g, residual)
        w = w - 0.05 * gc.dequantize(q, s)
    np.testing.assert_allclose(w.numpy(), target.numpy(), atol=0.02)


def test_compressed_all_reduce_on_one_rank_group(one_rank_gloo):
    """test_train_data.py:209 on a one-rank gloo group: the mean within
    0.51 of a quantization step, and bitwise the group-free
    ``dequantize(quantize(g + r))`` with its residual."""
    rng = np.random.default_rng(1)
    g = {"g": torch.from_numpy(rng.standard_normal(64).astype(np.float32)),
         "h": torch.from_numpy(rng.standard_normal((3, 5)).astype(
             np.float32))}
    r = {"g": torch.zeros(64),
         "h": torch.from_numpy(rng.standard_normal((3, 5)).astype(
             np.float32) * 0.01)}
    out, new_r = gc.compressed_all_reduce(g, None, r)
    scale = g["g"].abs().max().item() / 127.0
    np.testing.assert_allclose(out["g"].numpy(), g["g"].numpy(),
                               atol=scale * 0.51)
    for k in g:
        q, s, want_r = gc.apply_error_feedback(g[k], r[k])
        assert torch.equal(out[k], gc.dequantize(q, s))
        assert torch.equal(new_r[k], want_r)


def test_collective_bytes_saved_and_residuals_match_reference():
    gs = _grads(2)
    tree = {f"l{i}": torch.from_numpy(g) for i, g in enumerate(gs)}
    ref_tree = {f"l{i}": jnp.asarray(g) for i, g in enumerate(gs)}
    assert gc.collective_bytes_saved(tree) == \
        ref_gc.collective_bytes_saved(ref_tree)
    res = gc.init_residuals(tree)
    assert all(r.dtype == torch.float32 and r.shape == tree[k].shape
               and not r.any() for k, r in res.items())


# ============================================================ era scan
@pytest.mark.parametrize("r", [1, 7, 256, 300, 1000])
@pytest.mark.parametrize("t,h", [(4, 2), (64, 10), (512, 10)])
def test_can_delete_blocks_matches_reference(r, t, h):
    """test_kernels.py:44's shapes: the port's point-form scan (plain, on
    CPU tensors, with and without ``use_kernel``) equals the reference's
    Pallas kernel in interpret mode and its oracle."""
    rng = np.random.default_rng(r * 1000 + t + h)
    alloc = rng.integers(0, 100, r).astype(np.int32)
    retire = (alloc + rng.integers(0, 50, r)).astype(np.int32)
    res = rng.integers(0, 160, (t, h)).astype(np.int32)
    res[rng.random((t, h)) < 0.5] = INF
    want = np.asarray(ref_can_delete_blocks(alloc, retire, res,
                                            use_kernel=True, interpret=True))
    np.testing.assert_array_equal(
        want, np.asarray(ref_can_delete_blocks(alloc, retire, res)))
    for use_kernel in (False, True):
        got = can_delete_blocks(alloc, retire, res, use_kernel=use_kernel)
        assert got.dtype == torch.bool and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        ref.era_scan_ref(*map(torch.from_numpy, (alloc, retire, res))).numpy(),
        want)


def test_can_delete_blocks_never_frees_protected():
    """test_kernels.py:97: a reservation inside [alloc, retire] (ends
    included) keeps a block; one outside frees it."""
    alloc = np.array([5, 5, 5], np.int32)
    retire = np.array([10, 10, 10], np.int32)
    assert not can_delete_blocks(alloc, retire,
                                 np.array([[7, INF]], np.int32)).any()
    for era in (5, 10):
        assert not can_delete_blocks(alloc, retire,
                                     np.array([[era]], np.int32)).any()
    for era in (4, 11):
        assert can_delete_blocks(alloc, retire,
                                 np.array([[era]], np.int32)).all()


def test_era_scan_point_form_refuses_cpu_tensors():
    """The kernel wrapper takes CUDA tensors only: no silent CPU route."""
    t = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        era_scan.era_scan(t, t, torch.zeros((1, 2), dtype=torch.int32))


# ============================================================ era clocks
def test_distributed_era_clock_monotone_merge():
    """test_sharding_launch.py:175, beside the reference's clock."""
    smr = make_scheme("WFE", max_threads=2, era_freq=1, cleanup_freq=1)
    clock = DistributedEraClock(smr)
    ref_smr = ref_make_scheme("WFE", max_threads=2, era_freq=1,
                              cleanup_freq=1)
    ref_clock = RefClock(ref_smr)
    e0 = clock.local
    assert e0 == ref_clock.local
    for remote in (e0 - 1, e0 + 10):
        assert clock.merge(remote) == ref_clock.merge(remote)
    assert clock.local == ref_clock.local == e0 + 10
    smr.global_era.fa_add(1)  # local F&A keeps working after a merge
    assert clock.local == e0 + 11


def test_device_merge_on_one_rank_group(one_rank_gloo):
    """test_sharding_launch.py:190 on a one-rank gloo group: the merge is
    the rank's own maximum and never moves a clock back."""
    smrs = [make_scheme("WFE", max_threads=2, era_freq=1, cleanup_freq=1)
            for _ in range(3)]
    smrs[1].global_era.fa_add(7)
    dom = ShardedEraDomain(smrs)
    clock = dom.clocks[0]
    before = clock.local
    assert clock.device_merge() == before
    assert merged_era(5) == 5
    t = merged_era(torch.tensor([9]))
    assert torch.is_tensor(t) and t.tolist() == [9]
    m = dom.device_merge_all()
    assert m == max(dom.locals) == before + 7 and dom.spread() == 0
    assert dom.stats()["era_merges"] == 1
    assert clock.local >= before


# ============================================================ meshes
def test_production_shapes_are_the_reference_meshes():
    """``repro/launch/mesh.py``: (16, 16) ("data", "model") and
    (2, 16, 16) ("pod", "data", "model")."""
    assert {k: tuple(v.items()) for k, v in PRODUCTION_SHAPES.items()} == {
        "16x16": (("data", 16), ("model", 16)),
        "2x16x16": (("pod", 2), ("data", 16), ("model", 16))}


def test_smoke_mesh_opens_a_one_rank_gloo_group_on_the_cpu():
    assert not dist.is_initialized()
    try:
        mesh = make_smoke_mesh("cpu")
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        assert mesh.mesh_dim_names == ("data", "model")
        assert tuple(mesh.shape) == (1, 1)
        assert make_smoke_mesh("cpu").mesh_dim_names == ("data", "model")
        # a CUDA mesh never runs on the open gloo group
        with pytest.raises(RuntimeError, match="nccl"):
            make_smoke_mesh("cuda")
        for multi_pod in (False, True):
            with pytest.raises(RuntimeError, match="ranks for mesh"):
                make_production_mesh(multi_pod=multi_pod)
    finally:
        dist.destroy_process_group()


# ============================================================ trainer
def _train_batch(cfg, seed, b=4, s=16):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
    batch["labels"][0, :3] = -1
    if cfg.frontend == "frames":
        batch["frames"] = 0.02 * rng.standard_normal(
            (b, cfg.encoder_ctx, cfg.d_model)).astype(np.float32)
    return batch


def _step(cfg, batch, mesh=None, steps=1):
    """``steps`` train steps from seed-0 masters: plain tensors, or DTensors
    laid out by ``sharding_tree`` on ``mesh`` (accumulators pinned to the
    same placements) under ``axis_rules``.  Returns (losses, params)."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.sharding.axes import axis_rules, sharding_tree
    from repro_torch.train.optim import (AdamWConfig, adamw_init, tree_leaves,
                                         tree_map)
    from repro_torch.train.trainer import make_train_step

    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu",
                        master=True)
    shardings = None
    if mesh is not None:
        shardings = sharding_tree(params, model.params_axes(), mesh)
        params = tree_map(lambda t, pl: distribute_tensor(t, mesh, pl),
                          params, shardings)
    state = {"params": params, "opt": adamw_init(params)}
    step = make_train_step(model, AdamWConfig(warmup_steps=1),
                           grad_shardings=shardings)
    losses = []
    with axis_rules(mesh):
        for _ in range(steps):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
    leaves = [p.full_tensor() if mesh is not None else p
              for p in tree_leaves(state["params"])]
    return losses, leaves


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_train_step_on_one_rank_mesh_matches_plain(one_rank_gloo, arch):
    """Two steps (two microbatches each, remat on) on DTensor masters on a
    1x1 gloo mesh against the plain-tensor steps: the same local ops, so
    the same losses and parameters within 1e-6 (MLA's summation order of
    a weight used twice may differ in the last bits)."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_smoke_config

    cfg = get_smoke_config(arch).scaled(num_microbatches=2, remat=True)
    batch = _train_batch(cfg, 1)
    mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    want_loss, want = _step(cfg, batch, steps=2)
    got_loss, got = _step(cfg, batch, mesh, steps=2)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-6)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_bf16_weight_gather_step(one_rank_gloo):
    """``perf_flags.bf16_weight_gather`` (off by default): a bf16 model's
    step on a 1x1 mesh casts the f32 masters to bf16 before the forward;
    the loss is finite and within 1e-2 of the step without the flag, and
    the masters stay f32."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_smoke_config
    from repro_torch.models.perf_flags import FLAGS, set_flags

    assert FLAGS["bf16_weight_gather"] is False
    cfg = get_smoke_config("stablelm-3b").scaled(dtype=torch.bfloat16,
                                                 num_microbatches=2)
    batch = _train_batch(cfg, 2)
    mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    off_loss, off = _step(cfg, batch, mesh)
    prev = set_flags(bf16_weight_gather=True)
    try:
        on_loss, on = _step(cfg, batch, mesh)
    finally:
        set_flags(**prev)
    assert math.isfinite(on_loss[0])
    assert abs(on_loss[0] - off_loss[0]) <= 1e-2 * abs(off_loss[0])
    assert all(p.dtype == torch.float32 for p in on)
