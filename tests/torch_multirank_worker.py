"""Four gloo ranks on the CPU for ``tests/test_torch_multirank.py``.

Run as ``python tests/torch_multirank_worker.py <dir>``: reads
``<dir>/inputs.npz`` (written by the test), spawns four ranks joined by a
``FileStore`` under ``<dir>`` (no port, so parallel test workers cannot
collide) and writes ``<dir>/rank<r>.npz`` with each rank's results; prints
``MULTIRANK_OK`` when every rank finished.
"""

import os
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 4
SPMD_ARCHS = ("stablelm-3b", "mixtral-8x7b", "recurrentgemma-2b")


def _nest(flat: dict, prefix: str) -> dict:
    """Nested dicts of the arrays whose '/'-joined key starts with prefix."""
    out: dict = {}
    for key, val in flat.items():
        if not key.startswith(prefix):
            continue
        node = out
        parts = key[len(prefix):].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return out


def _collectives(rank, inp, res):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, distribute_tensor

    from repro_torch.core.distributed_eras import merged_era
    from repro_torch.sharding.axes import sharding_tree
    from repro_torch.sharding.gradient_compression import \
        compressed_all_reduce
    from repro_torch.sharding.overlap import ag_matmul, rs_matmul
    from repro_torch.train.fault_tolerance import reshard_state
    from repro_torch.train.optim import tree_map

    x, w = torch.from_numpy(inp["x"]), torch.from_numpy(inp["w"])
    m, n = x.shape
    p = w.shape[1]
    res["ag"] = ag_matmul(x[rank * m // WORLD:(rank + 1) * m // WORLD],
                          w[:, rank * p // WORLD:(rank + 1) * p // WORLD]
                          ).numpy()
    res["rs"] = rs_matmul(x[:, rank * n // WORLD:(rank + 1) * n // WORLD],
                          w[rank * n // WORLD:(rank + 1) * n // WORLD]
                          ).numpy()
    res["era"] = np.array(merged_era(10 * rank + 3))
    grads = {k: torch.from_numpy(inp[f"g{rank}_{k}"]) for k in ("a", "b")}
    resid = {k: torch.from_numpy(inp[f"r{rank}_{k}"]) for k in ("a", "b")}
    mean, new_r = compressed_all_reduce(grads, None, resid)
    for k in ("a", "b"):
        res[f"mean_{k}"] = mean[k].numpy()
        res[f"resid_{k}"] = new_r[k].numpy()

    # reshard a state from a (4,) mesh to a (2, 2) mesh
    state = {"w": torch.from_numpy(inp["sw"]), "b": torch.from_numpy(
        inp["sb"]), "step": torch.tensor(3)}
    axes = {"w": ("mlp", "embed"), "b": ("batch",), "step": None}
    mesh4 = init_device_mesh("cpu", (4,), mesh_dim_names=("model",))
    mesh22 = init_device_mesh("cpu", (2, 2),
                              mesh_dim_names=("data", "model"))
    start = tree_map(lambda leaf, pl: distribute_tensor(leaf, mesh4, pl),
                     state, sharding_tree(state, axes, mesh4))
    moved = reshard_state(start, axes, mesh22)
    want = sharding_tree(state, axes, mesh22)
    ok = all(isinstance(moved[k], DTensor)
             and moved[k].device_mesh == mesh22
             and tuple(moved[k].placements) == tuple(want[k])
             and torch.equal(moved[k].full_tensor(), state[k])
             for k in state)
    res["reshard_ok"] = np.array(ok)
    res["reshard_w_placements"] = np.array(str(moved["w"].placements))
    # a plain tensor distributes, a DTensor on the same mesh redistributes
    again = reshard_state(moved, axes, mesh22)
    res["reshard_again_ok"] = np.array(all(
        torch.equal(again[k].full_tensor(), state[k]) for k in state))


def _spmd(rank, inp, res):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, distribute_tensor

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model, from_jax_params
    from repro_torch.sharding.axes import (axis_rules, logical_to_spec,
                                           sharding_tree, spec_to_placements)
    from repro_torch.train.optim import tree_map

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    for arch in SPMD_ARCHS:
        cfg = get_smoke_config(arch)
        model = build_model(cfg)
        params = from_jax_params(cfg, _nest(inp, f"{arch}/"), device="cpu")
        toks = torch.from_numpy(inp[f"{arch}:tokens"])
        batch = {"tokens": toks[:, :-1].contiguous(),
                 "labels": toks[:, 1:].contiguous()}
        b, s = batch["tokens"].shape
        with torch.no_grad():
            res[f"{arch}:one_logits"] = model.forward(
                params, batch["tokens"]).numpy()
            res[f"{arch}:one_loss"] = np.array(model.loss(params,
                                                          batch).item())
        placed = tree_map(
            lambda leaf, pl: distribute_tensor(leaf, mesh, pl), params,
            sharding_tree(params, model.params_axes(), mesh))
        tpl = spec_to_placements(logical_to_spec(("batch", None), (b, s),
                                                 mesh), mesh)
        dbatch = {k: distribute_tensor(v, mesh, tpl)
                  for k, v in batch.items()}
        with torch.no_grad(), axis_rules(mesh):
            logits = model.forward(placed, dbatch["tokens"])
            loss = model.loss(placed, dbatch)
        assert isinstance(logits, DTensor), type(logits)
        res[f"{arch}:logits"] = logits.full_tensor().numpy()
        res[f"{arch}:loss"] = np.array(loss.full_tensor().item())
        res[f"{arch}:logits_placements"] = np.array(str(logits.placements))


def _moe(rank, inp, res):
    """mixtral's smoke MoE layer with dropped tokens: the group-local
    dispatch (G = 2) on a (2, 2) mesh, forward and gradients, and the
    global dispatch on one device."""
    import dataclasses

    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, distribute_tensor

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import moe
    from repro_torch.models.moe import MOE_AXES, apply_moe
    from repro_torch.sharding.axes import (axis_rules, logical_to_spec,
                                           sharding_tree, spec_to_placements)
    from repro_torch.train.optim import tree_map

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    cfg = dataclasses.replace(
        get_smoke_config("mixtral-8x7b"),
        capacity_factor=float(inp["moe:capacity_factor"]))
    p = {k: torch.from_numpy(inp[f"moe:{k}"])
         for k in ("router", "wi_gate", "wi_up", "wo")}
    x, gout = (torch.from_numpy(inp[f"moe:{k}"]) for k in ("x", "gout"))
    with torch.no_grad():
        res["moe:one_out"] = apply_moe(cfg, p, x).numpy()
    axes = {k: MOE_AXES[k] for k in p}
    dp = tree_map(lambda t, pl: distribute_tensor(t, mesh, pl
                                                  ).requires_grad_(),
                  p, sharding_tree(p, axes, mesh))
    dx = distribute_tensor(x, mesh, spec_to_placements(logical_to_spec(
        ("batch", "seq", "embed"), x.shape, mesh), mesh)).requires_grad_()
    with axis_rules(mesh):
        res["moe:groups"] = np.array(moe._dispatch_groups(x.shape[0]
                                                          * x.shape[1]))
        out = apply_moe(cfg, dp, dx)
        assert isinstance(out, DTensor), type(out)
        (out.full_tensor() * gout).sum().backward()
    res["moe:out"] = out.full_tensor().detach().numpy()
    res["moe:placements"] = np.array(str(out.placements))
    res["moe:out_dx"] = dx.grad.full_tensor().numpy()
    for k, v in dp.items():
        res[f"moe:out_d{k}"] = v.grad.full_tensor().numpy()


#: flash cases: (H, KH, q's placements on ("data", "model")); k and v take
#: ``kv`` placements.  KH 1 does not divide the model axis, so q's heads
#: must follow k's replicated layout; a sequence sharding is gathered.
FLASH_CASES = {
    "gqa_heads": (4, 2, "batch_heads", "batch_heads"),
    "kv_replicated": (4, 1, "batch_heads", "batch"),
    "seq": (4, 2, "seq", "seq"),
}


def _flash(rank, inp, res):
    """Gradients through ``attention.flash_attention`` on DTensors (the
    ``local_map`` wrapper) against the one-device call."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.models import attention
    from repro_torch.sharding.axes import axis_rules

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    layouts = {"batch_heads": [Shard(0), Shard(2)],
               "batch": [Shard(0), Replicate()],
               "seq": [Shard(1), Replicate()]}
    for name, (h, kh, q_layout, kv_layout) in FLASH_CASES.items():
        q, k, v, gout = (torch.from_numpy(inp[f"flash:{name}:{x}"])
                         for x in ("q", "k", "v", "gout"))
        b, t = q.shape[:2]
        pos = torch.arange(t)[None].expand(b, t)
        one = [x.clone().requires_grad_() for x in (q, k, v)]
        out1 = attention.flash_attention(*one, pos, pos, causal=True,
                                         arange_positions=True)
        (out1 * gout).sum().backward()
        dts = [distribute_tensor(x, mesh, layouts[lay]).requires_grad_()
               for x, lay in ((q, q_layout), (k, kv_layout), (v, kv_layout))]
        before = attention.FLASH_ROUTES["plain"].n
        with axis_rules(mesh):
            out = attention.flash_attention(*dts, pos, pos, causal=True,
                                            arange_positions=True)
            (out.full_tensor() * gout).sum().backward()
        res[f"flash:{name}:calls"] = np.array(
            attention.FLASH_ROUTES["plain"].n - before)
        res[f"flash:{name}:placements"] = np.array(str(out.placements))
        res[f"flash:{name}:out"] = out.full_tensor().detach().numpy()
        res[f"flash:{name}:one_out"] = out1.detach().numpy()
        for x, dt, o in zip("qkv", dts, one):
            res[f"flash:{name}:d{x}"] = dt.grad.full_tensor().numpy()
            res[f"flash:{name}:one_d{x}"] = o.grad.numpy()


def _train(rank, inp, res):
    """One ``make_train_step`` step of stablelm-3b's smoke config (two
    microbatches) on DTensor masters laid out by ``sharding_tree`` on a
    (2, 2) mesh, the gradient accumulators pinned to the FSDP layout
    (``zero_shard_spec`` over "data"), against the one-device step."""
    import dataclasses

    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model, from_jax_params
    from repro_torch.sharding.axes import (axis_rules, sharding_tree,
                                           spec_to_placements,
                                           spec_tree_for_params,
                                           zero_shard_spec)
    from repro_torch.train.optim import (AdamWConfig, adamw_init, tree_leaves,
                                         tree_map)
    from repro_torch.train.trainer import make_train_step

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    arch = "stablelm-3b"
    cfg = dataclasses.replace(get_smoke_config(arch), num_microbatches=2)
    model = build_model(cfg)
    toks = torch.from_numpy(inp[f"{arch}:tokens"])
    batch = {"tokens": toks[:, :-1].contiguous(),
             "labels": toks[:, 1:].contiguous()}
    opt = AdamWConfig(warmup_steps=1)

    def master():
        params = from_jax_params(cfg, _nest(inp, f"{arch}/"), device="cpu",
                                 master=True)
        return {"params": params, "opt": adamw_init(params)}

    one = master()
    one, m1 = make_train_step(model, opt)(one, batch)
    state = master()
    axes = model.params_axes()
    state["params"] = tree_map(
        lambda leaf, pl: distribute_tensor(leaf, mesh, pl), state["params"],
        sharding_tree(state["params"], axes, mesh))
    state["opt"] = adamw_init(state["params"])
    specs = spec_tree_for_params(state["params"], axes, mesh)
    fsdp = tree_map(lambda s, leaf: spec_to_placements(
        zero_shard_spec(s, leaf.shape, mesh), mesh), specs, state["params"])
    with axis_rules(mesh):
        state, m = make_train_step(model, opt, grad_shardings=fsdp)(state,
                                                                    batch)
    res["train:loss"] = np.array(float(m["loss"]))
    res["train:one_loss"] = np.array(float(m1["loss"]))
    res["train:grad_norm"] = np.array(float(m["grad_norm"].full_tensor()))
    res["train:one_grad_norm"] = np.array(float(m1["grad_norm"]))
    got = [p.full_tensor() for p in tree_leaves(state["params"])]
    want = tree_leaves(one["params"])
    res["train:max_param_diff"] = np.array(max(
        (a - b).abs().max().item() for a, b in zip(got, want)))
    res["train:sharded_leaves"] = np.array(sum(
        any(not pl.is_replicate() for pl in p.placements)
        for p in tree_leaves(state["params"])))
    res["train:fsdp_differs"] = np.array(sum(
        tuple(a) != tuple(p.placements) for a, p in zip(
            tree_leaves(fsdp), tree_leaves(state["params"]))))


def _rank(rank, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/store",
                            rank=rank, world_size=WORLD)
    inp = dict(np.load(os.path.join(out_dir, "inputs.npz")))
    res: dict = {}
    _collectives(rank, inp, res)
    _spmd(rank, inp, res)
    _moe(rank, inp, res)
    _flash(rank, inp, res)
    _train(rank, inp, res)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    out = sys.argv[1]
    mp.spawn(_rank, args=(out,), nprocs=WORLD)
    print("MULTIRANK_OK")
