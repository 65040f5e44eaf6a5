"""Four gloo ranks on the CPU for ``tests/test_torch_tp_numerics.py``.

Run as ``python tests/torch_tp_worker.py <dir>``: reads
``<dir>/inputs.npz`` (written by the test), spawns four ranks joined by a
``FileStore`` under ``<dir>`` on a (2, 2) ("data", "model") mesh and writes
``<dir>/rank<r>.npz``; prints ``TP_OK`` when every rank finished.

For each setting of ``perf_flags.bf16_collective_matmul`` it runs three bf16
products whose sums cross the mesh, through the port's own entry points:

* ``row``: a row-parallel ``layers.matmul``, x (B, S, K) on (Shard(0),
  Shard(2)), w (K, N) on (Replicate(), Shard(0)): the contraction shards
  over "model";
* ``col_dx``: the input gradient of a column-parallel ``layers.matmul``, x
  on (Shard(0), Replicate()), w on (Replicate(), Shard(1)): the gradient's
  contraction shards over "model";
* ``moe``: the MoE expert product ``moe._experts`` in the expert-parallel
  layout, buf (G, E, C, d) on (Shard(0), Shard(1)), w (E, d, f) on
  (Replicate(), Shard(0)): its output and its weight gradient, whose sum
  over the groups' rows shards over "data".

Beside each, the same product as DTensor computes it by itself with bf16
partials (``torch.matmul`` / ``torch.bmm`` on the DTensors: the port's
path before the toggle existed), and rank 0 computes the one-device port's
result on plain tensors.
"""

import os
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 4


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16)


def _f32(t):
    t = t.detach()
    return (t.full_tensor() if hasattr(t, "full_tensor") else t
            ).float().numpy()


def _experts_dtensor_bf16(buf, w):
    """The expert product as DTensor computes it on bf16 DTensors."""
    g, e, c, _ = buf.shape
    rows = buf.transpose(0, 1).reshape(e, g * c, buf.shape[3])
    out = torch.bmm(rows, w.to(buf.dtype))
    return out.reshape(e, g, c, out.shape[2]).transpose(0, 1)


def _products(inp, mesh, res, tag, flag):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.models import moe
    from repro_torch.models.layers import matmul
    from repro_torch.models.perf_flags import set_flags

    def dt(a, placements, grad=False):
        t = distribute_tensor(_bf16(a), mesh, placements)
        return t.requires_grad_() if grad else t

    prev = set_flags(bf16_collective_matmul=flag)
    try:
        # row-parallel forward
        x = dt(inp["row_x"], [Shard(0), Shard(2)])
        w = dt(inp["row_w"], [Replicate(), Shard(0)])
        res[f"{tag}:row"] = _f32(matmul(x, w))
        res[f"{tag}:row_dtensor"] = _f32(torch.matmul(x, w))

        # column-parallel input gradient
        gout = dt(inp["col_g"], [Shard(0), Shard(2)])
        for name, fn in (("col_dx", matmul), ("col_dx_dtensor",
                                              torch.matmul)):
            x = dt(inp["col_x"], [Shard(0), Replicate()], grad=True)
            w = dt(inp["col_w"], [Replicate(), Shard(1)])
            y = fn(x, w)
            y.backward(gout)
            res[f"{tag}:{name}"] = _f32(x.grad)

        # the MoE expert product, forward and weight gradient
        g_out = dt(inp["moe_g"], [Shard(0), Shard(1)])
        for name, fn in (("moe", moe._experts),
                         ("moe_dtensor", _experts_dtensor_bf16)):
            buf = dt(inp["moe_buf"], [Shard(0), Shard(1)])
            w = distribute_tensor(torch.from_numpy(inp["moe_w"]), mesh,
                                  [Replicate(), Shard(0)]).requires_grad_()
            out = fn(buf, w)
            res[f"{tag}:{name}"] = _f32(out)
            res[f"{tag}:{name}_dtype"] = np.array(str(out.dtype))
            out.backward(g_out.to(out.dtype))
            res[f"{tag}:{name}_dw"] = _f32(w.grad)
    finally:
        set_flags(**prev)


def _one_device(inp, res):
    """The one-device port on plain tensors (flag off)."""
    from repro_torch.models import moe
    from repro_torch.models.layers import matmul

    res["one:row"] = _f32(matmul(_bf16(inp["row_x"]), _bf16(inp["row_w"])))
    x = _bf16(inp["col_x"]).requires_grad_()
    matmul(x, _bf16(inp["col_w"])).backward(_bf16(inp["col_g"]))
    res["one:col_dx"] = _f32(x.grad)
    w = torch.from_numpy(inp["moe_w"]).requires_grad_()
    out = moe._experts(_bf16(inp["moe_buf"]), w)
    out.backward(_bf16(inp["moe_g"]).float())
    res["one:moe"] = _f32(out)
    res["one:moe_dw"] = _f32(w.grad)


def _rank(rank, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/store",
                            rank=rank, world_size=WORLD)
    from torch.distributed.device_mesh import init_device_mesh

    inp = dict(np.load(os.path.join(out_dir, "inputs.npz")))
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    res: dict = {}
    _products(inp, mesh, res, "off", False)
    _products(inp, mesh, res, "on", True)
    if rank == 0:
        _one_device(inp, res)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    out = sys.argv[1]
    mp.spawn(_rank, args=(out,), nprocs=WORLD)
    print("TP_OK")
