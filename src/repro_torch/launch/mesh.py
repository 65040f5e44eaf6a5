"""Production mesh definition (``repro.launch.mesh``), as a ``DeviceMesh``
(a FUNCTION — importing this module touches no process group).

Single pod: (16, 16) = 256 devices, axes ("data", "model").
Multi-pod: (2, 16, 16) = 512 devices, axes ("pod", "data", "model") — the
"pod" axis composes with "data" for DP (the batch logical axis maps to
("pod", "data")).

A production mesh needs a ``torch.distributed`` process group of at least
its size, which the caller starts (``torchrun``, or
``init_process_group`` with an explicit address, world size and rank).
:func:`make_smoke_mesh` is the 1x1 mesh with the production axis names;
where no group is open it starts a one-rank group itself.  Spec
resolution (``sharding.axes.logical_to_spec``) needs no devices: it reads
the axis sizes alone (:data:`PRODUCTION_SHAPES`).
"""

from __future__ import annotations

import math
import os
import tempfile

#: axis name -> size of the two production meshes
PRODUCTION_SHAPES = {
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
}


def make_production_mesh(*, multi_pod: bool = False):
    """The (16, 16) or (2, 16, 16) CUDA mesh over the running process
    group's first 256 or 512 ranks; raises when the world is smaller."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    sizes = PRODUCTION_SHAPES["2x16x16" if multi_pod else "16x16"]
    shape, axes = tuple(sizes.values()), tuple(sizes)
    need = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < need:
        raise RuntimeError(
            f"need {need} ranks for mesh {shape}; have {have}. Start a "
            "process group of that size first; resolving specs needs only "
            "PRODUCTION_SHAPES.")
    # one world serves both meshes: the single-pod mesh takes the first 256
    return DeviceMesh("cuda", torch.arange(need).reshape(shape),
                      mesh_dim_names=axes)


def make_smoke_mesh(device):
    """1x1 mesh with the production axis names on ``device``.  Where no
    process group is open it starts a one-rank one on a ``FileStore`` under
    the temporary directory: NCCL for a CUDA device, gloo for the CPU (the
    caller destroys it).  An open group must have one rank and the
    device's backend: a CUDA mesh never runs on gloo."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dev = torch.device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        fd, path = tempfile.mkstemp(prefix="repro_torch_pg_")
        os.close(fd)
        os.unlink(path)  # the FileStore creates it, and removes it at exit
        dist.init_process_group(backend, store=dist.FileStore(path, 1),
                                rank=0, world_size=1)
    elif backend not in dist.get_backend() or dist.get_world_size() != 1:
        raise RuntimeError(
            f"a 1x1 mesh on {dev} needs a one-rank {backend} group; the open "
            f"group is {dist.get_backend()} with {dist.get_world_size()} "
            "ranks")
    return init_device_mesh(dev.type, (1, 1),
                            mesh_dim_names=("data", "model"))
