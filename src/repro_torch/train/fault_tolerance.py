"""Fault tolerance (``repro.train.fault_tolerance``): restart-from-manifest.

At 1000+ nodes, node failure is routine; the reference's contract:

* ``run_with_restarts`` — the driver loop: any step failure rolls back to
  the last durable manifest and resumes; training state (params, opt, data
  cursor = opt.step) is fully recoverable from the checkpoint;
* ``reshard_state`` — elastic scaling: re-lay-out an existing state pytree
  onto a NEW mesh (changed device count after failure or scale-up) by
  recomputing every leaf's NamedSharding from its logical axes and
  device_put'ing — legal whenever the new mesh divides the same dims, which
  the divisibility-fallback rules guarantee by construction;
* straggler mitigation on the data plane lives in the scheduler
  (deadline-based batch cutoff) — wait-free WFE operations make the cutoff
  a hard bound (no lock can be held by a stalled peer).

In the port, ``reshard_state`` recomputes every leaf's DTensor placements
on the new ``DeviceMesh`` (``sharding.axes.sharding_tree``): a plain tensor
is distributed, a DTensor on the same mesh redistributed, and a DTensor
on another mesh gathered to its full value and distributed anew.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Optional

__all__ = ["run_with_restarts", "reshard_state"]


def reshard_state(state: Any, axes_tree: Any, new_mesh) -> Any:
    """Re-lay-out ``state`` (nested dicts of tensors) for ``new_mesh``
    (elastic scale up/down); every leaf keeps its full value."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    from repro_torch.sharding.axes import sharding_tree
    from repro_torch.train.optim import tree_map

    placements = sharding_tree(state, axes_tree, new_mesh)

    def one(leaf, want):
        if isinstance(leaf, DTensor):
            if leaf.device_mesh == new_mesh:
                return leaf.redistribute(new_mesh, want)
            leaf = leaf.full_tensor()
        return distribute_tensor(leaf, new_mesh, want)

    return tree_map(one, state, placements)


def run_with_restarts(
    trainer,
    state: Any,
    batches_factory: Callable[[int], Iterable],
    *,
    total_steps: int,
    chunk: int = 10,
    max_restarts: int = 5,
    on_restart: Optional[Callable[[int, BaseException], None]] = None,
) -> Any:
    """Drive training to ``total_steps`` surviving up to ``max_restarts``
    failures; resumes from the checkpointer's latest manifest each time.

    ``batches_factory(step)`` must return a stream positioned at ``step``
    (the synthetic pipeline is seeded by step, so replay is exact).  The
    port updates the state in place: without a checkpoint, a failure
    inside a step retries from what that step had written.
    """
    ckpt = trainer.checkpointer
    restarts = 0
    while int(state["opt"]["step"]) < total_steps:
        start = int(state["opt"]["step"])
        todo = min(chunk, total_steps - start)
        try:
            state = trainer.run(state, batches_factory(start), steps=todo)
        except Exception as e:  # noqa: BLE001 — any step failure
            restarts += 1
            if restarts > max_restarts:
                raise
            if on_restart is not None:
                on_restart(restarts, e)
            restored = ckpt.restore(state) if ckpt is not None else None
            if restored is not None:
                state = restored
            # else: retry from the in-memory state (failure before 1st save)
    return state
