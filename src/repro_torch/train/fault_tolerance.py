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

The port has ``run_with_restarts``.  ``reshard_state`` re-lays a state out
on a device mesh through the reference's ``sharding/axes.py``; the port has
no mesh yet, so it waits for the port's sharding (ROADMAP Queue 1 item 5).
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Optional

__all__ = ["run_with_restarts"]


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
