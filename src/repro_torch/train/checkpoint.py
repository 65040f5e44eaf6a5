"""Async checkpointing with WFE-reclaimed snapshot generations.

This is DESIGN.md §2.1(B): the trainer keeps multiple *generations* of
host-side snapshot buffers alive — the writer thread drains generation g
while the train loop already produced g+1.  Generations are era-stamped WFE
blocks: the writer protects the generation it reads (``get_protected``),
the trainer retires superseded generations, and WFE's wait-freedom
guarantees the trainer is never blocked by a slow writer (the paper's
stalled-thread scenario: a hung writer bounds memory at
max_hes·generations, it does not grow unboundedly nor stall training).

Format: one .npz per snapshot + manifest.json {step, file, leaf paths,
checksum}; restore validates the checksum and returns the pytree.

The port's copy (of ``repro.train.checkpoint``).  Its state is updated in
place by the next step, so ``save`` takes the snapshot as a synchronous
host copy of every leaf before it returns (the reference's
``_flatten_state`` copies with ``np.asarray`` the same way); the writer
thread then only does I/O.  Leaf paths are the reference's key strings in
its order (sorted keys, ``['params']['embed']['table']``) and the arrays
and checksum are the same bytes, so a checkpoint written by either
package restores into the other's state.  ``restore`` puts each leaf back
on the device and dtype of the matching leaf of ``like``.
"""

from __future__ import annotations

import hashlib
import json
import os
import queue
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import Block, make_scheme
from repro_torch.core.atomics import AtomicRef, PtrView

from .optim import tree_items

__all__ = ["Checkpointer", "SnapshotGeneration"]


class SnapshotGeneration(Block):
    """Era-stamped host snapshot (one training step's full state)."""

    __slots__ = ("step", "arrays")

    def __init__(self, step: int, arrays):
        super().__init__()
        self.step = step
        self.arrays = arrays  # list[(path, np.ndarray)]

    def _poison_payload(self) -> None:
        self.arrays = None


def keystr(path: Tuple[str, ...]) -> str:
    """``jax.tree_util.keystr`` of a dict key path: ``['a']['b']``."""
    return "".join(f"[{k!r}]" for k in path)


def _flatten_state(state: Any) -> List[Tuple[str, np.ndarray]]:
    """(key string, host copy) per leaf; the copy is taken now, so later
    in-place updates of the state do not reach the snapshot."""
    return [(keystr(path), torch.as_tensor(leaf).detach().to(
                "cpu", copy=True).numpy())
            for path, leaf in tree_items(state)]


def _unflatten(like: Any, leaves: List[Any]) -> Any:
    it = iter(leaves)

    def build(tree):
        if isinstance(tree, dict):
            return {k: build(tree[k]) for k in sorted(tree)}
        return next(it)

    return build(like)


def _checksum(arrays: List[Tuple[str, np.ndarray]]) -> str:
    h = hashlib.sha256()
    for path, a in arrays:
        h.update(path.encode())
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes()[:1 << 16])  # bounded: first 64KiB per leaf
    return h.hexdigest()


class Checkpointer:
    def __init__(self, directory: str, *, keep_last: int = 2,
                 max_threads: int = 4, sync: bool = False):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self.keep_last = keep_last
        self.sync = sync
        self.smr = make_scheme("WFE", max_threads=max_threads,
                               era_freq=1, cleanup_freq=1)
        self._train_tid = self.smr.register_thread()
        self._writer_tid = self.smr.register_thread()
        self._latest = AtomicRef(None)
        self._view = PtrView(self._latest)
        self._queue: "queue.Queue[Optional[int]]" = queue.Queue()
        self._errors: List[BaseException] = []
        self._writer = threading.Thread(target=self._writer_loop, daemon=True)
        if not sync:
            self._writer.start()

    # ----------------------------------------------------------- trainer side
    def save(self, step: int, state: Any) -> None:
        """Snapshot + hand off to the writer; never blocks on I/O."""
        arrays = _flatten_state(state)
        gen = self.smr.alloc_block(SnapshotGeneration, self._train_tid,
                                   step, arrays)
        old = self._latest.load()
        self._latest.store(gen)
        if old is not None:
            self.smr.retire(old, self._train_tid)  # superseded generation
        if self.sync:
            self._write_one(self._writer_tid)
        else:
            self._queue.put(step)

    def close(self) -> None:
        if not self.sync:
            self._queue.put(None)
            self._writer.join(timeout=60)
        if self._errors:
            raise self._errors[0]

    # ----------------------------------------------------------- writer side
    def _writer_loop(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                return
            try:
                self._write_one(self._writer_tid)
            except BaseException as e:  # pragma: no cover
                self._errors.append(e)

    def _write_one(self, tid: int) -> None:
        gen = self.smr.get_protected(self._view, 0, tid)
        if gen is None or gen.arrays is None:
            return
        arrays = gen.arrays
        step = gen.step
        payload = {f"a{i}": a for i, (_, a) in enumerate(arrays)}
        # name must end in .npz or np.savez appends the suffix itself
        tmp = os.path.join(self.dir, f".tmp_ckpt_{step:08d}.npz")
        final = os.path.join(self.dir, f"ckpt_{step:08d}.npz")
        np.savez(tmp, **payload)
        os.replace(tmp, final)
        manifest = {
            "step": step,
            "file": os.path.basename(final),
            "paths": [p for p, _ in arrays],
            "checksum": _checksum(arrays),
        }
        mtmp = os.path.join(self.dir, "manifest.json.tmp")
        with open(mtmp, "w") as f:
            json.dump(manifest, f)
        os.replace(mtmp, os.path.join(self.dir, "manifest.json"))
        self.smr.clear(tid)
        self.smr.flush(self._writer_tid)
        self._gc_old()

    def _gc_old(self) -> None:
        ckpts = sorted(f for f in os.listdir(self.dir)
                       if f.startswith("ckpt_") and f.endswith(".npz"))
        for f in ckpts[: -self.keep_last]:
            os.unlink(os.path.join(self.dir, f))

    # ----------------------------------------------------------- restore
    def latest_manifest(self) -> Optional[dict]:
        path = os.path.join(self.dir, "manifest.json")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    def restore(self, like: Any) -> Optional[Any]:
        """Restore into the structure of ``like``; None if no checkpoint."""
        man = self.latest_manifest()
        if man is None:
            return None
        data = np.load(os.path.join(self.dir, man["file"]))
        arrays = [data[f"a{i}"] for i in range(len(man["paths"]))]
        if _checksum(list(zip(man["paths"], arrays))) != man["checksum"]:
            raise IOError("checkpoint checksum mismatch")
        items = tree_items(like)
        assert len(items) == len(arrays), (len(items), len(arrays))
        paths = [keystr(p) for p, _ in items]
        if paths != man["paths"]:
            raise ValueError("checkpoint leaf paths differ from the state's")
        cast = [torch.from_numpy(np.asarray(a)).to(device=l.device,
                                                   dtype=l.dtype)
                for a, (_, l) in zip(arrays, items)]
        return _unflatten(like, cast)

    def unreclaimed_generations(self) -> int:
        return self.smr.unreclaimed()
