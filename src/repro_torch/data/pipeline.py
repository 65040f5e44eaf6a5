"""Synthetic tokenized LM data + background prefetch (``repro.data.pipeline``).

A copy of the reference, on the port's own WFE (``repro_torch.core``);
batches are NumPy arrays, bit-identical to the reference's for the same
(seed, step, host), and the trainer moves them to its device.

* ``SyntheticLMData`` — a deterministic token stream (hash-seeded per step,
  Zipf-ish marginals so losses are non-degenerate), sharded by host: each
  process materializes only its slice of the global batch.  Determinism by
  (seed, step) is what makes fault-tolerant *replay* exact: restore at step
  k simply re-seeds the stream at k.
* ``PrefetchingLoader`` — a background thread fills a bounded buffer of
  batch *generations*; consumed generations are retired through WFE
  (DESIGN.md §2.1(B)): a consumer still reading an old batch (e.g. an
  in-flight async step) cannot have it recycled under it, and a stalled
  consumer bounds — not grows — prefetch memory.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, Optional

import numpy as np

from repro_torch.core import Block, make_scheme
from repro_torch.core.atomics import AtomicRef, PtrView

__all__ = ["SyntheticLMData", "PrefetchingLoader"]


class SyntheticLMData:
    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 *, seed: int = 0, n_hosts: int = 1, host_id: int = 0,
                 extras: Optional[Dict[str, tuple]] = None):
        assert global_batch % n_hosts == 0
        self.vocab = vocab_size
        self.seq = seq_len
        self.local_batch = global_batch // n_hosts
        self.seed = seed
        self.host = host_id
        self.extras = extras or {}

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 31 + self.host)
        # Zipf-ish marginals: geometric mixture over the vocab
        z = rng.zipf(1.3, size=(self.local_batch, self.seq + 1))
        toks = (z % self.vocab).astype(np.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        for name, shape in self.extras.items():
            batch[name] = rng.standard_normal(
                (self.local_batch, *shape), dtype=np.float32) * 0.02
        return batch

    def stream(self, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1


class BatchGeneration(Block):
    """Era-stamped prefetched batch (WFE-managed host buffer)."""

    __slots__ = ("step", "batch")

    def __init__(self, step: int, batch):
        super().__init__()
        self.step = step
        self.batch = batch

    def _poison_payload(self) -> None:
        self.batch = None


class PrefetchingLoader:
    """Bounded background prefetch; WFE reclaims consumed generations."""

    def __init__(self, data: SyntheticLMData, *, depth: int = 2,
                 start_step: int = 0):
        self.data = data
        self.depth = depth
        self.smr = make_scheme("WFE", max_threads=2, era_freq=1,
                               cleanup_freq=1)
        self._producer_tid = self.smr.register_thread()
        self._consumer_tid = self.smr.register_thread()
        self._q: "queue.Queue[Optional[BatchGeneration]]" = queue.Queue(
            maxsize=depth)
        self._stop = threading.Event()
        self._current = AtomicRef(None)
        self._view = PtrView(self._current)
        self._thread = threading.Thread(
            target=self._produce, args=(start_step,), daemon=True)
        self._thread.start()

    def _produce(self, start_step: int) -> None:
        step = start_step
        while not self._stop.is_set():
            gen = self.smr.alloc_block(BatchGeneration, self._producer_tid,
                                       step, self.data.batch_at(step))
            while not self._stop.is_set():
                try:
                    self._q.put(gen, timeout=0.1)
                    step += 1
                    break
                except queue.Full:
                    continue
            else:
                self.smr.retire(gen, self._producer_tid)  # shutting down

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        gen = self._q.get()
        old = self._current.load()
        self._current.store(gen)
        # the consumer protects the generation it is handing out
        got = self.smr.get_protected(self._view, 0, self._consumer_tid)
        if old is not None:
            self.smr.retire(old, self._consumer_tid)
        assert got.batch is not None, "prefetch generation reclaimed early"
        return got.batch

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=10)
        self.smr.clear(self._consumer_tid)
        for _ in range(8):
            self.smr.flush(self._consumer_tid)
            self.smr.flush(self._producer_tid)

    def unreclaimed(self) -> int:
        return self.smr.unreclaimed()
