"""Train step assembly (``repro.train.trainer``): microbatched gradient
accumulation + AdamW, on one device (default CUDA).

``make_train_step`` builds the step:

* the global batch splits into ``cfg.num_microbatches`` microbatches along
  the batch dim (the reference's ``reshape(n, b // n, ...)``); each runs
  ``(loss / n).backward()``, which accumulates its f32 gradient into the
  ``.grad`` of the f32 master weights; with per-group remat inside the
  model (``cfg.remat``) the live activations are one microbatch's,
  whatever the global batch;
* the loss is averaged over the microbatches, then one ``adamw_update``
  runs in place and the gradients are dropped (``grad = None``).

Parameters live in the training storage (``init_params(..., master=True)``:
every leaf in ``cfg.param_dtype``) and never require grad themselves.  For
each step the trainer hands the model aliases of them that do: leaves
stacked over groups (``params["groups"]``, whisper's encoder layers)
become one alias per layer, so each layer's gradient lands in its slice of
the master's ``.grad`` in place.  Autograd's backward of a slice of one
stacked leaf would write a zero-filled gradient of the whole stack per
layer (32 x the stack's bytes per microbatch at stablelm-3b's depth).

On a mesh (the caller installs ``sharding.axes.axis_rules(mesh)`` and
lays the masters out as DTensors, e.g. by ``sharding_tree`` of
``params_axes()``), each microbatch is laid out as ``("batch", "seq")``
from the replicated global batch (a local slice, no collective), or, where
the batch arrives as DTensors, split from each rank's own rows; and the
gradient accumulators are created in ``grad_shardings``' placements (the
reference's FSDP layout of the f32 accumulator; default: each master's
own).  A layer's alias then gets no ``.grad`` of its own: a hook takes
the gradient autograd delivers (a ``Partial`` sum from a sharded matmul,
or any other placement), redistributes it to the accumulator's placements
and adds it to the accumulator's local shard, so every microbatch's
gradient lands in the pinned layout, not in one that autograd's
``AccumulateGrad`` would pick.  ``adamw_update`` then runs on DTensors.

With ``perf_flags.FLAGS["bf16_weight_gather"]`` (off by default) the step
casts the floating aliases to ``cfg.dtype`` once per microbatch before the
forward, so on a mesh every weight gather moves bf16; gradients flow back
to the f32 accumulators through the cast.

The compiled step, the counterpart of the reference's
``jax.jit(make_train_step(...))`` (``Trainer._step_fn``): on the card each
step signature (the tree paths, shapes and dtypes of every state leaf and
batch key, as jax keys its cache by the inputs' avals) is captured once as
a CUDA graph, forward, backward and AdamW, and replayed from then on.  The
batch goes into static device buffers of the signature first (through a
fresh pinned buffer each step); the first dispatch of a signature runs
eagerly on them (the warm-up, and the step's result), then the capture on
a stream of its own into the trainer's graph pool.  A graph writes the
state it was captured on, so the graphs are kept for one state (the
identity of its leaves): a new one (``Checkpointer.restore``'s) drops them
and their pool and is captured anew.  Metrics come back as copies made
after the replay.  A capture or replay that fails raises; nothing falls
back to the eager step.  ``_eager_steps()`` runs the eager step on the card
instead (``jax.disable_jit``'s counterpart); the CPU always does, and so
does a state or batch of DTensors (a mesh: its NCCL step is not captured).
Python-level choices inside the step (``perf_flags.FLAGS``) are taken at
capture, as jax takes them at trace time.

``Trainer.run`` records a span per step for the wait for the batch
(``train.data``), the step (``train.step``: input load, replay or
capture) and the metrics' read-back (``train.metrics``, which waits for
the step on the card); see ``repro_torch.obs``.

The reference names a ``compressed_dp`` mode only in docstrings
(``repro/train/trainer.py:11-13``, ``sharding/gradient_compression.py``);
its ``make_train_step`` has no such mode, so the port adds none.  The
int8 all-reduce is ``sharding.gradient_compression.compressed_all_reduce``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import time
import weakref
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch import obs, resolve_device
from repro_torch.kernels import build
from repro_torch.models.loops import counted_range
from repro_torch.sharding.axes import is_dtensor

from .optim import (AdamWConfig, adamw_init, adamw_update, tree_items,
                    tree_leaves, tree_map)

TrainState = Dict[str, Any]  # {"params", "opt"}

#: subtrees whose leaves stack layers along dim 0 (``index_tree`` slices
#: them per layer in the model)
_STACKED = (("groups",), ("encoder", "layers"))


def init_train_state(model, generator: torch.Generator, opt_cfg: AdamWConfig,
                     device=None) -> TrainState:
    """Seeded master weights on ``device`` (default CUDA) and fresh AdamW
    state."""
    params = model.init(generator, device=device, master=True)
    return {"params": params, "opt": adamw_init(params)}


def _split_microbatches(batch: Dict[str, torch.Tensor], n: int
                        ) -> List[Dict[str, torch.Tensor]]:
    def split(x):
        b = x.shape[0]
        assert b % n == 0, (b, n)
        if is_dtensor(x):
            return _split_local(x, n)
        return x.reshape(n, b // n, *x.shape[1:])

    parts = {k: split(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def _split_local(x, n: int) -> list:
    """A batch DTensor laid out by its caller (the dry run's cells, as the
    reference's ``in_shardings`` lay out its batch) split into ``n``
    microbatch DTensors of the same placements: each rank splits its own
    rows, so no rows move between ranks."""
    from torch.distributed.tensor import DTensor

    local = x.to_local()
    parts = local.reshape(n, local.shape[0] // n, *local.shape[1:])
    shape = (x.shape[0] // n,) + tuple(x.shape[1:])
    return [DTensor.from_local(parts[i], x.device_mesh, x.placements,
                               run_check=False, shape=shape,
                               stride=torch.empty(shape,
                                                  device="meta").stride())
            for i in range(n)]


def _alias(leaf: torch.Tensor, stacked: bool):
    """Leaves requiring grad that share ``leaf``'s storage, their gradient
    the matching part of ``leaf.grad``: one per layer if ``stacked``."""
    if not stacked:
        return _one(leaf, leaf.grad, None)
    return [_one(leaf[i], leaf.grad, i) for i in range(leaf.shape[0])]


def _one(view: torch.Tensor, acc: torch.Tensor, index) -> torch.Tensor:
    """An alias of ``view`` requiring grad whose gradient lands in ``acc``
    (at layer ``index`` of a stacked leaf): as its ``.grad`` for a plain
    tensor, through :func:`_accumulate` for a DTensor."""
    out = view.detach().requires_grad_()
    if is_dtensor(acc):
        out.register_post_accumulate_grad_hook(
            functools.partial(_accumulate, acc, index))
    else:
        out.grad = acc if index is None else acc[index]
    return out


def _accumulate(acc, index, alias: torch.Tensor) -> None:
    """Add the gradient autograd left in ``alias.grad`` to the DTensor
    accumulator ``acc`` (its layer ``index`` where stacked) in ``acc``'s
    placements, on ``acc``'s local shard, and drop it.  A layer of a stack
    sharded along the layers dim lands on the ranks that hold it."""
    from torch.distributed.tensor import Replicate, Shard

    g, alias.grad = alias.grad, None
    mesh, local = acc.device_mesh, acc.to_local()
    with torch.no_grad():
        if index is None:
            local.add_(g.redistribute(mesh, acc.placements).to_local())
            return
        # the layer's placements: acc's, one dim down, with the layers dim
        # itself replicated
        want = [Replicate() if p == Shard(0)
                else Shard(p.dim - 1) if isinstance(p, Shard) else p
                for p in acc.placements]
        g = g.redistribute(mesh, want).to_local()
        # this rank's layers [start, start + size): torch.chunk's split,
        # mesh dims major to minor, as DTensor shards a dim
        start, size = 0, acc.shape[0]
        for i, (p, c) in enumerate(zip(acc.placements,
                                       mesh.get_coordinate())):
            if p == Shard(0):
                chunk = -(-size // mesh.size(i))
                start += c * chunk
                size = max(0, min(chunk, size - c * chunk))
        if size != local.shape[0]:
            raise RuntimeError(f"layer shard {size} != local {local.shape}")
        if start <= index < start + size:
            local[index - start].add_(g)


def _zeros_in(leaf: torch.Tensor, placements) -> torch.Tensor:
    """The zero gradient accumulator of ``leaf``, in ``leaf``'s dtype and,
    where ``leaf`` is a DTensor, in ``placements`` (or ``leaf``'s own)."""
    if not is_dtensor(leaf):
        return torch.zeros_like(leaf)
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    # on the local tensor's device (``meta`` in a dry run), not the mesh's
    mesh, placements = leaf.device_mesh, placements or leaf.placements
    local, _ = compute_local_shape_and_global_offset(leaf.shape, mesh,
                                                     placements)
    zeros = torch.zeros(local, dtype=leaf.dtype,
                        device=leaf.to_local().device)
    return DTensor.from_local(zeros, mesh, placements, run_check=False,
                              shape=leaf.shape, stride=leaf.stride())


def bind_grads(params: Any, grad_shardings: Optional[Any] = None) -> Any:
    """Zero ``.grad`` on every master leaf (in ``grad_shardings``' DTensor
    placements where given) and return the tree of aliases the model
    differentiates (see the module docstring)."""
    def walk(tree, pl, path):
        if isinstance(tree, dict):
            return {k: walk(v, None if pl is None else pl[k], path + (k,))
                    for k, v in tree.items()}
        tree.grad = _zeros_in(tree, pl)
        return _alias(tree, any(path[:len(s)] == s for s in _STACKED))

    return walk(params, grad_shardings, ())


def _cast_floating(tree, dtype):
    """Aliases (tensors, or lists of per-layer aliases) cast to ``dtype``
    where floating: a differentiable cast."""
    if isinstance(tree, dict):
        return {k: _cast_floating(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast_floating(v, dtype) for v in tree]
    return tree.to(dtype) if tree.is_floating_point() else tree


def _lay_out(mb: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A microbatch as DTensors in the ``("batch", "seq")`` layout of the
    installed mesh (the global batch is the same on every rank, so the
    sharded dims are local slices); itself without a mesh."""
    from repro_torch.sharding.axes import (current_mesh, logical_to_spec,
                                           rewrap, spec_to_placements)

    mesh = current_mesh()
    if mesh is None:
        return mb
    out = {}
    for key, x in mb.items():
        names = ("batch", "seq")[:x.ndim] + (None,) * (x.ndim - 2)
        want = spec_to_placements(logical_to_spec(names, x.shape, mesh), mesh)
        x = x if is_dtensor(x) else rewrap(x, mesh)
        out[key] = x.redistribute(mesh, want)
    return out


def _to_device(batch, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def make_train_step(model, opt_cfg: AdamWConfig,
                    grad_shardings: Optional[Any] = None
                    ) -> Callable[[TrainState, Dict[str, Any]], Any]:
    """The step: ``train_step(state, batch) -> (state, metrics)``.  The
    batch (NumPy arrays or tensors) moves to the parameters' device; the
    state is updated in place and returned; metrics ``loss``, ``lr`` and
    ``grad_norm`` are device tensors.  ``grad_shardings``: a tree of DTensor
    placements (``sharding.axes.sharding_tree``) the f32 gradient
    accumulators of DTensor masters are pinned to."""
    from repro_torch.models.perf_flags import FLAGS

    cfg = model.cfg

    def train_step(state: TrainState, batch: Dict[str, Any]):
        params = state["params"]
        device = tree_leaves(params)[0].device
        n = cfg.num_microbatches
        live = bind_grads(params, grad_shardings)
        loss = torch.zeros((), dtype=torch.float32, device=device)
        mbs = _split_microbatches(_to_device(batch, device), n)
        for i in counted_range(n, loss):
            mb = mbs[i]
            used = (_cast_floating(live, cfg.dtype)
                    if FLAGS["bf16_weight_gather"] else live)
            mb_loss = model.loss(used, _lay_out(mb))
            (mb_loss / n).backward()
            if is_dtensor(mb_loss):
                mb_loss = mb_loss.full_tensor()
            loss += mb_loss.detach() / n
        grads = tree_map(lambda p: p.grad, params)
        _, _, metrics = adamw_update(opt_cfg, params, grads, state["opt"])
        for p in tree_leaves(params):
            p.grad = None
        metrics["loss"] = loss
        return state, metrics

    return train_step


#: the card runs the eager step inside it (``kernels.build.eager_steps``,
#: which the serving engine's steps follow too)
_eager_steps = build.eager_steps


def _as_tensor(x):
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


def _signature(state: TrainState, batch: Dict[str, torch.Tensor]) -> tuple:
    """The key of a step: the tree path, shape and dtype of every state
    leaf and batch key (jax's cache key, the inputs' avals)."""
    return (tuple((path, tuple(x.shape), x.dtype)
                  for path, x in tree_items(state)),
            tuple((k, tuple(v.shape), v.dtype)
                  for k, v in sorted(batch.items())))


class _StaticBatch:
    """A compiled step's batch: one device buffer per key, at its shape and
    dtype, that the graph reads.  ``load`` copies one step's batch in on
    the current stream, a host array through a fresh pinned buffer (a copy
    still queued for an earlier step never reads a buffer refilled for a
    later one)."""

    def __init__(self, batch: Dict[str, torch.Tensor], device):
        self.tensors = {k: torch.empty(v.shape, dtype=v.dtype, device=device)
                        for k, v in batch.items()}

    def load(self, batch: Dict[str, torch.Tensor]) -> None:
        for k, dst in self.tensors.items():
            src = batch[k]
            if src.shape != dst.shape or src.dtype != dst.dtype:
                raise ValueError(f"batch key {k!r} of {src.dtype} "
                                 f"{tuple(src.shape)}: the graph was captured "
                                 f"for {dst.dtype} {tuple(dst.shape)}")
            if dst.is_cuda and not src.is_cuda:
                host = torch.empty(src.shape, dtype=src.dtype,
                                   pin_memory=True)
                src = host.copy_(src)
            dst.copy_(src, non_blocking=True)


class _Graph:
    """One captured step: the graph, its static batch and metrics, and the
    launches its capture tallied (added at each replay)."""

    __slots__ = ("graph", "inputs", "metrics", "tally")

    def __init__(self, graph, inputs, metrics, tally):
        self.graph, self.inputs = graph, inputs
        self.metrics, self.tally = metrics, tally


class _CompiledStep:
    """``make_train_step``'s step compiled as the reference's ``jax.jit`` of
    it is (see the module docstring): ``(state, batch) -> (state,
    metrics)``; ``_cache_size()`` counts the signatures dispatched, as
    jax's jitted function does."""

    def __init__(self, step: Callable, device: torch.device):
        self._step = step
        self._device = device
        self._keys: set = set()
        self._graphs: Dict[tuple, _Graph] = {}
        self._state: Optional[list] = None  # (weakref, data_ptr) per leaf
        self._pool = None
        self._stream = None
        self.capture_seconds = 0.0

    def _cache_size(self) -> int:
        return len(self._keys)

    def __call__(self, state: TrainState, batch: Dict[str, Any]):
        tensors = {k: _as_tensor(v) for k, v in batch.items()}
        key = _signature(state, tensors)
        self._keys.add(key)
        leaves = tree_leaves(state)
        if (self._device.type != "cuda" or build.eager()
                or any(map(is_dtensor, leaves + list(tensors.values())))):
            return self._step(state, batch)
        if not self._captured_on(leaves):
            self._graphs.clear()  # they write the old state's storage
            self._pool = None
            self._state = [(weakref.ref(x), x.data_ptr()) for x in leaves]
        graph = self._graphs.get(key)
        if graph is None:
            return self._capture(key, state, tensors)
        graph.inputs.load(tensors)
        graph.graph.replay()
        graph.tally.replay()
        return state, {k: v.clone() for k, v in graph.metrics.items()}

    def _captured_on(self, leaves: list) -> bool:
        """Whether ``leaves`` are the tensors, at the storage, the graphs
        were captured on."""
        return (self._state is not None and len(self._state) == len(leaves)
                and all(ref() is x and ptr == x.data_ptr()
                        for (ref, ptr), x in zip(self._state, leaves)))

    def _capture(self, key: tuple, state: TrainState,
                 batch: Dict[str, torch.Tensor]):
        """The first dispatch of ``key`` on this state: the eager step on the
        static batch on the capture stream (its result is the step's; it
        also sets up what a capture must not: the kernel library, cuBLAS's
        workspaces for the stream), then the capture into the graph pool
        with the cached blocks of the warm-up returned to the card first.
        Launches in the capture are tallied, those autograd's device thread
        makes for it too (``build.capturing(stream)``); each replay adds
        the tally."""
        dev = self._device
        inputs = _StaticBatch(batch, dev)
        inputs.load(batch)
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=dev)
        stream, current = self._stream, torch.cuda.current_stream(dev)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            state, metrics = self._step(state, inputs.tensors)
        current.wait_stream(stream)
        for v in metrics.values():
            v.record_stream(current)
        t0 = time.perf_counter()
        torch.cuda.synchronize(dev)
        gc.collect()
        torch.cuda.empty_cache()
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        g = torch.cuda.CUDAGraph()
        with build.capturing(stream) as tally, torch.cuda.stream(stream):
            g.capture_begin(pool=self._pool, capture_error_mode="thread_local")
            try:
                _, static = self._step(state, inputs.tensors)
            except BaseException:
                with contextlib.suppress(Exception):
                    g.capture_end()  # ends the capture; the step's error
                raise                # is the one to report
            g.capture_end()
        current.wait_stream(stream)
        self._graphs[key] = _Graph(g, inputs, static, tally)
        self.capture_seconds += time.perf_counter() - t0
        return state, metrics


@dataclasses.dataclass
class Trainer:
    """Minimal driver used by the CLI and the fault-tolerance drill.  Its
    step (``_step_fn``) is the compiled one (the module docstring): on the
    card one CUDA graph per step signature, replayed; on the CPU, and for
    DTensor states, the eager ``make_train_step``."""

    model: Any
    opt_cfg: AdamWConfig
    checkpointer: Optional[Any] = None  # train.checkpoint.Checkpointer
    checkpoint_every: int = 0
    device: Any = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self._step_fn = _CompiledStep(
            make_train_step(self.model, self.opt_cfg), self.device)

    def init(self, generator: torch.Generator) -> TrainState:
        return init_train_state(self.model, generator, self.opt_cfg,
                                device=self.device)

    def run(self, state: TrainState, batches, *, steps: int,
            on_metrics: Optional[Callable[[int, dict], None]] = None
            ) -> TrainState:
        it = iter(batches)
        start = int(state["opt"]["step"])
        for i in range(start, start + steps):
            with obs.span("train.data"):
                batch = next(it)
            with obs.span("train.step"):
                state, metrics = self._step_fn(state, batch)
            if on_metrics is not None:
                with obs.span("train.metrics"):
                    values = {k: float(v) for k, v in metrics.items()}
                on_metrics(i + 1, values)
            if (self.checkpointer is not None and self.checkpoint_every
                    and (i + 1) % self.checkpoint_every == 0):
                self.checkpointer.save(int(state["opt"]["step"]), state)
        return state
