"""Per-device analysis of the dispatched aten-op stream of a step (there is
no HLO): the dry run's "profile" (``repro.launch.hlo_analysis``).

``analyze(step, *args)`` runs ``step(*args)`` once, on meta tensors or
meta DTensors in a dry run, under a ``TorchDispatchMode`` that counts what
one device executes:

1. flops: each op that ``torch.utils.flop_counter`` has a formula for
   (matmuls, convolutions and the fused attention ops), by that formula;
   the reference counts dots (and convolutions) alone;
2. bytes: output + operand bytes of every op that is not a view.  Eager
   runs each op on its own, so this exceeds the reference's figure, which
   charges each fused XLA instruction once;
3. collectives: every ``_c10d_functional`` collective, per kind its count,
   its bytes (the larger of input and result), the ring-model wire bytes
   of its group (``roofline.wire_bytes``), and the count of those that
   reduce a product's output by element type (``product_dtypes``, keyed
   by HLO's names ``f32``, ``bf16``, ...: the collective's input storage
   was made by a matmul, as the reference's ``all-reduce(%dot)``'s
   operand is a dot);
4. memory: the storages live at once, arguments included, from a tracker
   that adds a storage at the op that creates it and drops it when it is
   freed.

**Per device.**  The mode sees a DTensor op at its global shape; it lets
DTensor dispatch it (returns ``NotImplemented``), and counts the local ops
DTensor then runs on this rank's shards, the collectives of its
redistributions among them.  The ops DTensor's sharding propagation runs at
the global shape on fake tensors are not counted.

Python loops run in eager, so every trip is counted and there is no
``missing_trip_counts`` to report (the reference's counts how many while
loops had no known trip count).  On meta tensors the model's loops of
equal trips (the plain attention's chunk walks, the mLSTM's chunks, the
sLSTM's steps) run one trip, which counts as many times as the loop has
trips, its gradient too (``models.loops``).  The list of per-trip outputs
such a loop keeps holds one trip's storage, so the peak omits the others'.
"""

from __future__ import annotations

import weakref
from typing import Any, Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.models import loops

from .roofline import COLLECTIVE_KINDS, wire_bytes

#: ``_c10d_functional`` op name -> the reference's collective kind
_COLLECTIVE_OPS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
}


#: the ops whose output a product's all-reduce sums
_PRODUCTS = (torch.ops.aten.mm, torch.ops.aten.bmm, torch.ops.aten.addmm,
             torch.ops.aten.baddbmm)
_FAKE = torch._C._TorchDispatchModeKey.FAKE
#: allocations: they move no bytes
_ALLOCS = (torch.ops.aten.empty, torch.ops.aten.empty_like,
           torch.ops.aten.empty_strided, torch.ops.aten.new_empty)
_PLAIN = torch.Tensor.__torch_dispatch__


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard, else ``t``."""
    to_local = getattr(t, "to_local", None)
    return to_local() if to_local is not None else t


def hlo_dtype(dtype: torch.dtype) -> str:
    """HLO's name of an element type (``f32``, ``bf16``, ``s32``, ...)."""
    if dtype == torch.bool:
        return "pred"
    kind = ("bf" if dtype == torch.bfloat16 else "f" if dtype.is_floating_point
            else "s" if dtype.is_signed else "u")
    return f"{kind}{dtype.itemsize * 8}"


def _group_size(args) -> int:
    """Size of the process group a functional collective names (its last
    string argument; a reduce op's name comes before it)."""
    from torch.distributed.distributed_c10d import _resolve_process_group

    name = [a for a in args if isinstance(a, str)][-1]
    return _resolve_process_group(name).size()


class _LiveStorages:
    """Bytes of the distinct storages alive at once, and their peak; the op
    that made each."""

    def __init__(self):
        self.live: Dict[int, int] = {}
        self.maker: Dict[int, Any] = {}
        self.now = 0
        self.peak = 0

    def add(self, t: torch.Tensor, maker=None) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self.live:
            return
        self.live[key] = st.nbytes()
        self.maker[key] = maker
        self.now += self.live[key]
        self.peak = max(self.peak, self.now)
        weakref.finalize(st, self._drop, key)

    def made_by(self, t: torch.Tensor):
        return self.maker.get(t.untyped_storage()._cdata)

    def _drop(self, key: int) -> None:
        self.now -= self.live.pop(key, 0)
        self.maker.pop(key, None)


class _Counter(TorchDispatchMode):
    def __init__(self, storages: _LiveStorages, trips: loops.Trips):
        super().__init__()
        self.trips = trips
        from torch.utils.flop_counter import flop_registry

        self.formulas = flop_registry
        self.storages = storages
        self.flops = 0
        self.bytes = 0
        self.collectives = {k: {"count": 0, "result_bytes": 0,
                                "wire_bytes": 0.0, "product_dtypes": {}}
                            for k in COLLECTIVE_KINDS}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if torch._C._get_dispatch_mode(_FAKE) is not None:
            # DTensor's sharding propagation, at the global shape under a
            # FakeTensorMode
            return func(*args, **kwargs)
        if any(t.__torch_dispatch__ is not _PLAIN for t in types):
            # a tensor subclass (DTensor, a collective's wrapper) first
            # dispatches to its local ops, which come back here
            return NotImplemented
        out = func(*args, **kwargs)
        outs = _tensors(out)
        for t in outs:
            self.storages.add(t, func.overloadpacket)
        n = self.trips.factor()
        formula = self.formulas.get(func.overloadpacket)
        if formula is not None:
            if func.overloadpacket in _PRODUCTS and \
                    func._overloadname == "dtype":
                # a product with another output dtype: its formula takes
                # the operands alone
                args, kwargs = args[:2], {}
            self.flops += n * formula(*args, **kwargs, out_val=out)
        ins = _tensors((args, kwargs))
        if func.namespace == "_c10d_functional":
            kind = _COLLECTIVE_OPS.get(func._opname)
            if kind is not None:
                size = max(sum(map(_nbytes, ins)), sum(map(_nbytes, outs)))
                rec = self.collectives[kind]
                rec["count"] += n
                rec["result_bytes"] += n * size
                rec["wire_bytes"] += n * wire_bytes(kind, size,
                                                    _group_size(args))
                if self.storages.made_by(ins[0]) in _PRODUCTS:
                    per, name = rec["product_dtypes"], hlo_dtype(outs[0].dtype)
                    per[name] = per.get(name, 0) + n
        elif not func.is_view and func.overloadpacket not in _ALLOCS:
            self.bytes += n * (sum(map(_nbytes, ins))
                               + sum(map(_nbytes, outs)))
        return out


def argument_bytes(*args: Any) -> int:
    """Bytes of the distinct storages of ``args``' tensors on this device
    (a DTensor's local shard)."""
    seen: Dict[int, int] = {}
    for t in _tensors(args):
        st = _local(t).untyped_storage()
        seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def analyze(step: Callable, *args: Any) -> Dict[str, Any]:
    """Run ``step(*args)`` once and count one device's work (module
    docstring).  Returns ``flops_per_device``, ``bytes_per_device``,
    ``collectives`` (per kind ``count``, ``result_bytes``, ``wire_bytes``,
    ``product_dtypes``)
    and ``memory`` (``argument_bytes``, ``peak_bytes`` and, under the
    reference's name, ``live_bytes_per_device``: the peak of the storages
    live at once, arguments included)."""
    storages = _LiveStorages()
    for t in _tensors(args):
        storages.add(_local(t))
    with loops.counting() as trips, _Counter(storages, trips) as counter:
        out = step(*args)
        del out
    return {
        "flops_per_device": float(counter.flops),
        "bytes_per_device": float(counter.bytes),
        "collectives": counter.collectives,
        "memory": {"argument_bytes": argument_bytes(*args),
                   "peak_bytes": storages.peak,
                   "live_bytes_per_device": storages.peak},
    }
