"""Distributed era clocks, host half: N shard clocks joined in one process.

Ported from ``repro.core.distributed_eras``.  A single F&A word does not
exist across SMR instances.  Instead each instance (a *shard* of the block
pool) advances a local monotone counter, and the global era is the
*maximum* over instances, merged periodically on the host
(:class:`ShardedEraDomain`).

Safety argument (HE/WFE invariant preserved): every block lives its whole
lifecycle — ``alloc_era`` stamp, ``retire_era`` stamp, reservation scan —
against ONE instance's clock, so the single-instance proof applies shard by
shard.  The merge only ever *advances* a lagging clock to the fleet maximum
(a monotone join): a reader's published reservation can then only LAG the
true global era, and the interval check ``alloc_era <= resv <= retire_era``
errs toward keeping blocks alive — lag delays reclamation, never enables
it.  Monotonicity of max-merge means eras never regress, so
``retire_era >= alloc_era`` stays true for every block.  Boundedness: each
instance's increments are bounded by its own alloc/retire activity exactly
as in the single-instance proof, and the merge adds no increments — it only
equalizes, so the fleet-wide clock spread after a merge is zero and between
merges is bounded by one merge period's worth of local activity.

The device half: :func:`merged_era` is an all-reduce MAX of the era over
a ``torch.distributed`` process group (the reference's ``pmax`` inside
``shard_map``); :meth:`DistributedEraClock.device_merge` and
:meth:`ShardedEraDomain.device_merge_all` fold its result into the local
clocks.  They import torch inside, so the host layer imports none.
"""

from __future__ import annotations

from typing import List

__all__ = ["merged_era", "DistributedEraClock", "ShardedEraDomain"]


def merged_era(local_era, group=None):
    """All-reduce MAX of per-rank era counters over ``group`` (None: the
    default group).  ``local_era`` is an int or a one-element tensor; the
    reduction runs on a one-element int64 tensor on the group's device
    (CUDA for NCCL, the CPU for gloo).  Returns the maximum as an int, or
    as a tensor of ``local_era``'s device when given one."""
    import torch
    import torch.distributed as dist

    if dist.get_backend(group) == "nccl":
        dev = torch.device("cuda", torch.cuda.current_device())
    else:
        dev = torch.device("cpu")
    t = torch.as_tensor(local_era).reshape(1).to(dev, torch.int64)
    if torch.is_tensor(local_era):
        t = t.clone()
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    if torch.is_tensor(local_era):
        return t.to(local_era.device)
    return int(t.item())


class DistributedEraClock:
    """One SMR instance's era clock with monotone max-merge.

    The local component is the instance's ordinary F&A counter (WFE/HE
    ``global_era``, EBR/IBR ``global_epoch`` — whatever ``era_clock()``
    exposes); ``merge`` folds in the freshest remote maximum and returns the
    merged value.  Schemes without a clock (HP, Leak) construct a clock
    whose ops are no-ops.
    """

    def __init__(self, smr) -> None:
        self.smr = smr
        self._clock = smr.era_clock()
        #: merges that actually advanced the local clock (telemetry)
        self.merged_in = 0

    @property
    def local(self) -> int:
        return self._clock.load() if self._clock is not None else 0

    def merge(self, remote_max: int) -> int:
        """Fold a remote era maximum into the local clock (monotone join).

        Uses CAS so concurrent local F&A increments are never lost; bounded
        retries (the clock only moves forward, so a failed CAS means
        someone else already advanced past ``remote_max``).
        """
        if self._clock is None:
            return 0
        while True:
            cur = self._clock.load()
            if remote_max <= cur:
                return cur
            if self._clock.cas(cur, remote_max):
                self.merged_in += 1
                return remote_max

    def device_merge(self, group=None) -> int:
        """Run the all-reduce MAX over ``group`` and merge the result.

        In production this rides on an existing step collective; here it is
        a standalone all-reduce of one int64."""
        return self.merge(merged_era(self.local, group))


class ShardedEraDomain:
    """Monotone max-merge across N shard clocks inside one process.

    The sharded block pool gives each shard its own SMR instance; this
    domain is the join of their clocks.  ``merge_all`` reads every local
    clock, takes the maximum, and folds it into each shard — the host-side
    analogue of the all-reduce-max.  Reads and merges are racy with
    concurrent local F&A increments, which is fine: a concurrent increment
    can only make some local clock LARGER than the maximum we computed, and
    ``merge`` never moves a clock backwards, so the join stays monotone.
    """

    def __init__(self, smrs) -> None:
        self.clocks: List[DistributedEraClock] = [
            DistributedEraClock(smr) for smr in smrs
        ]
        #: completed merge rounds (telemetry / tests)
        self.merges = 0

    @property
    def locals(self) -> List[int]:
        return [c.local for c in self.clocks]

    def spread(self) -> int:
        """Current max-min divergence across shard clocks (racy gauge)."""
        vals = self.locals
        return max(vals) - min(vals) if vals else 0

    def merge_all(self) -> int:
        """One merge round: every shard clock advances to the fleet max."""
        m = max(self.locals, default=0)
        for c in self.clocks:
            c.merge(m)
        self.merges += 1
        return m

    def device_merge_all(self, group=None) -> int:
        """Fold the cross-rank device maximum into every shard clock."""
        m = max((c.device_merge(group) for c in self.clocks), default=0)
        for c in self.clocks:
            c.merge(m)
        self.merges += 1
        return m

    def stats(self) -> dict:
        return {
            "era_merges": self.merges,
            "era_spread": self.spread(),
            "era_max": max(self.locals, default=0),
            "merged_in": sum(c.merged_in for c in self.clocks),
        }
