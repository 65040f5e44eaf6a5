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

The reference's device half — ``merged_era`` (an all-reduce max inside
``shard_map``), ``DistributedEraClock.device_merge`` and
``ShardedEraDomain.device_merge_all`` — is not ported here: across cards
it becomes a ``torch.distributed`` all-reduce MAX, which belongs with the
port of ``sharding/`` and ``launch/``.
"""

from __future__ import annotations

from typing import List

__all__ = ["DistributedEraClock", "ShardedEraDomain"]


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

    def stats(self) -> dict:
        return {
            "era_merges": self.merges,
            "era_spread": self.spread(),
            "era_max": max(self.locals, default=0),
            "merged_in": sum(c.merged_in for c in self.clocks),
        }
