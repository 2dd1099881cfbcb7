"""Job scheduling policies (paper §3.2 + baselines).

The paper's algorithm:
  1. compute S_s (eq. 1) for every site = bytes of the job's required files
     already present there;
  2. pick the site with max S_s;
  3. tie-break by min RelativeLoad (eq. 2).

Baselines implemented for the ablation (and because the paper's related work
compares against them): Random, LeastLoaded (queue-only), ShortestTransfer
(estimate transfer time for missing bytes and minimize transfer + queue).
"""

from __future__ import annotations

import dataclasses
import random as _random
from typing import Sequence

from .catalog import ReplicaCatalog
from .topology import GridTopology


@dataclasses.dataclass
class Job:
    job_id: int
    job_type: int
    required: list[str]              # LFNs (paper: R_j)
    length: float                    # ops (paper: MI)
    submit_time: float = 0.0


class SchedulerPolicy:
    name = "base"

    def __init__(self, catalog: ReplicaCatalog, topology: GridTopology,
                 seed: int = 0) -> None:
        self.catalog = catalog
        self.topology = topology
        self.rng = _random.Random(seed)

    def select_site(self, job: Job) -> int:
        raise NotImplementedError


class DataAwareScheduler(SchedulerPolicy):
    """The paper's scheduling policy (§3.2)."""

    name = "dataaware"

    def select_site(self, job: Job) -> int:
        online = self.topology.online_sites()
        scores = {s: self.catalog.bytes_at_site(job.required, s) for s in online}
        best = max(scores.values())
        # sites with most available requested data, tie-break min relative load
        ties = [s for s in online if scores[s] == best]
        return min(ties, key=lambda s: (self.topology.sites[s].relative_load(), s))


class RandomScheduler(SchedulerPolicy):
    name = "random"

    def select_site(self, job: Job) -> int:
        return self.rng.choice(self.topology.online_sites())


class LeastLoadedScheduler(SchedulerPolicy):
    """Ignore data location entirely: min RelativeLoad."""

    name = "leastloaded"

    def select_site(self, job: Job) -> int:
        online = self.topology.online_sites()
        return min(online, key=lambda s: (self.topology.sites[s].relative_load(), s))


class ShortestTransferScheduler(SchedulerPolicy):
    """Chang et al. [6]-style: minimize estimated (transfer + queue) time.

    Transfer estimate: for each missing file take bytes / current point
    bandwidth from its best source; queue estimate: RelativeLoad.
    """

    name = "shortesttransfer"

    def select_site(self, job: Job) -> int:
        online = self.topology.online_sites()

        def cost(s: int) -> float:
            t = 0.0
            for lfn in job.required:
                if self.catalog.has_replica(lfn, s):
                    continue
                # Durable masters keep this non-empty even when every
                # holder's site is down (same rule replica fetches use).
                holders = self.catalog.fetchable_holders(lfn, self.topology)
                bw = max((self.topology.point_bandwidth(h, s) for h in holders),
                         default=0.0)
                if bw <= 0.0:
                    return float("inf")
                t += self.catalog.size(lfn) / bw
            return max(t, self.topology.sites[s].relative_load())

        return min(online, key=lambda s: (cost(s), s))


#: Scheduling-policy registry, keyed by each policy's ``name`` attribute:
#: ``dataaware`` (the paper's §3.2 algorithm), ``random``, ``leastloaded``,
#: ``shortesttransfer``. These names are what ``GridSimulator``,
#: ``run_experiment`` and ``ScenarioSpec.scheduler`` accept.
SCHEDULERS: dict[str, type[SchedulerPolicy]] = {
    c.name: c for c in (DataAwareScheduler, RandomScheduler, LeastLoadedScheduler,
                        ShortestTransferScheduler)
}


def make_scheduler(name: str, catalog: ReplicaCatalog, topology: GridTopology,
                   seed: int = 0) -> SchedulerPolicy:
    """Instantiate a scheduling policy from :data:`SCHEDULERS` by name.

    ``seed`` only matters for stochastic policies (``random``); the rest are
    deterministic functions of catalog + topology state. Raises ``KeyError``
    for unknown names — callers validate against ``SCHEDULERS`` for nicer
    errors (e.g. ``ScenarioSpec.__post_init__``).
    """
    return SCHEDULERS[name](catalog, topology, seed=seed)
