"""DataGridService — the paper's control plane as a runtime service.

One object owns the catalog, the topology, the per-host replica managers
(HRS by default) and the data-aware scheduler, all the port's own host
modules (``repro_torch.core``). Three substrates consume it:

  * the input pipeline (``repro_torch.data.pipeline``): dataset shards are
    files; each read is a job routed to the host holding the most bytes;
  * checkpoint restore (``repro_torch.checkpoint``): parameter shards are
    files; restore sources are HRS replica selections (intra-region first);
  * serving (``repro_torch.serve.engine``): prefix-KV blocks and adapters
    are files; requests are jobs.

The service tracks simulated transfer cost (bytes x link) so examples and
tests can assert the hierarchy is respected without real hardware.
"""

from __future__ import annotations

import dataclasses

from ..core.catalog import ReplicaCatalog
from ..core.replica import StorageState, make_strategy
from ..core.scheduler import Job, make_scheduler
from ..core.topology import GridTopology


@dataclasses.dataclass
class TransferStat:
    lfn: str
    src: int
    dst: int
    bytes: float
    inter_region: bool
    stored: bool


class DataGridService:
    def __init__(self, topology: GridTopology, *, strategy: str = "hrs",
                 scheduler: str = "dataaware", seed: int = 0) -> None:
        self.topology = topology
        self.catalog = ReplicaCatalog()
        self.storage = StorageState(self.catalog, topology)
        self.strategy = make_strategy(strategy, self.catalog, topology,
                                      self.storage)
        self.scheduler = make_scheduler(scheduler, self.catalog, topology,
                                        seed=seed)
        self.transfers: list[TransferStat] = []
        self._clock = 0.0
        self._job_id = 0

    # -- artifact registry ---------------------------------------------------
    def register(self, lfn: str, size: float, master_site: int) -> None:
        self.catalog.register_file(lfn, size, master_site)
        self.storage.bootstrap(master_site, lfn, self._clock)

    def tick(self, dt: float = 1.0) -> None:
        self._clock += dt

    # -- the paper's operations ----------------------------------------------
    def schedule(self, required: list[str], length: float = 1.0) -> int:
        """Route a work unit to a host (paper §3.2)."""
        self._job_id += 1
        job = Job(job_id=self._job_id, job_type=0, required=list(required),
                  length=length)
        return self.scheduler.select_site(job)

    def ensure_local(self, required: list[str], site: int) -> list[TransferStat]:
        """Run HRS for every missing file of a work unit (paper §3.3).

        Executes the plans immediately (transfer latency is accounted, not
        simulated — the DES in repro_torch.core.simulator does the timing
        study).
        """
        stats = []
        for lfn in required:
            self.tick(0.001)
            if self.storage.holds(site, lfn):
                self.storage.touch(site, lfn, self._clock)
                continue
            plan = self.strategy.plan_fetch(lfn, site)
            for victim in plan.evictions:
                self.storage.remove(site, victim)
            if plan.store:
                self.storage.add(site, lfn, self._clock)
            st = TransferStat(lfn=lfn, src=plan.src, dst=site,
                              bytes=self.catalog.size(lfn),
                              inter_region=plan.inter_region,
                              stored=plan.store)
            self.transfers.append(st)
            stats.append(st)
        return stats

    def place_job(self, required: list[str], length: float = 1.0):
        """schedule + ensure_local in one call. Returns (site, transfers)."""
        site = self.schedule(required, length)
        stats = self.ensure_local(required, site)
        self.topology.sites[site].queued_work += length
        return site, stats

    def complete_job(self, site: int, length: float = 1.0) -> None:
        self.topology.sites[site].queued_work = max(
            0.0, self.topology.sites[site].queued_work - length)

    # -- bookkeeping -----------------------------------------------------------
    def inter_comm_count(self) -> int:
        return sum(1 for t in self.transfers if t.inter_region)

    def wan_bytes(self) -> float:
        return sum(t.bytes for t in self.transfers if t.inter_region)

    def lan_bytes(self) -> float:
        return sum(t.bytes for t in self.transfers if not t.inter_region)
