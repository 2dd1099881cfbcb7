"""Discrete-event data-grid simulator (the paper's GridSim analogue, §4).

The counterpart of ``repro.core.simulator``, event for event: submit ->
broker schedules (policy) -> site queue -> replica manager fetches missing
files (strategy) -> job processes when data ready AND CE free -> done. Job
time = max(transfer time, queue time) + processing time.

The fluid network lives in :class:`repro_torch.core.network.NetworkEngine`,
whose slot state sits on ``device`` (``"cuda"`` by default) and whose
re-rates run the port's CUDA kernels; ``net=`` picks its backend as in the
reference. ``broker="jax"`` dispatches simultaneous arrivals through
:class:`repro_torch.core.torchsched.TorchScheduler` (the ``dataaware``
policy). The host-side event heap, queues and ``random.Random`` streams
are the reference's, so results match it bit for bit.

Not in this slice, and raising ``NotImplementedError``: telemetry
(``obs=`` / ``REPRO_OBS`` other than off), the tie-race sanitizer
(``sanitize=True``), the replication economy (an armed ``econ_interval``),
``strategy_mode="batch"`` and the other batch brokers. Failure, slowdown
and speculative-backup injection work as in the reference.
"""

from __future__ import annotations

import collections
import dataclasses
import heapq
import os
import random as _random
from typing import Optional

import torch

from .access import AccessHistory
from .catalog import ReplicaCatalog
from .economy import DEFAULT_INTERVAL_S, ECON_BACKENDS
from .network import BACKENDS, NetworkEngine
from .replica import FetchPlan, ReplicaStrategy, StorageState, make_strategy
from .scheduler import Job, SchedulerPolicy, make_scheduler
from .topology import GridTopology


# --------------------------------------------------------------------------
# events
# --------------------------------------------------------------------------
(SUBMIT, NET, CPU_DONE, FAIL, RECOVER, SLOW_START, SLOW_END, WATCHDOG,
 FLUSH) = range(9)

#: Values the ``net=`` engine flag accepts: NetworkEngine backends plus
#: ``"topmost"``, which keeps the numpy backend over a topology built with
#: the legacy topmost-uplink accounting.
NETS = BACKENDS + ("topmost",)

#: Telemetry modes the reference accepts (``repro.obs.OBS_MODES``); only
#: ``"off"`` runs in the port so far.
OBS_MODES = ("off", "report", "series", "trace")


@dataclasses.dataclass(eq=False)
class _Transfer:
    tid: int
    plan: FetchPlan
    link_ids: tuple[int, ...]    # full source-side path, unified link space
    slot: int = -1
    waiters: list["_JobState"] = dataclasses.field(default_factory=list)


@dataclasses.dataclass(eq=False)
class _JobState:
    job: Job
    site: int = -1
    missing: list[str] = dataclasses.field(default_factory=list)
    pending_transfers: int = 0
    temp_files: list[str] = dataclasses.field(default_factory=list)
    pinned: list[str] = dataclasses.field(default_factory=list)
    data_ready_time: float = -1.0
    start_time: float = -1.0
    done: bool = False
    is_backup: bool = False
    twin: Optional["_JobState"] = None   # speculative copy, if any
    remaining_ops: float = 0.0
    rounds: int = 0                      # staging rounds (re-fetch after eviction)
    pin_on_arrival: bool = False         # anti-livelock escalation


@dataclasses.dataclass
class JobRecord:
    job_id: int
    job_type: int
    site: int
    submit_time: float
    data_ready_time: float
    start_time: float
    finish_time: float
    inter_comms: int
    wan_bytes: float
    resubmits: int = 0

    @property
    def job_time(self) -> float:
        return self.finish_time - self.submit_time


@dataclasses.dataclass
class SimResult:
    records: list[JobRecord]
    total_inter_comms: int
    total_wan_bytes: float
    total_lan_bytes: float
    makespan: float
    # the NetworkEngine's work counters (rerate_calls/rerate_slots/
    # flush_passes/flush_slots) and the AccessHistory prefetch ledger
    net_stats: dict = dataclasses.field(default_factory=dict)
    prefetches: int = 0
    prefetch_bytes: float = 0.0

    @property
    def avg_job_time(self) -> float:
        # left to right in record order, the summation the golden files
        # pin: a tensor sum reorders the additions, and Python 3.12's
        # sum() compensates them; either moves the last bits
        total = 0.0
        for r in self.records:
            total += r.job_time
        return total / max(1, len(self.records))

    @property
    def avg_inter_comms(self) -> float:
        return self.total_inter_comms / max(1, len(self.records))


class GridSimulator:
    def __init__(
        self,
        topology: GridTopology,
        catalog: ReplicaCatalog,
        *,
        scheduler: str | SchedulerPolicy = "dataaware",
        strategy: str | ReplicaStrategy = "hrs",
        strategy_mode: str = "sequential",
        seed: int = 0,
        speculative_backups: bool = False,
        straggler_threshold: float = 3.0,
        broker: str = "event",
        batch_window: float = 0.0,
        net: str = "numpy",
        econ: str = "numpy",
        econ_interval: Optional[float] = None,
        obs: Optional[str] = None,
        obs_interval: Optional[float] = None,
        sanitize: bool = False,
        device: "str | torch.device" = "cuda",
    ) -> None:
        if obs is None:
            obs = os.environ.get("REPRO_OBS", "off")
        if obs not in OBS_MODES:
            raise ValueError(f"unknown obs mode {obs!r} "
                             f"(want one of {OBS_MODES})")
        if obs != "off":
            raise NotImplementedError(
                f"obs={obs!r}: telemetry is not ported yet (ROADMAP queue 1 "
                "item 7); run with obs off and REPRO_OBS unset or 'off'")
        if sanitize:
            raise NotImplementedError(
                "sanitize=True: the tie-race sanitizer is not ported yet "
                "(ROADMAP queue 1 item 8)")
        if econ not in ECON_BACKENDS:
            raise ValueError(f"unknown econ backend {econ!r} "
                             f"(want one of {ECON_BACKENDS})")
        self.topology = topology
        self.catalog = catalog
        self.storage = StorageState(catalog, topology)
        self.scheduler = (
            scheduler if isinstance(scheduler, SchedulerPolicy)
            else make_scheduler(scheduler, catalog, topology, seed=seed)
        )
        if net not in NETS:
            raise ValueError(f"unknown net engine {net!r} (want one of {NETS})")
        if net == "topmost":
            # legacy model: contend only on the topmost crossed uplink. The
            # topology must have been built that way (run_experiment(net=
            # 'topmost') does this), never mutated here.
            if topology.path_model != "topmost":
                raise ValueError(
                    "net='topmost' requires a topology built with "
                    "path_model='topmost' (GridTopology(..., "
                    "path_model='topmost'), or run_experiment(net="
                    "'topmost') which does this for you)")
            net = "numpy"
        self.network = NetworkEngine(topology, backend=net, device=device)
        self.device = self.network.device
        # access history: pure observation, fed from the fetch/hit path
        if isinstance(strategy, ReplicaStrategy):
            if strategy_mode != "sequential":
                raise ValueError(
                    "strategy_mode applies to strategies built by name; "
                    "pass the registry name instead of an instance")
            self.strategy = strategy
            if strategy.access is not None:
                self.access = strategy.access   # adopt: one shared history
            else:
                self.access = AccessHistory(catalog, topology)
                strategy.access = self.access
        else:
            self.access = AccessHistory(catalog, topology)
            self.strategy = make_strategy(strategy, catalog, topology,
                                          self.storage, self.access,
                                          mode=strategy_mode)
        self.rng = _random.Random(seed)
        self.speculative_backups = speculative_backups
        self.straggler_threshold = straggler_threshold
        self.batch_window = batch_window
        # the replication economy: None arms it only for strategies that
        # declare uses_economy (none of the ported ones)
        if econ_interval is None:
            econ_interval = (DEFAULT_INTERVAL_S
                             if self.strategy.uses_economy else 0.0)
        if econ_interval > 0:
            raise NotImplementedError(
                "the replication economy (econ_interval > 0) is not ported "
                "yet (ROADMAP queue 1 item 5)")
        if broker == "jax":
            # the batch broker flag keeps the reference's name
            if self.scheduler.name == "dataaware":
                from .torchsched import TorchScheduler
                self._batch_broker = TorchScheduler(catalog, topology,
                                                    device=self.device)
            elif self.scheduler.name in ("shortesttransfer", "leastloaded",
                                         "random"):
                raise NotImplementedError(
                    f"broker='jax' with scheduler {self.scheduler.name!r} is "
                    "not ported yet (ROADMAP queue 1 item 3)")
            else:
                raise ValueError(
                    "broker='jax' implements the 'dataaware', "
                    "'shortesttransfer', 'leastloaded' and 'random' "
                    f"policies; got scheduler {self.scheduler.name!r}")
        elif broker == "event":
            if batch_window > 0:
                raise ValueError(
                    "batch_window only applies to broker='jax' "
                    "(the event broker dispatches each SUBMIT immediately)")
            self._batch_broker = None
        else:
            raise ValueError(f"unknown broker {broker!r} (want 'event'|'jax')")
        self._batch_buf: list[Job] = []
        self._flush_pending = False

        self._q: list[tuple[float, int, int, object]] = []
        self._seq = 0
        self.now = 0.0
        self._net_version = 0
        self._transfers: dict[int, _Transfer] = {}
        self._inflight: dict[tuple[int, str], _Transfer] = {}
        self._tid = 0
        # per-site CPU: FIFO queue of ready jobs + the running job. Cancelled
        # jobs stay queued as tombstones (done=True) and are skipped on pop.
        self._cpu_queue: dict[int, collections.deque[_JobState]] = {
            s.site_id: collections.deque() for s in topology.sites
        }
        self._running: dict[int, Optional[_JobState]] = {
            s.site_id: None for s in topology.sites
        }
        self._cpu_version: dict[int, int] = {s.site_id: 0 for s in topology.sites}
        self._cpu_last_update: dict[int, float] = {s.site_id: 0.0 for s in topology.sites}
        # ordered set (insertion-ordered dict) -> O(1) membership + removal
        self._site_jobs: dict[int, dict[_JobState, None]] = {
            s.site_id: {} for s in topology.sites
        }

        self.records: list[JobRecord] = []
        self._inter_comms: dict[int, int] = {}
        self._wan_bytes: dict[int, float] = {}
        self._resubmits: dict[int, int] = {}
        self.total_wan_bytes = 0.0
        self.total_lan_bytes = 0.0
        self._n_expected = 0

    # -- event plumbing ----------------------------------------------------
    def _push(self, t: float, kind: int, payload: object) -> None:
        self._seq += 1
        heapq.heappush(self._q, (t, self._seq, kind, payload))

    def submit_job(self, job: Job, at: float) -> None:
        self._n_expected += 1
        job.submit_time = at
        self._push(at, SUBMIT, job)

    def _check_site(self, site: int) -> None:
        if not 0 <= site < len(self.topology.sites):
            raise ValueError(
                f"site {site} out of range (topology has "
                f"{len(self.topology.sites)} sites)")

    def inject_failure(self, site: int, at: float, duration: float) -> None:
        self._check_site(site)
        self._push(at, FAIL, site)
        self._push(at + duration, RECOVER, site)

    def inject_slowdown(self, site: int, at: float, duration: float,
                        factor: float = 0.1) -> None:
        self._check_site(site)
        self._push(at, SLOW_START, (site, factor))
        self._push(at + duration, SLOW_END, (site, factor))

    # -- network -----------------------------------------------------------
    def _net_advance(self) -> None:
        self.network.advance(self.now)

    def _net_rerate(self, changed: tuple[int, ...] = ()) -> None:
        eta = self.network.rerate(changed, self.now)
        if self.network.batched:
            # deferred: the single fused flush at the end of the drained
            # instant re-rates and reschedules the NET wake-up
            return
        self._net_version += 1
        if eta is not None:
            self._push(eta, NET, self._net_version)

    def _net_flush(self) -> None:
        """Batched engine only: fold everything the drained instant
        changed into one fused device pass and reschedule the NET
        wake-up. No-op on the incremental backends and clean instants."""
        net = self.network
        if not net.dirty:
            return
        eta = net.flush(self.now)
        self._net_version += 1
        if eta is not None:
            self._push(eta, NET, self._net_version)

    def _start_transfer(self, plan: FetchPlan, js: _JobState) -> None:
        key = (plan.dst, plan.lfn)
        if key in self._inflight and self._inflight[key].plan.store:
            # another job at this site is already fetching it; piggyback
            self._inflight[key].waiters.append(js)
            return
        self._net_advance()
        size = self.catalog.size(plan.lfn)
        link_ids = self.topology.link_ids_for(plan.src, plan.dst)
        # evictions + space reservation happen at transfer start
        if plan.store:
            for victim in plan.evictions:
                self.storage.remove(plan.dst, victim)
            self.topology.sites[plan.dst].used_storage += size  # reserve
        self.storage.pin(plan.src, plan.lfn)   # source can't be evicted mid-copy
        self._tid += 1
        tr = _Transfer(self._tid, plan, link_ids, waiters=[js])
        self._transfers[tr.tid] = tr
        self.network.alloc(tr, size, link_ids)
        if plan.store:
            self._inflight[key] = tr
        if plan.inter_region:
            self._inter_comms[js.job.job_id] = self._inter_comms.get(js.job.job_id, 0) + 1
            self._wan_bytes[js.job.job_id] = self._wan_bytes.get(js.job.job_id, 0.0) + size
            self.total_wan_bytes += size
        else:
            self.total_lan_bytes += size
        self.access.record_fetch(plan.src, plan.dst, plan.lfn, size,
                                 plan.inter_region, self.now)
        self._net_rerate(link_ids)

    def _finish_transfer(self, tr: _Transfer) -> None:
        plan = tr.plan
        self._transfers.pop(tr.tid, None)
        self._inflight.pop((plan.dst, plan.lfn), None)
        link_ids = self.network.release(tr)
        self.storage.unpin(plan.src, plan.lfn)
        self.storage.touch(plan.src, plan.lfn, self.now)
        if plan.store:
            # un-reserve, then commit properly through StorageState
            self.topology.sites[plan.dst].used_storage -= self.catalog.size(plan.lfn)
            self.storage.add(plan.dst, plan.lfn, self.now)
        for js in tr.waiters:
            if js.done:
                continue
            if plan.store:
                if js.pin_on_arrival:
                    self.storage.pin(plan.dst, plan.lfn)
                    js.pinned.append(plan.lfn)
            else:
                js.temp_files.append(plan.lfn)
            js.pending_transfers -= 1
            self._fetch_next(js)
        self._net_rerate(link_ids)

    def _abort_transfers_touching(self, site: int) -> None:
        """Failure handling: drop transfers with src or dst at a failed site."""
        self._net_advance()
        dead = [t for t in self._transfers.values()
                if t.plan.src == site or t.plan.dst == site]
        changed: set[int] = set()
        for tr in dead:
            self._transfers.pop(tr.tid, None)
            self._inflight.pop((tr.plan.dst, tr.plan.lfn), None)
            changed.update(self.network.release(tr))
            if self.topology.sites[tr.plan.src].online or \
               self.catalog.has_replica(tr.plan.lfn, tr.plan.src):
                self.storage.unpin(tr.plan.src, tr.plan.lfn)
            if tr.plan.store:
                self.topology.sites[tr.plan.dst].used_storage -= \
                    self.catalog.size(tr.plan.lfn)
            for js in tr.waiters:
                if js.done or js.site == site:
                    continue  # jobs at the failed site are resubmitted anyway
                # replan this file from surviving replicas
                js.missing.insert(0, tr.plan.lfn)
                js.pending_transfers -= 1
                self._fetch_next(js)
        self._net_rerate(tuple(sorted(changed)))

    # -- job lifecycle -----------------------------------------------------
    #
    # Staging semantics: replicas are pinned only while a job is *running*.
    # A job re-verifies its working set when it reaches the CE; anything
    # evicted in the meantime is re-staged (another round). After 3 rounds
    # the job pins files as they arrive (anti-livelock escalation).
    def _schedule(self, job: Job) -> None:
        self._place(job, self.scheduler.select_site(job))

    def _place(self, job: Job, site: int) -> _JobState:
        js = _JobState(job=job, site=site, remaining_ops=job.length)
        self._site_jobs[site][js] = None
        self.topology.sites[site].queued_work += job.length
        js.missing = [l for l in job.required if not self.storage.holds(site, l)]
        for lfn in job.required:
            self.storage.touch(site, lfn, self.now)
            # demand signal: one access per required file at placement, a
            # hit when it resolved from the site's own SE
            self.access.record_access(site, lfn, self.now)
            if lfn not in js.missing:
                self.access.record_hit(site, lfn, self.now)
        self._fetch_next(js)
        return js

    def _drain_submit_batch(self, first: Job) -> list[Job]:
        """Batch broker: pull every SUBMIT event sharing this timestamp off
        the head of the heap (stopping at any other event kind, which
        preserves causality with failures/completions)."""
        batch = [first]
        q = self._q
        while q and q[0][0] <= self.now and q[0][2] == SUBMIT:
            batch.append(heapq.heappop(q)[3])  # type: ignore[arg-type]
        return batch

    def _dispatch_batch(self, batch: list[Job]) -> None:
        if len(batch) == 1:
            self._schedule(batch[0])
            return
        assert self._batch_broker is not None
        sites = self._batch_broker.select_batch([j.required for j in batch])
        for job, site in zip(batch, sites):
            self._place(job, site)

    def _next_missing(self, js: _JobState) -> Optional[str]:
        """Pop ``js.missing`` down to its first file that still needs a
        transfer (touching anything that already arrived); ``None`` when
        nothing is left."""
        while js.missing:
            lfn = js.missing.pop(0)
            if self.storage.holds(js.site, lfn):
                self.storage.touch(js.site, lfn, self.now)
                continue
            return lfn
        return None

    def _fetch_next(self, js: _JobState) -> None:
        """Files are accessed sequentially within a job (paper §4.1): one
        transfer in flight per job."""
        if js.done:
            return
        lfn = self._next_missing(js)
        if lfn is not None:
            plan = self.strategy.plan_fetch(lfn, js.site)
            js.pending_transfers += 1
            self._start_transfer(plan, js)
            return
        if js.pending_transfers == 0:
            if js.data_ready_time < 0:
                js.data_ready_time = self.now
            self._enqueue_cpu(js)

    def _working_set_missing(self, js: _JobState) -> list[str]:
        return [f for f in js.job.required
                if f not in js.temp_files and not self.storage.holds(js.site, f)]

    def _enqueue_cpu(self, js: _JobState) -> None:
        self._cpu_queue[js.site].append(js)
        self._maybe_start_cpu(js.site)

    def _cpu_advance(self, site: int) -> None:
        run = self._running[site]
        if run is not None:
            dt = self.now - self._cpu_last_update[site]
            run.remaining_ops = max(
                0.0, run.remaining_ops - dt * self.topology.sites[site].compute_capacity
            )
        self._cpu_last_update[site] = self.now

    def _maybe_start_cpu(self, site: int) -> None:
        if self._running[site] is not None or not self.topology.sites[site].online:
            return
        q = self._cpu_queue[site]
        while q:
            js = q.popleft()
            if js.done:
                continue
            missing = self._working_set_missing(js)
            if missing:
                # part of the staged set was evicted while queued: re-stage
                js.rounds += 1
                if js.rounds >= 3:
                    js.pin_on_arrival = True
                js.missing = missing
                self._fetch_next(js)
                continue
            # pin the working set for the duration of processing
            for f in js.job.required:
                if self.storage.holds(site, f) and f not in js.pinned:
                    self.storage.pin(site, f)
                    js.pinned.append(f)
                self.storage.touch(site, f, self.now)
            js.start_time = self.now
            self._running[site] = js
            self._cpu_last_update[site] = self.now
            self._reschedule_cpu(site)
            if self.speculative_backups and not js.is_backup and js.twin is None:
                expected = js.job.length / self.topology.sites[site].compute_capacity
                self._push(self.now + self.straggler_threshold * expected, WATCHDOG, js)
            return

    def _reschedule_cpu(self, site: int) -> None:
        js = self._running[site]
        if js is None:
            return
        self._cpu_version[site] += 1
        cap = self.topology.sites[site].compute_capacity
        eta = self.now + js.remaining_ops / cap
        self._push(eta, CPU_DONE, (site, self._cpu_version[site]))

    def _finish_job(self, js: _JobState) -> None:
        js.done = True
        site = js.site
        self.topology.sites[site].queued_work -= js.job.length
        for lfn in js.pinned:
            self.storage.unpin(site, lfn)
        js.temp_files.clear()   # paper: temp buffer dropped after job completes
        self._site_jobs[site].pop(js, None)
        twin = js.twin
        if twin is not None and not twin.done:
            self._cancel_job(twin)
        jid = js.job.job_id
        self.records.append(JobRecord(
            job_id=jid, job_type=js.job.job_type, site=site,
            submit_time=js.job.submit_time, data_ready_time=js.data_ready_time,
            start_time=js.start_time, finish_time=self.now,
            inter_comms=self._inter_comms.get(jid, 0),
            wan_bytes=self._wan_bytes.get(jid, 0.0),
            resubmits=self._resubmits.get(jid, 0),
        ))

    def _cancel_job(self, js: _JobState) -> None:
        js.done = True       # tombstone: a queued copy is skipped on pop
        site = js.site
        self.topology.sites[site].queued_work -= js.job.length
        for lfn in js.pinned:
            self.storage.unpin(site, lfn)
        js.temp_files.clear()
        if self._running[site] is js:
            self._cpu_advance(site)
            self._running[site] = None
            self._cpu_version[site] += 1
            self._maybe_start_cpu(site)
        self._site_jobs[site].pop(js, None)

    # -- failures / stragglers ----------------------------------------------
    def _fail_site(self, site: int) -> None:
        st = self.topology.sites[site]
        if not st.online:
            return
        self._cpu_advance(site)
        st.online = False
        self._abort_transfers_touching(site)
        # lose non-master replicas (the SE is gone); masters are durable
        for lfn in self.storage.site_contents(site):
            if not self.catalog.is_master(lfn, site):
                self.storage.lose(site, lfn)
        # resubmit every job that was at this site
        victims = list(self._site_jobs[site])
        self._site_jobs[site].clear()
        self._cpu_queue[site].clear()
        self._running[site] = None
        self._cpu_version[site] += 1
        for js in victims:
            if js.done:
                continue
            js.done = True
            st.queued_work -= js.job.length
            jid = js.job.job_id
            if js.twin is not None and not js.twin.done:
                continue  # its twin survives; no resubmission needed
            self._resubmits[jid] = self._resubmits.get(jid, 0) + 1
            self._push(self.now, SUBMIT, js.job)

    def _recover_site(self, site: int) -> None:
        self.topology.sites[site].online = True
        self._maybe_start_cpu(site)

    def _watchdog(self, js: _JobState) -> None:
        """Speculative backup: if js still running past threshold, clone it."""
        if js.done or self._running[js.site] is not js:
            return
        job = js.job
        backup_site = self.scheduler.select_site(job)
        if backup_site == js.site:
            candidates = [s for s in self.topology.online_sites() if s != js.site]
            if not candidates:
                return
            backup_site = min(
                candidates, key=lambda s: (self.topology.sites[s].relative_load(), s))
        twin = _JobState(job=job, site=backup_site, is_backup=True,
                         remaining_ops=job.length)
        twin.twin = js
        js.twin = twin
        self._site_jobs[backup_site][twin] = None
        self.topology.sites[backup_site].queued_work += job.length
        twin.missing = [l for l in job.required
                        if not self.storage.holds(backup_site, l)]
        self._fetch_next(twin)

    # -- main loop -----------------------------------------------------------
    def run(self, until: float = float("inf")) -> SimResult:
        self.network.last = 0.0
        batched = self.network.batched
        while self._q:
            if batched:
                # batched drain: handle every event sharing the head
                # timestamp, then one fused network pass for the instant
                t = self._q[0][0]
                if t > until:
                    heapq.heappop(self._q)
                    break
                self._drain_instant(t)
                continue
            t, _, kind, payload = heapq.heappop(self._q)
            if t > until:
                break
            self.now = t
            self._handle_event(kind, payload)
        total_ic = sum(r.inter_comms for r in self.records)
        return SimResult(
            records=self.records,
            total_inter_comms=total_ic,
            total_wan_bytes=self.total_wan_bytes,
            total_lan_bytes=self.total_lan_bytes,
            makespan=self.now,
            net_stats=dict(self.network.stats),
            prefetches=self.access.prefetches,
            prefetch_bytes=self.access.prefetch_bytes,
        )

    def _handle_event(self, kind: int, payload: object) -> None:
        t = self.now
        if kind == SUBMIT:
            # submit_time was stamped at first submission; resubmitted
            # jobs (failures) keep it so job_time spans the whole outage.
            if self._batch_broker is None:
                self._schedule(payload)  # type: ignore[arg-type]
            elif self.batch_window > 0:
                # collect; dispatch together once the window closes
                self._batch_buf.append(payload)  # type: ignore[arg-type]
                if not self._flush_pending:
                    self._flush_pending = True
                    self._push(t + self.batch_window, FLUSH, None)
            else:
                self._dispatch_batch(self._drain_submit_batch(payload))  # type: ignore[arg-type]
        elif kind == FLUSH:
            self._flush_pending = False
            batch, self._batch_buf = self._batch_buf, []
            if batch:
                self._dispatch_batch(batch)
        elif kind == NET:
            if payload != self._net_version:
                return
            self._net_advance()
            done_idx = self.network.completions()
            if done_idx:
                done = sorted((self.network.obj[i] for i in done_idx),
                              key=lambda tr: tr.tid)
                for tr in done:
                    self._finish_transfer(tr)
            else:
                self._net_rerate()
        elif kind == CPU_DONE:
            site, ver = payload  # type: ignore[misc]
            if ver != self._cpu_version[site]:
                return
            self._cpu_advance(site)
            js = self._running[site]
            if js is None:
                return
            self._running[site] = None
            self._finish_job(js)
            self._maybe_start_cpu(site)
        elif kind == FAIL:
            self._fail_site(payload)  # type: ignore[arg-type]
        elif kind == RECOVER:
            self._recover_site(payload)  # type: ignore[arg-type]
        elif kind == SLOW_START:
            site, factor = payload  # type: ignore[misc]
            self._cpu_advance(site)
            self.topology.sites[site].compute_capacity *= factor
            self._reschedule_cpu(site)
        elif kind == SLOW_END:
            site, factor = payload  # type: ignore[misc]
            self._cpu_advance(site)
            self.topology.sites[site].compute_capacity /= factor
            self._reschedule_cpu(site)
        elif kind == WATCHDOG:
            self._watchdog(payload)  # type: ignore[arg-type]

    def _drain_instant(self, t0: float) -> None:
        """Pop and handle every event at time ``t0``, including events the
        handlers push back *at* ``t0``. Each drained round ends with the
        instant's one fused flush, which may reschedule the NET wake-up
        back at ``t0``, so the outer loop re-drains until the instant is
        quiet."""
        while self._q and self._q[0][0] <= t0:
            while self._q and self._q[0][0] <= t0:
                t, _, kind, payload = heapq.heappop(self._q)
                self.now = t
                self._handle_event(kind, payload)
            self._net_flush()
