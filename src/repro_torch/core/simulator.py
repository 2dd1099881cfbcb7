"""Discrete-event data-grid simulator (the paper's GridSim analogue, §4).

The counterpart of ``repro.core.simulator``, event for event: submit ->
broker schedules (policy) -> site queue -> replica manager fetches missing
files (strategy) -> job processes when data ready AND CE free -> done. Job
time = max(transfer time, queue time) + processing time.

The fluid network lives in :class:`repro_torch.core.network.NetworkEngine`,
whose slot state sits on ``device`` (``"cuda"`` by default) and whose
re-rates run the port's CUDA kernels; ``net=`` picks its backend as in the
reference. ``broker="jax"`` dispatches simultaneous arrivals through the
batch brokers of :mod:`repro_torch.core.torchsched` (``dataaware``,
``leastloaded``, ``random``, and ``shortesttransfer`` on the ``st_cost``
kernel). ``strategy_mode="batch"`` plans every (job, missing-file) fetch
of a burst in one ``strategy_plan`` pass and consumes the cached plans
under the reference's keep / reverdict / replan guard (``_live_plan``).
The replication economy (an armed ``econ_interval``, or the ``economic``
and ``predictive`` strategies) runs as the periodic ``ECON`` event, its
value matrix scored by the ``value_score`` kernel. The host-side event
heap, queues and ``random.Random`` streams are the reference's, so results
match it bit for bit. Failure, slowdown and speculative-backup injection
work as in the reference.

Telemetry (:mod:`repro_torch.obs`; ``obs=`` or the ``REPRO_OBS``
environment value) charges the reference's spans and counters, and on a
CUDA device its spans wait for the card as they open and close; with obs
off every hook is one ``is None`` check. ``sanitize=True`` is the
reference's tie-race sanitizer: every instant with two or more events is
replayed, order reversed, in a deep-copied twin (its own slot tensors and
kernel buffers, :mod:`repro_torch.kernels.net_call`) and the observable
states compared.
"""

from __future__ import annotations

import collections
import copy
import dataclasses
import heapq
import os
import random as _random
from typing import Optional

import torch

from ..obs import DEFAULT_OBS_INTERVAL_S, OBS_MODES, make_probe
from .access import AccessHistory
from .catalog import ReplicaCatalog
from .economy import DEFAULT_INTERVAL_S, ECON_BACKENDS, ReplicationOptimizer
from .network import BACKENDS, NetworkEngine
from .replica import FetchPlan, ReplicaStrategy, StorageState, make_strategy
from .scheduler import Job, SchedulerPolicy, make_scheduler
from .topology import GridTopology


# --------------------------------------------------------------------------
# events
# --------------------------------------------------------------------------
(SUBMIT, NET, CPU_DONE, FAIL, RECOVER, SLOW_START, SLOW_END, WATCHDOG,
 FLUSH, ECON, OBS) = range(11)

EVENT_NAMES = ("SUBMIT", "NET", "CPU_DONE", "FAIL", "RECOVER", "SLOW_START",
               "SLOW_END", "WATCHDOG", "FLUSH", "ECON", "OBS")

#: Host-phase span charged for each handled event kind (telemetry only;
#: ``None`` kinds are counted but not timed — they are rare control
#: events). Nested spans (strategy planning inside a dispatch, a fused
#: flush inside a NET completion) subtract out via the probe's
#: exclusive-time accounting.
_EVENT_PHASE = ("broker.dispatch", "net.events", "cpu.done", None, None,
                None, None, None, "broker.dispatch", "econ.auction",
                "obs.sample")

#: Values the ``net=`` engine flag accepts: NetworkEngine backends plus
#: ``"topmost"``, which keeps the numpy backend over a topology built with
#: the legacy topmost-uplink accounting.
NETS = BACKENDS + ("topmost",)


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
    # burst-planned fetches awaiting execution (strategy_mode="batch"):
    # one FetchPlan per still-missing file, consumed by _fetch_next
    plan_cache: dict[str, "FetchPlan"] = dataclasses.field(
        default_factory=dict)


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


@dataclasses.dataclass(frozen=True)
class TieRace:
    """One same-timestamp event group whose handler order changes
    observable state (found by the ``sanitize=True`` engine mode)."""

    time: float
    kinds: tuple[str, ...]       # event kinds in the tie group, seq order
    detail: str                  # first state divergence, human-readable


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
    #: :class:`repro_torch.obs.TelemetryReport` when an ``obs=`` mode is on.
    telemetry: Optional[object] = None

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
        # obs=None defers to the REPRO_OBS environment value, so existing
        # entry points (the golden suites included) can run unchanged with
        # telemetry forced on
        if obs is None:
            obs = os.environ.get("REPRO_OBS", "off")
        if obs not in OBS_MODES:
            raise ValueError(f"unknown obs mode {obs!r} "
                             f"(want one of {OBS_MODES})")
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
        # the network engine is built before the strategy: the batched
        # planners read their per-burst bandwidth columns from it
        self.network = NetworkEngine(topology, backend=net, device=device)
        self.device = self.network.device
        # access history: pure observation, fed from the fetch/hit path.
        # Shared with the strategy (the access-aware ones consult it) and
        # the replication economy (which acts on it).
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
                                          mode=strategy_mode,
                                          network=self.network)
        # batched planners consume whole arrival bursts (`_batch_fetch`)
        # and cache an online-site vector the failure paths invalidate
        self._batched_strategy = getattr(self.strategy, "batched", False)
        self.rng = _random.Random(seed)
        self.speculative_backups = speculative_backups
        self.straggler_threshold = straggler_threshold
        self.batch_window = batch_window
        # the replication economy (proactive, periodic): None arms it only
        # for the strategies that declare uses_economy, at the default
        # period; an explicit interval > 0 forces it on, 0 turns it off
        if econ_interval is None:
            econ_interval = (DEFAULT_INTERVAL_S
                             if self.strategy.uses_economy else 0.0)
        self._econ_interval = econ_interval
        if econ_interval > 0:
            self._econ = ReplicationOptimizer(
                catalog, topology, self.storage, self.access, self.network,
                model=self.strategy.econ_model, backend=econ)
        else:
            self._econ = None
        self._econ_armed = False
        # -- telemetry (repro_torch.obs; off by default) ------------------
        # with obs off, self._obs is None and every hot-path guard below is
        # a single `is None` check; on a CUDA device the probe's spans wait
        # for the card as they open and close (every kernel and copy of the
        # engine runs on the device's current stream)
        self._obs = make_probe(
            obs, sync=(torch.cuda.current_stream(self.device).synchronize
                       if self.device.type == "cuda" else None))
        self._obs_interval = (DEFAULT_OBS_INTERVAL_S if obs_interval is None
                              else obs_interval)
        self._obs_armed = False
        # time of the last handled *non-OBS* event: the makespan under an
        # obs mode. Trailing OBS samples advance self.now past the real
        # workload end; counting them would break observation-only.
        self._obs_real_now = 0.0
        if broker == "jax":
            # the batch broker flag keeps the reference's name
            from . import torchsched
            name = self.scheduler.name
            if name == "dataaware":
                self._batch_broker = torchsched.TorchScheduler(
                    catalog, topology, device=self.device)
            elif name == "shortesttransfer":
                self._batch_broker = torchsched.TorchShortestTransferBroker(
                    catalog, topology, self.network, device=self.device)
            elif name == "leastloaded":
                self._batch_broker = torchsched.TorchLeastLoadedBroker(
                    catalog, topology, device=self.device)
            elif name == "random":
                # share the policy's Random: single-job batches (which
                # fall back to the sequential policy) and batched dispatch
                # then consume one PRNG stream
                self._batch_broker = torchsched.TorchRandomBroker(
                    catalog, topology, self.scheduler.rng,
                    device=self.device)
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
        # -- tie-race sanitizer -----------------------------------------
        # For every group of >= 2 events sharing a timestamp, a deep-copied
        # twin replays the instant with the group's order reversed and the
        # canonicalized observable states are compared. Twin replay
        # deep-copies the engine; the batch brokers and the batched
        # planners ride catalog/storage listeners a copy drops.
        if sanitize and (self._batch_broker is not None
                         or self._batched_strategy):
            raise ValueError(
                "sanitize=True requires broker='event' and "
                "strategy_mode='sequential' (twin replay deep-copies "
                "the engine, dropping listeners)")
        self.sanitize = sanitize
        self.ties_seen = 0
        self.tie_races: list[TieRace] = []

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
        if self._obs is None:
            eta = self.network.rerate(changed, self.now)
        else:
            with self._obs.span("net.rerate"):
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
        if self._obs is None:
            eta = net.flush(self.now)
        else:
            with self._obs.span("net.flush"):
                eta = net.flush(self.now)
        self._net_version += 1
        if eta is not None:
            self._push(eta, NET, self._net_version)

    def _start_transfer(self, plan: FetchPlan,
                        js: Optional[_JobState]) -> None:
        """Start a transfer. ``js`` is the waiting job, or ``None`` for a
        proactive (economy-initiated) prefetch: same fluid-model slot and
        link contention, but no waiter, and accounted as prefetch traffic
        rather than per-job inter-communication."""
        key = (plan.dst, plan.lfn)
        if js is not None and key in self._inflight \
                and self._inflight[key].plan.store:
            # another job at this site is already fetching it; piggyback
            self._inflight[key].waiters.append(js)
            return
        self._net_advance()
        size = self.catalog.size(plan.lfn)
        link_ids = self.topology.link_ids_for(plan.src, plan.dst)
        # evictions + space reservation happen at transfer start
        if plan.store:
            if plan.evictions and self._obs is not None:
                self._obs.count("evict.transfers")
                self._obs.count("evict.victims", len(plan.evictions))
                with self._obs.span("evict.apply"):
                    for victim in plan.evictions:
                        self.storage.remove(plan.dst, victim)
            else:
                for victim in plan.evictions:
                    self.storage.remove(plan.dst, victim)
            self.topology.sites[plan.dst].used_storage += size  # reserve
        self.storage.pin(plan.src, plan.lfn)   # source can't be evicted mid-copy
        self._tid += 1
        tr = _Transfer(self._tid, plan, link_ids,
                       waiters=[] if js is None else [js])
        self._transfers[tr.tid] = tr
        self.network.alloc(tr, size, link_ids)
        if plan.store:
            self._inflight[key] = tr
        if plan.inter_region:
            if js is not None:
                self._inter_comms[js.job.job_id] = self._inter_comms.get(js.job.job_id, 0) + 1
                self._wan_bytes[js.job.job_id] = self._wan_bytes.get(js.job.job_id, 0.0) + size
            self.total_wan_bytes += size
        else:
            self.total_lan_bytes += size
        if js is None:
            self.access.record_prefetch(plan.src, plan.dst, plan.lfn, size,
                                        self.now)
        else:
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

    def _place(self, job: Job, site: int, *,
               defer_fetch: bool = False) -> _JobState:
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
        if not defer_fetch:
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
        obs = self._obs
        if obs is None:
            sites = self._batch_broker.select_batch(
                [j.required for j in batch])
        else:
            obs.count("broker.batches")
            obs.count("broker.batch_jobs", len(batch))
            with obs.span("broker.select_batch"):
                sites = self._batch_broker.select_batch(
                    [j.required for j in batch])
        if self._batched_strategy:
            # burst-level plan consumption: place everything first, then
            # plan every job's missing files in one strategy_plan pass
            jss = [self._place(job, site, defer_fetch=True)
                   for job, site in zip(batch, sites)]
            self._batch_fetch(jss)
        else:
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
            obs = self._obs
            plan = js.plan_cache.pop(lfn, None)
            if plan is not None:
                plan = self._live_plan(plan)
            if plan is None:
                if obs is None:
                    plan = self.strategy.plan_fetch(lfn, js.site)
                else:
                    with obs.span("strategy.plan"):
                        plan = self.strategy.plan_fetch(lfn, js.site)
            js.pending_transfers += 1
            self._start_transfer(plan, js)
            return
        if js.pending_transfers == 0:
            if js.data_ready_time < 0:
                js.data_ready_time = self.now
            self._enqueue_cpu(js)

    def _batch_fetch(self, jss: list[_JobState]) -> None:
        """``strategy_mode="batch"``: plan EVERY (job, missing-file) fetch
        of the burst in one ``plan_batch`` pass and cache the plans on
        each job, so the whole staging chain rides the batched planner.
        ``_fetch_next`` consumes the cache one transfer at a time under
        the ``_live_plan`` guard: an earlier plan of the burst (or any
        event between burst and consumption) may take the space or the
        very replica a later plan counted on."""
        pairs = [(lfn, js.site) for js in jss for lfn in js.missing]
        if pairs:
            obs = self._obs
            if obs is None:
                plans = self.strategy.plan_batch(pairs)
            else:
                obs.count("strategy.plan_batch_calls")
                obs.count("strategy.plan_batch_pairs", len(pairs))
                with obs.span("strategy.plan"):
                    plans = self.strategy.plan_batch(pairs)
            owners = (js for js in jss for _ in js.missing)
            for js, (lfn, _), plan in zip(owners, pairs, plans):
                js.plan_cache[lfn] = plan
        for js in jss:
            self._fetch_next(js)

    def _live_plan(self, plan: FetchPlan) -> Optional[FetchPlan]:
        """Adapt a burst-cached plan to the live state: keep it while it
        is still exactly executable, hand it to the strategy's cheap
        ``refresh_plan`` when only its store/eviction verdict went stale,
        and drop it (``None`` — full singleton replan) when the chosen
        source itself is gone or a cheaper class of source has appeared
        (an inter-region plan whose file now has a regional copy). The
        guards run in the reference's order; another order changes which
        of keep, reverdict and replan a plan gets."""
        obs = self._obs
        if plan.store and (plan.dst, plan.lfn) in self._inflight:
            if obs is not None:
                obs.count("plan_cache.keep")
            return plan      # piggybacks onto the in-flight transfer
        if not self.catalog.has_replica(plan.lfn, plan.src):
            if obs is not None:
                obs.count("plan_cache.replan")
            return None      # the chosen source was evicted since the burst
        if not (self.topology.sites[plan.src].online
                or self.catalog.is_master(plan.lfn, plan.src)):
            if obs is not None:
                obs.count("plan_cache.replan")
            return None
        if plan.inter_region and self.catalog.duplicated_in_region(
                plan.lfn, plan.dst, self.topology):
            if obs is not None:
                obs.count("plan_cache.replan")
            return None      # a regional copy appeared since the burst:
            # keeping the snapshot's WAN source would double-count
            # inter-region traffic the sequential pipeline avoids
        need = self.catalog.size(plan.lfn)
        free = self.storage.free(plan.dst)
        if plan.store and plan.evictions:
            # planned evictions must still exist, still cover, and still
            # be necessary (a file that fits outright now must not evict)
            if (free < need
                    and all(self.storage.holds(plan.dst, l)
                            and self.storage.evictable(plan.dst, l)
                            for l in plan.evictions)
                    and free + sum(self.catalog.size(l)
                                   for l in plan.evictions) >= need):
                if obs is not None:
                    obs.count("plan_cache.keep")
                return plan
        elif plan.store:
            if free >= need:
                if obs is not None:
                    obs.count("plan_cache.keep")
                return plan
        elif free < need:    # store=False stays the right call only
            if obs is not None:
                obs.count("plan_cache.keep")
            return plan      # while the file cannot fit
        if obs is None:
            return self.strategy.refresh_plan(plan)
        obs.count("plan_cache.reverdict")
        with obs.span("strategy.plan"):
            return self.strategy.refresh_plan(plan)

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

    # -- replication economy -------------------------------------------------
    def _econ_round(self) -> None:
        """One periodic proactive-replication round: auction the top-valued
        files (``ReplicationOptimizer.step``) and execute the winners as
        waiter-less store transfers. Prefetches ride the same fluid model
        as job fetches, so the cost side of the economy is real."""
        assert self._econ is not None
        if self._obs is not None:
            self._obs.count("econ.rounds")
        self._net_advance()
        for prop in self._econ.step(self.now):
            # revalidate against the live state: an earlier winner in this
            # same round may have pinned a source copy or consumed space
            if self.storage.holds(prop.dst, prop.lfn) or \
                    (prop.dst, prop.lfn) in self._inflight:
                continue
            if not self.catalog.has_replica(prop.lfn, prop.src):
                continue
            if not all(self.storage.holds(prop.dst, l)
                       and self.storage.evictable(prop.dst, l)
                       for l in prop.evictions):
                continue
            free = self.storage.free(prop.dst) + sum(
                self.catalog.size(l) for l in prop.evictions)
            if free < self.catalog.size(prop.lfn):
                continue
            if self._obs is not None:
                self._obs.count("econ.prefetch_started")
            self._start_transfer(prop.to_plan(self.topology), None)
        if len(self.records) < self._n_expected:
            self._push(self.now + self._econ_interval, ECON, None)
        else:
            self._econ_armed = False   # workload drained; disarm

    # -- telemetry sampling (repro_torch.obs) --------------------------------
    def _obs_sample(self) -> None:
        """One periodic OBS sampling round: append a row of grid-state
        channels to the telemetry ring buffer. Strictly read-only over
        engine state, so the event's presence in the heap never changes
        observable results — the same contract the sanitizer's twin
        replay relies on (twins drop the probe on deepcopy and their OBS
        events no-op here)."""
        obs = self._obs
        if obs is not None and obs.sampler is not None:
            obs.sampler.sample(self)
        # the repush depends only on the armed flag, not on the probe:
        # sanitizer twins drop the probe on deepcopy but must keep the
        # event stream (and hence the pending-queue digest) identical
        if self._obs_armed and len(self.records) < self._n_expected:
            self._push(self.now + self._obs_interval, OBS, None)
        else:
            self._obs_armed = False

    # -- failures / stragglers ----------------------------------------------
    def _fail_site(self, site: int) -> None:
        st = self.topology.sites[site]
        if not st.online:
            return
        self._cpu_advance(site)
        st.online = False
        if self._batched_strategy:
            self.strategy.invalidate_online()
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
        if self._batched_strategy:
            self.strategy.invalidate_online()
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
        if self._econ is not None and not self._econ_armed:
            # first optimizer round one interval in — by then the access
            # history holds a usable demand signal
            self._econ_armed = True
            self._push(self.now + self._econ_interval, ECON, None)
        obs = self._obs
        if obs is not None and obs.sampler is not None and \
                not self._obs_armed and self._obs_interval > 0:
            # sim-time sampling clock, mirroring the ECON arming: one
            # baseline sample now, then one OBS event per interval until
            # the workload drains
            self._obs_armed = True
            obs.sampler.sample(self)
            self._push(self.now + self._obs_interval, OBS, None)
        batched = self.network.batched
        while self._q:
            if self.sanitize:
                if not self._sanitize_step(until):
                    break
                continue
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
            self._handle(kind, payload)
        total_ic = sum(r.inter_comms for r in self.records)
        telemetry = None
        makespan = self.now
        if obs is not None:
            makespan = self._obs_real_now
            obs.merge_counters("net", self.network.stats)
            telemetry = obs.finalize(net_stats=self.network.stats)
        return SimResult(
            records=self.records,
            total_inter_comms=total_ic,
            total_wan_bytes=self.total_wan_bytes,
            total_lan_bytes=self.total_lan_bytes,
            makespan=makespan,
            net_stats=dict(self.network.stats),
            prefetches=self.access.prefetches,
            prefetch_bytes=self.access.prefetch_bytes,
            telemetry=telemetry,
        )

    def _handle(self, kind: int, payload: object) -> None:
        """Dispatch one popped event (``self.now`` already advanced),
        charging its telemetry phase when a probe is attached — the one
        per-event hot-path branch the obs="off" contract allows."""
        obs = self._obs
        if obs is None:
            return self._handle_event(kind, payload)
        if kind != OBS:
            self._obs_real_now = self.now
        obs.event(EVENT_NAMES[kind], self.now)
        phase = _EVENT_PHASE[kind]
        if phase is None:
            return self._handle_event(kind, payload)
        with obs.span(phase):
            return self._handle_event(kind, payload)

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
        elif kind == ECON:
            self._econ_round()
        elif kind == OBS:
            self._obs_sample()

    # -- tie-race sanitizer ------------------------------------------------
    def _sanitize_step(self, until: float) -> bool:
        """Process one *instant* (every event sharing the head timestamp);
        when the instant is a tie group, replay it order-reversed in a
        deep-copied twin and record any observable-state divergence.
        Returns False when the run should stop (head event past ``until``
        — popped and dropped, matching the normal loop)."""
        t = self._q[0][0]
        if t > until:
            heapq.heappop(self._q)
            return False
        group = sorted(e for e in self._q if e[0] == t)
        twin = self._tie_twin(t) if len(group) > 1 else None
        if twin is not None:
            self.ties_seen += 1
        self._drain_instant(t)
        if twin is not None:
            twin._drain_instant(t)
            diff = _digest_diff(self._state_digest(), twin._state_digest())
            if diff is not None:
                self.tie_races.append(TieRace(
                    time=t,
                    kinds=tuple(EVENT_NAMES[e[2]] for e in group),
                    detail=diff,
                ))
        return True

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
                self._handle(kind, payload)
            self._net_flush()

    def _tie_twin(self, t: float) -> "GridSimulator":
        """Deep-copied engine whose events at ``t`` are re-queued in
        reversed seq order (fresh seq numbers keep the (time, seq) key
        shape; among themselves they pop in the reversed order). The copy
        owns its slot tensors and kernel buffers
        (``SlotArrays``/``NetInputs.__deepcopy__``), so its launches write
        nothing of this engine's."""
        twin = copy.deepcopy(self)
        group = []
        while twin._q and twin._q[0][0] == t:
            group.append(heapq.heappop(twin._q))
        for _, _, kind, payload in reversed(group):
            twin._push(t, kind, payload)
        return twin

    def _state_digest(self) -> dict:
        """Canonicalized observable state for twin comparison. Anything
        whose order is *not* semantic (records, holder sets, transfer
        tables, the pending-event multiset) is sorted; anything whose
        order *is* semantic (per-site FIFO CPU queues) keeps its order so
        a genuine ordering race shows up. Internal version counters, PRNG
        positions and heap seq numbers are excluded — bookkeeping, not
        observable results. The slot state comes to the host in one copy
        (:meth:`NetworkEngine.slot_state`)."""
        d: dict = {"now": self.now}
        d["records"] = sorted(
            (r.job_id, r.job_type, r.site, r.submit_time, r.data_ready_time,
             r.start_time, r.finish_time, r.inter_comms, r.wan_bytes,
             r.resubmits)
            for r in self.records)
        d["sites"] = [(s.site_id, s.online, s.used_storage, s.queued_work,
                       s.compute_capacity) for s in self.topology.sites]
        d["storage"] = [sorted(self.storage.site_contents(s.site_id))
                        for s in self.topology.sites]
        d["catalog"] = [(lfn, sorted(self.catalog.holders(lfn)))
                        for lfn in self.catalog.files]
        rem_now, rate = self.network.slot_state(self.now)
        d["transfers"] = sorted(
            (tr.plan.lfn, tr.plan.src, tr.plan.dst, bool(tr.plan.store),
             float(rem_now[tr.slot]),
             float(rate[tr.slot]),
             sorted(w.job.job_id for w in tr.waiters))
            for tr in self._transfers.values())
        d["cpu"] = [
            (s.site_id,
             None if self._running[s.site_id] is None
             else self._running[s.site_id].job.job_id,
             [js.job.job_id for js in self._cpu_queue[s.site_id]
              if not js.done])
            for s in self.topology.sites]
        d["jobs"] = sorted(
            (js.job.job_id, site_id, tuple(js.missing),
             js.pending_transfers, js.data_ready_time, js.start_time,
             js.done, js.is_backup, js.rounds)
            for site_id, jobs in self._site_jobs.items()
            for js in jobs)
        d["queue"] = sorted(
            (e[0], e[2], _payload_digest(e[2], e[3])) for e in self._q)
        d["totals"] = (
            self.total_wan_bytes, self.total_lan_bytes,
            sorted(self._inter_comms.items()),
            sorted(self._wan_bytes.items()),
            sorted(self._resubmits.items()))
        return d


def _payload_digest(kind: int, payload: object) -> tuple:
    """Order-comparison key for a pending event's payload. Version
    counters (NET, CPU_DONE) are *excluded*: twins bump them in different
    interleavings while converging to the same physical state."""
    if kind == SUBMIT:
        return ("job", payload.job_id)             # type: ignore[union-attr]
    if kind == NET:
        return ("net",)
    if kind == CPU_DONE:
        return ("cpu", payload[0])                 # type: ignore[index]
    if kind in (FAIL, RECOVER):
        return ("site", payload)
    if kind in (SLOW_START, SLOW_END):
        return ("slow",) + tuple(payload)          # type: ignore[arg-type]
    if kind == WATCHDOG:
        return ("watchdog", payload.job.job_id)    # type: ignore[union-attr]
    return (EVENT_NAMES[kind],)


def _digest_diff(a: object, b: object, path: str = "state"
                 ) -> Optional[str]:
    """First divergence between two state digests, human-readable."""
    if type(a) is not type(b):
        return f"{path}: {type(a).__name__} != {type(b).__name__}"
    if isinstance(a, dict):
        assert isinstance(b, dict)
        for k in a:
            if k not in b:
                return f"{path}.{k}: missing in twin"
            diff = _digest_diff(a[k], b[k], f"{path}.{k}")
            if diff is not None:
                return diff
        extra = [k for k in b if k not in a]
        if extra:
            return f"{path}.{extra[0]}: only in twin"
        return None
    if isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple))
        if len(a) != len(b):
            return f"{path}: length {len(a)} != {len(b)}"
        for i, (x, y) in enumerate(zip(a, b)):
            diff = _digest_diff(x, y, f"{path}[{i}]")
            if diff is not None:
                return diff
        return None
    if a != b:
        return f"{path}: {a!r} != {b!r}"
    return None
