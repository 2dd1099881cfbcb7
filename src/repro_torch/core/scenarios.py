"""Declarative experiment scenarios + the named-scenario registry.

The paper evaluates one fixed world: a 4-region x 13-site two-level grid
with uniform links and a steady uniform arrival stream. Related work shows
the interesting regimes live elsewhere — DIANA-style network-aware
scheduling (arXiv:0707.0862) on heterogeneous fabrics, bulk scheduling
(arXiv:cs/0602026) under bursty submission. A :class:`ScenarioSpec` captures
*everything* that defines one experiment — topology shape, per-tier
bandwidth/storage, arrival process, workload mix, failure injections,
scheduler + replication strategy + broker, seeds — as a frozen, JSON
round-trippable dataclass, and :data:`SCENARIOS` registers named instances
(the paper baseline plus deep hierarchies, fat-region fabrics, flash-crowd /
diurnal / bulk arrivals, site churn, and a cache-starved regime).

The registry is the reference's (``repro.core.scenarios``), copied so the
port runs the same named experiments:
``python -m repro_torch.launch.experiments --scenario NAME``.
"""

from __future__ import annotations

import dataclasses
import math
import random as _random

from ..fault.failures import churn_schedule
from ..obs import OBS_MODES
from .economy import ECON_BACKENDS
from .quantities import GB, MB, MBPS_TO_BYTES_PER_S
from .replica import STRATEGIES, STRATEGY_MODES
from .scheduler import SCHEDULERS
from .simulator import NETS
from .workload import GridConfig

ARRIVALS = ("uniform", "poisson", "flash_crowd", "diurnal")
BROKERS = ("event", "jax")


@dataclasses.dataclass(frozen=True)
class ChurnSpec:
    """Declarative site-churn regime for the grid simulator.

    ``n_failures`` outages are spread over ``window`` (seconds of sim time);
    each takes a distinct site offline for a duration drawn exponentially
    around ``mean_downtime_s``. Expansion into concrete ``(site, at,
    duration)`` events is :func:`repro_torch.fault.failures.churn_schedule`,
    deterministic under a seed.
    """

    n_failures: int = 0
    window: tuple[float, float] = (0.0, 0.0)
    mean_downtime_s: float = 4000.0


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """Everything that defines one grid experiment, declaratively.

    Field groups (defaults reproduce the paper's Table-1 world exactly —
    ``to_grid_config`` of the default spec equals ``GridConfig()``):

    *Topology* — ``tier_fanouts`` is the tier tree, e.g. ``(4, 13)`` (the
    paper) or ``(2, 3, 3, 3)`` (a 5-tier hierarchy); ``uplink_mbps`` gives
    one uplink bandwidth per internal level, top-down; ``lan_mbps`` is the
    site NIC. ``uplink_scale`` holds ``(level, node, factor)`` bandwidth
    multipliers (fat regions), ``storage_scale`` holds ``(region, factor)``
    SE-capacity multipliers, and ``storage_gb`` the base SE size.

    *Workload* — catalog size/granularity, per-job file count, job mix and
    length, Zipf skew of the per-job file draw (``None`` = fixed sets);
    ``hotset_shifts`` reshuffles the popular file set that many times
    mid-run (the drifting-hot-set regime).

    *Arrivals* — ``arrival`` is one of ``uniform | poisson | flash_crowd |
    diurnal`` (see :func:`arrival_schedule`); ``arrival_burst`` > 1 submits
    uniform arrivals in bursts of that size (DIANA-style bulk submission,
    usually with ``broker="jax"``).

    *Injections* — ``churn`` expands into deterministic ``(site, at,
    duration)`` failures via :func:`repro_torch.fault.failures.churn_schedule`;
    ``slowdowns`` are literal ``(site, at, duration, factor)`` stragglers.

    *Engine* — scheduler / replication strategy / broker registry names,
    the network-engine backend ``net`` (``numpy`` | ``pallas`` |
    ``pallas-interpret`` | ``device`` | ``device-interpret`` | ``topmost``,
    see :class:`repro_torch.core.network.NetworkEngine`), the replication-economy
    value-scoring backend ``econ`` + its period ``econ_interval_s``
    (``None`` arms the optimizer only for the access-aware strategies; see
    :mod:`repro.core.economy`) and the seeds to run (one simulation per
    seed).

    Specs are frozen; derive variants with ``dataclasses.replace`` and
    serialize with :meth:`to_dict` / :meth:`from_dict` (exact round-trip,
    JSON-safe).
    """

    name: str
    description: str = ""
    probes: str = ""                 # paper figure / related-work regime
    # -- topology ----------------------------------------------------------
    tier_fanouts: tuple[int, ...] = (4, 13)
    lan_mbps: float = 1000.0
    uplink_mbps: tuple[float, ...] = (10.0,)
    uplink_scale: tuple[tuple[int, int, float], ...] = ()
    storage_gb: float = 10.0
    storage_scale: tuple[tuple[int, float], ...] = ()
    # -- workload ----------------------------------------------------------
    n_jobs: int = 500
    n_job_types: int = 5
    files_per_job: int = 12
    file_size_mb: float = 500.0
    catalog_gb: float = 50.0
    job_length: float = 60e9
    zipf_alpha: float | None = 0.9
    hotset_shifts: int = 0           # mid-run hot-set reshuffles (drift)
    # -- arrival process ---------------------------------------------------
    arrival: str = "uniform"
    interarrival_s: float = 60.0
    arrival_burst: int = 1
    crowd_at: float = 0.5            # flash_crowd: burst start (job fraction)
    crowd_frac: float = 0.3          # flash_crowd: fraction of jobs in burst
    crowd_factor: float = 30.0       # flash_crowd: rate multiplier in burst
    diurnal_amplitude: float = 0.8   # diurnal: rate swing, 0..1
    diurnal_period_jobs: int = 200   # diurnal: jobs per day-cycle
    # -- injections --------------------------------------------------------
    churn: ChurnSpec = ChurnSpec()
    slowdowns: tuple[tuple[int, float, float, float], ...] = ()
    # -- engine ------------------------------------------------------------
    scheduler: str = "dataaware"
    strategy: str = "hrs"
    strategy_mode: str = "sequential"
    broker: str = "event"
    batch_window_s: float = 0.0
    net: str = "numpy"
    econ: str = "numpy"              # value-scoring backend of the economy
    econ_interval_s: float | None = None   # None=auto (access-aware strategies)
    obs: str = "off"                 # telemetry mode (repro_torch.obs.OBS_MODES)
    obs_interval_s: float | None = None    # sim-seconds between OBS samples
    seeds: tuple[int, ...] = (0,)

    def __post_init__(self) -> None:
        if len(self.tier_fanouts) < 2:
            raise ValueError(f"{self.name}: need >=2 tier levels")
        if len(self.uplink_mbps) != len(self.tier_fanouts) - 1:
            raise ValueError(
                f"{self.name}: {len(self.tier_fanouts)}-level fanouts need "
                f"{len(self.tier_fanouts) - 1} uplink bandwidths, got "
                f"{len(self.uplink_mbps)}")
        if self.arrival not in ARRIVALS:
            raise ValueError(f"{self.name}: unknown arrival {self.arrival!r} "
                             f"(want one of {ARRIVALS})")
        if self.scheduler not in SCHEDULERS:
            raise ValueError(f"{self.name}: unknown scheduler "
                             f"{self.scheduler!r} (want one of "
                             f"{sorted(SCHEDULERS)})")
        if self.strategy not in STRATEGIES:
            raise ValueError(f"{self.name}: unknown strategy "
                             f"{self.strategy!r} (want one of "
                             f"{sorted(STRATEGIES)})")
        if self.strategy_mode not in STRATEGY_MODES:
            raise ValueError(f"{self.name}: unknown strategy_mode "
                             f"{self.strategy_mode!r} (want one of "
                             f"{STRATEGY_MODES})")
        if self.broker not in BROKERS:
            raise ValueError(f"{self.name}: unknown broker {self.broker!r}")
        if self.net not in NETS:
            raise ValueError(f"{self.name}: unknown net engine "
                             f"{self.net!r} (want one of {NETS})")
        if self.econ not in ECON_BACKENDS:
            raise ValueError(f"{self.name}: unknown econ backend "
                             f"{self.econ!r} (want one of {ECON_BACKENDS})")
        if self.obs not in OBS_MODES:
            raise ValueError(f"{self.name}: unknown obs mode "
                             f"{self.obs!r} (want one of {OBS_MODES})")
        if self.hotset_shifts < 0:
            raise ValueError(f"{self.name}: hotset_shifts must be >= 0")
        if self.hotset_shifts > 0 and self.zipf_alpha is None:
            raise ValueError(
                f"{self.name}: hotset_shifts needs a Zipf workload "
                "(zipf_alpha=None draws fixed per-type filesets, which "
                "cannot drift)")
        if not self.seeds:
            raise ValueError(f"{self.name}: need at least one seed")

    # -- derived -----------------------------------------------------------
    @property
    def n_sites(self) -> int:
        n = 1
        for f in self.tier_fanouts:
            n *= f
        return n

    # -- serialization -----------------------------------------------------
    def to_dict(self) -> dict:
        """JSON-safe dict; exact inverse of :meth:`from_dict`."""
        d = dataclasses.asdict(self)
        d["churn"] = dataclasses.asdict(self.churn)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ScenarioSpec":
        d = dict(d)
        churn = d.get("churn", {})
        if not isinstance(churn, ChurnSpec):
            churn = dict(churn)
            churn["window"] = tuple(churn.get("window", (0.0, 0.0)))
            churn = ChurnSpec(**churn)
        d["churn"] = churn
        for key in ("tier_fanouts", "uplink_mbps", "seeds"):
            if key in d:
                d[key] = tuple(d[key])
        for key in ("uplink_scale", "storage_scale", "slowdowns"):
            if key in d:
                d[key] = tuple(tuple(row) for row in d[key])
        return cls(**d)


def to_grid_config(spec: ScenarioSpec, seed: int | None = None) -> GridConfig:
    """Lower a spec's topology + workload fields to a :class:`GridConfig`.

    For two-level trees this emits the classic ``n_regions x
    sites_per_region`` form, so the default spec lowers to exactly
    ``GridConfig()`` (the golden-metrics baseline path).
    """
    mbps = MBPS_TO_BYTES_PER_S
    two_level = len(spec.tier_fanouts) == 2
    return GridConfig(
        n_regions=spec.tier_fanouts[0] if two_level else 4,
        sites_per_region=spec.tier_fanouts[1] if two_level else 13,
        storage_capacity=spec.storage_gb * GB,
        lan_bandwidth=spec.lan_mbps * mbps,
        wan_bandwidth=spec.uplink_mbps[0] * mbps,
        n_jobs=spec.n_jobs,
        n_job_types=spec.n_job_types,
        files_per_job=spec.files_per_job,
        file_size=spec.file_size_mb * MB,
        total_file_bytes=spec.catalog_gb * GB,
        job_length=spec.job_length,
        interarrival=spec.interarrival_s,
        zipf_alpha=spec.zipf_alpha,
        hotset_shifts=spec.hotset_shifts,
        seed=spec.seeds[0] if seed is None else seed,
        tier_fanouts=None if two_level else spec.tier_fanouts,
        uplink_bandwidths=(None if two_level
                           else tuple(u * mbps for u in spec.uplink_mbps)),
        uplink_scale=spec.uplink_scale,
        storage_scale=spec.storage_scale,
    )


def arrival_schedule(spec: ScenarioSpec, n_jobs: int,
                     seed: int = 0) -> list[float] | None:
    """Submit times (seconds, one per job) for the spec's arrival process.

    Returns ``None`` for ``uniform`` so the runner takes ``run_experiment``'s
    default arrival path (bit-identical to the paper baseline, including
    ``arrival_burst`` bulk submission). ``poisson`` and ``diurnal`` keep the
    baseline's mean rate ``1 / interarrival_s`` so those scenarios stay
    load-comparable; ``flash_crowd`` deliberately does not — the crowd adds
    extra load on top of the steady stream (with the default knobs the
    realized mean rate is ~1.4x the base). Deterministic under ``seed``.
    """
    ia = spec.interarrival_s
    if spec.arrival == "uniform":
        return None
    if spec.arrival == "poisson":
        rng = _random.Random(seed ^ 0xA441)
        t, out = 0.0, []
        for _ in range(n_jobs):
            out.append(t)
            t += rng.expovariate(1.0 / ia)
        return out
    if spec.arrival == "flash_crowd":
        # steady stream, except a contiguous block of jobs arrives at
        # crowd_factor x the base rate (a release / reprocessing campaign)
        lo = int(n_jobs * spec.crowd_at)
        hi = min(n_jobs, lo + max(1, int(n_jobs * spec.crowd_frac)))
        t, out = 0.0, []
        for j in range(n_jobs):
            out.append(t)
            t += ia / spec.crowd_factor if lo <= j < hi else ia
        return out
    if spec.arrival == "diurnal":
        # sinusoidally modulated gaps: "daytime" jobs arrive up to
        # (1 - amplitude) x faster, "night" up to (1 + amplitude) x slower
        t, out = 0.0, []
        for j in range(n_jobs):
            out.append(t)
            phase = 2.0 * math.pi * j / max(1, spec.diurnal_period_jobs)
            t += ia * (1.0 + spec.diurnal_amplitude * math.sin(phase))
        return out
    raise AssertionError(f"unhandled arrival {spec.arrival!r}")


def injections(spec: ScenarioSpec, seed: int = 0) -> tuple[
        list[tuple[int, float, float]],
        list[tuple[int, float, float, float]]]:
    """Expand the spec's fault fields into run_experiment's
    ``(failures, slowdowns)`` lists."""
    failures = churn_schedule(spec.churn, spec.n_sites, seed=seed)
    return failures, [tuple(s) for s in spec.slowdowns]


# --------------------------------------------------------------------------
# the registry
# --------------------------------------------------------------------------
SCENARIOS: dict[str, ScenarioSpec] = {}


def register_scenario(spec: ScenarioSpec) -> ScenarioSpec:
    """Add a spec to :data:`SCENARIOS` (name must be unused)."""
    if spec.name in SCENARIOS:
        raise ValueError(f"scenario {spec.name!r} already registered")
    SCENARIOS[spec.name] = spec
    return spec


def get_scenario(name: str) -> ScenarioSpec:
    try:
        return SCENARIOS[name]
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; registered: "
                       f"{', '.join(sorted(SCENARIOS))}") from None


register_scenario(ScenarioSpec(
    name="paper_baseline",
    description="The paper's Table-1 world: 4 regions x 13 sites, 10 GB "
                "SEs, 1000/10 Mbps LAN/WAN, 500 jobs at a steady 60 s "
                "spacing, data-aware scheduler + HRS.",
    probes="paper fig4-fig7 (golden-metrics baseline)",
))

register_scenario(ScenarioSpec(
    name="deep_4tier",
    description="A 4-tier hierarchy (2 clusters x 4 groups x 7 sites) with "
                "a 10 Mbps top uplink over 100 Mbps group uplinks: locality "
                "is two-layered, so eviction mistakes cost more.",
    probes="hierarchy depth beyond the paper's 2-level grid",
    tier_fanouts=(2, 4, 7),
    uplink_mbps=(10.0, 100.0),
))

register_scenario(ScenarioSpec(
    name="deep_5tier",
    description="A 5-tier hierarchy (2 x 3 x 3 x 3 = 54 sites) with "
                "bandwidth decreasing up the tree (200/50/10 Mbps).",
    probes="hierarchy depth; tier-graded bandwidth",
    tier_fanouts=(2, 3, 3, 3),
    uplink_mbps=(10.0, 50.0, 200.0),
))

register_scenario(ScenarioSpec(
    name="fat_region",
    description="Paper grid but region 0's WAN uplink is 10x fatter "
                "(100 Mbps): a well-connected Tier-1-like center among "
                "thin regions.",
    probes="DIANA network-aware scheduling regime (arXiv:0707.0862)",
    uplink_scale=((1, 0, 10.0),),
))

register_scenario(ScenarioSpec(
    name="flash_crowd",
    description="Steady stream, then 30% of all jobs arrive at 30x the "
                "base rate mid-run (data release / reprocessing campaign).",
    probes="queue + WAN saturation transients",
    arrival="flash_crowd",
))

register_scenario(ScenarioSpec(
    name="diurnal",
    description="Sinusoidally modulated arrivals (80% rate swing, 200-job "
                "day cycle): replicas staged during the quiet phase serve "
                "the busy phase.",
    probes="time-varying load; cache warm-up dynamics",
    arrival="diurnal",
))

register_scenario(ScenarioSpec(
    name="bulk_diana",
    description="DIANA-style bulk submission: jobs arrive in bursts of 50 "
                "and each burst is placed by one jitted batch decision "
                "(broker='jax').",
    probes="bulk scheduling (arXiv:cs/0602026); jitted broker path",
    arrival_burst=50,
    broker="jax",
))

register_scenario(ScenarioSpec(
    name="site_churn",
    description="Paper grid under churn: 6 site outages (mean 4000 s) "
                "spread over the first 30000 s; queued jobs resubmit, "
                "replicas are lost and re-staged.",
    probes="fault-tolerance axis; replica durability",
    churn=ChurnSpec(n_failures=6, window=(1000.0, 30000.0),
                    mean_downtime_s=4000.0),
))

register_scenario(ScenarioSpec(
    name="deep_contended",
    description="A 4-tier hierarchy (3 clusters x 3 groups x 6 sites) with "
                "a fat 100 Mbps top tier over thin 10 Mbps group uplinks: "
                "cross-cluster transfers squeeze through a thin mid-tier "
                "link the legacy topmost-uplink model never contended.",
    probes="mid-tier path contention (net='numpy' vs net='topmost'; "
           "benchmarks/run.py net_sweep)",
    tier_fanouts=(3, 3, 6),
    uplink_mbps=(100.0, 10.0),
))

register_scenario(ScenarioSpec(
    name="bulk_shortest",
    description="Bulk submission placed by the vectorized shortest-transfer "
                "broker: each 50-job burst is costed against a "
                "point-bandwidth matrix snapshot of the per-link arrays "
                "and dispatched as one jitted decision.",
    probes="multi-backend brokers (shortesttransfer under broker='jax')",
    scheduler="shortesttransfer",
    arrival_burst=50,
    broker="jax",
))

register_scenario(ScenarioSpec(
    name="grid_500",
    description="The OptorSim-scale point: 500 sites (5 clusters x 10 "
                "groups x 10 sites, 500/1000 Mbps graded uplinks, 50 GB "
                "SEs) over a 1000-file / 500 GB catalog, 100k jobs "
                "arriving in bursts of 50, each burst placed by one "
                "jitted batch decision against the incremental presence "
                "bitmap. Sized to run *sustainably* — makespan tracks "
                "the arrival span and inter-comms settle near the "
                "paper's — so the benchmark measures engine throughput, "
                "not backlog pathology. The ROADMAP's scale target; "
                "`benchmarks/run.py scale_sweep` runs it as its largest "
                "point.",
    probes="engine scale (OptorSim-scale grid studies; 500-site / "
           "100k-job ROADMAP item); blocked st_cost + incremental "
           "snapshot hot paths",
    tier_fanouts=(5, 10, 10),
    uplink_mbps=(500.0, 1000.0),
    storage_gb=50.0,
    catalog_gb=500.0,
    n_jobs=100_000,
    n_job_types=10,
    interarrival_s=15.0,
    arrival_burst=50,
    broker="jax",
))

register_scenario(ScenarioSpec(
    name="grid_500_saturated",
    description="The grid_500 world driven into backlog on purpose: "
                "arrivals 30x faster (0.5 s between bursts of 50) over "
                "10x thinner uplinks (50/100 Mbps), so thousands of "
                "transfers pile onto every cluster uplink and the "
                "incremental engine's per-event member union + "
                "next-completion scan both go O(backlog). scale_sweep "
                "runs the same 20k-job point under net='numpy' and "
                "net='device'; the batched engine's O(1)-per-event "
                "drain must beat the incremental wall clock >=2x here.",
    probes="saturated-backlog pathology (ROADMAP batched-event item); "
           "device vs numpy engine wall-clock evidence",
    tier_fanouts=(5, 10, 10),
    uplink_mbps=(50.0, 100.0),
    storage_gb=50.0,
    catalog_gb=500.0,
    n_jobs=20_000,
    n_job_types=10,
    interarrival_s=0.5,
    arrival_burst=50,
    broker="jax",
    net="device",
))

register_scenario(ScenarioSpec(
    name="grid_500_evict",
    description="The grid_500 world driven into *planner* pathology: 50 "
                "MB files over a 10,000-file catalog, 25 GB SEs (~500 "
                "evictable residents each) and 25-file jobs, so the SEs "
                "saturate early and nearly every store walks the full "
                "two-phase LRU scan over hundreds of residents with "
                "hundreds of candidate sources. This is the "
                "strategy_mode='batch' discriminating regime: the "
                "sequential planner pays per-file Python scans "
                "(holders walk, per-resident evictable + "
                "duplicated_in_region checks), the batched planner "
                "amortizes them into per-burst vectorized passes plus "
                "cheap source-preserving re-verdicts. scale_sweep runs "
                "the 20k-job point in both strategy modes; the batched "
                "wall clock must beat sequential >=2x here.",
    probes="eviction-scan-bound planning (batched replica-strategy "
           "engine); burst plan-cache + refresh_plan hot paths",
    tier_fanouts=(5, 10, 10),
    uplink_mbps=(500.0, 1000.0),
    storage_gb=25.0,
    catalog_gb=500.0,
    file_size_mb=50.0,
    files_per_job=25,
    n_jobs=20_000,
    n_job_types=10,
    interarrival_s=15.0,
    arrival_burst=50,
    broker="jax",
))

register_scenario(ScenarioSpec(
    name="grid_5000",
    description="The 5000-site / 1M-job rung: 5 clusters x 10 groups x "
                "10 subgroups x 10 sites (graded 10000/2000/1000 Mbps "
                "uplinks, 50 GB SEs) over a 2000-file / 1 TB catalog, a "
                "million jobs arriving in bursts of 50 every 75 s (the "
                "same per-site pressure as grid_500), each burst placed "
                "by one jitted batch decision. Runs on the batched "
                "on-device event engine (net='device'): occupancy "
                "changes only mark the engine dirty and every drained "
                "instant re-rates + reconstructs + scans in one fused "
                "pass, so per-event network work no longer grows with "
                "the in-flight count.",
    probes="engine scale (5000-site / 1M-job ROADMAP rung); batched "
           "event-engine drain + tolerance-golden contract at scale",
    tier_fanouts=(5, 10, 10, 10),
    uplink_mbps=(10000.0, 2000.0, 1000.0),
    storage_gb=50.0,
    catalog_gb=1000.0,
    n_jobs=1_000_000,
    n_job_types=20,
    interarrival_s=1.5,
    arrival_burst=50,
    broker="jax",
    net="device",
))

register_scenario(ScenarioSpec(
    name="cache_starved",
    description="Paper grid with 2 GB SEs: a site can hold at most 4 of "
                "the 12 files a job needs, so eviction policy dominates.",
    probes="eviction-pressure regime (two-phase vs plain LRU)",
    storage_gb=2.0,
))

register_scenario(ScenarioSpec(
    name="economy_starved",
    description="The cache_starved world under the OptorSim-style "
                "replication economy: the economic strategy prices every "
                "eviction as a trade (predicted accesses x transfer cost) "
                "and a periodic optimizer auctions top-valued files to "
                "sites with space.",
    probes="replication economy (economic/auction-based related work); "
           "proactive vs reactive replication under eviction pressure",
    storage_gb=2.0,
    strategy="economic",
    seeds=(0, 1),
))

register_scenario(ScenarioSpec(
    name="hotset_drift",
    description="Paper grid whose popular file set reshuffles 3 times "
                "mid-run (sharper 1.1 Zipf draw): reactive strategies "
                "keep serving yesterday's hot set while the predictive "
                "strategy's decayed counts track the drift and its "
                "optimizer stages rising files ahead of demand.",
    probes="popularity-prediction replication (CMS access-pattern study); "
           "the regime where predictive beats reactive HRS",
    zipf_alpha=1.1,
    hotset_shifts=3,
    seeds=(0, 1),
))


# --------------------------------------------------------------------------
# parameter sweeps as first-class specs
# --------------------------------------------------------------------------
#: Axes a sweep may vary: any ScenarioSpec field (replaced literally via
#: ``dataclasses.replace``) plus the derived ``wan_mbps`` axis (the topmost
#: uplink bandwidth, i.e. ``uplink_mbps[0]``).
_SPEC_FIELDS = frozenset(
    f.name for f in dataclasses.fields(ScenarioSpec)) - {"name"}
SWEEP_AXES = _SPEC_FIELDS | {"wan_mbps"}


def with_axis(spec: ScenarioSpec, axis: str, value) -> ScenarioSpec:
    """One sweep cell: ``spec`` with ``axis`` replaced by ``value``.

    The replaced spec re-validates in ``__post_init__``, so sweeping an
    engine axis (``strategy``, ``net``, ``scheduler``, ``econ``, ...) to a
    bad value fails at expansion time, not mid-run.
    """
    if axis == "wan_mbps":
        return dataclasses.replace(
            spec, uplink_mbps=(float(value),) + spec.uplink_mbps[1:])
    if axis not in _SPEC_FIELDS:
        raise ValueError(f"unknown sweep axis {axis!r} "
                         f"(want one of {sorted(SWEEP_AXES)})")
    # JSON-sourced values (SweepSpec.from_dict) arrive as lists: coerce
    # them the same way ScenarioSpec.from_dict does, so sweep cells stay
    # hashable frozen specs
    if axis in ("tier_fanouts", "uplink_mbps", "seeds"):
        value = tuple(value)
    elif axis in ("uplink_scale", "storage_scale", "slowdowns"):
        value = tuple(tuple(row) for row in value)
    return dataclasses.replace(spec, **{axis: value})


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """A named parameter study: one base scenario crossed along one axis.

    ``base`` names a registered :class:`ScenarioSpec`; each cell is the
    base with ``axis`` set to one of ``values`` (see :func:`with_axis` for
    the axis vocabulary — every spec field plus ``wan_mbps``). The runner
    (``python -m repro_torch.launch.experiments --scenario NAME``) accepts sweep
    names next to scenario names and writes the whole grid, one row per
    (value, seed), into ``BENCH_scenarios.json``. JSON round-trippable like
    :class:`ScenarioSpec`.
    """

    name: str
    base: str
    axis: str
    values: tuple
    description: str = ""

    def __post_init__(self) -> None:
        if self.axis not in SWEEP_AXES:
            raise ValueError(f"{self.name}: unknown sweep axis "
                             f"{self.axis!r} (want one of "
                             f"{sorted(SWEEP_AXES)})")
        if not self.values:
            raise ValueError(f"{self.name}: need at least one value")

    def expand(self) -> list[tuple[object, ScenarioSpec]]:
        """``(value, cell spec)`` per value; cells are named
        ``base@axis=value`` and fully validated."""
        base = get_scenario(self.base)
        return [
            (v, dataclasses.replace(with_axis(base, self.axis, v),
                                    name=f"{self.base}@{self.axis}={v}"))
            for v in self.values
        ]

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["values"] = list(self.values)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "SweepSpec":
        d = dict(d)
        d["values"] = tuple(d["values"])
        return cls(**d)


#: Named-sweep registry (the grid analogue of :data:`SCENARIOS`).
SWEEPS: dict[str, SweepSpec] = {}


def register_sweep(spec: SweepSpec) -> SweepSpec:
    """Add a sweep to :data:`SWEEPS` (name must be unused in both
    registries, so ``--scenario`` can resolve either)."""
    if spec.name in SWEEPS or spec.name in SCENARIOS:
        raise ValueError(f"sweep {spec.name!r} already registered")
    get_scenario(spec.base)          # fail fast on a bad base
    spec.expand()                    # ... and on any invalid cell
    SWEEPS[spec.name] = spec
    return spec


def get_sweep(name: str) -> SweepSpec:
    try:
        return SWEEPS[name]
    except KeyError:
        raise KeyError(f"unknown sweep {name!r}; registered: "
                       f"{', '.join(sorted(SWEEPS))}") from None


_ALL_STRATEGIES = ("hrs", "bhr", "lru", "economic", "predictive")

register_sweep(SweepSpec(
    name="starved_strategies",
    base="cache_starved",
    axis="strategy",
    values=_ALL_STRATEGIES,
    description="Every replication strategy under 2 GB eviction pressure: "
                "the discriminating regime for the access-aware pair.",
))

register_sweep(SweepSpec(
    name="drift_strategies",
    base="hotset_drift",
    axis="strategy",
    values=_ALL_STRATEGIES,
    description="Every replication strategy against a drifting hot set "
                "(prediction should beat reactive HRS here).",
))

register_sweep(SweepSpec(
    name="contended_nets",
    base="deep_contended",
    axis="net",
    values=("topmost", "numpy", "pallas"),
    description="Network-model fidelity grid: the legacy topmost-uplink "
                "accounting vs the per-link path model vs the vectorized "
                "re-rate backend on the mid-tier-contended tree.",
))

register_sweep(SweepSpec(
    name="baseline_wan",
    base="paper_baseline",
    axis="wan_mbps",
    values=(10.0, 50.0, 100.0, 500.0, 1000.0),
    description="The paper's fig7 WAN-bandwidth axis as a first-class "
                "sweep.",
))
